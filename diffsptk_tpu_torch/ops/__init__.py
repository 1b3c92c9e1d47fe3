from .companding import (
    ALawCompression,
    ALawExpansion,
    InverseUniformQuantization,
    MuLawCompression,
    MuLawExpansion,
    UniformQuantization,
)
from .dct import (
    DiscreteCosineTransform,
    DiscreteHartleyTransform,
    DiscreteSineTransform,
    InverseDiscreteCosineTransform,
    InverseDiscreteHartleyTransform,
    InverseDiscreteSineTransform,
    InverseWalshHadamardTransform,
    WalshHadamardTransform,
)
from .fftr import (
    RealValuedFastFourierTransform,
    RealValuedInverseFastFourierTransform,
)
from .frame import Frame
from .freqt import FrequencyTransform
from .gnorm import (
    GeneralizedCepstrumGainNormalization,
    GeneralizedCepstrumInverseGainNormalization,
)
from .mc2b import (
    MelCepstrumToMLSADigitalFilterCoefficients,
    MLSADigitalFilterCoefficientsToMelCepstrum,
)
from .parcor import (
    AllPoleToAllZeroDigitalFilterCoefficients,
    AllZeroToAllPoleDigitalFilterCoefficients,
    InverseSineToParcorCoefficients,
    LinearPredictiveCoefficientsToParcorCoefficients,
    LogAreaRatioToParcorCoefficients,
    ParcorCoefficientsToInverseSine,
    ParcorCoefficientsToLinearPredictiveCoefficients,
    ParcorCoefficientsToLogAreaRatio,
)
from .spec import Spectrum
from .stft import InverseShortTimeFourierTransform, ShortTimeFourierTransform
from .unframe import Unframe
from .window import Window
from .acorr import Autocorrelation
from .dfs import (
    InfiniteImpulseResponseDigitalFilter,
    SecondOrderDigitalFilter,
)
from .levdur import LevinsonDurbin, ReverseLevinsonDurbin
from .linear_intpl import LinearInterpolation
from .lpc import LinearPredictiveCodingAnalysis
from .poledf import AllPoleDigitalFilter
from .zerodf import AllZeroDigitalFilter
from .cep import (
    CepstralAnalysis,
    CepstralDistance,
    CepstrumToAutocorrelation,
    CepstrumToMinimumPhaseImpulseResponse,
    CepstrumToNegativeDerivativeOfPhaseSpectrum,
    MinimumPhaseImpulseResponseToCepstrum,
    NegativeDerivativeOfPhaseSpectrumToCepstrum,
)
from .mcep import CoefficientsFrequencyTransform, MelCepstralAnalysis
from .mgc2mgc import MelGeneralizedCepstrumToMelGeneralizedCepstrum
from .mgc2sp import MelGeneralizedCepstrumToSpectrum
from .mglsadf import (
    PseudoInverseMGLSADigitalFilter,
    PseudoMGLSADigitalFilter,
)
from .fbank import (
    InverseMelFilterBankAnalysis,
    MelFilterBankAnalysis,
    MelFrequencyCepstralCoefficientsAnalysis,
    PerceptualLinearPredictiveCoefficientsAnalysis,
)
from .griffin import GriffinLim
from .mdct import (
    HilbertTransform,
    InverseModifiedDiscreteCosineTransform,
    InverseModifiedDiscreteSineTransform,
    InverseModifiedDiscreteTransform,
    ModifiedDiscreteCosineTransform,
    ModifiedDiscreteSineTransform,
    ModifiedDiscreteTransform,
)
from .lsp import (
    LinearPredictiveCoefficientsStabilityCheck,
    LinearPredictiveCoefficientsToLineSpectralPairs,
    LineSpectralPairsStabilityCheck,
    LineSpectralPairsToLinearPredictiveCoefficients,
    LineSpectralPairsToSpectrum,
)
from .rootpol import PolynomialToRoots, RootsToPolynomial
from .freqt2 import (
    SecondOrderAllPassFrequencyTransform,
    SecondOrderAllPassInverseFrequencyTransform,
)
from .mcpf import (
    MelCepstrumInversePowerNormalization,
    MelCepstrumPostfiltering,
    MelCepstrumPowerNormalization,
    MLSADigitalFilterStabilityCheck,
)
from .mgcep import MelGeneralizedCepstralAnalysis
from .smcep import SecondOrderAllPassMelCepstralAnalysis
from .ap import Aperiodicity
from .excite import ExcitationGeneration
from .pitch import Pitch
from .pitch_spec import PitchAdaptiveSpectralAnalysis
from .world_synth import WorldSynthesis
from .chroma import ChromaFilterBankAnalysis
from .cqt import ConstantQTransform, InverseConstantQTransform
from .gammatone import (
    GammatoneFilterBankAnalysis,
    GammatoneFilterBankSynthesis,
)
from .pqmf import (
    FractionalOctaveBandAnalysis,
    PseudoQuadratureMirrorFilterBankAnalysis,
    PseudoQuadratureMirrorFilterBankSynthesis,
)
from .csm import (
    AutocorrelationToCompositeSinusoidalModelCoefficients,
    CompositeSinusoidalModelCoefficientsToAutocorrelation,
)
from .delta import Delta, MaximumLikelihoodParameterGeneration
from .drc import DynamicRangeCompression
from .dtw import DynamicTimeWarping
from .misc import (
    Decimation,
    F0Evaluation,
    Delay,
    Entropy,
    Flux,
    GroupDelay,
    Histogram,
    Interpolation,
    MagicNumberInterpolation,
    MedianFilter,
    Phase,
    RootMeanSquareError,
    SignalToNoiseRatio,
    Yingram,
    ZeroCrossingAnalysis,
)
from .learners import (
    GaussianMixtureModeling,
    IndependentComponentAnalysis,
    LindeBuzoGrayAlgorithm,
    NonnegativeMatrixFactorization,
    PrincipalComponentAnalysis,
)
from .vq import (
    InverseMultiStageVectorQuantization,
    InverseVectorQuantization,
    MultiStageVectorQuantization,
    VectorQuantization,
)
