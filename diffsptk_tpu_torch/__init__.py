"""diffsptk_tpu_torch: the PyTorch/CUDA port of diffsptk_tpu.

The port mirrors the JAX package's layout (``core``, ``ops``, ``kernels``,
``models``, ``utils``) and its public names.  Operators are
``nn.Module``s that run on the card unless built with ``device="cpu"``.
Each hand-written CUDA kernel (``csrc/``) has a plain torch twin beside it,
which is what a CPU tensor runs.  The package never imports JAX.
"""

from .core import BaseNonFunctionalOp, BaseOp, Design
from .kernels.state import twins
from .models.mcep_vocoder import MelCepstralVocoder
from .models.world_vocoder import WorldVocoder
from .ops.acorr import Autocorrelation
from .ops.ap import Aperiodicity
from .ops.companding import (
    ALawCompression,
    ALawExpansion,
    InverseUniformQuantization,
    MuLawCompression,
    MuLawExpansion,
    UniformQuantization,
)
from .ops.cep import (
    CepstralAnalysis,
    CepstralDistance,
    CepstrumToAutocorrelation,
    CepstrumToMinimumPhaseImpulseResponse,
    CepstrumToNegativeDerivativeOfPhaseSpectrum,
    MinimumPhaseImpulseResponseToCepstrum,
    NegativeDerivativeOfPhaseSpectrumToCepstrum,
)
from .ops.chroma import ChromaFilterBankAnalysis
from .ops.cqt import ConstantQTransform, InverseConstantQTransform
from .ops.csm import (
    AutocorrelationToCompositeSinusoidalModelCoefficients,
    CompositeSinusoidalModelCoefficientsToAutocorrelation,
)
from .ops.dct import (
    DiscreteCosineTransform,
    DiscreteHartleyTransform,
    DiscreteSineTransform,
    InverseDiscreteCosineTransform,
    InverseDiscreteHartleyTransform,
    InverseDiscreteSineTransform,
    InverseWalshHadamardTransform,
    WalshHadamardTransform,
)
from .ops.delta import Delta, MaximumLikelihoodParameterGeneration
from .ops.dfs import (
    InfiniteImpulseResponseDigitalFilter,
    SecondOrderDigitalFilter,
)
from .ops.drc import DynamicRangeCompression
from .ops.dtw import DynamicTimeWarping
from .ops.excite import ExcitationGeneration
from .ops.fbank import (
    InverseMelFilterBankAnalysis,
    MelFilterBankAnalysis,
    MelFrequencyCepstralCoefficientsAnalysis,
    PerceptualLinearPredictiveCoefficientsAnalysis,
)
from .ops.fftr import (
    RealValuedFastFourierTransform,
    RealValuedInverseFastFourierTransform,
)
from .ops.frame import Frame
from .ops.freqt import FrequencyTransform
from .ops.freqt2 import (
    SecondOrderAllPassFrequencyTransform,
    SecondOrderAllPassInverseFrequencyTransform,
)
from .ops.gammatone import (
    GammatoneFilterBankAnalysis,
    GammatoneFilterBankSynthesis,
)
from .ops.gnorm import (
    GeneralizedCepstrumGainNormalization,
    GeneralizedCepstrumInverseGainNormalization,
)
from .ops.levdur import LevinsonDurbin, ReverseLevinsonDurbin
from .ops.linear_intpl import LinearInterpolation
from .ops.lpc import LinearPredictiveCodingAnalysis
from .ops.lsp import (
    LinearPredictiveCoefficientsStabilityCheck,
    LinearPredictiveCoefficientsToLineSpectralPairs,
    LineSpectralPairsStabilityCheck,
    LineSpectralPairsToLinearPredictiveCoefficients,
    LineSpectralPairsToSpectrum,
)
from .ops.mc2b import (
    MelCepstrumToMLSADigitalFilterCoefficients,
    MLSADigitalFilterCoefficientsToMelCepstrum,
)
from .ops.mcep import CoefficientsFrequencyTransform, MelCepstralAnalysis
from .ops.mcpf import (
    MelCepstrumInversePowerNormalization,
    MelCepstrumPostfiltering,
    MelCepstrumPowerNormalization,
    MLSADigitalFilterStabilityCheck,
)
from .ops.mdct import (
    HilbertTransform,
    InverseModifiedDiscreteCosineTransform,
    InverseModifiedDiscreteSineTransform,
    InverseModifiedDiscreteTransform,
    ModifiedDiscreteCosineTransform,
    ModifiedDiscreteSineTransform,
    ModifiedDiscreteTransform,
)
from .ops.mgc2mgc import MelGeneralizedCepstrumToMelGeneralizedCepstrum
from .ops.mgc2sp import MelGeneralizedCepstrumToSpectrum
from .ops.mgcep import MelGeneralizedCepstralAnalysis
from .ops.mglsadf import (
    PseudoInverseMGLSADigitalFilter,
    PseudoMGLSADigitalFilter,
)
from .ops.griffin import GriffinLim
from .ops.pitch import Pitch
from .ops.pitch_spec import PitchAdaptiveSpectralAnalysis
from .ops.parcor import (
    AllPoleToAllZeroDigitalFilterCoefficients,
    AllZeroToAllPoleDigitalFilterCoefficients,
    InverseSineToParcorCoefficients,
    LinearPredictiveCoefficientsToParcorCoefficients,
    LogAreaRatioToParcorCoefficients,
    ParcorCoefficientsToInverseSine,
    ParcorCoefficientsToLinearPredictiveCoefficients,
    ParcorCoefficientsToLogAreaRatio,
)
from .ops.poledf import AllPoleDigitalFilter
from .ops.rootpol import PolynomialToRoots, RootsToPolynomial
from .ops.pqmf import (
    FractionalOctaveBandAnalysis,
    PseudoQuadratureMirrorFilterBankAnalysis,
    PseudoQuadratureMirrorFilterBankSynthesis,
)
from .ops.smcep import SecondOrderAllPassMelCepstralAnalysis
from .ops.spec import Spectrum
from .ops.stft import (
    InverseShortTimeFourierTransform,
    ShortTimeFourierTransform,
)
from .ops.unframe import Unframe
from .ops.window import Window
from .ops.world_synth import WorldSynthesis
from .ops.zerodf import AllZeroDigitalFilter
from .signals import mseq, mseq_like
from .utils.carry import load_jax_params

STFT = ShortTimeFourierTransform
ISTFT = InverseShortTimeFourierTransform
FFTR = RealValuedFastFourierTransform
IFFTR = RealValuedInverseFastFourierTransform
LPC = LinearPredictiveCodingAnalysis
MLSA = PseudoMGLSADigitalFilter
IMLSA = PseudoInverseMGLSADigitalFilter
CQT = ConstantQTransform
ICQT = InverseConstantQTransform
MDCT = ModifiedDiscreteCosineTransform
IMDCT = InverseModifiedDiscreteCosineTransform
MDST = ModifiedDiscreteSineTransform
IMDST = InverseModifiedDiscreteSineTransform
PQMF = PseudoQuadratureMirrorFilterBankAnalysis
IPQMF = PseudoQuadratureMirrorFilterBankSynthesis
DCT = DiscreteCosineTransform
IDCT = InverseDiscreteCosineTransform
DST = DiscreteSineTransform
IDST = InverseDiscreteSineTransform
DHT = DiscreteHartleyTransform
IDHT = InverseDiscreteHartleyTransform
WHT = WalshHadamardTransform
IWHT = InverseWalshHadamardTransform
FBANK = MelFilterBankAnalysis
IFBANK = InverseMelFilterBankAnalysis
MFCC = MelFrequencyCepstralCoefficientsAnalysis
PLP = PerceptualLinearPredictiveCoefficientsAnalysis
DRC = DynamicRangeCompression
DTW = DynamicTimeWarping
IIR = InfiniteImpulseResponseDigitalFilter
MLPG = MaximumLikelihoodParameterGeneration

__all__ = [
    "ALawCompression",
    "ALawExpansion",
    "AllPoleDigitalFilter",
    "AllPoleToAllZeroDigitalFilterCoefficients",
    "AllZeroDigitalFilter",
    "AllZeroToAllPoleDigitalFilterCoefficients",
    "Aperiodicity",
    "Autocorrelation",
    "AutocorrelationToCompositeSinusoidalModelCoefficients",
    "BaseNonFunctionalOp",
    "BaseOp",
    "CQT",
    "CepstralAnalysis",
    "CepstralDistance",
    "CepstrumToAutocorrelation",
    "CepstrumToMinimumPhaseImpulseResponse",
    "CepstrumToNegativeDerivativeOfPhaseSpectrum",
    "ChromaFilterBankAnalysis",
    "CoefficientsFrequencyTransform",
    "CompositeSinusoidalModelCoefficientsToAutocorrelation",
    "ConstantQTransform",
    "DCT",
    "DHT",
    "DRC",
    "DST",
    "DTW",
    "Delta",
    "Design",
    "DiscreteCosineTransform",
    "DiscreteHartleyTransform",
    "DiscreteSineTransform",
    "DynamicRangeCompression",
    "DynamicTimeWarping",
    "ExcitationGeneration",
    "FBANK",
    "FFTR",
    "FractionalOctaveBandAnalysis",
    "Frame",
    "FrequencyTransform",
    "GammatoneFilterBankAnalysis",
    "GammatoneFilterBankSynthesis",
    "GeneralizedCepstrumGainNormalization",
    "GeneralizedCepstrumInverseGainNormalization",
    "GriffinLim",
    "HilbertTransform",
    "ICQT",
    "IDCT",
    "IDHT",
    "IDST",
    "IFBANK",
    "IFFTR",
    "IIR",
    "IMDCT",
    "IMDST",
    "IMLSA",
    "IPQMF",
    "ISTFT",
    "IWHT",
    "InfiniteImpulseResponseDigitalFilter",
    "InverseConstantQTransform",
    "InverseDiscreteCosineTransform",
    "InverseDiscreteHartleyTransform",
    "InverseDiscreteSineTransform",
    "InverseMelFilterBankAnalysis",
    "InverseModifiedDiscreteCosineTransform",
    "InverseModifiedDiscreteSineTransform",
    "InverseModifiedDiscreteTransform",
    "InverseShortTimeFourierTransform",
    "InverseSineToParcorCoefficients",
    "InverseUniformQuantization",
    "InverseWalshHadamardTransform",
    "LPC",
    "LevinsonDurbin",
    "LineSpectralPairsStabilityCheck",
    "LineSpectralPairsToLinearPredictiveCoefficients",
    "LineSpectralPairsToSpectrum",
    "LinearInterpolation",
    "LinearPredictiveCodingAnalysis",
    "LinearPredictiveCoefficientsStabilityCheck",
    "LinearPredictiveCoefficientsToLineSpectralPairs",
    "LinearPredictiveCoefficientsToParcorCoefficients",
    "LogAreaRatioToParcorCoefficients",
    "MDCT",
    "MDST",
    "MFCC",
    "MLPG",
    "MLSA",
    "MLSADigitalFilterCoefficientsToMelCepstrum",
    "MLSADigitalFilterStabilityCheck",
    "MaximumLikelihoodParameterGeneration",
    "MelCepstralAnalysis",
    "MelCepstralVocoder",
    "MelCepstrumInversePowerNormalization",
    "MelCepstrumPostfiltering",
    "MelCepstrumPowerNormalization",
    "MelCepstrumToMLSADigitalFilterCoefficients",
    "MelFilterBankAnalysis",
    "MelFrequencyCepstralCoefficientsAnalysis",
    "MelGeneralizedCepstralAnalysis",
    "MelGeneralizedCepstrumToMelGeneralizedCepstrum",
    "MelGeneralizedCepstrumToSpectrum",
    "MinimumPhaseImpulseResponseToCepstrum",
    "ModifiedDiscreteCosineTransform",
    "ModifiedDiscreteSineTransform",
    "ModifiedDiscreteTransform",
    "MuLawCompression",
    "MuLawExpansion",
    "NegativeDerivativeOfPhaseSpectrumToCepstrum",
    "PLP",
    "PQMF",
    "ParcorCoefficientsToInverseSine",
    "ParcorCoefficientsToLinearPredictiveCoefficients",
    "ParcorCoefficientsToLogAreaRatio",
    "PerceptualLinearPredictiveCoefficientsAnalysis",
    "Pitch",
    "PitchAdaptiveSpectralAnalysis",
    "PolynomialToRoots",
    "PseudoInverseMGLSADigitalFilter",
    "PseudoMGLSADigitalFilter",
    "PseudoQuadratureMirrorFilterBankAnalysis",
    "PseudoQuadratureMirrorFilterBankSynthesis",
    "RealValuedFastFourierTransform",
    "RealValuedInverseFastFourierTransform",
    "ReverseLevinsonDurbin",
    "RootsToPolynomial",
    "STFT",
    "SecondOrderAllPassFrequencyTransform",
    "SecondOrderAllPassInverseFrequencyTransform",
    "SecondOrderAllPassMelCepstralAnalysis",
    "SecondOrderDigitalFilter",
    "ShortTimeFourierTransform",
    "Spectrum",
    "Unframe",
    "UniformQuantization",
    "WHT",
    "WalshHadamardTransform",
    "Window",
    "WorldSynthesis",
    "WorldVocoder",
    "load_jax_params",
    "mseq",
    "mseq_like",
    "twins",
]
