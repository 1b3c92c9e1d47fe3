"""diffsptk_tpu_torch: the PyTorch/CUDA port of diffsptk_tpu.

The port mirrors the JAX package's layout (``core``, ``ops``, ``kernels``,
``models``, ``utils``) and its public names.  Operators are
``nn.Module``s that run on the card unless built with ``device="cpu"``.
Each hand-written CUDA kernel (``csrc/``) has a plain torch twin beside it,
which is what a CPU tensor runs.  The package never imports JAX.
"""

from .core import BaseOp, Design
from .kernels.state import twins
from .models.mcep_vocoder import MelCepstralVocoder
from .models.world_vocoder import WorldVocoder
from .ops.acorr import Autocorrelation
from .ops.ap import Aperiodicity
from .ops.cep import (
    CepstralAnalysis,
    CepstralDistance,
    CepstrumToAutocorrelation,
    CepstrumToMinimumPhaseImpulseResponse,
    CepstrumToNegativeDerivativeOfPhaseSpectrum,
    MinimumPhaseImpulseResponseToCepstrum,
    NegativeDerivativeOfPhaseSpectrumToCepstrum,
)
from .ops.cqt import ConstantQTransform, InverseConstantQTransform
from .ops.csm import (
    AutocorrelationToCompositeSinusoidalModelCoefficients,
    CompositeSinusoidalModelCoefficientsToAutocorrelation,
)
from .ops.excite import ExcitationGeneration
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

__all__ = [
    "AllPoleDigitalFilter",
    "AllPoleToAllZeroDigitalFilterCoefficients",
    "AllZeroDigitalFilter",
    "AllZeroToAllPoleDigitalFilterCoefficients",
    "Aperiodicity",
    "Autocorrelation",
    "AutocorrelationToCompositeSinusoidalModelCoefficients",
    "BaseOp",
    "CQT",
    "CepstralAnalysis",
    "CepstralDistance",
    "CepstrumToAutocorrelation",
    "CepstrumToMinimumPhaseImpulseResponse",
    "CepstrumToNegativeDerivativeOfPhaseSpectrum",
    "CoefficientsFrequencyTransform",
    "CompositeSinusoidalModelCoefficientsToAutocorrelation",
    "ConstantQTransform",
    "Design",
    "ExcitationGeneration",
    "FFTR",
    "FractionalOctaveBandAnalysis",
    "Frame",
    "FrequencyTransform",
    "GeneralizedCepstrumGainNormalization",
    "GeneralizedCepstrumInverseGainNormalization",
    "HilbertTransform",
    "ICQT",
    "IFFTR",
    "IMDCT",
    "IMDST",
    "IMLSA",
    "IPQMF",
    "ISTFT",
    "InverseConstantQTransform",
    "InverseModifiedDiscreteCosineTransform",
    "InverseModifiedDiscreteSineTransform",
    "InverseModifiedDiscreteTransform",
    "InverseShortTimeFourierTransform",
    "InverseSineToParcorCoefficients",
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
    "MLSA",
    "MLSADigitalFilterCoefficientsToMelCepstrum",
    "MLSADigitalFilterStabilityCheck",
    "MelCepstralAnalysis",
    "MelCepstralVocoder",
    "MelCepstrumInversePowerNormalization",
    "MelCepstrumPostfiltering",
    "MelCepstrumPowerNormalization",
    "MelCepstrumToMLSADigitalFilterCoefficients",
    "MelGeneralizedCepstralAnalysis",
    "MelGeneralizedCepstrumToMelGeneralizedCepstrum",
    "MelGeneralizedCepstrumToSpectrum",
    "MinimumPhaseImpulseResponseToCepstrum",
    "ModifiedDiscreteCosineTransform",
    "ModifiedDiscreteSineTransform",
    "ModifiedDiscreteTransform",
    "NegativeDerivativeOfPhaseSpectrumToCepstrum",
    "PQMF",
    "ParcorCoefficientsToInverseSine",
    "ParcorCoefficientsToLinearPredictiveCoefficients",
    "ParcorCoefficientsToLogAreaRatio",
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
    "ShortTimeFourierTransform",
    "Spectrum",
    "Unframe",
    "Window",
    "WorldSynthesis",
    "WorldVocoder",
    "load_jax_params",
    "mseq",
    "mseq_like",
    "twins",
]
