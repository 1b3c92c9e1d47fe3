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
from .ops.acorr import Autocorrelation
from .ops.fftr import RealValuedFastFourierTransform
from .ops.frame import Frame
from .ops.freqt import FrequencyTransform
from .ops.gnorm import (
    GeneralizedCepstrumGainNormalization,
    GeneralizedCepstrumInverseGainNormalization,
)
from .ops.levdur import LevinsonDurbin, ReverseLevinsonDurbin
from .ops.lpc import LinearPredictiveCodingAnalysis
from .ops.mcep import CoefficientsFrequencyTransform, MelCepstralAnalysis
from .ops.mgc2mgc import MelGeneralizedCepstrumToMelGeneralizedCepstrum
from .ops.mglsadf import (
    PseudoInverseMGLSADigitalFilter,
    PseudoMGLSADigitalFilter,
)
from .ops.parcor import (
    AllPoleToAllZeroDigitalFilterCoefficients,
    AllZeroToAllPoleDigitalFilterCoefficients,
)
from .ops.poledf import AllPoleDigitalFilter
from .ops.spec import Spectrum
from .ops.stft import ShortTimeFourierTransform
from .ops.window import Window
from .ops.zerodf import AllZeroDigitalFilter
from .utils.carry import load_jax_params

STFT = ShortTimeFourierTransform
LPC = LinearPredictiveCodingAnalysis
MLSA = PseudoMGLSADigitalFilter
IMLSA = PseudoInverseMGLSADigitalFilter

__all__ = [
    "AllPoleDigitalFilter",
    "AllPoleToAllZeroDigitalFilterCoefficients",
    "AllZeroDigitalFilter",
    "AllZeroToAllPoleDigitalFilterCoefficients",
    "Autocorrelation",
    "BaseOp",
    "CoefficientsFrequencyTransform",
    "Design",
    "Frame",
    "FrequencyTransform",
    "GeneralizedCepstrumGainNormalization",
    "GeneralizedCepstrumInverseGainNormalization",
    "IMLSA",
    "LPC",
    "LevinsonDurbin",
    "LinearPredictiveCodingAnalysis",
    "MLSA",
    "MelCepstralAnalysis",
    "MelCepstralVocoder",
    "MelGeneralizedCepstrumToMelGeneralizedCepstrum",
    "PseudoInverseMGLSADigitalFilter",
    "PseudoMGLSADigitalFilter",
    "RealValuedFastFourierTransform",
    "ReverseLevinsonDurbin",
    "STFT",
    "ShortTimeFourierTransform",
    "Spectrum",
    "Window",
    "load_jax_params",
    "twins",
]
