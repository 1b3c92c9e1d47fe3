"""The stateless functional API (counterpart of
``diffsptk_tpu/functional.py``): the JAX package's 100 functions, with its
signatures and defaults.

Each function builds its operator once per argument set, device and dtype
(an LRU cache, ``core.BaseOp._func``) and calls it, so it runs on its
input tensor's device in its input's real dtype and takes the same route
as the class: on a CUDA float32 input, ``mcep`` and ``smcep`` reach the
Newton kernel and ``levdur``, ``lpc`` and ``plp`` at orders 13-64 over
2,048 frames or more the SPD solve kernel, as their classes do.

Examples
--------
>>> import torch
>>> import diffsptk_tpu_torch as pt
>>> import diffsptk_tpu_torch.functional as F
>>> x = pt.ramp(3, device="cpu", dtype=torch.float64)
>>> F.acorr(x, 2).round().tolist()         # as Autocorrelation(4, 2)(x)
[14.0, 8.0, 3.0]
>>> F.decimate(pt.ramp(7, device="cpu"), 2).tolist()
[0.0, 2.0, 4.0, 6.0]
>>> round(float(F.rmse(pt.step(3, device="cpu"), pt.ramp(3, device="cpu"))), 3)
1.225
"""

from __future__ import annotations

from .ops.companding import (
    ALawCompression,
    ALawExpansion,
    InverseUniformQuantization,
    MuLawCompression,
    MuLawExpansion,
    UniformQuantization,
)
from .ops.dct import (
    DiscreteCosineTransform,
    DiscreteHartleyTransform,
    DiscreteSineTransform,
    InverseDiscreteCosineTransform,
    InverseDiscreteHartleyTransform,
    InverseDiscreteSineTransform,
    WalshHadamardTransform,
)
from .ops.fftr import (
    RealValuedFastFourierTransform,
    RealValuedInverseFastFourierTransform,
)
from .ops.frame import Frame
from .ops.freqt import FrequencyTransform
from .ops.gnorm import (
    GeneralizedCepstrumGainNormalization,
    GeneralizedCepstrumInverseGainNormalization,
)
from .ops.mc2b import (
    MelCepstrumToMLSADigitalFilterCoefficients,
    MLSADigitalFilterCoefficientsToMelCepstrum,
)
from .ops.parcor import (
    AllPoleToAllZeroDigitalFilterCoefficients,
    InverseSineToParcorCoefficients,
    LinearPredictiveCoefficientsToParcorCoefficients,
    LogAreaRatioToParcorCoefficients,
    ParcorCoefficientsToInverseSine,
    ParcorCoefficientsToLinearPredictiveCoefficients,
    ParcorCoefficientsToLogAreaRatio,
)
from .ops.spec import Spectrum
from .ops.stft import (
    InverseShortTimeFourierTransform,
    ShortTimeFourierTransform,
)
from .ops.unframe import Unframe
from .ops.window import Window


def frame(x, frame_length=400, frame_period=80, center=True, zmean=False,
          mode="constant"):
    """Perform framing: (..., T) -> (..., T/P, L)."""
    return Frame._func(x, frame_length=frame_length,
                       frame_period=frame_period, center=center,
                       zmean=zmean, mode=mode)


def window(x, out_length=None, *, window="blackman", norm="power",
           symmetric=True):
    """Apply a window function to the framed input."""
    return Window._func(x, in_length=x.shape[-1], out_length=out_length,
                        window=window, norm=norm, symmetric=symmetric)


def unframe(y, out_length=None, *, frame_period=80, center=True,
            window="rectangular", norm="none", symmetric=True):
    """Revert framed waveform by overlap-add."""
    return Unframe._func(y, out_length, frame_length=y.shape[-1],
                         frame_period=frame_period, center=center,
                         window=window, norm=norm, symmetric=symmetric)


def fftr(x, fft_length=None, out_format="complex"):
    """Real-valued FFT."""
    return RealValuedFastFourierTransform._func(
        x, fft_length=fft_length, out_format=out_format)


def ifftr(y, out_length=None):
    """Inverse of fftr."""
    return RealValuedInverseFastFourierTransform._func(
        y, fft_length=2 * (y.shape[-1] - 1), out_length=out_length)


def spec(b=None, a=None, *, fft_length=512, eps=0.0, relative_floor=None,
         out_format="power"):
    """Spectrum from numerator b and/or denominator a."""
    return Spectrum._func(b, a, fft_length=fft_length, eps=eps,
                          relative_floor=relative_floor,
                          out_format=out_format, module=False)


def stft(x, *, frame_length=400, frame_period=80, fft_length=512,
         center=True, zmean=False, mode="constant", window="blackman",
         norm="power", symmetric=True, eps=1e-9, relative_floor=None,
         out_format="power"):
    """Short-time Fourier transform."""
    return ShortTimeFourierTransform._func(
        x, frame_length=frame_length, frame_period=frame_period,
        fft_length=fft_length, center=center, zmean=zmean, mode=mode,
        window=window, norm=norm, symmetric=symmetric, eps=eps,
        relative_floor=relative_floor, out_format=out_format, module=False)


def istft(y, *, out_length=None, frame_length=400, frame_period=80,
          fft_length=512, center=True, window="blackman", norm="power",
          symmetric=True):
    """Inverse short-time Fourier transform."""
    return InverseShortTimeFourierTransform._func(
        y, out_length, frame_length=frame_length, frame_period=frame_period,
        fft_length=fft_length, center=center, window=window, norm=norm,
        symmetric=symmetric, module=False)


def dct(x, dct_type=2):
    """Discrete cosine transform."""
    return DiscreteCosineTransform._func(x, dct_length=x.shape[-1],
                                         dct_type=dct_type)


def idct(y, dct_type=2):
    """Inverse discrete cosine transform."""
    return InverseDiscreteCosineTransform._func(y, dct_length=y.shape[-1],
                                                dct_type=dct_type)


def dst(x, dst_type=2):
    """Discrete sine transform."""
    return DiscreteSineTransform._func(x, dst_length=x.shape[-1],
                                       dst_type=dst_type)


def idst(y, dst_type=2):
    """Inverse discrete sine transform."""
    return InverseDiscreteSineTransform._func(y, dst_length=y.shape[-1],
                                              dst_type=dst_type)


def dht(x, dht_type=2):
    """Discrete Hartley transform."""
    return DiscreteHartleyTransform._func(x, dht_length=x.shape[-1],
                                          dht_type=dht_type)


def idht(y, dht_type=2):
    """Inverse discrete Hartley transform."""
    return InverseDiscreteHartleyTransform._func(y, dht_length=y.shape[-1],
                                                 dht_type=dht_type)


def wht(x, wht_type="natural"):
    """Walsh-Hadamard transform."""
    return WalshHadamardTransform._func(x, wht_length=x.shape[-1],
                                        wht_type=wht_type)


iwht = wht


def freqt(c, out_order, alpha=0.0):
    """Frequency transform (all-pass warping)."""
    return FrequencyTransform._func(c, in_order=c.shape[-1] - 1,
                                    out_order=out_order, alpha=alpha)


def mc2b(mc, alpha=0.0):
    """Mel-cepstrum to MLSA filter coefficients."""
    return MelCepstrumToMLSADigitalFilterCoefficients._func(
        mc, cep_order=mc.shape[-1] - 1, alpha=alpha)


def b2mc(b, alpha=0.0):
    """MLSA filter coefficients to mel-cepstrum."""
    return MLSADigitalFilterCoefficientsToMelCepstrum._func(
        b, cep_order=b.shape[-1] - 1, alpha=alpha)


def gnorm(x, gamma=0.0, c=None):
    """Gain normalization of generalized cepstrum."""
    return GeneralizedCepstrumGainNormalization._func(
        x, cep_order=x.shape[-1] - 1, gamma=gamma, c=c)


def ignorm(y, gamma=0.0, c=None):
    """Inverse gain normalization."""
    return GeneralizedCepstrumInverseGainNormalization._func(
        y, cep_order=y.shape[-1] - 1, gamma=gamma, c=c)


def alaw(x, abs_max=1.0, a=87.6):
    """A-law compression."""
    return ALawCompression._func(x, abs_max=abs_max, a=a)


def ialaw(y, abs_max=1.0, a=87.6):
    """A-law expansion."""
    return ALawExpansion._func(y, abs_max=abs_max, a=a)


def ulaw(x, abs_max=1.0, mu=255):
    """Mu-law compression."""
    return MuLawCompression._func(x, abs_max=abs_max, mu=mu)


def iulaw(y, abs_max=1.0, mu=255):
    """Mu-law expansion."""
    return MuLawExpansion._func(y, abs_max=abs_max, mu=mu)


def quantize(x, abs_max=1.0, n_bit=8, quantizer="mid-rise"):
    """Uniform quantization."""
    return UniformQuantization._func(x, abs_max=abs_max, n_bit=n_bit,
                                     quantizer=quantizer)


def dequantize(y, abs_max=1.0, n_bit=8, quantizer="mid-rise"):
    """Inverse uniform quantization."""
    return InverseUniformQuantization._func(y, abs_max=abs_max, n_bit=n_bit,
                                            quantizer=quantizer)


def lpc2par(a, gamma=1.0, c=None):
    """LPC to PARCOR."""
    return LinearPredictiveCoefficientsToParcorCoefficients._func(
        a, lpc_order=a.shape[-1] - 1, gamma=gamma, c=c)


def par2lpc(k, gamma=1.0, c=None):
    """PARCOR to LPC."""
    return ParcorCoefficientsToLinearPredictiveCoefficients._func(
        k, lpc_order=k.shape[-1] - 1, gamma=gamma, c=c)


def par2is(k):
    """PARCOR to inverse sine."""
    return ParcorCoefficientsToInverseSine._func(k,
                                                 par_order=k.shape[-1] - 1)


def is2par(s):
    """Inverse sine to PARCOR."""
    return InverseSineToParcorCoefficients._func(s,
                                                 par_order=s.shape[-1] - 1)


def par2lar(k):
    """PARCOR to log area ratio."""
    return ParcorCoefficientsToLogAreaRatio._func(k,
                                                  par_order=k.shape[-1] - 1)


def lar2par(g):
    """Log area ratio to PARCOR."""
    return LogAreaRatioToParcorCoefficients._func(g,
                                                  par_order=g.shape[-1] - 1)


def norm0(a):
    """All-pole to all-zero filter coefficients (self-inverse)."""
    return AllPoleToAllZeroDigitalFilterCoefficients._func(
        a, filter_order=a.shape[-1] - 1)


def acorr(x, acr_order, out_format="naive"):
    """Autocorrelation of a framed waveform."""
    from .ops.acorr import Autocorrelation
    return Autocorrelation._func(x, frame_length=x.shape[-1],
                                 acr_order=acr_order, out_format=out_format)


def levdur(r, eps=None):
    """Levinson-Durbin: autocorrelation -> LPC."""
    from .ops.levdur import LevinsonDurbin
    return LevinsonDurbin._func(r, lpc_order=r.shape[-1] - 1, eps=eps)


def rlevdur(a, n_fft=512):
    """Reverse Levinson-Durbin: LPC -> autocorrelation."""
    from .ops.levdur import ReverseLevinsonDurbin
    return ReverseLevinsonDurbin._func(a, lpc_order=a.shape[-1] - 1,
                                       n_fft=n_fft)


def lpc(x, lpc_order, eps=None):
    """LPC analysis of a framed waveform."""
    from .ops.lpc import LinearPredictiveCodingAnalysis
    return LinearPredictiveCodingAnalysis._func(
        x, frame_length=x.shape[-1], lpc_order=lpc_order, eps=eps,
        module=False)


def linear_intpl(x, upsampling_factor):
    """Linear interpolation from frame rate to sample rate."""
    from .ops.linear_intpl import LinearInterpolation
    return LinearInterpolation._func(x, upsampling_factor=upsampling_factor)


def poledf(x, a, frame_period, ignore_gain=False):
    """All-pole digital filtering with frame-rate coefficients."""
    from .ops.poledf import AllPoleDigitalFilter
    return AllPoleDigitalFilter._func(
        x, a, filter_order=a.shape[-1] - 1, frame_period=frame_period,
        ignore_gain=ignore_gain)


def zerodf(x, b, frame_period, ignore_gain=False):
    """All-zero digital filtering with frame-rate coefficients."""
    from .ops.zerodf import AllZeroDigitalFilter
    return AllZeroDigitalFilter._func(
        x, b, filter_order=b.shape[-1] - 1, frame_period=frame_period,
        ignore_gain=ignore_gain)


def dfs(x, b=None, a=None, ir_length=None):
    """Static digital filtering."""
    from .ops.dfs import InfiniteImpulseResponseDigitalFilter
    return InfiniteImpulseResponseDigitalFilter._func(
        x, b=b, a=a, ir_length=ir_length)


def df2(x, sample_rate, **kwargs):
    """Second-order digital filtering."""
    from .ops.dfs import SecondOrderDigitalFilter
    return SecondOrderDigitalFilter._func(x, sample_rate=sample_rate,
                                          module=False, **kwargs)


# ---------------------------------------------------------------------------
# Cepstrum / mel-cepstrum stack
# ---------------------------------------------------------------------------

def fftcep(x, cep_order, accel=0.0, n_iter=0):
    """FFT-based cepstral analysis."""
    from .ops.cep import CepstralAnalysis
    return CepstralAnalysis._func(x, fft_length=2 * (x.shape[-1] - 1),
                                  cep_order=cep_order, accel=accel,
                                  n_iter=n_iter)


def c2acr(c, acr_order, n_fft=512):
    """Cepstrum to autocorrelation."""
    from .ops.cep import CepstrumToAutocorrelation
    return CepstrumToAutocorrelation._func(
        c, cep_order=c.shape[-1] - 1, acr_order=acr_order, n_fft=n_fft)


def c2mpir(c, ir_length, n_fft=512):
    """Cepstrum to minimum-phase impulse response."""
    from .ops.cep import CepstrumToMinimumPhaseImpulseResponse
    return CepstrumToMinimumPhaseImpulseResponse._func(
        c, cep_order=c.shape[-1] - 1, ir_length=ir_length, n_fft=n_fft)


def mpir2c(h, cep_order, n_fft=512):
    """Minimum-phase impulse response to cepstrum."""
    from .ops.cep import MinimumPhaseImpulseResponseToCepstrum
    return MinimumPhaseImpulseResponseToCepstrum._func(
        h, ir_length=h.shape[-1], cep_order=cep_order, n_fft=n_fft)


def c2ndps(c, fft_length):
    """Cepstrum to negative derivative of phase spectrum."""
    from .ops.cep import CepstrumToNegativeDerivativeOfPhaseSpectrum
    return CepstrumToNegativeDerivativeOfPhaseSpectrum._func(
        c, cep_order=c.shape[-1] - 1, fft_length=fft_length)


def ndps2c(n, cep_order):
    """NDPS to cepstrum."""
    from .ops.cep import NegativeDerivativeOfPhaseSpectrumToCepstrum
    return NegativeDerivativeOfPhaseSpectrumToCepstrum._func(
        n, fft_length=2 * (n.shape[-1] - 1), cep_order=cep_order)


def cdist(c1, c2, full=False, reduction="mean"):
    """Cepstral distance."""
    from .ops.cep import CepstralDistance
    return CepstralDistance._func(c1, c2, full=full, reduction=reduction)


def mcep(x, cep_order, alpha=0.0, n_iter=0):
    """Mel-cepstral analysis."""
    from .ops.mcep import MelCepstralAnalysis
    return MelCepstralAnalysis._func(
        x, fft_length=2 * (x.shape[-1] - 1), cep_order=cep_order,
        alpha=alpha, n_iter=n_iter, module=False)


def smcep(x, cep_order, alpha=0.0, theta=0.0, n_iter=0, accuracy_factor=4):
    """Second-order all-pass mel-cepstral analysis."""
    from .ops.smcep import SecondOrderAllPassMelCepstralAnalysis
    return SecondOrderAllPassMelCepstralAnalysis._func(
        x, fft_length=2 * (x.shape[-1] - 1), cep_order=cep_order,
        alpha=alpha, theta=theta, n_iter=n_iter,
        accuracy_factor=accuracy_factor, module=False)


def mgc2mgc(mc, out_order, in_alpha=0, out_alpha=0, in_gamma=0, out_gamma=0,
            in_norm=False, out_norm=False, in_mul=False, out_mul=False,
            n_fft=512):
    """Mel-generalized cepstrum conversion."""
    from .ops.mgc2mgc import MelGeneralizedCepstrumToMelGeneralizedCepstrum
    return MelGeneralizedCepstrumToMelGeneralizedCepstrum._func(
        mc, in_order=mc.shape[-1] - 1, out_order=out_order,
        in_alpha=in_alpha, out_alpha=out_alpha, in_gamma=in_gamma,
        out_gamma=out_gamma, in_norm=in_norm, out_norm=out_norm,
        in_mul=in_mul, out_mul=out_mul, n_fft=n_fft)


def mgc2sp(mc, fft_length, alpha=0, gamma=0, norm=False, mul=False,
           n_fft=512, out_format="power"):
    """Mel-generalized cepstrum to spectrum."""
    from .ops.mgc2sp import MelGeneralizedCepstrumToSpectrum
    return MelGeneralizedCepstrumToSpectrum._func(
        mc, cep_order=mc.shape[-1] - 1, fft_length=fft_length, alpha=alpha,
        gamma=gamma, norm=norm, mul=mul, n_fft=n_fft,
        out_format=out_format, module=False)


def freqt2(c, out_order, alpha=0, theta=0, n_fft=512):
    """Second-order all-pass frequency transform."""
    from .ops.freqt2 import SecondOrderAllPassFrequencyTransform
    return SecondOrderAllPassFrequencyTransform._func(
        c, in_order=c.shape[-1] - 1, out_order=out_order, alpha=alpha,
        theta=theta, n_fft=n_fft)


def ifreqt2(c, out_order, alpha=0, theta=0, n_fft=512):
    """Second-order all-pass inverse frequency transform."""
    from .ops.freqt2 import SecondOrderAllPassInverseFrequencyTransform
    return SecondOrderAllPassInverseFrequencyTransform._func(
        c, in_order=c.shape[-1] - 1, out_order=out_order, alpha=alpha,
        theta=theta, n_fft=n_fft)


def pnorm(x, alpha=0, ir_length=128):
    """Mel-cepstrum power normalization."""
    from .ops.mcpf import MelCepstrumPowerNormalization
    return MelCepstrumPowerNormalization._func(
        x, cep_order=x.shape[-1] - 1, alpha=alpha, ir_length=ir_length,
        module=False)


def ipnorm(y):
    """Mel-cepstrum inverse power normalization."""
    from .ops.mcpf import MelCepstrumInversePowerNormalization
    return MelCepstrumInversePowerNormalization._func(
        y, cep_order=y.shape[-1] - 2)


def mcpf(mc, alpha=0, beta=0, onset=2, ir_length=128):
    """Mel-cepstrum postfiltering."""
    from .ops.mcpf import MelCepstrumPostfiltering
    return MelCepstrumPostfiltering._func(
        mc, cep_order=mc.shape[-1] - 1, alpha=alpha, beta=beta, onset=onset,
        ir_length=ir_length, module=False)


def mlsacheck(mc, **kwargs):
    """MLSA filter stability check."""
    from .ops.mcpf import MLSADigitalFilterStabilityCheck
    return MLSADigitalFilterStabilityCheck._func(
        mc, cep_order=mc.shape[-1] - 1, **kwargs)


# ---------------------------------------------------------------------------
# LSP / roots
# ---------------------------------------------------------------------------

def lpc2lsp(a, log_gain=False, sample_rate=None, out_format="radian"):
    """LPC to line spectral pairs."""
    from .ops.lsp import LinearPredictiveCoefficientsToLineSpectralPairs
    return LinearPredictiveCoefficientsToLineSpectralPairs._func(
        a, lpc_order=a.shape[-1] - 1, log_gain=log_gain,
        sample_rate=sample_rate, out_format=out_format)


def lsp2lpc(w, log_gain=False, sample_rate=None, in_format="radian"):
    """Line spectral pairs to LPC."""
    from .ops.lsp import LineSpectralPairsToLinearPredictiveCoefficients
    return LineSpectralPairsToLinearPredictiveCoefficients._func(
        w, lpc_order=w.shape[-1] - 1, log_gain=log_gain,
        sample_rate=sample_rate, in_format=in_format)


def lsp2sp(w, fft_length, alpha=0, gamma=-1, log_gain=False,
           out_format="power"):
    """LSP to spectrum."""
    from .ops.lsp import LineSpectralPairsToSpectrum
    return LineSpectralPairsToSpectrum._func(
        w, lsp_order=w.shape[-1] - 1, fft_length=fft_length, alpha=alpha,
        gamma=gamma, log_gain=log_gain, out_format=out_format)


def lpccheck(a, margin=1e-16, warn_type="warn"):
    """LPC stability check."""
    from .ops.lsp import LinearPredictiveCoefficientsStabilityCheck
    return LinearPredictiveCoefficientsStabilityCheck._func(
        a, lpc_order=a.shape[-1] - 1, margin=margin, warn_type=warn_type)


def lspcheck(w, rate=0.0, n_iter=1, warn_type="warn"):
    """LSP stability check."""
    from .ops.lsp import LineSpectralPairsStabilityCheck
    return LineSpectralPairsStabilityCheck._func(
        w, lsp_order=w.shape[-1] - 1, rate=rate, n_iter=n_iter,
        warn_type=warn_type)


def root_pol(a, eps=None, out_format="rectangular"):
    """Polynomial to roots."""
    from .ops.rootpol import PolynomialToRoots
    return PolynomialToRoots._func(a, order=a.shape[-1] - 1, eps=eps,
                                   out_format=out_format)


def pol_root(x, eps=None, in_format="rectangular"):
    """Roots to polynomial."""
    from .ops.rootpol import RootsToPolynomial
    return RootsToPolynomial._func(x, order=x.shape[-1], eps=eps,
                                   in_format=in_format)


def acr2csm(r):
    """Autocorrelation to CSM coefficients."""
    from .ops.csm import (
        AutocorrelationToCompositeSinusoidalModelCoefficients)
    return AutocorrelationToCompositeSinusoidalModelCoefficients._func(
        r, acr_order=r.shape[-1] - 1)


def csm2acr(c):
    """CSM coefficients to autocorrelation."""
    from .ops.csm import (
        CompositeSinusoidalModelCoefficientsToAutocorrelation)
    return CompositeSinusoidalModelCoefficientsToAutocorrelation._func(
        c, acr_order=c.shape[-1] - 1)


# ---------------------------------------------------------------------------
# Filterbanks / transforms
# ---------------------------------------------------------------------------

def fbank(x, n_channel, sample_rate, **kwargs):
    """Mel filterbank analysis."""
    from .ops.fbank import MelFilterBankAnalysis
    return MelFilterBankAnalysis._func(
        x, fft_length=2 * (x.shape[-1] - 1), n_channel=n_channel,
        sample_rate=sample_rate, **kwargs)


def ifbank(y, fft_length, sample_rate, **kwargs):
    """Inverse mel filterbank analysis."""
    from .ops.fbank import InverseMelFilterBankAnalysis
    return InverseMelFilterBankAnalysis._func(
        y, n_channel=y.shape[-1], fft_length=fft_length,
        sample_rate=sample_rate, **kwargs)


def mfcc(x, mfcc_order, n_channel, sample_rate, **kwargs):
    """MFCC analysis."""
    from .ops.fbank import MelFrequencyCepstralCoefficientsAnalysis
    return MelFrequencyCepstralCoefficientsAnalysis._func(
        x, fft_length=2 * (x.shape[-1] - 1), mfcc_order=mfcc_order,
        n_channel=n_channel, sample_rate=sample_rate, module=False,
        **kwargs)


def plp(x, plp_order, n_channel, sample_rate, **kwargs):
    """PLP analysis."""
    from .ops.fbank import PerceptualLinearPredictiveCoefficientsAnalysis
    return PerceptualLinearPredictiveCoefficientsAnalysis._func(
        x, fft_length=2 * (x.shape[-1] - 1), plp_order=plp_order,
        n_channel=n_channel, sample_rate=sample_rate, module=False,
        **kwargs)


def chroma(x, n_channel, sample_rate, norm=float("inf"), use_power=True):
    """Chroma filterbank analysis."""
    from .ops.chroma import ChromaFilterBankAnalysis
    return ChromaFilterBankAnalysis._func(
        x, fft_length=2 * (x.shape[-1] - 1), n_channel=n_channel,
        sample_rate=sample_rate, norm=norm, use_power=use_power)


def mdct(x, frame_length, window="sine"):
    """Modified discrete cosine transform."""
    from .ops.mdct import ModifiedDiscreteCosineTransform
    return ModifiedDiscreteCosineTransform._func(
        x, frame_length=frame_length, window=window, module=False)


def imdct(y, out_length=None, window="sine"):
    """Inverse MDCT."""
    from .ops.mdct import InverseModifiedDiscreteCosineTransform
    return InverseModifiedDiscreteCosineTransform._func(
        y, out_length, frame_length=2 * y.shape[-1], window=window,
        module=False)


def mdst(x, frame_length, window="sine"):
    """Modified discrete sine transform."""
    from .ops.mdct import ModifiedDiscreteSineTransform
    return ModifiedDiscreteSineTransform._func(
        x, frame_length=frame_length, window=window, module=False)


def imdst(y, out_length=None, window="sine"):
    """Inverse MDST."""
    from .ops.mdct import InverseModifiedDiscreteSineTransform
    return InverseModifiedDiscreteSineTransform._func(
        y, out_length, frame_length=2 * y.shape[-1], window=window,
        module=False)


def hilbert(x, fft_length=None, dim=-1):
    """Analytic signal via Hilbert transform."""
    from .ops.mdct import HilbertTransform
    if fft_length is None:
        fft_length = x.shape[dim]
    return HilbertTransform._func(x, fft_length=fft_length, dim=dim)


def griffin(y, out_length=None, **kwargs):
    """Griffin-Lim phase reconstruction."""
    from .ops.griffin import GriffinLim
    return GriffinLim._func(y, out_length, module=False, **kwargs)


# ---------------------------------------------------------------------------
# Misc / metrics
# ---------------------------------------------------------------------------

def decimate(x, period, start=0, dim=-1):
    """Decimation."""
    from .ops.misc import Decimation
    return Decimation._func(x, period=period, start=start, dim=dim)


def interpolate(x, period, start=0, dim=-1):
    """Zero-stuffing interpolation."""
    from .ops.misc import Interpolation
    return Interpolation._func(x, period=period, start=start, dim=dim)


def delay(x, start, keeplen=False, dim=-1):
    """Delay or advance."""
    from .ops.misc import Delay
    return Delay._func(x, start=start, keeplen=keeplen, dim=dim)


def entropy(p, out_format="nat"):
    """Shannon entropy."""
    from .ops.misc import Entropy
    return Entropy._func(p, out_format=out_format)


def histogram(x, n_bin=10, lower_bound=0.0, upper_bound=1.0, norm=False,
              softness=1e-3):
    """Soft histogram."""
    from .ops.misc import Histogram
    return Histogram._func(x, n_bin=n_bin, lower_bound=lower_bound,
                           upper_bound=upper_bound, norm=norm,
                           softness=softness)


def snr(s, sn, frame_length=None, full=False, reduction="mean", eps=1e-8):
    """(Segmental) signal-to-noise ratio."""
    from .ops.misc import SignalToNoiseRatio
    return SignalToNoiseRatio._func(s, sn, frame_length=frame_length,
                                    full=full, reduction=reduction, eps=eps)


def rmse(x, y, reduction="mean"):
    """Root mean square error."""
    from .ops.misc import RootMeanSquareError
    return RootMeanSquareError._func(x, y, reduction=reduction)


def f0eval(x, y, reduction="mean", out_format="f0-rmse-cent"):
    """F0 / voicing evaluation."""
    from .ops.misc import F0Evaluation
    return F0Evaluation._func(x, y, reduction=reduction,
                              out_format=out_format)


def flux(x, y=None, lag=1, norm=2, reduction="mean"):
    """Spectral flux."""
    from .ops.misc import Flux
    return Flux._func(x, y, lag=lag, norm=norm, reduction=reduction)


def zcross(x, frame_length, norm=False, softness=1e-3):
    """Zero-crossing rate."""
    from .ops.misc import ZeroCrossingAnalysis
    return ZeroCrossingAnalysis._func(x, frame_length=frame_length,
                                      norm=norm, softness=softness)


def grpdelay(b=None, a=None, *, fft_length=512, alpha=1.0, gamma=1.0):
    """Group delay."""
    from .ops.misc import GroupDelay
    return GroupDelay._func(b, a, fft_length=fft_length, alpha=alpha,
                            gamma=gamma)


def phase(b=None, a=None, *, fft_length=512, unwrap=False):
    """Phase spectrum."""
    from .ops.misc import Phase
    return Phase._func(b, a, fft_length=fft_length, unwrap=unwrap)


def yingram(x, sample_rate=22050, lag_min=22, lag_max=None, n_bin=20):
    """Yingram."""
    from .ops.misc import Yingram
    return Yingram._func(x, frame_length=x.shape[-1],
                         sample_rate=sample_rate, lag_min=lag_min,
                         lag_max=lag_max, n_bin=n_bin)


def medfilt(x, filter_length=3, across_features=False, magic_number=None):
    """Median filtering."""
    from .ops.misc import MedianFilter
    return MedianFilter._func(x, filter_length=filter_length,
                              across_features=across_features,
                              magic_number=magic_number)


def magic_intpl(x, magic_number=0.0):
    """Magic number interpolation."""
    from .ops.misc import MagicNumberInterpolation
    return MagicNumberInterpolation._func(x, magic_number=magic_number)


def delta(x, seed=[[-0.5, 0.0, 0.5]], static_out=True):
    """Delta features."""
    from .ops.delta import Delta
    return Delta._func(x, seed=seed, static_out=static_out)


def mlpg(u, seed=[[-0.5, 0.0, 0.5], [1.0, -2.0, 1.0]]):
    """Maximum-likelihood parameter generation."""
    from .ops.delta import MaximumLikelihoodParameterGeneration
    return MaximumLikelihoodParameterGeneration._func(
        u, size=u.shape[-2], seed=seed)


def dtw(x, y, lengths=None, return_indices=False, metric="euclidean", p=4,
        softness=1e-3):
    """Soft dynamic time warping."""
    from .ops.dtw import DynamicTimeWarping
    return DynamicTimeWarping._func(x, y, lengths, return_indices,
                                    metric=metric, p=p, softness=softness)


def dtw_merge(x, y, indices):
    """Merge sequences along a DTW path."""
    from .ops.dtw import DynamicTimeWarping
    return DynamicTimeWarping.merge(x, y, indices)


def drc(x, sample_rate, threshold=-20, ratio=2, attack_time=1,
        release_time=500, makeup_gain=0, abs_max=1):
    """Dynamic range compression."""
    from .ops.drc import DynamicRangeCompression
    return DynamicRangeCompression._func(
        x, sample_rate=sample_rate, threshold=threshold, ratio=ratio,
        attack_time=attack_time, release_time=release_time,
        makeup_gain=makeup_gain, abs_max=abs_max)


def excite(p, frame_period=80, voiced_region="pulse",
           unvoiced_region="gauss", polarity="auto", init_phase="zeros"):
    """Excitation generation."""
    from .ops.excite import ExcitationGeneration
    return ExcitationGeneration._func(
        p, frame_period=frame_period, voiced_region=voiced_region,
        unvoiced_region=unvoiced_region, polarity=polarity,
        init_phase=init_phase)
