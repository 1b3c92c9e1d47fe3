"""Neural pitch extraction networks (counterpart of
``diffsptk_tpu/ops/pitch_nn.py``).

* CREPE [Kim et al. 2018], the torchcrepe architecture, "full" and
  "tiny" capacities;
* FCNF0++ [Morrison et al. 2023], the penn architecture (1024-sample
  frames at 8 kHz -> 1440 pitch bins, five-cent resolution).

Each extractor is an ``nn.Module`` holding its network's weights as
float32 buffers under the torch state-dict names of the released
checkpoints (``conv1.weight``, ``conv1_BN.running_mean``,
``block0.norm.weight``, ...), so ``load_jax_params(extractor,
jax_extractor.params)`` carries the JAX package's weights across.  The
weights stay float32 whatever dtype the module is moved to, and the
networks run in float32 with the result cast back to the input's dtype,
as in the JAX package.

The JAX package pins the networks' convolutions to
``Precision.DEFAULT``, one reduced-precision pass.  On the card each
extractor runs its network at one fixed precision, its class constant
``PRECISION``.  FCNF0 takes TF32 (``"tf32"``): each of its convs with
more than one input channel runs in TF32 as a channels-last 2-D
convolution, where cuDNN takes tensor-core kernels, and its f0 stays
within 0.31 cents of full fp32.  CREPE takes full fp32 (``"full"``): in
TF32 its Viterbi decode moved to another path on some frames, 105 cents
away (``chip_smoke.py`` [pitch-crepe], NVIDIA H100).  Each network's
first conv, with one input channel, runs in full fp32 as a 1-D
convolution either way, where cuDNN's TF32 kernels are the slower
(``tools/torch_pitch_conv.py``).  Everything around the networks
(resampling, framing, decoding, loudness) stays in full fp32.  The CPU
has no TF32 and takes plain 1-D convolutions.

``weights=None`` takes the checkpoint bundled with the JAX package
(``diffsptk_tpu/assets/*.npz``), read by file path; CREPE "full" has
none and falls back to a deterministic random initialization with a
warning, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import logging
import math
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core import child, place
from ..utils.resample import Resampler
from .stft import ShortTimeFourierTransform


def hop_frames(x: torch.Tensor, window: int, hop: int,
               mode: str = "constant", zmean: bool = False) -> torch.Tensor:
    """Centered frames at every hop multiple in [0, T]: T // hop + 1
    frames (the torchcrepe/penn hop convention)."""
    T = x.shape[-1]
    n = T // hop + 1
    left = window // 2
    right = max((n - 1) * hop + window - left - T, 0)
    shape = x.shape
    xp = F.pad(x.reshape(-1, 1, T), (left, right), mode=mode)
    xp = xp.reshape(shape[:-1] + (xp.shape[-1],))
    y = xp.unfold(-1, window, hop)[..., :n, :]
    if zmean:
        y = y - torch.mean(y, dim=-1, keepdim=True)
    return y


logger = logging.getLogger("diffsptk_tpu_torch")

UNVOICED_SYMBOL = 0.0

# ------------------------------------------------------------------ CREPE
CREPE_SAMPLE_RATE = 16000
CREPE_WINDOW_SIZE = 1024
CREPE_PITCH_BINS = 360
CREPE_CENTS_PER_BIN = 20.0
CREPE_CENTS_OFFSET = 1997.3794084376191
CREPE_MAX_FMAX = 2006.0
LOUDNESS_REF_DB = 20.0
LOUDNESS_MIN_DB = -100.0

_CREPE_CAPACITY = {
    "full": dict(in_channels=[1, 1024, 128, 128, 128, 256],
                 out_channels=[1024, 128, 128, 128, 256, 512],
                 in_features=2048),
    "tiny": dict(in_channels=[1, 128, 16, 16, 16, 32],
                 out_channels=[128, 16, 16, 16, 32, 64],
                 in_features=256),
}
_CREPE_KERNELS = [512, 64, 64, 64, 64, 64]
_CREPE_STRIDES = [4, 1, 1, 1, 1, 1]
_CREPE_PADS = [(254, 254)] + [(31, 32)] * 5
_CREPE_BN_EPS = 0.0010000000474974513

# Frames through a network at a time.  In one pass FCNF0 holds about 2.3
# MiB a frame (17.7 GiB for [pitch-fcnf0]'s 7,712 frames) and runs the 80
# GB card out of memory at 61,696 frames, 32 rows of 10 s at 16 kHz;
# CREPE "full" does at 30,848.  In chunks of 2,048 the peak stays at 5-6
# GiB, and the time is within 6 % of one pass either way
# (tools/torch_pitch_memory.py, NVIDIA H100).
FRAMES_PER_CHUNK = 2048

# The checkpoints that the JAX package bundles, trained there on
# synthetic pitched audio.
BUNDLED_WEIGHTS = {"crepe-tiny": "crepe_tiny_synth.npz",
                   "fcnf0": "fcnf0_synth.npz"}


def crepe_cents_to_frequency(cents):
    """Cents on the CREPE scale (ref 10 Hz) -> Hz."""
    return 10.0 * 2.0 ** (cents / 1200.0)


def crepe_bins_to_cents(bins):
    return CREPE_CENTS_PER_BIN * bins + CREPE_CENTS_OFFSET


def init_crepe_params(model: str = "full", seed: int = 0) -> dict:
    """Deterministic random init with torch-state-dict naming: the JAX
    package's draws, in the same order."""
    rng = np.random.RandomState(seed)
    params = {}
    for name, shape in crepe_shapes(model).items():
        if name == "classifier.weight":
            params[name] = rng.randn(*shape).astype(np.float32) / math.sqrt(
                shape[1])
        elif name.endswith(".weight") and "_BN" not in name:
            params[name] = rng.randn(*shape).astype(np.float32) * (
                1.0 / math.sqrt(shape[1] * shape[2]))
        elif name.endswith(("_BN.weight", "running_var")):
            params[name] = np.ones(shape, np.float32)
        else:
            params[name] = np.zeros(shape, np.float32)
    return params


def crepe_shapes(model: str = "full") -> dict:
    """The shape of every parameter of a CREPE network."""
    cap = _CREPE_CAPACITY[model]
    shapes = {}
    for i, (ci, co, k) in enumerate(zip(cap["in_channels"],
                                        cap["out_channels"],
                                        _CREPE_KERNELS), start=1):
        shapes[f"conv{i}.weight"] = (co, ci, k)
        for name in ("conv{}.bias", "conv{}_BN.weight", "conv{}_BN.bias",
                     "conv{}_BN.running_mean", "conv{}_BN.running_var"):
            shapes[name.format(i)] = (co,)
    shapes["classifier.weight"] = (CREPE_PITCH_BINS, cap["in_features"])
    shapes["classifier.bias"] = (CREPE_PITCH_BINS,)
    return shapes


def bundled_weights_path(name: str):
    """Path of a checkpoint bundled with the JAX package
    (``diffsptk_tpu/assets``, a data file beside this package), or None."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.path.join(root, "diffsptk_tpu", "assets", name)
    return path if os.path.isfile(path) else None


def load_params(weights, init_fn, expect: dict | None = None,
                bundled: str | None = None) -> dict:
    """Load a parameter dict (numpy arrays) from a dict, an .npz file or a
    torch checkpoint.

    ``weights=None`` takes the bundled checkpoint named ``bundled``,
    which must then exist; with neither, a deterministic random init
    (``init_fn()``) is used with a warning.  ``expect`` maps each
    parameter name to its shape (or an array of that shape); a missing
    name or another shape raises ``ValueError``."""
    if weights is None and bundled is not None:
        path = bundled_weights_path(bundled)
        if path is None:
            raise FileNotFoundError(
                f"the bundled checkpoint {bundled} is not in "
                f"diffsptk_tpu/assets; pass weights= explicitly")
        logger.info("using bundled checkpoint %s", path)
        weights = path
    if weights is None:
        logger.warning(
            "no pretrained weights supplied; using deterministic random "
            "initialization — pitch output will not be meaningful. Pass "
            "weights='/path/to/checkpoint' (npz or torch state dict).")
        return init_fn()
    if isinstance(weights, dict):
        raw = weights
    elif str(weights).endswith(".npz"):
        with np.load(weights) as f:
            raw = dict(f)
    else:
        state = torch.load(weights, map_location="cpu", weights_only=False)
        if hasattr(state, "state_dict"):
            state = state.state_dict()
        elif isinstance(state, dict) and "state_dict" in state:
            state = state["state_dict"]
        raw = {k: v for k, v in state.items() if hasattr(v, "detach")}
    params = {k: (v.detach().cpu().numpy() if hasattr(v, "detach")
                  else np.asarray(v)) for k, v in raw.items()}
    if expect is not None:
        missing = [k for k in expect if k not in params]
        if missing:
            raise ValueError(f"checkpoint is missing parameters: {missing}")
        for k, ref in expect.items():
            shape = tuple(getattr(ref, "shape", ref))
            if tuple(params[k].shape) != shape:
                raise ValueError(
                    f"shape mismatch for {k}: checkpoint "
                    f"{params[k].shape} vs architecture {shape}")
    return params


class Float32Weights(nn.Module):
    """A node of a network's weight tree.  Its floating buffers stay
    float32 whatever dtype the tree is moved to (``place``, ``.to``,
    ``.double()``): the networks run in float32, as in the JAX package."""

    def _apply(self, fn, recurse=True):
        def keep_float32(t):
            out = fn(t)
            return out.float() if out.is_floating_point() else out

        return super()._apply(keep_float32, recurse)


def attach_weights(module: nn.Module, params: dict) -> tuple:
    """Register ``params`` under ``module`` as float32 buffers of
    :class:`Float32Weights` nodes, by their dotted names; returns the
    names in order."""
    for name, value in params.items():
        path = name.split(".")
        if len(path) < 2:
            raise ValueError(f"a weight name needs a node: {name}")
        node = module
        for part in path[:-1]:
            nxt = getattr(node, part, None)
            if nxt is None:
                nxt = Float32Weights()
                node.add_module(part, nxt)
            node = nxt
        node.register_buffer(path[-1], torch.as_tensor(
            np.asarray(value, np.float32)))
    return tuple(params)


def gather_weights(module: nn.Module, names) -> dict:
    buffers = dict(module.named_buffers())
    return {name: buffers[name] for name in names}


@contextlib.contextmanager
def network_precision(precision: str = "tf32"):
    """The networks' scope on the card: ``"tf32"`` lets cuDNN's
    convolutions and the matmuls take TF32 (the counterpart of the JAX
    package's ``Precision.DEFAULT``), ``"full"`` keeps full fp32.  The
    flags are restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    tf32 = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def run_network(forward, frames: torch.Tensor) -> torch.Tensor:
    """``forward`` over (M, L) float32 frames, ``FRAMES_PER_CHUNK`` at a
    time (each frame is independent, so the result does not depend on
    the chunking)."""
    step = FRAMES_PER_CHUNK
    return torch.cat([forward(frames[i:i + step])
                      for i in range(0, frames.shape[0], step)])


def conv(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
         stride: int = 1, precision: str = "full") -> torch.Tensor:
    """One network layer's VALID convolution, (B, Ci, L) -> (B, Co, L').
    On the card with ``precision="tf32"`` a layer with Ci > 1 runs in TF32
    as a channels-last (B, Ci, 1, L) 2-D convolution; everything else in
    full fp32 as a 1-D convolution."""
    if precision == "tf32" and h.is_cuda and w.shape[1] > 1:
        h4 = h[:, :, None, :].contiguous(memory_format=torch.channels_last)
        w4 = w[:, :, None, :].contiguous(memory_format=torch.channels_last)
        with network_precision("tf32"):
            return F.conv2d(h4, w4, b, stride=(1, stride))[:, :, 0, :]
    with network_precision("full"):
        return F.conv1d(h, w, b, stride=stride)


def crepe_forward(params: dict, x: torch.Tensor, model: str = "full",
                  embed: bool = False, precision: str = "full"
                  ) -> torch.Tensor:
    """CREPE forward: (B, 1024) frames -> (B, 360) probabilities (sigmoid)
    or (B, D) embeddings.  torchcrepe's layer order: conv -> ReLU ->
    BatchNorm(eval) -> MaxPool(2).  ``precision`` as for :func:`conv`."""
    cap = _CREPE_CAPACITY[model]
    h = x[:, None, :]                                   # (B, 1, T)

    def p(name):
        return torch.as_tensor(params[name], dtype=h.dtype, device=h.device)

    def layer(h, i):
        h = F.pad(h, _CREPE_PADS[i - 1])
        h = conv(h, p(f"conv{i}.weight"), p(f"conv{i}.bias"),
                 stride=_CREPE_STRIDES[i - 1], precision=precision)
        h = torch.relu(h)
        mean = p(f"conv{i}_BN.running_mean")[:, None]
        var = p(f"conv{i}_BN.running_var")[:, None]
        gamma = p(f"conv{i}_BN.weight")[:, None]
        beta = p(f"conv{i}_BN.bias")[:, None]
        h = (h - mean) * torch.rsqrt(var + _CREPE_BN_EPS) * gamma + beta
        return F.max_pool1d(h, 2, 2)

    for i in range(1, 5):
        h = layer(h, i)
    if embed:
        return h.reshape(h.shape[0], -1)
    for i in range(5, 7):
        h = layer(h, i)
    # (B, C, T) -> (B, T, C) -> flatten, as in torchcrepe
    h = h.transpose(1, 2).reshape(h.shape[0], cap["in_features"])
    with network_precision(precision):
        logits = h @ p("classifier.weight").T + p("classifier.bias")
    return torch.sigmoid(logits)


def viterbi_decode(probs: torch.Tensor, transition: torch.Tensor
                   ) -> torch.Tensor:
    """Max-product Viterbi over pitch bins.

    probs: (..., N, C) observation probabilities; transition: (C, C)
    row-normalized.  Returns the (..., N) int32 state path.  A loop over
    the frames of (..., C, C) max-plus steps, then a backtrace loop of
    gathers, all on probs' device (no host read).  Ties go to the first
    index, with the JAX package's order of operations
    (``carry[..., :, None] + logt``, then the max over axis -2)."""
    logp = torch.log(torch.clamp(probs, min=1e-20))
    logt = torch.log(torch.clamp(transition, min=1e-20)).to(probs.dtype)
    obs = logp.movedim(-2, 0)                              # (N, ..., C)
    carry = obs[0]
    args = []
    for obs_t in obs[1:]:
        # one reduction gives the max and its first index
        best, arg = torch.max(carry[..., :, None] + logt, dim=-2)
        args.append(arg)
        carry = best + obs_t
    state = torch.argmax(carry, dim=-1)                    # (...,)
    path = [state]
    for arg in reversed(args):
        state = torch.gather(arg, -1, state[..., None])[..., 0]
        path.append(state)
    return torch.stack(path[::-1], dim=-1).to(torch.int32)


def crepe_transition() -> np.ndarray:
    """torchcrepe's triangular pitch-transition matrix (decode.py)."""
    xx, yy = np.meshgrid(np.arange(CREPE_PITCH_BINS),
                         np.arange(CREPE_PITCH_BINS))
    t = np.maximum(12 - np.abs(xx - yy), 0).astype(np.float64)
    return t / t.sum(axis=1, keepdims=True)


def weighted_cents(probs: torch.Tensor, bins: torch.Tensor, cents_fn,
                   window: int = 4) -> torch.Tensor:
    """Local weighted average of cents around the decoded bin (the
    torchcrepe 'weighted argmax' refinement)."""
    C = probs.shape[-1]
    offs = torch.arange(-window, window + 1, device=probs.device)
    idx = torch.clamp(bins[..., None].long() + offs, 0, C - 1)
    w = torch.gather(probs, -1, idx)
    cents = cents_fn(idx.to(probs.dtype))
    return torch.sum(w * cents, dim=-1) / torch.clamp(
        torch.sum(w, dim=-1), min=1e-12)


def a_weighting_db(frequencies: np.ndarray) -> np.ndarray:
    """IEC 61672 A-weighting in dB (as librosa.A_weighting)."""
    f2 = np.asarray(frequencies, np.float64) ** 2
    const = np.array([12194.217, 20.598997, 107.65265, 737.86223]) ** 2
    num = const[0] * f2**2
    den = ((f2 + const[0]) * (f2 + const[1])
           * np.sqrt((f2 + const[2]) * (f2 + const[3])))
    with np.errstate(divide="ignore"):
        return 2.0 + 20.0 * np.log10(np.maximum(num / np.maximum(den, 1e-300),
                                                1e-300))


def _edge_windows(x: torch.Tensor, width: int) -> torch.Tensor:
    shape = x.shape
    xp = F.pad(x.reshape(-1, 1, shape[-1]),
               (width // 2, width - 1 - width // 2), mode="replicate")
    return xp.reshape(shape[:-1] + (xp.shape[-1],)).unfold(-1, width, 1)


def median_filter(x: torch.Tensor, width: int) -> torch.Tensor:
    """Running median over ``width`` edge-padded samples; for an even
    width the mean of the two middle values (as ``jnp.median``, where
    ``torch.median`` would return the lower one)."""
    v = torch.sort(_edge_windows(x, width), dim=-1).values
    lo, hi = v[..., (width - 1) // 2], v[..., width // 2]
    return lo if width % 2 else 0.5 * (lo + hi)


def mean_filter(x: torch.Tensor, width: int) -> torch.Tensor:
    return torch.mean(_edge_windows(x, width), dim=-1)


class PitchExtractionByCREPE(nn.Module):
    """CREPE pitch extraction."""

    PRECISION = "full"           # the network's precision on the card

    def __init__(self, frame_period: int, sample_rate: int, *,
                 f_min: float | None = None, f_max: float | None = None,
                 voicing_threshold: float = 1e-2,
                 silence_threshold: float = -60.0, filter_length: int = 3,
                 model: str = "full", weights=None, dtype=None,
                 device=None) -> None:
        super().__init__()
        if model not in _CREPE_CAPACITY:
            raise ValueError("model must be 'tiny' or 'full'.")
        self.model = model
        self.f_min = 50.0 if f_min is None else f_min
        self.f_max = CREPE_MAX_FMAX if f_max is None else f_max
        if not 0 <= self.f_min < self.f_max <= sample_rate / 2:
            raise ValueError("Invalid f_min and f_max.")
        self.voicing_threshold = voicing_threshold
        self.silence_threshold = silence_threshold
        self.filter_length = filter_length

        self.hop = frame_period * CREPE_SAMPLE_RATE // sample_rate
        self.stft = child(ShortTimeFourierTransform,
                          frame_length=CREPE_WINDOW_SIZE,
                          frame_period=self.hop,
                          fft_length=CREPE_WINDOW_SIZE, norm="none",
                          window="hanning", out_format="db")
        self.resample = Resampler(sample_rate, CREPE_SAMPLE_RATE,
                                  device="cpu", dtype=torch.float64)

        params = load_params(weights, lambda: init_crepe_params(model),
                             expect=crepe_shapes(model),
                             bundled=BUNDLED_WEIGHTS.get(f"crepe-{model}"))
        self._weight_names = attach_weights(
            self, {k: params[k] for k in crepe_shapes(model)})
        self.register_buffer("transition",
                             torch.as_tensor(crepe_transition()))
        freqs = np.arange(CREPE_WINDOW_SIZE // 2 + 1) \
            * (CREPE_SAMPLE_RATE / CREPE_WINDOW_SIZE)
        self.register_buffer("perceptual_weights", torch.as_tensor(
            a_weighting_db(freqs) - LOUDNESS_REF_DB))
        # restrict decodable bins to [f_min, f_max]
        cents = crepe_bins_to_cents(np.arange(CREPE_PITCH_BINS))
        freq = crepe_cents_to_frequency(cents)
        self.register_buffer("bin_mask", torch.as_tensor(
            ((freq >= self.f_min) & (freq <= self.f_max)).astype(
                np.float64)))
        place(self, device, dtype)

    @property
    def params(self) -> dict:
        return gather_weights(self, self._weight_names)

    def frames(self, x: torch.Tensor) -> torch.Tensor:
        """The network's input: (..., N, 1024) float32 frames of ``x``
        resampled to 16 kHz, each zero-mean and of unit deviation."""
        x = self.resample(x)
        if x.shape[-1] < CREPE_WINDOW_SIZE // 2:
            raise ValueError(
                f"Input length must be greater than "
                f"{CREPE_WINDOW_SIZE // 2} at {CREPE_SAMPLE_RATE} Hz.")
        frames = hop_frames(x, CREPE_WINDOW_SIZE, self.hop, zmean=True)
        frames = frames / torch.clamp(
            torch.std(frames, dim=-1, keepdim=True, correction=0), min=1e-10)
        return frames.float()

    def _probs(self, x: torch.Tensor, embed: bool = False) -> torch.Tensor:
        frames = self.frames(x)
        # Network inference runs float32; results are cast back.
        params = self.params
        y = run_network(
            lambda f: crepe_forward(params, f, self.model, embed=embed,
                                    precision=self.PRECISION),
            frames.reshape(-1, CREPE_WINDOW_SIZE))
        return y.reshape(*frames.shape[:-1], -1).to(x.dtype)

    def calc_prob(self, x: torch.Tensor) -> torch.Tensor:
        return self._probs(x, embed=False)

    def calc_embed(self, x: torch.Tensor) -> torch.Tensor:
        return self._probs(x, embed=True)

    def calc_pitch(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.calc_prob(x), x)

    def decode(self, probs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Network probabilities (..., N, 360) and the waveform -> f0:
        Viterbi path, weighted cents, filters and the loudness mask."""
        probs = probs * self.bin_mask.to(x.dtype)
        bins = viterbi_decode(probs, self.transition)
        cents = weighted_cents(probs, bins, crepe_bins_to_cents)
        pitch = crepe_cents_to_frequency(cents)
        periodicity = torch.gather(probs, -1, bins[..., None].long())[..., 0]
        periodicity = median_filter(periodicity, self.filter_length)
        pitch = mean_filter(pitch, self.filter_length)

        # loudness frames follow the same hop convention as the net
        # frames (torchcrepe pads both identically), so no trim occurs
        loud_frames = hop_frames(x, CREPE_WINDOW_SIZE, self.hop)
        loudness = (self.stft.spec(self.stft.window(loud_frames))
                    + self.perceptual_weights.to(x.dtype))
        loudness = torch.clamp(loudness, min=LOUDNESS_MIN_DB).mean(-1)
        n = min(pitch.shape[-1], loudness.shape[-1])
        mask = ((periodicity[..., :n] < self.voicing_threshold)
                | (loudness[..., :n] < self.silence_threshold))
        return torch.where(mask, torch.full_like(pitch[..., :n],
                                                 UNVOICED_SYMBOL),
                           pitch[..., :n])


# ------------------------------------------------------------------ FCNF0
PENN_SAMPLE_RATE = 8000
PENN_WINDOW_SIZE = 1024
PENN_PITCH_BINS = 1440
PENN_CENTS_PER_BIN = 5.0
PENN_FMIN = 31.0
PENN_FMAX = 1984.0

# (in_ch, out_ch, post-conv length, maxpool (kernel, stride) or None)
_FCNF0_BLOCKS = [
    (1, 256, 481, (2, 2)),
    (256, 32, 225, (2, 2)),
    (32, 32, 97, (2, 2)),
    (32, 128, 66, None),
    (128, 256, 35, None),
    (256, 512, 4, None),
]
_FCNF0_KERNEL = 32


def penn_bins_to_frequency(bins):
    return PENN_FMIN * 2.0 ** (PENN_CENTS_PER_BIN * bins / 1200.0)


def init_fcnf0_params(seed: int = 0) -> dict:
    """Deterministic random init: the JAX package's draws, in the same
    order."""
    rng = np.random.RandomState(seed)
    params = {}
    for name, shape in fcnf0_shapes().items():
        if name == "head.weight":
            params[name] = rng.randn(*shape).astype(np.float32) / math.sqrt(
                shape[1] * shape[2])
        elif name.endswith("conv.weight"):
            params[name] = rng.randn(*shape).astype(np.float32) * (
                1.0 / math.sqrt(shape[1] * shape[2]))
        elif name.endswith("norm.weight"):
            params[name] = np.ones(shape, np.float32)
        else:
            params[name] = np.zeros(shape, np.float32)
    return params


def fcnf0_shapes() -> dict:
    """The shape of every parameter of the FCNF0++ network."""
    shapes = {}
    for i, (ci, co, ln, _pool) in enumerate(_FCNF0_BLOCKS):
        shapes[f"block{i}.conv.weight"] = (co, ci, _FCNF0_KERNEL)
        shapes[f"block{i}.conv.bias"] = (co,)
        shapes[f"block{i}.norm.weight"] = (co, ln)
        shapes[f"block{i}.norm.bias"] = (co, ln)
    shapes["head.weight"] = (PENN_PITCH_BINS, 512, 4)
    shapes["head.bias"] = (PENN_PITCH_BINS,)
    return shapes


def fcnf0_forward(params: dict, x: torch.Tensor,
                  precision: str = "full") -> torch.Tensor:
    """FCNF0++ forward: (B, 1024) frames -> (B, 1440) logits.

    Valid (unpadded) conv1d stack with the penn layer plan: kernel 32
    throughout, max-pool 2 after the first three blocks, LayerNorm over
    (channels, length) per block, and a final 1x4 conv head; the input is
    cropped to 993 samples so the stack lands exactly on length 1.
    ``precision`` as for :func:`conv`."""
    h = x[:, None, 16:-15]                                  # (B, 1, 993)

    def p(name):
        return torch.as_tensor(params[name], dtype=h.dtype, device=h.device)

    for i, (_ci, _co, _ln, pool) in enumerate(_FCNF0_BLOCKS):
        h = conv(h, p(f"block{i}.conv.weight"), p(f"block{i}.conv.bias"),
                 precision=precision)
        if pool is not None:
            h = F.max_pool1d(h, pool[0], pool[1])
        h = torch.relu(h)
        # LayerNorm over (C, L) with elementwise affine
        h = F.layer_norm(h, h.shape[-2:], p(f"block{i}.norm.weight"),
                         p(f"block{i}.norm.bias"), eps=1e-5)
    logits = conv(h, p("head.weight"), p("head.bias"), precision=precision)
    return logits[..., 0]                                   # (B, 1440)


class PitchExtractionByFCNF0(nn.Module):
    """FCNF0++ pitch extraction."""

    PRECISION = "tf32"           # the network's precision on the card

    def __init__(self, frame_period: int, sample_rate: int, *,
                 f_min: float | None = None, f_max: float | None = None,
                 voicing_threshold: float = 0.5, weights=None, dtype=None,
                 device=None) -> None:
        super().__init__()
        self.f_min = PENN_FMIN if f_min is None else f_min
        self.f_max = PENN_FMAX if f_max is None else f_max
        if not 0 <= self.f_min < self.f_max <= sample_rate / 2:
            raise ValueError("Invalid f_min and f_max.")
        self.voicing_threshold = voicing_threshold

        self.hop = frame_period * PENN_SAMPLE_RATE // sample_rate
        self.resample = Resampler(sample_rate, PENN_SAMPLE_RATE,
                                  device="cpu", dtype=torch.float64)
        params = load_params(weights, init_fcnf0_params,
                             expect=fcnf0_shapes(),
                             bundled=BUNDLED_WEIGHTS["fcnf0"])
        self._weight_names = attach_weights(
            self, {k: params[k] for k in fcnf0_shapes()})
        cents = PENN_CENTS_PER_BIN * np.arange(PENN_PITCH_BINS)
        freq = PENN_FMIN * 2.0 ** (cents / 1200.0)
        self.register_buffer("bin_mask", torch.as_tensor(
            np.where((freq >= self.f_min) & (freq <= self.f_max), 0.0,
                     -np.inf)))
        place(self, device, dtype)

    @property
    def params(self) -> dict:
        return gather_weights(self, self._weight_names)

    def frames(self, x: torch.Tensor) -> torch.Tensor:
        """The network's input: (..., N, 1024) float32 frames of ``x``
        resampled to 8 kHz."""
        x = self.resample(x)
        if x.shape[-1] <= PENN_WINDOW_SIZE // 2:
            raise ValueError(
                f"Input length must be greater than "
                f"{PENN_WINDOW_SIZE // 2} at {PENN_SAMPLE_RATE} Hz.")
        return hop_frames(x, PENN_WINDOW_SIZE, self.hop,
                          mode="reflect").float()

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        frames = self.frames(x)
        # float32 inference; results are cast back
        params = self.params
        logits = run_network(
            lambda f: fcnf0_forward(params, f, precision=self.PRECISION),
            frames.reshape(-1, PENN_WINDOW_SIZE))
        return logits.reshape(*frames.shape[:-1], PENN_PITCH_BINS).to(
            x.dtype)

    def calc_prob(self, x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(self._logits(x), dim=-1)

    def calc_embed(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(
            "FCNF0 does not expose embeddings (matching the reference).")

    def calc_pitch(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self._logits(x))

    def decode(self, logits: torch.Tensor) -> torch.Tensor:
        """Network logits (..., N, 1440) -> f0: argmax, local expected
        value and the entropy voicing decision."""
        logits = logits + self.bin_mask.to(logits.dtype)
        probs = torch.softmax(logits, dim=-1)
        bins = torch.argmax(probs, dim=-1)
        # local expected value decoding over +-19 bins (penn default)
        cents = weighted_cents(
            probs, bins, lambda b: PENN_CENTS_PER_BIN * b, window=19)
        pitch = PENN_FMIN * 2.0 ** (cents / 1200.0)
        # periodicity = normalized inverse entropy (penn 'entropy' method)
        ent = -torch.sum(probs * torch.log(torch.clamp(probs, min=1e-20)),
                         dim=-1)
        periodicity = 1.0 - ent / math.log(PENN_PITCH_BINS)
        return torch.where(periodicity >= self.voicing_threshold, pitch,
                           torch.full_like(pitch, UNVOICED_SYMBOL))
