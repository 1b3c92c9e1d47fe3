"""Plain reference of mel-cepstral analysis and MLSA re-synthesis.

It imports nothing of the program.  Each piece is a frozen copy of the
plain formulation in ``diffsptk_tpu_torch`` at commit 2f79b3d, written
out without the program's kernels, plans or caches; the source of each
is named above it.  Every number it uses is worked out here again from
the configuration and the input waveform.

* the STFT: centred frames, a power-normalised Blackman window, a real
  FFT, the power spectrum with a relative floor;
* mel-cepstral analysis: the seed cepstrum and ``n_iter`` Newton steps,
  each solving the Toeplitz-plus-Hankel system of every frame with
  ``torch.linalg.solve``;
* the MLSA filter: the mel-cepstrum warped to a plain cepstrum of order
  ``cep_order_mlsa`` by the all-pass recurrence, and a Taylor series of
  ``taylor_order`` stages of the time-varying FIR, each stage the direct
  sum over taps with coefficients blended linearly between frames,
  times the frame gain; the inverse filter is the same filter on -mc.

``arith`` (``harness/compare.py``) sets the precision: float64 for the
reference, float32 with TF32 products for its control.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

ROW_BYTES = 2 << 30
"""Bytes of one block of rows' FIR contexts; the cascade runs the rows in
blocks so that it fits beside the inputs."""


# diffsptk_tpu_torch/ops/window.py:design_window, "blackman", symmetric,
# norm "power"
def blackman(length: int) -> np.ndarray:
    n = np.arange(length)
    size = max(length - 1, 1)
    w = (0.42 - 0.5 * np.cos(2 * np.pi * n / size)
         + 0.08 * np.cos(4 * np.pi * n / size))
    return w / np.sqrt(np.sum(w * w))


# diffsptk_tpu_torch/ops/frame.py (center=True, mode "constant"),
# ops/window.py, ops/spec.py (eps=0, relative_floor=-80, out_format
# "power")
def power_spectrum(x: torch.Tensor, frame_length: int, frame_period: int,
                   fft_length: int, relative_floor_db: float = -80.0
                   ) -> torch.Tensor:
    L, P = frame_length, frame_period
    xp = F.pad(x, (L // 2, (L - 1) // 2))
    frames = xp.unfold(-1, L, P)
    w = torch.as_tensor(blackman(L), dtype=x.dtype, device=x.device)
    s = torch.fft.rfft(frames * w, n=fft_length).abs().square()
    floor = 10.0 ** (relative_floor_db / 10.0)
    return torch.maximum(s, s.amax(dim=-1, keepdim=True) * floor)


# diffsptk_tpu_torch/ops/freqt.py:design_freqt
def freqt_matrix(in_order: int, out_order: int, alpha: float) -> np.ndarray:
    """Warp matrix A (in_order+1, out_order+1): c_out = c_in @ A."""
    L1, L2 = in_order + 1, out_order + 1
    beta = 1.0 - alpha * alpha
    A = np.zeros((L2, L1))
    A[0, :] = alpha ** np.arange(L1)
    if L2 > 1 and L1 > 1:
        A[1, 1:] = A[0, :-1] * beta * np.arange(1, L1)
    for i in range(2, L2):
        for j in range(1, L1):
            A[i, j] = A[i - 1, j - 1] + alpha * (A[i, j - 1] - A[i - 1, j])
    return A.T


# diffsptk_tpu_torch/ops/mcep.py:design_coef_freqt
def coef_freqt_matrix(in_order: int, out_order: int,
                      alpha: float) -> np.ndarray:
    L1, L2 = in_order + 1, out_order + 1
    A = np.zeros((L2, L1))
    A[:, 0] = (-alpha) ** np.arange(L2)
    for i in range(1, L2):
        for j in range(1, L1):
            A[i, j] = A[i - 1, j - 1] + alpha * (A[i, j - 1] - A[i - 1, j])
    return A.T


# diffsptk_tpu_torch/ops/mcep.py:MelCepstralAnalysis._design
def mcep_matrices(fft_length: int, M: int, alpha: float):
    """P0 (seed: irfft of the log spectrum, warped), P1 (mc to the warped
    log spectrum's real part), P2 (the spectrum ratio to the warped
    correlation), and the alpha vector."""
    H = fft_length // 2
    t = np.arange(H + 1)
    ang = 2.0 * np.pi * np.outer(t, t) / fft_length
    C1 = np.cos(ang)
    w = np.full(H + 1, 2.0)
    w[0] = w[H] = 1.0
    Ci = (w[:, None] * np.cos(ang)) / fft_length
    P1 = freqt_matrix(M, H, -alpha) @ C1
    P2 = Ci @ coef_freqt_matrix(H, 2 * M, alpha)
    scale = np.ones(H + 1)
    scale[0] = scale[H] = 0.5
    P0 = (Ci * scale[None, :]) @ freqt_matrix(H, M, alpha)
    return P0, P1, P2, (-alpha) ** np.arange(M + 1)


# diffsptk_tpu_torch/ops/mcep.py:MelCepstralAnalysis._forward, the plain
# branch, with the solve by torch.linalg.solve
def mcep(s: torch.Tensor, fft_length: int, M: int, alpha: float,
         n_iter: int, arith) -> torch.Tensor:
    n = M + 1
    P0, P1, P2, av = (torch.as_tensor(a, dtype=s.dtype, device=s.device)
                      for a in mcep_matrices(fft_length, M, alpha))
    log_s = torch.log(s)
    mc = arith.mm(log_s, P0)
    i = torch.arange(n, device=s.device)
    toeplitz = (i[:, None] - i[None, :]).abs()
    hankel = i[:, None] + i[None, :]
    for _ in range(n_iter):
        D = arith.mm(mc, P1)
        d = torch.exp(log_s - D - D)
        rt = arith.mm(d, P2)
        r = rt[..., :n]
        A = r[..., toeplitz] + rt[..., hankel]
        mc = mc + torch.linalg.solve(A, (r - av).unsqueeze(-1)).squeeze(-1)
    return mc


# diffsptk_tpu_torch/ops/zerodf.py, the direct path: y[t] = sum_k
# btilde[t, k] x[t - k], btilde blending frames n and n+1 over frame n
# (the last frame replicated); minimum phase, so no advance.  Computed
# frame by frame as one product of the frame's (P, M+1) history with its
# two frames' taps.
def fir(x: torch.Tensor, c: torch.Tensor, P: int, arith) -> torch.Tensor:
    rows, N, K = c.shape
    M = K - 1
    hist = F.pad(x, (M, 0)).unfold(-1, K, 1).flip(-1)     # (rows, T, K)
    hist = hist.reshape(rows, N, P, K)
    taps = torch.stack((c, torch.cat((c[:, 1:], c[:, -1:]), dim=1)), -1)
    both = arith.mm(hist, taps)                           # (rows, N, P, 2)
    lam = torch.arange(P, dtype=x.dtype, device=x.device) / P
    y = both[..., 0] * (1 - lam) + both[..., 1] * lam
    return y.reshape(rows, N * P)


# diffsptk_tpu_torch/ops/linear_intpl.py:linear_interpolate on one value
# a frame
def frame_gain(c0: torch.Tensor, P: int) -> torch.Tensor:
    nxt = torch.cat((c0[:, 1:], c0[:, -1:]), dim=1)
    lam = torch.arange(P, dtype=c0.dtype, device=c0.device) / P
    g = c0[..., None] * (1 - lam) + nxt[..., None] * lam
    return torch.exp(g.reshape(c0.shape[0], -1))


# diffsptk_tpu_torch/ops/mglsadf.py:MultiStageFIRFilter.forward (phase
# "minimum", a = 1, weights 1/i) with ops/mgc2mgc.py's warp to alpha 0
# (gamma 0: one freqt) and utils/linalg.py:remove_gain
def mlsa(x: torch.Tensor, mc: torch.Tensor, P: int, alpha: float,
         cep_order_mlsa: int, taylor_order: int, arith) -> torch.Tensor:
    M = mc.shape[-1] - 1
    A = torch.as_tensor(freqt_matrix(M, cep_order_mlsa, -alpha),
                        dtype=x.dtype, device=x.device)
    c = arith.mm(mc, A)
    c0 = c[..., 0]
    c = torch.cat((torch.zeros_like(c[..., :1]), c[..., 1:]), dim=-1)
    N = c.shape[-2]
    per_row = N * P * (cep_order_mlsa + 1) * x.element_size()
    block = max(1, ROW_BYTES // per_row)
    out = []
    for r in range(0, x.shape[0], block):
        xs, cs = x[r:r + block], c[r:r + block]
        y = xs
        stage = xs
        for i in range(1, taylor_order + 1):
            stage = fir(stage, cs, P, arith) / i
            y = y + stage
        out.append(y * frame_gain(c0[r:r + block], P))
    return torch.cat(out)


def analyze(config: dict, x: torch.Tensor, arith) -> torch.Tensor:
    """Waveform (rows, T) -> mel-cepstrum (rows, frames, M+1)."""
    p = config["program"]
    x = x.to(arith.dtype)
    s = power_spectrum(x, p["frame_length"], p["frame_period"],
                       p["fft_length"])
    return mcep(s, p["fft_length"], p["cep_order"], p["alpha"],
                p["n_iter"], arith)


def analysis_synthesis(config: dict, x: torch.Tensor, arith) -> dict:
    """mc, then IMLSA on -mc and MLSA on mc: {"mc": ..., "y": ...}."""
    p = config["program"]
    P = p["frame_period"]
    x = x.to(arith.dtype)
    mc = analyze(config, x, arith)
    T = mc.shape[-2] * P
    args = (P, p["alpha"], p["cep_order_mlsa"], p["taylor_order"], arith)
    e = mlsa(x[..., :T], -mc, *args)
    return {"mc": mc, "y": mlsa(e, mc, *args)}


def sizes(config: dict, samples: int) -> tuple[int, int]:
    """(frames, output samples) of a row of ``samples``."""
    P = config["program"]["frame_period"]
    frames = (samples - 1) // P + 1
    return frames, frames * P

