"""The Taylor-series MLSA cascade: S stages, each a time-varying FIR of
M + 1 taps whose coefficients blend linearly between frames n and n + 1
over the P samples of frame n.

The least work is the lower of two ways to compute a stage, copied from
chip_smoke.py's ``cascade_bound`` (commit 2f79b3d): directly, 2 (M+1)
taps of 2 operations for each of the two filters a sample blends; or as
an FFT convolution, one real transform of the frame's L = P + M inputs
and two inverse ones at 2.5 L log2 L operations each, two complex
products of 6 operations a bin and the blend (3 a sample); plus one
transform of each frame's coefficients a call.  x and y (B N P values)
and c (B N (M+1)) are read or written once, float32.
"""

import math


def chunked(P: int, M: int) -> bool:
    """Whether a stage's M + 1 taps reach past one frame period: the
    tap-chunked geometry.  Otherwise the stage is unchunked."""
    return M + 1 > P


def work(B: int, N: int, P: int, M: int, S: int, times: int = 1,
         itemsize: int = 4) -> tuple[float, float]:
    """(operations, bytes) of ``times`` S-stage cascades over B rows of N
    frames."""
    L = P + M
    rfft = 2.5 * L * math.log2(L)
    per_frame = min(2 * (M + 1) * 2 * P,
                    3 * rfft + 2 * 6 * (L // 2 + 1) + 3 * P)
    flops = B * N * (S * per_frame + rfft) * times
    nbytes = (2 * B * N * P + B * N * (M + 1)) * itemsize * times
    return float(flops), float(nbytes)
