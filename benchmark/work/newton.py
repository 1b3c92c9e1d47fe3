"""One Newton step's linear solves of mel-cepstral analysis.

Each frame solves the SPD system (Toeplitz(r) + Hankel(rt)) dx = b of
order n by Cholesky: assembling the lower triangle, factoring it and
both triangular sweeps.  The system is read as its generator rt (2n - 1
values) and right-hand side b (n), and dx (n) is written, float32.
"""


def solve_flops(n: int) -> int:
    """Operations of one order-n solve, counted as the algorithm states
    them: n(n+1)/2 additions to assemble, n square roots, the column
    scalings and the rank-one updates, then two sweeps."""
    assemble = n * (n + 1) // 2
    factor = 0
    for j in range(n):
        factor += 1 + (n - j - 1)                       # rsqrt, scale
        for k in range(j + 1, n):
            factor += 2 * (n - k)                       # update column k
    sweeps = 2 * sum(2 * j + 1 for j in range(n))       # forward, back
    return assemble + factor + sweeps


def work(n: int, systems: int, times: int = 1,
         itemsize: int = 4) -> tuple[float, float]:
    """(operations, bytes) of ``times`` launches of ``systems`` solves."""
    flops = solve_flops(n) * systems * times
    nbytes = ((2 * n - 1) + n + n) * itemsize * systems * times
    return float(flops), float(nbytes)
