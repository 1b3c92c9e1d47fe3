"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates at the 700 W limit) and the least time of a piece of work."""

F32_PEAK = 67e12      # float32 outside the tensor cores, flop/s
HBM_RATE = 3.35e12    # device memory, bytes/s


def least_seconds(flops: float, nbytes: float) -> tuple[float, str]:
    """The larger of bytes over the memory rate and operations over the
    float32 peak, and which of the two it is."""
    t_bytes = nbytes / HBM_RATE
    t_ops = flops / F32_PEAK
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
