"""Each work count against a hand count at one small shape."""

from harness.manifest import module


def test_newton_order_two_by_hand():
    # assemble A00, A10, A11: 3; column 0: rsqrt, A10 * inv, A11 - A10^2:
    # 4; column 1: rsqrt: 1; forward y0 = b0 d0, y1 = (b1 - A10 y0) d1: 4;
    # back the same: 4
    newton = module("work", "newton")
    assert newton.solve_flops(2) == 16
    # rt (3 values) and b (2) read, x (2) written, float32, 5 systems
    assert newton.work(2, systems=5, times=3) == (16 * 15, 7 * 4 * 15)


def test_newton_order_three_by_hand():
    # assemble 6; column 0: 1 + 2 + updates of columns 1 (2 x 2) and 2
    # (2 x 1) = 9; column 1: 1 + 1 + 2 = 4; column 2: 1; sweeps 2 x (1 +
    # 3 + 5) = 18
    assert module("work", "newton").solve_flops(3) == 6 + 9 + 4 + 1 + 18


def test_cascade_small_shape_by_hand():
    cascade = module("work", "mlsa_cascade")
    # B 1, N 2, P 4, M 3, S 2: directly 2 filters x 4 taps x 2 flops x 4
    # samples = 64 a frame and stage, under the FFT form's 3 x 2.5 x 7
    # log2 7 + 12 x 4 + 12; plus one transform of c a frame
    fft = 2.5 * 7 * 2.807354922057604
    flops, nbytes = cascade.work(B=1, N=2, P=4, M=3, S=2)
    assert abs(flops - 2 * (2 * 64 + fft)) < 1e-9
    assert nbytes == (2 * 8 + 2 * 4) * 4
    assert cascade.chunked(P=80, M=199) and not cascade.chunked(240, 199)


def test_cascade_takes_the_fft_count_at_the_flagship():
    cascade = module("work", "mlsa_cascade")
    flops, _ = cascade.work(B=1, N=1, P=80, M=199, S=1)
    L = 279
    fft = 2.5 * L * 8.124121311829478
    assert abs(flops - (3 * fft + 12 * 140 + 240 + fft)) < 1e-6
