#!/usr/bin/env python3
"""Round-trip SNR of the 48 kHz mel-cepstral vocoder against Taylor order.

    python3 tools/torch_mlsa_convergence.py

Runs ``MelCepstralVocoder(frame_length=1200, frame_period=240,
fft_length=2048, cep_order=24, alpha=0.55)`` (48 kHz, 5 ms frames) in
float64 on the CPU over row 0 of chip_smoke.py's synthetic speech at
48 kHz (57,600 samples), with the Taylor order of the IMLSA / MLSA
cascades at 20 (the model's default), 25 and 30, and prints the SNR of
the analysis-synthesis round trip.  An accuracy reading, no timing; runs
on the CPU only.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    import torch

    import diffsptk_tpu_torch as pt
    from chip_smoke import synth_speech

    x = torch.as_tensor(synth_speech(1, 57600, sr=48000),
                        dtype=torch.float64)
    for order in (20, 25, 30):
        voc = pt.MelCepstralVocoder(frame_length=1200, frame_period=240,
                                    fft_length=2048, cep_order=24,
                                    alpha=0.55, taylor_order=order,
                                    device="cpu", dtype=torch.float64)
        y = voc.analysis_synthesis(x)
        snr = float(10 * torch.log10((x ** 2).sum() / ((y - x) ** 2).sum()))
        print(f"[convergence] 48 kHz, alpha 0.55, Taylor order {order}: "
              f"round-trip SNR {snr:.2f} dB (float64, CPU, row 0)",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
