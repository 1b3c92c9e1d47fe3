"""Auditory frequency scales (host-side, numpy float64; counterpart of
``diffsptk_tpu/utils/scales.py``).

The filterbank family designs on one of these scales; conversions run at
design time only, so they stay in numpy.
"""

from __future__ import annotations

import numpy as np

_SCALES = ("htk", "mel", "oshaughnessy", "inverted-mel", "chakroborty",
           "bark", "traunmuller", "linear")


def hz_to_auditory(f, scale: str):
    f = np.asarray(f, dtype=np.float64)
    if scale == "htk":
        return 1127.0 * np.log1p(f / 700.0)
    if scale in ("oshaughnessy", "mel"):
        return 2595.0 * np.log10(1.0 + f / 700.0)
    if scale in ("chakroborty", "inverted-mel"):
        return 2195.286 - 2595.0 * np.log10(1.0 + (4031.25 - f) / 700.0)
    if scale in ("traunmuller", "bark"):
        return (26.81 * f) / (1960.0 + f) - 0.53
    if scale == "linear":
        return f
    raise ValueError(f"scale {scale} is not supported.")


def auditory_to_hz(z, scale: str):
    z = np.asarray(z, dtype=np.float64)
    if scale == "htk":
        return 700.0 * np.expm1(z / 1127.0)
    if scale in ("oshaughnessy", "mel"):
        return 700.0 * (np.power(10.0, z / 2595.0) - 1.0)
    if scale in ("chakroborty", "inverted-mel"):
        return 4031.25 - 700.0 * (np.power(10.0, (2195.286 - z) / 2595.0)
                                  - 1.0)
    if scale in ("traunmuller", "bark"):
        return 1960.0 * (z + 0.53) / (26.28 - z)
    if scale == "linear":
        return z
    raise ValueError(f"scale {scale} is not supported.")
