"""Quality/rate metrics (framework-free: jpeg_tpu/utils/metrics.py's
psnr and bits_per_pixel). Stage times come from the spans of utils/trace."""

from __future__ import annotations

import numpy as np


def psnr(a, b, peak: float = 255.0) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    mse = float(np.mean((a - b) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(peak * peak / mse)


def bits_per_pixel(jpeg_bytes: bytes, shape) -> float:
    return len(jpeg_bytes) * 8.0 / (shape[0] * shape[1])
