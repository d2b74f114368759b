"""The 8x8 DCT-II basis shared by the transform builders and the IDCT."""

from __future__ import annotations

import functools

import numpy as np


@functools.cache
def dct_basis() -> np.ndarray:
    """Orthonormal 8x8 DCT-II basis D: coeffs = D @ x for a length-8 signal.

    D[u, x] = c(u)/2 * cos((2x+1) u pi / 16), c(0) = 1/sqrt(2), else 1.
    Satisfies D @ D.T = I, so the inverse transform is D.T.
    """
    u = np.arange(8)[:, None].astype(np.float64)
    x = np.arange(8)[None, :].astype(np.float64)
    d = 0.5 * np.cos((2.0 * x + 1.0) * u * np.pi / 16.0)
    d[0, :] *= 1.0 / np.sqrt(2.0)
    return d.astype(np.float32)
