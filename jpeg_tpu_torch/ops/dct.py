"""The 8x8 DCT-II basis shared by the transform matrices and the IDCT, and
the reduced bases of the scaled decode."""

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


@functools.cache
def idct_scaled_basis(k: int) -> np.ndarray:
    """(k, 8) basis B for DCT-domain 8->k downscaling: a k x k spatial block
    from the top-left k x k of an 8-point coefficient block via
    out = B @ C @ B^T (libjpeg jidctred semantics, exact float form).

    B[y, u] = sqrt(k/8) * Tk[u, y] for u < k (Tk = orthonormal k-point DCT),
    zero otherwise; the sqrt(k/8) rescale makes a constant block decode to its
    own value (spectral truncation preserves the mean). k = 8 reduces to the
    full IDCT transpose."""
    if k not in (1, 2, 4, 8):
        raise ValueError(f"scaled IDCT supports k in 1/2/4/8, got {k}")
    u = np.arange(k)[:, None].astype(np.float64)
    y = np.arange(k)[None, :].astype(np.float64)
    t = np.sqrt(2.0 / k) * np.cos((2.0 * y + 1.0) * u * np.pi / (2.0 * k))
    t[0, :] *= 1.0 / np.sqrt(2.0)
    b = np.zeros((k, 8), dtype=np.float64)
    b[:, :k] = np.sqrt(k / 8.0) * t.T
    return b.astype(np.float32)
