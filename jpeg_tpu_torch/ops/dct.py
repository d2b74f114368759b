"""The 8x8 DCT-II basis and the DCT as products against it: the separable
block and image-layout forms, the (64, 64) zig-zag matrix that folds the
2-D transform and the zig-zag order into one matmul, and the reduced bases
of the scaled decode.

The products are plain full-f32 torch matmuls, as jpeg_tpu computes them
outside any Pallas kernel. The (64, 64) form is decode(use_pallas=False)'s
IDCT on a card; the full-size default decode runs kernel B2 (ops/fused)."""

from __future__ import annotations

import functools

import numpy as np
import torch

from jpeg_tpu_torch import tables
from jpeg_tpu_torch.ops import _cuda


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


@functools.cache
def zigzag_dct_matrix() -> np.ndarray:
    """(64, 64) matrix M with zz_coeffs = M @ block_flat: the full 2-D DCT
    (kron(D, D) over a row-major flattened 8x8 block) with the zig-zag
    permutation folded into the row order, built in float64 and rounded to
    f32 once. M is orthogonal (a permutation of an orthogonal kron), so the
    inverse transform is M^T (idct_zigzag_blocks)."""
    d = dct_basis().astype(np.float64)
    return np.kron(d, d)[np.asarray(tables.ZIGZAG_ORDER)].astype(np.float32)


@functools.cache
def _on_device(which: str, device: torch.device) -> torch.Tensor:
    """dct_basis() ("basis") or zigzag_dct_matrix() ("zigzag") as an f32
    tensor on `device`, uploaded once."""
    m = dct_basis() if which == "basis" else zigzag_dct_matrix()
    return _cuda.settled(torch.as_tensor(m, device=device))


def _f32(x: torch.Tensor, which: str):
    """(x as f32, the matrix on x's device). The products below are plain
    f32 matmuls, as jpeg_tpu runs them at HIGHEST precision: on a card they
    must not run in TF32 (mcu_conv._require_full_f32 raises if PyTorch
    allows it)."""
    if x.device.type == "cuda":
        from jpeg_tpu_torch.ops import mcu_conv

        mcu_conv._require_full_f32()
    return x.to(torch.float32), _on_device(which, x.device)


def fdct_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """(..., 8, 8) spatial blocks -> (..., 8, 8) DCT coefficients:
    D @ X @ D^T, the left product first."""
    x, d = _f32(blocks, "basis")
    return torch.matmul(torch.matmul(d, x), d.T)


def idct_blocks(coeffs: torch.Tensor) -> torch.Tensor:
    """(..., 8, 8) DCT coefficients -> (..., 8, 8) spatial blocks:
    D^T @ C @ D, the left product first."""
    c, d = _f32(coeffs, "basis")
    return torch.matmul(torch.matmul(d.T, c), d)


def fdct_zigzag_blocks(flat_blocks: torch.Tensor) -> torch.Tensor:
    """(B, 64) row-major flattened spatial blocks -> (B, 64) zig-zag-ordered
    DCT coefficients, one matmul with zigzag_dct_matrix()^T."""
    x, m = _f32(flat_blocks, "zigzag")
    return torch.matmul(x, m.T)


def idct_zigzag_blocks(zz: torch.Tensor) -> torch.Tensor:
    """(B, 64) zig-zag-ordered (dequantized) coefficients -> (B, 64)
    row-major flattened spatial blocks (the transpose pair of
    fdct_zigzag_blocks), one matmul with zigzag_dct_matrix()."""
    z, m = _f32(zz, "zigzag")
    return torch.matmul(z, m)


def fdct_plane(plane: torch.Tensor) -> torch.Tensor:
    """Separable DCT over an (H, W) plane kept in image layout: coefficient
    (u, v) of block (a, b) lands at pixel (8a+u, 8b+v). H and W must be
    multiples of 8. The vertical pass, then the horizontal one."""
    h, w = plane.shape
    if h % 8 or w % 8:
        raise ValueError(f"plane {(h, w)} is not a multiple of 8")
    x, d = _f32(plane, "basis")
    v = torch.matmul(d, x.reshape(h // 8, 8, w)).reshape(h, w)
    return torch.matmul(v.reshape(h, w // 8, 8), d.T).reshape(h, w)


def idct_plane(coeffs: torch.Tensor) -> torch.Tensor:
    """Inverse of fdct_plane (image-layout separable IDCT)."""
    h, w = coeffs.shape
    if h % 8 or w % 8:
        raise ValueError(f"plane {(h, w)} is not a multiple of 8")
    c, d = _f32(coeffs, "basis")
    v = torch.matmul(d.T, c.reshape(h // 8, 8, w)).reshape(h, w)
    return torch.matmul(v.reshape(h, w // 8, 8), d).reshape(h, w)
