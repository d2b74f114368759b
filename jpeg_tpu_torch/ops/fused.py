"""Fused dequantize + 8x8 IDCT + level unshift over an image-layout plane.

Counterpart of jpeg_tpu/ops/fused.py fused_dequant_idct. On a CUDA tensor it
launches the hand-written kernel csrc/idct8.cu (kernel B), which replaces the
Pallas kernel fused._idct8_kernel (pallas_call at fused.py:121) and does the
whole 2-D transform in one pass; on a CPU tensor it runs the plain twin
fused_dequant_idct_reference. The kernel's source note says what bounds it
on the card. The f32 summation order differs between the two, so they agree
to |diff| <= 1e-2 (the bound of tests/test_fused.py), not bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from jpeg_tpu_torch.ops import _cuda
from jpeg_tpu_torch.ops.dct import dct_basis

# Kernel launches since the last reset (plus one per launch, nowhere else).
LAUNCHES = 0


@functools.cache
def _basis(device: torch.device) -> torch.Tensor:
    """dct_basis() as a (64,) f32 tensor, uploaded once per device."""
    return torch.as_tensor(dct_basis(), device=device).reshape(64)


def _check_plane(coeffs: torch.Tensor) -> None:
    if coeffs.ndim != 2 or coeffs.shape[0] % 8 or coeffs.shape[1] % 8:
        raise ValueError(
            f"coefficient plane must be (H, W) with H, W multiples of 8, got "
            f"{tuple(coeffs.shape)}")


def fused_dequant_idct_reference(coeffs: torch.Tensor, qtable) -> torch.Tensor:
    """Plain twin (any device): dequantize by the (8, 8) table, then
    D^T C D per block (vertical then horizontal contraction), then +128."""
    _check_plane(coeffs)
    h, w = coeffs.shape
    dev = coeffs.device
    d = torch.as_tensor(dct_basis(), device=dev)
    q = torch.as_tensor(qtable, dtype=torch.float32, device=dev).reshape(8, 8)
    c = coeffs.to(torch.float32).reshape(h // 8, 8, w // 8, 8) * q[None, :, None, :]
    t = torch.einsum("uy,aubv->aybv", d, c)
    out = torch.einsum("aybv,vx->aybx", t, d)
    return out.reshape(h, w) + 128.0


def _fused_dequant_idct_cuda(coeffs: torch.Tensor, qtable) -> torch.Tensor:
    global LAUNCHES
    _check_plane(coeffs)
    dev = coeffs.device
    h, w = coeffs.shape
    c = coeffs.to(torch.int32).contiguous()
    q = torch.as_tensor(qtable, dtype=torch.float32, device=dev).reshape(
        64).contiguous()
    d = _basis(dev)
    out = torch.empty((h, w), dtype=torch.float32, device=dev)
    if h == 0 or w == 0:
        return out
    lib = _cuda.load("idct8")
    with torch.cuda.device(dev):
        err = lib.jt_idct8(
            ctypes.c_void_p(c.data_ptr()), ctypes.c_void_p(q.data_ptr()),
            ctypes.c_void_p(d.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            ctypes.c_int(h), ctypes.c_int(w), _cuda.stream_handle(dev))
    _cuda.check("idct8", err)
    LAUNCHES += 1
    return out


def fused_dequant_idct(coeffs: torch.Tensor, qtable) -> torch.Tensor:
    """(H, W) int32 quantized coefficient plane (image layout) + (8, 8)
    table (array, or a tensor on the plane's device to spare the upload) ->
    (H, W) float32 pixel plane (level-unshifted to [0, 255] range).

    CUDA tensors launch kernel B (csrc/idct8.cu); CPU tensors run the plain
    twin. Any other device raises."""
    kind = coeffs.device.type
    if kind == "cpu":
        return fused_dequant_idct_reference(coeffs, qtable)
    if kind == "cuda":
        return _fused_dequant_idct_cuda(coeffs, qtable)
    raise ValueError(f"fused_dequant_idct: unsupported device {coeffs.device}")
