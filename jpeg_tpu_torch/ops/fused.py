"""Fused 8x8 transforms over image-layout planes: level shift + DCT +
quantize (encode) and dequantize + IDCT + level unshift (decode).

Counterparts of jpeg_tpu/ops/fused.py fused_dct_quantize and
fused_dequant_idct. On a CUDA tensor each launches a hand-written kernel
that does the whole 2-D transform in one pass:
  - kernel C, csrc/dct8.cu, replaces the Pallas kernel fused._dct8_kernel
    (pallas_call at fused.py:101);
  - kernel B, csrc/idct8.cu, replaces fused._idct8_kernel (pallas_call at
    fused.py:121).
On a CPU tensor each runs its plain twin (fused_dct_quantize_reference,
fused_dequant_idct_reference). The kernels' source notes say what bounds
them on the card. A kernel and its twin sum in f32 and are held to the bounds
of tests/test_fused.py: quantized coefficients within 1 in at most
max(8, 5e-4 n) places; IDCT samples to |diff| <= 1e-2. Kernel C's FMA chains
follow the order the twin's contractions take on the CPU and, at the 4K
plane shapes, on the card, where the two come out equal in every
coefficient; at small shapes cuBLAS sums the twin in another order and a few
.5 boundaries flip.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from jpeg_tpu_torch.ops import _cuda, dct, mcu_conv, quant

# Kernel B launches since the last reset (plus one per launch, nowhere else).
LAUNCHES = 0
# Kernel C launches since the last reset (plus one per launch, nowhere else).
DCT_LAUNCHES = 0
# Worker threads launch too (parallel/pipeline), so the increments hold a lock.
_COUNT_LOCK = threading.Lock()


def _check_plane(plane: torch.Tensor) -> None:
    if plane.ndim != 2 or plane.shape[0] % 8 or plane.shape[1] % 8:
        raise ValueError(
            f"plane must be (H, W) with H, W multiples of 8, got "
            f"{tuple(plane.shape)}")


def _require_aligned(fn: str, **tensors) -> None:
    """Kernels B and C move 16 bytes per load and store. W % 8 == 0 keeps
    every row aligned once the base is."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} is not 16-byte aligned")


def fused_dct_quantize_reference(plane: torch.Tensor, qtable) -> torch.Tensor:
    """Plain twin (any device): -128, D x D^T per block (vertical then
    horizontal contraction), true division by the (8, 8) table (row =
    vertical frequency), round half away from zero -> (H, W) int32."""
    _check_plane(plane)
    if plane.device.type == "cuda":
        mcu_conv._require_full_f32()  # the einsums below must not run in TF32
    h, w = plane.shape
    d = dct._on_device("basis", plane.device)
    x = (plane.to(torch.float32) - 128.0).reshape(h // 8, 8, w // 8, 8)
    t = torch.einsum("uy,aybx->aubx", d, x)
    coef = torch.einsum("aubx,vx->aubv", t, d).reshape(h, w)
    return quant.quantize_plane(coef, qtable)


def _launch_dct(plane, q, out) -> None:
    """Enqueue kernel C on PyTorch's current stream: prepared contiguous
    CUDA tensors ((H, W) f32 plane and (H, W) int32 out, both 16-byte
    aligned, (64,) f32 raster table), no checks and no allocation. Counts
    the launch."""
    global DCT_LAUNCHES
    dev = plane.device
    h, w = plane.shape
    lib = _cuda.load("dct8")
    with torch.cuda.device(dev):
        err = lib.jt_dct8(
            ctypes.c_void_p(plane.data_ptr()), ctypes.c_void_p(q.data_ptr()),
            ctypes.c_void_p(out.data_ptr()),
            ctypes.c_int(h), ctypes.c_int(w), _cuda.stream_handle(dev))
    _cuda.check("dct8", err)
    with _COUNT_LOCK:
        DCT_LAUNCHES += 1


def _fused_dct_quantize_cuda(plane: torch.Tensor, qtable) -> torch.Tensor:
    _check_plane(plane)
    dev = plane.device
    h, w = plane.shape
    x = plane.to(torch.float32).contiguous()
    q = torch.as_tensor(qtable, dtype=torch.float32, device=dev).reshape(
        64).contiguous()
    out = torch.empty((h, w), dtype=torch.int32, device=dev)
    if h == 0 or w == 0:
        return out
    _require_aligned("fused_dct_quantize", plane=x, out=out)
    _launch_dct(x, q, out)
    return out


def fused_dct_quantize(plane: torch.Tensor, qtable) -> torch.Tensor:
    """(H, W) pixel plane (float, H and W multiples of 8) + (8, 8) quant
    table (array, or a tensor on the plane's device) -> (H, W) int32
    quantized coefficients in image layout: quantize_plane of the 8x8 DCT of
    plane - 128.

    CUDA tensors launch kernel C (csrc/dct8.cu); CPU tensors run the plain
    twin. Any other device raises."""
    kind = plane.device.type
    if kind == "cpu":
        return fused_dct_quantize_reference(plane, qtable)
    if kind == "cuda":
        return _fused_dct_quantize_cuda(plane, qtable)
    raise ValueError(f"fused_dct_quantize: unsupported device {plane.device}")


def fused_dequant_idct_reference(coeffs: torch.Tensor, qtable) -> torch.Tensor:
    """Plain twin (any device): dequantize by the (8, 8) table, then
    D^T C D per block (vertical then horizontal contraction), then +128."""
    _check_plane(coeffs)
    h, w = coeffs.shape
    dev = coeffs.device
    d = torch.as_tensor(dct.dct_basis(), device=dev)
    q = torch.as_tensor(qtable, dtype=torch.float32, device=dev).reshape(8, 8)
    c = coeffs.to(torch.float32).reshape(h // 8, 8, w // 8, 8) * q[None, :, None, :]
    t = torch.einsum("uy,aubv->aybv", d, c)
    out = torch.einsum("aybv,vx->aybx", t, d)
    return out.reshape(h, w) + 128.0


def _launch_idct(coeffs, q, out) -> None:
    """Enqueue kernel B on PyTorch's current stream: prepared contiguous
    CUDA tensors ((H, W) int32 coefficients and (H, W) f32 out, both 16-byte
    aligned, (64,) f32 raster table), no checks and no allocation. Counts
    the launch."""
    global LAUNCHES
    dev = coeffs.device
    h, w = coeffs.shape
    lib = _cuda.load("idct8")
    with torch.cuda.device(dev):
        err = lib.jt_idct8(
            ctypes.c_void_p(coeffs.data_ptr()), ctypes.c_void_p(q.data_ptr()),
            ctypes.c_void_p(out.data_ptr()),
            ctypes.c_int(h), ctypes.c_int(w), _cuda.stream_handle(dev))
    _cuda.check("idct8", err)
    with _COUNT_LOCK:
        LAUNCHES += 1


def _fused_dequant_idct_cuda(coeffs: torch.Tensor, qtable) -> torch.Tensor:
    _check_plane(coeffs)
    dev = coeffs.device
    h, w = coeffs.shape
    c = coeffs.to(torch.int32).contiguous()
    q = torch.as_tensor(qtable, dtype=torch.float32, device=dev).reshape(
        64).contiguous()
    out = torch.empty((h, w), dtype=torch.float32, device=dev)
    if h == 0 or w == 0:
        return out
    _require_aligned("fused_dequant_idct", coeffs=c, out=out)
    _launch_idct(c, q, out)
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
