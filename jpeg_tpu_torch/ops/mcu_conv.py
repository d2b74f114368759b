"""The whole encoder transform as ONE integer-exact matmul (colour, and
the single-plane gray twin).

Color conversion, the -128 level shift, chroma box subsampling, the 2-D DCT
and the zig-zag permutation are all linear (or affine) maps from an MCU's
RGB pixels to its (hv + 2) x 64 zig-zag coefficients, so they compose into a
single (mcu_h * mcu_w * 3, (hv+2)*64) matrix applied to non-overlapping MCU
patches (im2col is one reshape + permute). The matrix is held in 2^15
fixed point, split into hi/lo halves whose entries and partial sums stay
below 2^24, so an f32 matmul of the integer-valued operands is exact in any
summation order; the integer combine and the quantizer's round half away
from zero are exact int32 arithmetic. The coefficients are therefore
bit-identical on every device and to the JAX package's _mcu_transform_int.

The one requirement: the f32 product must run in full f32. TF32 (10-bit
mantissa) would round the operands, so _mcu_transform_int refuses to run
when PyTorch is set to allow it.
"""

from __future__ import annotations

import collections
import functools
import threading

import numpy as np
import torch

from jpeg_tpu_torch import tables
from jpeg_tpu_torch.config import Subsampling
from jpeg_tpu_torch.ops import _cuda, color, dct, tile
from jpeg_tpu_torch.utils.trace import span


@functools.cache
def _mcu_kernel_f64(mode: Subsampling) -> tuple[np.ndarray, np.ndarray]:
    """Composed transform kernel in float64:
    (kernel (mcu_h, mcu_w, 3, (hv+2)*64), bias ((hv+2)*64,)).

    Output channel blk*64 + k is zig-zag DCT coefficient k of MCU block blk:
    blocks 0..hv-1 are luma in v-by-h raster order (spec A.2.3), then Cb, Cr.
    The bias folds the -128 level shift: it only touches DC rows (the other
    DCT rows sum to zero), and the chroma matrix rows' +128 storage offset
    cancels the shift exactly, leaving luma DC at -1024 and chroma DC at 0.
    """
    hf, vf = mode.h_factor, mode.v_factor
    hv = hf * vf
    mh, mw = mode.mcu_height, mode.mcu_width
    d8 = dct.dct_basis().astype(np.float64)
    zz = np.kron(d8, d8)[np.asarray(tables.ZIGZAG_ORDER)]  # (64, 64)
    w = zz.reshape(64, 8, 8)  # (k, u, v)
    cw = color.RGB_TO_YCBCR.astype(np.float64)

    kern = np.zeros((mh, mw, 3, (hv + 2) * 64), dtype=np.float64)
    for a in range(vf):
        for b in range(hf):
            blk = a * hf + b
            kern[8 * a:8 * a + 8, 8 * b:8 * b + 8, :, 64 * blk:64 * blk + 64] = (
                np.einsum("kuv,c->uvck", w, cw[0])
            )
    # Chroma: the box mean spreads each subsampled tap over its vf x hf
    # source pixels with weight 1/(vf*hf).
    inv = 1.0 / (vf * hf)
    for ci, row in ((hv, cw[1]), (hv + 1, cw[2])):
        full = np.einsum("kuv,c->uvck", w, row)  # on the subsampled grid
        up = np.repeat(np.repeat(full, vf, axis=0), hf, axis=1) * inv
        kern[:, :, :, 64 * ci:64 * ci + 64] = up

    bias = np.zeros((hv + 2) * 64, dtype=np.float64)
    for blk in range(hv):
        bias[64 * blk] = -1024.0  # luma DC level shift: -(128 * 64) / 8
    return kern, bias


@functools.cache
def mcu_kernel(mode: Subsampling) -> tuple[np.ndarray, np.ndarray]:
    """f32 rounding of _mcu_kernel_f64: (kernel (mcu_h, mcu_w, 3,
    (hv+2)*64), bias ((hv+2)*64,)), jpeg_tpu's float conv kernel. The
    port's transform runs the integer twin (mcu_kernel_int)."""
    kern, bias = _mcu_kernel_f64(mode)
    return kern.astype(np.float32), bias.astype(np.float32)


# Fixed-point scale of the integer transform kernel: at 2^15 the composed
# kernel's rounding perturbs a coefficient by well under 0.15 before
# quantization, and the result is exact integer arithmetic.
_INT_SCALE_BITS = 15
# Kernel split K_int = K_hi * 2^_HI_SHIFT + K_lo with |K_hi| <= 256,
# |K_lo| <= 2^(_HI_SHIFT-1): every product with a uint8 pixel and every
# partial sum stays below 2^24, so an f32 accumulator is exact.
_HI_SHIFT = 7


@functools.cache
def mcu_kernel_int(mode: Subsampling):
    """Integer fixed-point transform kernel:
    (k_hilo (mcu_h, mcu_w, 3, 2*(hv+2)*64) f32-storing-integers,
     bias_int ((hv+2)*64,) int32).

    k_hilo stacks the hi kernel then the lo kernel along output channels so
    ONE product gives both partial sums; the true coefficient is
    (acc_hi * 2^_HI_SHIFT + acc_lo + bias_int) / 2^_INT_SCALE_BITS.
    Exactness bounds are asserted here at build time, not assumed."""
    kern64, bias64 = _mcu_kernel_f64(mode)
    k_int = np.rint(kern64 * (1 << _INT_SCALE_BITS))
    k_hi = np.rint(k_int / (1 << _HI_SHIFT))
    k_lo = k_int - k_hi * (1 << _HI_SHIFT)
    assert np.abs(k_hi).max() <= 256 and np.abs(k_lo).max() <= 1 << (
        _HI_SHIFT - 1
    )
    # f32-accumulator exactness: every partial sum of |pixel * weight| must
    # stay below 2^24 per output channel.
    nco = kern64.shape[-1]
    for half in (k_hi, k_lo):
        worst = np.abs(half).reshape(-1, nco).sum(axis=0).max() * 255.0
        assert worst < 2 ** 24, worst
    bias_int = np.rint(bias64 * (1 << _INT_SCALE_BITS)).astype(np.int32)
    k_hilo = np.concatenate([k_hi, k_lo], axis=-1).astype(np.float32)
    return k_hilo, bias_int


def zigzag_qdiv(qy, qc, hv: int) -> np.ndarray:
    """((hv+2)*64,) f32 per-channel quantization divisors (zig-zag order,
    luma channels first) from the (8, 8) raster tables."""
    return zigzag_qdiv_int(qy, qc, hv).astype(np.float32)


def zigzag_qdiv_int(qy, qc, hv: int) -> np.ndarray:
    """((hv+2)*64,) int32 per-channel quantization divisors (zig-zag order,
    luma channels first) from the (8, 8) raster tables."""
    order = np.asarray(tables.ZIGZAG_ORDER)
    qzy = np.asarray(qy).reshape(64)[order].astype(np.int32)
    qzc = np.asarray(qc).reshape(64)[order].astype(np.int32)
    return np.concatenate([np.tile(qzy, hv), qzc, qzc])


def kernel_to_torch(k_hilo: np.ndarray, bias: np.ndarray, device):
    """The numpy (k_hilo, bias_int) pair of mcu_kernel_int -> the port's
    tensors: ((mcu_h*mcu_w*3, 2*nco) f32 matrix, (nco,) int32 bias)."""
    kern = torch.as_tensor(
        np.ascontiguousarray(k_hilo.reshape(-1, k_hilo.shape[-1])),
        dtype=torch.float32, device=device)
    return kern, torch.as_tensor(bias, dtype=torch.int32, device=device)


@functools.cache
def _device_kernel(mode: Subsampling, device: torch.device):
    """kernel_to_torch(*mcu_kernel_int(mode), device), uploaded once."""
    kern, bias = kernel_to_torch(*mcu_kernel_int(mode), device)
    return _cuda.settled(kern), _cuda.settled(bias)


# Small constants of the transform kept on their device once uploaded: the
# quantizer's divisors, already shifted by _INT_SCALE_BITS, per quant-table
# set and mode, and the encoder's table-id row per mode: uploaded per image,
# each would be a blocking copy that waits for the card's queue. A fill
# waits for its upload (_cuda.settled), since the next reader may be another
# thread on another stream; a hit records the reader's stream, since an entry
# may be evicted while that stream still reads it (least recently used goes
# first). CONSTANT_UPLOADS counts the fills, under the cache's lock.
CONSTANT_UPLOADS = 0
_CONSTANTS_SIZE = 32
_constants: collections.OrderedDict = collections.OrderedDict()
_constants_lock = threading.Lock()


def constant(values: np.ndarray, device) -> torch.Tensor:
    """`values` as a tensor on `device`, uploaded once per (contents,
    device) and kept: callers read it and never write it."""
    global CONSTANT_UPLOADS
    device = torch.device(device)
    key = (str(device), values.dtype.str, values.shape, values.tobytes())
    with _constants_lock:
        hit = _constants.get(key)
        if hit is not None:
            _constants.move_to_end(key)
    if hit is not None:
        if device.type == "cuda":
            hit.record_stream(torch.cuda.current_stream(device))
        return hit
    with span("jt.wait.upload"):
        made = _cuda.settled(torch.tensor(values, device=device))
    with _constants_lock:
        CONSTANT_UPLOADS += 1
        _constants[key] = made
        if len(_constants) > _CONSTANTS_SIZE:
            _constants.popitem(last=False)
    return made


def _require_full_f32() -> None:
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is True: the exact integer "
            "transform needs full-f32 matmuls; set it to False")
    precision = torch.get_float32_matmul_precision()
    if precision != "highest":
        raise RuntimeError(
            f"torch.get_float32_matmul_precision() is {precision!r}: the "
            "exact integer transform needs 'highest'")


def _mcu_transform_int(rgb: torch.Tensor, qy, qc, mode: Subsampling):
    """uint8 (H, W, 3) tensor, MCU-aligned, + (8, 8) raster quant tables ->
    (n_mcu, hv+2, 64) int32 quantized zig-zag blocks, MCU-interleaved in
    scan order (DC not yet DPCM'd), on rgb's device. A (K, H, W, 3) batch
    gives (K * n_mcu, hv+2, 64), image after image: K MCU-aligned images
    stacked along their rows are one tall image to the im2col, so the batch
    is still one matmul.

    Explicit im2col (one reshape + permute: stride == window, so patches
    don't overlap), ONE f32 matmul computing the hi/lo integer partial sums
    exactly, the integer combine, then round_half_away(c / (q * 2^S)) as
    sign * ((2|c| + d) // (2d)) with d = q << S (all magnitudes < 2^28)."""
    _require_full_f32()
    device = rgb.device
    hv = mode.h_factor * mode.v_factor
    d = constant(zigzag_qdiv_int(qy, qc, hv) << _INT_SCALE_BITS, device)
    with span("jt.encode.transform"):
        kern, bias = _device_kernel(mode, device)
        nco = (hv + 2) * 64
        mh, mw = mode.mcu_height, mode.mcu_width
        if rgb.ndim == 4:
            rgb = rgb.reshape(-1, *rgb.shape[2:])
        r, c = rgb.shape[0] // mh, rgb.shape[1] // mw
        patches = rgb.reshape(r, mh, c, mw * 3).permute(0, 2, 1, 3).reshape(
            r * c, mh * mw * 3)
        out = torch.matmul(patches.to(torch.float32), kern)
        acc = (
            out[:, :nco].to(torch.int32) * (1 << _HI_SHIFT)
            + out[:, nco:].to(torch.int32)
            + bias
        )
        q0 = (2 * torch.abs(acc) + d) // (2 * d)
        q = torch.where(acc < 0, -q0, q0)
    return q.reshape(-1, hv + 2, 64)


def mcu_transform(rgb: torch.Tensor, qy, qc, mode: Subsampling):
    """uint8 (H, W, 3) tensor, MCU-aligned, + (8, 8) raster quant tables ->
    (n_mcu, hv+2, 64) int32 quantized zig-zag blocks, MCU-interleaved in
    scan order (DC not yet DPCM'd), on rgb's device.

    The exact integer transform (_mcu_transform_int) on every device, the
    CPU included. So on the CPU this equals jpeg_tpu's accelerator form,
    jpeg_tpu.ops.mcu_conv._mcu_transform_int, and not
    jpeg_tpu.ops.mcu_conv.mcu_transform on a JAX CPU, which routes to a
    staged float form that is 1 off at .5 boundaries."""
    return _mcu_transform_int(rgb, qy, qc, mode)


@functools.cache
def gray_kernel_int() -> tuple[np.ndarray, np.ndarray]:
    """Integer fixed-point kernel of the single-plane (gray) transform:
    (k_hilo (64, 128) f32-storing-integers, bias_int (64,) int32). Same
    scale, split and exactness contract as mcu_kernel_int; the -128 level
    shift folds into the DC bias (-1024 * 2^S)."""
    d8 = dct.dct_basis().astype(np.float64)
    zz = np.kron(d8, d8)[np.asarray(tables.ZIGZAG_ORDER)]  # (64k, 64px)
    k_int = np.rint(zz.T * (1 << _INT_SCALE_BITS))  # (px, k)
    k_hi = np.rint(k_int / (1 << _HI_SHIFT))
    k_lo = k_int - k_hi * (1 << _HI_SHIFT)
    assert np.abs(k_hi).max() <= 256 and np.abs(k_lo).max() <= 1 << (
        _HI_SHIFT - 1
    )
    for half in (k_hi, k_lo):
        assert np.abs(half).sum(axis=0).max() * 255.0 < 2 ** 24
    bias = np.zeros(64, dtype=np.float64)
    bias[0] = -1024.0 * (1 << _INT_SCALE_BITS)
    return (np.concatenate([k_hi, k_lo], axis=1).astype(np.float32),
            np.rint(bias).astype(np.int32))


@functools.cache
def _gray_device_kernel(device: torch.device):
    """kernel_to_torch(*gray_kernel_int(), device), uploaded once."""
    kern, bias = kernel_to_torch(*gray_kernel_int(), device)
    return _cuda.settled(kern), _cuda.settled(bias)


def gray_transform_int(plane: torch.Tensor, qy) -> torch.Tensor:
    """uint8 (H, W) tensor, 8-aligned, + (8, 8) raster quant table ->
    (B, 64) int32 quantized zig-zag blocks in raster block order, on the
    plane's device: the gray twin of _mcu_transform_int (one full-f32
    matmul of integer operands, exact integer combine and quantizer), so
    bit-identical to jpeg_tpu's gray_transform_int on every device."""
    _require_full_f32()
    device = plane.device
    order = np.asarray(tables.ZIGZAG_ORDER)
    d = constant(np.asarray(qy).reshape(64)[order].astype(np.int32)
                 << _INT_SCALE_BITS, device)
    with span("jt.encode.transform"):
        kern, bias = _gray_device_kernel(device)
        flat = tile.blockify(plane).reshape(-1, 64)
        out = torch.matmul(flat.to(torch.float32), kern)
        acc = (
            out[:, :64].to(torch.int32) * (1 << _HI_SHIFT)
            + out[:, 64:].to(torch.int32)
            + bias
        )
        q0 = (2 * torch.abs(acc) + d) // (2 * d)
        return torch.where(acc < 0, -q0, q0)
