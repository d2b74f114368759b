"""Fused 8x8 transforms over image-layout planes: level shift + DCT +
quantize (encode) and dequantize + IDCT + level unshift (decode).

Counterparts of jpeg_tpu/ops/fused.py fused_dct_quantize and
fused_dequant_idct. On a CUDA tensor each launches a hand-written kernel
that does the whole 2-D transform in one pass:
  - kernel C, csrc/dct8.cu, replaces the Pallas kernel fused._dct8_kernel
    (pallas_call at fused.py:101);
  - kernel B, csrc/idct8.cu, replaces fused._idct8_kernel (pallas_call at
    fused.py:121);
  - kernel B2, the second entry of csrc/idct8.cu, does B's work for the
    decoder's finish: one launch over all of a decode's components, on the
    entropy decoder's zig-zag blocks in their scan order, writing rounded
    uint8 samples (dequant_idct_planes; dequant_idct_samples for one
    component).
On a CPU tensor each runs its plain twin (fused_dct_quantize_reference,
fused_dequant_idct_reference, dequant_idct_planes_reference,
dequant_idct_samples_reference). The kernels' source notes say what bounds
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

from jpeg_tpu_torch.ops import _cuda, dct, mcu_conv, quant, tile, zigzag

# Kernel B launches since the last reset (plus one per launch, nowhere else).
LAUNCHES = 0
# Kernel C launches since the last reset (plus one per launch, nowhere else).
DCT_LAUNCHES = 0
# Kernel B2 launches since the last reset (plus one per launch, nowhere else).
ZZ_LAUNCHES = 0
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


def _check_blocks(zz: torch.Tensor, blocks_shape) -> tuple:
    hb, wb = (int(n) for n in blocks_shape)
    if zz.ndim != 2 or zz.shape[1] != 64 or zz.shape[0] != hb * wb:
        raise ValueError(
            f"zz must be ({hb} * {wb}, 64) zig-zag blocks, got "
            f"{tuple(zz.shape)}")
    return hb, wb


def _check_out(out, shape, device) -> None:
    if out is not None and (tuple(out.shape) != shape
                            or out.dtype != torch.uint8
                            or out.device != device
                            or not out.is_contiguous()):
        raise ValueError(
            f"out must be a contiguous {shape} uint8 tensor on {device}, got "
            f"{tuple(out.shape)} {out.dtype} on {out.device}")


def _components(zzs, qtables, shapes, scan, n_img: int, outs) -> list:
    """Checks dequant_idct_planes' arguments; per component (zz, qtable,
    (hb, wb), scan geometry or None, out or None)."""
    ncomp = len(zzs)
    scan = (None,) * ncomp if scan is None else tuple(scan)
    outs = (None,) * ncomp if outs is None else tuple(outs)
    if not 1 <= ncomp <= 3 or not (len(qtables) == len(shapes) == len(scan)
                                   == len(outs) == ncomp):
        raise ValueError("dequant_idct_planes takes 1-3 components, with a "
                         "table, a block grid and a scan order each")
    if n_img < 1:
        raise ValueError(f"n_img must be at least 1, got {n_img}")
    comps = []
    for zz, q, shape, geo, out in zip(zzs, qtables, shapes, scan, outs):
        hb, wb = (int(n) for n in shape)
        per = hb * wb
        want = (n_img, per, 64) if zz.ndim == 3 else (n_img * per, 64)
        if tuple(zz.shape) != want or zz.device != zzs[0].device:
            raise ValueError(
                f"zz must be {want} zig-zag blocks on {zzs[0].device}, got "
                f"{tuple(zz.shape)} on {zz.device}")
        if geo is not None:
            mcu_rows, mcu_cols, v, h = (int(n) for n in geo)
            if (mcu_rows * v, mcu_cols * h) != (hb, wb):
                raise ValueError(
                    f"scan geometry {tuple(geo)} does not tile the {hb}x{wb} "
                    "block grid")
            geo = (mcu_rows, mcu_cols, v, h)
        _check_out(out, (n_img * hb * 8, wb * 8), zz.device)
        comps.append((zz, q, (hb, wb), geo, out))
    return comps


def dequant_idct_planes_reference(zzs, qtables, shapes, scan=None,
                                  n_img: int = 1, outs=None) -> list:
    """Plain twin of dequant_idct_planes (any device): per component the
    blocks to plane raster order (the MCU reorder as a reshape + permute,
    layout.scan_to_raster's), then dequant_idct_samples_reference on the
    images stacked along their rows."""
    res = []
    for zz, q, (hb, wb), geo, out in _components(zzs, qtables, shapes, scan,
                                                 n_img, outs):
        z = zz.reshape(-1, 64)
        if geo is not None:
            mcu_rows, mcu_cols, v, h = geo
            z = z.reshape(n_img * mcu_rows, mcu_cols, v, h, 64).permute(
                0, 2, 1, 3, 4).reshape(-1, 64)
        res.append(dequant_idct_samples_reference(z, q, (n_img * hb, wb),
                                                  out))
    return res


def _launch_idct_samples(zzs, qs, outs, geos, lib=None) -> None:
    """Enqueue kernel B2 on PyTorch's current stream, one launch for every
    component: per component prepared tensors (int32 zig-zag blocks whose
    rows are contiguous, 16-byte aligned; (64,) f32 raster table; the
    contiguous uint8 plane out, 8-byte aligned) and its geometry (n, hb,
    wb, image stride in blocks, mcu_cols, v, h); no checks and no
    allocation. Counts the launch. A CPU device takes the host build of the
    kernel's bodies that the tests pass as `lib`."""
    global ZZ_LAUNCHES
    dev = zzs[0].device
    lib = lib or _cuda.load("idct8")
    n = len(zzs)

    def ptrs(ts):
        return (ctypes.c_void_p * n)(*(t.data_ptr() for t in ts))

    geo = (ctypes.c_int * (7 * n))(*(int(v) for g in geos for v in g))
    args = (ptrs(zzs), ptrs(qs), ptrs(outs), geo, ctypes.c_int(n))
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            err = lib.jt_idct8_samples(*args, _cuda.stream_handle(dev))
    else:
        err = lib.jt_idct8_samples(*args, None)
    _cuda.check("idct8_samples", err)
    with _COUNT_LOCK:
        ZZ_LAUNCHES += 1


# B2 numbers a component's blocks in 32 bits.
MAX_BLOCKS = (1 << 31) - 1


def _prepare_planes(comps, n_img: int, device):
    """Kernel B2's launch arguments from _components: (blocks, tables,
    outs, geometries), each output allocated where not given."""
    zs, qs, outs, geos = [], [], [], []
    for zz, q, (hb, wb), geo, out in comps:
        z = zz.to(torch.int32)
        per = hb * wb
        if z.ndim == 3 and z.stride(2) == 1 and z.stride(1) == 64 and (
                z.stride(0) % 64 == 0):
            stride = z.stride(0) // 64
        else:
            z, stride = z.contiguous(), per
        if n_img * per > MAX_BLOCKS or n_img * stride > MAX_BLOCKS:
            raise ValueError(f"{n_img} x {per} blocks: at most {MAX_BLOCKS}")
        mcu_cols, v, h = (wb, 1, 1) if geo is None else geo[1:]
        if out is None:
            out = torch.empty((n_img * hb * 8, wb * 8), dtype=torch.uint8,
                              device=device)
        if per:
            _require_aligned("dequant_idct_planes", zz=z)
            if out.data_ptr() % 8:
                raise ValueError(
                    "dequant_idct_planes: out is not 8-byte aligned")
        zs.append(z)
        qs.append(torch.as_tensor(q, dtype=torch.float32,
                                  device=device).reshape(64).contiguous())
        outs.append(out)
        geos.append((n_img, hb, wb, stride, mcu_cols, v, h))
    return zs, qs, outs, geos


def _dequant_idct_planes_cuda(zzs, qtables, shapes, scan=None,
                              n_img: int = 1, outs=None) -> list:
    comps = _components(zzs, qtables, shapes, scan, n_img, outs)
    zs, qs, outs, geos = _prepare_planes(comps, n_img, zzs[0].device)
    if any(g[1] * g[2] for g in geos):
        _launch_idct_samples(zs, qs, outs, geos)
    return outs


def dequant_idct_planes(zzs, qtables, shapes, scan=None, n_img: int = 1,
                        outs=None) -> list:
    """1-3 components' int32 zig-zag quantized blocks -> each one's uint8
    samples, clip(round(IDCT(deq) + 128), 0, 255), as a (n_img 8 hb, 8 wb)
    plane (n_img images stacked along their rows).

    Per component: zz, its blocks, (n_img hb wb, 64) or, for n_img images
    whose blocks lie at a fixed stride (a slice of a batch's (n, B, 64)
    rows, read without a copy), (n_img, hb wb, 64); its (8, 8) table (array,
    or a tensor on zz's device); its block grid (hb, wb) per image; its scan
    order, None for plane raster block order or (mcu_rows, mcu_cols, v, h)
    for the entropy decoder's MCU order (each image's MCUs in raster order,
    each MCU's v x h blocks in raster order, spec A.2.3); and `outs`, a
    contiguous uint8 plane per component to write into (slices of one
    buffer save a copy), or None. Returns the planes.

    CUDA tensors launch kernel B2 (csrc/idct8.cu, jt_idct8_samples) ONCE for
    every component, reading the blocks in their scan order in place; its
    samples equal kernel B's rounded and clamped bit for bit. CPU tensors
    run the plain twin. Any other device raises."""
    kind = zzs[0].device.type
    if kind == "cpu":
        return dequant_idct_planes_reference(zzs, qtables, shapes, scan,
                                             n_img, outs)
    if kind == "cuda":
        return _dequant_idct_planes_cuda(zzs, qtables, shapes, scan, n_img,
                                         outs)
    raise ValueError(
        f"dequant_idct_planes: unsupported device {zzs[0].device}")


def dequant_idct_samples_reference(zz: torch.Tensor, qtable, blocks_shape,
                                   out=None) -> torch.Tensor:
    """Plain twin of dequant_idct_samples (any device): the chain it
    replaces, from_zigzag -> unblockify -> fused_dequant_idct_reference ->
    round (half to even) -> clamp to [0, 255] -> uint8."""
    hb, wb = _check_blocks(zz, blocks_shape)
    _check_out(out, (hb * 8, wb * 8), zz.device)
    plane = fused_dequant_idct_reference(
        tile.unblockify(zigzag.from_zigzag(zz.reshape(hb, wb, 64))), qtable)
    samples = torch.clamp(torch.round(plane), 0.0, 255.0).to(torch.uint8)
    if out is None:
        return samples
    return out.copy_(samples)


def dequant_idct_samples(zz: torch.Tensor, qtable, blocks_shape,
                         out=None) -> torch.Tensor:
    """(hb wb, 64) int32 zig-zag quantized blocks in plane raster block
    order + (8, 8) table (array, or a tensor on zz's device) + the block grid
    (hb, wb) -> (8 hb, 8 wb) uint8 samples, clip(round(IDCT(deq) + 128), 0,
    255): what fused_dequant_idct, round and clamp give on
    unblockify(from_zigzag(zz)). `out`, a contiguous (8 hb, 8 wb) uint8
    tensor on zz's device, receives the samples (a slice of a larger buffer
    saves a copy); it is returned.

    One component of dequant_idct_planes: CUDA tensors launch kernel B2
    (csrc/idct8.cu, jt_idct8_samples) once; CPU tensors run the plain twin.
    Any other device raises."""
    kind = zz.device.type
    if kind == "cpu":
        return dequant_idct_samples_reference(zz, qtable, blocks_shape, out)
    if kind == "cuda":
        hb, wb = _check_blocks(zz, blocks_shape)
        return _dequant_idct_planes_cuda([zz], [qtable], [(hb, wb)],
                                         outs=[out])[0]
    raise ValueError(f"dequant_idct_samples: unsupported device {zz.device}")
