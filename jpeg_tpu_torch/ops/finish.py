"""The decode finish after the samples: chroma upsample, YCbCr -> RGB, round,
clip to uint8 and the crop, over three sample planes.

The reference runs it inside one jitted XLA program, _jit_finish_color
(jpeg_tpu/models/decoder.py:349-357, around _finish_color at :94-119). On a
CUDA tensor finish_color launches kernel H (csrc/finish_color.cu), one pass
from the samples to the cropped image; on a CPU tensor it runs the plain
twin, finish_color_reference, the chain of torch ops the port ran before:
upsample per plane (ops/subsample), the colour map (ops/color), round, clip,
crop. The two are equal bit for bit: integer samples make every step before
the colour map exact in f32, and the kernel keeps the map's f32 operations
and their order (the source note says how).
"""

from __future__ import annotations

import ctypes
import threading

import torch

from jpeg_tpu_torch.ops import _cuda, color, subsample

# Kernel H launches since the last reset (plus one per launch, nowhere else).
LAUNCHES = 0
# Worker threads launch too (parallel/pipeline), so the increment holds a lock.
_COUNT_LOCK = threading.Lock()

_DOUBLINGS = {1: 0, 2: 1, 4: 2}
# Kernel H's grid takes the output rows and the images as its y and z.
MAX_EXTENT = 65535


def upsample(plane: torch.Tensor, factor, fan: bool) -> torch.Tensor:
    """A (..., H, W) sample plane upsampled by its (fh, fv) ratios to the
    max-sampled grid (triangular or replication per `fan`)."""
    fh, fv = factor
    if fh == 1 and fv == 1:
        return plane
    up = subsample.fancy_upsample_factors if fan else subsample.upsample_factors
    return up(plane, fv, fh)


def rgb_from_planes(planes, is_rgb: bool) -> torch.Tensor:
    """Three upsampled (..., H, W) sample planes -> (..., H, W, 3) uint8
    RGB. is_rgb: components are stored as R/G/B, so the YCbCr matrix is
    skipped."""
    ycc = torch.stack(planes, dim=-1)
    rgb = ycc if is_rgb else color.ycbcr_to_rgb(ycc, clip=False)
    return torch.clamp(torch.round(rgb), 0, 255).to(torch.uint8)


def axis_filters(factor, fan: bool) -> tuple:
    """(ph, pv, rh, rv) of one plane, as `upsample` runs it: triangle
    doublings along columns and rows, and the replication factor where an
    axis has none. A horizontal ratio of 3 replicates both axes; a vertical
    one of 3 replicates the rows after the horizontal doublings."""
    fh, fv = factor
    if not fan or fh == 3:
        return 0, 0, fh, fv
    if fv == 3:
        return _DOUBLINGS[fh], 0, 1, 3
    return _DOUBLINGS[fh], _DOUBLINGS[fv], 1, 1


def _geometry(planes, factors, fancy, hlim: int, wlim: int):
    """Checks the three planes against their ratios and the crop; returns
    (images, per plane (rows, cols, ph, pv, rh, rv))."""
    if len(planes) != 3 or len(factors) != 3 or len(fancy) != 3:
        raise ValueError("finish_color takes three planes, ratios and choices")
    ndim = planes[0].ndim
    if ndim not in (2, 3) or any(p.ndim != ndim for p in planes):
        raise ValueError(
            f"planes must all be (H, W) or all (n, H, W), got "
            f"{[tuple(p.shape) for p in planes]}")
    n = planes[0].shape[0] if ndim == 3 else 1
    dev = planes[0].device
    geo, full = [], set()
    for p, (fh, fv), fan in zip(planes, factors, fancy):
        if p.dtype != torch.uint8 or p.device != dev or (
                ndim == 3 and p.shape[0] != n):
            raise ValueError(
                f"planes must be uint8 on one device with one image count, "
                f"got {tuple(p.shape)} {p.dtype} on {p.device}")
        if not (1 <= fh <= 4 and 1 <= fv <= 4):
            raise ValueError(f"upsampling ratio out of range: {(fh, fv)}")
        rows, cols = p.shape[-2:]
        full.add((rows * fv, cols * fh))
        geo.append((rows, cols, *axis_filters((fh, fv), bool(fan))))
    if len(full) != 1:
        raise ValueError(f"the planes upsample to different sizes: {full}")
    h, w = full.pop()
    if not (0 <= hlim <= h and 0 <= wlim <= w):
        raise ValueError(f"crop {(hlim, wlim)} outside the {(h, w)} image")
    if hlim > MAX_EXTENT or n > MAX_EXTENT:
        raise ValueError(f"{n} images of {hlim} rows: at most {MAX_EXTENT} "
                         "of each (a JPEG frame has at most 65535 rows)")
    return n, geo


def finish_color_reference(planes, factors, fancy, is_rgb: bool, hlim: int,
                           wlim: int) -> torch.Tensor:
    """Plain twin of finish_color (any device): upsample each plane in f32,
    the colour map, round, clip, crop."""
    _geometry(planes, factors, fancy, hlim, wlim)
    ups = [upsample(p.to(torch.float32), f, bool(fan))
           for p, f, fan in zip(planes, factors, fancy)]
    return rgb_from_planes(ups, is_rgb)[..., :hlim, :wlim, :].contiguous()


def _launch_finish(planes, geo, out, n: int, hlim: int, wlim: int,
                   is_rgb: bool, lib=None) -> None:
    """Enqueue kernel H on PyTorch's current stream: prepared contiguous
    uint8 planes and out, per plane (rows, cols, ph, pv, rh, rv), no checks
    and no allocation. Counts the launch. A CPU device takes the host build
    of the kernel's thread body that the tests pass as `lib`."""
    global LAUNCHES
    dev = out.device
    lib = lib or _cuda.load("finish_color")
    ptrs = (ctypes.c_void_p * 3)(*(p.data_ptr() for p in planes))
    g = (ctypes.c_int * 18)(*(int(v) for row in geo for v in row))
    m = (ctypes.c_float * 9)(*color.YCBCR_TO_RGB.reshape(-1).tolist())
    args = (ptrs, g, m, ctypes.c_void_p(out.data_ptr()), ctypes.c_int(n),
            ctypes.c_int(hlim), ctypes.c_int(wlim), ctypes.c_int(int(is_rgb)))
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            err = lib.jt_finish_color(*args, _cuda.stream_handle(dev))
    else:
        err = lib.jt_finish_color(*args, None)
    _cuda.check("finish_color", err)
    with _COUNT_LOCK:
        LAUNCHES += 1


def _finish_color_cuda(planes, factors, fancy, is_rgb: bool, hlim: int,
                       wlim: int) -> torch.Tensor:
    n, geo = _geometry(planes, factors, fancy, hlim, wlim)
    ps = [p.contiguous() for p in planes]
    shape = (hlim, wlim, 3) if planes[0].ndim == 2 else (n, hlim, wlim, 3)
    out = torch.empty(shape, dtype=torch.uint8, device=planes[0].device)
    if out.numel():
        _launch_finish(ps, geo, out, n, hlim, wlim, is_rgb)
    return out


def finish_color(planes, factors, fancy, is_rgb: bool, hlim: int,
                 wlim: int) -> torch.Tensor:
    """Three uint8 sample planes at their padded block-grid sizes, each
    (H_c, W_c) or, for n images stacked, (n, H_c, W_c); per plane its (fh,
    fv) ratios to the max-sampled grid (1-4) and its triangular-vs-
    replication choice -> the contiguous (hlim, wlim, 3), or (n, hlim,
    wlim, 3), uint8 image: upsampled, YCbCr -> RGB unless is_rgb, rounded
    half to even, clipped, cropped. The triangle's edge samples read the
    padding rows and columns before the crop; no filter crosses from one
    image of a batch into another.

    CUDA tensors launch kernel H (csrc/finish_color.cu); CPU tensors run the
    plain twin. Any other device raises."""
    kind = planes[0].device.type
    if kind == "cpu":
        return finish_color_reference(planes, factors, fancy, is_rgb, hlim,
                                      wlim)
    if kind == "cuda":
        return _finish_color_cuda(planes, factors, fancy, is_rgb, hlim, wlim)
    raise ValueError(f"finish_color: unsupported device {planes[0].device}")
