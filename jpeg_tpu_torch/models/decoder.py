"""The decoder pipeline: JFIF JPEG bytes -> RGB pixels.

  host: JFIF parse, native C++ Huffman decode to dense zig-zag coefficients,
  scan -> raster block order; device: de-zigzag, dequant + IDCT + unshift
  (kernel B, ops/fused), round and clip, chroma upsample, YCbCr -> RGB,
  round and clip to uint8; host: crop.

Gray (1-component) baseline streams take the same route with one block per
MCU and no colour map (jpeg_tpu's dense _finish_gray).

The port covers 1-component and 3-component single-scan (interleaved)
baseline streams whose components use Huffman table ids 0/1. Other streams
and options raise NotImplementedError naming the ROADMAP.md item that will
bring them.
"""

from __future__ import annotations

import numpy as np
import torch

from jpeg_tpu_torch.entropy import native
from jpeg_tpu_torch.io import jfif
from jpeg_tpu_torch.models import layout
from jpeg_tpu_torch.ops import color, fused, subsample, tile, zigzag


def _reconstruct_plane(zz, qtab, blocks_shape):
    """(N, 64) zig-zag quantized blocks in plane raster order -> (H, W)
    float plane of integer samples in [0, 255].

    The samples are rounded and range-limited *before* any upsampling or
    colour math, matching libjpeg's post-IDCT range_limit: clamping order is
    observable through the triangular chroma upsample at extreme
    quantization."""
    hb, wb = blocks_shape
    blocks = zigzag.from_zigzag(zz.reshape(hb, wb, 64))
    plane = fused.fused_dequant_idct(tile.unblockify(blocks), qtab)
    return torch.clamp(torch.round(plane), 0.0, 255.0)


def _finish_color(y_zz, cb_zz, cr_zz, qy, qcb, qcr, shapes, factors,
                  fancy=(True, True, True), is_rgb: bool = False):
    """shapes: per-component block grids (hb, wb); factors: per-component
    (fh, fv) upsampling ratios to the max-sampled grid. fancy: per-component
    triangular-vs-replication choice (upsample_choices). is_rgb: components
    are stored as R/G/B, so the YCbCr matrix is skipped."""
    planes = []
    for zz, q, shape, (fh, fv), fan in zip(
        (y_zz, cb_zz, cr_zz), (qy, qcb, qcr), shapes, factors, fancy
    ):
        p = _reconstruct_plane(zz, q, shape)
        if fh > 1 or fv > 1:
            up = (
                subsample.fancy_upsample_factors
                if fan else subsample.upsample_factors
            )
            p = up(p, fv, fh)
        planes.append(p)
    ycc = torch.stack(planes, dim=-1)
    rgb = ycc if is_rgb else color.ycbcr_to_rgb(ycc)
    return torch.clamp(torch.round(rgb), 0, 255).to(torch.uint8)


def _finish_gray(zz, qy, shape):
    return _reconstruct_plane(zz, qy, shape).to(torch.uint8)


def upsample_choices(width: int, components, hmax: int,
                     fancy_requested: bool) -> tuple:
    """Per-component fancy-vs-replication choice, mirroring libjpeg's
    jdsample.c start_pass: triangular ("fancy") upsampling applies only when
    the component's true downsampled width exceeds 2 samples."""
    out = []
    for c in components:
        cw = layout.ceil_div(width * c.h, hmax)
        out.append(bool(fancy_requested) and cw > 2)
    return tuple(out)


def _check_supported(info: jfif.FrameInfo) -> None:
    comps = info.components
    if len(comps) == 4:
        raise NotImplementedError(
            "CMYK/YCCK decode is not ported yet (ROADMAP.md Queue 1 item 4)")
    if len(comps) not in (1, 3):
        raise jfif.JpegFormatError(f"unsupported component count {len(comps)}")
    if info.progressive:
        raise NotImplementedError(
            "progressive decode is not ported yet (ROADMAP.md Queue 1 item 4)")
    if len(info.scans) != 1 or len(info.scans[0].comp_ids) != len(comps):
        raise NotImplementedError(
            "non-interleaved multi-scan decode is not ported yet "
            "(ROADMAP.md Queue 1 item 4)")
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    for c in comps:
        if not (1 <= c.h <= 4 and 1 <= c.v <= 4):
            raise jfif.JpegFormatError(
                f"sampling factors out of range: {(c.h, c.v)}"
            )
        if hmax % c.h or vmax % c.v:
            raise jfif.JpegFormatError(
                f"non-integer upsampling ratio: {(c.h, c.v)} in a frame with "
                f"max factors {(hmax, vmax)}"
            )
    if sum(c.h * c.v for c in comps) > 10:
        raise jfif.JpegFormatError("more than 10 blocks per MCU (spec B.2.3)")
    for c in comps:
        for key in ((0, c.dc_id), (1, c.ac_id)):
            if key not in info.htables:
                raise jfif.JpegFormatError(
                    f"scan references undefined Huffman table "
                    f"{'AC' if key[0] else 'DC'} {key[1]}"
                )
        if c.dc_id != c.ac_id or c.dc_id not in (0, 1):
            raise NotImplementedError(
                "streams whose components use Huffman table ids other than a "
                "shared 0 or 1 are not ported yet (ROADMAP.md Queue 1 item 4)")


def decode(data: bytes, fancy_upsample: bool = True, device="cuda",
           max_pixels: int | None = 2_000_000_000,
           scale_denom: int = 1, output: str = "rgb",
           device_output: bool = False) -> np.ndarray:
    """Decode JPEG bytes to (H, W, 3) RGB uint8 (or (H, W) uint8 for a gray
    stream), running the IDCT, upsample
    and colour map on `device` ("cuda" by default; "cpu" runs the plain
    twins). Entropy decoding runs in the native C++ runtime on the host.

    fancy_upsample: triangular chroma interpolation (libjpeg-style) instead
    of pixel doubling. max_pixels: allocation guard against adversarial
    headers; None disables. scale_denom, output="ycbcr" and device_output
    are not ported yet and raise NotImplementedError."""
    if output not in ("rgb", "ycbcr"):
        raise ValueError(f"unknown output {output!r}")
    if scale_denom not in (1, 2, 4, 8):
        raise ValueError(f"scale_denom must be 1, 2, 4 or 8, got {scale_denom}")
    if scale_denom != 1 or output != "rgb" or device_output:
        raise NotImplementedError(
            "scale_denom, output='ycbcr' and device_output are not ported "
            "yet (ROADMAP.md Queue 1 item 4)")
    device = torch.device(device)
    info = jfif.parse_jpeg(data)
    if max_pixels is not None and info.width * info.height > max_pixels:
        raise jfif.JpegFormatError(
            f"frame {info.width}x{info.height} exceeds max_pixels={max_pixels}"
        )
    _check_supported(info)
    comps = info.components
    if len(comps) == 1:
        # Non-interleaved single-component scan: MCU = one block (spec
        # A.2.2), so scan order is raster order.
        c0 = comps[0]
        mcu_rows = layout.ceil_div(info.height, 8)
        mcu_cols = layout.ceil_div(info.width, 8)
        zz = native.decode_scan(
            info.scan_data, mcu_rows * mcu_cols, [(0, 1, c0.dc_id, c0.ac_id)],
            info.htables, info.restart_interval,
        )[0]
        qy = torch.as_tensor(info.qtables[c0.qtab_id], dtype=torch.float32,
                             device=device)
        out = _finish_gray(torch.as_tensor(zz, device=device), qy,
                           (mcu_rows, mcu_cols))
        return out[: info.height, : info.width].cpu().numpy()
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    mcu_rows = layout.ceil_div(info.height, 8 * vmax)
    mcu_cols = layout.ceil_div(info.width, 8 * hmax)
    n_mcu = mcu_rows * mcu_cols

    mcu_layout = [
        (i, c.h * c.v, c.dc_id, c.ac_id) for i, c in enumerate(comps)
    ]
    scans = native.decode_scan(
        info.scan_data, n_mcu, mcu_layout, info.htables, info.restart_interval,
    )
    # Scan order -> plane raster order per component (spec A.2.3).
    zz = [
        layout.scan_to_raster(s, mcu_rows, mcu_cols, c.v, c.h)
        if c.h * c.v > 1 else s
        for c, s in zip(comps, scans)
    ]
    shapes = tuple((mcu_rows * c.v, mcu_cols * c.h) for c in comps)
    factors = tuple((hmax // c.h, vmax // c.v) for c in comps)
    qtabs = [torch.as_tensor(info.qtables[c.qtab_id], dtype=torch.float32,
                             device=device) for c in comps]
    fancy = upsample_choices(info.width, comps, hmax, fancy_upsample)
    # Components stored as RGB (no color transform): Adobe APP14 with
    # transform=0, or literal 'R','G','B' component ids (libjpeg convention).
    is_rgb = info.adobe_transform == 0 or (
        info.adobe_transform is None
        and tuple(c.comp_id for c in comps) == (0x52, 0x47, 0x42)
    )
    planes = [torch.as_tensor(np.ascontiguousarray(z), device=device)
              for z in zz]
    out = _finish_color(*planes, *qtabs, shapes, factors, fancy, is_rgb)
    return out[: info.height, : info.width].cpu().numpy()
