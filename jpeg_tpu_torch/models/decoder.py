"""The decoder pipeline: JFIF JPEG bytes -> RGB/gray/CMYK pixels.

  host: JFIF parse, Huffman scan decode (native C++ or NumPy walkers; for
  baseline single-scan streams the sparse walk, which yields only the
  nonzero coefficients) -> one upload -> device: densify (sparse payloads),
  or the Huffman decode itself (entropy="indexed": kernel D after a host
  index pass; entropy="device": the chunked block-start program, anchored at
  every restart segment or program F without markers, + kernel D;
  ops/entropy_decode), then the finish: de-zigzag, dequant + IDCT +
  unshift, round and clip to uint8 samples (kernel B2, ops/fused, one
  launch for every component, reading the blocks in their MCU scan order;
  the other forms first reorder them to raster order: the DCT-domain scaled
  IDCT for scale_denom 2/4/8, use_pallas=False, CMYK/YCCK), then chroma
  upsample, YCbCr -> RGB, round and clip to uint8 and the crop (kernel H,
  ops/finish).

Sequential (SOF0/SOF1) and progressive (SOF2) Huffman modes, 8-bit, 1, 3 or
4 components (gray / YCbCr / RGB / Adobe CMYK+YCCK), arbitrary per-component
sampling factors 1-4 with integer upsampling ratios, interleaved or
non-interleaved multi-scan, any Huffman table ids: everything
jpeg_tpu.decode takes, and decode_batched for K homogeneous baseline
streams.

Full-size planes (k = 8) run kernel B2 on a CUDA device and its plain twin
on the CPU by default (use_pallas=True). use_pallas=False takes jpeg_tpu's
default formulation instead: one (64, 64) matmul on a card, the separable
block IDCT on the CPU, no kernel. Either way a colour image's samples go
through kernel H on a card (its twin on the CPU); 4-component streams and
the mesh layer's stripes (parallel/shard) keep the f32 planes of
_reconstruct_plane and the torch upsample and colour map.
"""

from __future__ import annotations

import os
import typing

import numpy as np
import torch

from jpeg_tpu_torch.entropy import (
    decode_device, decode_np, native, progressive_np)
from jpeg_tpu_torch.io import jfif
from jpeg_tpu_torch.models import layout
from jpeg_tpu_torch.ops import (
    color, dct, finish, fused, mcu_conv, quant, tile, zigzag)
from jpeg_tpu_torch.utils.trace import span

ENTROPY_BACKENDS = ("auto", "native", "numpy", "device", "indexed", "sparse")


def _reconstruct_plane(zz, qtab, blocks_shape, k: int = 8,
                       use_pallas: bool = True):
    """(N, 64) zig-zag quantized blocks in plane raster order ->
    (H*k/8, W*k/8) float plane of integer samples in [0, 255]. k < 8 runs
    the DCT-domain scaled IDCT (libjpeg "draft"/jidctred semantics,
    dct.idct_scaled_basis): each 8x8 block reconstructs as k x k pixels from
    its lowest k x k frequencies, as two full-f32 contractions (no kernel:
    the reference runs it as an einsum outside Pallas too).

    k = 8: use_pallas runs dequant + IDCT + 128 as kernel B
    (fused.fused_dequant_idct). Otherwise jpeg_tpu's default formulation,
    branch for branch (jpeg_tpu/models/decoder.py, _reconstruct_plane): on
    a card de-zigzag + dequantize + IDCT as ONE (64, 64) matmul, the table
    permuted to zig-zag order scaling the coefficients first
    (dct.idct_zigzag_blocks), then the blocks back into the plane; on the
    CPU the separable block IDCT of the dequantized raster blocks.

    The samples are rounded and range-limited *before* any upsampling or
    colour math, matching libjpeg's post-IDCT range_limit: clamping order is
    observable through the triangular chroma upsample at extreme
    quantization. Integer samples also make every later f32 op exact enough
    that the host finish (finish_ycbcr) reproduces the device's bytes."""
    hb, wb = blocks_shape
    if k == 8 and not use_pallas and zz.device.type != "cpu":
        qz = torch.as_tensor(qtab, dtype=torch.float32, device=zz.device)
        qz = zigzag.to_zigzag(qz.reshape(8, 8))
        flat = dct.idct_zigzag_blocks(zz.reshape(-1, 64).to(torch.float32) * qz)
        plane = tile.plane_from_scan_blocks(flat, hb, wb) + 128.0
        return torch.clamp(torch.round(plane), 0.0, 255.0)
    blocks = zigzag.from_zigzag(zz.reshape(hb, wb, 64))
    if k != 8:
        if zz.device.type == "cuda":
            mcu_conv._require_full_f32()  # the einsums must not run in TF32
        coeff = quant.dequantize(blocks, qtab)
        b = torch.as_tensor(dct.idct_scaled_basis(k), device=zz.device)
        if k == 1:
            # One sample per block, from the DC alone: DC * (b00 * b00), the
            # two basis entries multiplied first, as jnp.einsum orders
            # "yu,abuv,xv->abyx" for a (1, 8) basis. The order matters here:
            # b00 * b00 is 0.12499999 in f32, samples land on .5 boundaries
            # often, and (DC * b00) * b00 rounds many of them the other way.
            plane = coeff[..., 0, 0] * (b[0, 0] * b[0, 0]) + 128.0
        else:
            t = torch.einsum("yu,abuv->abyv", b, coeff)
            small = torch.einsum("abyv,xv->abyx", t, b)
            plane = small.permute(0, 2, 1, 3).reshape(hb * k, wb * k) + 128.0
    elif use_pallas:
        plane = fused.fused_dequant_idct(tile.unblockify(blocks), qtab)
    else:
        coeff = quant.dequantize(blocks, qtab)
        plane = tile.unblockify(dct.idct_blocks(coeff)) + 128.0
    return torch.clamp(torch.round(plane), 0.0, 255.0)


def _reconstruct_batch(zz, qtab, blocks_shape, k: int, n_img: int,
                       use_pallas: bool = True):
    """_reconstruct_plane for n_img images of one geometry whose raster
    blocks follow one another in `zz`: (n_img, H*k/8, W*k/8) planes. Blocks
    are independent, so at full size the images stacked along their rows
    are one plane to kernel B: one launch for the batch. The matmul forms
    (k < 8, or use_pallas=False) run image by image, because their
    contractions go to cuBLAS, which may sum in another order on another
    shape, and the batch must give decode()'s pixels exactly."""
    hb, wb = blocks_shape
    if k == 8 and use_pallas:
        plane = _reconstruct_plane(zz, qtab, (n_img * hb, wb), k)
    else:
        plane = torch.cat([
            _reconstruct_plane(z, qtab, blocks_shape, k, use_pallas)
            for z in zz.chunk(n_img)])
    return plane.reshape(n_img, hb * k, wb * k)


def _upsampled_planes(zzs, qtabs, shapes, factors, fancy, k: int = 8,
                      use_pallas: bool = True):
    """Per-component reconstructed f32 planes, each upsampled to the
    max-sampled grid (the 4-component finish)."""
    return [finish.upsample(_reconstruct_plane(zz, q, shape, k, use_pallas),
                            factor, fan)
            for zz, q, shape, factor, fan
            in zip(zzs, qtabs, shapes, factors, fancy)]


def _samples(zz, qtab, blocks_shape, k: int = 8, use_pallas: bool = True,
             n_img: int = 1, out=None):
    """_reconstruct_batch's samples as uint8: (n_img * H*k/8, W*k/8) for
    n_img images whose raster blocks follow one another in `zz`, from the
    f32 integer samples of the forms other than kernel B2 (the scaled IDCT,
    use_pallas=False), converted exactly. `out` (a contiguous uint8 tensor
    of that shape) receives them."""
    hb, wb = blocks_shape
    if n_img == 1:
        plane = _reconstruct_plane(zz, qtab, blocks_shape, k, use_pallas)
    else:
        plane = _reconstruct_batch(zz, qtab, blocks_shape, k, n_img,
                                   use_pallas)
    samples = plane.reshape(n_img * hb * k, wb * k).to(torch.uint8)
    return samples if out is None else out.copy_(samples)


def _component_samples(zzs, qtabs, shapes, k: int = 8,
                       use_pallas: bool = True, n_img: int = 1, scan=None,
                       outs=None):
    """Every component's uint8 samples, (n_img * H*k/8, W*k/8) each, from
    its zig-zag blocks: (n_img * N, 64), or (n_img, N, 64) for a batch's
    rows. scan: per component None (plane raster block order) or its MCU
    geometry (mcu_rows, mcu_cols, v, h) of ONE image, the blocks then in
    the entropy decoder's scan order. outs: a uint8 tensor per component to
    write into, or None.

    At full size with use_pallas, kernel B2 (fused.dequant_idct_planes)
    ONCE for all components, reading the scan order in place. Otherwise
    each component's blocks go to raster order (layout.scan_to_raster on
    the images' MCU rows stacked) and through _samples."""
    scan = (None,) * len(zzs) if scan is None else scan
    outs = (None,) * len(zzs) if outs is None else outs
    if k == 8 and use_pallas:
        return fused.dequant_idct_planes(zzs, qtabs, shapes, scan, n_img,
                                         outs)
    planes = []
    for zz, q, shape, geo, out in zip(zzs, qtabs, shapes, scan, outs):
        zz = zz.reshape(-1, 64)
        if geo is not None:
            mcu_rows, mcu_cols, v, h = geo
            zz = layout.scan_to_raster(zz, n_img * mcu_rows, mcu_cols, v, h)
        planes.append(_samples(zz, q, shape, k, use_pallas, n_img, out))
    return planes


def _finish_color(y_zz, cb_zz, cr_zz, qy, qcb, qcr, shapes, factors,
                  fancy=(True, True, True), is_rgb: bool = False, k: int = 8,
                  n_img: int | None = None, use_pallas: bool = True,
                  hlim: int | None = None, wlim: int | None = None,
                  scan=None):
    """shapes: per-component block grids (hb, wb); factors: per-component
    (fh, fv) upsampling ratios to the max-sampled grid. fancy: per-component
    triangular-vs-replication choice (upsample_choices). n_img: the blocks
    hold that many images, one after another (or as (n_img, N, 64) rows),
    and the result gains a leading image axis (every step after the IDCT
    works on each sample's own image only, so the pixels are those of n_img
    separate calls). hlim, wlim: the crop (None: the whole padded grid).
    scan: per component None or its MCU geometry (_component_samples).

    The components' uint8 samples (_component_samples: kernel B2 once on a
    card), then the upsample, colour map and crop in one call
    (finish.finish_color: kernel H on a card); on the CPU both run their
    plain twins."""
    n = 1 if n_img is None else n_img
    samples = _component_samples((y_zz, cb_zz, cr_zz), (qy, qcb, qcr),
                                 shapes, k, use_pallas, n, scan)
    planes = [s if n_img is None else s.reshape(n, hb * k, wb * k)
              for s, (hb, wb) in zip(samples, shapes)]
    fh, fv = factors[0]
    hlim = shapes[0][0] * k * fv if hlim is None else hlim
    wlim = shapes[0][1] * k * fh if wlim is None else wlim
    return finish.finish_color(planes, factors, fancy, is_rgb, hlim, wlim)


def _finish_gray(zz, qy, shape, k: int = 8, use_pallas: bool = True,
                 hlim: int | None = None, wlim: int | None = None):
    """One component's uint8 samples (kernel B2 on a card), cropped."""
    return _component_samples((zz,), (qy,), (shape,), k,
                              use_pallas)[0][:hlim, :wlim]


class YCbCrPlanes(typing.NamedTuple):
    """decode(output="ycbcr") result: per-component uint8 sample planes at
    their PADDED block-grid sizes (the full padded planes are required for
    an exact host finish: the triangular upsample's edge samples read the
    block-padding columns that the device RGB path also reads before its
    crop). `finish_ycbcr` reproduces decode(output="rgb") bit-exactly.

    For 4:2:0 the three planes total 1.5 bytes/pixel against 3 for RGB:
    half the device->host transfer."""

    planes: tuple       # per-component 2-D uint8 arrays (np, or tensors)
    height: int         # true output frame height (after scale_denom)
    width: int
    factors: tuple      # per-component (fh, fv) upsample ratios
    fancy: tuple        # per-component triangular-vs-replication choice


def _finish_planes(y_zz, cb_zz, cr_zz, qy, qcb, qcr, shapes, k: int = 8,
                   flat: bool = False, use_pallas: bool = True, scan=None):
    """Device half of the ycbcr output: per-component integer sample planes
    (the exact values _finish_color would feed its upsample/colour tail),
    as uint8. flat=True returns ONE concatenated 1-D buffer instead of a
    tuple, each plane written into its slice: the to-host case fetches it in
    a single copy. scan: as _component_samples."""
    zzs, qtabs = (y_zz, cb_zz, cr_zz), (qy, qcb, qcr)
    if not flat:
        return tuple(_component_samples(zzs, qtabs, shapes, k, use_pallas,
                                        scan=scan))
    sizes = [hb * k * wb * k for hb, wb in shapes]
    buf = torch.empty(sum(sizes), dtype=torch.uint8, device=y_zz.device)
    _component_samples(zzs, qtabs, shapes, k, use_pallas, scan=scan, outs=[
        piece.view(hb * k, wb * k)
        for (hb, wb), piece in zip(shapes, buf.split(sizes))])
    return buf


def _split_flat_planes(buf: np.ndarray, shapes, k: int):
    """Host inverse of _finish_planes(flat=True)."""
    out = []
    off = 0
    for hb, wb in shapes:
        h, w = hb * k, wb * k
        out.append(buf[off:off + h * w].reshape(h, w))
        off += h * w
    return tuple(out)


def _np_triangle_axis(x: np.ndarray, axis: int) -> np.ndarray:
    """NumPy mirror of subsample._triangle_axis (same f32 expression order,
    so results are bit-identical for integer-valued inputs)."""
    x = np.moveaxis(x, axis, 0)
    prev = np.concatenate([x[:1], x[:-1]], axis=0)
    nxt = np.concatenate([x[1:], x[-1:]], axis=0)
    a = (np.float32(3.0) * x + prev) * np.float32(0.25)
    b = (np.float32(3.0) * x + nxt) * np.float32(0.25)
    out = np.stack([a, b], axis=1).reshape(2 * x.shape[0], *x.shape[1:])
    return np.moveaxis(out, 0, axis)


def _np_upsample(x: np.ndarray, fv: int, fh: int, fan: bool) -> np.ndarray:
    if not fan:
        return x.repeat(fv, axis=0).repeat(fh, axis=1)
    f = fh
    while f > 1:
        if f % 2:
            return x.repeat(fv, axis=0).repeat(f, axis=1)
        x = _np_triangle_axis(x, 1)
        f //= 2
    f = fv
    while f > 1:
        if f % 2:
            return x.repeat(f, axis=0)
        x = _np_triangle_axis(x, 0)
        f //= 2
    return x


def _finish_ycbcr_rows(p: YCbCrPlanes, r0: int, r1: int) -> np.ndarray:
    """finish_ycbcr for output rows [r0, r1): each component upsamples a
    halo-padded row slice and crops to the stripe, so the result is
    bit-identical to the full-array computation (the triangular filter has
    1-row support per doubling; the 4-row halo covers factors <= 4, and
    true top/bottom edges keep their replication semantics because the
    slice reaches the array edge there)."""
    planes = []
    for plane, (fh, fv), fan in zip(p.planes, p.factors, p.fancy):
        lo = max(0, r0 // fv - 4)
        hi = min(plane.shape[0], -(-r1 // fv) + 4)
        x = plane[lo:hi].astype(np.float32)
        if fh > 1 or fv > 1:
            x = _np_upsample(x, fv, fh, fan)
        planes.append(x[r0 - lo * fv: r1 - lo * fv])
    w = min(pl.shape[1] for pl in planes)
    # color.ycbcr_to_rgb's chain, term for term: a BLAS product may sum in
    # another order and break equality with the device's bytes.
    terms = [pl[:, :w] - color.YCBCR_OFFSET[c] for c, pl in enumerate(planes)]
    rgb = np.empty((terms[0].shape[0], w, 3), dtype=np.float32)
    for c, row in enumerate(color.YCBCR_TO_RGB):
        acc = terms[0] * row[0]
        acc = acc + terms[1] * row[1]
        rgb[..., c] = acc + terms[2] * row[2]
    return np.clip(np.round(rgb), 0, 255).astype(np.uint8)


def finish_ycbcr(p: YCbCrPlanes, threads: int | None = None) -> np.ndarray:
    """Host finish for decode(output="ycbcr"): upsample + YCbCr->RGB +
    round/clip + crop, bit-identical to decode(output="rgb") on the same
    stream. All host f32 ops mirror the device finish expression for
    expression: integer uint8 samples make the triangle weights exact
    quarter-integers and each colour channel is one f32 multiply-add chain
    in the order of color.ycbcr_to_rgb.

    Runs in row stripes on a thread pool (NumPy releases the GIL).
    threads=1 forces the serial path; stripes are halo-exact, so the thread
    count never changes bytes."""
    # Bring device planes to the host ONCE up front; the stripes slice them.
    p = p._replace(planes=tuple(
        pl.cpu().numpy() if isinstance(pl, torch.Tensor) else np.asarray(pl)
        for pl in p.planes))
    y_rows = max(int(p.planes[0].shape[0]), p.height)
    if threads is None:
        threads = min(8, os.cpu_count() or 1)
    if threads <= 1 or y_rows < 256:
        return _finish_ycbcr_rows(p, 0, p.height)[:, : p.width]
    from concurrent.futures import ThreadPoolExecutor

    step = -(-p.height // threads)
    # Stripe boundaries on even rows: keeps every chroma doubling's
    # a/b sample pairing identical to the full computation.
    step += step % 2
    spans = [(r, min(r + step, p.height))
             for r in range(0, p.height, step)]
    with ThreadPoolExecutor(len(spans)) as pool:
        parts = list(pool.map(
            lambda s: _finish_ycbcr_rows(p, s[0], s[1]), spans))
    return np.concatenate(parts, axis=0)[:, : p.width]


def _finish_cmyk(zzs, qtabs, shapes, factors, fancy, ycck: bool,
                 invert: bool, use_pallas: bool = True):
    """Four-component (Adobe CMYK / YCCK) finish.

    ycck: components 1-3 are YCbCr-coded (APP14 transform=2): run the
    inverse colour matrix, then complement into stored-CMY space (libjpeg
    jdcolor.c ycck_cmyk_convert). invert: an Adobe APP14 marker is present,
    so match PIL's convention of returning the complement of the stored
    samples (JpegImagePlugin rawmode "CMYK;I")."""
    planes = _upsampled_planes(zzs, qtabs, shapes, factors, fancy,
                               use_pallas=use_pallas)
    if ycck:
        rgb = color.ycbcr_to_rgb(torch.stack(planes[:3], dim=-1), clip=True)
        stored = torch.stack(
            [255.0 - rgb[..., 0], 255.0 - rgb[..., 1], 255.0 - rgb[..., 2],
             planes[3]], dim=-1,
        )
    else:
        stored = torch.stack(planes, dim=-1)
    out = 255.0 - stored if invert else stored
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


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


def _progressive_backend(entropy: str) -> str:
    """Map decode()'s entropy selector onto the progressive scan walkers.
    Progressive has host backends only (numpy / native C++); the other
    selectors take the best host one."""
    if entropy == "numpy":
        return "numpy"
    if entropy == "native":
        return "native"
    return "auto"


def _auto_backend(device: torch.device) -> str:
    """What entropy="auto" takes for a baseline single-scan stream on
    `device`: "device" or "host" (the native dense walker, or the NumPy one
    where the table ids do not fit it).

    On the CPU the host walkers: densify, or a twin of a device decoder,
    would only add work to the native dense walk. On a card the device
    Huffman decoders, by measurement (chip_smoke.py phase 8, 3840x2160 q75
    4:2:0, NVIDIA H100 80GB HBM3 at 700 W, the backends in turns in one
    call, medians of 7; three calls on three machines, the second with a
    slower form of the host split that has since been replaced): "device"
    12.750 / 31.076 / 8.205 ms end to end against 42.053 / 47.520 / 34.871
    ms "sparse" and 28.462 / 30.242 / 22.304 ms "indexed" (the native walk
    with the dense upload: 45.4-62.2 ms); per image in decode_stream at depth
    4 13.314 / 22.166 / 11.970 against 20.213 / 24.087 / 14.719 "sparse" and
    11.744 / 19.362 / 9.575 "indexed". On the same image with a restart
    interval of one MCU row (135 segments) 14.501 / 30.787 / 10.718 ms
    against 24.882 / 27.396 / 21.054 "sparse". The host has only the
    unstuffing left (1.1-1.6 ms against a 26.5-30.3 ms sparse walk).

    Since the block starts are found by one chunked program, with or without
    restart markers, the time no longer grows with a segment's length: at
    restart intervals of 240 and 960 MCUs "device" read 9.592 / 11.094 and
    9.228 / 10.022 ms against 22.510 / 24.329 and 22.350 / 23.224 "sparse",
    on flat frames (solid black, 280-row black bars) 7.122 / 7.881 and
    9.382 / 9.198 against 13.705 / 14.572 and 30.813 / 33.312 (chip_smoke.py
    phase 8, in turns, two calls, NVIDIA H100 80GB HBM3 at 700 W). Its
    scratch is O(chunks), and a scan is given no more words than its blocks
    can span (decode_device.MAX_BLOCK_BITS). No stream has been measured on
    which "sparse" wins on a card, so none is sent there."""
    return "host" if device.type == "cpu" else "device"


def _native_ok(mcu_layout: list) -> bool:
    """The native walkers index one joint table set 0/1 per component.
    Only the layout decides: a native runtime that fails to build raises
    where it is first called, it does not send the decode to NumPy."""
    return all(
        dc == ac and dc in (0, 1) for (_, _, dc, ac) in mcu_layout
    )


def _check_tables(htables: dict, mcu_layout: list) -> None:
    for (_comp, _bpm, dc, ac) in mcu_layout:
        for key in ((0, dc), (1, ac)):
            if key not in htables:
                raise jfif.JpegFormatError(
                    f"scan references undefined Huffman table "
                    f"{'AC' if key[0] else 'DC'} {key[1]}"
                )


def _check_qtables(info: jfif.FrameInfo) -> None:
    for c in info.components:
        if c.qtab_id not in info.qtables:
            raise jfif.JpegFormatError(
                f"component {c.comp_id} references undefined quantization "
                f"table {c.qtab_id}"
            )


DEVICE_ENTROPY = ("device", "indexed")


def _decode_scan_device(info: jfif.FrameInfo, n_mcu: int, mcu_layout: list,
                        entropy: str, device: torch.device):
    """Entropy-decode one baseline scan with a device Huffman decoder:
    per-component (N, 64) int32 tensors on `device`, in scan order.
    "device" takes any table ids; "indexed" needs the native runtime's
    layout for its host index pass."""
    _check_tables(info.htables, mcu_layout)
    args = (info.scan_data, n_mcu, mcu_layout, info.htables,
            info.restart_interval, device)
    if entropy == "device":
        return decode_device.decode_scan(*args)
    if not _native_ok(mcu_layout):
        raise jfif.JpegFormatError(
            f"{entropy} entropy backend unavailable for this scan layout"
        )
    return decode_device.decode_scan_indexed(*args)


def _decode_scan_host(info: jfif.FrameInfo, n_mcu: int, mcu_layout: list,
                      entropy: str):
    """Entropy-decode one baseline scan on the host to dense per-component
    (N, 64) int32 zig-zag blocks in scan order: the native C++ walker when
    the layout allows ("auto", "native"), else the NumPy one."""
    _check_tables(info.htables, mcu_layout)
    ok = _native_ok(mcu_layout)
    if entropy == "native" and not ok:
        raise jfif.JpegFormatError(
            f"{entropy} entropy backend unavailable for this scan layout"
        )
    with span("jt.decode.walk"):
        if ok and entropy != "numpy":
            return native.decode_scan(
                info.scan_data, n_mcu, mcu_layout, info.htables,
                info.restart_interval,
            )
        luts = {k: decode_np.make_decode_lut(t)
                for k, t in info.htables.items()}
        return decode_np.decode_scan(
            info.scan_data, n_mcu, mcu_layout, luts, info.restart_interval
        )


def _decode_noninterleaved(info: jfif.FrameInfo, mcu_rows: int, mcu_cols: int,
                           entropy: str = "auto", device=None):
    """Multi-scan baseline: one component per scan, MCU = one block (A.2.2).

    Returns per-component (N, 64) zig-zag blocks in plane raster order, padded
    to the interleaved MCU grid the finish expects: host arrays, or, from the
    device Huffman decoders, tensors on `device` padded there.
    """
    comps = info.components
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    by_id = {c.comp_id: (i, c) for i, c in enumerate(comps)}
    out = [None] * len(comps)

    for scan in info.scans:
        if len(scan.comp_ids) != 1:
            raise jfif.JpegFormatError(
                "partially interleaved scans are not supported"
            )
        cid, dc_id, ac_id = scan.comp_ids[0]
        ci, c = by_id[cid]
        # Component dimensions (T.81 A.1.1) and its own block grid.
        cw = layout.ceil_div(info.width * c.h, hmax)
        ch = layout.ceil_div(info.height * c.v, vmax)
        bw, bh = layout.ceil_div(cw, 8), layout.ceil_div(ch, 8)
        sub_info = jfif.FrameInfo(
            width=info.width, height=info.height, components=comps,
            qtables=info.qtables, htables=scan.htables,
            restart_interval=scan.restart_interval, scan_data=scan.data,
        )
        scan_layout = [(0, 1, dc_id, ac_id)]
        # Pad the raster grid up to the interleaved-MCU geometry.
        gh, gw = mcu_rows * c.v, mcu_cols * c.h
        if entropy in DEVICE_ENTROPY:
            blocks = _decode_scan_device(sub_info, bh * bw, scan_layout,
                                         entropy, device)[0]
            grid = torch.zeros((gh, gw, 64), dtype=blocks.dtype,
                               device=blocks.device)
        else:
            blocks = _decode_scan_host(sub_info, bh * bw, scan_layout,
                                       entropy)[0]
            grid = np.zeros((gh, gw, 64), dtype=blocks.dtype)
        grid[:bh, :bw] = blocks.reshape(bh, bw, 64)
        out[ci] = grid.reshape(gh * gw, 64)

    for ci, arr in enumerate(out):
        if arr is None:
            raise jfif.JpegFormatError(
                f"component {comps[ci].comp_id} has no scan"
            )
    return out


def _scan_blocks(info: jfif.FrameInfo, mcu_rows: int, mcu_cols: int,
                 entropy: str, device: torch.device):
    """Entropy-decode every scan and bring the coefficients to `device`:
    (per-component (N, 64) int32 zig-zag tensors, per-component scan
    geometry). A component's geometry is (mcu_rows, mcu_cols, v, h) where
    its blocks come in the MCU scan order of an interleaved scan (spec
    A.2.3: several blocks to an MCU), and None where they are in plane
    raster order already.

    "indexed" and "device" run the Huffman decode of every baseline scan on
    the device (_decode_scan_device), and "auto" on a card takes "device"
    for a single-scan stream (_auto_backend). "sparse" takes the sparse
    walk: one payload upload, densify on the device. Progressive streams take the host walkers whatever
    `entropy` says. Every other case decodes to dense host grids
    (progressive and multi-scan walkers give them in raster order already),
    which go up as they are. (The reference re-encodes them as the sparse
    payload first; on this card that costs more than the dense upload, see
    PERF.md section 5, so decode_device.sparse_payload_from_blocks has no
    caller here.)"""
    comps = info.components
    n_mcu = mcu_rows * mcu_cols
    scan = [None] * len(comps)  # per component: (rows, cols, v, h) of MCU order
    single_scan = not info.progressive and (len(comps) == 1 or (
        len(info.scans) <= 1 and len(info.scans[0].comp_ids) == len(comps)))
    payload = None
    if info.progressive:
        with span("jt.decode.walk"):
            host = progressive_np.decode_progressive(
                info, backend=_progressive_backend(entropy))
    elif single_scan:
        # A one-component scan is one block per MCU in raster order already.
        if len(comps) == 1:
            mcu_layout = [(0, 1, comps[0].dc_id, comps[0].ac_id)]
        else:
            mcu_layout = [
                (i, c.h * c.v, c.dc_id, c.ac_id) for i, c in enumerate(comps)
            ]
            scan = [(mcu_rows, mcu_cols, c.v, c.h) if c.h * c.v > 1
                    else None for c in comps]
        backend = entropy
        if entropy == "auto":
            backend = _auto_backend(device)
        if backend in DEVICE_ENTROPY:
            host = _decode_scan_device(info, n_mcu, mcu_layout, backend,
                                       device)
        elif backend == "sparse":
            _check_tables(info.htables, mcu_layout)
            if not _native_ok(mcu_layout):
                raise jfif.JpegFormatError(
                    f"{entropy} entropy backend unavailable for this scan "
                    "layout")
            with span("jt.decode.walk"):
                payload = decode_device.sparse_payload(
                    info.scan_data, n_mcu, mcu_layout, info.htables,
                    info.restart_interval)
        else:
            host = _decode_scan_host(info, n_mcu, mcu_layout, entropy)
    else:
        host = _decode_noninterleaved(info, mcu_rows, mcu_cols, entropy,
                                      device)

    if payload is not None:
        words, B, Sp, Ep, Edp = payload
        with span("jt.wait.upload"):
            words = decode_device.payload_tensor(words, device)
        # No entropy leaf: the densify waits on its own small uploads.
        rows = decode_device.densify_body(words, B, Sp, Ep, Edp)
        sizes = [mcu_rows * c.v * mcu_cols * c.h for c in comps] if (
            len(comps) > 1) else [B]
        zz = list(torch.split(rows, sizes))
    elif isinstance(host[0], torch.Tensor):
        zz = list(host)
    else:
        with span("jt.wait.upload"):
            zz = [torch.as_tensor(np.ascontiguousarray(z, dtype=np.int32),
                                  device=device) for z in host]
    return zz, scan


def _raster_blocks(zz, scan):
    """_scan_blocks' blocks in plane raster order (a reshape + permute on
    the device where a component came in MCU scan order)."""
    return [layout.scan_to_raster(z, *geo) if geo is not None else z
            for z, geo in zip(zz, scan)]


def _device_blocks(info: jfif.FrameInfo, mcu_rows: int, mcu_cols: int,
                   entropy: str, device: torch.device):
    """_scan_blocks' per-component (N, 64) int32 zig-zag tensors, in plane
    raster order (the mesh layer's stripes take them so)."""
    return _raster_blocks(*_scan_blocks(info, mcu_rows, mcu_cols, entropy,
                                        device))


def decode(data: bytes, fancy_upsample: bool = True, device="cuda",
           max_pixels: int | None = 2_000_000_000,
           scale_denom: int = 1, output: str = "rgb",
           device_output: bool = False, entropy: str = "auto",
           use_pallas: bool = True):
    """Decode JPEG bytes to (H, W, 3) RGB, (H, W) gray, or, for Adobe
    4-component CMYK/YCCK streams, (H, W, 4) CMYK uint8 samples, running
    everything after the entropy decode on `device` ("cuda" by default;
    "cpu" runs the plain twins).

    fancy_upsample: triangular chroma interpolation (libjpeg-style) instead
    of pixel doubling.
    max_pixels: allocation guard against adversarial headers (a 32-byte file
    can declare a 12.9-gigapixel frame); None disables.
    scale_denom: 1, 2, 4 or 8: DCT-domain scaled decode (libjpeg "draft"
    mode): each block reconstructs at 8/scale_denom points per axis from its
    lowest frequencies; output is ceil(H/scale_denom) x ceil(W/scale_denom).
    The entropy decode is unchanged; the finish and the download shrink by
    scale_denom^2.
    output: "rgb" (default) or "ycbcr": return a YCbCrPlanes of the
    per-component uint8 sample planes instead of finished RGB (3-component
    YCbCr streams only). finish_ycbcr(planes) reproduces the RGB result
    bit-exactly on the host; for 4:2:0 the planes are half the download.
    device_output: return the pixels as a torch.Tensor on `device` (and
    device planes inside YCbCrPlanes) instead of downloading them.
    entropy: Huffman scan decode backend: "auto" (on a card the device
    Huffman decoders for a baseline single-scan stream, see _auto_backend;
    on the CPU the native dense walker; the NumPy walker when the native
    one does not fit),
    "native", "numpy", or "sparse" (host sparse-coefficient walk + device
    densify), "indexed" (host index pass: destuff, and per block its bit
    offset and DC; then kernel D decodes every block's AC coefficients on
    the device; needs table ids that fit the native runtime) or "device"
    (the host only splits at restart markers and unstuffs; the chunked
    block-start program finds the block starts, anchored at every restart
    segment or from bit 0 without markers, and kernel D decodes; any table
    ids). All give the same coefficients.
    Progressive streams have host walkers only: "numpy" and "native" select
    one, every other name takes the best.
    use_pallas: how a full-size plane (scale_denom 1) is dequantized and
    inverse transformed. True (the default here; jpeg_tpu's default is
    False): kernel B2 on a card (kernel B for 4-component streams), its
    plain twin on the CPU. False: jpeg_tpu's default formulation, one
    (64, 64) matmul per plane on a card and the separable block IDCT on the
    CPU, with no IDCT kernel. Their samples after
    the IDCT agree to +-1 where an f32 sum lands on a .5 boundary; the
    colour map can widen that to 3 in an RGB pixel (1.772 per chroma
    level). The scaled decode ignores the switch."""
    if entropy not in ENTROPY_BACKENDS:
        raise ValueError(f"unknown entropy backend {entropy!r}")
    if output not in ("rgb", "ycbcr"):
        raise ValueError(f"unknown output {output!r}")
    if scale_denom not in (1, 2, 4, 8):
        raise ValueError(f"scale_denom must be 1, 2, 4 or 8, got {scale_denom}")
    k = 8 // scale_denom
    device = torch.device(device)
    with span("jt.decode"):
        with span("jt.decode.parse"):
            info = jfif.parse_jpeg(data)
            is_rgb = _check_frame(info, max_pixels, scale_denom, output)
        comps = info.components
        hlim = layout.ceil_div(info.height, scale_denom)
        wlim = layout.ceil_div(info.width, scale_denom)

        def qtabs():
            with span("jt.wait.upload"):
                return [torch.as_tensor(info.qtables[c.qtab_id],
                                        dtype=torch.float32, device=device)
                        for c in comps]

        def deliver(out: torch.Tensor):
            if device_output:
                return out
            with span("jt.wait.download"):
                return out.cpu().numpy()

        if len(comps) == 1:
            # Non-interleaved single-component scan: MCU = one block (spec
            # A.2.2), so scan order is raster order.
            mcu_rows = layout.ceil_div(info.height, 8)
            mcu_cols = layout.ceil_div(info.width, 8)
            zz = _scan_blocks(info, mcu_rows, mcu_cols, entropy, device)[0][0]
            qy, = qtabs()
            with span("jt.decode.finish"):
                out = _finish_gray(zz, qy, (mcu_rows, mcu_cols), k,
                                   use_pallas, hlim, wlim)
            return deliver(out)

        hmax = max(c.h for c in comps)
        vmax = max(c.v for c in comps)
        mcu_rows = layout.ceil_div(info.height, 8 * vmax)
        mcu_cols = layout.ceil_div(info.width, 8 * hmax)
        zz, scan = _scan_blocks(info, mcu_rows, mcu_cols, entropy, device)
        shapes = tuple((mcu_rows * c.v, mcu_cols * c.h) for c in comps)
        factors = tuple((hmax // c.h, vmax // c.v) for c in comps)
        qt = qtabs()
        fancy = upsample_choices(info.width, comps, hmax, fancy_upsample)

        if len(comps) == 4:
            # Adobe CMYK (transform 0/absent) or YCCK (transform 2); returns
            # (H, W, 4) samples matching PIL's CMYK mode (complemented when
            # the Adobe APP14 marker is present: PIL rawmode "CMYK;I").
            with span("jt.decode.finish"):
                out = _finish_cmyk(
                    _raster_blocks(zz, scan), qt, shapes, factors, fancy,
                    info.adobe_transform == 2,
                    info.adobe_transform is not None, use_pallas)[:hlim, :wlim]
            return deliver(out)
        if output == "ycbcr":
            flat = not device_output  # one copy to the host
            with span("jt.decode.finish"):
                planes = _finish_planes(*zz, *qt, shapes, k, flat,
                                        use_pallas, scan)
            if flat:
                with span("jt.wait.download"):
                    planes = planes.cpu().numpy()
                planes = _split_flat_planes(planes, shapes, k)
            return YCbCrPlanes(tuple(planes), hlim, wlim, factors, fancy)
        with span("jt.decode.finish"):
            out = _finish_color(*zz, *qt, shapes, factors, fancy, is_rgb, k,
                                use_pallas=use_pallas, hlim=hlim, wlim=wlim,
                                scan=scan)
        return deliver(out)


def _check_frame(info: jfif.FrameInfo, max_pixels, scale_denom: int,
                 output: str) -> bool:
    """decode()'s checks of a parsed header, before any scan is read.
    Returns whether a 3-component frame stores RGB (no colour transform):
    Adobe APP14 with transform=0, or literal 'R','G','B' component ids
    (libjpeg convention)."""
    if max_pixels is not None and info.width * info.height > max_pixels:
        raise jfif.JpegFormatError(
            f"frame {info.width}x{info.height} exceeds max_pixels={max_pixels}"
        )
    _check_qtables(info)
    comps = info.components
    if output == "ycbcr" and len(comps) != 3:
        raise ValueError(
            f"output='ycbcr' needs a 3-component stream, got {len(comps)}")
    if len(comps) == 1:
        return False
    if len(comps) not in (3, 4):
        raise jfif.JpegFormatError(f"unsupported component count {len(comps)}")
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
    if len(comps) == 4 and scale_denom != 1:
        raise jfif.JpegFormatError(
            "scaled decode of 4-component streams is not supported"
        )
    is_rgb = len(comps) == 3 and (info.adobe_transform == 0 or (
        info.adobe_transform is None
        and tuple(c.comp_id for c in comps) == (0x52, 0x47, 0x42)
    ))
    if output == "ycbcr" and is_rgb:
        raise ValueError(
            "output='ycbcr' requires a YCbCr-coded stream (this one "
            "stores RGB components)")
    return is_rgb


BATCH_MODES = ("auto", "pipelined", "fused")


# What batch_mode="auto" takes, decided by measurement (chip_smoke.py phase 8,
# K = 4 streams of 3840x2160 q75 4:2:0, NVIDIA H100 80GB HBM3 at 700 W, the
# two modes in turns, medians of 7): "fused" 119.1 ms against 170.5 ms
# "pipelined" for the batch. The card is idle most of either; what
# "pipelined" adds is host work in line (four packs, four downloads and a
# host stack of the results), and one stream has nothing to pipeline.
AUTO_BATCH_MODE = "fused"


def decode_batched(datas, fancy_upsample: bool = True,
                   device_output: bool = False, scale_denom: int = 1,
                   batch_mode: str = "auto", device="cuda"):
    """Decode K same-geometry baseline JPEGs as one batch on `device`:
    (K, ceil(H/scale_denom), ceil(W/scale_denom), 3) uint8, bit-identical to
    K calls of decode() (a tensor on `device` with device_output).

    Each stream's entropy layer is resolved on the host by the sparse C++
    walk, threaded across streams; the payloads share one size bucket, and
    the device densifies, reorders and finishes every image.

    batch_mode selects how the device work is composed (identical pixels
    either way):
      "fused": all K payloads go up as one tensor, then one densify, one
        launch of kernel B2 for every component of the K images (reading
        the densified rows in place), and one of kernel H for the batch.
      "pipelined": image by image. Payload i+1 is packed on the host and
        uploaded from a pinned buffer on a side stream while image i
        densifies and finishes.
      "auto": AUTO_BATCH_MODE, the one that measured faster on the card.

    The device work runs on PyTorch's current stream. Only "pipelined"
    uploads on a stream of its own; the current stream waits for each
    upload's event before it reads the payload.

    Requirements: homogeneous 3-component single-scan interleaved
    sequential streams: identical geometry, sampling factors, quant tables,
    per-component Huffman table ids (0/1, DC = AC), component ids and Adobe
    transform. Huffman table contents may differ per stream; they feed only
    the host walk."""
    from concurrent.futures import ThreadPoolExecutor

    if batch_mode not in BATCH_MODES:
        raise ValueError(f"unknown batch_mode {batch_mode!r}")
    if scale_denom not in (1, 2, 4, 8):
        raise ValueError(f"scale_denom must be 1, 2, 4 or 8, got {scale_denom}")
    if not datas:
        raise ValueError("decode_batched needs at least one stream")
    k = 8 // scale_denom
    device = torch.device(device)
    infos = [jfif.parse_jpeg(d) for d in datas]
    for info in infos:
        _check_qtables(info)
    i0 = infos[0]
    comps = i0.components
    if len(comps) != 3:
        raise ValueError("decode_batched needs 3-component streams")
    for info in infos:
        if info.progressive or len(info.scans) != 1 or len(
            info.scans[0].comp_ids
        ) != len(comps):
            raise ValueError(
                "decode_batched needs single-scan interleaved baseline streams"
            )
        if any(c.dc_id != c.ac_id or c.dc_id not in (0, 1)
               for c in info.components):
            raise ValueError("decode_batched needs table ids 0/1 per component")
        for c in info.components:
            if (0, c.dc_id) not in info.htables or (
                1, c.ac_id
            ) not in info.htables:
                raise jfif.JpegFormatError(
                    "scan references undefined Huffman table"
                )
    for info in infos[1:]:
        # Huffman table ids are part of the homogeneity key: mcu_layout is
        # built once from stream 0 and drives every stream's sparse walk.
        # Likewise adobe_transform and the component ids select the colour
        # transform, which is chosen once for the whole batch.
        same = (
            (info.width, info.height) == (i0.width, i0.height)
            and [(c.h, c.v, c.qtab_id, c.dc_id, c.ac_id)
                 for c in info.components]
            == [(c.h, c.v, c.qtab_id, c.dc_id, c.ac_id) for c in comps]
            and info.adobe_transform == i0.adobe_transform
            and [c.comp_id for c in info.components]
            == [c.comp_id for c in comps]
            and all(t in info.qtables
                    and np.array_equal(info.qtables[t], i0.qtables[t])
                    for t in i0.qtables)
        )
        if not same:
            raise ValueError("decode_batched requires homogeneous streams")

    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    mcu_rows = layout.ceil_div(i0.height, 8 * vmax)
    mcu_cols = layout.ceil_div(i0.width, 8 * hmax)
    n_mcu = mcu_rows * mcu_cols
    mcu_layout = [
        (i, c.h * c.v, c.dc_id, c.ac_id) for i, c in enumerate(comps)
    ]
    n_img = len(infos)
    if batch_mode == "auto":
        batch_mode = AUTO_BATCH_MODE

    # Host sparse walks, threaded across streams: the walk is a ctypes call
    # that releases the interpreter lock, and a restart-free stream is
    # serial inside, so stream-level threads are what overlaps them.
    def walk(info):
        return native.sparse_scan(
            info.scan_data, n_mcu, mcu_layout, info.htables,
            info.restart_interval,
        )

    with ThreadPoolExecutor(min(4, n_img)) as pool:
        walks = list(pool.map(walk, infos))
        Sp = decode_device.sparse_bucket(max(w[0].shape[0] for w in walks))
        Ep = decode_device.exception_bucket(max(
            int(np.count_nonzero(np.abs(w[0].astype(np.int32)) > 7))
            for w in walks
        ))
        Edp = decode_device.exception_bucket(max(
            decode_device.dc_diff_exceptions(w[3]) for w in walks
        ))

        def build(w):
            return decode_device.build_payload(*w, Sp, Ep, Edp)

        if batch_mode == "fused":
            payloads = np.stack(list(pool.map(build, walks)))
    B = walks[0][2].shape[0]

    ranges, base = [], 0
    for c in comps:
        ranges.append((base, base + c.h * c.v * n_mcu))
        base = ranges[-1][1]
    shapes = tuple((mcu_rows * c.v, mcu_cols * c.h) for c in comps)
    factors = tuple((hmax // c.h, vmax // c.v) for c in comps)
    fancy = upsample_choices(i0.width, comps, hmax, fancy_upsample)
    qtabs = [torch.as_tensor(i0.qtables[c.qtab_id], dtype=torch.float32,
                             device=device) for c in comps]
    is_rgb = i0.adobe_transform == 0 or (
        i0.adobe_transform is None
        and tuple(c.comp_id for c in comps) == (0x52, 0x47, 0x42)
    )
    hlim = layout.ceil_div(i0.height, scale_denom)
    wlim = layout.ceil_div(i0.width, scale_denom)

    scan = [(mcu_rows, mcu_cols, c.v, c.h) if c.h * c.v > 1 else None
            for c in comps]

    def finish(rows):
        """(n, B, 64) densified rows of n images -> (n, hlim, wlim, 3): each
        component's (n, blocks, 64) slice of the rows, in scan order."""
        return _finish_color(*(rows[:, lo:hi] for lo, hi in ranges), *qtabs,
                             shapes, factors, fancy, is_rgb, k,
                             n_img=rows.shape[0], hlim=hlim, wlim=wlim,
                             scan=scan)

    if batch_mode == "fused":
        out = finish(decode_device.densify_body(
            decode_device.payload_tensor(payloads, device), B, Sp, Ep, Edp))
        return out if device_output else out.cpu().numpy()

    # Pipelined. Kernel launches return before the device has run them, so
    # after image i's work is enqueued this thread packs payload i+1 while
    # the device is busy; the side stream lets that upload pass the work
    # queued on the current one. Two pinned buffers take turns.
    on_card = device.type == "cuda"
    if on_card:
        side = torch.cuda.Stream(device)
        pinned = [None, None]
        sent = [None, None]

    def upload(i):
        words = build(walks[i])
        if not on_card:
            return decode_device.payload_tensor(words, device)
        slot = i % 2
        if pinned[slot] is None:
            pinned[slot] = torch.empty(words.shape[0], dtype=torch.int32,
                                       pin_memory=True)
        else:
            sent[slot].synchronize()  # upload i - 2 has left the buffer
        pinned[slot].numpy()[:] = words.view(np.int32)
        with torch.cuda.stream(side):
            dev = pinned[slot].to(device, non_blocking=True)
            sent[slot] = torch.cuda.Event()
            sent[slot].record()
        current = torch.cuda.current_stream(device)
        current.wait_event(sent[slot])
        dev.record_stream(current)  # allocated on `side`, read on `current`
        return dev

    outs = []
    nxt = upload(0)
    for i in range(n_img):
        payload = nxt
        outs.append(finish(
            decode_device.densify_body(payload, B, Sp, Ep, Edp)[None])[0])
        if i + 1 < n_img:
            nxt = upload(i + 1)
    if device_output:
        return torch.stack(outs)
    # Per-image downloads drain in order while later images still run.
    return np.stack([o.cpu().numpy() for o in outs])
