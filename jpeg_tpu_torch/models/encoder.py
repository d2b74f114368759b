"""The encoder pipeline: RGB or gray array, or BMP -> baseline JFIF JPEG
bytes.

Device pack (the default):
  device: edge pad -> exact integer transform (ops/mcu_conv) -> DC DPCM ->
  [symbol histograms -> optimal tables, for optimize_tables] -> packer
  level 1 (kernel A, ops/pack) -> the scan pass (ops/pack.pack_scan:
  level-2 placement per restart segment, trim, 1-pad, 0xFF stuffing,
  RSTn); host: the scan's bytes -> JFIF.
Host pack (device_pack=False, use_pallas=True, or a restart interval that
does not divide the MCU count):
  device: edge pad -> exact integer transform, or colour + downsample +
  fused DCT/quantize (kernel C, ops/fused) for use_pallas -> coefficient
  download; host: raster -> scan order, DC DPCM, MCU interleave, native
  packer (native symbol counts -> optimal tables first, for optimize_tables)
  -> JFIF.

The device pack is jpeg_tpu/models/encoder.py's with the Pallas level-1
packer (`use_pallas_pack=True`); both paths emit the same bytes as the JAX
package's exact transform chains. A block over the packer's 288-bit budget
(or a segment over its word capacity) spills the whole scan to the native
host packer, counted in HOST_PACK_SPILLS.

Every device-pack entry point is built from the same pieces: encode() and
parallel.pipeline.encode_stream from _enqueue (everything up to the first
readback) and _finish (the rest); encode_batched and
parallel.mosaic.encode_mosaic_stream from _level1_segments and
pack.pack_scan. All of them end in _scan_or_spill, the one place where a
scan is downloaded or spilled.
"""

from __future__ import annotations

import collections
import threading
from typing import NamedTuple

import numpy as np
import torch

from jpeg_tpu_torch.config import EncodeConfig, Subsampling
from jpeg_tpu_torch.entropy import huffman, native
from jpeg_tpu_torch.io import bmp, jfif
from jpeg_tpu_torch.models import layout
from jpeg_tpu_torch.ops import (
    _cuda, bitpack, color, dpcm as dpcm_ops, fused, mcu_conv, pack, quant,
    subsample, symbols, tile, zigzag,
)
from jpeg_tpu_torch.utils.trace import span

# Device word-buffer capacity per segment: 8 words (256 bits) per block on
# average, plus 2. Typical q75 blocks need ~30-100 bits.
WORDS_PER_BLOCK = 8

# Scans host-packed because level 2 reported ok=False (the designed spill).
# Counted under a lock: encode_stream's callers may encode from threads.
HOST_PACK_SPILLS = 0
_COUNT_LOCK = threading.Lock()

_STANDARD_TABLES = huffman.standard_tables()


def _interleaved_blocks(rgb, qy, qc, mode: Subsampling, restart_mcus: int):
    """Pixels -> (n_mcu * bpm, 64) MCU-interleaved blocks with DC DPCM'd
    (restart resets every restart_mcus MCUs) plus the (B,) table-id array
    (0 luma / 1 chroma). The transform already emits MCU scan order."""
    hv = mode.h_factor * mode.v_factor
    tbl_row = mcu_conv.constant(np.array([0] * hv + [1, 1], np.int32),
                                rgb.device)
    blocks = mcu_conv._mcu_transform_int(rgb, qy, qc, mode)  # (n_mcu, bpm, 64)
    n_mcu = blocks.shape[0]
    r = int(restart_mcus)
    with span("jt.encode.transform"):
        blocks[:, :hv, 0] = dpcm_ops.dpcm(
            blocks[:, :hv, 0].reshape(-1), r * hv).reshape(n_mcu, hv)
        blocks[:, hv, 0] = dpcm_ops.dpcm(blocks[:, hv, 0], r)
        blocks[:, hv + 1, 0] = dpcm_ops.dpcm(blocks[:, hv + 1, 0], r)
    return blocks.reshape(-1, 64), tbl_row.repeat(n_mcu), n_mcu, hv


def _level1_segments(blocks, tbl, luts, n_units: int, restart_units: int):
    """Kernel A (level 1) over (B, 64) DPCM'd blocks, cut into restart
    segments -> (buf (nseg, seg_blocks, BLOCK_WORDS+1), bit totals (nseg,
    seg_blocks), nwords). Segments are restart_units of the n_units MCUs
    each; an interval of 0, or of at least n_units, is one segment. A last
    segment that is shorter is filled out with blocks of zero bits, which
    level 2 places nowhere."""
    r = int(restart_units)
    buf, t_b = pack.pack_level1(blocks, tbl, *luts[:4], packed=luts[4])
    seg_units = n_units if r == 0 or r >= n_units else r
    nseg = -(-n_units // seg_units)
    seg_blocks = blocks.shape[0] // n_units * seg_units
    fill = nseg * seg_blocks - blocks.shape[0]
    if fill:
        buf = torch.cat([buf, buf.new_zeros((fill, buf.shape[1]))])
        t_b = torch.cat([t_b, t_b.new_zeros(fill)])
    nwords = seg_blocks * WORDS_PER_BLOCK + 2
    return (buf.reshape(nseg, seg_blocks, -1), t_b.reshape(nseg, seg_blocks),
            nwords)


def _optimal_tables(hists) -> dict:
    """[dc_luma, ac_luma(, dc_chroma, ac_chroma)] symbol histograms ->
    {(is_ac, id): optimal HuffTable}."""
    keys = ((0, 0), (1, 0), (0, 1), (1, 1))
    return {k: huffman.optimal_table(h.cpu().numpy())
            for k, h in zip(keys, hists)}


def _color_hists(blocks, n_mcu: int, hv: int):
    """Device symbol histograms of the interleaved DPCM'd blocks:
    [dc_luma, ac_luma, dc_chroma, ac_chroma] (jpeg_tpu's
    _transform_color_hists)."""
    per_mcu = blocks.reshape(n_mcu, hv + 2, 64)
    dc_l, ac_l = symbols.symbol_histogram(per_mcu[:, :hv].reshape(-1, 64))
    dc_c1, ac_c1 = symbols.symbol_histogram(per_mcu[:, hv])
    dc_c2, ac_c2 = symbols.symbol_histogram(per_mcu[:, hv + 1])
    return dc_l, ac_l, dc_c1 + dc_c2, ac_c1 + ac_c2


# Table sets whose device LUTs are kept (least recently used goes first):
# the standard set hits on every encode; each optimize_tables encode adds
# its own.
_LUT_CACHE_SIZE = 8
_lut_cache: collections.OrderedDict = collections.OrderedDict()
_lut_lock = threading.Lock()


def _device_luts(htables: dict, device) -> tuple:
    """{(is_ac, id): HuffTable} -> (dc_code, dc_len, ac_code, ac_len, packed)
    int32 tensors on `device`: the four (2, 256) LUTs and pack.pack_tables'
    (2, 2, 256) words for kernel A, built and uploaded once per table set
    and device. A cached set may be evicted while a stream other than the
    one that filled it still reads it, so a hit records the caller's current
    stream on its tensors: their memory is not reused before that stream
    has passed."""
    device = torch.device(device)
    key = (str(device),) + tuple(
        (k, t.code.tobytes(), t.size.tobytes())
        for k, t in sorted(htables.items()))
    with _lut_lock:
        luts = _lut_cache.get(key)
        if luts is not None:
            _lut_cache.move_to_end(key)
    if luts is not None:
        if device.type == "cuda":
            current = torch.cuda.current_stream(device)
            for t in luts:
                t.record_stream(current)
        return luts
    luts = tuple(torch.as_tensor(a.astype(np.int32), device=device)
                 for a in bitpack.luts_from_tables(htables))
    luts += (_cuda.settled(pack.pack_tables(*luts)),)
    with _lut_lock:
        _lut_cache[key] = luts
        if len(_lut_cache) > _LUT_CACHE_SIZE:
            _lut_cache.popitem(last=False)
    return luts


def _pallas_planes(rgb, mode: Subsampling):
    """uint8 (H, W, 3) tensor, MCU-aligned -> the (y, cb, cr) f32 planes
    that the use_pallas path hands fused_dct_quantize: colour, the -128
    shift, chroma downsample, then +128 back, since the fused transform
    shifts by -128 itself (jpeg_tpu's order)."""
    y, cb, cr = color.rgb_to_ycbcr_planes(rgb)
    cb = subsample.downsample_plane(cb - 128.0, mode)
    cr = subsample.downsample_plane(cr - 128.0, mode)
    return (y - 128.0) + 128.0, cb + 128.0, cr + 128.0


def _transform_color(rgb, qy, qc, mode: Subsampling, use_pallas: bool = False):
    """uint8 (H, W, 3) tensor, MCU-aligned -> (y_zz, cb_zz, cr_zz) int32
    (B, 64) zig-zag blocks in raster block order per component.

    The default path is the exact integer transform (ops/mcu_conv), whose
    luma comes out in MCU scan order and is reordered to raster here.
    use_pallas routes the level shift + DCT + quantize through
    fused_dct_quantize (kernel C on the card) instead; its coefficients may
    differ from the exact path by 1 at .5 boundaries. The f32 arithmetic
    follows jpeg_tpu's order, (y - 128) + 128 included: that round trip is
    not the identity in f32."""
    if use_pallas:
        y, cb, cr = _pallas_planes(rgb, mode)

        def plane_to_zz(plane, qtab):
            qp = fused.fused_dct_quantize(plane, qtab)
            return zigzag.to_zigzag(tile.blockify(qp)).reshape(-1, 64)

        return plane_to_zz(y, qy), plane_to_zz(cb, qc), plane_to_zz(cr, qc)

    hf, vf = mode.h_factor, mode.v_factor
    hv = hf * vf
    rows = rgb.shape[0] // mode.mcu_height
    cols = rgb.shape[1] // mode.mcu_width
    blocks = mcu_conv._mcu_transform_int(rgb, qy, qc, mode)
    # Luma: MCU scan order -> plane raster order (one permute).
    y_zz = blocks[:, :hv].reshape(rows, cols, vf, hf, 64).permute(
        0, 2, 1, 3, 4).reshape(-1, 64)
    return y_zz, blocks[:, hv], blocks[:, hv + 1]


def _dpcm_host(dc: np.ndarray, reset_every: int) -> np.ndarray:
    prev = np.concatenate([[0], dc[:-1]])
    if reset_every:
        prev[np.arange(len(dc)) % reset_every == 0] = 0
    return dc - prev


def interleave_mcus(y_scan, cb_scan, cr_scan, hv: int):
    """Merge per-component scan-order blocks into one interleaved (B, 64)
    int32 array plus the per-block table-id array (0 luma / 1 chroma).
    int32 is the native packer's ABI, so it reads the array without a copy."""
    n_mcu = cb_scan.shape[0]
    bpm = hv + 2
    blocks = np.empty((n_mcu, bpm, 64), dtype=np.int32)
    blocks[:, :hv] = y_scan.reshape(n_mcu, hv, 64)
    blocks[:, hv] = cb_scan
    blocks[:, hv + 1] = cr_scan
    tbl = np.zeros((n_mcu, bpm), dtype=np.uint8)
    tbl[:, hv:] = 1
    return blocks.reshape(-1, 64), tbl.reshape(-1)


def _pack_scan(blocks, tbl, cfg: EncodeConfig, bpm: int):
    """Entropy-pack one scan on the host with the native packer, with the
    standard tables or, for optimize_tables, the optimal tables of the
    native symbol counts -> (scan bytes, tables)."""
    if cfg.optimize_tables:
        freqs = native.count_frequencies(blocks, tbl)
        htables = {k: huffman.optimal_table(v) for k, v in freqs.items()}
    else:
        htables = huffman.standard_tables()
    scan = native.encode_scan(
        blocks, tbl, htables,
        restart_interval=cfg.restart_interval, blocks_per_mcu=bpm,
    )
    return scan, htables


def _normalize_image(image) -> np.ndarray:
    """Floats are rounded then clipped; other dtypes clip to uint8."""
    image = np.asarray(image)
    if np.issubdtype(image.dtype, np.floating):
        return np.clip(np.round(image), 0, 255).astype(np.uint8)
    if image.dtype != np.uint8:
        return np.clip(image, 0, 255).astype(np.uint8)
    return image


def _color_components(mode: Subsampling):
    """The 3-component SOF spec every color writer shares."""
    return [
        jfif.ComponentSpec(1, mode.h_factor, mode.v_factor, 0, 0, 0),
        jfif.ComponentSpec(2, 1, 1, 1, 1, 1),
        jfif.ComponentSpec(3, 1, 1, 1, 1, 1),
    ]


def _quant_tables(cfg: EncodeConfig, quant_tables):
    """(luma, chroma) (8, 8) quant tables: the caller's, clipped to 1-255,
    or the quality's."""
    if quant_tables is None:
        return quant.luma_table(cfg.quality), quant.chroma_table(cfg.quality)
    return tuple(np.clip(np.asarray(t, np.int32).reshape(8, 8), 1, 255)
                 for t in quant_tables[:2])


def _host_pack_color(y_zz, cb_scan, cr_scan, mcu_rows: int, mcu_cols: int,
                     cfg: EncodeConfig):
    """Host half of the colour encode: the three int32 (B, 64) zig-zag
    coefficient arrays of _transform_color, downloaded (the caller's own:
    they are modified in place) -> (scan bytes, tables). Raster -> scan
    order, DC DPCM, MCU interleave, native packer."""
    mode = cfg.subsampling
    r = cfg.restart_interval
    hv = mode.h_factor * mode.v_factor
    y_scan = y_zz[layout.mcu_scan_permutation(
        mcu_rows, mcu_cols, mode.v_factor, mode.h_factor)]
    # Chroma sampling is (1, 1): raster order is scan order.
    y_scan[:, 0] = _dpcm_host(y_scan[:, 0], r * hv)
    cb_scan[:, 0] = _dpcm_host(cb_scan[:, 0], r)
    cr_scan[:, 0] = _dpcm_host(cr_scan[:, 0], r)
    blocks, tbl = interleave_mcus(y_scan, cb_scan, cr_scan, hv)
    return _pack_scan(blocks, tbl, cfg, hv + 2)


def _host_pack_gray(zz, cfg: EncodeConfig):
    """Host half of the gray encode: the downloaded (B, 64) zig-zag blocks
    (modified in place) -> (scan bytes, tables). DC DPCM, native packer."""
    zz[:, 0] = _dpcm_host(zz[:, 0], cfg.restart_interval)
    return _pack_scan(zz, np.zeros(zz.shape[0], dtype=np.uint8), cfg, 1)


def _header(shape, cfg: EncodeConfig, qy, qc) -> tuple:
    """The frame of an (H, W) gray or (H, W, 3) colour image: (width,
    height, components, quant tables), as write_jpeg takes them."""
    h, w = shape[:2]
    if len(shape) == 2:
        return w, h, [jfif.ComponentSpec(1, 1, 1, 0, 0, 0)], {0: qy}
    return w, h, _color_components(cfg.subsampling), {0: qy, 1: qc}


def _jfif(header, htables, scan, restart_interval: int, comment=None):
    """One image's JFIF bytes; a gray frame carries its luma tables only."""
    if len(header[2]) == 1:
        htables = {k: t for k, t in htables.items() if k[1] == 0}
    return jfif.write_jpeg(*header, htables, scan,
                           restart_interval=restart_interval, comment=comment)


def _scan_or_spill(scan, status: np.ndarray, blocks, tbl, htables,
                   restart_interval: int, bpm: int, write, fetch=None,
                   rst_base: int = 0):
    """write(the scan's bytes) of one image or stripe whose scan pass has
    run. `status` is the pass's status on the host; `scan`, `blocks` and
    `tbl` are still on the device. The scan's first count bytes come down
    (fetch(scan, count), a numpy array; by default a plain copy). When a
    segment was not ok, the native host packer packs the same DPCM'd blocks
    instead, RSTn numbered from rst_base: the device pack's one spill rule,
    counted in HOST_PACK_SPILLS."""
    global HOST_PACK_SPILLS
    nseg = status.shape[0] // 2
    if not status[nseg:2 * nseg].all():
        with span("jt.encode.spill"):
            with _COUNT_LOCK:
                HOST_PACK_SPILLS += 1
            return write(native.encode_scan(
                blocks.cpu().numpy(), tbl.cpu().numpy(), htables,
                restart_interval=restart_interval, blocks_per_mcu=bpm,
                rst_base=rst_base))
    count = int(status[-1])
    with span("jt.wait.download"):
        host = (fetch(scan, count) if fetch is not None
                else scan[:count].cpu().numpy())
    with span("jt.encode.finalize"):
        return write(host)


class _Enqueued(NamedTuple):
    """One image's device pack as _enqueue leaves it: its frame (_header),
    its DPCM'd MCU-interleaved (B, 64) blocks and (B,) table ids on the
    device, its MCUs, blocks per MCU and restart interval, the scan pass's
    output (None under optimize_tables: the pass waits for the tables) and
    what the host reads next: the pass's status, or the stacked symbol
    histograms."""
    header: tuple
    blocks: torch.Tensor
    tbl: torch.Tensor
    n_units: int
    bpm: int
    restart_interval: int
    scan: torch.Tensor | None
    readback: torch.Tensor


def _enqueue(img, cfg: EncodeConfig, qy, qc) -> _Enqueued:
    """Enqueue one image's device pack on the current stream, up to what
    the host must read back: an (H, W) gray or (H, W, 3) colour uint8
    tensor on its device -> edge pad, exact integer transform, DC DPCM,
    then kernel A and the scan pass with the standard tables, or, for
    optimize_tables, the symbol histograms. Nothing here waits for the
    device."""
    r = cfg.restart_interval
    header = _header(tuple(img.shape), cfg, qy, qc)
    if img.ndim == 2:
        with span("jt.encode.transform"):
            img = tile.pad_to_multiple(img, 8, 8)
        blocks = mcu_conv.gray_transform_int(img, qy)  # raster == scan order
        with span("jt.encode.transform"):
            blocks[:, 0] = dpcm_ops.dpcm(blocks[:, 0], r)
        tbl = torch.zeros(blocks.shape[0], dtype=torch.int32,
                          device=blocks.device)
        n_units, bpm = blocks.shape[0], 1
    else:
        mode = cfg.subsampling
        with span("jt.encode.transform"):
            img = tile.pad_to_multiple(img, mode.mcu_height, mode.mcu_width)
        blocks, tbl, n_units, hv = _interleaved_blocks(img, qy, qc, mode, r)
        bpm = hv + 2
    with span("jt.encode.pack"):
        if cfg.optimize_tables:
            hists = (symbols.symbol_histogram(blocks) if bpm == 1
                     else _color_hists(blocks, n_units, bpm - 2))
            scan, readback = None, torch.stack(hists)
        else:
            scan, readback = pack.pack_scan(*_level1_segments(
                blocks, tbl, _device_luts(_STANDARD_TABLES, blocks.device),
                n_units, r))
    return _Enqueued(header, blocks, tbl, n_units, bpm, r, scan, readback)


def _finish(rec: _Enqueued, host: torch.Tensor, comment=None,
            fetch=None) -> bytes:
    """The JFIF bytes of an _enqueue'd image, once `host` holds its
    readback on the host. Under optimize_tables: the image's optimal tables
    from its histograms, the scan pass with them on the current stream,
    and the pass's status read back. Then _scan_or_spill, with `fetch` as
    its download."""
    tables, scan = _STANDARD_TABLES, rec.scan
    if scan is None:
        tables = _optimal_tables(host)
        with span("jt.encode.pack"):
            scan, status = pack.pack_scan(*_level1_segments(
                rec.blocks, rec.tbl, _device_luts(tables, rec.blocks.device),
                rec.n_units, rec.restart_interval))
        with span("jt.wait.status"):
            host = status.cpu()
    return _scan_or_spill(
        scan, host.numpy(), rec.blocks, rec.tbl, tables, rec.restart_interval,
        rec.bpm, lambda s: _jfif(rec.header, tables, s, rec.restart_interval,
                                 comment), fetch)


def encode(
    image,
    quality: int = 75,
    subsampling="420",
    restart_interval: int | None = None,
    optimize_tables: bool = False,
    comment: str | None = None,
    device_pack: bool | None = None,
    quant_tables=None,
    use_pallas: bool = False,
    use_pallas_pack: bool = False,
    device="cuda",
) -> bytes:
    """Encode an (H, W, 3) RGB or (H, W) grayscale uint8 array (or a .bmp
    path / BMP bytes) to baseline JFIF JPEG bytes, running the transform and
    the bit packer on `device` ("cuda" by default; "cpu" runs the plain
    twins).

    device_pack: pack the scan on the device (kernel A + the scan pass);
    None means True. False, or a restart interval that does not divide the
    MCU count, downloads the coefficients and packs on the host (native
    C++). Both emit the same bytes.
    use_pallas: run level shift + DCT + quantize through fused_dct_quantize
    (kernel C) instead of the exact integer transform; forces the host pack.
    Colour only, as in jpeg_tpu.
    use_pallas_pack: accepted for parity with jpeg_tpu.encode; the port has
    one device packer (kernel A), whose bytes equal both of jpeg_tpu's."""
    del use_pallas_pack
    cfg = EncodeConfig(
        quality=quality,
        subsampling=subsampling,
        restart_interval=0 if restart_interval is None else restart_interval,
        optimize_tables=optimize_tables,
    )
    if isinstance(image, (str, bytes)):
        image = bmp.read_bmp(image) if isinstance(image, str) else bmp.decode_bmp(image)
    image = _normalize_image(image)
    gray = image.ndim == 2
    if not gray and (image.ndim != 3 or image.shape[2] != 3):
        raise ValueError(
            f"expected (H, W, 3) or (H, W) image, got {image.shape}")
    qy, qc = _quant_tables(cfg, quant_tables)
    mode = cfg.subsampling
    mcu_h, mcu_w = (8, 8) if gray else (mode.mcu_height, mode.mcu_width)
    n_mcu = (layout.ceil_div(image.shape[0], mcu_h)
             * layout.ceil_div(image.shape[1], mcu_w))
    r = cfg.restart_interval
    # The fused DCT path (colour only) feeds the host packer.
    on_device = ((device_pack is None or device_pack)
                 and (gray or not use_pallas)
                 and not (r and r < n_mcu and n_mcu % r))
    with span("jt.encode.dispatch"):
        with span("jt.wait.upload"):
            img = torch.as_tensor(np.ascontiguousarray(image),
                                  device=torch.device(device))
        if on_device:
            rec = _enqueue(img, cfg, qy, qc)
        else:
            with span("jt.encode.transform"):
                img = tile.pad_to_multiple(img, mcu_h, mcu_w)
            # The exact transform's spans are its own; use_pallas's kernel C
            # wrappers upload their tables blocking, in the parent's glue.
            planes = ([mcu_conv.gray_transform_int(img, qy)] if gray
                      else _transform_color(img, qy, qc, mode, use_pallas))
    with span("jt.encode.finish"):
        if on_device:
            with span("jt.wait.status"):
                host = rec.readback.cpu()
            return _finish(rec, host, comment)
        with span("jt.wait.download"):
            planes = [a.cpu().numpy() for a in planes]
        with span("jt.encode.finalize"):
            scan, htables = (_host_pack_gray(*planes, cfg) if gray else
                             _host_pack_color(*planes, img.shape[0] // mcu_h,
                                              img.shape[1] // mcu_w, cfg))
            return _jfif(_header(image.shape, cfg, qy, qc), htables, scan, r,
                         comment)


def encode_batched(
    images,
    quality: int = 75,
    subsampling="420",
    restart_interval: int = 0,
    comment: str | None = None,
    quant_tables=None,
    device_pack: bool | None = None,
    device="cuda",
) -> list[bytes]:
    """Encode K same-shape RGB images, (K, H, W, 3), as one batch on
    `device`: one upload, one edge pad, one exact transform (one matmul over
    the K * n_mcu MCU rows), DC DPCM that restarts at every image, ONE launch
    of kernel A over all K * B blocks, then the scan pass once per image
    over its segments (RSTn from 0), one download of the K statuses and
    encode()'s scan-or-spill per image. Returns one JFIF stream per image,
    byte-identical to K calls of encode().

    All device work runs on PyTorch's current stream.

    device_pack=False, or a restart interval that does not divide the MCU
    count, encodes image by image: those are encode()'s host-pack cases and
    have no batched form. An image whose pack overflows (a block over 288
    bits) alone takes the host packer, counted in HOST_PACK_SPILLS; the
    others keep their device pack."""
    imgs = np.asarray(images)
    if imgs.ndim != 4 or imgs.shape[-1] != 3:
        raise ValueError(f"expected (K, H, W, 3) uint8, got {imgs.shape}")
    if imgs.shape[0] == 0:
        return []
    imgs = _normalize_image(imgs)
    r = int(restart_interval)
    cfg = EncodeConfig(quality=quality, subsampling=subsampling,
                       restart_interval=r)
    mode = cfg.subsampling
    device = torch.device(device)
    if device_pack is None:
        device_pack = True
    n_img, h0, w0 = imgs.shape[:3]
    n_mcu = (layout.ceil_div(h0, mode.mcu_height)
             * layout.ceil_div(w0, mode.mcu_width))
    if not device_pack or (r and r < n_mcu and n_mcu % r):
        return [encode(im, quality=quality, subsampling=mode,
                       restart_interval=restart_interval, comment=comment,
                       device_pack=device_pack, quant_tables=quant_tables,
                       device=device)
                for im in imgs]
    qy_np, qc_np = _quant_tables(cfg, quant_tables)
    batch = tile.pad_batch_to_multiple(
        torch.as_tensor(np.ascontiguousarray(imgs), device=device),
        mode.mcu_height, mode.mcu_width)
    # A segment ends at every image boundary, so the prediction restarts
    # there; with aligned restarts the segments are the images' own.
    seg_mcus = r if 0 < r < n_mcu else n_mcu
    blocks, tbl, _, hv = _interleaved_blocks(batch, qy_np, qc_np, mode,
                                             seg_mcus)
    htables = _STANDARD_TABLES
    buf, t_b, nwords = _level1_segments(
        blocks, tbl, _device_luts(htables, device), n_img * n_mcu, seg_mcus)
    nseg = n_mcu // seg_mcus
    passes = [pack.pack_scan(buf[k * nseg:(k + 1) * nseg],
                             t_b[k * nseg:(k + 1) * nseg], nwords)
              for k in range(n_img)]
    status = torch.stack([s for _, s in passes]).cpu().numpy()
    header = _header(imgs.shape[1:], cfg, qy_np, qc_np)
    bpm = hv + 2
    per_img = n_mcu * bpm
    return [_scan_or_spill(
        scan, status[k], blocks[k * per_img:(k + 1) * per_img],
        tbl[k * per_img:(k + 1) * per_img], htables, r, bpm,
        lambda s: _jfif(header, htables, s, r, comment))
        for k, (scan, _) in enumerate(passes)]


def encode_bmp_to_jpeg(input_path: str, output_path: str, quality: int = 75,
                       subsampling="444", **kw) -> None:
    """Read a BMP file, encode it, write the JPEG file."""
    data = encode(bmp.read_bmp(input_path), quality=quality,
                  subsampling=subsampling, **kw)
    with open(output_path, "wb") as f:
        f.write(data)


def encode_rgb_to_jpeg(rgb, output_path: str, quality: int = 75,
                       subsampling="444", **kw) -> None:
    """Encode a raw (H, W, 3) RGB array and write the JPEG file."""
    data = encode(np.asarray(rgb), quality=quality, subsampling=subsampling, **kw)
    with open(output_path, "wb") as f:
        f.write(data)
