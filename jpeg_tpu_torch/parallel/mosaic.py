"""Single-JFIF mosaic encode: one large image, sharded as horizontal MCU
stripes over the mesh's ``mcu`` axis, out as ONE spec-compliant JFIF stream
(counterpart of jpeg_tpu/parallel/mosaic.py).

Each stripe computes its blocks on its own position, resets its DC
predictors at its restart marker (the stripes are restart segments) and is
entropy-packed on its own; because restart segments are byte-aligned, the
"bitstream offset exchange" reduces to concatenating [stripe bytes + RSTn]
in stripe order. encode_mosaic_stream does the same for an image that never
exists whole, stripe by stripe from a source callable, in memory bounded by
one stripe.
"""

from __future__ import annotations

import numpy as np
import torch

from jpeg_tpu_torch.config import EncodeConfig
from jpeg_tpu_torch.entropy import huffman
from jpeg_tpu_torch.io import jfif
from jpeg_tpu_torch.models import encoder as E
from jpeg_tpu_torch.ops import pack, quant, tile
from jpeg_tpu_torch.parallel.batch import encode_batch
from jpeg_tpu_torch.parallel.mesh import make_mesh


def encode_mosaic(
    image,
    quality: int = 75,
    subsampling="420",
    mesh=None,
    optimize_tables: bool = False,
    device_pack: bool = False,
) -> bytes:
    """Encode one large image into a single JFIF stream, stripe-sharded over
    the mesh's ``mcu`` axis (mesh: None takes every CUDA device as stripes;
    a (1, n) mesh of make_multihost_mesh spreads them over the ranks, and
    every rank gets the stream). `image`: (H, W, 3) uint8, any size. The
    restart interval is one stripe's MCUs, which the DRI field caps at
    65,535: use enough stripes."""
    image = np.asarray(image)
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3), got {image.shape}")
    if mesh is None:
        mesh = make_mesh(batch_axis=1)
    return encode_batch(
        image[None],
        quality=quality,
        subsampling=subsampling,
        mesh=mesh,
        stripe_restart=True,
        optimize_tables=optimize_tables,
        device_pack=device_pack,
    )[0]


def encode_mosaic_stream(
    source,
    height: int,
    width: int,
    quality: int = 75,
    subsampling="420",
    stripe_rows: int | None = None,
    rst_rows: int = 1,
    optimize_tables: bool = False,
    comment: str | None = None,
    out=None,
    device="cuda",
):
    """Memory-bounded mosaic encode: one spec-compliant JFIF out, the device
    and host memory bounded by a single stripe, the image never
    materialized.

    source: callable (row0, row1) -> uint8 (row1-row0, width, 3) pixel rows.
    Called once per stripe in top-to-bottom order (twice per stripe when
    optimize_tables=True: pass 1 sums the stripes' device symbol histograms,
    pass 2 packs with the optimal tables).
    stripe_rows: rows per stripe (rounded to MCU-height multiples); default
    targets ~32 MB of pixels per stripe.
    rst_rows: MCU rows per restart segment: the scan's DRI is
    rst_rows * mcu_cols, so stripes splice at byte-aligned RSTn boundaries
    and DC predictors never cross a stripe.
    out: file-like for streamed writes; when None the bytes are returned.
    device: where each stripe's transform and pack run ("cuda" by default).

    Each stripe is whole restart groups (the last one may end in a shorter
    group), so it is packed on the device (kernel A + the scan pass, its
    RSTn numbered from the stripe's first segment); a stripe whose pack
    overflows the per-block budget takes the native host packer instead
    (encoder's one spill rule, counted in encoder.HOST_PACK_SPILLS).
    The stream is byte-identical to encode(image, quality, subsampling,
    restart_interval=rst_rows*mcu_cols, optimize_tables=...) on the whole
    image."""
    cfg = EncodeConfig(quality=quality, subsampling=subsampling)
    mode = cfg.subsampling
    mcu_h, mcu_w = mode.mcu_height, mode.mcu_width
    hv = mode.h_factor * mode.v_factor
    bpm = hv + 2
    if height <= 0 or width <= 0:
        raise ValueError(f"bad mosaic dims {height}x{width}")
    mcu_rows_total = -(-height // mcu_h)
    mcu_cols = -(-width // mcu_w)
    r = rst_rows * mcu_cols  # DRI in MCUs
    if r > 65535:
        raise ValueError(
            f"restart interval {r} exceeds the DRI field (reduce rst_rows "
            f"or the mosaic width)")

    if stripe_rows is None:
        stripe_rows = max(1, int(32e6 // (3 * width)) // mcu_h) * mcu_h
    stripe_rows = max(mcu_h * rst_rows, stripe_rows // mcu_h * mcu_h)
    if (stripe_rows // mcu_h) % rst_rows:
        raise ValueError(
            f"stripe_rows={stripe_rows} is not a whole number of restart "
            f"groups (rst_rows={rst_rows}, MCU height {mcu_h})")

    qy, qc = quant.luma_table(cfg.quality), quant.chroma_table(cfg.quality)
    device = torch.device(device)

    def stripes():
        """Drive source stripe by stripe, yielding each stripe's DPCM'd
        interleaved blocks on the device (restarting every r MCUs from the
        stripe's start, as the whole image's do), table ids and MCUs."""
        row0 = 0
        while row0 < height:
            rows = min(stripe_rows, height - row0)
            img = np.asarray(source(row0, row0 + rows))
            if img.shape != (rows, width, 3):
                raise ValueError(
                    f"source returned {img.shape}, expected {(rows, width, 3)}")
            if img.dtype != np.uint8:
                img = np.clip(img, 0, 255).astype(np.uint8)
            padded = tile.pad_to_multiple(
                torch.as_tensor(np.ascontiguousarray(img), device=device),
                mcu_h, mcu_w)
            blocks, tbl, n_mcu, _ = E._interleaved_blocks(padded, qy, qc,
                                                          mode, r)
            yield blocks, tbl, n_mcu
            row0 += rows

    if optimize_tables:
        # Pass 1: global symbol histograms, summed on the device.
        hists = None
        for blocks, _, n_mcu in stripes():
            h = [x.to(torch.int64) for x in E._color_hists(blocks, n_mcu, hv)]
            hists = h if hists is None else [a + b for a, b in zip(hists, h)]
        htables = E._optimal_tables(hists)
    else:
        htables = huffman.standard_tables()
    luts = E._device_luts(htables, device)

    chunks = [] if out is None else None

    def emit(b: bytes):
        if out is None:
            chunks.append(b)
        else:
            out.write(b)

    emit(jfif.write_header(width, height, E._color_components(mode),
                           {0: qy, 1: qc}, htables, restart_interval=r,
                           comment=comment))
    seg = 0  # global restart-segment counter across stripes
    total_segs = -(-mcu_rows_total // rst_rows)
    for blocks, tbl, n_mcu in stripes():
        scan, status = pack.pack_scan(
            *E._level1_segments(blocks, tbl, luts, n_mcu, r), rst_base=seg)
        status = status.cpu().numpy()
        emit(E._scan_or_spill(scan, status, blocks, tbl, htables, r, bpm,
                              bytes, rst_base=seg))
        seg += status.shape[0] // 2
        if seg < total_segs:  # splice marker between stripes
            emit(bytes([0xFF, 0xD0 + ((seg - 1) & 7)]))
    emit(b"\xff\xd9")  # EOI
    if out is None:
        return b"".join(chunks)
    return None


def assemble_tiles(tiles) -> np.ndarray:
    """(R, C, h, w, 3) tile grid -> (R*h, C*w, 3) mosaic array."""
    t = np.asarray(tiles)
    r, c, h, w, ch = t.shape
    return t.transpose(0, 2, 1, 3, 4).reshape(r * h, c * w, ch)
