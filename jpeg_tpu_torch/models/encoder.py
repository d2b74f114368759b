"""The encoder pipeline: RGB array or BMP -> baseline JFIF JPEG bytes.

  device: edge pad -> exact integer transform (ops/mcu_conv) -> DC DPCM ->
  packer level 1 (kernel A, ops/pack) -> level-2 placement per restart
  segment; host: native finalize (trim, 1-pad, 0xFF stuffing, RSTn) -> JFIF.

This is the device-pack path of jpeg_tpu/models/encoder.py with the Pallas
level-1 packer (`use_pallas_pack=True`); it emits the same bytes as the JAX
package's exact transform + Pallas packer chain. A block over the packer's
288-bit budget (or a segment over its word capacity) spills the whole scan
to the native host packer, counted in HOST_PACK_SPILLS.
"""

from __future__ import annotations

import numpy as np
import torch

from jpeg_tpu_torch.config import EncodeConfig, Subsampling
from jpeg_tpu_torch.entropy import huffman, native
from jpeg_tpu_torch.io import bmp, jfif
from jpeg_tpu_torch.ops import bitpack, dpcm as dpcm_ops, mcu_conv, pack, quant, tile

# Device word-buffer capacity per segment: 8 words (256 bits) per block on
# average, plus 2. Typical q75 blocks need ~30-100 bits.
WORDS_PER_BLOCK = 8

# Scans host-packed because level 2 reported ok=False (the designed spill).
HOST_PACK_SPILLS = 0


def _interleaved_blocks(rgb, qy, qc, mode: Subsampling, restart_mcus: int):
    """Pixels -> (n_mcu * bpm, 64) MCU-interleaved blocks with DC DPCM'd
    (restart resets every restart_mcus MCUs) plus the (B,) table-id array
    (0 luma / 1 chroma). The transform already emits MCU scan order."""
    blocks = mcu_conv._mcu_transform_int(rgb, qy, qc, mode)  # (n_mcu, bpm, 64)
    n_mcu = blocks.shape[0]
    hv = mode.h_factor * mode.v_factor
    r = int(restart_mcus)
    blocks[:, :hv, 0] = dpcm_ops.dpcm(
        blocks[:, :hv, 0].reshape(-1), r * hv).reshape(n_mcu, hv)
    blocks[:, hv, 0] = dpcm_ops.dpcm(blocks[:, hv, 0], r)
    blocks[:, hv + 1, 0] = dpcm_ops.dpcm(blocks[:, hv + 1, 0], r)
    tbl_row = torch.tensor([0] * hv + [1, 1], dtype=torch.int32,
                           device=blocks.device)
    return blocks.reshape(-1, 64), tbl_row.repeat(n_mcu), n_mcu, hv


def _transform_color_packed(rgb, qy, qc, luts, mode: Subsampling,
                            restart_mcus: int):
    """Device half of the encode: pixels -> (words (nseg, nwords) int64
    holding uint32, totals (nseg,), ok (nseg,), blocks, tbl). Restart
    segments must tile the MCU count evenly; an interval of at least the
    MCU count is one segment."""
    blocks, tbl, n_mcu, hv = _interleaved_blocks(rgb, qy, qc, mode,
                                                 restart_mcus)
    r = int(restart_mcus)
    nblocks = blocks.shape[0]
    buf, t_b = pack.pack_level1(blocks, tbl, *luts)
    nseg = 1 if r == 0 or r >= n_mcu else n_mcu // r
    seg_blocks = nblocks // nseg
    nwords = seg_blocks * WORDS_PER_BLOCK + 2
    words, totals, ok = pack.pack_level2(
        buf.reshape(nseg, seg_blocks, -1), t_b.reshape(nseg, seg_blocks), nwords)
    return words, totals, ok, blocks, tbl


def _normalize_image(image) -> np.ndarray:
    """Floats are rounded then clipped; other dtypes clip to uint8."""
    image = np.asarray(image)
    if np.issubdtype(image.dtype, np.floating):
        return np.clip(np.round(image), 0, 255).astype(np.uint8)
    if image.dtype != np.uint8:
        return np.clip(image, 0, 255).astype(np.uint8)
    return image


def _normalize_quant_tables(quant_tables):
    if quant_tables is None:
        return None
    qt_y = np.clip(np.asarray(quant_tables[0], np.int32).reshape(8, 8), 1, 255)
    qt_c = np.clip(np.asarray(quant_tables[1], np.int32).reshape(8, 8), 1, 255)
    return (qt_y, qt_c)


def _color_components(mode: Subsampling):
    """The 3-component SOF spec every color writer shares."""
    return [
        jfif.ComponentSpec(1, mode.h_factor, mode.v_factor, 0, 0, 0),
        jfif.ComponentSpec(2, 1, 1, 1, 1, 1),
        jfif.ComponentSpec(3, 1, 1, 1, 1, 1),
    ]


def _encode_color(image: np.ndarray, cfg: EncodeConfig, comment,
                  quant_tables, device) -> bytes:
    global HOST_PACK_SPILLS
    h0, w0 = image.shape[:2]
    mode = cfg.subsampling
    img = tile.pad_to_multiple(
        torch.as_tensor(np.ascontiguousarray(image), device=device),
        mode.mcu_height, mode.mcu_width)
    if quant_tables is not None:
        qy_np, qc_np = quant_tables
    else:
        qy_np, qc_np = quant.luma_table(cfg.quality), quant.chroma_table(cfg.quality)

    r = cfg.restart_interval
    n_mcu = (img.shape[0] // mode.mcu_height) * (img.shape[1] // mode.mcu_width)
    if r and r < n_mcu and n_mcu % r:
        raise NotImplementedError(
            f"restart_interval={r} does not divide the {n_mcu} MCUs; unaligned "
            "restart intervals need the host-pack path, not ported yet "
            "(ROADMAP.md Queue 1 item 2)")
    htables = huffman.standard_tables()
    luts = tuple(torch.as_tensor(a.astype(np.int32), device=img.device)
                 for a in bitpack.luts_from_tables(htables))
    words, totals, ok, blocks, tbl = _transform_color_packed(
        img, qy_np, qc_np, luts, mode, r)
    if bool(ok.all()):
        totals_np = totals.cpu().numpy()
        maxw = (int(totals_np.max()) + 31) // 32
        w_host = words[:, :maxw].cpu().numpy().astype(np.uint32)
        scan = bitpack.finalize_stream(w_host, totals_np)
    else:
        # A block or segment overflowed the device budget: host-pack the
        # same coefficients (the designed spill).
        HOST_PACK_SPILLS += 1
        scan = native.encode_scan(
            blocks.cpu().numpy(), tbl.cpu().numpy(), htables,
            restart_interval=r, blocks_per_mcu=mode.blocks_per_mcu)
    return jfif.write_jpeg(
        w0, h0, _color_components(mode), {0: qy_np, 1: qc_np},
        htables, scan, restart_interval=r, comment=comment,
    )


def encode(
    image,
    quality: int = 75,
    subsampling="420",
    restart_interval: int | None = None,
    optimize_tables: bool = False,
    comment: str | None = None,
    quant_tables=None,
    device="cuda",
) -> bytes:
    """Encode an (H, W, 3) RGB uint8 array (or a .bmp path / BMP bytes) to
    baseline JFIF JPEG bytes, running the transform and the bit packer on
    `device` ("cuda" by default; "cpu" runs the plain twins)."""
    if optimize_tables:
        raise NotImplementedError(
            "optimize_tables is not ported yet (ROADMAP.md Queue 1 item 2)")
    cfg = EncodeConfig(
        quality=quality,
        subsampling=subsampling,
        restart_interval=0 if restart_interval is None else restart_interval,
    )
    if isinstance(image, (str, bytes)):
        image = bmp.read_bmp(image) if isinstance(image, str) else bmp.decode_bmp(image)
    image = _normalize_image(image)
    quant_tables = _normalize_quant_tables(quant_tables)
    if image.ndim == 2:
        raise NotImplementedError(
            "grayscale encode is not ported yet (ROADMAP.md Queue 1 item 1)")
    if image.ndim == 3 and image.shape[2] == 3:
        return _encode_color(image, cfg, comment, quant_tables,
                             torch.device(device))
    raise ValueError(f"expected (H, W, 3) or (H, W) image, got {image.shape}")


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
