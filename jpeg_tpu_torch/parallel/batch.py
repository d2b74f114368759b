"""Batched, mesh-sharded encode and decode: same-sized images over the
(batch, mcu) mesh, one independent JFIF stream per image.

Counterpart of jpeg_tpu/parallel/batch.py. On encode the positions do
everything through the quantized, DPCM'd coefficients and the global symbol
histograms (parallel.shard); then either the host packs each image's scan
(native packer), or, with device_pack and stripe restarts, every stripe is
packed on its own position (kernel A + level 2) and the host only finalizes
and stitches the segments with RSTn. On decode the host (or, with
entropy="device", the card) resolves each stream's Huffman layer and the
positions finish the stripes with halo rows for the chroma upsample.
On a mesh over several ranks (mesh.make_multihost_mesh) every rank passes
the whole batch, runs its own positions, and gets every stream or pixel:
the host steps run identically on every rank.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from jpeg_tpu_torch.config import Subsampling, _as_subsampling
from jpeg_tpu_torch.entropy import huffman, native
from jpeg_tpu_torch.io import jfif
from jpeg_tpu_torch.models import decoder, encoder, layout
from jpeg_tpu_torch.ops import bitpack, quant
from jpeg_tpu_torch.parallel import shard
from jpeg_tpu_torch.parallel.mesh import grid_map, make_mesh, to_host

# Mesh batches whose device pack overflowed the 288-bit per-block budget
# (bitpack.BLOCK_WORDS) and were packed whole on the host instead. Counted
# under a lock: callers may encode from threads.
DEVICE_PACK_FALLBACKS = 0
_COUNT_LOCK = threading.Lock()


def tables_from_histograms(hists: np.ndarray) -> dict:
    """(4, 256) [dc_luma, ac_luma, dc_chroma, ac_chroma] -> HuffTable dict."""
    return {
        (0, 0): huffman.optimal_table(hists[0]),
        (1, 0): huffman.optimal_table(hists[1]),
        (0, 1): huffman.optimal_table(hists[2]),
        (1, 1): huffman.optimal_table(hists[3]),
    }


def _encode_batch_device_packed(grid, padded_shape, orig_shape, qy, qc, mesh,
                                mode, optimize_tables: bool = False,
                                ) -> list[bytes] | None:
    """Device path: every stripe entropy-packs its own restart segment on its
    own position; the host only finalizes (stuff/pad) and stitches with
    RSTn. With optimize_tables, a first pass psums global symbol histograms
    (the blocks never leave the devices) and the optimal tables feed the
    packing pass. `grid` holds the padded images' stripes, `padded_shape`
    is their (B, H, W, 3). Returns None if any stripe overflowed the
    per-block budget."""
    if optimize_tables:
        htables = tables_from_histograms(to_host(shard.sharded_histograms(
            grid, qy, qc, mesh, mode, stripe_restart=True)))
    else:
        htables = huffman.standard_tables()
    words, totals, ok = shard.sharded_encode_packed(
        grid, qy, qc, htables, mesh, mode)
    if not bool(to_host(ok, mesh).all()):
        return None
    totals_np = to_host(totals, mesh)
    # Download each stripe's words only as far as the longest segment:
    # (B, sp, maxw), stripe j of image i at [i, j]. Every rank gathers the
    # same totals, so every rank cuts at the same maxw.
    maxw = (int(totals_np.max()) + 31) // 32
    words_np = to_host(grid_map(lambda w: w[:, None, :maxw], words),
                       mesh).astype(np.uint32)
    b, h0, w0 = orig_shape[0], orig_shape[1], orig_shape[2]
    sp = mesh.shape["mcu"]
    hp, wp = padded_shape[1], padded_shape[2]
    mcu_cols = wp // mode.mcu_width
    mcu_rows = hp // mode.mcu_height
    dri = (mcu_rows // sp) * mcu_cols if sp > 1 else 0
    return [
        jfif.write_jpeg(
            w0, h0, encoder._color_components(mode), {0: qy, 1: qc}, htables,
            bitpack.finalize_stream(words_np[i], totals_np[i]),
            restart_interval=dri)
        for i in range(b)]


def _pad_images(imgs: np.ndarray, mult_h: int, mult_w: int) -> np.ndarray:
    """Edge-replicate pad (B, H, W, 3) on the host up to multiples of
    (mult_h, mult_w); no copy when nothing is padded."""
    ph = (-imgs.shape[1]) % mult_h
    pw = (-imgs.shape[2]) % mult_w
    if not (ph or pw):
        return imgs
    return np.pad(imgs, ((0, 0), (0, ph), (0, pw), (0, 0)), mode="edge")


def encode_batch(
    imgs,
    quality: int = 75,
    subsampling="420",
    mesh=None,
    stripe_restart: bool = True,
    optimize_tables: bool = False,
    device_pack: bool = False,
) -> list[bytes]:
    """Encode a batch of same-sized RGB images into independent JFIF streams.

    imgs: (B, H, W, 3) uint8, B divisible by the mesh's batch axis. The
    transform is sharded over the (batch, mcu-stripe) mesh axes (mesh: None
    takes make_mesh(), every CUDA device); the images are padded to MCU
    multiples and to the stripe count. With stripe_restart each stripe
    becomes a restart segment (DRI = one stripe's MCUs), so entropy packing
    parallelizes per stripe too, and device_pack packs it on its position;
    a batch whose device pack overflows falls back to the host pack,
    counted in DEVICE_PACK_FALLBACKS. With optimize_tables, one set of
    optimal tables is derived from the psum'd global histograms and shared
    by the whole batch."""
    global DEVICE_PACK_FALLBACKS
    imgs = encoder._normalize_image(imgs)
    if imgs.ndim != 4 or imgs.shape[-1] != 3:
        raise ValueError(f"expected (B, H, W, 3), got {imgs.shape}")
    mode = _as_subsampling(subsampling)
    if mesh is None:
        mesh = make_mesh()
    sp = mesh.shape["mcu"]
    h0, w0 = imgs.shape[1], imgs.shape[2]
    padded = _pad_images(imgs, mode.mcu_height * sp, mode.mcu_width)
    qy = quant.luma_table(quality)
    qc = quant.chroma_table(quality)
    grid = shard._image_grid(padded, mesh, mode)  # one upload for all passes

    if device_pack and stripe_restart:
        out = _encode_batch_device_packed(
            grid, padded.shape, imgs.shape, qy, qc, mesh, mode,
            optimize_tables=optimize_tables)
        if out is not None:
            return out
        with _COUNT_LOCK:  # fall through to the host pack
            DEVICE_PACK_FALLBACKS += 1

    y, cb, cr, hists = shard.sharded_encode_blocks(
        grid, qy, qc, mesh, mode, stripe_restart=stripe_restart)
    y, cb, cr = to_host(y, mesh), to_host(cb, mesh), to_host(cr, mesh)

    hv = mode.h_factor * mode.v_factor
    hp, wp = padded.shape[1], padded.shape[2]
    mcu_cols = wp // mode.mcu_width
    mcu_rows = hp // mode.mcu_height
    dri = (mcu_rows // sp) * mcu_cols if (stripe_restart and sp > 1) else 0
    htables = (tables_from_histograms(to_host(hists)) if optimize_tables
               else huffman.standard_tables())
    out = []
    for i in range(imgs.shape[0]):
        blocks, tbl = encoder.interleave_mcus(y[i], cb[i], cr[i], hv)
        scan = native.encode_scan(blocks, tbl, htables, restart_interval=dri,
                                  blocks_per_mcu=hv + 2)
        out.append(jfif.write_jpeg(
            w0, h0, encoder._color_components(mode), {0: qy, 1: qc}, htables,
            scan, restart_interval=dri))
    return out


def _block_grids(infos, mesh, mcu_rows: int, mcu_cols: int, entropy: str):
    """Entropy-decode every stream of a batch row that this process holds
    a position of, on its first position of the row
    (decoder._device_blocks: raster-order zig-zag blocks per component, on
    the card by the device Huffman decoders for "auto"), stack each row's
    images and send every local stripe to its position: three grids (y,
    cb, cr) of (b_local, n_local, 64) int32 blocks, None at other ranks'
    positions (every rank holds all the streams)."""
    dp, sp = mesh.devices.shape
    bl = len(infos) // dp
    grids = [np.empty((dp, sp), dtype=object) for _ in range(3)]
    for r in range(dp):
        cols = [j for j in range(sp) if mesh.is_local((r, j))]
        if not cols:
            continue
        per_img = [decoder._device_blocks(info, mcu_rows, mcu_cols, entropy,
                                          mesh.devices[r, cols[0]])
                   for info in infos[r * bl:(r + 1) * bl]]
        for c in range(3):
            rows = torch.stack([z[c] for z in per_img])
            nl = rows.shape[1] // sp
            for j in cols:
                grids[c][r, j] = rows[:, j * nl:(j + 1) * nl].to(
                    mesh.devices[r, j])
    return grids


def decode_batch(jpegs, mesh=None, entropy: str = "auto") -> np.ndarray:
    """Decode a batch of same-geometry baseline JPEGs to (B, H, W, 3) uint8.

    The data-parallel twin of encode_batch: each stream's Huffman layer is
    resolved by the port's `entropy` backend (decode()'s names: "auto" is
    "device" on a card, the block-start program + kernel D; the native walk
    on the CPU) on this process's first position of its batch row, then
    the positions finish every image's stripes, with halo rows for the
    triangular chroma upsample. Bit-identical to per-image decode() on the
    mesh's devices.

    All streams must share geometry, sampling mode and quant tables; B must
    divide over the ``batch`` axis and the MCU-row count over the ``mcu``
    axis. Streams whose chroma is at most 2 samples wide (replication
    upsampling), whose components are stored as RGB, or whose two chroma
    components use different quant tables are decoded image by image."""
    if entropy not in decoder.ENTROPY_BACKENDS:
        raise ValueError(f"unknown entropy backend {entropy!r}")
    if mesh is None:
        mesh = make_mesh()
    infos = [jfif.parse_jpeg(d) for d in jpegs]
    i0 = infos[0]
    comps0 = i0.components
    if len(comps0) != 3 or any((c.h, c.v) != (1, 1) for c in comps0[1:]):
        raise ValueError("decode_batch needs 3-component standard layouts")
    mode = next(
        (m for m in Subsampling
         if (m.h_factor, m.v_factor) == (comps0[0].h, comps0[0].v)),
        None,
    )
    if mode is None:
        raise ValueError(
            f"unsupported sampling {(comps0[0].h, comps0[0].v)} for the "
            "sharded path; decode images individually instead")
    for info in infos[1:]:
        same = (
            (info.width, info.height) == (i0.width, i0.height)
            and [(c.h, c.v, c.qtab_id) for c in info.components]
            == [(c.h, c.v, c.qtab_id) for c in comps0]
            and all(k in info.qtables
                    and np.array_equal(info.qtables[k], i0.qtables[k])
                    for k in i0.qtables)
        )
        if not same:
            raise ValueError("decode_batch requires homogeneous streams")

    dev0 = mesh.devices[mesh.local_positions()[0]]
    cy = comps0[0]
    is_rgb = i0.adobe_transform == 0 or (
        i0.adobe_transform is None
        and tuple(c.comp_id for c in comps0) == (0x52, 0x47, 0x42))
    if ((cy.h > 1 and layout.ceil_div(i0.width, cy.h) <= 2) or is_rgb
            or comps0[1].qtab_id != comps0[2].qtab_id):
        return np.stack([decoder.decode(d, entropy=entropy, device=dev0)
                         for d in jpegs])

    mcu_rows = layout.ceil_div(i0.height, 8 * cy.v)
    mcu_cols = layout.ceil_div(i0.width, 8 * cy.h)
    dp, sp = mesh.devices.shape
    if mcu_rows % sp:
        raise ValueError(f"{mcu_rows} MCU rows not divisible over {sp} stripes")
    if len(infos) % dp:
        raise ValueError(
            f"batch {len(infos)} not divisible by batch axis {dp}")

    grids = _block_grids(infos, mesh, mcu_rows, mcu_cols, entropy)
    qy = i0.qtables[comps0[0].qtab_id]
    qc = i0.qtables[comps0[1].qtab_id]
    px = to_host(shard.sharded_decode_pixels(*grids, qy, qc, mcu_cols, mesh,
                                             mode), mesh)
    return px[:, : i0.height, : i0.width]
