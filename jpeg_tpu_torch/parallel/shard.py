"""The per-stripe programs of the parallel layer: batch + MCU-stripe
parallelism over a (batch, mcu) mesh (parallel.mesh).

Counterpart of jpeg_tpu/parallel/shard.py, whose shard_map bodies become
loops over the mesh's positions with the collectives between them:

  * ``batch`` axis: independent images, pure data parallelism;
  * ``mcu`` axis: horizontal MCU stripes of each image. The serial seams of
    a JPEG scan become
      - a ppermute of each stripe's last DC predictor to the next stripe,
      - a psum of per-stripe symbol histograms into the global table input,
      - halo rows (ppermute both ways) for the triangular chroma upsample.

With stripe_restart each stripe is one restart segment (DRI/RSTn), so
stripes are independent and the DC exchange is skipped. The packed form
entropy-codes every stripe on its own position: kernel A (ops/pack) and
level 2, one segment per image stripe. The decode finish runs the port's
decoder's f32 sequence per stripe (kernel B through
models/decoder._reconstruct_plane, round and clip, the torch upsample and
colour map of ops/finish's plain twin; the vertical doubling takes halo rows
from the next stripes), so its pixels equal decode()'s, which runs kernels
B2 and H, bit for bit.

Values cross positions as grids of per-position tensors (mesh.is_grid);
on a mesh over several ranks a grid holds None at the other ranks'
positions, and the collectives take the mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from jpeg_tpu_torch.config import Subsampling
from jpeg_tpu_torch.models import decoder, encoder
from jpeg_tpu_torch.ops import finish, mcu_conv, pack, subsample, symbols
from jpeg_tpu_torch.parallel import mesh as mesh_mod
from jpeg_tpu_torch.parallel.mesh import Mesh, grid_map, ppermute, psum


def _check_geometry(imgs, mesh: Mesh, mode: Subsampling) -> None:
    b, h, w = imgs.shape[0], imgs.shape[1], imgs.shape[2]
    dp, sp = mesh.shape["batch"], mesh.shape["mcu"]
    if b % dp:
        raise ValueError(f"batch {b} not divisible by batch axis {dp}")
    if h % (mode.mcu_height * sp):
        raise ValueError(
            f"height {h} not divisible by {sp} stripes of {mode.mcu_height}")
    if w % mode.mcu_width:
        raise ValueError(f"width {w} not a multiple of {mode.mcu_width}")


def _image_grid(imgs, mesh: Mesh, mode: Subsampling):
    """(B, H, W, 3) uint8 images (host array, tensor, or a grid already
    sharded) -> a grid of (b_local, h_local, W, 3) stripes on the
    positions' devices."""
    if not mesh_mod.is_grid(imgs):
        _check_geometry(imgs, mesh, mode)
    return mesh_mod.shard(imgs, mesh)


def _stripe_transform(imgs, qy, qc, mode: Subsampling):
    """A position's (b, h_local, W, 3) uint8 stripe -> per-component
    zig-zag blocks in the stripe's MCU scan order: y (b, n_local * hv, 64),
    cb and cr (b, n_local, 64). The exact integer transform emits MCU scan
    order itself (encoder._transform_color reorders its luma to raster, and
    jpeg_tpu's _stripe_transform back to scan), over the b images as one
    taller image: one matmul per position."""
    hv = mode.h_factor * mode.v_factor
    b = imgs.shape[0]
    blocks = mcu_conv._mcu_transform_int(imgs, qy, qc, mode).reshape(
        b, -1, hv + 2, 64)
    n_local = blocks.shape[1]
    return (blocks[:, :, :hv].reshape(b, n_local * hv, 64),
            blocks[:, :, hv], blocks[:, :, hv + 1])


def _dpcm(blocks, recv):
    """DC DPCM along each image's blocks (b, n, 64), in place: the first
    block is predicted from recv (b,), the others from their predecessor."""
    dc = blocks[:, :, 0]
    prev = torch.cat([recv[:, None], dc[:, :-1]], dim=1)
    blocks[:, :, 0] = dc - prev
    return blocks


def _stripe_step(grid, qy, qc, *, mode: Subsampling, stripe_restart: bool,
                 mesh: Mesh):
    """Transform, DC DPCM and global histograms over the mesh. grid: the
    (b_local, h_local, W, 3) stripes. Returns grids y, cb, cr (DPCM'd, the
    previous stripe's last DC arriving by ppermute unless stripe_restart)
    and the psum'd (4, 256) histograms [dc_luma, ac_luma, dc_chroma,
    ac_chroma] at every position."""
    sp = mesh.shape["mcu"]
    comps = grid_map(lambda im: _stripe_transform(im, qy, qc, mode), grid)
    out = []
    for c in range(3):
        blocks = grid_map(lambda t: t[c], comps)
        if stripe_restart or sp == 1:
            recv = grid_map(lambda x: x.new_zeros(x.shape[0]), blocks)
        else:
            recv = ppermute(grid_map(lambda x: x[:, -1, 0], blocks), "mcu",
                            [(i, i + 1) for i in range(sp - 1)], mesh)
        out.append(grid_map(_dpcm, blocks, recv))
    y, cb, cr = out

    def hist(yb, cbb, crb):
        dc_l, ac_l = symbols.symbol_histogram(yb.reshape(-1, 64))
        dc_c1, ac_c1 = symbols.symbol_histogram(cbb.reshape(-1, 64))
        dc_c2, ac_c2 = symbols.symbol_histogram(crb.reshape(-1, 64))
        return torch.stack([dc_l, ac_l, dc_c1 + dc_c2, ac_c1 + ac_c2])

    hists = psum(grid_map(hist, y, cb, cr), ("batch", "mcu"), mesh)
    return y, cb, cr, hists


def _stripe_blocks(imgs, qy, qc, mode: Subsampling):
    """One position's stripe as one restart segment per image: transform,
    DPCM from zero at the stripe's start, the MCU interleave. Returns
    ((b * n_mcu * bpm, 64) int32 blocks, (b * n_mcu * bpm,) table ids,
    n_mcu per image stripe)."""
    hv = mode.h_factor * mode.v_factor
    y, cb, cr = _stripe_transform(imgs, qy, qc, mode)
    b = y.shape[0]
    y, cb, cr = (_dpcm(x, x.new_zeros(b)) for x in (y, cb, cr))
    n_mcu = cb.shape[1]
    blocks = torch.cat([y.reshape(b, n_mcu, hv, 64), cb[:, :, None],
                        cr[:, :, None]], dim=2).reshape(-1, 64)
    tbl = torch.tensor([0] * hv + [1, 1], dtype=torch.int32,
                       device=blocks.device).repeat(b * n_mcu)
    return blocks, tbl, n_mcu


def _stripe_step_packed(imgs, qy, qc, luts, *, mode: Subsampling):
    """One position's PACKED restart segments: _stripe_blocks, then kernel
    A over the b image stripes' blocks in one launch and level 2 with one
    segment per image stripe. Returns words (b, nwords) int64 holding
    uint32, totals (b, 1) and ok (b, 1); ok is False where a block exceeds
    the 288-bit budget (bitpack.BLOCK_WORDS)."""
    blocks, tbl, n_mcu = _stripe_blocks(imgs, qy, qc, mode)
    b = imgs.shape[0]
    words, totals, ok = pack.pack_level2(
        *encoder._level1_segments(blocks, tbl, luts, b * n_mcu, n_mcu))
    return words, totals[:, None], ok[:, None]


def sharded_encode_packed(imgs, qy, qc, huff: dict, mesh: Mesh,
                          mode: Subsampling = Subsampling.YUV420):
    """Distributed transform + per-stripe device entropy packing.

    Returns grids (words, totals, ok): at position (i, j), the (b_local,
    nwords) words, (b_local, 1) bit totals and ok flags of stripe j of the
    batch row's images; to_host assembles (B, sp * nwords), (B, sp),
    (B, sp). Join the segments with RSTn after the host finalize."""
    grid = _image_grid(imgs, mesh, mode)
    parts = grid_map(
        lambda im: _stripe_step_packed(
            im, qy, qc, encoder._device_luts(huff, im.device), mode=mode),
        grid)
    return tuple(grid_map(lambda p, k=k: p[k], parts) for k in range(3))


def sharded_histograms(imgs, qy, qc, mesh: Mesh,
                       mode: Subsampling = Subsampling.YUV420,
                       stripe_restart: bool = True):
    """Pass 1 of the device-packed optimized-table batch encode: the global
    (4, 256) int32 symbol histograms psum'd over the whole mesh (on this
    process's first position's device), the blocks never leaving the
    devices. Same geometry contract as sharded_encode_blocks."""
    grid = _image_grid(imgs, mesh, mode)
    hists = _stripe_step(grid, qy, qc, mode=mode,
                         stripe_restart=bool(stripe_restart), mesh=mesh)[3]
    return hists[mesh.local_positions()[0]]


def sharded_encode_blocks(imgs, qy, qc, mesh: Mesh,
                          mode: Subsampling = Subsampling.YUV420,
                          stripe_restart: bool = False):
    """Run the distributed transform.

    imgs: (B, H, W, 3) uint8 (host array, tensor, or grid), H and W already
    multiples of the MCU size, with B divisible by the ``batch`` axis and
    H / mcu_height by the ``mcu`` axis.

    Returns (y, cb, cr, hists): grids of per-component (b_local, n_local,
    64) int32 zig-zag blocks in MCU scan order with DC already DPCM'd
    (to_host gives (B, N_comp, 64)), and the (4, 256) global symbol
    histograms [dc_luma, ac_luma, dc_chroma, ac_chroma] (on this process's
    first position's device)."""
    grid = _image_grid(imgs, mesh, mode)
    y, cb, cr, hists = _stripe_step(grid, qy, qc, mode=mode,
                                    stripe_restart=bool(stripe_restart),
                                    mesh=mesh)
    return y, cb, cr, hists[mesh.local_positions()[0]]


def _halo_triangle_vertical(grid, mesh: Mesh):
    """Vertical doubling with 3:1 triangular weights across stripe
    boundaries. grid: (b, h_local, w) chroma stripes along the mcu axis.
    The filter needs one row of halo on each side; the boundary rows travel
    by ppermute (edge stripes replicate their own row, as the unsharded
    edge does). Bit-identical to subsample._triangle_axis on the whole
    plane: the same f32 operations on the same samples."""
    sp = grid.shape[1]
    if sp == 1:
        return grid_map(lambda x: subsample._triangle_axis(x, -2), grid)
    from_above = ppermute(grid_map(lambda x: x[:, -1, :], grid), "mcu",
                          [(i, i + 1) for i in range(sp - 1)], mesh)
    from_below = ppermute(grid_map(lambda x: x[:, 0, :], grid), "mcu",
                          [(i, i - 1) for i in range(1, sp)], mesh)
    out = np.empty(grid.shape, dtype=object)
    for i, j in mesh.local_positions():
        x = grid[i, j]
        top = x[:, 0, :] if j == 0 else from_above[i, j]
        bot = x[:, -1, :] if j == sp - 1 else from_below[i, j]
        prev = torch.cat([top[:, None, :], x[:, :-1, :]], dim=1)
        nxt = torch.cat([x[:, 1:, :], bot[:, None, :]], dim=1)
        a = (3.0 * x + prev) * 0.25
        b = (3.0 * x + nxt) * 0.25
        bsz, h, w = x.shape
        out[i, j] = torch.stack([a, b], dim=2).reshape(bsz, 2 * h, w)
    return out


def _stripe_decode(y, cb, cr, qy, qc, *, mode: Subsampling, mcu_cols: int,
                   mesh: Mesh):
    """Decode finish over the mesh: grids of raster-order zig-zag blocks
    (b, n_local, 64) per component -> a grid of (b, h_local, W, 3) uint8
    pixels. Per position: dequant + IDCT (kernel B on the b stripes stacked
    along their rows, one launch per component), round and clip, the
    horizontal upsample; then the vertical doubling across the stripes with
    halo rows; then the colour map, round and clip."""
    hf, vf = mode.h_factor, mode.v_factor

    def planes(zy, zcb, zcr):
        b = zy.shape[0]

        def plane(zz, qtab, wb):
            q = torch.as_tensor(qtab, dtype=torch.float32, device=zz.device)
            hb = zz.shape[1] // wb
            return decoder._reconstruct_batch(zz.reshape(-1, 64), q,
                                              (hb, wb), 8, b)

        chroma = [finish.upsample(plane(z, qc, mcu_cols), (hf, 1), True)
                  for z in (zcb, zcr)]
        return plane(zy, qy, mcu_cols * hf), chroma[0], chroma[1]

    parts = grid_map(planes, y, cb, cr)
    yp, cbp, crp = (grid_map(lambda p, k=k: p[k], parts) for k in range(3))
    if vf == 2:
        cbp = _halo_triangle_vertical(cbp, mesh)
        crp = _halo_triangle_vertical(crp, mesh)
    return grid_map(lambda a, b, c: finish.rgb_from_planes([a, b, c], False),
                    yp, cbp, crp)


def sharded_decode_pixels(y_zz, cb_zz, cr_zz, qy, qc, mcu_cols: int,
                          mesh: Mesh, mode: Subsampling = Subsampling.YUV420):
    """Distributed decode finishing: per-component (B, N, 64) zig-zag blocks
    in PLANE RASTER order (host arrays, tensors or grids) -> a grid of
    (b_local, h_local, W, 3) uint8 pixels over (batch, stripe); to_host
    gives (B, H, W, 3). Bit-identical to the port's single-device decoder
    (fancy upsampling). The MCU-row count must divide over the ``mcu``
    axis."""
    sp = mesh.shape["mcu"]
    if not mesh_mod.is_grid(y_zz):
        n_mcu = cb_zz.shape[1]
        if n_mcu % mcu_cols or (n_mcu // mcu_cols) % sp:
            raise ValueError(
                f"{n_mcu // mcu_cols} MCU rows not divisible over {sp} "
                "stripes")
    y, cb, cr = (mesh_mod.shard(z, mesh) for z in (y_zz, cb_zz, cr_zz))
    return _stripe_decode(y, cb, cr, qy, qc, mode=mode, mcu_cols=int(mcu_cols),
                          mesh=mesh)
