"""Shared inputs for the PyTorch port's tests (tests/test_torch_*.py).

Images and coefficient blocks come from numpy seeds, never from files, so
the tests run anywhere the repository does."""

from __future__ import annotations

import functools
import importlib.util
import pathlib

import numpy as np
import pytest


def make_image(h, w, seed=0):
    """Gradient + uniform noise in [-10, 10] (bench.make_image's formula)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    grad = np.stack(
        [xx * 255 / w, yy * 255 / h, (xx + yy) * 128 / (h + w)], axis=-1
    )
    noise = rng.integers(-10, 11, size=(h, w, 3))
    return np.clip(grad + noise, 0, 255).astype(np.uint8)


@functools.cache
def plainjpeg():
    """The benchmark's plain codec and reference (benchmark/lib/plainjpeg.py),
    loaded by its path: it imports numpy and torch only, never jax."""
    path = (pathlib.Path(__file__).resolve().parent.parent / "benchmark"
            / "lib" / "plainjpeg.py")
    spec = importlib.util.spec_from_file_location("bench_plainjpeg", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def plain_streams(images, subsampling: str, restart: int, quality=75,
                  device="cpu"):
    """(streams, coefficients) of uint8 (H, W, 3) images of one shape, as
    the plain encoder writes them: one JFIF stream and one (MCUs, blocks,
    64) coefficient tensor per image."""
    import torch

    P = plainjpeg()
    rgb = torch.as_tensor(np.stack(images), device=device)
    coefs = P.coefficients(rgb, quality, subsampling=subsampling)
    head = P.jfif_header(rgb.shape[2], rgb.shape[1], quality, subsampling,
                         restart)
    return ([head + s + b"\xff\xd9" for s in P.scans(coefs, restart)],
            list(coefs))


def outside_bounds(out, coefs, height: int, width: int, subsampling: str,
                   quality=75) -> int:
    """RGB bytes of a decode outside the reference's pixel_bounds (all of
    them where its shape differs)."""
    import torch

    lo, hi = plainjpeg().pixel_bounds(coefs, quality, height, width,
                                      subsampling=subsampling)
    out = torch.as_tensor(out).cpu()
    if out.shape != lo.shape:
        return lo.numel()
    return int(((out < lo.cpu()) | (out > hi.cpu())).sum())


def random_blocks(rng, n, density):
    """(n, 64) int32 zig-zag blocks: AC nonzero with probability `density`,
    values in [-200, 200]; DC differences in [-800, 800)."""
    blocks = np.zeros((n, 64), dtype=np.int32)
    mask = rng.random((n, 64)) < density
    blocks[mask] = rng.integers(-200, 201, size=mask.sum())
    blocks[:, 0] = rng.integers(-800, 800, size=n)
    return blocks


def scan_block_words(rng, totals, fill="random"):
    """(n, 10) int32 word buffers for blocks of these bit totals, as kernel A
    leaves them: random (or, with fill="ones", all-ones) bits up to each
    total, zero past it."""
    totals = np.asarray(totals, dtype=np.int64)
    ncols = 10  # bitpack.BLOCK_WORDS + 1
    words = (np.full((totals.shape[0], ncols), 0xFFFFFFFF, dtype=np.uint64)
             if fill == "ones" else
             rng.integers(0, 1 << 32, size=(totals.shape[0], ncols),
                          dtype=np.uint64))
    keep = np.clip(totals[:, None] - np.arange(ncols)[None, :] * 32, 0, 32)
    keep = keep.astype(np.uint64)
    mask = ((np.uint64(1) << keep) - np.uint64(1)) << (np.uint64(32) - keep)
    mask[keep == 0] = 0
    return (words & mask).astype(np.uint32).view(np.int32)


def require_cuda():
    """Skip the calling test unless a CUDA device is present (decided when
    the test runs, never at import or collection)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def scan_args(jpg: bytes):
    """(scan bytes, MCU count, mcu_layout, Huffman tables, restart interval)
    of a baseline single-scan stream: the arguments of the port's scan
    walkers (native.decode_scan, native.sparse_scan,
    decode_device.sparse_payload)."""
    from jpeg_tpu_torch.io import jfif
    from jpeg_tpu_torch.models import layout

    info = jfif.parse_jpeg(jpg)
    comps = info.components
    if len(comps) == 1:  # one block per MCU whatever the sampling factors
        hmax = vmax = 1
        mcu_layout = [(0, 1, comps[0].dc_id, comps[0].ac_id)]
    else:
        hmax = max(c.h for c in comps)
        vmax = max(c.v for c in comps)
        mcu_layout = [(i, c.h * c.v, c.dc_id, c.ac_id)
                      for i, c in enumerate(comps)]
    n_mcu = (layout.ceil_div(info.height, 8 * vmax)
             * layout.ceil_div(info.width, 8 * hmax))
    return (info.scan_data, n_mcu, mcu_layout, info.htables,
            info.restart_interval)


def level1_bits(block, tid: int, htables) -> int:
    """Bits of one zig-zag block (DC already DPCM'd) under the baseline
    Huffman procedure, counted position by position in plain Python: an
    oracle for the packers' totals that shares no code with them. Magnitude
    categories are capped at 12, as the packers cap them."""
    dc, ac = htables[(0, tid)], htables[(1, tid)]

    def size(v):
        return min(int(abs(int(v))).bit_length(), 12)

    bits = int(dc.size[size(block[0])]) + size(block[0])
    run = 0
    for k in range(1, 64):
        if block[k] == 0:
            run += 1
            continue
        bits += (run >> 4) * int(ac.size[0xF0])
        s = size(block[k])
        bits += int(ac.size[((run & 15) << 4) + s]) + s
        run = 0
    if block[63] == 0:
        bits += int(ac.size[0])
    return bits


def _block_of_bits(rng, target: int, tid: int, htables) -> np.ndarray:
    """A dense block whose level-1 record is exactly `target` bits: random
    dense blocks, the last coefficients adjusted until the count fits."""
    while True:
        block = np.zeros(64, dtype=np.int32)
        n = int(rng.integers(30, 64))
        block[:n] = rng.integers(-63, 64, size=n)
        for _ in range(200):
            bits = level1_bits(block, tid, htables)
            if bits == target:
                return block
            k = int(rng.integers(1, 64))
            block[k] = 0 if bits > target else int(rng.integers(-7, 8))


def adversarial_level1_blocks(htables):
    """(blocks (N, 64) int32, tbl (N,) int32): the cases a level-1 packer
    gets wrong first. An all-zero block; only coefficient 63 nonzero; zero
    runs of exactly 15, 16, 17, 31, 32, 33, 47, 48 and 62 before a nonzero
    (alone, and followed by more); every magnitude category 1-12 with both
    signs at its smallest and largest value (+-1 ... +-2047, and +-4095 and
    beyond for the cap) as DC and as AC; blocks of exactly 288 and 289 bits
    under each table; blocks far over the 288-bit budget (all +-1023, all
    +-2047); table ids 0 and 1 alternating, so both meet within a warp."""
    rng = np.random.default_rng(2024)
    blocks = [np.zeros(64, dtype=np.int32)]
    b = np.zeros(64, dtype=np.int32)
    b[63] = -3
    blocks.append(b)
    for run in (15, 16, 17, 31, 32, 33, 47, 48, 62):
        b = np.zeros(64, dtype=np.int32)
        b[0] = 5
        b[run + 1] = 2
        blocks.append(b)
        b = b.copy()
        b[1 + run + 1:] = rng.integers(-4, 5, size=64 - (run + 2))
        blocks.append(b)
    # Two long runs in one block (16 + 32 zeros), and a run that ends at 63.
    b = np.zeros(64, dtype=np.int32)
    b[[0, 17, 50, 63]] = (-1, 1, -1, 7)
    blocks.append(b)
    for s in range(1, 13):
        for v in (1 << (s - 1), (1 << s) - 1):
            for sign in (1, -1):
                b = np.zeros(64, dtype=np.int32)
                b[0] = sign * v
                b[1 + s] = -sign * v
                b[40] = sign * v
                blocks.append(b)
    for v in (4096, -4096, 20000, -32768):
        b = np.zeros(64, dtype=np.int32)
        b[[0, 2]] = v
        blocks.append(b)
    for tid in (0, 1):
        for target in (288, 289):
            blocks.append(_block_of_bits(rng, target, tid, htables))
    for v in (1023, 2047):
        b = np.full(64, v, dtype=np.int32)
        b[1::2] = -v
        blocks.append(b)
    blocks = np.stack(blocks)
    tbl = (np.arange(len(blocks)) % 2).astype(np.int32)
    # The exact-size blocks were fitted to their own table id.
    fitted = len(blocks) - 6
    tbl[fitted:fitted + 4] = (0, 0, 1, 1)
    return blocks, tbl


LEVEL1_SIZES = (1, 31, 33, 127, 129)


def adversarial_level1_case(n: int, htables):
    """The adversarial blocks cycled (and, past one cycle, shuffled by a
    seeded permutation) to exactly n blocks."""
    blocks, tbl = adversarial_level1_blocks(htables)
    idx = np.arange(n) % len(blocks)
    if n > len(blocks):
        idx = np.random.default_rng(n).permutation(idx)
    elif n < len(blocks):
        # Short cases still see the hardest blocks: take them from the end.
        idx = np.arange(len(blocks) - n, len(blocks))
    return blocks[idx], tbl[idx]


def adversarial_idct_planes():
    """[(name, coefficient plane (H, W) int32, (8, 8) quant table)]: the
    smallest plane, a ragged width (40 = 5 blocks), a wide one that is not
    a multiple of 128 columns (1008), DC only, and one coefficient at
    +-2047 under a table of 255s (samples near 1e5, where an f32 ulp is
    8e-3, close to the 1e-2 tolerance)."""
    rng = np.random.default_rng(77)
    flat = np.full((8, 8), 16, dtype=np.int32)
    steep = np.full((8, 8), 255, dtype=np.int32)
    cases = []
    for shape in ((8, 8), (8, 40), (16, 1008)):
        cases.append((f"random{shape}",
                      rng.integers(-100, 101, size=shape).astype(np.int32),
                      flat))
    dc_only = np.zeros((16, 40), dtype=np.int32)
    dc_only[::8, ::8] = rng.integers(-1024, 1024, size=(2, 5))
    cases.append(("dc_only", dc_only, flat))
    for sign, (u, v) in ((1, (0, 0)), (-1, (7, 7)), (1, (1, 6)), (-1, (4, 3))):
        one = np.zeros((8, 40), dtype=np.int32)
        one[u, 16 + v] = sign * 2047
        cases.append((f"one_{'p' if sign > 0 else 'm'}2047_at_{u}{v}", one,
                      steep))
    return cases


@pytest.fixture
def jax_exact_transform(monkeypatch):
    """For the test's duration, run jpeg_tpu's entry points on the exact
    integer transform, the one they take on an accelerator (on the CPU
    mcu_conv.mcu_transform and encoder._transform_gray route to a staged
    float form that is 1 off at .5 boundaries), so that their bytes can be
    held against the port's. The cached jits are cleared on entry and on
    exit: no test before or after sees a trace made under the other route.
    Nothing in jpeg_tpu changes on disk."""
    import jpeg_tpu.models.encoder as JE
    import jpeg_tpu.ops.mcu_conv as JM

    def clear():
        for jit in (JE._jit_color, JE._jit_color_packed,
                    JE._jit_color_packed_batch, JE._jit_color_hists,
                    JE._jit_gray, JE._jit_gray_packed, JE._jit_gray_hists):
            jit.cache_clear()

    clear()
    monkeypatch.setattr(JM, "mcu_transform", JM._mcu_transform_int)
    monkeypatch.setattr(JE, "_transform_gray", JM.gray_transform_int)
    yield
    monkeypatch.undo()
    clear()


# ---------------------------------------------------------------------------
# Inputs of the device Huffman decoders' kernels (ops/entropy_decode), built
# from a baseline single-scan stream as entropy/decode_device builds them.
# ---------------------------------------------------------------------------


def ac_indexed_inputs(jpg: bytes, device="cpu"):
    """(words, off, dc, slot, tables): what decode_scan_indexed hands kernel
    D for one stream, from the native index pass."""
    import torch

    from jpeg_tpu_torch.entropy import decode_device as PD, native
    from jpeg_tpu_torch.ops import entropy_decode as ED

    args = scan_args(jpg)
    _, n_mcu, mcu_layout, htables, _ = args
    destuffed, ac_off, dc = native.index_scan(*args)
    slots, slot_of = PD._scan_slots(mcu_layout)
    slot = np.concatenate([
        np.full(bpm * n_mcu, slot_of[(1, ac)], dtype=np.int32)
        for (_, bpm, _, ac) in mcu_layout])
    return tuple(torch.as_tensor(a, device=device) for a in (
        PD._guarded_words(destuffed), ac_off, dc, slot,
        ED.build_tables(htables, slots)))


def segment_inputs(jpg: bytes, device="cpu"):
    """((words, segment offsets, interval, MCU count, seq, tables, blocks),
    bits per segment): what decode_scan hands kernel E, built segment by
    segment with decode_np's functions. A stream without restart markers
    comes out as one segment."""
    import torch

    from jpeg_tpu_torch.entropy import decode_device as PD
    from jpeg_tpu_torch.ops import entropy_decode as ED

    scan, n_mcu, mcu_layout, htables, r = scan_args(jpg)
    unstuffed = [PD.decode_np.unstuff(s)
                 for s in PD.decode_np.split_restart_segments(scan)]
    flat = np.concatenate(unstuffed)
    lens = np.array([len(u) for u in unstuffed])
    seg_off = (np.cumsum(lens) - lens).astype(np.int32)
    slots, slot_of = PD._scan_slots(mcu_layout)
    seq, base = [], 0
    for ci, (_, bpm, dc, ac) in enumerate(mcu_layout):
        seq += [(ci, slot_of[(0, dc)], slot_of[(1, ac)], base + occ, bpm)
                for occ in range(bpm)]
        base += bpm * n_mcu
    return (torch.as_tensor(PD._guarded_words(flat), device=device),
            torch.as_tensor(seg_off, device=device),
            r if r else n_mcu, n_mcu,
            torch.tensor(seq, dtype=torch.int32, device=device),
            torch.as_tensor(ED.build_tables(htables, slots), device=device),
            base), [len(u) * 8 for u in unstuffed]


def prefix_inputs(jpg: bytes, device="cpu", nbytes=None):
    """((words, MCU count, seq, classes, tables), true bits): what
    decode_scan_prefix hands program F for a stream without restart markers.
    nbytes: pad the scan to that many bytes instead of the guard alone."""
    import torch

    from jpeg_tpu_torch.entropy import decode_device as PD
    from jpeg_tpu_torch.ops import entropy_decode as ED

    scan, n_mcu, mcu_layout, htables, _ = scan_args(jpg)
    unstuffed = PD.decode_np.unstuff(scan)
    true_bits = len(unstuffed) * 8
    if nbytes:
        unstuffed = np.concatenate(
            [unstuffed, np.zeros(nbytes - len(unstuffed) - 8, dtype=np.uint8)])
    slots, slot_of = PD._scan_slots(mcu_layout)
    pairs = [(slot_of[(0, dc)], slot_of[(1, ac)])
             for (_, bpm, dc, ac) in mcu_layout for _ in range(bpm)]
    classes = sorted(set(pairs))
    return (
        torch.as_tensor(PD._guarded_words(unstuffed), device=device), n_mcu,
        torch.tensor([(d, a, classes.index((d, a))) for d, a in pairs],
                     dtype=torch.int32, device=device),
        torch.tensor(classes, dtype=torch.int32, device=device),
        torch.as_tensor(ED.build_tables(htables, slots), device=device),
    ), true_bits


def regroup_prefix(ac_off, diff, mcu_layout):
    """Program F's (MCU, block of the MCU) outputs -> component-major
    (AC offsets, absolute DCs), the order of native.index_scan."""
    import torch

    offs, dcs, base = [], [], 0
    for (_, bpm, _, _) in mcu_layout:
        offs.append(ac_off[:, base:base + bpm].reshape(-1))
        dcs.append(torch.cumsum(diff[:, base:base + bpm].reshape(-1),
                                0).to(torch.int32))
        base += bpm
    return torch.cat(offs).contiguous(), torch.cat(dcs).contiguous()


@pytest.fixture
def jax_exact_sharded(jax_exact_transform):
    """jax_exact_transform for jpeg_tpu.parallel as well: the four cached
    shard_map builders of jpeg_tpu/parallel/shard.py are cleared on entry
    and on exit, so that the sharded programs trace under the exact
    transform and no other test sees them."""
    import jpeg_tpu.parallel.shard as JS

    builders = (JS._build_sharded_packed_fn, JS._build_sharded_hist_fn,
                JS._build_sharded_fn, JS._build_sharded_decode)
    for b in builders:
        b.cache_clear()
    yield
    for b in builders:
        b.cache_clear()


def cpu_mesh(n=8, batch_axis=None):
    """The port's mesh of n positions on the CPU, jpeg_tpu's virtual
    8-device mesh's counterpart."""
    from jpeg_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(n, batch_axis=batch_axis, devices=["cpu"] * n)


def parallel_images(rng, b=4, h=64, w=48):
    """tests/test_parallel.py's images: gradient base + noise in [-12, 12]."""
    yy, xx = np.mgrid[0:h, 0:w]
    grad = np.stack([xx * 255 / w, yy * 255 / h, (xx + yy) * 128 / (h + w)],
                    -1)
    noise = rng.integers(-12, 13, size=(b, h, w, 3))
    return np.clip(grad[None] + noise, 0, 255).astype(np.uint8)
