#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (jpeg_tpu_torch) on one GPU.

Usage, from the repository root, on a machine with a CUDA device:

    python3 chip_smoke.py

Phases, each reported on its own line:
  1. require a CUDA device (exit 2 without one, or without the package);
  2. print the card's name and power limit (nvidia-smi);
  3. build both CUDA kernels from csrc/ with nvcc for sm_90a, and the native
     entropy runtime, and print the build seconds and ptxas resource use;
  4. kernel A (packer level 1) against its plain twin on the card: random
     blocks at AC densities 0, 0.15 and 0.3, and the 4K image's blocks;
  5. kernel B (dequant + IDCT) against its plain twin at the 4K plane shapes;
  6. the main path: a 3840x2160 q75 4:2:0 encode and decode through
     jpeg_tpu_torch.encode/decode on the card, with every launch counter
     reset first; the bytes must equal the port's CPU encode, the pixels the
     port's CPU decode to +-1 in <= 0.5% of samples;
  7. smaller encodes (4:4:4 1001x777, 4:2:2, aligned restarts) byte-identical
     to the CPU path;
  8. median timings over warm runs: encode, decode, each kernel and its
     plain twin on the card.
Then one JSON line of the kernels, and last {"ok": true, "device": ...}.
Any failed phase exits 1.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

DEVICE = "cuda"
HEIGHT, WIDTH = 2160, 3840  # bench.py's 4K image
QUALITY, SUBSAMPLING = 75, "420"
WARM, RUNS = 2, 7
DIFF_SHARE = 0.005  # decoded samples allowed to differ by 1 from the CPU path


class PhaseError(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def make_image(h, w, seed=0):
    """Gradient + uniform noise in [-10, 10] (bench.make_image's formula)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    grad = np.stack(
        [xx * 255 / w, yy * 255 / h, (xx + yy) * 128 / (h + w)], axis=-1
    )
    noise = rng.integers(-10, 11, size=(h, w, 3))
    return np.clip(grad + noise, 0, 255).astype(np.uint8)


def random_blocks(rng, n, density):
    blocks = np.zeros((n, 64), dtype=np.int32)
    mask = rng.random((n, 64)) < density
    blocks[mask] = rng.integers(-200, 201, size=mask.sum())
    blocks[:, 0] = rng.integers(-800, 800, size=n)
    return blocks


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def psnr(a, b) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


def median_ms_host(fn, torch):
    """Median wall ms of fn() over RUNS warm runs, synchronized."""
    for _ in range(WARM):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(RUNS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def median_ms_device(fn, torch):
    """Median device ms of fn() over RUNS warm runs, by CUDA events."""
    for _ in range(WARM):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end))
    return statistics.median(ts)


def level1_err(got, ref, budget):
    """Kernel A's contract: totals equal everywhere, words equal for blocks
    within the budget. Returns (max |diff| over those, blocks compared)."""
    gb, gt = (t.cpu().numpy() for t in got)
    rb, rt = (t.cpu().numpy() for t in ref)
    err = int(np.abs(gt.astype(np.int64) - rt).max(initial=0))
    fits = rt <= budget
    gw = gb.view(np.uint32)[fits].astype(np.int64)
    rw = rb.view(np.uint32)[fits].astype(np.int64)
    err = max(err, int(np.abs(gw - rw).max(initial=0)))
    return err, int(gt.shape[0])


def run(card: str) -> dict:
    import torch

    import jpeg_tpu_torch
    from jpeg_tpu_torch.config import Subsampling
    from jpeg_tpu_torch.entropy import huffman, native
    from jpeg_tpu_torch.io import jfif
    from jpeg_tpu_torch.models import encoder, layout
    from jpeg_tpu_torch.ops import _cuda, bitpack, fused, pack, quant, tile, zigzag

    dev = torch.device(DEVICE)

    # Phase 3: builds.
    t0 = time.perf_counter()
    native._load()
    print(f"phase 3: native entropy runtime built/loaded in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name in ("pack_level1", "idct8"):
        t0 = time.perf_counter()
        _cuda.load(name)
        secs = time.perf_counter() - t0
        log = _cuda.BUILD_LOG.get(name, (secs, "(library up to date)"))[1]
        usage = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "bytes stack" in ln]
        print(f"phase 3: built {name} in {secs:.2f} s: {' | '.join(usage)}",
              flush=True)

    img = make_image(HEIGHT, WIDTH)
    mode = Subsampling(SUBSAMPLING)
    htables = huffman.standard_tables()
    luts_np = bitpack.luts_from_tables(htables)
    luts = tuple(torch.as_tensor(a.astype(np.int32), device=dev)
                 for a in luts_np)
    budget = bitpack.BLOCK_WORDS * 32

    # The port's own CPU path: the references for the card's bytes/pixels.
    t0 = time.perf_counter()
    jpg_cpu = jpeg_tpu_torch.encode(img, QUALITY, SUBSAMPLING, device="cpu")
    px_cpu = jpeg_tpu_torch.decode(jpg_cpu, device="cpu")
    print(f"phase 4: CPU reference encode+decode in "
          f"{time.perf_counter() - t0:.2f} s ({len(jpg_cpu)} bytes)", flush=True)

    # Phase 4: kernel A vs plain.
    rng = np.random.default_rng(0)
    err_a, n_a = 0, 0
    cases = [(random_blocks(rng, 65536, d), f"random density {d}")
             for d in (0.0, 0.15, 0.3)]
    dimg = tile.pad_to_multiple(torch.as_tensor(img, device=dev),
                                mode.mcu_height, mode.mcu_width)
    blocks4k, tbl4k, _, _ = encoder._interleaved_blocks(
        dimg, quant.luma_table(QUALITY), quant.chroma_table(QUALITY), mode, 0)
    for blocks_np, label in cases:
        blocks = torch.as_tensor(blocks_np, device=dev)
        tbl = torch.as_tensor((rng.random(len(blocks_np)) < 0.5).astype(np.int32),
                              device=dev)
        e, n = level1_err(pack.pack_level1(blocks, tbl, *luts),
                          pack.pack_level1_reference(blocks, tbl, *luts), budget)
        print(f"phase 4: kernel A vs plain, {label}: {n} blocks, max |err| {e}",
              flush=True)
        err_a, n_a = max(err_a, e), n_a + n
    got4k = pack.pack_level1(blocks4k, tbl4k, *luts)
    e, n = level1_err(got4k, pack.pack_level1_reference(blocks4k, tbl4k, *luts),
                      budget)
    over = int((got4k[1] > budget).sum())
    print(f"phase 4: kernel A vs plain, 4K q{QUALITY} {SUBSAMPLING} blocks: {n} "
          f"blocks ({over} over {budget} bits), max |err| {e}", flush=True)
    err_a = max(err_a, e)
    check(err_a == 0, f"kernel A disagrees with its plain twin (max {err_a})")

    # Phase 5: kernel B vs plain at the 4K plane shapes, on the 4K stream's
    # own coefficients.
    info = jfif.parse_jpeg(jpg_cpu)
    comps = info.components
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    mcu_rows = layout.ceil_div(info.height, 8 * vmax)
    mcu_cols = layout.ceil_div(info.width, 8 * hmax)
    scans = native.decode_scan(
        info.scan_data, mcu_rows * mcu_cols,
        [(i, c.h * c.v, c.dc_id, c.ac_id) for i, c in enumerate(comps)],
        info.htables, info.restart_interval)
    planes = []
    for c, s in zip(comps, scans):
        raster = layout.scan_to_raster(s, mcu_rows, mcu_cols, c.v, c.h)
        zz = torch.as_tensor(raster, device=dev).reshape(
            mcu_rows * c.v, mcu_cols * c.h, 64)
        qt = torch.as_tensor(info.qtables[c.qtab_id], dtype=torch.float32,
                             device=dev)
        planes.append((tile.unblockify(zigzag.from_zigzag(zz)), qt))
    err_b = 0.0
    for coeffs, qt in planes:
        got = fused.fused_dequant_idct(coeffs, qt)
        ref = fused.fused_dequant_idct_reference(coeffs, qt)
        e = float((got - ref).abs().max())
        print(f"phase 5: kernel B vs plain, plane {tuple(coeffs.shape)}: "
              f"max |err| {e:.3g}", flush=True)
        err_b = max(err_b, e)
    check(err_b <= 1e-2, f"kernel B disagrees with its plain twin ({err_b})")

    # Phase 6: the main path, counted.
    torch.cuda.synchronize()
    pack.LAUNCHES = 0
    fused.LAUNCHES = 0
    encoder.HOST_PACK_SPILLS = 0
    jpg = jpeg_tpu_torch.encode(img, QUALITY, SUBSAMPLING, device=dev)
    px = jpeg_tpu_torch.decode(jpg, device=dev)
    torch.cuda.synchronize()
    launches_a, launches_b = pack.LAUNCHES, fused.LAUNCHES
    spills = encoder.HOST_PACK_SPILLS
    print(f"phase 6: 4K q{QUALITY} {SUBSAMPLING}: {len(jpg)} bytes; launches: "
          f"kernel A {launches_a}, kernel B {launches_b}; host-pack spills "
          f"{spills}", flush=True)
    check(launches_a >= 1, "kernel A did not launch on the main path")
    check(launches_b >= 3, "kernel B launched fewer than 3 times")
    check(spills == 0, f"{spills} host-pack spills on the main path")
    check(jpg == jpg_cpu, "CUDA encode bytes differ from the CPU encode")
    check(px.shape == (HEIGHT, WIDTH, 3) and px.dtype == np.uint8,
          f"decoded {px.shape} {px.dtype}")
    diff = np.abs(px.astype(np.int32) - px_cpu.astype(np.int32))
    ndiff = int((diff != 0).sum())
    print(f"phase 6: encode bytes equal the CPU path's; decode vs CPU decode: "
          f"max |diff| {int(diff.max())}, {ndiff} of {diff.size} samples differ; "
          f"PSNR vs source {psnr(px, img):.2f} dB", flush=True)
    check(int(diff.max()) <= 1, "decode differs from the CPU decode by > 1")
    check(ndiff <= DIFF_SHARE * diff.size, "too many decode differences")

    # Phase 7: smaller encodes, byte-identical to the CPU path.
    for (h, w), sub, r in (((777, 1001), "444", 0), ((480, 640), "422", 0),
                           ((768, 1024), "420", 4)):
        im = make_image(h, w, seed=h)
        a = jpeg_tpu_torch.encode(im, QUALITY, sub, r, device=dev)
        b = jpeg_tpu_torch.encode(im, QUALITY, sub, r, device="cpu")
        print(f"phase 7: {w}x{h} {sub} restart {r}: {len(a)} bytes, "
              f"equal to CPU: {a == b}", flush=True)
        check(a == b, f"{w}x{h} {sub} r={r}: CUDA bytes differ from CPU")
    check(encoder.HOST_PACK_SPILLS == 0, "host-pack spill in phase 7")

    # Phase 8: timings.
    mpix = HEIGHT * WIDTH / 1e6
    ms_enc = median_ms_host(
        lambda: jpeg_tpu_torch.encode(img, QUALITY, SUBSAMPLING, device=dev),
        torch)
    ms_dec = median_ms_host(lambda: jpeg_tpu_torch.decode(jpg, device=dev),
                            torch)
    luma, qluma = planes[0]
    ms_a = median_ms_device(lambda: pack.pack_level1(blocks4k, tbl4k, *luts),
                            torch)
    ms_a_plain = median_ms_device(
        lambda: pack.pack_level1_reference(blocks4k, tbl4k, *luts), torch)
    ms_b = median_ms_device(lambda: fused.fused_dequant_idct(luma, qluma), torch)
    ms_b_plain = median_ms_device(
        lambda: fused.fused_dequant_idct_reference(luma, qluma), torch)
    for label, ms in (
        (f"encode 4K q{QUALITY} {SUBSAMPLING} end to end", ms_enc),
        (f"decode 4K q{QUALITY} {SUBSAMPLING} end to end", ms_dec),
    ):
        print(f"phase 8: {label}: {ms:.3f} ms median of {RUNS} "
              f"({mpix / ms * 1e3:.1f} MPix/s) [{card}]", flush=True)
    for label, ms, plain in (
        (f"kernel A pack_level1, {blocks4k.shape[0]} blocks", ms_a, ms_a_plain),
        (f"kernel B idct8, {tuple(luma.shape)} plane", ms_b, ms_b_plain),
    ):
        print(f"phase 8: {label}: {ms:.4f} ms; plain twin on the card "
              f"{plain:.4f} ms; median of {RUNS} [{card}]", flush=True)

    return {"kernels": [
        {"name": "pack_level1", "route": "cuda",
         "source": "jpeg_tpu_torch/csrc/pack_level1.cu",
         "replaces": "jpeg_tpu/ops/pack_pallas.py:82",
         "launches": launches_a, "max_abs_err": err_a,
         "ms": ms_a, "plain_ms": ms_a_plain},
        {"name": "idct8", "route": "cuda",
         "source": "jpeg_tpu_torch/csrc/idct8.cu",
         "replaces": "jpeg_tpu/ops/fused.py:69",
         "launches": launches_b, "max_abs_err": err_b,
         "ms": ms_b, "plain_ms": ms_b_plain},
    ]}


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch unavailable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    print(f"phase 1: CUDA device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}", flush=True)
    try:
        import jpeg_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the jpeg_tpu_torch package is missing: {e}",
              file=sys.stderr)
        return 2
    card = card_line()
    print(f"phase 2: {card}", flush=True)
    try:
        kernels = run(card)
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(card)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
