#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (jpeg_tpu_torch) on one GPU.

Usage, from the repository root, on a machine with a CUDA device:

    python3 chip_smoke.py

Phases, each reported on its own line:
  1. require a CUDA device (exit 2 without one, or without the package);
  2. print the card's name and power limit (nvidia-smi);
  3. build the six CUDA kernel sources from csrc/ with nvcc for sm_90a (one
     nvcc each, all started together) and the native entropy runtime, and print
     the build seconds and ptxas resource use;
  4. kernel A (packer level 1) against its plain twin on the card: random
     blocks at AC densities 0, 0.15 and 0.3, the adversarial blocks of
     tests/torch_port_util.py at five ragged sizes, and the 4K image's
     blocks at q75 and at q95 (dense);
     4b: with optimal tables of a skewed histogram (codes of 16 bits, a ZRL
     code other than the standard one);
  5. kernel B (dequant + IDCT) against its plain twin at the 4K plane shapes
     and on the adversarial planes of tests/torch_port_util.py;
     5b: kernel C (level shift + DCT + quantize) against its plain twin on
     the 4K Y, Cb and Cr planes at q75 and q95, a uniform-random plane and a
     ragged width (2160x3848): 0 coefficients apart, and within the
     kernel's contract of the twin run on the CPU (a second witness);
     5c: the device Huffman decoders against their plain twins, 0 apart:
     kernel D (AC decode at known block starts) and the chunked block-start
     program, as program F (no restart markers) and as E's route (anchored
     at every restart segment, then the DC sums and kernel D), on seeded
     small streams (4:2:0, 4:4:4, 4:2:2, gray, with and without restarts,
     standard and optimal tables), E's route over a restart-free stream as
     one segment against F + D, and at full width: D's rows of the 4K
     stream equal native.decode_scan's; on the eight frames of
     sync_frames (the 4K stream, a solid black frame, 280-row black bars,
     gray, q95, restart intervals of 240, 960 and 1 MCU) F's offsets and
     cumulated DCs equal native.index_scan's and E's rows
     native.decode_scan's, each with its resolve rounds (SYNC_PASSES) and
     its time alone, and decode(entropy="device") equals "sparse" exactly;
     5d: the decode finish's kernels against their plain twins, 0 apart:
     kernel B2 (zig-zag blocks in, uint8 samples out; also equal to kernel
     B rounded and clamped) on the decoder's blocks of the 4K 4:2:0, 4:4:4,
     4:2:2 and gray streams, 1001x777 4:2:0 and 4:4:4 (a crop) and the K = 4
     stack decode_batched makes, one component at a time in raster order
     and all components in one launch in the entropy decoder's scan order
     (the K = 4 stack as decode_batched's (4, B, 64) rows, read at their
     stride); kernel H (upsample, colour, round, clip, crop) on the colour
     ones, on the scale_denom 2/4/8 samples, and on every ratio pair in
     {1, 2, 3, 4}^2 on small planes (fancy and not, YCbCr and RGB, 1 and 3
     images, crops for byte, word and 8-byte stores); each of those decodes
     (decode_batched for the stack) equal, byte for byte, to the old route
     composed from the decoder's blocks and the twins on the card; the 4K
     finish on scan-order blocks counted by torch.profiler: 2 kernel
     launches (B2, H);
  6. the main path: a 3840x2160 q75 4:2:0 encode and decode through
     jpeg_tpu_torch.encode/decode on the card, with every launch counter
     reset first (encode: kernel A once; decode: program F (five launches)
     and kernel D once each, since entropy="auto" is the "device" backend on
     a card, kernel B2 once and kernel H once, kernel B never, and no
     scan -> raster copy); the bytes must equal the port's CPU encode, the
     pixels the
     port's CPU decode to +-1 in <= 0.5% of samples;
     6b: the same image through encode(use_pallas=True) (kernel C, host
     pack), counted: kernel C 3 launches, kernel A none; coefficients within
     kernel C's contract of the CPU's, PSNR within 0.1 dB of 6's;
     6c: optimize_tables, on the card with the device pack and with the host
     pack and on the CPU: the same bytes, the optimal tables in the stream;
     6d: restart interval 7, which does not divide the MCU count: card bytes
     equal CPU bytes;
     6e: the image's Y plane as a gray image: card bytes equal CPU bytes,
     the card decode within +-1 of the CPU decode in <= 0.5% of samples;
     6f: the decode options on the 4K colour and gray streams, counted:
     entropy="sparse" and "native" (kernel B2 1 launch each and H 1; gray
     B2 1 and H none; kernels A, B and C none; all counts read after every
     decode here),
     pixels exactly equal; the payload's bytes beside the dense grids';
     scale_denom 2, 4, 8 against the CPU decode; output="ycbcr" +
     finish_ycbcr == decode() exactly; device_output a tensor on cuda:0
     equal to the host result; entropy="indexed" and "device" on the
     colour, gray and restart-240 streams, counted (kernel D once per
     indexed decode; E's route and kernel D once each per decode with
     restarts; program F and kernel D once each without), pixels exactly
     equal to "sparse"; a 4K
     scan with one flipped byte through "sparse", "indexed" and "device":
     all raise ScanDecodeError or all give the same pixels; the colour and
     gray streams with use_pallas=False (jpeg_tpu's default formulation:
     one (64, 64) matmul per plane): kernel B2 never launched (once by the
     default decode; H still once for colour), the samples after the
     IDCT (gray pixels,
     colour output="ycbcr" planes) within +-1 in <= 0.5% of the default
     decode's, the colour pixels within 3 (a chroma level moves R or B by up
     to 1.772) in <= 0.5%, the two forms timed in turns (medians of 7);
     6g: the committed fixture streams (tests/data/torch_port: progressive,
     non-interleaved, CMYK, YCCK), card decode against CPU decode; the
     non-interleaved one also with "indexed" and "device";
     6h: encode_batched, K = 8 distinct 4K images (the image rolled by
     k * 97 columns): every stream equals encode() of its image on the card,
     kernel A launched once for the batch and the scan pass once per
     image, kernel C never, no spill; K = 3
     at 1001x777 4:4:4 with a restart interval of one MCU row; K = 2 with
     device_pack=False; kernel A against its plain twin on the blocks those
     two device-packed batches give it (1,555,200 for K = 8);
     6i: decode_batched, K = 4 of those streams: "fused", "pipelined" and
     "auto" each equal the stacked per-image decode() exactly, kernel B2 1
     launch and H 1 fused, 4 and 4 pipelined; scale_denom=2; device_output
     a tensor
     on cuda:0; a stream of another size raises ValueError; kernel B
     against its plain twin on the batch's stacked planes (8640x3840 and
     4320x1920);
     6j: encode_stream, 64 distinct 4K images from a generator, depth 2:
     every stream equals encode() of its image (by hash), kernel A 64
     launches; then 4 images of mixed sizes with optimize_tables;
     6k: decode_stream, 16 of those streams at depth 2 and 4: pixels equal
     per-image decode() exactly and in order, kernel B2 16 launches and H 16
     counted under the workers' threads; a stream of another geometry in
     the middle;
     once at depth 4 with entropy="indexed" (kernel D 16 launches);
     6l: encode_noninterleaved at 4K and encode_progressive at 1024x768
     4:2:0 and 640x480 gray: card bytes equal CPU bytes, the card decode
     equals the decode of the baseline stream of the same image exactly;
     6m: the mesh layer (jpeg_tpu_torch.parallel) on the one card:
     make_mesh() is (1, 1); on a (2, 3) mesh of six positions on cuda:0,
     the K = 8 frames of 6h: encode_batch without stripe restarts (DC by
     ppermute, host pack) equals encode() per image; with stripe restarts
     the device pack (kernel A once per position) and the host pack equal
     encode(restart_interval=10800), no device-pack fallback; with
     optimize_tables device pack == host pack; decode_batch with "auto"
     (kernel B 18 launches, D 8, F 8) and "sparse" equals the stacked
     decode() exactly; kernels A and B against their twins on position
     (0, 0)'s stripe; encode_mosaic of 2x2 4K tiles (7680x4320) on a (1, 6)
     mesh, device and host pack, equals encode(restart_interval=21600);
     6p: the mesh over torch.distributed ranks (make_multihost_mesh): this
     script again with --rank as 2 gloo ranks of 3 positions each on
     cuda:0, then as 1 NCCL rank of 6 positions; every rank drives
     encode_batch (device pack, host pack without stripe restarts,
     optimize_tables) and decode_batch "auto" on (2, 3), encode_mosaic of
     the 2x2 4K tiles and decode_batch of its stream on (1, 6), each path
     counted once (per rank: kernel A once per position, B three times, D
     and F once per image of its batch rows) and then timed; every rank's
     streams and pixels hash equal to 6m's, and it prints the bytes that
     reached it from the other rank;
     6n: encode_mosaic_stream of 4x4 4K tiles (15360x8640, 132.7 MPix) from
     a source callable, a restart segment per MCU row: hash equal to
     encode(restart_interval=960), kernel A once per stripe, the peak device
     memory of each (the stream's under a quarter of the whole image's);
     then the two-pass optimize_tables at 2x2;
     6o: python -m jpeg_tpu_torch, every subcommand in a subprocess of its
     own (all started together) on 4K BMPs in a temporary folder: the
     outputs equal the library calls', encode --trace-dir writes a trace;
  7. smaller encodes (4:4:4 1001x777, 4:2:2, aligned restarts) byte-identical
     to the CPU path;
  8. median timings over warm runs: encode (default, use_pallas,
     optimize_tables, gray), decode (colour, gray; sparse and native, each
     also by stage; scaled; ycbcr planes + host finish; the host cost of
     packing dense grids into the sparse payload); each kernel's wrapper
     call and its plain twin on the card (CUDA events around one call); and
     each kernel alone (kernel_only_us: events around a graph of 20 launches
     on prepared buffers, L2 cold) beside the bytes it must move and the
     time the card's memory needs for them (B2 on the three components'
     blocks in one launch, and on the Y and a chroma plane's alone; H on
     the 4K image); the 4K finish in turns four ways (kernel B + torch ops
     as before B2 and H, the twins on the card, the scan -> raster copy and
     a B2 launch per component + H, B2 + H) and the 4K decode end to end in
     turns with the finish before B2 and H and with B2 + H, also by stage
     (with each of the three finishes); the scan -> raster reorders of every
     counted path through B2 (0); kernel B's library call, one
     torch.addmm of the Y and a chroma plane's f32 blocks against
     diag(q) @ kron(D, D), timed the same way, and for kernel C the addmm
     of its scaled DCT alone (the rounding is further calls);
     encode_batched (K = 8, with its peak device memory), decode_batched (K = 4, fused and pipelined in
     turns), encode_stream (32 images) and decode_stream (16 streams) at
     depth 1, 2 and 4, each in ms per image beside the single call's; the
     host index pass beside the host sparse walk; decode by "sparse",
     "indexed" and "device" in turns, end to end and by stage, on the 4K
     stream, the restart-240 and the restart-960 one and the two flat
     frames, and decode_stream at depth 4 with each; kernel D, E's route and
     every launch of program F alone; in turns, encode_batch on the (2, 3)
     mesh against encode_batched K=8, decode_batch against decode_batched
     K=8 (ms per image), and encode_mosaic_stream of the 4x4 tiles against
     encode() of the whole image (MPix/s).
Then one JSON line of the kernels, and last {"ok": true, "device": ...}.
Any failed phase exits 1.
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

DEVICE = "cuda"
HEIGHT, WIDTH = 2160, 3840  # bench.py's 4K image
QUALITY, SUBSAMPLING = 75, "420"
WARM, RUNS = 2, 7
DIFF_SHARE = 0.005  # decoded samples allowed to differ by 1 from the CPU path
KERNELS = ("pack_level1", "idct8", "dct8", "ac_indexed", "finish_color",
           "pack_scan", "scan_decode")
KERNEL_LAUNCHES = 20  # launches per timed replay of kernel_only_us
COLD_BYTES = 200_000_000  # moved between two uses of a buffer; the L2 holds 50 MB
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
UNALIGNED_RESTART = 7  # does not divide the 4K 4:2:0 image's 32,400 MCUs
ROW_RESTART = 240  # one MCU row of the 4K 4:2:0 image: 135 restart segments
TURN_RUNS = 5  # timed rounds of a comparison in turns (1 warm round before)
BATCH_ENCODE, BATCH_DECODE = 8, 4  # images per encode_batched / decode_batched
STREAM_ENCODE, STREAM_DECODE = 32, 16  # images per encode_stream / decode_stream
STREAM_RUNS = 3  # timed runs of encode_stream at each depth (1 warm run before)
ROLL = 97  # columns between two frames of a batch or a stream
RANK_POSITIONS = 6  # phase 6p: positions of each mesh, spread over the ranks
RANK_TIMEOUT_S = 180  # phase 6p: a rank's collectives, its init included
RANK_WAIT_S = 360  # phase 6p: one process group's ranks, start to exit
RANK_RUNS = 3  # phase 6p: timed runs of each path after its counted run
# Launches (A, B, C, B2, H) of one call of a path.
NONE_N = (0, 0, 0, 0, 0)
ENCODE_N = (1, 0, 0, 0, 0)  # an encode: kernel A once
COLOUR_N = (0, 0, 0, 1, 1)  # a colour decode: B2 once for all, then H
GRAY_N = (0, 0, 0, 1, 0)  # a gray decode: B2 once


class PhaseError(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def times(n: int, counts: tuple) -> tuple:
    return tuple(n * c for c in counts)


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


def sync_frames(img):
    """name -> (image, encode keyword arguments): the 4K frames the
    block-start program is held to and timed on (phase 5c; also
    kernel_compare.py): the default stream, flat content (a solid black
    frame, 280-row black bars), gray, q95, and restart intervals of one MCU
    row, four rows and one MCU."""
    bars = img.copy()
    bars[:280] = 0
    bars[-280:] = 0
    return {
        "4K": (img, {}),
        "4K solid black": (np.zeros_like(img), {}),
        "4K 280-row black bars": (bars, {}),
        "4K gray": (img[..., 0], {}),
        "4K q95": (img, {"quality": 95}),
        f"4K restart {ROW_RESTART}": (img, {"restart_interval": ROW_RESTART}),
        f"4K restart {4 * ROW_RESTART}": (
            img, {"restart_interval": 4 * ROW_RESTART}),
        "4K restart 1": (img, {"restart_interval": 1}),
    }


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


def rotation(nbytes: int) -> int:
    """Buffer sets to cycle through so that a launch finds none of its
    bytes in the L2: at least 4, and at least COLD_BYTES between reuses."""
    return max(4, -(-COLD_BYTES // nbytes))


def kernel_only_us(launch, nbuf: int, torch) -> float:
    """Kernel-only device time in us. launch(i) enqueues one launch of the
    kernel on buffer set i (0 <= i < nbuf) through the wrapper module's thin
    launch helper, with inputs, outputs and tables prepared beforehand.
    KERNEL_LAUNCHES launches, cycling over the buffer sets so that the L2 is
    cold, are captured into one CUDA graph (no host time between them);
    CUDA events time a replay, divided by the launch count; median of RUNS
    replays."""
    for i in range(nbuf):
        launch(i)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(KERNEL_LAUNCHES):
            launch(i % nbuf)
    graph.replay()
    torch.cuda.synchronize()
    ts = []
    for _ in range(RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end) * 1e3 / KERNEL_LAUNCHES)
    return statistics.median(ts)


def level1_bytes(nblocks: int) -> int:
    """Bytes kernel A must move: per block 64 int32 coefficients and a table
    id in, 10 words and a bit total out."""
    return nblocks * (64 * 4 + 4 + 10 * 4 + 4)


def plane_bytes(h: int, w: int) -> int:
    """Bytes kernels B and C must move: 4 in and 4 out per sample."""
    return h * w * 8


def bound_us(nbytes: int) -> float:
    """The least time the card's memory could take to move nbytes."""
    return nbytes / HBM_BYTES_PER_S * 1e6


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


def coef_diff(got, ref):
    """Kernel C's contract: (max |diff|, coefficients differing, bound on
    that count, n)."""
    d = (got.cpu().long() - ref.cpu().long()).abs()
    n = d.numel()
    return int(d.max()), int((d != 0).sum()), max(8, 5e-4 * n), n


def decode_diff(got, ref):
    """The decode contract against the CPU path: (max |diff|, samples
    differing, samples); raises unless within +-1 in <= DIFF_SHARE."""
    check(got.shape == ref.shape and got.dtype == np.uint8,
          f"decoded {got.shape} {got.dtype}, expected {ref.shape}")
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    worst, ndiff = int(diff.max(initial=0)), int((diff != 0).sum())
    check(worst <= 1, f"decode differs from the CPU decode by {worst}")
    check(ndiff <= DIFF_SHARE * diff.size,
          f"{ndiff} of {diff.size} samples differ from the CPU decode")
    return worst, ndiff, diff.size


def stage_medians(stages, torch):
    """stages: [(name, fn)], each fn taking the previous stage's result.
    Runs the chain WARM + RUNS times with a synchronize after every stage;
    returns {name: median ms} (host clock)."""
    times = {name: [] for name, _ in stages}
    for run in range(WARM + RUNS):
        value = None
        for name, fn in stages:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            value = fn(value)
            torch.cuda.synchronize()
            if run >= WARM:
                times[name].append((time.perf_counter() - t0) * 1e3)
    return {name: statistics.median(ts) for name, ts in times.items()}


def medians_in_turns(forms: dict, torch, runs=TURN_RUNS):
    """forms: {name: fn}. One warm round, then `runs` rounds in which every
    form runs once, the order rotating from round to round, so that a drift
    of the host hits all of them; each run ends in a synchronize. Returns
    {name: median wall ms}."""
    names = list(forms)
    ts = {name: [] for name in names}
    for rnd in range(1 + runs):
        k = rnd % len(names)
        for name in names[k:] + names[:k]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            forms[name]()
            torch.cuda.synchronize()
            if rnd >= 1:
                ts[name].append((time.perf_counter() - t0) * 1e3)
    return {name: statistics.median(v) for name, v in ts.items()}


def int_err(got, ref) -> int:
    """max |got - ref| of two integer tensors of one shape."""
    check(got.shape == ref.shape, f"shapes {got.shape} and {ref.shape}")
    return int((got.long() - ref.long()).abs().max()) if got.numel() else 0


def timed(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def build_all():
    """Phase 3: nvcc for every kernel and the native runtime, in parallel."""
    from jpeg_tpu_torch.entropy import native
    from jpeg_tpu_torch.ops import _cuda

    with ThreadPoolExecutor(len(KERNELS) + 1) as ex:
        nat = ex.submit(timed, native._load)
        futs = {name: ex.submit(timed, _cuda.load, name) for name in KERNELS}
        print(f"phase 3: native entropy runtime built/loaded in "
              f"{nat.result()[1]:.2f} s", flush=True)
        for name, fut in futs.items():
            secs = fut.result()[1]
            log = _cuda.BUILD_LOG.get(name, (secs, "(library up to date)"))[1]
            usage = [ln.strip() for ln in log.splitlines()
                     if "registers" in ln or "bytes stack" in ln]
            print(f"phase 3: built {name} in {secs:.2f} s: {' | '.join(usage)}",
                  flush=True)


def reset_counts():
    """Every kernel's launch count, and the scan -> raster reorders, to 0,
    once the card is idle."""
    import torch

    from jpeg_tpu_torch.models import layout
    from jpeg_tpu_torch.ops import entropy_decode, finish, fused, pack

    torch.cuda.synchronize()
    layout.SCAN_TO_RASTER_CALLS = 0
    pack.LAUNCHES = 0
    fused.LAUNCHES = 0
    fused.DCT_LAUNCHES = 0
    fused.ZZ_LAUNCHES = 0
    finish.LAUNCHES = 0
    entropy_decode.AC_LAUNCHES = 0
    entropy_decode.SEGMENT_LAUNCHES = 0
    entropy_decode.PREFIX_LAUNCHES = 0
    entropy_decode.PREFIX_STAGE_LAUNCHES = 0
    entropy_decode.NATIVE_SCANS = 0
    entropy_decode.DC_SUM_LAUNCHES = 0


def read_counts():
    """((A, B, C, B2, H), (D, E, F, F's separate launches, native scan
    calls, DC-sum launches)) since the reset."""
    import torch

    from jpeg_tpu_torch.ops import entropy_decode, finish, fused, pack

    torch.cuda.synchronize()
    return ((pack.LAUNCHES, fused.LAUNCHES, fused.DCT_LAUNCHES,
             fused.ZZ_LAUNCHES, finish.LAUNCHES),
            (entropy_decode.AC_LAUNCHES, entropy_decode.SEGMENT_LAUNCHES,
             entropy_decode.PREFIX_LAUNCHES,
             entropy_decode.PREFIX_STAGE_LAUNCHES,
             entropy_decode.NATIVE_SCANS, entropy_decode.DC_SUM_LAUNCHES))


def hash_streams(streams) -> str:
    """One digest of a list of JFIF streams, in order."""
    return hashlib.sha256(b"".join(hashlib.sha256(s).digest()
                                   for s in streams)).hexdigest()


def hash_pixels(px) -> str:
    """One digest of a pixel array, its shape included."""
    return hashlib.sha256(repr(px.shape).encode()
                          + np.ascontiguousarray(px).tobytes()).hexdigest()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_paths(pbatch, pmosaic, mesh23, mesh16):
    """Phase 6p's paths on a rank: (name, call, digest of the result). A
    call takes the results of the paths before it, by name: the decodes
    decode the encodes' streams."""
    img = make_image(HEIGHT, WIDTH)
    batch8 = np.stack([np.roll(img, i * ROLL, axis=1)
                       for i in range(BATCH_ENCODE)])
    big4 = pmosaic.assemble_tiles(batch8[:4].reshape(2, 2, HEIGHT, WIDTH, 3))
    return (
        ("encode_batch", lambda done: pbatch.encode_batch(
            batch8, QUALITY, SUBSAMPLING, mesh=mesh23, device_pack=True),
         hash_streams),
        ("encode_batch_no_restart", lambda done: pbatch.encode_batch(
            batch8, QUALITY, SUBSAMPLING, mesh=mesh23, stripe_restart=False),
         hash_streams),
        ("encode_batch_optimize", lambda done: pbatch.encode_batch(
            batch8, QUALITY, SUBSAMPLING, mesh=mesh23, device_pack=True,
            optimize_tables=True), hash_streams),
        ("decode_batch", lambda done: pbatch.decode_batch(
            done["encode_batch_no_restart"], mesh=mesh23), hash_pixels),
        ("encode_mosaic", lambda done: [pmosaic.encode_mosaic(
            big4, QUALITY, SUBSAMPLING, mesh=mesh16, device_pack=True)],
         hash_streams),
        ("decode_mosaic", lambda done: pbatch.decode_batch(
            done["encode_mosaic"], mesh=mesh16), hash_pixels),
    )


def rank_main(address: str, world: str, rank: str, backend: str,
              out: str) -> int:
    """One rank of phase 6p: `chip_smoke.py --rank ADDRESS WORLD RANK
    BACKEND OUT`. Joins the process group, holds RANK_POSITIONS / WORLD
    positions on cuda:0 of the (2, 3) and (1, 6) meshes of
    make_multihost_mesh, and drives every path of rank_paths: once counted
    (launches of every kernel, wall ms, bytes from other ranks), then
    RANK_RUNS times timed, all ranks starting each run together; then the
    stages of decode_batch on (2, 3) (stage_medians). Writes {"paths":
    {path: {"hash", "launches", "first_ms", "ms", "xrank_bytes"}},
    "decode_stages": {stage: median ms}} to OUT as JSON."""
    import datetime

    import torch
    import torch.distributed as dist

    from jpeg_tpu_torch.config import Subsampling
    from jpeg_tpu_torch.io import jfif
    from jpeg_tpu_torch.parallel import batch as pbatch, mesh as pmesh
    from jpeg_tpu_torch.parallel import mosaic as pmosaic, shard as pshard

    world, rank = int(world), int(rank)
    dev = torch.device(DEVICE, 0)
    dist.init_process_group(
        backend, init_method=f"tcp://{address}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    try:
        n = RANK_POSITIONS // world
        mesh23 = pmesh.make_multihost_mesh(batch_axis=2, devices=[dev] * n,
                                           backend=backend)
        mesh16 = pmesh.make_multihost_mesh(batch_axis=1, devices=[dev] * n,
                                           backend=backend)
        report, done = {}, {}
        for name, fn, digest in rank_paths(pbatch, pmosaic, mesh23, mesh16):
            dist.barrier()
            reset_counts()
            before = pmesh.XRANK_BYTES
            t0 = time.perf_counter()
            done[name] = fn(done)
            torch.cuda.synchronize()
            first = (time.perf_counter() - t0) * 1e3
            abc, huffman_n = read_counts()
            xrank = pmesh.XRANK_BYTES - before
            times = []
            for _ in range(RANK_RUNS):
                dist.barrier()
                t0 = time.perf_counter()
                fn(done)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            report[name] = {"hash": digest(done[name]),
                            "launches": abc + huffman_n,
                            "first_ms": first,
                            "ms": statistics.median(times),
                            "xrank_bytes": xrank}
        # Where decode_batch's time goes on this rank: phase 8's stages of
        # the single-process mesh, the last one now an all_gather too.
        mode = Subsampling(SUBSAMPLING)
        infos = [jfif.parse_jpeg(j) for j in done["encode_batch_no_restart"]]
        mcu_cols = WIDTH // mode.mcu_width
        q = [infos[0].qtables[k] for k in (0, 1)]
        stages = stage_medians([
            ("entropy decodes + stripes to positions",
             lambda _: pbatch._block_grids(infos, mesh23,
                                           HEIGHT // mode.mcu_height,
                                           mcu_cols, "auto")),
            ("per-position finish", lambda g: pshard.sharded_decode_pixels(
                *g, *q, mcu_cols, mesh23, mode)),
            ("to_host", lambda g: pmesh.to_host(g, mesh23)),
        ], torch)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    pathlib.Path(out).write_text(json.dumps({"paths": report,
                                             "decode_stages": stages}))
    return 0


def run_ranks(backend: str, world: int, tmp: str) -> list:
    """Phase 6p's ranks of one process group: this script again, `world`
    subprocesses with --rank, all started together on a free port. Every
    rank must exit 0 within RANK_WAIT_S; the first to fail ends the others.
    Returns each rank's report (rank_main)."""
    port = free_port()
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")  # the ranks meet on lo
    logs = [pathlib.Path(tmp, f"{backend}{r}.log") for r in range(world)]
    outs = [pathlib.Path(tmp, f"{backend}{r}.json") for r in range(world)]
    procs = []
    try:
        for r in range(world):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, str(pathlib.Path(__file__).resolve()),
                     "--rank", f"127.0.0.1:{port}", str(world), str(r),
                     backend, str(outs[r])],
                    stdout=log, stderr=subprocess.STDOUT, env=env))
        deadline = time.monotonic() + RANK_WAIT_S
        while (any(p.poll() is None for p in procs)
               and not any(p.poll() for p in procs)
               and time.monotonic() < deadline):
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            tail = logs[r].read_text()[-3000:]
            check(False, f"phase 6p: {backend} rank {r} of {world} exited "
                  f"{p.returncode}:\n{tail}")
    return [json.loads(o.read_text()) for o in outs]


def skewed_tables(blocks, huffman, symbols, torch):
    """Optimal tables of the blocks' own symbols with geometrically skewed
    counts, so that the length limit binds (codes of 16 bits) and ZRL gets
    a code other than the standard one. Table ids 0 and 1 share them."""
    dc, ac = (h.numpy().astype(np.int64) for h in
              symbols.symbol_histogram(torch.as_tensor(blocks)))
    out = {}
    for is_ac, hist in ((0, dc), (1, ac)):
        skew = np.zeros(256, dtype=np.int64)
        for rank, sym in enumerate(np.flatnonzero(hist)[::-1]):
            skew[sym] = max(1, int(2 ** 40 * 0.55 ** rank))
        t = huffman.optimal_table(skew)
        out[(is_ac, 0)] = out[(is_ac, 1)] = t
    return out


def profiled_kernel_us(fn, name: str, torch) -> float:
    """Median device time in us of the kernel `name` over RUNS calls of
    fn(), by the profiler's trace (after WARM calls)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(WARM):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(RUNS):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    durs = [float(e["dur"]) for e in events if e.get("ph") == "X"
            and e.get("cat") == "kernel" and name in e.get("name", "")]
    return statistics.median(durs) if durs else float("nan")


# Phase 5e's shapes: (MCUs, blocks per MCU of each component, restart
# interval): the camera cell's frame, a 500x375 4:2:0 image (its MCU row as
# the interval when anchored), the 4K 4:2:0 frame and that frame at restart 1.
DC_SUM_SHAPES = {"camera": (16200, [2, 1, 1], 120),
                 "imagenet": (768, [4, 1, 1], 32),
                 "4k": (32400, [4, 1, 1], 240),
                 "4k restart 1": (32400, [4, 1, 1], 1)}


def dc_sum_phase(dev, card: str, torch) -> dict:
    """Phase 5e: the DC sums' one launch (csrc/scan_decode.cu) against its
    twin, the torch sums it replaced, in both modes at the driven shapes,
    0 apart; its kernel time by the profiler and its bytes."""
    from jpeg_tpu_torch.ops import entropy_decode

    out = {}
    for shape, (n_mcu, comp_bpm, interval) in DC_SUM_SHAPES.items():
        bpm = sum(comp_bpm)
        rng = np.random.default_rng(n_mcu + interval)
        diff = torch.as_tensor(rng.integers(-2047, 2048, size=n_mcu * bpm,
                                            dtype=np.int32), device=dev)
        ac_off = torch.as_tensor(rng.integers(0, 2**30, size=(n_mcu, bpm),
                                              dtype=np.int32), device=dev)
        seq = torch.as_tensor(rng.integers(0, 8, size=(bpm, 3),
                                           dtype=np.int32), device=dev)
        for anchored in (True, False):
            d = diff if anchored else diff.view(n_mcu, bpm)
            args = (d, ac_off, seq, comp_bpm, interval, n_mcu, anchored)
            got = entropy_decode.dc_sums(*args)
            want = entropy_decode.dc_sums_reference(*args)
            err = max(int_err(g, w) for g, w in zip(got, want)
                      if w is not None)
            us = profiled_kernel_us(lambda: entropy_decode.dc_sums(*args),
                                    "dc_sum_kernel", torch)
            nbytes = n_mcu * bpm * (12 if anchored else 20)
            mode = "anchored" if anchored else "from bit 0"
            print(f"phase 5e: DC sums, {shape} {mode}: {n_mcu * bpm} blocks; "
                  f"vs plain: max |err| {err}; kernel {us:.2f} us (profiler, "
                  f"median of {RUNS}); {nbytes} bytes, bound "
                  f"{bound_us(nbytes):.2f} us [{card}]", flush=True)
            check(err == 0, f"DC sums {shape} {mode}: max |err| {err}")
            out[f"{shape} {mode}"] = {"blocks": n_mcu * bpm, "kernel_us": us,
                                      "bytes": nbytes,
                                      "bound_us": bound_us(nbytes)}
    return out


def run(card: str) -> dict:
    import torch

    import jpeg_tpu_torch
    from jpeg_tpu_torch.config import EncodeConfig, Subsampling
    from jpeg_tpu_torch.entropy import decode_device, huffman, native
    from jpeg_tpu_torch.io import jfif
    from jpeg_tpu_torch.models import decoder, encoder, layout
    from jpeg_tpu_torch.parallel import pipeline
    from jpeg_tpu_torch.entropy.decode_np import ScanDecodeError
    from jpeg_tpu_torch.ops import (
        bitpack, dct, entropy_decode, finish, fused, mcu_conv, pack, quant,
        symbols, tile, zigzag)

    # The adversarial inputs are shared with the CPU and card tests.
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "tests"))
    import torch_port_fixtures as port_fixtures
    import torch_port_util as port_util

    dev = torch.device(DEVICE)
    started = time.perf_counter()

    def lap(phase: str) -> None:
        """Where the run's time goes: seconds since run() began, printed as
        each phase starts."""
        print(f"clock: {time.perf_counter() - started:.1f} s at the start of "
              f"phase {phase}", flush=True)

    build_all()

    img = make_image(HEIGHT, WIDTH)
    mode = Subsampling(SUBSAMPLING)
    htables = huffman.standard_tables()
    luts_np = bitpack.luts_from_tables(htables)
    luts = tuple(torch.as_tensor(a.astype(np.int32), device=dev)
                 for a in luts_np)
    packed = pack.pack_tables(*luts)
    budget = bitpack.BLOCK_WORDS * 32

    # The port's own CPU path: the references for the card's bytes/pixels.
    t0 = time.perf_counter()
    jpg_cpu = jpeg_tpu_torch.encode(img, QUALITY, SUBSAMPLING, device="cpu")
    px_cpu = jpeg_tpu_torch.decode(jpg_cpu, device="cpu")
    print(f"phase 4: CPU reference encode+decode in "
          f"{time.perf_counter() - t0:.2f} s ({len(jpg_cpu)} bytes)", flush=True)

    lap("4")
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
    for n in port_util.LEVEL1_SIZES:
        blocks_np, tbl_np = port_util.adversarial_level1_case(n, htables)
        blocks = torch.as_tensor(blocks_np, device=dev)
        tbl = torch.as_tensor(tbl_np, device=dev)
        e, _ = level1_err(pack.pack_level1(blocks, tbl, *luts),
                          pack.pack_level1_reference(blocks, tbl, *luts), budget)
        print(f"phase 4: kernel A vs plain, adversarial blocks, B = {n}: "
              f"max |err| {e}", flush=True)
        err_a, n_a = max(err_a, e), n_a + n
    blocks4k_q95, _, _, _ = encoder._interleaved_blocks(
        dimg, quant.luma_table(95), quant.chroma_table(95), mode, 0)
    for q, blk in ((QUALITY, blocks4k), (95, blocks4k_q95)):
        got4k = pack.pack_level1(blk, tbl4k, *luts)
        e, n = level1_err(got4k, pack.pack_level1_reference(blk, tbl4k, *luts),
                          budget)
        over = int((got4k[1] > budget).sum())
        print(f"phase 4: kernel A vs plain, 4K q{q} {SUBSAMPLING} blocks: {n} "
              f"blocks ({over} over {budget} bits, "
              f"{float((blk != 0).sum()) / n:.1f} nonzeros per block), "
              f"max |err| {e}", flush=True)
        err_a = max(err_a, e)
    check(err_a == 0, f"kernel A disagrees with its plain twin (max {err_a})")

    lap("4c")
    # Phase 4c: the scan pass against its twin (pack_level2 + the native
    # finalize) on the 4K frame's kernel A output, in one segment and at
    # restart ROW_RESTART (135 segments): bytes and status; its launches
    # per encode() and per encode_stream image.
    scan_sets, err_scan = {}, 0
    for r in (0, ROW_RESTART):
        blk_r, tbl_r, n_mcu_r, _ = encoder._interleaved_blocks(
            dimg, quant.luma_table(QUALITY), quant.chroma_table(QUALITY),
            mode, r)
        scan_sets[r] = encoder._level1_segments(
            blk_r, tbl_r, encoder._device_luts(htables, dev), n_mcu_r, r)
        got_scan, got_status = pack.pack_scan(*scan_sets[r])
        ref_scan, ref_status = pack.pack_scan_reference(*scan_sets[r])
        count = int(ref_status[-1])
        same = (got_status.cpu().tolist() == ref_status.tolist()
                and torch.equal(got_scan[:count].cpu(), ref_scan))
        err_scan += not same
        print(f"phase 4c: scan pass vs twin, 4K q{QUALITY} restart {r}: "
              f"{scan_sets[r][1].shape[0]} segments, {count} bytes, equal "
              f"{same}", flush=True)
    check(err_scan == 0, "the scan pass disagrees with its twin")
    before = pack.SCAN_LAUNCHES
    jpeg_tpu_torch.encode(img, QUALITY, SUBSAMPLING, device=dev)
    scan_per_encode = pack.SCAN_LAUNCHES - before
    list(jpeg_tpu_torch.encode_stream(iter([img] * 4), QUALITY, SUBSAMPLING,
                                      device=dev))
    scan_per_stream_image = (pack.SCAN_LAUNCHES - before - scan_per_encode) / 4
    print(f"phase 4c: scan pass launches: {scan_per_encode} per encode(), "
          f"{scan_per_stream_image} per encode_stream image", flush=True)

    lap("4b")
    # Phase 4b: kernel A with optimal tables whose codes reach 16 bits.
    blocks_np = random_blocks(rng, 65536, 0.15)
    blocks_np[::5, 1:40] = 0  # long zero runs: ZRL symbols
    skew = skewed_tables(blocks_np, huffman, symbols, torch)
    skew_luts = tuple(torch.as_tensor(a.astype(np.int32), device=dev)
                      for a in bitpack.luts_from_tables(skew))
    blocks = torch.as_tensor(blocks_np, device=dev)
    tbl = torch.as_tensor((rng.random(len(blocks_np)) < 0.5).astype(np.int32),
                          device=dev)
    e, n = level1_err(pack.pack_level1(blocks, tbl, *skew_luts),
                      pack.pack_level1_reference(blocks, tbl, *skew_luts),
                      budget)
    max_len = int(max(t.size.max() for t in skew.values()))
    zrl, zrl_std = skew[(1, 0)], htables[(1, 0)]
    print(f"phase 4b: kernel A vs plain, skewed optimal tables: {n} blocks, "
          f"longest code {max_len} bits, ZRL code {int(zrl.code[0xF0]):b} "
          f"({int(zrl.size[0xF0])} bits; standard "
          f"{int(zrl_std.code[0xF0]):b}), max |err| {e}", flush=True)
    check(max_len == 16, f"skewed tables reach only {max_len} bits")
    check((zrl.code[0xF0], zrl.size[0xF0]) != (zrl_std.code[0xF0],
                                               zrl_std.size[0xF0]),
          "the skewed ZRL code is the standard one")
    check(e == 0, f"kernel A disagrees with its twin on skewed tables ({e})")
    err_a = max(err_a, e)

    lap("5")
    # Phase 5: kernel B vs plain at the 4K plane shapes, on the 4K stream's
    # own coefficients.
    info = jfif.parse_jpeg(jpg_cpu)
    comps = info.components
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    mcu_rows = layout.ceil_div(info.height, 8 * vmax)
    mcu_cols = layout.ceil_div(info.width, 8 * hmax)

    def coefficient_planes(parsed):
        """A 4K stream's dense scans from the native walk, and per component
        the (coefficient plane on the card, quantization table) pair that
        kernel B takes (the chain before kernel B2, still the mesh layer's
        and the 4-component finish's)."""
        dense = native.decode_scan(
            parsed.scan_data, mcu_rows * mcu_cols,
            [(i, c.h * c.v, c.dc_id, c.ac_id) for i, c in enumerate(comps)],
            parsed.htables, parsed.restart_interval)
        out = []
        for c, s in zip(comps, dense):
            raster = layout.scan_to_raster(s, mcu_rows, mcu_cols, c.v, c.h)
            zz = torch.as_tensor(raster, device=dev).reshape(
                mcu_rows * c.v, mcu_cols * c.h, 64)
            qt = torch.as_tensor(parsed.qtables[c.qtab_id],
                                 dtype=torch.float32, device=dev)
            out.append((tile.unblockify(zigzag.from_zigzag(zz)), qt))
        return dense, out

    scans, planes = coefficient_planes(info)
    err_b = 0.0
    for coeffs, qt in planes:
        got = fused.fused_dequant_idct(coeffs, qt)
        ref = fused.fused_dequant_idct_reference(coeffs, qt)
        e = float((got - ref).abs().max())
        print(f"phase 5: kernel B vs plain, plane {tuple(coeffs.shape)}: "
              f"max |err| {e:.3g}", flush=True)
        err_b = max(err_b, e)
    for name, coeffs_np, qt_np in port_util.adversarial_idct_planes():
        coeffs = torch.as_tensor(coeffs_np, device=dev)
        e = float((fused.fused_dequant_idct(coeffs, qt_np)
                   - fused.fused_dequant_idct_reference(coeffs, qt_np)
                   ).abs().max())
        print(f"phase 5: kernel B vs plain, {name} {coeffs_np.shape}: "
              f"max |err| {e:.3g}", flush=True)
        err_b = max(err_b, e)
    check(err_b <= 1e-2, f"kernel B disagrees with its plain twin ({err_b})")

    lap("5b")
    # Phase 5b: kernel C vs plain on the planes the use_pallas path feeds it.
    pallas_planes = encoder._pallas_planes(dimg, mode)
    cases = [(p, q, name) for q in (QUALITY, 95)
             for p, name in zip(pallas_planes, ("Y", "Cb", "Cr"))]
    cases.append((torch.as_tensor(
        rng.integers(0, 256, size=(HEIGHT, WIDTH)).astype(np.float32),
        device=dev), QUALITY, "uniform random"))
    # A width that is a multiple of 8 but not of a warp's 256 columns.
    cases.append((torch.as_tensor(
        rng.integers(0, 256, size=(HEIGHT, WIDTH + 8)).astype(np.float32),
        device=dev), QUALITY, "uniform random, ragged width"))
    err_c = 0
    for plane, q, name in cases:
        qt = quant.chroma_table(q) if name in ("Cb", "Cr") else (
            quant.luma_table(q))
        got = fused.fused_dct_quantize(plane, qt)
        e, nd, _, n = coef_diff(
            got, fused.fused_dct_quantize_reference(plane, qt))
        # A second witness, the twin on the CPU: if the card's twin ever
        # orders its matrix products differently, this says which side moved.
        e_cpu, nd_cpu, bound, _ = coef_diff(
            got, fused.fused_dct_quantize_reference(plane.cpu(), qt))
        print(f"phase 5b: kernel C vs plain, {name} plane "
              f"{tuple(plane.shape)} q{q}: max |err| {e}, {nd} of {n} "
              f"coefficients differ; vs the twin on the CPU: max |err| "
              f"{e_cpu}, {nd_cpu} differ (bound {bound:.0f})", flush=True)
        check(nd == 0,
              f"kernel C disagrees with its plain twin on {name} q{q} "
              f"({nd} coefficients; {nd_cpu} against the twin on the CPU)")
        check(e_cpu <= 1 and nd_cpu <= bound,
              f"kernel C is outside its contract against the twin on the "
              f"CPU on {name} q{q}")
        err_c = max(err_c, e)
    del cases

    lap("5c")
    # Phase 5c: kernels D and E and program F vs their plain twins. Integers
    # throughout: every comparison is exact.
    def huffman_stream(mode_, shape, restart, optimal):
        im = make_image(*shape, seed=shape[0] + restart)
        kw = dict(quality=85, restart_interval=restart,
                  optimize_tables=optimal, device="cpu")
        if mode_ == "gray":
            return jpeg_tpu_torch.encode(im[..., 0], **kw)
        return jpeg_tpu_torch.encode(im, subsampling=mode_, **kw)

    def hold_d(stream):
        """Kernel D on the host index pass's offsets of `stream`: max |err|
        against its twin, after holding it to native.decode_scan."""
        d_in = port_util.ac_indexed_inputs(stream, dev)
        rows = entropy_decode.decode_ac_indexed(*d_in)
        torch.cuda.synchronize()
        want = np.concatenate(native.decode_scan(*port_util.scan_args(stream)))
        check(np.array_equal(rows.cpu().numpy(), want),
              "kernel D's rows differ from native.decode_scan's")
        return d_in, rows, int_err(
            rows, entropy_decode.decode_ac_indexed_reference(*d_in))

    def hold_f(stream):
        """Program F on `stream`: max |err| over its three outputs against
        its twin, after holding it to native.index_scan."""
        args = port_util.scan_args(stream)
        f_in, true_bits = port_util.prefix_inputs(stream, dev)
        got = entropy_decode.prefix_index(*f_in)
        torch.cuda.synchronize()
        off, dc = port_util.regroup_prefix(got[0], got[1], args[2])
        _, want_off, want_dc = native.index_scan(*args)
        end_pos, flag = got[2].tolist()
        check(flag == 0 and true_bits - 7 <= end_pos <= true_bits,
              f"program F: flag {flag}, end {end_pos} of {true_bits} bits")
        check(np.array_equal(off.cpu().numpy(), want_off)
              and np.array_equal(dc.cpu().numpy(), want_dc),
              "program F's offsets or DCs differ from native.index_scan's")
        twin = entropy_decode.prefix_index_reference(*f_in)
        return f_in, got, max(int_err(g, t) for g, t in zip(got, twin))

    def run_e(e_in):
        rows, status = entropy_decode.decode_segments(*e_in)
        torch.cuda.synchronize()
        return rows, status

    def hold_e(stream):
        """Kernel E on `stream`'s segments, held to native.decode_scan:
        (inputs, rows, status)."""
        e_in, bits = port_util.segment_inputs(stream, dev)
        rows, status = run_e(e_in)
        want = np.concatenate(native.decode_scan(*port_util.scan_args(stream)))
        ends, flags = status.cpu().tolist()
        check(not any(flags) and all(b - 7 <= e <= b
                                     for e, b in zip(ends, bits)),
              "kernel E: an error flag, or an end position off its segment")
        check(np.array_equal(rows.cpu().numpy(), want),
              "kernel E's rows differ from native.decode_scan's")
        return e_in, rows, status

    err_d = err_e = err_f = 0
    for mode_, shape in (("420", (203, 331)), ("444", (101, 77)),
                         ("422", (90, 150)), ("gray", (75, 97))):
        for restart, optimal in ((0, False), (0, True), (11, False),
                                 (7, True)):
            stream = huffman_stream(mode_, shape, restart, optimal)
            _, rows_d, e_d = hold_d(stream)
            e_in, rows_e, status = hold_e(stream)
            t_rows, t_status = entropy_decode.decode_segments_reference(*e_in)
            e_e = max(int_err(rows_e, t_rows), int_err(status, t_status))
            line = (f"phase 5c: {mode_} {shape[1]}x{shape[0]} restart "
                    f"{restart}, {'optimal' if optimal else 'standard'} "
                    f"tables: {rows_d.shape[0]} blocks, {status.shape[1]} "
                    f"segments; vs plain: D max |err| {e_d}, E {e_e}")
            if restart == 0:
                # One segment: kernel E's rows are F + D's, by another route.
                f_in, got_f, e_f = hold_f(stream)
                off, dc = port_util.regroup_prefix(
                    got_f[0], got_f[1], port_util.scan_args(stream)[2])
                d_in = port_util.ac_indexed_inputs(stream, dev)
                rows_fd = entropy_decode.decode_ac_indexed(
                    f_in[0], off, dc, d_in[3], d_in[4])
                check(torch.equal(rows_fd, rows_e),
                      "kernel E as one segment differs from F + D")
                line += f", F {e_f}; E as one segment == F + D"
                err_f = max(err_f, e_f)
            print(line, flush=True)
            err_d, err_e = max(err_d, e_d), max(err_e, e_e)
    # At full width. D on the 4K stream; the block-start program (F without
    # markers, E's route with them) on every frame of sync_frames, each
    # alone beside its repair passes.
    d4k, rows4k, e = hold_d(jpg_cpu)
    err_d = max(err_d, e)
    print(f"phase 5c: kernel D, 4K q{QUALITY} {SUBSAMPLING}: "
          f"{rows4k.shape[0]} rows equal native.decode_scan's; vs plain: max "
          f"|err| {e}", flush=True)
    del rows4k

    def f_alone_us(f_in):
        """Program F alone, kernel only: its five launches back to back, as
        a decode runs them."""
        words, n_mcu, seq, classes, tables = f_in
        sets = []
        for _ in range(4):
            w = words.clone()
            outs = [torch.empty((n_mcu, seq.shape[0]), dtype=torch.int32,
                                device=dev) for _ in range(2)]
            outs.append(torch.empty(2, dtype=torch.int32, device=dev))
            sets.append(entropy_decode.prefix_launches(
                w, n_mcu, seq, classes, tables, *outs,
                entropy_decode.prefix_scratch(w.numel(), n_mcu,
                                              classes.shape[0], dev)))
        return kernel_only_us(lambda i: [go() for _, go in sets[i]],
                              len(sets), torch), sets

    def e_alone_us(e_in):
        """E's route alone, kernel only: the anchored program, the DC sums
        and kernel D (scan_decode on words already on the card: the control
        words' memset, no upload), on rotating buffers."""
        words, seg_off, interval, n_mcu, seq, tables, nblocks = e_in
        comps = seq[:, 0].tolist()
        comp_bpm = [comps.count(c) for c in sorted(set(comps))]
        sets = [words.clone() for _ in range(rotation(nblocks * 256))]
        return kernel_only_us(
            lambda i: entropy_decode.scan_decode(
                dev, True, sets[i].numel(), seg_off.numel(), interval, n_mcu,
                seq, tables, comp_bpm, words=sets[i], seg_off=seg_off),
            len(sets), torch)

    sync_runs = {}  # frame -> (route, segments, blocks, passes, kernel us)
    frames_4k = {}
    for name, (frame, kw) in sync_frames(img).items():
        kw = {"quality": QUALITY, **kw}
        if frame.ndim == 3:
            kw["subsampling"] = SUBSAMPLING
        stream = jpg_cpu if name == "4K" else jpeg_tpu_torch.encode(
            frame, device=dev, **kw)
        frames_4k[name] = stream
        if not kw.get("restart_interval"):
            f_in, _got, e = hold_f(stream)
            passes = entropy_decode.SYNC_PASSES
            err_f = max(err_f, e)
            us, _sets = f_alone_us(f_in)
            sync_runs[name] = ("F", 1, f_in[1] * f_in[2].shape[0], passes, us)
            if name == "4K":
                f4k = f_in
            del _got, _sets
        else:
            e_in, rows, status = hold_e(stream)
            passes = entropy_decode.SYNC_PASSES
            (t_rows, t_status), secs = timed(
                entropy_decode.decode_segments_reference, *e_in)
            e = max(int_err(rows, t_rows), int_err(status, t_status))
            err_e = max(err_e, e)
            us = e_alone_us(e_in)
            sync_runs[name] = ("E", e_in[1].shape[0], e_in[6], passes, us)
            if kw["restart_interval"] == ROW_RESTART:
                e4k, secs_e_plain = e_in, secs
            del rows, status, t_rows, t_status
        route, nseg, nblocks, passes, us = sync_runs[name]
        same = np.array_equal(
            jpeg_tpu_torch.decode(stream, device=dev, entropy="device"),
            jpeg_tpu_torch.decode(stream, device=dev, entropy="sparse"))
        print(f"phase 5c: {'program F' if route == 'F' else 'E route'}, "
              f"{name}: {nseg} segments, {nblocks} blocks, equal to the host "
              f"walkers; vs plain: max |err| {e}; repair passes {passes}; "
              f"kernel-only {us:.2f} us; 'device' pixels == 'sparse': "
              f"{same} [{card}]", flush=True)
        check(same, f"{name}: 'device' pixels differ from 'sparse'")
    jpg_rst = frames_4k[f"4K restart {ROW_RESTART}"]
    jpg_long = frames_4k[f"4K restart {4 * ROW_RESTART}"]
    check(err_d == 0 and err_e == 0 and err_f == 0,
          f"a device Huffman decoder disagrees with its plain twin "
          f"(D {err_d}, E {err_e}, F {err_f})")

    dc_sum = dc_sum_phase(dev, card, torch)

    lap("5d")
    # Phase 5d: kernels B2 (zig-zag blocks in, uint8 samples out) and H (the
    # finish after the samples) against their plain twins on the card, 0
    # apart, at the shapes the decoder gives them; B2 also against kernel B
    # rounded and clamped (the same FMA chains). Then the decodes against
    # the old route composed from the decoder's blocks and the twins, byte
    # for byte, and the finish's kernels counted by the profiler.
    def finish_inputs(streams):
        """The decoder's finish inputs for one stream, or for several of one
        geometry stacked as decode_batched stacks them: (blocks per
        component, tables, block grids of one image, ratios, upsample
        choices, rows, columns, images)."""
        info = jfif.parse_jpeg(streams[0])
        cs_ = info.components
        hm, vm = max(c.h for c in cs_), max(c.v for c in cs_)
        mr = layout.ceil_div(info.height, 8 * vm)
        mc = layout.ceil_div(info.width, 8 * hm)
        per = [decoder._device_blocks(jfif.parse_jpeg(j), mr, mc, "auto", dev)
               for j in streams]
        zz = [torch.cat(z) if len(z) > 1 else z[0] for z in zip(*per)]
        qt = [torch.as_tensor(info.qtables[c.qtab_id], dtype=torch.float32,
                              device=dev) for c in cs_]
        shapes_ = [(mr * c.v, mc * c.h) for c in cs_]
        factors_ = tuple((hm // c.h, vm // c.v) for c in cs_)
        fancy_ = decoder.upsample_choices(info.width, cs_, hm, True)
        return (zz, qt, shapes_, factors_, fancy_, info.height, info.width,
                len(streams))

    def scan_inputs(streams):
        """The blocks as the decoder hands them to kernel B2: each
        component's blocks in the entropy decoder's scan order, and its
        scan geometry (None: raster order); several streams of one
        geometry as decode_batched's (n, B, 64) rows, a (n, blocks, 64)
        slice per component."""
        info = jfif.parse_jpeg(streams[0])
        cs_ = info.components
        hm, vm = max(c.h for c in cs_), max(c.v for c in cs_)
        mr = layout.ceil_div(info.height, 8 * vm)
        mc = layout.ceil_div(info.width, 8 * hm)
        per = [decoder._scan_blocks(jfif.parse_jpeg(j), mr, mc, "auto", dev)
               for j in streams]
        zz, geo = per[0]
        if len(streams) > 1:
            rows = torch.stack([torch.cat(z) for z, _ in per])
            bounds = np.cumsum([0] + [z.shape[0] for z in zz])
            zz = [rows[:, lo:hi] for lo, hi in zip(bounds[:-1], bounds[1:])]
        return zz, geo

    def old_route(zz, qt, shapes_, factors_, fancy_, h, w, n):
        """The finish before kernels B2 and H, from the twins on the card:
        de-zigzag, unblockify, kernel B's twin, round, clamp; then the torch
        upsample, colour map, round, clip and crop."""
        samples = [fused.dequant_idct_samples_reference(z, q, (n * hb, wb))
                   for z, q, (hb, wb) in zip(zz, qt, shapes_)]
        if len(samples) == 1:
            return samples[0][:h, :w]
        planes_ = [p.reshape(n, hb * 8, wb * 8) if n > 1 else p
                   for p, (hb, wb) in zip(samples, shapes_)]
        return finish.finish_color_reference(planes_, factors_, fancy_, False,
                                             h, w)

    err_b2, err_h, b2_cases, h_cases = 0, 0, 0, 0
    gray_5d = jpeg_tpu_torch.encode(np.ascontiguousarray(img[..., 1]),
                                    QUALITY, device=dev)
    decodes_5d = {
        f"4K {SUBSAMPLING}": [jpg_cpu],
        "4K 444": [jpeg_tpu_torch.encode(img, QUALITY, "444", device=dev)],
        "4K 422": [jpeg_tpu_torch.encode(img, QUALITY, "422", device=dev)],
        "1001x777 420": [jpeg_tpu_torch.encode(
            np.ascontiguousarray(img[:777, :1001]), QUALITY, "420",
            device=dev)],
        "1001x777 444": [jpeg_tpu_torch.encode(
            np.ascontiguousarray(img[:777, :1001]), QUALITY, "444",
            device=dev)],
        "4K gray": [gray_5d],
        f"K={BATCH_DECODE} 4K stacked as decode_batched stacks them": [
            jpeg_tpu_torch.encode(np.roll(img, i * ROLL, axis=1), QUALITY,
                                  SUBSAMPLING, device=dev)
            for i in range(BATCH_DECODE)],
    }
    for label, streams in decodes_5d.items():
        zz, qt, shapes_, factors_, fancy_, h, w, n = finish_inputs(streams)
        samples = []
        for z, q, (hb, wb) in zip(zz, qt, shapes_):
            got = fused.dequant_idct_samples(z, q, (n * hb, wb))
            twin = fused.dequant_idct_samples_reference(z, q, (n * hb, wb))
            plane = tile.unblockify(zigzag.from_zigzag(z.reshape(
                n * hb, wb, 64)))
            by_b = torch.clamp(torch.round(fused.fused_dequant_idct(
                plane, q)), 0, 255).to(torch.uint8)
            e, e_b = int_err(got, twin), int_err(got, by_b)
            print(f"phase 5d: kernel B2 vs plain, {label}, "
                  f"{tuple(got.shape)} samples: max |err| {e}; vs kernel B "
                  f"rounded: {e_b}", flush=True)
            check(e_b == 0, f"kernel B2 differs from kernel B rounded ({e_b})")
            err_b2, b2_cases = max(err_b2, e), b2_cases + 1
            samples.append(got if n == 1 else got.reshape(n, hb * 8, wb * 8))
        # All components in one launch, in the entropy decoder's order.
        zz_s, geo_s = scan_inputs(streams)
        before_b2 = fused.ZZ_LAUNCHES
        got_s = fused.dequant_idct_planes(zz_s, qt, shapes_, geo_s, n_img=n)
        torch.cuda.synchronize()
        one_launch = fused.ZZ_LAUNCHES == before_b2 + 1
        twin_s = fused.dequant_idct_planes_reference(zz_s, qt, shapes_,
                                                     geo_s, n_img=n)
        e = max(int_err(g, t) for g, t in zip(got_s, twin_s))
        e_r = max(int_err(g.reshape(s.shape), s)
                  for g, s in zip(got_s, samples))
        print(f"phase 5d: kernel B2 vs plain, {label}, every component in "
              f"one launch ({one_launch}) in scan order {geo_s}: max |err| "
              f"{e}; vs the raster-order launches: {e_r}", flush=True)
        check(one_launch and e_r == 0,
              f"{label}: one launch {one_launch}, {e_r} from raster order")
        err_b2, b2_cases = max(err_b2, e), b2_cases + 1
        if len(samples) == 3:
            got = finish.finish_color(samples, factors_, fancy_, False, h, w)
            e = int_err(got, finish.finish_color_reference(
                samples, factors_, fancy_, False, h, w))
            print(f"phase 5d: kernel H vs plain, {label}, ratios {factors_}, "
                  f"{tuple(got.shape)}: max |err| {e}", flush=True)
            err_h, h_cases = max(err_h, e), h_cases + 1
        if n == 1:
            px_5d = jpeg_tpu_torch.decode(streams[0], device=dev,
                                          device_output=True)
        else:
            px_5d = jpeg_tpu_torch.decode_batched(streams, device=dev,
                                                  device_output=True)
        same = torch.equal(px_5d, old_route(zz, qt, shapes_, factors_, fancy_,
                                            h, w, n))
        print(f"phase 5d: {label}: {'decode_batched' if n > 1 else 'decode'}"
              f" == the old route (twins on the card): {same}", flush=True)
        check(same, f"{label}: the decode differs from the old route")
    # The scaled decodes' samples (two einsums, no B2) through H.
    zz, qt, shapes_, factors_, fancy_, h, w, n = finish_inputs([jpg_cpu])
    for d in (2, 4, 8):
        k = 8 // d
        samples = [decoder._samples(z, q, s, k) for z, q, s in
                   zip(zz, qt, shapes_)]
        hl, wl = layout.ceil_div(h, d), layout.ceil_div(w, d)
        got = finish.finish_color(samples, factors_, fancy_, False, hl, wl)
        e = int_err(got, finish.finish_color_reference(
            samples, factors_, fancy_, False, hl, wl))
        print(f"phase 5d: kernel H vs plain, scale_denom {d} planes "
              f"{[tuple(p.shape) for p in samples]}: max |err| {e}",
              flush=True)
        err_h, h_cases = max(err_h, e), h_cases + 1
    # Every ratio pair in {1, 2, 3, 4}^2 on small planes, both upsample
    # choices, YCbCr and RGB, one image and a batch of three, with a crop.
    rng_5d = np.random.default_rng(5)
    e_pairs = 0
    for fh, fv in ((a, b) for a in range(1, 5) for b in range(1, 5)):
        for fan in (True, False):
            for is_rgb in (False, True):
                for nimg in (None, 3):
                    fac = ((1, 1), (fh, fv), (fh, fv))
                    pl = [torch.as_tensor(rng_5d.integers(0, 256, size=(
                        (nimg,) if nimg else ()) + (96 // f[1], 120 // f[0])
                    ).astype(np.uint8), device=dev) for f in fac]
                    for crop in ((91, 113), (91, 116), (96, 120)):
                        got = finish.finish_color(pl, fac, (fan,) * 3, is_rgb,
                                                  *crop)
                        e_pairs = max(e_pairs, int_err(
                            got, finish.finish_color_reference(
                                pl, fac, (fan,) * 3, is_rgb, *crop)))
                        h_cases += 1
    print(f"phase 5d: kernel H vs plain, every ratio pair on 96x120 planes "
          f"(crops 91x113, 91x116 and 96x120: byte, word and 8-byte "
          f"stores), fancy and not, "
          f"YCbCr and RGB, 1 and 3 images: max |err| {e_pairs}", flush=True)
    err_h = max(err_h, e_pairs)
    check(err_b2 == 0 and err_h == 0,
          f"kernels B2 / H disagree with their twins ({err_b2} / {err_h})")
    # The finish after the entropy decode, on the blocks as the decoder
    # hands them over, kernels counted by the profiler.
    zz, qt, shapes_, factors_, fancy_, h, w, n = finish_inputs([jpg_cpu])
    zz_s, geo_s = scan_inputs([jpg_cpu])
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        decoder._finish_color(*zz_s, *qt, shapes_, factors_, fancy_, hlim=h,
                              wlim=w, scan=geo_s)
        torch.cuda.synchronize()
    finish_kernels = [ev.name for ev in prof.events()
                      if ev.device_type.name == "CUDA"
                      and not ev.name.startswith(("Memcpy", "Memset"))]
    print(f"phase 5d: the 4K finish after the entropy decode, by the "
          f"profiler: {len(finish_kernels)} kernel launches: "
          + "; ".join(name[:60] for name in finish_kernels), flush=True)
    check(len(finish_kernels) == 2,
          f"the finish is {len(finish_kernels)} kernel launches")
    print(f"phase 5d: kernels B2 and H vs plain: {b2_cases} / {h_cases} "
          f"cases, max |err| {err_b2} / {err_h}", flush=True)

    # Every path of the JSON line's "launches_per": its counts as they were
    # read just after it ran, read_counts()'s ((A, B, C, B2, H), (D, E, F,
    # F's separate launches, native scan calls, DC-sum launches)).
    path_counts = {}
    # Per path, the scan -> raster reorders (layout.SCAN_TO_RASTER_CALLS)
    # read just after it ran.
    path_reorders = {}

    def counted_all(fn, path=None, images=1):
        """fn() with every kernel's count set to 0 just before and read just
        after: (result, *read_counts()). `path` keeps the counts read under
        that name, divided by the `images` the call took."""
        reset_counts()
        out = fn()
        abc, huffman_n = read_counts()
        if path is not None:
            path_reorders[path] = layout.SCAN_TO_RASTER_CALLS
            check(all(n % images == 0 for n in abc + huffman_n),
                  f"{path}: launches {abc}, {huffman_n} over {images} images")
            path_counts[path] = (tuple(n // images for n in abc),
                                 tuple(n // images for n in huffman_n))
        return out, abc, huffman_n

    def counted(fn, huffman=(0, 0, 0), **keep):
        """counted_all for a path whose (D, E, F) launches are known
        beforehand: (result, (A, B, C, B2, H) launches). The default is a path
        that runs no device Huffman decoder."""
        out, abc, huffman_n = counted_all(fn, **keep)
        check(huffman_n[:3] == huffman,
              f"(D, E, F) launches {huffman_n[:3]}, expected {huffman}")
        return out, abc

    lap("6")
    # Phase 6: the main path, counted: the encode, then the decode.
    encoder.HOST_PACK_SPILLS = 0
    jpg, per_encode, huffman_encode = counted_all(
        lambda: jpeg_tpu_torch.encode(img, QUALITY, SUBSAMPLING, device=dev),
        path="default_encode")
    px, per_decode, huffman_main = counted_all(
        lambda: jpeg_tpu_torch.decode(jpg, device=dev), path="default_decode")
    main_launches = tuple(e + d for e, d in zip(
        per_encode + huffman_encode, per_decode + huffman_main))
    spills = encoder.HOST_PACK_SPILLS
    print(f"phase 6: 4K q{QUALITY} {SUBSAMPLING}: {len(jpg)} bytes; launches "
          f"(A, B, C, B2, H): encode {per_encode}, decode {per_decode}; "
          f"host-pack spills {spills}", flush=True)
    check(per_encode == ENCODE_N, "a default encode is one launch of kernel A")
    check(per_decode == COLOUR_N,
          "a colour decode is one launch of kernel B2 and one of H")
    f_launches = len(entropy_decode._SYNC_STEPS)
    check(huffman_encode == (0, 0, 0, 0, 0, 0),
          f"an encode launched a Huffman decoder: {huffman_encode}")
    check(huffman_main == (1, 0, 1, f_launches, 1, 1),
          f"a default decode is program F ({f_launches} launches), the DC "
          f"sums and kernel D once each from one native scan call, not "
          f"{huffman_main}")
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
    psnr_default = psnr(px, img)

    lap("6b")
    # Phase 6b: encode(use_pallas=True), counted: kernel C then the host pack.
    cfg = EncodeConfig(quality=QUALITY, subsampling=SUBSAMPLING)
    qy, qc = quant.luma_table(QUALITY), quant.chroma_table(QUALITY)
    cimg = tile.pad_to_multiple(torch.as_tensor(img), mode.mcu_height,
                                mode.mcu_width)
    coef_cpu, secs = timed(encoder._transform_color, cimg, qy, qc, mode, True)
    jpg_pallas_cpu, secs2 = timed(lambda: jpeg_tpu_torch.encode(
        img, QUALITY, SUBSAMPLING, device="cpu", use_pallas=True))
    print(f"phase 6b: CPU references: use_pallas transform {secs:.2f} s, "
          f"encode {secs2:.2f} s", flush=True)
    encoder.HOST_PACK_SPILLS = 0
    jpg_pallas, per_pallas = counted(lambda: jpeg_tpu_torch.encode(
        img, QUALITY, SUBSAMPLING, device=dev, use_pallas=True),
        path="use_pallas_encode")
    launches_a_pallas, _, launches_c, _, _ = per_pallas
    print(f"phase 6b: use_pallas 4K q{QUALITY} {SUBSAMPLING}: "
          f"{len(jpg_pallas)} bytes; launches: kernel C {launches_c}, "
          f"kernel A {launches_a_pallas}", flush=True)
    check(launches_c == 3, f"kernel C launched {launches_c} times, not 3")
    check(launches_a_pallas == 0, "kernel A launched on the host-pack path")
    coef_card = encoder._transform_color(dimg, qy, qc, mode, True)
    planes_equal = True
    for name, g, r in zip(("Y", "Cb", "Cr"), coef_card, coef_cpu):
        e, nd, bound, n = coef_diff(g, r)
        print(f"phase 6b: {name} coefficients, card vs CPU use_pallas "
              f"transform: max |diff| {e}, {nd} of {n} differ (bound "
              f"{bound:.0f})", flush=True)
        check(e <= 1 and nd <= bound, f"use_pallas {name} coefficients "
              "outside kernel C's contract")
        planes_equal = planes_equal and nd == 0
    if planes_equal:
        check(jpg_pallas == jpg_pallas_cpu,
              "use_pallas bytes differ from the CPU's on equal coefficients")
        print("phase 6b: coefficients equal, bytes equal the CPU "
              "use_pallas encode", flush=True)
    else:
        scan, _ = encoder._host_pack_color(
            *(c.cpu().numpy() for c in coef_card),
            HEIGHT // mode.mcu_height, WIDTH // mode.mcu_width, cfg)
        check(jfif.parse_jpeg(jpg_pallas).scan_data == scan,
              "use_pallas scan is not the host pack of the card's coefficients")
        print("phase 6b: scan equals the host pack of the card's own "
              "coefficients", flush=True)
    px_pallas = jpeg_tpu_torch.decode(jpg_pallas, device=dev)
    psnr_pallas = psnr(px_pallas, img)
    print(f"phase 6b: decode PSNR vs source {psnr_pallas:.3f} dB (default "
          f"path {psnr_default:.3f} dB); vs the default path's decode "
          f"{psnr(px_pallas, px):.2f} dB", flush=True)
    check(abs(psnr_pallas - psnr_default) <= 0.1,
          "use_pallas PSNR is more than 0.1 dB from the default path's")

    lap("6c")
    # Phase 6c: optimize_tables, three ways, one set of bytes.
    opt = dict(optimize_tables=True)
    jpg_opt_cpu, secs = timed(lambda: jpeg_tpu_torch.encode(
        img, QUALITY, SUBSAMPLING, device="cpu", **opt))
    print(f"phase 6c: CPU reference optimize_tables encode {secs:.2f} s",
          flush=True)
    pack.LAUNCHES = 0
    encoder.HOST_PACK_SPILLS = 0
    jpg_opt = jpeg_tpu_torch.encode(img, QUALITY, SUBSAMPLING, device=dev,
                                    **opt)
    launches_a_opt, spills = pack.LAUNCHES, encoder.HOST_PACK_SPILLS
    jpg_opt_host = jpeg_tpu_torch.encode(img, QUALITY, SUBSAMPLING,
                                         device=dev, device_pack=False, **opt)
    print(f"phase 6c: optimize_tables 4K: {len(jpg_opt)} bytes (standard "
          f"tables {len(jpg)}); kernel A {launches_a_opt} launches, "
          f"{spills} spills; device pack == host pack: "
          f"{jpg_opt == jpg_opt_host}; == CPU: {jpg_opt == jpg_opt_cpu}",
          flush=True)
    check(launches_a_opt >= 1, "kernel A did not launch for optimize_tables")
    check(spills == 0, "optimize_tables spilled to the host packer")
    check(jpg_opt == jpg_opt_host == jpg_opt_cpu,
          "optimize_tables bytes differ between card, host pack and CPU")
    blocks_cpu, tbl_cpu, _, _ = encoder._interleaved_blocks(
        cimg, qy, qc, mode, 0)
    freqs = native.count_frequencies(blocks_cpu.numpy(), tbl_cpu.numpy())
    info_opt = jfif.parse_jpeg(jpg_opt)
    for key, f in freqs.items():
        want = huffman.optimal_table(f)
        got = info_opt.htables[key]
        check(np.array_equal(got.bits, want.bits)
              and np.array_equal(got.vals, want.vals),
              f"DHT table {key} is not the optimal one")
    print(f"phase 6c: DHT tables are the optimal ones of the native symbol "
          f"counts; longest code "
          f"{max(int(t.size.max()) for t in info_opt.htables.values())} bits",
          flush=True)
    px_opt = jpeg_tpu_torch.decode(jpg_opt, device=dev)
    check(np.array_equal(px_opt, px),
          "optimize_tables decode differs from the standard-table decode")

    lap("6d")
    # Phase 6d: an unaligned restart interval takes the host pack.
    r = UNALIGNED_RESTART
    n_mcu = (HEIGHT // mode.mcu_height) * (WIDTH // mode.mcu_width)
    check(n_mcu % r != 0, f"restart {r} divides {n_mcu}")
    jpg_r_cpu, secs = timed(lambda: jpeg_tpu_torch.encode(
        img, QUALITY, SUBSAMPLING, r, device="cpu"))
    jpg_r = jpeg_tpu_torch.encode(img, QUALITY, SUBSAMPLING, r, device=dev)
    print(f"phase 6d: restart {r} ({n_mcu} MCUs): {len(jpg_r)} bytes, equal "
          f"to CPU: {jpg_r == jpg_r_cpu} (CPU reference {secs:.2f} s)",
          flush=True)
    check(jpg_r == jpg_r_cpu, "unaligned-restart bytes differ from the CPU's")
    px_r = jpeg_tpu_torch.decode(jpg_r, device=dev)
    check(np.array_equal(px_r, px), "restart-7 decode differs from 6's")

    lap("6e")
    # Phase 6e: gray (the image's Y plane), counted.
    gray = np.clip(np.rint(img.astype(np.float64) @ [0.299, 0.587, 0.114]),
                   0, 255).astype(np.uint8)
    t0 = time.perf_counter()
    jpg_g_cpu = jpeg_tpu_torch.encode(gray, QUALITY, device="cpu")
    px_g_cpu = jpeg_tpu_torch.decode(jpg_g_cpu, device="cpu")
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    pack.LAUNCHES = 0
    fused.ZZ_LAUNCHES = 0
    encoder.HOST_PACK_SPILLS = 0
    jpg_g = jpeg_tpu_torch.encode(gray, QUALITY, device=dev)
    px_g = jpeg_tpu_torch.decode(jpg_g, device=dev)
    torch.cuda.synchronize()
    launches_a_g, launches_b_g = pack.LAUNCHES, fused.ZZ_LAUNCHES
    spills = encoder.HOST_PACK_SPILLS
    diff = np.abs(px_g.astype(np.int32) - px_g_cpu.astype(np.int32))
    ndiff = int((diff != 0).sum())
    print(f"phase 6e: gray 4K q{QUALITY}: {len(jpg_g)} bytes, equal to CPU: "
          f"{jpg_g == jpg_g_cpu}; launches: kernel A {launches_a_g}, kernel "
          f"B2 {launches_b_g}; {spills} spills; decode vs CPU: max |diff| "
          f"{int(diff.max())}, {ndiff} of {diff.size} differ; PSNR vs source "
          f"{psnr(px_g, gray):.2f} dB (CPU reference {secs:.2f} s)",
          flush=True)
    check(jpg_g == jpg_g_cpu, "gray bytes differ from the CPU's")
    check(launches_a_g >= 1 and launches_b_g >= 1,
          "gray encode/decode did not launch kernels A and B2")
    check(spills == 0, "gray encode spilled to the host packer")
    check(px_g.shape == gray.shape and px_g.dtype == np.uint8,
          f"gray decoded {px_g.shape} {px_g.dtype}")
    check(int(diff.max()) <= 1 and ndiff <= DIFF_SHARE * diff.size,
          "gray decode differs from the CPU decode")

    lap("6f")
    # Phase 6f: the decode options at 4K, colour then gray, counted.
    # entropy="auto" on the card is the "device" backend: on a stream
    # without restart markers program F and kernel D, once each.
    auto_n = (1, 0, 1)

    for label, stream, px_card, px_ref, nb in (
            ("colour", jpg, px, px_cpu, COLOUR_N),
            ("gray", jpg_g, px_g, px_g_cpu, GRAY_N)):
        keep = label == "colour"
        px_sparse, n_sparse = counted(lambda: jpeg_tpu_torch.decode(
            stream, device=dev, entropy="sparse"),
            path="sparse_decode" if keep else None)
        px_native, n_native = counted(lambda: jpeg_tpu_torch.decode(
            stream, device=dev, entropy="native"),
            path="native_decode" if keep else None)
        args = port_util.scan_args(stream)
        payload = decode_device.sparse_payload(*args)[0]
        dense_bytes = args[1] * sum(bpm for _, bpm, _, _ in args[2]) * 64 * 4
        print(f"phase 6f: {label} 4K decode: launches (A, B, C, B2, H) sparse "
              f"{n_sparse}, native {n_native}; sparse == native: "
              f"{np.array_equal(px_sparse, px_native)}; == the default "
              f"decode: {np.array_equal(px_sparse, px_card)}; payload "
              f"{payload.nbytes} bytes, dense coefficient grids "
              f"{dense_bytes} bytes", flush=True)
        check(n_sparse == nb and n_native == nb,
              f"{label} decode: launches {n_sparse} / {n_native}, not {nb}")
        check(np.array_equal(px_sparse, px_native),
              f"{label}: sparse and native decodes differ")
        check(np.array_equal(px_sparse, px_card),
              f"{label}: the default decode differs from the sparse one")
        for d in (2, 4, 8):
            ref_d, secs = timed(lambda: jpeg_tpu_torch.decode(
                stream, device="cpu", scale_denom=d))
            got_d, n_b = counted(lambda: jpeg_tpu_torch.decode(
                stream, device=dev, scale_denom=d), auto_n)
            worst, ndiff, n = decode_diff(got_d, ref_d)
            print(f"phase 6f: {label} scale_denom {d}: {got_d.shape}, "
                  f"launches {n_b}; vs CPU decode: max |diff| {worst}, "
                  f"{ndiff} of {n} differ (CPU reference {secs:.2f} s)",
                  flush=True)
            check(got_d.shape[:2] == (layout.ceil_div(HEIGHT, d),
                                      layout.ceil_div(WIDTH, d)),
                  f"scale_denom {d} gave {got_d.shape}")
            # The scaled IDCT is two einsums; a colour image still takes H.
            check(n_b == (0, 0, 0, 0, nb[4]),
                  f"a scaled decode launched {n_b}")
        out_dev, n_b = counted(lambda: jpeg_tpu_torch.decode(
            stream, device=dev, device_output=True), auto_n)
        check(n_b == nb, f"{label} device_output: launches {n_b}")
        check(isinstance(out_dev, torch.Tensor)
              and str(out_dev.device) == "cuda:0",
              f"{label}: device_output is not a tensor on cuda:0")
        check(np.array_equal(out_dev.cpu().numpy(), px_card),
              f"{label}: device_output differs from the host result")
        print(f"phase 6f: {label} device_output: {tuple(out_dev.shape)} "
              f"{out_dev.dtype} on {out_dev.device}, equal to the host "
              f"result", flush=True)
    for d in (1, 2):
        planes_d, n_b = counted(lambda: jpeg_tpu_torch.decode(
            jpg, device=dev, output="ycbcr", scale_denom=d), auto_n)
        rgb_d = px if d == 1 else jpeg_tpu_torch.decode(jpg, device=dev,
                                                        scale_denom=d)
        fin = jpeg_tpu_torch.finish_ycbcr(planes_d)
        fin1 = jpeg_tpu_torch.finish_ycbcr(planes_d, threads=1)
        print(f"phase 6f: output='ycbcr' scale_denom {d}: planes "
              f"{[p.shape for p in planes_d.planes]} "
              f"({sum(p.nbytes for p in planes_d.planes)} bytes, RGB "
              f"{rgb_d.nbytes}); launches {n_b}; finish_ycbcr == "
              f"decode(): {np.array_equal(fin, rgb_d)} (1 thread: "
              f"{np.array_equal(fin1, rgb_d)})", flush=True)
        check(n_b == ((0, 0, 0, 1, 0) if d == 1 else NONE_N),
              f"ycbcr output at scale_denom {d}: launches {n_b}")
        check(np.array_equal(fin, rgb_d) and np.array_equal(fin1, rgb_d),
              f"finish_ycbcr differs from decode() at scale_denom {d}")
    planes_dev = jpeg_tpu_torch.decode(jpg, device=dev, output="ycbcr",
                                       device_output=True)
    check(all(str(p.device) == "cuda:0" for p in planes_dev.planes),
          "ycbcr device_output planes are not on cuda:0")
    check(np.array_equal(jpeg_tpu_torch.finish_ycbcr(planes_dev), px),
          "finish_ycbcr of device planes differs from decode()")

    # The device Huffman decoders at 4K, counted: this slice's paths.
    per_huffman = {}
    huffman_path = {
        ("colour", "indexed"): "indexed_decode",
        ("colour", "device"): "device_decode",
        (f"colour restart {ROW_RESTART}", "device"): "device_decode_restarts"}
    for label, stream, nb, restarts in (
            ("colour", jpg, COLOUR_N, False), ("gray", jpg_g, GRAY_N, False),
            (f"colour restart {ROW_RESTART}", jpg_rst, COLOUR_N, True)):
        px_sparse = jpeg_tpu_torch.decode(stream, device=dev,
                                          entropy="sparse")
        for backend, want in (
                ("indexed", (1, 0, 0, 0, 0, 0)),
                ("device", (1, 1, 0, f_launches, 1, 1) if restarts else None)):
            got, abc, huffman_n = counted_all(lambda: jpeg_tpu_torch.decode(
                stream, device=dev, entropy=backend),
                path=huffman_path.get((label, backend)))
            same = np.array_equal(got, px_sparse)
            print(f"phase 6f: {label} 4K decode, entropy {backend!r}: "
                  f"launches (A, B, C, B2, H) {abc}, (D, E, F, F's separate "
                  f"launches, native scan calls, DC sums) {huffman_n}; == "
                  f"sparse: {same}", flush=True)
            check(same, f"{label}: {backend!r} pixels differ from sparse")
            check(abc == nb, f"{label} {backend!r}: launches {abc}")
            if want is None:  # no markers: program F, DC sums, kernel D
                check(huffman_n == (1, 0, 1, f_launches, 1, 1),
                      f"{label} 'device': launches {huffman_n}")
            else:
                check(huffman_n == want,
                      f"{label} {backend!r}: launches {huffman_n}")
            per_huffman[label, backend] = huffman_n
    # One flipped byte in the middle of the 4K scan, one that makes no
    # marker and breaks no stuffing: the three backends agree on it.
    at = jpg.index(b"\xff\xda") + 14 + len(info.scan_data) // 2
    while 0xFF in (jpg[at - 1], jpg[at], jpg[at + 1]):
        at += 1
    corrupt = bytearray(jpg)
    corrupt[at] = (corrupt[at] ^ 0x10) & 0xFE
    verdicts = {}
    for backend in ("sparse", "indexed", "device"):
        t0 = time.perf_counter()
        try:
            verdicts[backend] = jpeg_tpu_torch.decode(
                bytes(corrupt), device=dev, entropy=backend)
        except ScanDecodeError as e:
            verdicts[backend] = f"ScanDecodeError: {e}"
        torch.cuda.synchronize()
        shown = verdicts[backend] if isinstance(verdicts[backend], str) else (
            f"decoded {verdicts[backend].shape}")
        print(f"phase 6f: 4K scan with byte {at} flipped, entropy "
              f"{backend!r}: {shown} in {time.perf_counter() - t0:.3f} s",
              flush=True)
    raised = [isinstance(v, str) for v in verdicts.values()]
    check(all(raised) or not any(raised),
          "the backends disagree on whether the corrupt scan decodes")
    if not any(raised):
        check(np.array_equal(verdicts["sparse"], verdicts["indexed"])
              and np.array_equal(verdicts["sparse"], verdicts["device"]),
              "the backends decode the corrupt scan to different pixels")
    del verdicts

    # decode(use_pallas=False), jpeg_tpu's default formulation: one (64, 64)
    # matmul per plane on the card and no launch of kernel B2; the default
    # decode (kernel B2) in turns with it. The matmul sums each sample in
    # another order than kernel B2, so a sample on a .5 boundary may round the
    # other way: the samples after the IDCT (the gray pixels, the colour
    # stream's output="ycbcr" planes) are held to the decode contract, +-1 in
    # <= DIFF_SHARE; after the colour map a chroma sample 1 apart moves R or
    # B by up to 1.772, so the colour pixels may differ by up to 3.
    ms_no_pallas = {}
    for label, stream, px_card, nb in (("colour", jpg, px, COLOUR_N),
                                       ("gray", jpg_g, px_g, GRAY_N)):
        got, n_b = counted(lambda: jpeg_tpu_torch.decode(
            stream, device=dev, use_pallas=False), auto_n,
            path="use_pallas_false_decode" if label == "colour" else None)
        # The (64, 64) matmul instead of B2; a colour image still takes H.
        check(n_b == (0, 0, 0, 0, nb[4]),
              f"{label} use_pallas=False: launches {n_b}")
        _, n_default = counted(lambda: jpeg_tpu_torch.decode(
            stream, device=dev), auto_n)
        check(n_default == nb,
              f"{label} default decode: launches {n_default}")
        pairs = [(got, px_card)]
        if label == "colour":
            planes_np = jpeg_tpu_torch.decode(stream, device=dev,
                                              use_pallas=False, output="ycbcr")
            check(np.array_equal(jpeg_tpu_torch.finish_ycbcr(planes_np), got),
                  "use_pallas=False: finish_ycbcr differs from decode()")
            pairs = list(zip(planes_np.planes, jpeg_tpu_torch.decode(
                stream, device=dev, output="ycbcr").planes))
        for a, b in pairs:  # the samples after the IDCT
            worst, ndiff, n = decode_diff(a, b)
            print(f"phase 6f: {label} 4K use_pallas=False, samples after the "
                  f"IDCT {a.shape} vs the default decode's: max |diff| "
                  f"{worst}, {ndiff} of {n} differ", flush=True)
        diff = np.abs(got.astype(np.int32) - px_card.astype(np.int32))
        worst, ndiff = int(diff.max(initial=0)), int((diff != 0).sum())
        check(worst <= (3 if label == "colour" else 1)
              and ndiff <= DIFF_SHARE * diff.size,
              f"{label} use_pallas=False: pixels {worst} apart in {ndiff}")
        ms_no_pallas[label] = medians_in_turns({
            "default (kernel B2)": lambda: jpeg_tpu_torch.decode(
                stream, device=dev),
            "use_pallas=False": lambda: jpeg_tpu_torch.decode(
                stream, device=dev, use_pallas=False),
        }, torch, runs=RUNS)
        print(f"phase 6f: {label} 4K decode use_pallas=False: launches "
              f"(A, B, C, B2, H) {n_b}, default {n_default}; pixels vs the "
              f"default "
              f"decode: max |diff| {worst}, {ndiff} of {diff.size} differ "
              f"(by 1: {int((diff == 1).sum())}); in turns, medians of "
              f"{RUNS}: " + "; ".join(f"{k} {v:.3f} ms"
                                       for k, v in ms_no_pallas[label].items())
              + f" [{card}]", flush=True)

    lap("6g")
    # Phase 6g: the stream types only the host walkers read, on the card.
    for name, (_build, shape) in sorted(port_fixtures.FIXTURES.items()):
        data = port_fixtures.read(name)
        ref = jpeg_tpu_torch.decode(data, device="cpu")
        parsed = jfif.parse_jpeg(data)
        one_scan = not parsed.progressive and len(parsed.scans) == 1
        got, n_b = counted(
            lambda: jpeg_tpu_torch.decode(data, device=dev),
            ((1, 1, 0) if parsed.restart_interval else auto_n) if one_scan
            else (0, 0, 0))
        worst, ndiff, n = decode_diff(got, ref)
        print(f"phase 6g: {name}: {got.shape}, launches {n_b}; vs "
              f"CPU decode: max |diff| {worst}, {ndiff} of {n} differ",
              flush=True)
        check(got.shape == shape, f"{name} decoded to {got.shape}")
        # CMYK and YCCK keep kernel B (four components, the f32 finish).
        want_n = {1: GRAY_N, 3: COLOUR_N, 4: (0, 4, 0, 0, 0)}[
            shape[2] if len(shape) == 3 else 1]
        check(n_b == want_n, f"{name}: launches {n_b}, not {want_n}")
        if name.startswith("noninterleaved"):
            # Three scans: each takes kernel D once with "indexed"; with
            # "device" kernel D and the block-start program once each, as
            # E's route if it has restart markers, else as program F.
            marked = all(sc.restart_interval for sc in parsed.scans)
            for backend, want in (
                    ("indexed", (3, 0, 0)),
                    ("device", (3, 3, 0) if marked else (3, 0, 3))):
                other, abc, huffman_n = counted_all(
                    lambda: jpeg_tpu_torch.decode(data, device=dev,
                                                  entropy=backend))
                print(f"phase 6g: {name}, entropy {backend!r}: == the "
                      f"default decode: {np.array_equal(other, got)}; "
                      f"launches {abc}, {huffman_n}", flush=True)
                check(np.array_equal(other, got),
                      f"{name}: {backend!r} differs from the default decode")
                check(abc == n_b and huffman_n[:3] == want,
                      f"{name} {backend!r}: launches {abc}, {huffman_n}")


    # Phases 6h-6l: the serving entry points, counted like the rest. Frames
    # are the 4K image rolled by a multiple of ROLL columns.
    def frame(i):
        return np.roll(img, i * ROLL, axis=1)

    def frames(n):
        return (frame(i) for i in range(n))

    def digest(data) -> str:
        return hashlib.sha256(data).hexdigest()

    lap("6h")
    # Phase 6h: encode_batched.
    batch8 = np.stack(list(frames(BATCH_ENCODE)))
    jpgs8 = [jpeg_tpu_torch.encode(im, QUALITY, SUBSAMPLING, device=dev)
             for im in batch8]
    check(jpgs8[0] == jpg and len(set(jpgs8)) == BATCH_ENCODE,
          "the batch's frames are not distinct images")
    encoder.HOST_PACK_SPILLS = 0
    scans_before = pack.SCAN_LAUNCHES
    got8, per_batch_enc = counted(lambda: jpeg_tpu_torch.encode_batched(
        batch8, QUALITY, SUBSAMPLING, device=dev), path="encode_batched_k8")
    spills = encoder.HOST_PACK_SPILLS
    scans_batch = pack.SCAN_LAUNCHES - scans_before
    print(f"phase 6h: encode_batched K={BATCH_ENCODE} 4K q{QUALITY} "
          f"{SUBSAMPLING}: {[len(j) for j in got8]} bytes; equal to "
          f"encode() per image: {got8 == jpgs8}; launches (A, B, C, B2, H) "
          f"{per_batch_enc}, scan pass {scans_batch}; host-pack spills "
          f"{spills}", flush=True)
    check(got8 == jpgs8, "encode_batched bytes differ from encode()'s")
    check(per_batch_enc == ENCODE_N,
          f"encode_batched launched {per_batch_enc}, not one kernel A")
    check(scans_batch == BATCH_ENCODE * scan_per_encode,
          f"encode_batched launched {scans_batch} scan-pass kernels, not "
          f"one pass per image")
    check(spills == 0, f"{spills} host-pack spills in encode_batched")
    small = np.stack([make_image(777, 1001, seed=s) for s in range(3)])
    row_mcus = layout.ceil_div(1001, 8)
    for label, kw, want in (
            (f"K=3 1001x777 444 restart {row_mcus}",
             dict(subsampling="444", restart_interval=row_mcus), ENCODE_N),
            ("K=2 1001x777 420 device_pack=False",
             dict(subsampling="420", device_pack=False), NONE_N)):
        imgs = small[:2] if "device_pack" in kw else small
        got, n_b = counted(lambda: jpeg_tpu_torch.encode_batched(
            imgs, QUALITY, device=dev, **kw))
        ref = [jpeg_tpu_torch.encode(im, QUALITY, device=dev, **kw)
               for im in imgs]
        print(f"phase 6h: encode_batched {label}: equal to encode() per "
              f"image: {got == ref}; launches {n_b}", flush=True)
        check(got == ref, f"encode_batched {label}: bytes differ")
        check(n_b == want, f"encode_batched {label}: launches {n_b}")
    check(encoder.HOST_PACK_SPILLS == 0, "host-pack spill in phase 6h")
    # Kernel A against its twin on the blocks the two device-packed batches
    # give it: the padded batch through the transform, the prediction
    # restarting at every image (and at every restart interval).
    for label, imgs, sub, seg in (
            (f"K={BATCH_ENCODE} 4K {SUBSAMPLING}", batch8, mode, n_mcu),
            ("K=3 1001x777 444", small, Subsampling("444"), row_mcus)):
        dbatch = tile.pad_batch_to_multiple(
            torch.as_tensor(imgs, device=dev), sub.mcu_height, sub.mcu_width)
        blk, tb, _, _ = encoder._interleaved_blocks(dbatch, qy, qc, sub, seg)
        del dbatch
        e, n = level1_err(pack.pack_level1(blk, tb, *luts, packed=packed),
                          pack.pack_level1_reference(blk, tb, *luts), budget)
        print(f"phase 6h: kernel A vs plain, the blocks of encode_batched "
              f"{label}: {n} blocks, max |err| {e}", flush=True)
        check(e == 0, f"kernel A disagrees with its twin on the {label} "
              f"batch's blocks ({e})")
        err_a = max(err_a, e)
        del blk, tb

    lap("6i")
    # Phase 6i: decode_batched.
    jpgs4 = jpgs8[:BATCH_DECODE]
    px4 = np.stack([jpeg_tpu_torch.decode(j, device=dev) for j in jpgs4])
    check(np.array_equal(px4[0], px), "decode() is not repeatable")
    per_batch_dec = {}
    for bm in ("fused", "pipelined", "auto"):
        got, per_batch_dec[bm] = counted(
            lambda: jpeg_tpu_torch.decode_batched(jpgs4, batch_mode=bm,
                                                  device=dev),
            path=f"decode_batched_{bm}_k4")
        print(f"phase 6i: decode_batched K={BATCH_DECODE} {bm!r}: "
              f"{got.shape} {got.dtype}; equal to decode() per image: "
              f"{np.array_equal(got, px4)}; launches {per_batch_dec[bm]}",
              flush=True)
        check(got.shape == px4.shape and got.dtype == np.uint8
              and np.array_equal(got, px4),
              f"decode_batched {bm!r} differs from decode() per image")
    auto_mode = decoder.AUTO_BATCH_MODE
    check(per_batch_dec["fused"] == COLOUR_N,
          f"fused decode_batched launched {per_batch_dec['fused']}")
    check(per_batch_dec["pipelined"] == times(BATCH_DECODE, COLOUR_N),
          f"pipelined decode_batched launched {per_batch_dec['pipelined']}")
    check(per_batch_dec["auto"] == per_batch_dec[auto_mode],
          f"'auto' launched {per_batch_dec['auto']}, not {auto_mode!r}'s")
    px4_half = np.stack([jpeg_tpu_torch.decode(j, device=dev, scale_denom=2)
                         for j in jpgs4])
    for bm in ("fused", "pipelined"):
        got, n_b = counted(lambda: jpeg_tpu_torch.decode_batched(
            jpgs4, scale_denom=2, batch_mode=bm, device=dev))
        print(f"phase 6i: decode_batched {bm!r} scale_denom 2: {got.shape}; "
              f"equal to decode() per image: "
              f"{np.array_equal(got, px4_half)}; launches {n_b}", flush=True)
        check(np.array_equal(got, px4_half),
              f"decode_batched {bm!r} scale_denom 2 differs from decode()")
        check(n_b == (0, 0, 0, 0, 1 if bm == "fused" else BATCH_DECODE),
              f"a scaled batch launched {n_b}")
    out_dev = jpeg_tpu_torch.decode_batched(jpgs4, device_output=True,
                                            device=dev)
    check(isinstance(out_dev, torch.Tensor) and str(out_dev.device) == "cuda:0"
          and np.array_equal(out_dev.cpu().numpy(), px4),
          "decode_batched device_output is not the pixels on cuda:0")
    del out_dev
    small_jpg = jpeg_tpu_torch.encode(small[0], QUALITY, "420", device=dev)
    try:
        jpeg_tpu_torch.decode_batched(jpgs4[:2] + [small_jpg], device=dev)
    except ValueError as e:
        print(f"phase 6i: a stream of another size raises ValueError: {e}",
              flush=True)
    else:
        raise PhaseError("decode_batched took streams of two sizes")
    # Kernel B against its twin on the planes the fused batch gives it: the
    # streams' planes stacked along their rows, one plane per component.
    per_stream = [coefficient_planes(jfif.parse_jpeg(j))[1] for j in jpgs4]
    for c in range(len(comps)):
        stacked = torch.cat([p[c][0] for p in per_stream])
        qt = per_stream[0][c][1]
        e = float((fused.fused_dequant_idct(stacked, qt)
                   - fused.fused_dequant_idct_reference(stacked, qt)
                   ).abs().max())
        print(f"phase 6i: kernel B vs plain, the fused batch's stacked plane "
              f"{tuple(stacked.shape)}: max |err| {e:.3g}", flush=True)
        check(e <= 1e-2, f"kernel B disagrees with its plain twin on the "
              f"stacked plane {tuple(stacked.shape)} ({e})")
        err_b = max(err_b, e)
        del stacked
    del per_stream

    lap("6j")
    # Phase 6j: encode_stream.
    want_hash = [digest(jpeg_tpu_torch.encode(f, QUALITY, SUBSAMPLING,
                                              device=dev))
                 for f in frames(STREAM_ENCODE)]
    encoder.HOST_PACK_SPILLS = 0
    streamed, n_b = counted(lambda: list(jpeg_tpu_torch.encode_stream(
        frames(STREAM_ENCODE), QUALITY, SUBSAMPLING, depth=2, device=dev)),
        path="encode_stream_per_image", images=STREAM_ENCODE)
    same = [digest(j) for j in streamed] == want_hash
    print(f"phase 6j: encode_stream {STREAM_ENCODE} x 4K depth 2: "
          f"{len(set(want_hash))} distinct streams, equal to encode() per "
          f"image: {same}; launches {n_b}; spills "
          f"{encoder.HOST_PACK_SPILLS}", flush=True)
    check(len(streamed) == STREAM_ENCODE and same,
          "encode_stream bytes differ from encode()'s")
    check(n_b == times(STREAM_ENCODE, ENCODE_N),
          f"encode_stream launched {n_b}")
    check(encoder.HOST_PACK_SPILLS == 0, "host-pack spill in encode_stream")
    mixed = [img, small[0], make_image(480, 640, seed=480),
             make_image(768, 1024, seed=768)]
    got, n_b = counted(lambda: list(jpeg_tpu_torch.encode_stream(
        iter(mixed), QUALITY, SUBSAMPLING, depth=2, optimize_tables=True,
        device=dev)))
    ref = [jpeg_tpu_torch.encode(im, QUALITY, SUBSAMPLING,
                                 optimize_tables=True, device=dev)
           for im in mixed]
    print(f"phase 6j: encode_stream, 4 sizes, optimize_tables: equal to "
          f"encode() per image: {got == ref} (first also to 6c's: "
          f"{got[0] == jpg_opt}); launches {n_b}", flush=True)
    check(got == ref and got[0] == jpg_opt,
          "encode_stream optimize_tables bytes differ from encode()'s")
    check(n_b == times(len(mixed), ENCODE_N),
          f"encode_stream optimize_tables launched {n_b}")

    lap("6k")
    # Phase 6k: decode_stream; the launches come from the workers' threads.
    jpgs16 = streamed[:STREAM_DECODE]
    del streamed
    want_px = [digest(jpeg_tpu_torch.decode(j, device=dev)) for j in jpgs16]
    check(len(set(want_px)) == STREAM_DECODE, "the streams' pixels repeat")
    for depth in (2, 4):
        got, n_b = counted(lambda: [digest(out) for out in
                                    jpeg_tpu_torch.decode_stream(
                                        iter(jpgs16), depth=depth,
                                        device=dev)],
                           tuple(n * STREAM_DECODE for n in auto_n),
                           path="decode_stream_per_image",
                           images=STREAM_DECODE)
        print(f"phase 6k: decode_stream {STREAM_DECODE} x 4K depth {depth}: "
              f"equal to decode() per stream, in order: {got == want_px}; "
              f"launches {n_b}", flush=True)
        check(got == want_px, f"decode_stream depth {depth} differs from "
              "decode() per stream")
        check(n_b == times(STREAM_DECODE, COLOUR_N),
              f"decode_stream depth {depth} launched {n_b}")
    got, abc, huffman_n = counted_all(lambda: [
        digest(out) for out in jpeg_tpu_torch.decode_stream(
            iter(jpgs16), depth=4, entropy="indexed", device=dev)])
    print(f"phase 6k: decode_stream {STREAM_DECODE} x 4K depth 4, entropy "
          f"'indexed': equal to decode() per stream, in order: "
          f"{got == want_px}; launches {abc}, {huffman_n}", flush=True)
    check(got == want_px, "decode_stream with 'indexed' differs from decode()")
    check(abc == times(STREAM_DECODE, COLOUR_N)
          and huffman_n == (STREAM_DECODE, 0, 0, 0, 0, 0),
          f"decode_stream with 'indexed' launched {abc}, {huffman_n}")
    odd = jpgs16[:2] + [small_jpg, jpg_g] + jpgs16[2:4]
    got, n_b = counted(lambda: list(jpeg_tpu_torch.decode_stream(
        odd, depth=2, device_output=True, device=dev)),
        tuple(n * len(odd) for n in auto_n))
    ok = all(isinstance(o, torch.Tensor) and str(o.device) == "cuda:0"
             for o in got)
    ok = ok and all(
        np.array_equal(o.cpu().numpy(), jpeg_tpu_torch.decode(j, device=dev))
        for o, j in zip(got, odd))
    print(f"phase 6k: decode_stream with a 1001x777 and a gray stream in the "
          f"middle, device_output: {[tuple(o.shape) for o in got]}; equal "
          f"to decode() per stream: {ok}; launches {n_b}", flush=True)
    check(ok, "decode_stream of mixed geometries differs from decode()")
    check(n_b == (0, 0, 0, 5 + 1, 5),
          f"mixed decode_stream launched {n_b}")
    del got

    lap("6l")
    # Phase 6l: the multi-scan and the progressive encoders.
    from jpeg_tpu_torch.models.progressive_enc import encode_progressive

    ni_cpu, secs = timed(lambda: jpeg_tpu_torch.encode_noninterleaved(
        img, QUALITY, device="cpu"))
    (ni, secs_card), n_b = counted(lambda: timed(
        lambda: jpeg_tpu_torch.encode_noninterleaved(img, QUALITY,
                                                     device=dev)))
    jpg444 = jpeg_tpu_torch.encode(img, QUALITY, "444", device=dev)
    px_ni = jpeg_tpu_torch.decode(ni, device=dev)
    info_ni = jfif.parse_jpeg(ni)
    print(f"phase 6l: encode_noninterleaved 4K q{QUALITY}: {len(ni)} bytes in "
          f"{len(info_ni.scans)} scans, equal to CPU: {ni == ni_cpu}; decode "
          f"equals the 4:4:4 baseline stream's: "
          f"{np.array_equal(px_ni, jpeg_tpu_torch.decode(jpg444, device=dev))}"
          f"; launches {n_b}; {secs_card:.2f} s on the card, CPU reference "
          f"{secs:.2f} s", flush=True)
    check(ni == ni_cpu, "encode_noninterleaved bytes differ from the CPU's")
    check(len(info_ni.scans) == 3, "encode_noninterleaved is not three scans")
    check(np.array_equal(px_ni, jpeg_tpu_torch.decode(jpg444, device=dev)),
          "the multi-scan stream decodes to other pixels than the baseline")
    check(n_b == NONE_N, f"encode_noninterleaved launched {n_b}")
    del px_ni
    for label, im, kw in (
            ("1024x768 4:2:0", make_image(768, 1024, seed=768),
             dict(subsampling="420")),
            ("640x480 gray", make_image(480, 640, seed=480)[..., 0], {})):
        pr_cpu, secs = timed(lambda: encode_progressive(
            im, QUALITY, device="cpu", **kw))
        pr, secs_card = timed(lambda: encode_progressive(
            im, QUALITY, device=dev, **kw))
        base = jpeg_tpu_torch.encode(im, QUALITY, device=dev, **kw)
        same_px = np.array_equal(jpeg_tpu_torch.decode(pr, device=dev),
                                 jpeg_tpu_torch.decode(base, device=dev))
        info_pr = jfif.parse_jpeg(pr)
        print(f"phase 6l: encode_progressive {label}: {len(pr)} bytes in "
              f"{len(info_pr.scans)} scans (baseline {len(base)}), equal to "
              f"CPU: {pr == pr_cpu}; decode equals the baseline stream's: "
              f"{same_px}; {secs_card:.2f} s on the card, CPU {secs:.2f} s",
              flush=True)
        check(info_pr.progressive, "encode_progressive did not write SOF2")
        check(pr == pr_cpu, f"progressive {label} bytes differ from the CPU's")
        check(same_px, f"progressive {label} decodes to other pixels than "
              "the baseline stream")

    lap("6m")
    # Phase 6m: the mesh layer (parallel.mesh/shard/batch/mosaic) on the one
    # card: a (2, 3) mesh of six positions, all on cuda:0.
    from jpeg_tpu_torch.parallel import (
        batch as pbatch, mesh as pmesh, mosaic as pmosaic, shard as pshard)

    t_phase = time.perf_counter()
    default_mesh = pmesh.make_mesh()
    print(f"phase 6m: make_mesh() on this machine: {default_mesh}", flush=True)
    if torch.cuda.device_count() == 1:
        check(default_mesh.shape == {"batch": 1, "mcu": 1},
              f"make_mesh() on one card is {default_mesh.shape}")
    mesh6 = pmesh.make_mesh(6, batch_axis=2, devices=[dev] * 6)
    check(mesh6.shape == {"batch": 2, "mcu": 3}, f"mesh {mesh6.shape}")
    mcu_rows_4k = HEIGHT // mode.mcu_height
    stripe_mcus = mcu_rows_4k // 3 * (WIDTH // mode.mcu_width)  # 10,800
    got, n_b = counted(lambda: pbatch.encode_batch(
        batch8, QUALITY, SUBSAMPLING, mesh=mesh6, stripe_restart=False),
        path="encode_batch_mesh_host_pack")
    print(f"phase 6m: encode_batch K={BATCH_ENCODE} on {mesh6.shape}, no "
          f"stripe restarts (DC by ppermute, host pack): equal to encode() "
          f"per image: {got == jpgs8}; launches {n_b}", flush=True)
    check(got == jpgs8, "encode_batch(stripe_restart=False) differs from "
          "encode()")
    check(n_b == NONE_N, f"the host-packed encode_batch launched {n_b}")
    want_r = [jpeg_tpu_torch.encode(im, QUALITY, SUBSAMPLING,
                                    restart_interval=stripe_mcus, device=dev)
              for im in batch8]
    pbatch.DEVICE_PACK_FALLBACKS = 0
    got_dp, n_b = counted(lambda: pbatch.encode_batch(
        batch8, QUALITY, SUBSAMPLING, mesh=mesh6, device_pack=True),
        path="encode_batch_mesh")
    got_hp = pbatch.encode_batch(batch8, QUALITY, SUBSAMPLING, mesh=mesh6)
    fallbacks = pbatch.DEVICE_PACK_FALLBACKS
    print(f"phase 6m: encode_batch, stripe restarts of {stripe_mcus} MCUs: "
          f"device pack == host pack: {got_dp == got_hp}; equal to "
          f"encode(restart_interval={stripe_mcus}): {got_dp == want_r}; "
          f"launches {n_b}; device-pack fallbacks {fallbacks}", flush=True)
    check(got_dp == got_hp == want_r, "encode_batch with stripe restarts "
          "differs from encode() or between its packs")
    check(n_b == times(6, ENCODE_N),
          f"encode_batch(device_pack) launched {n_b}, not "
          "kernel A once per position")
    check(fallbacks == 0, f"{fallbacks} device-pack fallbacks at q{QUALITY}")
    opt_dp, n_b = counted(lambda: pbatch.encode_batch(
        batch8, QUALITY, SUBSAMPLING, mesh=mesh6, device_pack=True,
        optimize_tables=True))
    opt_hp = pbatch.encode_batch(batch8, QUALITY, SUBSAMPLING, mesh=mesh6,
                                 optimize_tables=True)
    print(f"phase 6m: encode_batch optimize_tables: device pack == host "
          f"pack: {opt_dp == opt_hp}; {sum(map(len, opt_dp))} bytes against "
          f"{sum(map(len, got_dp))} standard; launches {n_b}", flush=True)
    check(opt_dp == opt_hp, "optimize_tables device pack differs from host")
    check(opt_dp != got_dp, "optimize_tables gave the standard tables' bytes")
    check(pbatch.DEVICE_PACK_FALLBACKS == 0, "device-pack fallback in 6m")
    px8 = np.stack([jpeg_tpu_torch.decode(j, device=dev) for j in jpgs8])
    for entropy, want in (("auto", (8, 0, 8)), ("sparse", (0, 0, 0))):
        got, abc, huffman_n = counted_all(
            lambda: pbatch.decode_batch(jpgs8, mesh=mesh6, entropy=entropy),
            path=f"decode_batch_mesh_{entropy}")
        print(f"phase 6m: decode_batch K={BATCH_ENCODE} on {mesh6.shape}, "
              f"entropy {entropy!r}: equal to decode() per image: "
              f"{np.array_equal(got, px8)}; launches (A, B, C, B2, H) {abc}, "
              f"(D, E, F) {huffman_n[:3]}", flush=True)
        check(got.shape == px8.shape and np.array_equal(got, px8),
              f"decode_batch {entropy!r} differs from decode()")
        check(abc == (0, 18, 0, 0, 0), f"decode_batch launched {abc}: kernel "
              "B is 3 launches per position (the stripes keep the f32 finish)")
        check(huffman_n[:3] == want, f"decode_batch {entropy!r}: (D, E, F) "
              f"{huffman_n[:3]}, expected {want}")
    # Kernels A and B against their twins on position (0, 0)'s stripe: the
    # first 720 rows of images 0-3.
    stripe = torch.as_tensor(batch8[:4, :HEIGHT // 3], device=dev)
    blk, tb, _ = pshard._stripe_blocks(stripe, qy, qc, mode)
    e, n = level1_err(pack.pack_level1(blk, tb, *luts, packed=packed),
                      pack.pack_level1_reference(blk, tb, *luts), budget)
    print(f"phase 6m: kernel A vs plain, position (0, 0)'s stripe: {n} "
          f"blocks, max |err| {e}", flush=True)
    check(e == 0, f"kernel A disagrees with its twin on a stripe ({e})")
    err_a = max(err_a, e)
    del stripe, blk, tb
    stripe_planes = [coefficient_planes(jfif.parse_jpeg(j))[1]
                     for j in jpgs8[:4]]
    for c in range(len(comps)):
        rows = stripe_planes[0][c][0].shape[0] // 3
        plane = torch.cat([p[c][0][:rows] for p in stripe_planes])
        qt = stripe_planes[0][c][1]
        e = float((fused.fused_dequant_idct(plane, qt)
                   - fused.fused_dequant_idct_reference(plane, qt)
                   ).abs().max())
        print(f"phase 6m: kernel B vs plain, position (0, 0)'s stacked "
              f"stripe plane {tuple(plane.shape)}: max |err| {e:.3g}",
              flush=True)
        check(e <= 1e-2, f"kernel B disagrees with its twin on the stripe "
              f"plane {tuple(plane.shape)} ({e})")
        err_b = max(err_b, e)
    del stripe_planes, plane
    big4 = pmosaic.assemble_tiles(np.stack(list(frames(4))).reshape(
        2, 2, HEIGHT, WIDTH, 3))
    mesh16 = pmesh.make_mesh(6, batch_axis=1, devices=[dev] * 6)
    mosaic_r = (2 * HEIGHT // mode.mcu_height // 6) * (2 * WIDTH
                                                        // mode.mcu_width)
    want_big4 = jpeg_tpu_torch.encode(big4, QUALITY, SUBSAMPLING,
                                      restart_interval=mosaic_r, device=dev)
    for dp_flag in (True, False):
        got, n_b = counted(lambda: pmosaic.encode_mosaic(
            big4, QUALITY, SUBSAMPLING, mesh=mesh16, device_pack=dp_flag))
        print(f"phase 6m: encode_mosaic 2x2 4K tiles ({2 * WIDTH}x"
              f"{2 * HEIGHT}) on {mesh16.shape}, device_pack={dp_flag}: "
              f"{len(got)} bytes, equal to encode(restart_interval="
              f"{mosaic_r}): {got == want_big4}; launches {n_b}", flush=True)
        check(got == want_big4, "encode_mosaic differs from encode()")
        check(n_b == (times(6, ENCODE_N) if dp_flag else NONE_N),
              f"encode_mosaic launched {n_b}")
    check(pbatch.DEVICE_PACK_FALLBACKS == 0, "device-pack fallback in 6m")
    print(f"phase 6m: {time.perf_counter() - t_phase:.1f} s", flush=True)

    lap("6p")
    # Phase 6p: the mesh over torch.distributed ranks (make_multihost_mesh):
    # this script again as 2 gloo ranks of 3 positions each on cuda:0 (NCCL
    # refuses two ranks on one card), then as 1 NCCL rank of 6 positions
    # (NCCL's all_reduce and all_gather on CUDA tensors). Every rank's
    # streams and pixels must hash equal to 6m's single-process results;
    # its launches are counted per path.
    t_phase = time.perf_counter()
    want_6p = {
        "encode_batch": hash_streams(want_r),
        "encode_batch_no_restart": hash_streams(jpgs8),
        "encode_batch_optimize": hash_streams(opt_dp),
        "decode_batch": hash_pixels(px8),
        "encode_mosaic": hash_streams([want_big4]),
        "decode_mosaic": hash_pixels(
            jpeg_tpu_torch.decode(want_big4, device=dev)[None]),
    }
    rank_path_names = []
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the ranks share the card with this process
    with tempfile.TemporaryDirectory() as tmp:
        for backend, world in (("gloo", 2), ("nccl", 1)):
            n = RANK_POSITIONS // world
            # Per rank (A, B, C, B2, H, D, E, F): kernel A once per
            # position, B three times (the stripes' f32 finish); D and F
            # once per image of the rank's batch rows (4 of a (2, 3) row),
            # D and E's route once for the mosaic's stream with restarts
            # (its one row is every rank's).
            want_n = {
                "encode_batch": (n, 0, 0, 0, 0, 0, 0, 0),
                "encode_batch_no_restart": (0,) * 8,
                "encode_batch_optimize": (n, 0, 0, 0, 0, 0, 0, 0),
                "decode_batch": (0, 3 * n, 0, 0, 0, 8 // world, 0,
                                 8 // world),
                "encode_mosaic": (n, 0, 0, 0, 0, 0, 0, 0),
                "decode_mosaic": (0, 3 * n, 0, 0, 0, 1, 1, 0),
            }
            t0 = time.perf_counter()
            reports = run_ranks(backend, world, tmp)
            print(f"phase 6p: {backend}, {world} rank(s) of {n} positions on "
                  f"{dev}: exited 0 in {time.perf_counter() - t0:.1f} s",
                  flush=True)
            for r, rep in enumerate(reports):
                check(list(rep["paths"]) == list(want_6p),
                      f"{backend} rank {r} ran {list(rep['paths'])}")
                print(f"phase 6p: {backend} rank {r} of {world}, decode_batch "
                      f"stages, medians of {RUNS}: " + "; ".join(
                          f"{k} {v:.3f} ms"
                          for k, v in rep["decode_stages"].items())
                      + f" [{card}]", flush=True)
                for name, got in rep["paths"].items():
                    abc, huffman_n = got["launches"][:5], got["launches"][5:]
                    path = f"{name}_{backend}{world}_rank{r}"
                    path_counts[path] = (tuple(abc), tuple(huffman_n))
                    rank_path_names.append(path)
                    same = got["hash"] == want_6p[name]
                    a, b, d, f = (got["launches"][i] for i in (0, 1, 5, 7))
                    print(f"phase 6p: {backend} rank {r} of {world}, {name}: "
                          f"hash equal to 6m's: {same}; launches (A, B, D, F) "
                          f"{(a, b, d, f)}; first call {got['first_ms']:.3f} "
                          f"ms, median of {RANK_RUNS} {got['ms']:.3f} ms; "
                          f"bytes from other ranks {got['xrank_bytes']} "
                          f"[{card}]", flush=True)
                    check(same, f"{backend} rank {r}: {name} differs from "
                          "the single-process result")
                    check(tuple(got["launches"][:8]) == want_n[name],
                          f"{backend} rank {r}: {name} launched "
                          f"{got['launches'][:8]}, expected {want_n[name]}")
                    check((got["xrank_bytes"] > 0) == (world > 1),
                          f"{backend} rank {r}: {name} took "
                          f"{got['xrank_bytes']} bytes from other ranks")
    print(f"phase 6p: {time.perf_counter() - t_phase:.1f} s", flush=True)

    lap("6n")
    # Phase 6n: encode_mosaic_stream of a 4x4 grid of 4K tiles, stripe by
    # stripe from a source callable, against encode() of the whole image.
    t_phase = time.perf_counter()
    big16 = pmosaic.assemble_tiles(np.stack(list(frames(16))).reshape(
        4, 4, HEIGHT, WIDTH, 3))
    bh, bw = big16.shape[:2]
    row_mcus = bw // mode.mcu_width  # 960
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    want16 = jpeg_tpu_torch.encode(big16, QUALITY, SUBSAMPLING,
                                   restart_interval=row_mcus, device=dev)
    peak_full16 = torch.cuda.max_memory_allocated()
    pulls = []

    def source16(a, b):
        pulls.append((a, b))
        return big16[a:b]

    torch.cuda.reset_peak_memory_stats()
    got16, n_b = counted(lambda: pmosaic.encode_mosaic_stream(
        source16, bh, bw, QUALITY, SUBSAMPLING, rst_rows=1, device=dev),
        path="encode_mosaic_stream")
    peak_stream16 = torch.cuda.max_memory_allocated()
    same16 = digest(got16) == digest(want16)
    print(f"phase 6n: encode_mosaic_stream 4x4 4K tiles ({bw}x{bh}, "
          f"{bw * bh / 1e6:.1f} MPix), rst_rows=1 ({len(pulls)} stripes of "
          f"{pulls[0][1]} rows): {len(got16)} bytes, hash equal to "
          f"encode(restart_interval={row_mcus}): {same16}; launches {n_b}; "
          f"peak device memory: stream {peak_stream16} bytes, whole-image "
          f"encode {peak_full16} bytes [{card}]", flush=True)
    check(same16, "encode_mosaic_stream differs from encode() of the image")
    check(n_b == times(len(pulls), ENCODE_N),
          f"encode_mosaic_stream launched {n_b} over {len(pulls)} stripes")
    check(peak_stream16 < peak_full16 / 4, "the stream's device memory is "
          "not bounded by a stripe")
    check(pbatch.DEVICE_PACK_FALLBACKS == 0, "device-pack fallback in 6n")
    del want16
    bh4, bw4 = big4.shape[:2]
    want_opt = jpeg_tpu_torch.encode(big4, QUALITY, SUBSAMPLING,
                                      restart_interval=bw4 // mode.mcu_width,
                                      optimize_tables=True, device=dev)
    got_opt = pmosaic.encode_mosaic_stream(
        lambda a, b: big4[a:b], bh4, bw4, QUALITY, SUBSAMPLING,
        optimize_tables=True, device=dev)
    print(f"phase 6n: encode_mosaic_stream 2x2 4K tiles, optimize_tables "
          f"(two passes): {len(got_opt)} bytes, equal to encode(): "
          f"{got_opt == want_opt}", flush=True)
    check(got_opt == want_opt, "two-pass encode_mosaic_stream differs")
    print(f"phase 6n: {time.perf_counter() - t_phase:.1f} s", flush=True)

    lap("6o")
    # Phase 6o: python -m jpeg_tpu_torch, every subcommand in a subprocess
    # of its own (all started together), on a 4K BMP in a temporary folder.
    import contextlib
    import io

    from jpeg_tpu_torch import cli
    from jpeg_tpu_torch.io import bmp
    from jpeg_tpu_torch.utils import metrics

    t_phase = time.perf_counter()
    root = pathlib.Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        bmp.write_bmp(str(tmp / "a.bmp"), batch8[0])
        bmp.write_bmp(str(tmp / "b.bmp"), batch8[1])
        (tmp / "a.jpg").write_bytes(jpgs8[0])
        (tmp / "b.jpg").write_bytes(jpgs8[1])
        a, b = str(tmp / "a.bmp"), str(tmp / "b.bmp")
        runs = {
            "encode": ["encode", a, str(tmp / "e.jpg"), "--trace-dir",
                       str(tmp / "trace")],
            "encode -q 90 -r 240 --optimize-tables": [
                "encode", a, str(tmp / "e2.jpg"), "-q", "90", "-r", "240",
                "--optimize-tables"],
            "decode": ["decode", str(tmp / "a.jpg"), str(tmp / "d.bmp")],
            "decode --entropy sparse": [
                "decode", str(tmp / "a.jpg"), str(tmp / "d2.bmp"),
                "--entropy", "sparse"],
            "roundtrip": ["roundtrip", a],
            "info": ["info", str(tmp / "a.jpg")],
            "mosaic --devices 1": ["mosaic", a, str(tmp / "m.jpg"),
                                   "--devices", "1"],
            "mosaic --stream": ["mosaic", a, str(tmp / "s.jpg"), "--stream"],
            "batch": ["batch", a, b, "-o", str(tmp / "enc")],
            "batch --decode": ["batch", str(tmp / "a.jpg"),
                               str(tmp / "b.jpg"), "--decode", "-o",
                               str(tmp / "dec")],
        }

        def run_cli(argv):
            return subprocess.run(
                [sys.executable, "-m", "jpeg_tpu_torch", *argv], cwd=root,
                capture_output=True, text=True, timeout=300)

        with ThreadPoolExecutor(len(runs)) as ex:
            procs = dict(zip(runs, ex.map(run_cli, runs.values())))
        for name, proc in procs.items():
            print(f"phase 6o: python -m jpeg_tpu_torch {name}: exit "
                  f"{proc.returncode}: "
                  f"{(proc.stdout.strip().splitlines() or [''])[0][:160]}",
                  flush=True)
            check(proc.returncode == 0, f"CLI {name} failed: "
                  f"{proc.stderr[-2000:]}")
        round_jpg = jpeg_tpu_torch.encode(batch8[0], device=dev)
        round_px = jpeg_tpu_torch.decode(round_jpg, device=dev)
        info_text = io.StringIO()
        with contextlib.redirect_stdout(info_text):
            cli.main(["info", str(tmp / "a.jpg")])
        outputs = {
            "encode": ((tmp / "e.jpg").read_bytes(), jpgs8[0]),
            "encode -q 90 -r 240 --optimize-tables": (
                (tmp / "e2.jpg").read_bytes(),
                jpeg_tpu_torch.encode(batch8[0], 90, restart_interval=240,
                                      optimize_tables=True, device=dev)),
            "decode": (bmp.read_bmp(str(tmp / "d.bmp")), px8[0]),
            "decode --entropy sparse": (bmp.read_bmp(str(tmp / "d2.bmp")),
                                        px8[0]),
            "roundtrip": (procs["roundtrip"].stdout.strip(), (
                f"quality=75 subsampling=420: {len(round_jpg)} bytes, "
                f"bpp={metrics.bits_per_pixel(round_jpg, img.shape):.3f}, "
                f"PSNR={metrics.psnr(round_px, batch8[0]):.2f} dB")),
            "info": (procs["info"].stdout, info_text.getvalue()),
            "mosaic --devices 1": ((tmp / "m.jpg").read_bytes(),
                                   pmosaic.encode_mosaic(
                                       batch8[0], mesh=pmesh.make_mesh(
                                           1, batch_axis=1))),
            "mosaic --stream": ((tmp / "s.jpg").read_bytes(),
                                jpeg_tpu_torch.encode(
                                    batch8[0], restart_interval=WIDTH // 16,
                                    device=dev)),
            "batch": ([(tmp / "enc" / n).read_bytes()
                       for n in ("a.jpg", "b.jpg")], jpgs8[:2]),
            "batch --decode": ([bmp.read_bmp(str(tmp / "dec" / n))
                                for n in ("a.bmp", "b.bmp")], list(px8[:2])),
        }
        for name, (got, want) in outputs.items():
            if isinstance(got, list):
                same = len(got) == len(want) and all(
                    np.array_equal(g, w) for g, w in zip(got, want))
            elif isinstance(got, np.ndarray):
                same = np.array_equal(got, want)
            else:
                same = got == want
            print(f"phase 6o: {name}: output equal to the library call's: "
                  f"{same}", flush=True)
            check(same, f"CLI {name} wrote other output than the library")
        trace = tmp / "trace" / "trace.json"
        check(trace.exists() and trace.stat().st_size > 0,
              "encode --trace-dir wrote no trace")
        kernel_events = trace.read_text().count('"cat": "kernel"')
        print(f"phase 6o: --trace-dir wrote {trace.stat().st_size} bytes, "
              f"{kernel_events} device kernel events", flush=True)
    print(f"phase 6o: {time.perf_counter() - t_phase:.1f} s", flush=True)

    lap("7")
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

    lap("8")
    # Phase 8: timings.
    mpix = HEIGHT * WIDTH / 1e6
    ms_enc = median_ms_host(
        lambda: jpeg_tpu_torch.encode(img, QUALITY, SUBSAMPLING, device=dev),
        torch)
    ms_dec = median_ms_host(lambda: jpeg_tpu_torch.decode(jpg, device=dev),
                            torch)
    ms_enc_pallas = median_ms_host(lambda: jpeg_tpu_torch.encode(
        img, QUALITY, SUBSAMPLING, device=dev, use_pallas=True), torch)
    ms_enc_opt = median_ms_host(lambda: jpeg_tpu_torch.encode(
        img, QUALITY, SUBSAMPLING, device=dev, optimize_tables=True), torch)
    ms_enc_gray = median_ms_host(
        lambda: jpeg_tpu_torch.encode(gray, QUALITY, device=dev), torch)
    ms_dec_gray = median_ms_host(
        lambda: jpeg_tpu_torch.decode(jpg_g, device=dev), torch)
    # Decode by backend, end to end and by stage. "native" uploads the three
    # dense int32 grids, "sparse" one payload of the nonzeros.
    ms_dec_by = {}
    ms_dec_by["native"] = median_ms_host(
        lambda: jpeg_tpu_torch.decode(jpg, device=dev, entropy="native"),
        torch)
    ms_dec_by["sparse"] = median_ms_host(
        lambda: jpeg_tpu_torch.decode(jpg, device=dev, entropy="sparse"),
        torch)
    ms_dec_by["auto"] = ms_dec
    ms_dec_scaled = {d: median_ms_host(
        lambda: jpeg_tpu_torch.decode(jpg, device=dev, scale_denom=d), torch)
        for d in (2, 4, 8)}
    ms_dec_planes = median_ms_host(
        lambda: jpeg_tpu_torch.decode(jpg, device=dev, output="ycbcr"), torch)
    planes_4k = jpeg_tpu_torch.decode(jpg, device=dev, output="ycbcr")
    ms_finish_host = median_ms_host(
        lambda: jpeg_tpu_torch.finish_ycbcr(planes_4k), torch)
    ms_finish_host_1 = median_ms_host(
        lambda: jpeg_tpu_torch.finish_ycbcr(planes_4k, threads=1), torch)
    ms_dec_dev_out = median_ms_host(
        lambda: jpeg_tpu_torch.decode(jpg, device=dev, device_output=True),
        torch)
    # What re-encoding dense host grids as the sparse payload would cost on
    # the host, beside the dense upload it would save (the "dense upload"
    # stage below): the decoder uploads such grids dense for this reason.
    ms_from_blocks = median_ms_host(
        lambda: decode_device.sparse_payload_from_blocks(scans), torch)

    # The serving entry points, host clock, ms per call. The streams' frames
    # come from a pool of 8 made beforehand, so that making a frame is not
    # timed; the per-image figure divides by the images.
    def pool_frames(n):
        return (batch8[i % BATCH_ENCODE] for i in range(n))

    def drain(gen):
        for _ in gen:
            pass

    lap("8, the serving entry points")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms_enc_batch = median_ms_host(lambda: jpeg_tpu_torch.encode_batched(
        batch8, QUALITY, SUBSAMPLING, device=dev), torch)
    peak_enc_batch = torch.cuda.max_memory_allocated()
    # fused and pipelined in turns, so that a drift of the host hits both.
    dec_batch_ts = {"fused": [], "pipelined": []}
    for rnd in range(WARM + RUNS):
        for bm in (("fused", "pipelined") if rnd % 2 == 0
                   else ("pipelined", "fused")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            jpeg_tpu_torch.decode_batched(jpgs4, batch_mode=bm, device=dev)
            torch.cuda.synchronize()
            if rnd >= WARM:
                dec_batch_ts[bm].append((time.perf_counter() - t0) * 1e3)
    ms_dec_batch = {bm: statistics.median(ts)
                    for bm, ts in dec_batch_ts.items()}
    torch.cuda.reset_peak_memory_stats()
    jpeg_tpu_torch.decode_batched(jpgs4, batch_mode="fused", device=dev)
    peak_dec_batch = torch.cuda.max_memory_allocated()
    # What sets the batch's pace: its four host walks on four threads, as
    # decode_batched runs them, alone; and the batch without its download.
    walk_args = [port_util.scan_args(j) for j in jpgs4]

    def threaded_walks():
        with ThreadPoolExecutor(BATCH_DECODE) as pool:
            return list(pool.map(lambda a: native.sparse_scan(*a), walk_args))

    ms_batch_walks = median_ms_host(threaded_walks, torch)
    ms_batch_walk_1 = median_ms_host(
        lambda: native.sparse_scan(*walk_args[0]), torch)
    ms_dec_batch_dev = median_ms_host(lambda: jpeg_tpu_torch.decode_batched(
        jpgs4, batch_mode="fused", device_output=True, device=dev), torch)
    # The mesh layer against the single-device batch entry points, and the
    # streamed mosaic against encode() of the whole image, in turns.
    lap("8, the mesh layer")
    ms_mesh = medians_in_turns({
        f"encode_batch K={BATCH_ENCODE} on (2, 3) positions, device pack":
            lambda: pbatch.encode_batch(batch8, QUALITY, SUBSAMPLING,
                                        mesh=mesh6, device_pack=True),
        f"encode_batched K={BATCH_ENCODE}":
            lambda: jpeg_tpu_torch.encode_batched(batch8, QUALITY,
                                                  SUBSAMPLING, device=dev),
    }, torch)
    ms_mesh.update(medians_in_turns({
        f"decode_batch K={BATCH_ENCODE} on (2, 3) positions":
            lambda: pbatch.decode_batch(jpgs8, mesh=mesh6),
        f"decode_batched K={BATCH_ENCODE}":
            lambda: jpeg_tpu_torch.decode_batched(jpgs8, device=dev),
    }, torch))
    # Where the mesh entry points' time goes, by stage (host clock, a
    # synchronize after each stage).
    grid8 = pshard._image_grid(batch8, mesh6, mode)
    infos8 = [jfif.parse_jpeg(j) for j in jpgs8]
    q8 = [infos8[0].qtables[k] for k in (0, 1)]
    mesh_stages = {
        f"encode_batch K={BATCH_ENCODE}, device pack": stage_medians([
            ("upload of the stripes (shard)",
             lambda _: pshard._image_grid(batch8, mesh6, mode)),
            ("per-position programs (transform, DPCM, kernel A, level 2)",
             lambda _: pshard.sharded_encode_packed(grid8, qy, qc, htables,
                                                    mesh6, mode)),
            ("the same + status and word downloads + 8 finalizes + JFIF",
             lambda _: pbatch._encode_batch_device_packed(
                 grid8, batch8.shape, batch8.shape, qy, qc, mesh6, mode)),
        ], torch),
        f"decode_batch K={BATCH_ENCODE}, 'auto'": stage_medians([
            ("parse + 8 device entropy decodes + stripes to positions",
             lambda _: pbatch._block_grids(infos8, mesh6, mcu_rows_4k,
                                           WIDTH // mode.mcu_width, "auto")),
            ("per-position finish (kernel B x18, upsample with halo rows, "
             "colour)", lambda g: pshard.sharded_decode_pixels(
                 *g, *q8, WIDTH // mode.mcu_width, mesh6, mode)),
            ("download + assembly (to_host)", pmesh.to_host),
        ], torch),
    }
    del grid8
    ms_mosaic = medians_in_turns({
        "encode_mosaic_stream": lambda: pmosaic.encode_mosaic_stream(
            lambda a, b: big16[a:b], bh, bw, QUALITY, SUBSAMPLING,
            device=dev),
        "encode() of the materialized image": lambda: jpeg_tpu_torch.encode(
            big16, QUALITY, SUBSAMPLING, restart_interval=row_mcus,
            device=dev),
    }, torch, runs=3)
    lap("8, the streams")
    enc_stream_ts = {d: [] for d in (1, 2, 4)}
    for rnd in range(1 + STREAM_RUNS):
        for d in (1, 2, 4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            drain(jpeg_tpu_torch.encode_stream(
                pool_frames(STREAM_ENCODE), QUALITY, SUBSAMPLING, depth=d,
                device=dev))
            torch.cuda.synchronize()
            if rnd >= 1:
                enc_stream_ts[d].append((time.perf_counter() - t0) * 1e3)
    ms_enc_stream = {d: statistics.median(ts)
                     for d, ts in enc_stream_ts.items()}
    ms_dec_stream = {d: median_ms_host(lambda: drain(
        jpeg_tpu_torch.decode_stream(iter(jpgs16), depth=d, device=dev)),
        torch) for d in (1, 2, 4)}
    # The host work that encode_stream's one thread does per image, piece by
    # piece: the copy into the pinned staging buffer and the download of the
    # scan's bytes.
    slot = pipeline._Slot(dev)
    ms_stage_copy = median_ms_host(lambda: slot.stage(img), torch)
    scan4k, scan_status4k = pack.pack_scan(*scan_sets[0])
    count4k = int(scan_status4k[-1])
    torch.cuda.synchronize()
    ms_scan_download = median_ms_host(
        lambda: slot.download(scan4k, count4k).tobytes(), torch)

    n_mcu_4k = mcu_rows * mcu_cols
    lay_4k = [(i, c.h * c.v, c.dc_id, c.ac_id) for i, c in enumerate(comps)]
    geo_4k = [(mcu_rows, mcu_cols, c.v, c.h) if c.h * c.v > 1 else None
              for c in comps]
    sizes_4k = [mcu_rows * c.v * mcu_cols * c.h for c in comps]
    shapes_4k = tuple((mcu_rows * c.v, mcu_cols * c.h) for c in comps)
    factors_4k = tuple((hmax // c.h, vmax // c.v) for c in comps)
    qtabs_4k = [qt for _, qt in planes]

    def reorder(zz):
        return [layout.scan_to_raster(z, *g).contiguous() if g else z
                for z, g in zip(zz, geo_4k)]

    def densify(p):
        words, nb, sp, ep, edp = p
        return list(torch.split(
            decode_device.densify_body(words, nb, sp, ep, edp), sizes_4k))

    fancy_4k = (True, True, True)

    def torch_finish(y_zz, cb_zz, cr_zz, qy_, qcb, qcr, shapes_, factors_,
                     fancy_=fancy_4k, is_rgb=False, k=8, n_img=None,
                     use_pallas=True, hlim=None, wlim=None, scan=None):
        """decoder._finish_color as it ran before kernels B2 and H: per
        component the scan -> raster reorder, from_zigzag, unblockify,
        kernel B, round, clamp; then the torch upsample, colour map, round
        and clip; the crop (a full-size single image only)."""
        check(k == 8 and n_img is None and use_pallas,
              "the torch finish is timed on full-size single images")
        planes_ = []
        for z, q, (hb, wb), f, fan, g in zip(
                (y_zz, cb_zz, cr_zz), (qy_, qcb, qcr), shapes_, factors_,
                fancy_, scan or (None,) * 3):
            if g is not None:
                z = layout.scan_to_raster(z, *g)
            plane = fused.fused_dequant_idct(tile.unblockify(
                zigzag.from_zigzag(z.reshape(hb, wb, 64))), q)
            planes_.append(finish.upsample(
                torch.clamp(torch.round(plane), 0.0, 255.0), f, fan))
        return finish.rgb_from_planes(planes_, is_rgb)[:hlim, :wlim]

    tail = [
        ("finish: kernel B2, one launch on the scan order", lambda zz:
            decoder._component_samples(zz, qtabs_4k, shapes_4k,
                                       scan=geo_4k)),
        ("finish: kernel H", lambda sm: finish.finish_color(
            sm, factors_4k, fancy_4k, False, HEIGHT, WIDTH)),
        ("download", lambda out: out.cpu().numpy()),
    ]
    tail_per_plane = [
        ("scan -> raster on the card", reorder),
        ("finish: kernel B2 x3, a launch per component", lambda zz: [
            fused.dequant_idct_samples(z, q, s) for z, q, s in
            zip(zz, qtabs_4k, shapes_4k)]),
    ] + tail[1:]
    tail_torch = [
        ("scan -> raster on the card", reorder),
        ("finish: kernel B x3 + torch ops (before B2 and H)",
         lambda zz: torch_finish(*zz, *qtabs_4k, shapes_4k, factors_4k,
                                 hlim=HEIGHT, wlim=WIDTH)),
        ("download", lambda out: out.cpu().numpy()),
    ]
    stage_ms = {
        "sparse": stage_medians([
            ("host sparse walk + pack", lambda _: decode_device.sparse_payload(
                info.scan_data, n_mcu_4k, lay_4k, info.htables,
                info.restart_interval)),
            ("payload upload", lambda p: (
                decode_device.payload_tensor(p[0], dev), *p[1:])),
            ("densify on the card", densify),
        ] + tail, torch),
        "native": stage_medians([
            ("host dense walk", lambda _: native.decode_scan(
                info.scan_data, n_mcu_4k, lay_4k, info.htables,
                info.restart_interval)),
            ("dense upload", lambda host: [
                torch.as_tensor(z, device=dev) for z in host]),
        ] + tail, torch),
    }

    lap("8, the device Huffman decoders")
    # The device Huffman decoders. Step 0: the host index pass beside the
    # host sparse walk, on the 4K stream (one thread: no restart markers)
    # and on the restart-240 stream (threaded across its 135 segments).
    walk_plain, walk_rst = port_util.scan_args(jpg), port_util.scan_args(jpg_rst)
    ms_walks = {}
    for label, args in (("4K", walk_plain),
                        (f"4K restart {ROW_RESTART}", walk_rst)):
        ms_walks[label] = medians_in_turns({
            "native.index_scan": lambda: native.index_scan(*args),
            "native.sparse_scan": lambda: native.sparse_scan(*args),
            "decode_device.sparse_payload":
                lambda: decode_device.sparse_payload(*args),
        }, torch, RUNS)
    # End to end, the three backends in turns, on both streams, on the same
    # image with four MCU rows to a restart segment (the old kernel E's time
    # followed the blocks of one segment) and on the flat frames.
    huffman_backends = ("sparse", "indexed", "device")
    ms_turns = {
        label: medians_in_turns({
            b: (lambda b=b: jpeg_tpu_torch.decode(stream, device=dev,
                                                  entropy=b))
            for b in huffman_backends}, torch, RUNS)
        for label, stream in (("4K", jpg),
                              (f"4K restart {ROW_RESTART}", jpg_rst),
                              (f"4K restart {4 * ROW_RESTART}", jpg_long),
                              ("4K solid black", frames_4k["4K solid black"]),
                              ("4K 280-row black bars",
                               frames_4k["4K 280-row black bars"]))}
    ms_stream_turns = medians_in_turns({
        b: (lambda b=b: drain(jpeg_tpu_torch.decode_stream(
            iter(jpgs16), depth=4, entropy=b, device=dev)))
        for b in huffman_backends}, torch)

    # By stage. "indexed": the host index pass and the payload, one upload,
    # kernel D. "device" without markers: unstuff, one upload, program F,
    # regroup + cumsum, kernel D, the flags' readback; with markers: split
    # + unstuff, one upload, E's route (the anchored block-start program, the
    # DC sums, kernel D), the flags' readback.
    def split_rows(rows):
        return list(torch.split(rows, sizes_4k))

    def index_payload(_):
        destuffed, off, dc = native.index_scan(*walk_plain)
        words = decode_device._guarded_words(destuffed)
        return np.concatenate([words, off, dc]), len(words), off.shape[0]

    def run_d(p):
        up, nwords, nb = p
        return split_rows(entropy_decode.decode_ac_indexed(
            up[:nwords], up[nwords:nwords + nb], up[nwords + nb:], d4k[3],
            d4k[4]))

    def unstuff_words(_):
        return decode_device.unstuffed_segments(walk_plain[0])[0]

    def split_unstuff_words(_):
        words, seg_off, _lens = decode_device.unstuffed_segments(walk_rst[0])
        return np.concatenate([words, seg_off]), len(words)

    payload_bytes = index_payload(None)[0].nbytes
    device_stages = [
        ("host unstuff + words", unstuff_words),
        (f"upload ({f4k[0].numel() * 4} B)",
         lambda w: torch.from_numpy(w).to(dev)),
        ("program F", lambda w: (w, entropy_decode.prefix_index(
            w, *f4k[1:]))),
        ("regroup + cumsum", lambda p: (
            p[0], port_util.regroup_prefix(p[1][0], p[1][1], lay_4k),
            p[1][2])),
        ("kernel D", lambda p: (entropy_decode.decode_ac_indexed(
            p[0], *p[1], d4k[3], d4k[4]), p[2])),
        ("flags to the host", lambda p: (
            split_rows(p[0]), p[1].cpu().tolist())[0]),
    ]
    stage_ms_huffman = {
        "indexed": stage_medians([
            ("host index pass + payload", index_payload),
            (f"upload ({payload_bytes} B)", lambda p: (
                torch.from_numpy(p[0]).to(dev), *p[1:])),
            ("kernel D", run_d),
        ] + tail, torch),
        "device (no markers)": stage_medians(device_stages + tail, torch),
        "device (no markers), the finish before B2 and H": stage_medians(
            device_stages + tail_torch, torch),
        "device (no markers), the reorder and a B2 launch per component "
        "(the finish's form before B2 read the scan order)": stage_medians(
            device_stages + tail_per_plane, torch),
        f"device (restart {ROW_RESTART})": stage_medians([
            ("host split + unstuff + words", split_unstuff_words),
            (f"upload ({(e4k[0].numel() + e4k[1].numel()) * 4} B)",
             lambda p: (torch.from_numpy(p[0]).to(dev), p[1])),
            ("E route: block starts + DC sums + kernel D", lambda p:
             entropy_decode.decode_segments(p[0][:p[1]], p[0][p[1]:],
                                            *e4k[2:])),
            ("flags to the host", lambda p: (
                split_rows(p[0]), p[1].cpu().numpy())[0]),
        ] + tail, torch),
    }

    lap("8, the kernels alone")
    # Wrapper calls (CUDA events around one call, host work included) and
    # the twins on the card; E's twin is a Python walk, timed once in phase
    # 5c.
    ms_d = median_ms_device(
        lambda: entropy_decode.decode_ac_indexed(*d4k), torch)
    ms_d_plain = median_ms_device(
        lambda: entropy_decode.decode_ac_indexed_reference(*d4k), torch)
    ms_e = median_ms_device(
        lambda: entropy_decode.decode_segments(*e4k), torch)
    ms_f = median_ms_device(lambda: entropy_decode.prefix_index(*f4k), torch)
    ms_f_plain = median_ms_device(
        lambda: entropy_decode.prefix_index_reference(*f4k), torch)

    luma, qluma = planes[0]
    ms_a = median_ms_device(lambda: pack.pack_level1(
        blocks4k, tbl4k, *luts, packed=packed), torch)  # as the encoder calls it
    ms_a_plain = median_ms_device(
        lambda: pack.pack_level1_reference(blocks4k, tbl4k, *luts), torch)
    ms_b = median_ms_device(lambda: fused.fused_dequant_idct(luma, qluma), torch)
    ms_b_plain = median_ms_device(
        lambda: fused.fused_dequant_idct_reference(luma, qluma), torch)
    y_plane, qt_y = pallas_planes[0], quant.luma_table(QUALITY)
    ms_c = median_ms_device(lambda: fused.fused_dct_quantize(y_plane, qt_y),
                            torch)
    ms_c_plain = median_ms_device(
        lambda: fused.fused_dct_quantize_reference(y_plane, qt_y), torch)
    # Each kernel alone, on prepared buffers, beside its bound.
    qluma_flat = qluma.reshape(64).contiguous()
    chroma, qchroma = planes[1]
    qchroma_flat = qchroma.reshape(64).contiguous()
    cb_plane = pallas_planes[1]
    qt_y_flat = torch.as_tensor(qt_y, dtype=torch.float32, device=dev).reshape(64)
    qt_c_flat = torch.as_tensor(quant.chroma_table(QUALITY), dtype=torch.float32,
                                device=dev).reshape(64)

    def alone(inputs, out_like, launch, nbytes):
        """kernel_only_us of launch(*inputs[i], *outputs[i]) over rotating
        clones of the inputs and fresh outputs."""
        nbuf = rotation(nbytes)
        ins = [tuple(t.clone() for t in inputs) for _ in range(nbuf)]
        outs = [tuple(torch.empty_like(t) for t in out_like)
                for _ in range(nbuf)]
        return kernel_only_us(lambda i: launch(*ins[i], *outs[i]), nbuf, torch)

    # The scan pass on the 4K frame's kernel A output, one segment: the
    # wrapper, the twin (level 2 on the card, the words' download, the
    # native finalize) and its four launches alone. Its bytes: each total
    # read, each word that holds bits read, each scan byte written.
    buf_s, tb_s, nw_s = scan_sets[0]
    ms_scan = median_ms_device(lambda: pack.pack_scan(buf_s, tb_s, nw_s), torch)
    ms_scan_plain = median_ms_device(
        lambda: pack.pack_scan_reference(buf_s, tb_s, nw_s), torch)
    bytes_scan = int(tb_s.numel() * 4 + ((tb_s.to(torch.int64) + 31) // 32
                                         ).sum() * 4) + count4k
    nseg_s, nblk_s = tb_s.shape
    scan_out_like = (
        torch.empty(pack.scan_scratch_bytes(nseg_s, nblk_s, nw_s),
                    dtype=torch.uint8, device=dev),
        torch.empty(pack.scan_capacity(nseg_s, nw_s), dtype=torch.uint8,
                    device=dev),
        torch.empty(2 * nseg_s + 1, dtype=torch.int64, device=dev))
    us_scan = alone(
        (buf_s.contiguous(), tb_s.contiguous()), scan_out_like,
        lambda b, t, sc, o, st: pack._launch_scan(b, t, sc, o, st, nw_s, 0),
        sum(t.numel() * t.element_size() for t in (buf_s, tb_s))
        + nw_s * 4 + count4k)

    nblk = blocks4k.shape[0]
    bytes_a = level1_bytes(nblk)
    bytes_y, bytes_c = plane_bytes(*luma.shape), plane_bytes(*chroma.shape)
    a_launch = lambda b, t, buf, tot: pack._launch(b, t, packed, buf, tot)  # noqa: E731
    us_a = alone((blocks4k.contiguous(), tbl4k), got4k, a_launch, bytes_a)
    us_a_q95 = alone((blocks4k_q95.contiguous(), tbl4k), got4k, a_launch,
                     bytes_a)
    us_b = alone((luma.contiguous(),),
                 (torch.empty_like(luma, dtype=torch.float32),),
                 lambda c, o: fused._launch_idct(c, qluma_flat, o), bytes_y)
    us_b_c = alone((chroma.contiguous(),),
                   (torch.empty_like(chroma, dtype=torch.float32),),
                   lambda c, o: fused._launch_idct(c, qchroma_flat, o), bytes_c)
    us_c = alone((y_plane.contiguous(),),
                 (torch.empty_like(y_plane, dtype=torch.int32),),
                 lambda x, o: fused._launch_dct(x, qt_y_flat, o), bytes_y)
    us_c_c = alone((cb_plane.contiguous(),),
                   (torch.empty_like(cb_plane, dtype=torch.int32),),
                   lambda x, o: fused._launch_dct(x, qt_c_flat, o), bytes_c)
    # The library call that competes with kernel B: dequant + IDCT + 128 on
    # the plane's (N, 64) f32 raster blocks as ONE cuBLAS addmm against
    # diag(q) @ kron(D, D) (a block's row-major samples; the plane layout
    # would be one permute more), timed as the kernels are. Kernel C has no
    # such call: its true division and round half away are further calls, so
    # only the scaled DCT, (x - 128) @ kron(D, D)^T diag(1/q), is timed, and
    # labelled as such.
    mcu_conv._require_full_f32()
    kron = np.kron(dct.dct_basis().astype(np.float64),
                   dct.dct_basis().astype(np.float64))

    def library_us(blocks, weight, bias, nbytes):
        return alone((blocks,), (torch.empty_like(blocks),),
                     lambda x, o: torch.addmm(bias, x, weight, out=o), nbytes)

    def as_blocks(plane):
        return tile.blockify(plane).reshape(-1, 64).to(torch.float32)

    lib_b, lib_c = {}, {}
    for name, (coeffs, qt), x in (("Y", planes[0], pallas_planes[0]),
                                  ("chroma", planes[1], pallas_planes[1])):
        q = qt.cpu().numpy().astype(np.float64).reshape(64)
        w_b = torch.as_tensor(q[:, None] * kron, dtype=torch.float32,
                              device=dev)
        bias_b = torch.full((64,), 128.0, device=dev)
        blocks = as_blocks(coeffs).contiguous()
        got = torch.addmm(bias_b, blocks, w_b)
        err = float((got.reshape(blocks.shape[0], 8, 8) - tile.blockify(
            fused.fused_dequant_idct(coeffs, qt)).reshape(-1, 8, 8)
        ).abs().max())
        nbytes = plane_bytes(*coeffs.shape)
        lib_b[name] = (library_us(blocks, w_b, bias_b, nbytes), err,
                       2 * blocks.shape[0] * 64 * 64)
        qc = (quant.luma_table(QUALITY) if name == "Y"
              else quant.chroma_table(QUALITY)).astype(np.float64).reshape(64)
        w_c = torch.as_tensor(kron.T / qc[None, :], dtype=torch.float32,
                              device=dev)
        bias_c = torch.as_tensor(-128.0 * kron.sum(axis=1) / qc,
                                 dtype=torch.float32, device=dev)
        xb = as_blocks(x).contiguous()
        lib_c[name] = library_us(xb, w_c, bias_c, plane_bytes(*x.shape))
        del blocks, xb, got
    # Kernels B2 and H on the 4K stream's blocks as the decoder hands them
    # over (scan order): the wrapper calls and the twins on the card, each
    # kernel alone beside its bound (B2 also one component at a time, as
    # before it took them all), and the finish in turns with the one before
    # them (kernel B + torch ops); then the decode end to end with each
    # finish, in turns.
    zz_4k, qt_4k, sh_4k, fac_4k, fan_4k, _, _, _ = finish_inputs([jpg])
    zs_4k, geo_s4k = scan_inputs([jpg])
    samples_4k = fused.dequant_idct_planes(zs_4k, qt_4k, sh_4k, geo_s4k)
    (hb_y, wb_y), (hb_c, wb_c) = sh_4k[0], sh_4k[1]
    ms_b2 = median_ms_device(lambda: fused.dequant_idct_planes(
        zs_4k, qt_4k, sh_4k, geo_s4k), torch)
    ms_b2_plain = median_ms_device(
        lambda: fused.dequant_idct_planes_reference(
            zs_4k, qt_4k, sh_4k, geo_s4k), torch)
    ms_h = median_ms_device(lambda: finish.finish_color(
        samples_4k, fac_4k, fan_4k, False, HEIGHT, WIDTH), torch)
    ms_h_plain = median_ms_device(lambda: finish.finish_color_reference(
        samples_4k, fac_4k, fan_4k, False, HEIGHT, WIDTH), torch)
    # B2 reads 64 int32 per block and writes 64 uint8; H reads the three
    # sample planes and writes the RGB image.
    nblk_4k = sum(hb * wb for hb, wb in sh_4k)
    bytes_b2 = nblk_4k * 64 * 5
    bytes_b2_y = hb_y * wb_y * 64 * 5
    bytes_b2_c = hb_c * wb_c * 64 * 5
    bytes_h = sum(p.numel() for p in samples_4k) + HEIGHT * WIDTH * 3
    b2_args = fused._prepare_planes(fused._components(
        zs_4k, qt_4k, sh_4k, geo_s4k, 1, samples_4k), 1, dev)
    us_b2 = alone(tuple(b2_args[0]), tuple(samples_4k),
                  lambda zy, zcb, zcr, oy, ocb, ocr: fused._launch_idct_samples(
                      [zy, zcb, zcr], b2_args[1], [oy, ocb, ocr], b2_args[3]),
                  bytes_b2)
    q_flat = b2_args[1]
    geo_r = [(1, hb, wb, hb * wb, wb, 1, 1) for hb, wb in sh_4k]
    us_b2_y = alone((zz_4k[0].contiguous(),), (samples_4k[0],),
                    lambda z, o: fused._launch_idct_samples(
                        [z], q_flat[:1], [o], geo_r[:1]), bytes_b2_y)
    us_b2_c = alone((zz_4k[1].contiguous(),), (samples_4k[1],),
                    lambda z, o: fused._launch_idct_samples(
                        [z], q_flat[1:2], [o], geo_r[1:2]), bytes_b2_c)
    _, geo_h = finish._geometry(samples_4k, fac_4k, fan_4k, HEIGHT, WIDTH)
    us_h = alone(tuple(samples_4k),
                 (torch.empty((HEIGHT, WIDTH, 3), dtype=torch.uint8,
                              device=dev),),
                 lambda y, cb, cr, o: finish._launch_finish(
                     [y, cb, cr], geo_h, o, 1, HEIGHT, WIDTH, False), bytes_h)
    finish_args = (*zs_4k, *qt_4k, sh_4k, fac_4k, fan_4k)
    check(torch.equal(torch_finish(*finish_args, hlim=HEIGHT, wlim=WIDTH,
                                   scan=geo_s4k),
                      decoder._finish_color(*finish_args, hlim=HEIGHT,
                                            wlim=WIDTH, scan=geo_s4k)),
          "the torch finish and kernels B2 + H give different pixels")
    ms_finish_turns = medians_in_turns({
        "kernel B x3 + torch ops (before B2 and H)": lambda: torch_finish(
            *finish_args, hlim=HEIGHT, wlim=WIDTH, scan=geo_s4k),
        "the twins on the card": lambda: old_route(
            zz_4k, qt_4k, sh_4k, fac_4k, fan_4k, HEIGHT, WIDTH, 1),
        "scan -> raster + kernel B2 per component + kernel H":
            lambda: finish.finish_color(
                [fused.dequant_idct_samples(z, q, s) for z, q, s in
                 zip(reorder(zs_4k), qt_4k, sh_4k)],
                fac_4k, fan_4k, False, HEIGHT, WIDTH),
        "kernel B2 (one launch) + kernel H": lambda: decoder._finish_color(
            *finish_args, hlim=HEIGHT, wlim=WIDTH, scan=geo_s4k),
    }, torch, runs=RUNS)
    b2_h_finish = decoder._finish_color

    def decode_with(finish_fn):
        def go():
            decoder._finish_color = finish_fn
            try:
                return jpeg_tpu_torch.decode(jpg, device=dev)
            finally:
                decoder._finish_color = b2_h_finish
        return go

    ms_decode_turns = medians_in_turns({
        "finish by kernel B + torch ops": decode_with(torch_finish),
        "finish by kernels B2 + H": decode_with(b2_h_finish),
    }, torch, runs=RUNS)
    check(decoder._finish_color is b2_h_finish, "the finish was not restored")

    # Kernels D and E and program F alone. The tables (1 MB) stay where they
    # are, as in a decode; everything else rotates.
    nblk_h = d4k[1].shape[0]
    words_bytes = d4k[0].numel() * 4
    bytes_d = words_bytes + 3 * nblk_h * 4 + nblk_h * 256
    us_d = alone(d4k[:4], (torch.empty((nblk_h, 64), dtype=torch.int32,
                                       device=dev),),
                 lambda w, o, d, sl, rows: entropy_decode._launch_ac_indexed(
                     w, o, d, sl, d4k[4], rows), bytes_d)
    bytes_e = e4k[0].numel() * 4 + nblk_h * 256
    nseg_e = e4k[1].shape[0]
    # The block-start program alone was timed in phase 5c, on every frame.
    us_e = sync_runs[f"4K restart {ROW_RESTART}"][4]
    us_e_long = sync_runs[f"4K restart {4 * ROW_RESTART}"][4]
    us_f = sync_runs["4K"][4]
    f_words, f_mcus, f_seq, f_classes, f_tables = f4k
    f_nbits = f_words.numel() * 32
    bytes_f = f_words.numel() * 4 + 2 * f_mcus * f_seq.shape[0] * 4
    # Each launch of program F alone (on the outputs of the ones before).
    _us, f_sets = f_alone_us(f4k)
    for launches in f_sets:
        for _name, go in launches:
            go()
    us_f_stages = {
        name: kernel_only_us(lambda i, k=k: f_sets[i][k][1](), len(f_sets),
                             torch)
        for k, (name, _go) in enumerate(f_sets[0])}
    del f_sets
    for label, us, nbytes in (
        (f"kernel D ac_indexed, {nblk_h} blocks", us_d, bytes_d),
        (f"E route (block-start program + DC sums + kernel D), {nseg_e} "
         f"segments, {nblk_h} blocks", us_e, bytes_e),
        (f"program F prefix_index, {f_nbits} bit positions, {f_mcus} MCUs, "
         f"{len(us_f_stages)} launches", us_f, bytes_f),
    ):
        print(f"phase 8: {label}: kernel-only {us:.2f} us, {nbytes} bytes, "
              f"bound {bound_us(nbytes):.2f} us, share "
              f"{bound_us(nbytes) / us:.4f} [{card}]", flush=True)
    print(f"phase 8: E route with restart {4 * ROW_RESTART}: "
          f"{sync_runs[f'4K restart {4 * ROW_RESTART}'][1]} segments: "
          f"kernel-only {us_e_long:.2f} us (restart {ROW_RESTART}: {nseg_e} "
          f"segments, {us_e:.2f} us) [{card}]", flush=True)
    print("phase 8: program F by launch, kernel-only: "
          + "; ".join(f"{k} {v:.2f} us" for k, v in us_f_stages.items())
          + f" [{card}]", flush=True)
    for label, us, nbytes in (
        (f"kernel A pack_level1, {nblk} blocks q{QUALITY}", us_a, bytes_a),
        (f"kernel A pack_level1, {nblk} blocks q95", us_a_q95, bytes_a),
        (f"kernel B idct8, {tuple(luma.shape)} plane", us_b, bytes_y),
        (f"kernel B idct8, {tuple(chroma.shape)} plane", us_b_c, bytes_c),
        (f"kernel C dct8, {tuple(y_plane.shape)} plane", us_c, bytes_y),
        (f"kernel C dct8, {tuple(cb_plane.shape)} plane", us_c_c, bytes_c),
        (f"kernel B2 idct8_samples, the {nblk_4k} blocks of all three "
         f"components in one launch, scan order", us_b2, bytes_b2),
        (f"kernel B2 idct8_samples, {hb_y * wb_y} Y blocks alone", us_b2_y,
         bytes_b2_y),
        (f"kernel B2 idct8_samples, {hb_c * wb_c} chroma blocks alone", us_b2_c,
         bytes_b2_c),
        (f"kernel H finish_color, 4K {SUBSAMPLING} samples to "
         f"{HEIGHT}x{WIDTH} RGB", us_h, bytes_h),
    ):
        print(f"phase 8: {label}: kernel-only {us:.2f} us, {nbytes} bytes, "
              f"bound {bound_us(nbytes):.2f} us, share "
              f"{bound_us(nbytes) / us:.3f} ({nbytes / us / 1e3:.0f} GB/s) "
              f"[{card}]", flush=True)
    for name, (us, err, flops) in lib_b.items():
        print(f"phase 8: library call for kernel B, torch.addmm on the {name} "
              f"plane's {flops // (2 * 64 * 64)} f32 blocks: kernel-only "
              f"{us:.2f} us ({flops} FLOP, {flops / us / 1e6:.1f} TFLOP/s), "
              f"max |diff| from kernel B {err:.3g}; kernel B "
              f"{us_b if name == 'Y' else us_b_c:.2f} us [{card}]", flush=True)
    print(f"phase 8: kernel C's scaled DCT alone (no rounding), torch.addmm: "
          f"Y {lib_c['Y']:.2f} us, chroma {lib_c['chroma']:.2f} us; kernel C "
          f"{us_c:.2f} / {us_c_c:.2f} us [{card}]", flush=True)
    for label, ms in (
        (f"encode 4K q{QUALITY} {SUBSAMPLING} end to end", ms_enc),
        (f"decode 4K q{QUALITY} {SUBSAMPLING} end to end", ms_dec),
        (f"encode 4K q{QUALITY} {SUBSAMPLING} use_pallas end to end",
         ms_enc_pallas),
        (f"encode 4K q{QUALITY} {SUBSAMPLING} optimize_tables end to end",
         ms_enc_opt),
        (f"encode 4K q{QUALITY} gray end to end", ms_enc_gray),
        (f"decode 4K q{QUALITY} gray end to end", ms_dec_gray),
    ):
        print(f"phase 8: {label}: {ms:.3f} ms median of {RUNS} "
              f"({mpix / ms * 1e3:.1f} MPix/s) [{card}]", flush=True)
    for label, ms in (
        *((f"decode 4K, entropy {k!r}", v) for k, v in ms_dec_by.items()),
        *((f"decode 4K, scale_denom {d}", v) for d, v in ms_dec_scaled.items()),
        ("decode 4K, output='ycbcr' (planes to the host)", ms_dec_planes),
        ("finish_ycbcr on the host, 4K planes, default threads",
         ms_finish_host),
        ("finish_ycbcr on the host, 4K planes, 1 thread", ms_finish_host_1),
        ("decode 4K, device_output (no download)", ms_dec_dev_out),
        ("sparse_payload_from_blocks on the host, 4K dense grids (no caller "
         "in decode)", ms_from_blocks),
    ):
        print(f"phase 8: {label}: {ms:.3f} ms median of {RUNS} [{card}]",
              flush=True)
    for label, ms, n, single, runs in (
        (f"encode_batched K={BATCH_ENCODE} 4K", ms_enc_batch, BATCH_ENCODE,
         ms_enc, RUNS),
        *((f"decode_batched K={BATCH_DECODE} 4K {bm!r}", v, BATCH_DECODE,
           ms_dec, RUNS) for bm, v in ms_dec_batch.items()),
        *((f"encode_stream {STREAM_ENCODE} x 4K depth {d}", v,
           STREAM_ENCODE, ms_enc, STREAM_RUNS)
          for d, v in ms_enc_stream.items()),
        *((f"decode_stream {STREAM_DECODE} x 4K depth {d}", v, STREAM_DECODE,
           ms_dec, RUNS) for d, v in ms_dec_stream.items()),
    ):
        print(f"phase 8: {label}: {ms:.3f} ms median of {runs}, "
              f"{ms / n:.3f} ms per image ({mpix * n / ms * 1e3:.1f} MPix/s); "
              f"single call {single:.3f} ms ({mpix / single * 1e3:.1f} "
              f"MPix/s) [{card}]", flush=True)
    print(f"phase 8: peak device memory: encode_batched K={BATCH_ENCODE} "
          f"{peak_enc_batch} bytes; decode_batched K={BATCH_DECODE} fused "
          f"{peak_dec_batch} bytes [{card}]", flush=True)
    for label, ms in ms_mesh.items():
        print(f"phase 8: {label}, 4K, in turns: {ms:.3f} ms median of "
              f"{TURN_RUNS}, {ms / BATCH_ENCODE:.3f} ms per image "
              f"({mpix * BATCH_ENCODE / ms * 1e3:.1f} MPix/s) [{card}]",
              flush=True)
    for path, stages in mesh_stages.items():
        print(f"phase 8: {path} 4K stages on (2, 3) positions: "
              + "; ".join(f"{k} {v:.3f} ms" for k, v in stages.items())
              + f" [{card}]", flush=True)
    for label, ms in ms_mosaic.items():
        print(f"phase 8: 4x4 4K tiles ({bw}x{bh}), {label}, in turns: "
              f"{ms:.3f} ms median of 3 ({bw * bh / ms / 1e3:.1f} MPix/s) "
              f"[{card}]", flush=True)
    print(f"phase 8: decode_batched K={BATCH_DECODE} parts: the "
          f"{BATCH_DECODE} sparse walks on {BATCH_DECODE} threads "
          f"{ms_batch_walks:.3f} ms (one walk alone {ms_batch_walk_1:.3f} "
          f"ms); 'fused' with device_output (no download) "
          f"{ms_dec_batch_dev:.3f} ms [{card}]", flush=True)
    print(f"phase 8: encode_stream host pieces per 4K image: copy into the "
          f"pinned staging buffer {ms_stage_copy:.3f} ms, pinned download of "
          f"the {count4k} scan bytes and their copy out "
          f"{ms_scan_download:.3f} ms [{card}]", flush=True)
    print(f"phase 8: decode_batched batch_mode='auto' takes "
          f"{auto_mode!r} at K={BATCH_DECODE}", flush=True)
    for label, ms in ms_walks.items():
        print(f"phase 8: host walks, {label}: "
              + "; ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
              + f"; in turns, medians of {RUNS} [{card}]", flush=True)
    for label, ms in ms_turns.items():
        print(f"phase 8: decode {label} end to end by entropy backend, in "
              f"turns: " + "; ".join(f"{k!r} {v:.3f} ms" for k, v in ms.items())
              + f"; medians of {RUNS} [{card}]", flush=True)
    print(f"phase 8: decode_stream {STREAM_DECODE} x 4K depth 4 by entropy "
          f"backend, in turns, ms per image: "
          + "; ".join(f"{k!r} {v / STREAM_DECODE:.3f}"
                      for k, v in ms_stream_turns.items())
          + f"; medians of {TURN_RUNS} [{card}]", flush=True)
    print("phase 8: the 4K finish after the entropy decode, in turns: "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in ms_finish_turns.items())
          + f"; medians of {RUNS} [{card}]", flush=True)
    print("phase 8: decode 4K end to end, in turns: "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in ms_decode_turns.items())
          + f"; medians of {RUNS} [{card}]", flush=True)
    stage_ms.update(stage_ms_huffman)
    for path, stages in stage_ms.items():
        print(f"phase 8: decode 4K stages, {path} (sum "
              f"{sum(stages.values()):.3f} ms): "
              + "; ".join(f"{k} {v:.3f} ms" for k, v in stages.items())
              + f" [{card}]", flush=True)
    for label, ms, plain in (
        (f"kernel A pack_level1, {blocks4k.shape[0]} blocks", ms_a, ms_a_plain),
        (f"kernel B idct8, {tuple(luma.shape)} plane", ms_b, ms_b_plain),
        (f"kernel C dct8, {tuple(y_plane.shape)} plane", ms_c, ms_c_plain),
        (f"kernel B2 idct8_samples, {nblk_4k} blocks of three components",
         ms_b2, ms_b2_plain),
        (f"kernel H finish_color, {HEIGHT}x{WIDTH}", ms_h, ms_h_plain),
        (f"kernel D ac_indexed, {nblk_h} blocks", ms_d, ms_d_plain),
        (f"E route decode_segments, {nseg_e} segments (twin: one Python "
         f"walk on the host)", ms_e, secs_e_plain * 1e3),
        (f"program F prefix_index, {f_nbits} bit positions", ms_f,
         ms_f_plain),
        (f"scan pass pack_scan, {nblk_s} blocks, {count4k} scan bytes (twin: "
         f"level 2, the words' download, the native finalize)", ms_scan,
         ms_scan_plain),
    ):
        print(f"phase 8: {label}: {ms:.4f} ms; plain twin on the card "
              f"{plain:.4f} ms; median of {RUNS} [{card}]", flush=True)

    def entry(name, source, replaces, launches, err, ms, plain_ms, us, nbytes,
              launches_per, library_ms=None, **more):
        """One kernel of the JSON line. Every kernel here is bound by the
        bytes it moves. library_ms: the one PyTorch call that computes the
        same function, timed as the kernel is; only kernel B has one."""
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_us(nbytes) / 1e3, "bound_by": "bytes",
                "library_ms": library_ms, "kernel_us": us, "bytes": nbytes,
                "bound_us": bound_us(nbytes),
                "bound_share": bound_us(nbytes) / us,
                "launches_per": dict(zip(
                    launch_paths, launches_per)), **more}

    launch_paths = (
        "default_encode", "default_decode", "use_pallas_encode",
        "sparse_decode", "native_decode", "encode_batched_k8",
        "decode_batched_fused_k4", "decode_batched_pipelined_k4",
        "encode_stream_per_image", "decode_stream_per_image",
        "indexed_decode", "device_decode", "device_decode_restarts",
        "use_pallas_false_decode",
        "encode_batch_mesh_host_pack", "encode_batch_mesh",
        "decode_batch_mesh_auto", "decode_batch_mesh_sparse",
        "encode_mosaic_stream", *rank_path_names)

    # Per kernel A-F, each path's count as it was read just after the path
    # ran (path_counts); decode_batched's "auto" mode is one of the other two.
    check(set(path_counts) - {"decode_batched_auto_k4"} == set(launch_paths),
          f"paths counted: {sorted(path_counts)}")
    # (A, B, C, B2, H, D, E, F, F's launches, native scan calls, DC sums)
    # = per[0..10].
    per = [[(path_counts[p][0] + path_counts[p][1])[k] for p in launch_paths]
           for k in range(11)]
    # The DC sums run once per native scan call and nowhere else: once per
    # image on the device-route paths, never on the indexed one.
    scans = dict(zip(launch_paths, zip(per[9], per[10])))
    print(f"phase 8: (native scan calls, DC-sum launches) per path: {scans}",
          flush=True)
    check(all(n == d for n, d in scans.values())
          and all(scans[p] == (1, 1) for p in (
              "default_decode", "device_decode", "device_decode_restarts",
              "decode_stream_per_image"))
          and scans["indexed_decode"] == (0, 0),
          f"native scan calls and DC-sum launches per path: {scans}")
    # Every path of this process that went through kernel B2 read the scan
    # order in place: no scan -> raster reorder.
    b2_reorders = {p: path_reorders[p] for p in launch_paths
                   if p in path_reorders and path_counts[p][0][3]}
    print(f"phase 8: scan -> raster reorders on the paths through kernel "
          f"B2: {b2_reorders}; with use_pallas=False: "
          f"{path_reorders['use_pallas_false_decode']}", flush=True)
    check({"default_decode", "decode_batched_fused_k4",
           "decode_batched_pipelined_k4", "decode_stream_per_image"}
          <= set(b2_reorders) and not any(b2_reorders.values())
          and path_reorders["use_pallas_false_decode"] > 0,
          f"scan -> raster reorders: {b2_reorders}")
    lap("end")
    return {"kernels": [
        entry("pack_level1", "jpeg_tpu_torch/csrc/pack_level1.cu",
              "jpeg_tpu/ops/pack_pallas.py:82", main_launches[0], err_a, ms_a,
              ms_a_plain, us_a, bytes_a, per[0], kernel_us_q95=us_a_q95),
        entry("idct8", "jpeg_tpu_torch/csrc/idct8.cu",
              "jpeg_tpu/ops/fused.py:69", main_launches[1], err_b, ms_b,
              ms_b_plain,
              us_b, bytes_y, per[1], library_ms=lib_b["Y"][0] / 1e3,
              library_call="torch.addmm(128, blocks, diag(q) @ kron(D, D))",
              library_ms_chroma=lib_b["chroma"][0] / 1e3,
              library_max_abs_diff=max(v[1] for v in lib_b.values()),
              kernel_us_chroma=us_b_c,
              bytes_chroma=bytes_c, bound_us_chroma=bound_us(bytes_c)),
        entry("dct8", "jpeg_tpu_torch/csrc/dct8.cu",
              "jpeg_tpu/ops/fused.py:45", launches_c, err_c, ms_c, ms_c_plain,
              us_c, bytes_y, per[2],
              library_ms_dct_only=lib_c["Y"] / 1e3,
              library_ms_dct_only_chroma=lib_c["chroma"] / 1e3,
              library_call_dct_only="torch.addmm(-128 kron(D, D) 1 / q, "
                                    "blocks, kron(D, D)^T diag(1 / q)), no "
                                    "rounding",
              kernel_us_chroma=us_c_c,
              bytes_chroma=bytes_c, bound_us_chroma=bound_us(bytes_c)),
        entry("ac_indexed", "jpeg_tpu_torch/csrc/ac_indexed.cu",
              "jpeg_tpu/entropy/decode_device.py:179", main_launches[5],
              err_d, ms_d, ms_d_plain, us_d, bytes_d, per[5]),
        entry("prefix_index_anchored", "jpeg_tpu_torch/csrc/prefix_index.cu",
              "jpeg_tpu/entropy/decode_device.py:71",
              per_huffman[f"colour restart {ROW_RESTART}", "device"][1],
              err_e, ms_e, secs_e_plain * 1e3, us_e, bytes_e, per[6],
              kernel_us_covers="the anchored program, the DC sums, kernel D",
              by_frame={k: {"segments": v[1], "blocks": v[2],
                            "sync_passes": v[3], "kernel_us": v[4]}
                        for k, v in sync_runs.items() if v[0] == "E"}),
        entry("prefix_index", "jpeg_tpu_torch/csrc/prefix_index.cu",
              "jpeg_tpu/entropy/decode_device.py:866", main_launches[7],
              err_f, ms_f, ms_f_plain, us_f, bytes_f, per[7],
              separate_launches=per_huffman["colour", "device"][3],
              kernel_us_by_launch=us_f_stages,
              by_frame={k: {"blocks": v[2], "sync_passes": v[3],
                            "kernel_us": v[4]}
                        for k, v in sync_runs.items() if v[0] == "F"}),
        entry("idct8_samples", "jpeg_tpu_torch/csrc/idct8.cu",
              "jpeg_tpu/ops/fused.py:69", main_launches[3], err_b2, ms_b2,
              ms_b2_plain, us_b2, bytes_b2, per[3],
              replaces_in="jpeg_tpu/models/decoder.py:34 _reconstruct_plane "
                          "and the reorder at :360, inside :349 "
                          "_jit_finish_color",
              library_none="no one call: the reorder, the de-zigzag gather "
                           "and the rounding to uint8 are further calls",
              covers="all three components of the 4K image, one launch, "
                     "scan order",
              kernel_us_y_alone=us_b2_y, bytes_y_alone=bytes_b2_y,
              kernel_us_chroma_alone=us_b2_c, bytes_chroma_alone=bytes_b2_c,
              scan_to_raster_calls=b2_reorders),
        entry("finish_color", "jpeg_tpu_torch/csrc/finish_color.cu",
              "jpeg_tpu/models/decoder.py:349", main_launches[4], err_h, ms_h,
              ms_h_plain, us_h, bytes_h, per[4],
              library_none="no one call: the upsample, the colour map and "
                           "the rounding are further calls",
              finish_ms_in_turns=ms_finish_turns,
              decode_ms_in_turns=ms_decode_turns,
              finish_kernels_by_profiler=len(finish_kernels)),
        {"name": "pack_scan", "route": "cuda",
         "source": "jpeg_tpu_torch/csrc/pack_scan.cu",
         "replaces": None, "launches": scan_per_encode, "max_abs_err": err_scan,
         "ms": ms_scan, "plain_ms": ms_scan_plain,
         "bound_ms": bound_us(bytes_scan) / 1e3, "bound_by": "bytes",
         "library_ms": None, "kernel_us": us_scan, "bytes": bytes_scan,
         "bound_us": bound_us(bytes_scan),
         "bound_share": bound_us(bytes_scan) / us_scan,
         "launches_per": {"default_encode": scan_per_encode,
                          "encode_stream_per_image": scan_per_stream_image},
         "covers": "the memset and the three kernels, one launch each"},
        {"name": "dc_sum", "route": "cuda",
         "source": "jpeg_tpu_torch/csrc/scan_decode.cu",
         "replaces": "the torch DC sums between the block-start program and "
                     "kernel D (10 operations anchored, 16 from bit 0)",
         "launches": main_launches[10],
         "launches_per": dict(zip(launch_paths, per[10])),
         "native_scans_per": dict(zip(launch_paths, per[9])),
         "by_shape": dc_sum},
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
    if sys.argv[1:2] == ["--rank"]:
        return rank_main(*sys.argv[2:])
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
