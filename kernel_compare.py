#!/usr/bin/env python3
"""Kernel-only times of the port's CUDA kernels, and of other versions of
them beside them, in turns on one card.

Usage, from the repository root, on a machine with a CUDA device and nvcc:

    python3 kernel_compare.py [--previous DIR] [--previous-c DIR]
                              [--candidate-a FILE.cu]... [--flags-a "..."]...
                              [--candidate-b FILE.cu]... [--flags-b "..."]...
                              [--candidate-c FILE.cu]... [--flags-c "..."]...
                              [--candidate-d FILE.cu]... [--flags-d "..."]...
                              [--previous-ef DIR] [--flags-f "..."]...
                              [--previous-finish DIR] [--flags-b2 "..."]...
                              [--flags-h "..."]... [--finish-only]
                              [--previous-only] [--ef-only] [--json FILE]
    python3 kernel_compare.py --progressive-4k

The package's own kernels A (pack_level1), B (idct8), C (dct8) and D
(ac_indexed) are always timed. --previous DIR names a directory that holds pack_level1.cu and idct8.cu
with the C entry points those files had before the tables were pre-packed
(jt_pack_level1 taking the four LUTs, jt_idct8 taking the basis), e.g. an
older commit unpacked with `git archive`. --previous-c DIR names a directory
that holds a dct8.cu whose jt_dct8 still takes the basis (kernel C's first
design). --candidate-a / -b / -c / -d name
another source with the current entry point; --flags-a / -b / -c / -d build the
package's own source once more with extra nvcc flags (e.g. "-DJT_THREADS=256",
"-DJT_D_TILE=64") as a further contender; each of the eight may be given more
than once.
--previous-only times the previous sources and the package's kernel
C and nothing else (for a tree whose own A and B do not build yet).

The block-start program (csrc/prefix_index.cu, built inside
csrc/scan_decode.cu: program F, and E's route with the DC sums and kernel D
enqueued by one C call) is timed on the eight 4K frames of
chip_smoke.sync_frames, held to its plain twins first, with its resolve
rounds, its scratch and each of its launches alone. --previous-ef DIR names
a directory that holds prefix_index.cu and segment_walk.cu as they were
before the chunked program (program F in 18 launches at 4K, kernel E; commit
c3598a5 or older), timed in turns with it on the same inputs; --flags-f
builds the package's program once more with extra nvcc flags (e.g.
"-DJT_CHUNK_BITS=1024", "-DJT_LANES=1") as a further contender. --ef-only
runs this comparison and nothing else.

The decode finish (kernels B2 and H, csrc/idct8.cu's jt_idct8_samples and
csrc/finish_color.cu) is timed on the blocks as the decoder gives them
(scan order) of the 4K image at 4:2:0, 4:4:4 and 4:2:2 and of a K = 4
stack of 4:2:0 frames (decode_batched's rows): B2 over all three
components in one launch and H alone, kernel only, in turns with their
--flags-b2 / --flags-h builds (e.g. "-DJT_THREADS=64") and, with
--previous-finish DIR (an older tree's csrc holding an idct8.cu with the
per-plane entry jt_idct8_zz_u8 and a finish_color.cu with jt_finish_color,
e.g. commit 970af81's), against the previous forms: the scan -> raster
copy and a B2 launch per component, and the previous H. Each build's
kernels are counted with cuobjdump -sass,
and the count gives an issue bound: warp instructions / (132 SMs x 4 per
clock x nvidia-smi's highest SM clock). Then the whole finish, wall time,
in turns: kernel B + torch ops (from_zigzag, unblockify, kernel B, round,
clamp, the torch upsample and colour map; kernel B built from
--previous-finish or else from the package), the previous B2 x3 + H, and
B2 + H. Every contender's samples or pixels are held to the package's
first, 0 apart. --finish-only runs this comparison and nothing else.

Inputs are those of chip_smoke.py's main path: the 3840x2160 4:2:0 image's
194,400 level-1 blocks at q75 and at q95 (dense), its Y and Cb coefficient
planes (kernel B) and pixel planes (kernel C), and what the host index pass
gives kernel D for the q75 stream. Every contender is first held against the
plain twin on these inputs. Times come from
chip_smoke.kernel_only_us (CUDA events around a graph of 20 launches over
rotating buffers, L2 cold), contenders in turns, forwards then backwards,
ROUNDS times; each time and the median per contender are printed with the
card's name and power limit. Last, one warm 4K decode is profiled
(torch.profiler) to show where kernel B's three launches lie on the device's
timeline and what runs between them, and how much of the decode's span on the
device is busy. Then one JSON object on the last line,
also written to the file --json names, if given.

--progressive-4k does none of that: it times one encode_progressive of the
3840x2160 image on the card (its scan emission is host Python, too slow to
sit in the smoke run), checks that the stream decodes to the baseline
stream's pixels, prints the seconds and exits.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import shlex
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

import chip_smoke as cs

ROUNDS = 3


def _ptrs(*tensors):
    return [ctypes.c_void_p(t.data_ptr()) for t in tensors]


def _old_f_steps(lib, words, n_mcu, seq, classes, tables, out, stream):
    """The launches of program F as it was before the chunked program (18 at
    4K): block ends per bit position and class, the MCU hop, the doubling
    levels, the replay; `out` = (ac_off, diff, status, block ends, two jump
    tables, zeroed starts)."""
    ac_off, diff, status, fb, jump, other, starts = out
    nwords, bpm, nbits = words.numel(), seq.shape[0], words.numel() * 32
    c_int, c_long = ctypes.c_int, ctypes.c_long
    steps = [lambda: lib.jt_prefix_block_ends(
        *_ptrs(words), c_int(nwords), *_ptrs(classes), c_int(classes.shape[0]),
        *_ptrs(tables), c_int(tables.shape[0]), *_ptrs(fb), stream()),
        lambda first=jump: lib.jt_prefix_mcu_hop(
            *_ptrs(fb), c_int(nbits), *_ptrs(seq), c_int(bpm), *_ptrs(first),
            stream())]
    levels = max(1, (n_mcu - 1).bit_length())
    for j in range(levels):
        steps.append(lambda j=j, a=jump, b=other: lib.jt_prefix_double(
            *_ptrs(a, b, starts), c_int(nbits), c_long(1 << j), c_long(n_mcu),
            c_int(j + 1 < levels), stream()))
        jump, other = other, jump
    steps.append(lambda: lib.jt_prefix_replay(
        *_ptrs(words), c_int(nwords), *_ptrs(fb, starts), c_long(n_mcu),
        *_ptrs(seq), c_int(bpm), *_ptrs(tables, ac_off, diff, status),
        stream()))
    return steps


def compare_ef(args, torch, card, dev, img, build, results):
    """Program F and kernel E as they were (--previous-ef DIR, a tree of
    jpeg_tpu_torch/csrc from before the chunked program) against the chunked
    block-start program (and its --flags-f builds), in turns, forwards and
    backwards, kernel only, on the frames of chip_smoke.sync_frames:
    unanchored on the streams without markers, anchored (the program alone,
    and the whole route with the DC sums and kernel D) on those with."""
    import jpeg_tpu_torch
    from jpeg_tpu_torch.ops import _cuda, entropy_decode as ED

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "tests"))
    import torch_port_util as port_util

    stream = lambda: _cuda.stream_handle(dev)  # noqa: E731
    # Every source builds at once, one nvcc each. The package's program and
    # its --flags-f builds come in csrc/scan_decode.cu, which includes it,
    # so that the whole route (the chain of one C call) runs on each.
    jobs = {"chunked": ("scan_decode", None, ())}
    for i, flags in enumerate(args.flags_f):
        jobs[f"chunked {flags}"] = (f"flags{i}_scan_decode",
                                    _cuda._CSRC / "scan_decode.cu",
                                    shlex.split(flags))
    if args.previous_ef:
        prev = pathlib.Path(args.previous_ef)
        jobs["previous F"] = ("previous_prefix_index",
                              prev / "prefix_index.cu", ())
        jobs["previous E"] = ("previous_segment_walk",
                              prev / "segment_walk.cu", ())
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = dict(zip(jobs, pool.map(lambda j: build(*j), jobs.values())))
    old_f, old_e = libs.pop("previous F", None), libs.pop("previous E", None)
    new = libs

    def timed_in_turns(kernel, case, contenders, nbytes):
        times = {name: [] for name in contenders}
        order = list(contenders) + list(contenders)[::-1]
        for _ in range(ROUNDS):
            for name in order:
                launch, nbuf = contenders[name]
                times[name].append(cs.kernel_only_us(launch, nbuf, torch))
        for name, ts in times.items():
            med = statistics.median(ts)
            print(f"{kernel} {case} [{name}]: kernel-only {med:.2f} us (each: "
                  f"{', '.join(f'{t:.2f}' for t in ts)}); {nbytes} bytes, "
                  f"bound {cs.bound_us(nbytes):.2f} us [{card}]", flush=True)
            results.append({"kernel": kernel, "case": case, "version": name,
                            "kernel_us": med, "each_us": ts, "bytes": nbytes,
                            "bound_us": cs.bound_us(nbytes)})

    def by_launch(kernel, case, sets):
        """Each launch of the package's program alone, on the outputs of the
        launches before it (sets: per buffer set, [(name, enqueue)])."""
        us = {name: cs.kernel_only_us(lambda i, k=k: sets[i][k][1](),
                                      len(sets), torch)
              for k, (name, _go) in enumerate(sets[0])}
        print(f"{kernel} {case} [chunked] by launch, kernel-only: "
              + "; ".join(f"{k} {v:.2f} us" for k, v in us.items())
              + f" [{card}]", flush=True)
        results.append({"kernel": kernel, "case": case, "version": "chunked",
                        "kernel_us_by_launch": us})

    def note(kernel, case, name, agrees, extra=""):
        print(f"{kernel} {case} [{name}]: vs plain twin: "
              f"{'ok (max |err| 0)' if agrees else 'DISAGREES'}{extra}",
              flush=True)
        results.append({"kernel": kernel, "case": case, "version": name,
                        "agrees": bool(agrees)})

    nsets = 4
    for case, (frame, kw) in cs.sync_frames(img).items():
        kw = {"quality": cs.QUALITY, **kw}
        if frame.ndim == 3:
            kw["subsampling"] = cs.SUBSAMPLING
        jpg = jpeg_tpu_torch.encode(frame, device=dev, **kw)
        if not kw.get("restart_interval"):
            f_in, _bits = port_util.prefix_inputs(jpg, dev)
            words, n_mcu, seq, classes, tables = f_in
            bpm = seq.shape[0]
            twin = ED.prefix_index_reference(*f_in)
            nbytes = words.numel() * 4 + 2 * n_mcu * bpm * 4
            contenders = {}

            def outs():
                return [torch.empty((n_mcu, bpm), dtype=torch.int32,
                                    device=dev) for _ in range(2)] + [
                    torch.zeros(2, dtype=torch.int32, device=dev)]

            if old_f is not None:
                nbits = words.numel() * 32
                sets = []
                for _ in range(nsets):
                    w = words.clone()
                    o = outs() + [
                        torch.empty((classes.shape[0], nbits),
                                    dtype=torch.int32, device=dev),
                        torch.empty(nbits, dtype=torch.int32, device=dev),
                        torch.empty(nbits, dtype=torch.int32, device=dev),
                        torch.zeros(n_mcu, dtype=torch.int32, device=dev)]
                    sets.append((w, o, _old_f_steps(
                        old_f, w, n_mcu, seq, classes, tables, o, stream)))
                for st in sets[0][2]:
                    _cuda.check("previous F", st())
                torch.cuda.synchronize()
                o = sets[0][1]
                note("F", case, f"previous ({len(sets[0][2])} launches)",
                     all(torch.equal(g, t) for g, t in zip(o[:3], twin)))

                def old_launch(i, sets=sets):
                    for st in sets[i][2]:
                        _cuda.check("previous F", st())

                contenders[f"previous ({len(sets[0][2])} launches)"] = (
                    old_launch, nsets)
            for name, lib in new.items():
                sets = []
                for _ in range(nsets):
                    w, o = words.clone(), outs()
                    scratch = ED.prefix_scratch(w.numel(), n_mcu,
                                                classes.shape[0], dev, lib)
                    sets.append((o, scratch, ED.prefix_launches(
                        w, n_mcu, seq, classes, tables, *o, scratch, lib)))
                for _n, enqueue in sets[0][2]:
                    enqueue()
                torch.cuda.synchronize()
                o, scratch = sets[0][0], sets[0][1]
                passes = int(scratch[:4].view(torch.int32)[0])
                note("F", case, name,
                     all(torch.equal(g, t) for g, t in zip(o, twin)),
                     f"; repair passes {passes}; scratch {scratch.numel()} "
                     f"bytes")
                results.append({"kernel": "F", "case": case, "version": name,
                                "sync_passes": passes,
                                "scratch_bytes": scratch.numel()})

                def new_launch(i, sets=sets):
                    for _n, enqueue in sets[i][2]:
                        enqueue()

                contenders[name] = (new_launch, nsets)
                if name == "chunked":
                    launch_sets = [steps for _o, _s, steps in sets]
            timed_in_turns("F", case, contenders, nbytes)
            by_launch("F", case, launch_sets)
            continue
        e_in, _bits = port_util.segment_inputs(jpg, dev)
        words, seg_off, interval, n_mcu, seq, tables, nblocks = e_in
        t_rows, t_status = ED.decode_segments_reference(*e_in)
        nseg = seg_off.numel()
        nbytes = words.numel() * 4 + nseg * 4 + nblocks * 256
        contenders = {}
        if old_e is not None:
            sets = [(torch.zeros((nblocks, 64), dtype=torch.int32, device=dev),
                     torch.empty((2, nseg), dtype=torch.int32, device=dev))
                    for _ in range(nsets)]

            def old_e_launch(i, sets=sets):
                rows, status = sets[i]
                _cuda.check("previous E", old_e.jt_segment_walk(
                    *_ptrs(words), ctypes.c_int(words.numel()),
                    *_ptrs(seg_off), ctypes.c_int(nseg),
                    ctypes.c_long(interval), ctypes.c_long(n_mcu),
                    *_ptrs(seq), ctypes.c_int(seq.shape[0]), *_ptrs(tables),
                    ctypes.c_int(tables.shape[0]), *_ptrs(rows, status),
                    stream()))

            old_e_launch(0)
            torch.cuda.synchronize()
            note("E", case, "previous", torch.equal(sets[0][0], t_rows)
                 and torch.equal(sets[0][1], t_status))
            contenders["previous"] = (old_e_launch, nsets)
        comps = seq[:, 0].tolist()
        comp_bpm = [comps.count(c) for c in sorted(set(comps))]
        for name, lib in new.items():
            def route_launch(i, lib=lib):
                return ED.scan_decode(dev, True, words.numel(), nseg, interval,
                                      n_mcu, seq, tables, comp_bpm,
                                      words=words, seg_off=seg_off, lib=lib)

            rows, status = route_launch(0)
            torch.cuda.synchronize()
            passes = ED.SYNC_PASSES
            note("E", case, f"{name} + sums + D",
                 torch.equal(rows, t_rows) and torch.equal(status, t_status),
                 f"; repair passes {passes}")
            results.append({"kernel": "E", "case": case, "version": name,
                            "sync_passes": passes})
            alone = []
            for _ in range(nsets):
                per_block = torch.empty((4, nblocks), dtype=torch.int32,
                                        device=dev)
                status = torch.empty((2, nseg), dtype=torch.int32, device=dev)
                scratch = ED.sync_scratch(words.numel(), nseg, seq.shape[0],
                                          n_mcu, dev, lib)
                alone.append(ED._sync_steps(
                    lib, words, seg_off, interval, n_mcu, seq, tables,
                    scratch, per_block[0], per_block[1], status,
                    per_block[2], per_block[3]))

            def alone_launch(i, alone=alone):
                for _n, enqueue in alone[i]:
                    enqueue()

            if name == "chunked":
                launch_sets = alone

            contenders[f"{name}, program alone"] = (alone_launch, nsets)
            contenders[f"{name} + sums + D"] = (route_launch, nsets)
        timed_in_turns("E", case, contenders, nbytes)
        by_launch("E", case, launch_sets)


def sass_counts(lib_path) -> dict:
    """Kernel function (mangled name) -> its SASS instructions (NOPs left
    out), from cuobjdump -sass on a built library; {} where the toolkit has
    no cuobjdump."""
    import re
    import shutil
    import subprocess

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not pathlib.Path(tool).exists():
        return {}
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                         text=True, timeout=300).stdout
    counts, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+\S", line) and (
                " NOP" not in line):
            counts[name] += 1
    return counts


def sm_clock_mhz() -> float:
    """The card's highest SM clock (nvidia-smi clocks.max.sm)."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout
    return float(out.split()[0])


def compare_finish(args, torch, card, dev, img, build, results):
    """Kernels B2 and H against their --flags-b2 / --flags-h builds and
    against --previous-finish's forms (a launch of the previous B2 per
    component after the scan -> raster copy; the previous H), kernel only,
    in turns, on the 4K image at 4:2:0, 4:4:4 and 4:2:2 and on a K = 4
    stack of 4:2:0 frames as decode_batched stacks them; each kernel's SASS
    instructions and the issue bound they give; and the 4K 4:2:0 finish
    against the one before B2 and H (kernel B + torch ops) and the previous
    forms, wall time, in turns."""
    import jpeg_tpu_torch
    from jpeg_tpu_torch.io import jfif
    from jpeg_tpu_torch.models import decoder, layout
    from jpeg_tpu_torch.ops import _cuda, finish as fin, fused, tile, zigzag

    stream = lambda: _cuda.stream_handle(dev)  # noqa: E731
    clock = sm_clock_mhz()

    def in_turns(kernel, case, contenders, nbytes):
        """contenders: name -> (launch(i), buffer sets)."""
        times = {name: [] for name in contenders}
        order = list(contenders) + list(contenders)[::-1]
        for _ in range(ROUNDS):
            for name in order:
                launch, nbuf = contenders[name]
                times[name].append(cs.kernel_only_us(launch, nbuf, torch))
        bound = cs.bound_us(nbytes)
        for name, ts in times.items():
            med = statistics.median(ts)
            print(f"{kernel} {case} [{name}]: kernel-only {med:.2f} us (each: "
                  f"{', '.join(f'{t:.2f}' for t in ts)}); {nbytes} bytes, "
                  f"bound {bound:.2f} us, share {bound / med:.3f} [{card}]",
                  flush=True)
            results.append({"kernel": kernel, "case": case, "version": name,
                            "kernel_us": med, "each_us": ts, "bytes": nbytes,
                            "bound_us": bound, "bound_share": bound / med})

    def note(kernel, case, name, agrees):
        print(f"{kernel} {case} [{name}]: vs the package's: "
              f"{'ok (0 apart)' if agrees else 'DISAGREES'}", flush=True)
        results.append({"kernel": kernel, "case": case, "version": name,
                        "agrees": bool(agrees)})

    def sass(kernel, version, lib_name, fn_part, warps):
        """Print one kernel function's SASS instruction count and the issue
        bound of `warps` warps each issuing that many: warp instructions /
        (132 SMs x 4 issues per clock x the highest SM clock)."""
        counts = sass_counts(_cuda._BUILD_DIR / f"lib{lib_name}.so")
        for fn, n in counts.items():
            if fn_part in fn:
                us = warps * n / (132 * 4 * clock * 1e6) * 1e6
                print(f"SASS {kernel} [{version}] {fn}: {n} instructions; "
                      f"x {warps} warps -> issue bound {us:.2f} us at "
                      f"{clock:.0f} MHz [{card}]", flush=True)
                results.append({"kernel": kernel, "version": version,
                                "function": fn, "sass_instructions": n,
                                "warps": warps, "issue_bound_us": us,
                                "sm_clock_mhz": clock})
        if not counts:
            print(f"SASS {kernel} [{version}]: no cuobjdump", flush=True)

    b2_libs = {"package": ("idct8", _cuda.load("idct8"))}
    for i, flags in enumerate(args.flags_b2):
        b2_libs[f"flags {flags}"] = (f"idct8_b2_flags{i}", build(
            f"idct8_b2_flags{i}", _cuda._CSRC / "idct8.cu", shlex.split(flags)))
    h_libs = {"package": ("finish_color", _cuda.load("finish_color"))}
    for i, flags in enumerate(args.flags_h):
        h_libs[f"flags {flags}"] = (f"finish_color_flags{i}", build(
            f"finish_color_flags{i}", _cuda._CSRC / "finish_color.cu",
            shlex.split(flags)))
    prev_b2 = None
    if args.previous_finish:
        prev_b2 = build("idct8_previous_finish",
                        pathlib.Path(args.previous_finish) / "idct8.cu")
        h_libs["previous"] = ("finish_color_previous", build(
            "finish_color_previous",
            pathlib.Path(args.previous_finish) / "finish_color.cu"))

    def case_inputs(subsampling, k):
        """The decoder's finish inputs for k frames (the image rolled by
        cs.ROLL columns) of one stream geometry: per component the blocks
        as the decoder hands them over (k > 1: decode_batched's (k, B, 64)
        rows, a slice per component), tables, block grids of one image, scan
        geometry, ratios, upsample choices, rows and columns."""
        jpgs = [jpeg_tpu_torch.encode(np.roll(img, i * cs.ROLL, axis=1),
                                      cs.QUALITY, subsampling, device=dev)
                for i in range(k)]
        info = jfif.parse_jpeg(jpgs[0])
        comps = info.components
        hm, vm = max(c.h for c in comps), max(c.v for c in comps)
        mr = layout.ceil_div(info.height, 8 * vm)
        mc = layout.ceil_div(info.width, 8 * hm)
        per = [decoder._scan_blocks(jfif.parse_jpeg(j), mr, mc, "auto", dev)
               for j in jpgs]
        zs, scan = per[0]
        if k > 1:
            rows = torch.stack([torch.cat(z) for z, _ in per])
            bounds = np.cumsum([0] + [z.shape[0] for z in zs])
            zs = [rows[:, lo:hi] for lo, hi in zip(bounds[:-1], bounds[1:])]
        qt = [torch.as_tensor(info.qtables[c.qtab_id], dtype=torch.float32,
                              device=dev) for c in comps]
        shapes = [(mr * c.v, mc * c.h) for c in comps]
        factors = tuple((hm // c.h, vm // c.v) for c in comps)
        fancy = decoder.upsample_choices(info.width, comps, hm, True)
        return (zs, qt, shapes, scan, factors, fancy, info.height,
                info.width)

    def compare_case(label, subsampling, k):
        """B2 and H alone, in turns with their other builds and forms."""
        zs, qt, shapes, scan, factors, fancy, h, w = case_inputs(
            subsampling, k)
        samples = fused.dequant_idct_planes(zs, qt, shapes, scan, n_img=k)
        planes = [s if k == 1 else s.reshape(k, hb * 8, wb * 8)
                  for s, (hb, wb) in zip(samples, shapes)]
        rgb = fin.finish_color(planes, factors, fancy, False, h, w)
        # Kernel B2: every component in one launch, reading the scan order
        # in place; the previous form: the scan -> raster copy of the
        # components with several blocks to an MCU, then a launch per
        # component on the k images stacked along their rows.
        _, qs, _, geos = fused._prepare_planes(fused._components(
            zs, qt, shapes, scan, k, samples), k, dev)
        nblk = k * sum(hb * wb for hb, wb in shapes)
        nbytes = nblk * 64 * 5
        nbuf = cs.rotation(nbytes)
        ins = [[z.contiguous().clone() for z in zs] for _ in range(nbuf)]
        geos_c = [(g[0], g[1], g[2], g[1] * g[2], *g[4:]) for g in geos]
        outs = [[torch.empty_like(s) for s in samples] for _ in range(nbuf)]
        contenders = {}
        for name, (_, lib) in b2_libs.items():
            fused._launch_idct_samples(ins[0], qs, outs[0], geos_c, lib=lib)
            torch.cuda.synchronize()
            note("B2", label, name, all(torch.equal(o, s)
                                        for o, s in zip(outs[0], samples)))
            contenders[name] = (lambda i, lib=lib: fused._launch_idct_samples(
                ins[i], qs, outs[i], geos_c, lib=lib), nbuf)
        if prev_b2 is not None:
            reordered = [[torch.empty_like(z) for z in ins[0]]
                         for _ in range(nbuf)]

            def prev_launch(i):
                for z, r, q, o, (hb, wb), g in zip(ins[i], reordered[i], qs,
                                                   outs[i], shapes, scan):
                    if g is not None:
                        mr_, mc_, v, h_ = g
                        r.view(k * mr_, v, mc_, h_, 64).copy_(
                            z.view(k * mr_, mc_, v, h_, 64).permute(
                                0, 2, 1, 3, 4))
                        z = r
                    _cuda.check("previous B2", prev_b2.jt_idct8_zz_u8(
                        *_ptrs(z, q, o), ctypes.c_int(k * hb),
                        ctypes.c_int(wb), stream()))

            prev_launch(0)
            torch.cuda.synchronize()
            name = "previous: scan -> raster copy + a launch per component"
            note("B2", label, name, all(torch.equal(o, s)
                                        for o, s in zip(outs[0], samples)))
            contenders[name] = (prev_launch, nbuf)
        in_turns("B2", f"{label}, {nblk} blocks of three components",
                 contenders, nbytes)

        # Kernel H.
        _, geo = fin._geometry(planes, factors, fancy, h, w)
        nbytes = sum(p.numel() for p in planes) + rgb.numel()
        nbuf = cs.rotation(nbytes)
        ins = [[p.clone() for p in planes] for _ in range(nbuf)]
        outs = [torch.empty_like(rgb) for _ in range(nbuf)]
        contenders = {}
        for name, (_, lib) in h_libs.items():
            fin._launch_finish(ins[0], geo, outs[0], k, h, w, False, lib=lib)
            torch.cuda.synchronize()
            note("H", label, name, torch.equal(outs[0], rgb))
            contenders[name] = (lambda i, lib=lib: fin._launch_finish(
                ins[i], geo, outs[i], k, h, w, False, lib=lib), nbuf)
        in_turns("H", f"{label} {h}x{w}", contenders, nbytes)
        return zs, qt, shapes, scan, factors, fancy, h, w, samples, rgb, geos

    cases = [(f"4K {cs.SUBSAMPLING}", cs.SUBSAMPLING, 1), ("4K 444", "444", 1),
             ("4K 422", "422", 1), (f"K=4 4K {cs.SUBSAMPLING}",
                                    cs.SUBSAMPLING, 4)]
    first = None
    for label, subsampling, k in cases:
        got = compare_case(label, subsampling, k)
        first = first or got
    zs, qt, shapes, scan, factors, fancy, h, w, samples, rgb, geos = first

    # Instructions: B2 (all three components of the 4K 4:2:0 image), H in
    # the form the 4:2:0 image takes and in its general form (the package's
    # build: 128 threads, tiles of 16 rows x 256 columns).
    warps_b2 = sum(-(-hb * wb // 128) for hb, wb in shapes) * 4
    for name, (lib_name, _) in b2_libs.items():
        sass("B2", name, lib_name, "idct8_samples_kernel", warps_b2)
    if prev_b2 is not None:
        sass("B2", "previous, a launch per component", "idct8_previous_finish",
             "idct8_kernelILb1", warps_b2)
    warps_h = -(-w // 256) * -(-h // 16) * 4
    for name, (lib_name, _) in h_libs.items():
        if name == "previous":
            sass("H", name, lib_name, "finish_color_kernel",
                 -(-w // 8 // 128) * h * 4)
        else:
            sass("H", f"{name}, 4:2:0 form", lib_name,
                 "finish_color_kernelILb1ELi1E", warps_h)
            sass("H", f"{name}, general form", lib_name,
                 "finish_color_kernelILb1ELi0E", warps_h)

    # The 4K finish, wall time, in turns.
    _, geo = fin._geometry(samples, factors, fancy, h, w)
    if args.previous_finish:
        lib_b = prev_b2
        label_b = f"kernel B from {args.previous_finish} + torch ops"
    else:
        lib_b = _cuda.load("idct8")
        label_b = "kernel B + torch ops"

    def torch_finish():
        planes = []
        for z, q, (hb, wb), f, fan in zip(
                decoder._raster_blocks(zs, scan), qt, shapes, factors, fancy):
            coeffs = tile.unblockify(zigzag.from_zigzag(
                z.reshape(hb, wb, 64))).contiguous()
            plane = torch.empty(coeffs.shape, dtype=torch.float32, device=dev)
            _cuda.check("previous B", lib_b.jt_idct8(
                *_ptrs(coeffs, q.reshape(64).contiguous(), plane),
                ctypes.c_int(hb * 8), ctypes.c_int(wb * 8), stream()))
            planes.append(fin.upsample(
                torch.clamp(torch.round(plane), 0.0, 255.0), f, fan))
        return fin.rgb_from_planes(planes, False)[:h, :w]

    def b2_h():
        return decoder._finish_color(*zs, *qt, shapes, factors, fancy,
                                     hlim=h, wlim=w, scan=scan)

    def b2_h_direct():
        planes = [torch.empty_like(s) for s in samples]
        fused._launch_idct_samples(zs, [q.reshape(64) for q in qt], planes,
                                   geos)
        out = torch.empty((h, w, 3), dtype=torch.uint8, device=dev)
        fin._launch_finish(planes, geo, out, 1, h, w, False)
        return out

    forms = {label_b: torch_finish, "kernels B2 + H": b2_h,
             "kernels B2 + H, launched directly": b2_h_direct}
    if args.previous_finish:
        prev_h = h_libs["previous"][1]

        def prev_b2_h():
            planes = []
            for z, q, (hb, wb) in zip(decoder._raster_blocks(zs, scan), qt,
                                      shapes):
                o = torch.empty((hb * 8, wb * 8), dtype=torch.uint8,
                                device=dev)
                _cuda.check("previous B2", prev_b2.jt_idct8_zz_u8(
                    *_ptrs(z, q.reshape(64).contiguous(), o),
                    ctypes.c_int(hb), ctypes.c_int(wb), stream()))
                planes.append(o)
            out = torch.empty((h, w, 3), dtype=torch.uint8, device=dev)
            fin._launch_finish(planes, geo, out, 1, h, w, False, lib=prev_h)
            return out

        forms["previous B2 x3 + H (scan -> raster first), launched "
              "directly"] = prev_b2_h
    for name, fn in forms.items():
        note("finish", "4K", name, torch.equal(fn(), rgb))
    times = {name: [] for name in forms}
    for _ in range(ROUNDS):
        ms = cs.medians_in_turns(forms, torch, cs.RUNS)
        for name, v in ms.items():
            times[name].append(v)
    for name, ts in times.items():
        med = statistics.median(ts)
        print(f"finish 4K [{name}]: {med:.3f} ms wall (each: "
              f"{', '.join(f'{t:.3f}' for t in ts)}) [{card}]", flush=True)
        results.append({"kernel": "finish", "case": "4K", "version": name,
                        "wall_ms": med, "each_ms": ts})


def trace_decode(torch, img, card):
    """Profile one warm 4K colour decode and report where kernel B2's
    launches (idct8_samples_kernel) lie on the device's timeline: each
    launch's duration, and for each gap between two of them its length, the
    other kernels that ran in it and the time the device was idle in it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import jpeg_tpu_torch

    jpg = jpeg_tpu_torch.encode(img, cs.QUALITY, cs.SUBSAMPLING, device="cuda")
    for _ in range(2):
        jpeg_tpu_torch.decode(jpg, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        jpeg_tpu_torch.decode(jpg, device="cuda")
        torch.cuda.synchronize()
    kernels = sorted(
        ((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
         if e.device_type == DeviceType.CUDA),
        key=lambda k: k[0])
    idct = [i for i, k in enumerate(kernels)
            if "idct8_samples_kernel" in k[2]]
    report = {"idct8_us": [kernels[i][1] - kernels[i][0] for i in idct],
              "gaps": []}
    for i, j in zip(idct, idct[1:]):
        between = kernels[i + 1:j]
        gap = kernels[j][0] - kernels[i][1]
        busy = sum(k[1] - k[0] for k in between)
        report["gaps"].append({"gap_us": gap, "kernels_between": len(between),
                               "busy_us": busy, "idle_us": gap - busy})
    first, last = kernels[0][0], kernels[-1][1]
    report["device_span_us"] = last - first
    report["device_busy_us"] = sum(k[1] - k[0] for k in kernels)
    by_name: dict = {}
    for start, end, name in kernels:
        by_name[name] = by_name.get(name, 0.0) + end - start
    report["longest_us"] = sorted(
        ((round(us, 1), name[:60]) for name, us in by_name.items()),
        reverse=True)[:6]
    print(f"decode trace: longest on the device, by name: "
          f"{report['longest_us']}", flush=True)
    print(f"decode trace: kernel B2 launches "
          f"{[round(t, 1) for t in report['idct8_us']]} us; gaps between "
          f"them {report['gaps']}; device span {report['device_span_us']:.0f} "
          f"us, busy {report['device_busy_us']:.0f} us over {len(kernels)} "
          f"kernels and copies [{card}]", flush=True)
    return report


def progressive_4k(card: str) -> int:
    """One 4K progressive encode on the card, timed once."""
    import jpeg_tpu_torch
    from jpeg_tpu_torch.models.progressive_enc import encode_progressive

    img = cs.make_image(cs.HEIGHT, cs.WIDTH)
    base = jpeg_tpu_torch.encode(img, cs.QUALITY, cs.SUBSAMPLING,
                                 device="cuda")
    prog, secs = cs.timed(lambda: encode_progressive(
        img, cs.QUALITY, cs.SUBSAMPLING, device="cuda"))
    same = np.array_equal(jpeg_tpu_torch.decode(prog, device="cuda"),
                          jpeg_tpu_torch.decode(base, device="cuda"))
    print(f"encode_progressive 4K q{cs.QUALITY} {cs.SUBSAMPLING}: "
          f"{secs:.2f} s, {len(prog)} bytes (baseline {len(base)}); decode "
          f"equals the baseline stream's: {same} [{card}]", flush=True)
    return 0 if same else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--previous")
    ap.add_argument("--previous-c")
    ap.add_argument("--candidate-a", action="append", default=[])
    ap.add_argument("--candidate-b", action="append", default=[])
    ap.add_argument("--flags-a", action="append", default=[])
    ap.add_argument("--flags-b", action="append", default=[])
    ap.add_argument("--candidate-c", action="append", default=[])
    ap.add_argument("--flags-c", action="append", default=[])
    ap.add_argument("--candidate-d", action="append", default=[])
    ap.add_argument("--flags-d", action="append", default=[])
    ap.add_argument("--flags-f", action="append", default=[])
    ap.add_argument("--previous-ef")
    ap.add_argument("--ef-only", action="store_true")
    ap.add_argument("--previous-finish")
    ap.add_argument("--flags-b2", action="append", default=[])
    ap.add_argument("--flags-h", action="append", default=[])
    ap.add_argument("--finish-only", action="store_true")
    ap.add_argument("--previous-only", action="store_true")
    ap.add_argument("--json")
    ap.add_argument("--progressive-4k", action="store_true")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernel_compare: no CUDA device", file=sys.stderr)
        return 2
    if args.progressive_4k:
        return progressive_4k(cs.card_line())
    from jpeg_tpu_torch.config import Subsampling
    from jpeg_tpu_torch.entropy import huffman
    from jpeg_tpu_torch.models import encoder
    from jpeg_tpu_torch.ops import (
        _cuda, bitpack, dct, entropy_decode, fused, pack, quant, tile, zigzag)

    # Kernel D's inputs are built as the card tests build them.
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "tests"))
    import torch_port_util as port_util

    dev = torch.device("cuda")
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    stream = lambda: _cuda.stream_handle(dev)  # noqa: E731

    def build(name, source=None, flags=()):
        lib = _cuda.load(name, source, flags)
        log = _cuda.BUILD_LOG.get(name, (0.0, ""))[1]
        for ln in log.splitlines():
            if "registers" in ln or "bytes stack" in ln or "Compiling" in ln:
                print(f"build {name}: {ln.strip()}", flush=True)
        return lib

    img = cs.make_image(cs.HEIGHT, cs.WIDTH)
    if args.finish_only:
        results = []
        compare_finish(args, torch, card, dev, img, build, results)
        return finish(args, {"card": card, "results": results,
                             "decode_trace": None})
    if args.ef_only:
        results = []
        compare_ef(args, torch, card, dev, img, build, results)
        return finish(args, {"card": card, "results": results,
                             "decode_trace": None})

    # Inputs.
    mode = Subsampling(cs.SUBSAMPLING)
    dimg = tile.pad_to_multiple(torch.as_tensor(img, device=dev),
                                mode.mcu_height, mode.mcu_width)
    luts_np = bitpack.luts_from_tables(huffman.standard_tables())
    luts = tuple(torch.as_tensor(a.astype(np.int32), device=dev)
                 for a in luts_np)
    packed = pack.pack_tables(*luts)
    budget = bitpack.BLOCK_WORDS * 32
    level1_inputs = {}
    for q in (cs.QUALITY, 95):
        blocks, tbl, _, _ = encoder._interleaved_blocks(
            dimg, quant.luma_table(q), quant.chroma_table(q), mode, 0)
        level1_inputs[f"q{q}"] = (blocks.contiguous(), tbl.contiguous())
    qy, qc = quant.luma_table(cs.QUALITY), quant.chroma_table(cs.QUALITY)
    y_zz, cb_zz, _ = encoder._transform_color(dimg, qy, qc, mode)
    hb, wb = dimg.shape[0] // 8, dimg.shape[1] // 8
    coef_planes = {
        "Y": (tile.unblockify(zigzag.from_zigzag(
            y_zz.reshape(hb, wb, 64))).contiguous(), qy),
        "Cb": (tile.unblockify(zigzag.from_zigzag(
            cb_zz.reshape(hb // 2, wb // 2, 64))).contiguous(), qc),
    }
    y_px, cb_px, _ = encoder._pallas_planes(dimg, mode)
    pixel_planes = {"Y": (y_px.contiguous(), qy), "Cb": (cb_px.contiguous(), qc)}
    basis = dct._on_device("basis", dev).reshape(64)

    # Contenders: name -> function(inputs, outputs) that enqueues one launch.
    a_launchers, b_launchers, c_launchers = {}, {}, {}
    if args.previous_c:
        lib_c = build("previous_dct8",
                      pathlib.Path(args.previous_c) / "dct8.cu")

        def prev_c(plane, q, out):
            _cuda.check("previous C", lib_c.jt_dct8(
                *_ptrs(plane, q, basis, out), ctypes.c_int(plane.shape[0]),
                ctypes.c_int(plane.shape[1]), stream()))

        c_launchers["previous"] = prev_c
    if args.previous:
        prev = pathlib.Path(args.previous)
        lib_a = build("previous_pack_level1", prev / "pack_level1.cu")
        lib_b = build("previous_idct8", prev / "idct8.cu")

        def prev_a(blocks, tbl, buf, totals):
            _cuda.check("previous A", lib_a.jt_pack_level1(
                *_ptrs(blocks, tbl, *luts, buf, totals),
                ctypes.c_long(blocks.shape[0]), stream()))

        def prev_b(coeffs, q, out):
            _cuda.check("previous B", lib_b.jt_idct8(
                *_ptrs(coeffs, q, basis, out), ctypes.c_int(coeffs.shape[0]),
                ctypes.c_int(coeffs.shape[1]), stream()))

        a_launchers["previous"], b_launchers["previous"] = prev_a, prev_b

    def current_abi_a(lib, label):
        def launch(blocks, tbl, buf, totals):
            _cuda.check(label, lib.jt_pack_level1(
                *_ptrs(blocks, tbl, packed, buf, totals),
                ctypes.c_long(blocks.shape[0]), stream()))
        return launch

    def current_abi_b(lib, label):
        def launch(coeffs, q, out):
            _cuda.check(label, lib.jt_idct8(
                *_ptrs(coeffs, q, out), ctypes.c_int(coeffs.shape[0]),
                ctypes.c_int(coeffs.shape[1]), stream()))
        return launch

    def current_abi_c(lib, label):
        def launch(plane, q, out):
            _cuda.check(label, lib.jt_dct8(
                *_ptrs(plane, q, out), ctypes.c_int(plane.shape[0]),
                ctypes.c_int(plane.shape[1]), stream()))
        return launch

    if not args.previous_only:
        build("pack_level1")
        build("idct8")
        a_launchers["current"] = lambda b, t, buf, tot: pack._launch(
            b, t, packed, buf, tot)
        b_launchers["current"] = fused._launch_idct
        for i, flags in enumerate(args.flags_a):
            a_launchers[f"current {flags}"] = current_abi_a(build(
                f"flags{i}_pack_level1", _cuda._CSRC / "pack_level1.cu",
                shlex.split(flags)), "flags A")
        for i, flags in enumerate(args.flags_b):
            b_launchers[f"current {flags}"] = current_abi_b(build(
                f"flags{i}_idct8", _cuda._CSRC / "idct8.cu",
                shlex.split(flags)), "flags B")
        for i, src in enumerate(args.candidate_a):
            a_launchers[f"candidate {src}"] = current_abi_a(
                build(f"candidate{i}_pack_level1", src), "candidate A")
        for i, src in enumerate(args.candidate_b):
            b_launchers[f"candidate {src}"] = current_abi_b(
                build(f"candidate{i}_idct8", src), "candidate B")
    build("dct8")
    c_launchers["current"] = fused._launch_dct
    for i, flags in enumerate(args.flags_c):
        c_launchers[f"current {flags}"] = current_abi_c(build(
            f"flags{i}_dct8", _cuda._CSRC / "dct8.cu", shlex.split(flags)),
            "flags C")
    for i, src in enumerate(args.candidate_c):
        c_launchers[f"candidate {src}"] = current_abi_c(
            build(f"candidate{i}_dct8", src), "candidate C")

    def current_abi_d(lib, label):
        def launch(words, off, dc, slot, tables, rows):
            _cuda.check(label, lib.jt_ac_indexed(
                *_ptrs(words), ctypes.c_int(words.numel()),
                *_ptrs(off, dc, slot, tables), ctypes.c_int(tables.shape[0]),
                *_ptrs(rows), ctypes.c_long(off.shape[0]), stream()))
        return launch

    build("ac_indexed")
    d_launchers = {"current": entropy_decode._launch_ac_indexed}
    for i, flags in enumerate(args.flags_d):
        d_launchers[f"current {flags}"] = current_abi_d(build(
            f"flags{i}_ac_indexed", _cuda._CSRC / "ac_indexed.cu",
            shlex.split(flags)), "flags D")
    for i, src in enumerate(args.candidate_d):
        d_launchers[f"candidate {src}"] = current_abi_d(
            build(f"candidate{i}_ac_indexed", src), "candidate D")

    results = []
    failed = False

    def run_case(kernel, case, launchers, inputs, make_out, nbytes, check):
        """Check every contender against the twin, then time them in turns."""
        nonlocal failed
        nbuf = cs.rotation(nbytes)
        ins = [tuple(t.clone() for t in inputs) for _ in range(nbuf)]
        outs = [make_out() for _ in range(nbuf)]
        times = {name: [] for name in launchers}
        first = None
        for name, fn in launchers.items():
            fn(*ins[0], *outs[0])
            torch.cuda.synchronize()
            err = check(outs[0])
            if first is None:
                first = (name, outs[0][0].clone())
            same = "" if first[0] == name else (
                f"; vs [{first[0]}]: max |diff| "
                f"{float((outs[0][0].double() - first[1].double()).abs().max()):.3g}")
            print(f"{kernel} {case} [{name}]: vs plain twin: {err}{same}",
                  flush=True)
            if not err.startswith("ok"):
                failed = True
        order = list(launchers) + list(launchers)[::-1]
        for _ in range(ROUNDS):
            for name in order:
                fn = launchers[name]
                times[name].append(cs.kernel_only_us(
                    lambda i: fn(*ins[i], *outs[i]), nbuf, torch))
        bound = cs.bound_us(nbytes)
        for name, ts in times.items():
            med = statistics.median(ts)
            print(f"{kernel} {case} [{name}]: kernel-only {med:.2f} us (each: "
                  f"{', '.join(f'{t:.2f}' for t in ts)}); {nbytes} bytes, "
                  f"bound {bound:.2f} us, share {bound / med:.3f}, "
                  f"{nbytes / med / 1e3:.0f} GB/s [{card}]", flush=True)
            results.append({"kernel": kernel, "case": case, "version": name,
                            "kernel_us": med, "each_us": ts, "bytes": nbytes,
                            "bound_us": bound, "bound_share": bound / med,
                            "buffers": nbuf})

    for case, (blocks, tbl) in level1_inputs.items():
        n = blocks.shape[0]
        ref = pack.pack_level1_reference(blocks, tbl, *luts)
        over = int((ref[1] > budget).sum())
        print(f"A {case}: {n} blocks, {over} over {budget} bits, mean "
              f"{float(ref[1].float().mean()):.1f} bits, "
              f"{float((blocks != 0).sum()) / n:.2f} nonzeros per block",
              flush=True)

        def check_a(out, ref=ref):
            e, _ = cs.level1_err(out, ref, budget)
            return "ok (max |err| 0)" if e == 0 else f"DISAGREES (max {e})"

        run_case(
            "A", case, a_launchers, (blocks, tbl),
            lambda n=n: (torch.empty((n, bitpack.BLOCK_WORDS + 1),
                                     dtype=torch.int32, device=dev),
                         torch.empty((n,), dtype=torch.int32, device=dev)),
            cs.level1_bytes(n), check_a)

    for case, (coeffs, qt) in coef_planes.items():
        q = torch.as_tensor(qt, dtype=torch.float32, device=dev).reshape(64)
        ref = fused.fused_dequant_idct_reference(coeffs, qt)

        def check_b(out, ref=ref):
            e = float((out[0] - ref).abs().max())
            return f"ok (max |err| {e:.3g})" if e <= 1e-2 else f"DISAGREES ({e})"

        run_case("B", f"{case} {tuple(coeffs.shape)}", b_launchers,
                 (coeffs, q),
                 lambda c=coeffs: (torch.empty(c.shape, dtype=torch.float32,
                                               device=dev),),
                 cs.plane_bytes(*coeffs.shape), check_b)

    for case, (plane, qt) in pixel_planes.items():
        q = torch.as_tensor(qt, dtype=torch.float32, device=dev).reshape(64)
        ref = fused.fused_dct_quantize_reference(plane, qt)

        def check_c(out, ref=ref):
            e, nd, _, _ = cs.coef_diff(out[0], ref)
            return f"{'ok' if nd == 0 else 'DISAGREES'} (max |err| {e}, {nd} differ)"

        run_case("C", f"{case} {tuple(plane.shape)}", c_launchers, (plane, q),
                 lambda p=plane: (torch.empty(p.shape, dtype=torch.int32,
                                              device=dev),),
                 cs.plane_bytes(*plane.shape), check_c)

    import jpeg_tpu_torch

    d_in = port_util.ac_indexed_inputs(jpeg_tpu_torch.encode(
        img, cs.QUALITY, cs.SUBSAMPLING, device="cuda"), dev)
    ref_d = entropy_decode.decode_ac_indexed_reference(*d_in)
    nblk = d_in[1].shape[0]

    def check_d(out, ref=ref_d):
        e = cs.int_err(out[0], ref)
        return "ok (max |err| 0)" if e == 0 else f"DISAGREES (max {e})"

    run_case("D", f"q{cs.QUALITY} {nblk} blocks", d_launchers, d_in,
             lambda: (torch.empty((nblk, 64), dtype=torch.int32, device=dev),),
             d_in[0].numel() * 4 + 3 * nblk * 4 + nblk * 256, check_d)

    compare_ef(args, torch, card, dev, img, build, results)
    compare_finish(args, torch, card, dev, img, build, results)

    trace = None
    if not args.previous_only:
        trace = trace_decode(torch, img, card)
    return finish(args, {"card": card, "results": results,
                         "decode_trace": trace}, failed)


def finish(args, out, failed=False) -> int:
    """Write the JSON object (to --json too) and give the exit code: 1 if a
    contender disagreed with its twin."""
    failed = failed or any(r.get("agrees") is False for r in out["results"])
    if args.json:
        path = pathlib.Path(args.json)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
