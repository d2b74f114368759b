"""ctypes binding for the native (C++) entropy runtime.

Compiles the port's own copy of the runtime, jpeg_tpu_torch/csrc/entropy.cc
(byte for byte the JAX package's jpeg_tpu/native/entropy.cc, so that the
port builds where that package is absent), on first use with g++ -O3 into
jpeg_tpu_torch/build/. A missing compiler or a failed build raises, in the
encoder and in the decoder alike:
the NumPy walkers (entropy/decode_np, entropy/progressive_np) are for
entropy="numpy" and for scan layouts the native runtime does not take, never
a silent stand-in for a runtime that did not build.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import pathlib
import subprocess
import threading

import numpy as np

from jpeg_tpu_torch.entropy.huffman import HuffTable

_PKG = pathlib.Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "entropy.cc"
_BUILD_DIR = _PKG / "build"
_LIB_PATH = _BUILD_DIR / "libjtentropy.so"

_lock = threading.Lock()
_lib = None


def _build() -> None:
    """Compile entropy.cc unless the library is newer than the source. A file
    lock serializes concurrent builders (test workers); the library appears
    under its final name only once complete."""
    if not _SRC.exists():
        raise RuntimeError(f"native entropy source missing: {_SRC}")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(_BUILD_DIR / "entropy.lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if (_LIB_PATH.exists()
                and _LIB_PATH.stat().st_mtime >= _SRC.stat().st_mtime):
            return
        tmp = _LIB_PATH.with_suffix(f".{os.getpid()}.tmp")
        cmd = [
            "g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
            str(_SRC), "-o", str(tmp),
        ]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True,
                           timeout=300)
        except FileNotFoundError as e:
            raise RuntimeError("g++ not found: the native entropy runtime "
                               "cannot be built") from e
        except subprocess.CalledProcessError as e:
            raise RuntimeError(f"native entropy build failed:\n{e.stderr}") from e
        os.replace(tmp, _LIB_PATH)


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        _build()
        lib = ctypes.CDLL(str(_LIB_PATH))
        lib.jt_encode_scan.restype = ctypes.c_long
        lib.jt_decode_scan.restype = ctypes.c_long
        lib.jt_index_scan.restype = ctypes.c_long
        lib.jt_sparse_scan.restype = ctypes.c_long
        lib.jt_progressive_scan.restype = ctypes.c_long
        lib.jt_count_symbols.restype = None
        lib.jt_finalize_scan.restype = ctypes.c_long
        lib.jt_pack_payload.restype = ctypes.c_long
        lib.jt_version.restype = ctypes.c_int
        if lib.jt_version() != 9:
            raise RuntimeError(
                f"native entropy runtime version {lib.jt_version()}, need 9")
        _lib = lib
        return _lib


def available() -> bool:
    """True once the runtime is built and loaded. A runtime that cannot be
    built raises here, as at every other first use: it is never reported as
    merely unavailable."""
    return _load() is not None


def _code_arrays(huff: dict, is_ac: int):
    """Stack (2, 256) code/length arrays for table ids 0/1 of one class."""
    code = np.zeros((2, 256), dtype=np.uint32)
    size = np.zeros((2, 256), dtype=np.uint8)
    for tid in (0, 1):
        t: HuffTable | None = huff.get((is_ac, tid))
        if t is not None:
            code[tid] = t.code.astype(np.uint32)
            size[tid] = t.size.astype(np.uint8)
    return code, size


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def encode_scan(
    blocks: np.ndarray,
    tbl: np.ndarray,
    huff: dict,
    restart_interval: int = 0,
    blocks_per_mcu: int = 1,
    nthreads: int = 0,
    rst_base: int = 0,
) -> bytes:
    """Native twin of encode_np.encode_scan (same contract). rst_base offsets
    the modulo-8 RSTn indices for streaming multi-call scans."""
    lib = _load()
    assert lib is not None
    blocks = np.ascontiguousarray(blocks, dtype=np.int32)
    tbl8 = np.ascontiguousarray(tbl, dtype=np.uint8)
    nblocks = blocks.shape[0]
    dc_code, dc_len = _code_arrays(huff, 0)
    ac_code, ac_len = _code_arrays(huff, 1)
    restart_blocks = int(restart_interval) * int(blocks_per_mcu)
    nseg = 1 if restart_blocks <= 0 else max(1, -(-nblocks // restart_blocks))
    cap = nblocks * 420 + nseg * 2 + 64
    out = np.empty(cap, dtype=np.uint8)
    n = lib.jt_encode_scan(
        _ptr(blocks, ctypes.c_int32), _ptr(tbl8, ctypes.c_uint8),
        ctypes.c_long(nblocks),
        _ptr(dc_code, ctypes.c_uint32), _ptr(dc_len, ctypes.c_uint8),
        _ptr(ac_code, ctypes.c_uint32), _ptr(ac_len, ctypes.c_uint8),
        ctypes.c_long(restart_blocks), ctypes.c_long(rst_base),
        _ptr(out, ctypes.c_uint8), ctypes.c_long(cap), ctypes.c_int(nthreads),
    )
    if n < 0:
        raise RuntimeError(f"native encode_scan failed ({n})")
    return out[:n].tobytes()


def finalize_scan(words: np.ndarray, totals: np.ndarray,
                  rst_base: int = 0) -> bytes:
    """C-speed finalize of device-packed word segments: trim/1-pad/stuff each
    (row, total_bits) pair and join with RSTn markers. words (nseg, W)
    uint32; totals (nseg,) bit counts. Byte-identical to
    ops/bitpack.finalize_segment + marker join."""
    lib = _load()
    assert lib is not None
    words = np.ascontiguousarray(words, dtype=np.uint32)
    if words.ndim == 1:
        words = words[None]
    totals = np.ascontiguousarray(totals, dtype=np.int64)
    nseg = int(totals.shape[0])
    # Worst case: every byte stuffed (x2) — rounded up PER SEGMENT (the sum
    # of ceils exceeds ceil of the sum by up to nseg-1 bytes) — plus one RST
    # marker between segments.
    cap = int(2 * int(((totals + 7) // 8).sum()) + 2 * nseg + 16)
    out = np.empty(cap, dtype=np.uint8)
    n = lib.jt_finalize_scan(
        _ptr(words, ctypes.c_uint32), ctypes.c_long(words.shape[1]),
        _ptr(totals, ctypes.c_int64), ctypes.c_long(nseg),
        ctypes.c_long(rst_base), _ptr(out, ctypes.c_uint8),
        ctypes.c_long(cap),
    )
    if n < 0:
        raise RuntimeError(f"native finalize_scan failed ({n})")
    return out[:n].tobytes()


def pack_payload(vals, ks, counts, dc, Sp: int, Ep: int,
                 Edp: int) -> np.ndarray:
    """C-speed twin of decode_device.build_payload (byte-exact v2 layout)."""
    lib = _load()
    assert lib is not None
    vals = np.ascontiguousarray(vals, dtype=np.int16)
    ks = np.ascontiguousarray(ks, dtype=np.uint8)
    counts = np.ascontiguousarray(counts, dtype=np.uint8)
    dc = np.ascontiguousarray(dc, dtype=np.int32)
    B, S = counts.shape[0], vals.shape[0]
    B16 = -(-B // 16) * 16
    cap = ((B16 // 16) * 3 + (Sp // 16) * 3 + Sp // 8 + (B + 3) // 4
           + Ep + Ep // 2 + Edp + Edp // 2)
    out = np.empty(cap, dtype=np.uint32)
    n = lib.jt_pack_payload(
        _ptr(vals, ctypes.c_int16), _ptr(ks, ctypes.c_uint8),
        _ptr(counts, ctypes.c_uint8), _ptr(dc, ctypes.c_int32),
        ctypes.c_long(B), ctypes.c_long(S), ctypes.c_long(Sp),
        ctypes.c_long(Ep), ctypes.c_long(Edp),
        _ptr(out, ctypes.c_uint32), ctypes.c_long(cap),
    )
    if n < 0:
        raise ValueError(f"native pack_payload failed ({n})")
    return out[:n]


def count_frequencies(blocks: np.ndarray, tbl: np.ndarray) -> dict:
    """Native twin of encode_np.count_frequencies (no record stream needed)."""
    lib = _load()
    assert lib is not None
    blocks = np.ascontiguousarray(blocks, dtype=np.int32)
    tbl8 = np.ascontiguousarray(tbl, dtype=np.uint8)
    hists = np.zeros((4, 256), dtype=np.int64)
    lib.jt_count_symbols(
        _ptr(blocks, ctypes.c_int32), _ptr(tbl8, ctypes.c_uint8),
        ctypes.c_long(blocks.shape[0]), _ptr(hists, ctypes.c_int64),
    )
    return {
        (0, 0): hists[0], (1, 0): hists[1],
        (0, 1): hists[2], (1, 1): hists[3],
    }


def _scan_layout(mcu_layout: list, huff: dict):
    """Shared layout/table marshalling for jt_decode_scan / jt_index_scan."""
    comp_bpm = np.array([bpm for (_, bpm, _, _) in mcu_layout], dtype=np.int32)
    blk_comp, blk_occ, blk_tbl = [], [], []
    # Table id per component: JPEG allows distinct DC/AC ids, but our LUT set
    # is indexed 0/1 jointly; mcu_layout carries (dc_id, ac_id) which are equal
    # in all streams we emit. Assert and use dc_id.
    for ci, (_, bpm, dc_id, ac_id) in enumerate(mcu_layout):
        for k in range(bpm):
            blk_comp.append(ci)
            blk_occ.append(k)
            blk_tbl.append(dc_id)
    blk_comp = np.array(blk_comp, dtype=np.uint8)
    blk_occ = np.array(blk_occ, dtype=np.uint8)
    blk_tbl = np.array(blk_tbl, dtype=np.uint8)

    dc_code = np.zeros((2, 256), dtype=np.uint32)
    dc_len = np.zeros((2, 256), dtype=np.uint8)
    ac_code = np.zeros((2, 256), dtype=np.uint32)
    ac_len = np.zeros((2, 256), dtype=np.uint8)
    for (_, bpm, dc_id, ac_id) in mcu_layout:
        t = huff[(0, dc_id)]
        dc_code[dc_id], dc_len[dc_id] = t.code.astype(np.uint32), t.size.astype(np.uint8)
        t = huff[(1, ac_id)]
        ac_code[ac_id], ac_len[ac_id] = t.code.astype(np.uint32), t.size.astype(np.uint8)
    return (comp_bpm, blk_comp, blk_occ, blk_tbl,
            dc_code, dc_len, ac_code, ac_len)


def decode_scan(
    scan: bytes,
    mcu_count: int,
    mcu_layout: list,
    huff: dict,
    restart_interval: int,
    nthreads: int = 0,
) -> list[np.ndarray]:
    """Native twin of decode_np.decode_scan (same contract, huff tables not LUTs)."""
    lib = _load()
    assert lib is not None
    ncomp = len(mcu_layout)
    (comp_bpm, blk_comp, blk_occ, blk_tbl,
     dc_code, dc_len, ac_code, ac_len) = _scan_layout(mcu_layout, huff)
    bpm_total = int(comp_bpm.sum())

    data = np.frombuffer(scan, dtype=np.uint8)
    total_blocks = mcu_count * bpm_total
    out = np.zeros((total_blocks, 64), dtype=np.int32)
    err = lib.jt_decode_scan(
        _ptr(data, ctypes.c_uint8), ctypes.c_long(len(data)),
        ctypes.c_long(mcu_count), ctypes.c_int(bpm_total),
        _ptr(blk_comp, ctypes.c_uint8), _ptr(blk_occ, ctypes.c_uint8),
        _ptr(blk_tbl, ctypes.c_uint8),
        _ptr(dc_code, ctypes.c_uint32), _ptr(dc_len, ctypes.c_uint8),
        _ptr(ac_code, ctypes.c_uint32), _ptr(ac_len, ctypes.c_uint8),
        ctypes.c_long(restart_interval), ctypes.c_int(ncomp),
        _ptr(comp_bpm, ctypes.c_int32),
        _ptr(out, ctypes.c_int32), ctypes.c_int(nthreads),
    )
    if err != 0:
        raise ValueError(f"native decode_scan failed ({err})")
    res = []
    base = 0
    for (_, bpm, _, _) in mcu_layout:
        res.append(out[base : base + bpm * mcu_count])
        base += bpm * mcu_count
    return res


def progressive_scan(
    data: bytes,
    kind: int,
    ss: int,
    se: int,
    al: int,
    n_units: int,
    restart_interval: int,
    mcu_cols: int,
    comp_geom: list,
    grids: list,
    tables: list,
    nthreads: int = 0,
) -> None:
    """Decode one progressive (SOF2) scan in place — native twin of the
    per-scan loops in entropy/progressive_np.py.

    kind: 0 DC first, 1 DC refine, 2 AC first, 3 AC refine.
    comp_geom: per scan component (v, h, gw, bw) — sampling factors, grid row
    stride in blocks, and own block-raster width.
    grids: per scan component contiguous int32 ndarray (gh, gw, 64), mutated.
    tables: per scan component HuffTable (DC tables for kind 0, the single AC
    table for kinds 2/3; empty/ignored for kind 1).
    """
    lib = _load()
    assert lib is not None
    ncomp = len(comp_geom)
    comp_v = np.array([g[0] for g in comp_geom], dtype=np.int32)
    comp_h = np.array([g[1] for g in comp_geom], dtype=np.int32)
    comp_gw = np.array([g[2] for g in comp_geom], dtype=np.int32)
    comp_bw = np.array([g[3] for g in comp_geom], dtype=np.int32)
    codes = np.zeros((max(ncomp, 1), 256), dtype=np.uint32)
    lens = np.zeros((max(ncomp, 1), 256), dtype=np.uint8)
    for i, t in enumerate(tables):
        if t is not None:
            codes[i] = t.code.astype(np.uint32)
            lens[i] = t.size.astype(np.uint8)
    ptrs = (ctypes.POINTER(ctypes.c_int32) * ncomp)()
    for i, g in enumerate(grids):
        assert g.dtype == np.int32 and g.flags["C_CONTIGUOUS"]
        ptrs[i] = g.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    buf = np.frombuffer(data, dtype=np.uint8) if data else np.zeros(
        1, dtype=np.uint8
    )
    err = lib.jt_progressive_scan(
        _ptr(buf, ctypes.c_uint8), ctypes.c_long(len(data)),
        ctypes.c_int(kind), ctypes.c_int(ss), ctypes.c_int(se),
        ctypes.c_int(al),
        ctypes.c_long(n_units), ctypes.c_long(restart_interval),
        ctypes.c_long(mcu_cols), ctypes.c_int(ncomp),
        _ptr(comp_v, ctypes.c_int32), _ptr(comp_h, ctypes.c_int32),
        _ptr(comp_gw, ctypes.c_int32), _ptr(comp_bw, ctypes.c_int32),
        ptrs,
        _ptr(codes, ctypes.c_uint32), _ptr(lens, ctypes.c_uint8),
        ctypes.c_int(nthreads),
    )
    if err != 0:
        from jpeg_tpu_torch.entropy.decode_np import ScanDecodeError

        raise ScanDecodeError(f"native progressive scan failed ({err})")


def index_scan(
    scan: bytes,
    mcu_count: int,
    mcu_layout: list,
    huff: dict,
    restart_interval: int,
    nthreads: int = 0,
):
    """Light host pass for the hybrid device decoder: destuff the scan and
    record, per block (component-contiguous scan order, same indexing as
    decode_scan's output), the bit offset of its first AC code in the
    destuffed stream and its absolute DC coefficient.

    Returns (destuffed bytes ndarray, ac_off (B,) int32, dc (B,) int32).
    """
    lib = _load()
    assert lib is not None
    ncomp = len(mcu_layout)
    (comp_bpm, blk_comp, blk_occ, blk_tbl,
     dc_code, dc_len, ac_code, ac_len) = _scan_layout(mcu_layout, huff)
    bpm_total = int(comp_bpm.sum())

    data = np.frombuffer(scan, dtype=np.uint8)
    total_blocks = mcu_count * bpm_total
    # +512 zero guard bytes: the native fast cursor reads 8 bytes at a time
    # and may run ~256 bytes past a corrupt segment's end before the
    # per-block overrun check fires.
    destuffed = np.zeros(max(len(data), 1) + 512, dtype=np.uint8)
    ac_off = np.empty(total_blocks, dtype=np.int32)
    dc = np.empty(total_blocks, dtype=np.int32)
    n = lib.jt_index_scan(
        _ptr(data, ctypes.c_uint8), ctypes.c_long(len(data)),
        ctypes.c_long(mcu_count), ctypes.c_int(bpm_total),
        _ptr(blk_comp, ctypes.c_uint8), _ptr(blk_occ, ctypes.c_uint8),
        _ptr(blk_tbl, ctypes.c_uint8),
        _ptr(dc_code, ctypes.c_uint32), _ptr(dc_len, ctypes.c_uint8),
        _ptr(ac_code, ctypes.c_uint32), _ptr(ac_len, ctypes.c_uint8),
        ctypes.c_long(restart_interval), ctypes.c_int(ncomp),
        _ptr(comp_bpm, ctypes.c_int32),
        _ptr(destuffed, ctypes.c_uint8), _ptr(ac_off, ctypes.c_int32),
        _ptr(dc, ctypes.c_int32), ctypes.c_int(nthreads),
    )
    if n < 0:
        from jpeg_tpu_torch.entropy.decode_np import ScanDecodeError

        raise ScanDecodeError(f"native index_scan failed ({n})")
    return destuffed[:n], ac_off, dc


def sparse_scan(
    scan: bytes,
    mcu_count: int,
    mcu_layout: list,
    huff: dict,
    restart_interval: int,
    nthreads: int = 0,
):
    """Fully resolve the entropy layer on the host, sparsely: one walk over the
    scan returning, per block (component-contiguous scan order), the absolute
    DC coefficient plus the nonzero AC coefficients as (value, zig-zag
    position) pairs — the payload the sparse device decode backend uploads
    instead of dense coefficients.

    Returns (vals (S,) int16, ks (S,) uint8, counts (B,) uint8, dc (B,) int32)
    where S = total nonzero AC count and counts[b] is block b's share of
    vals/ks (block-major, zig-zag order within a block).
    """
    lib = _load()
    assert lib is not None
    ncomp = len(mcu_layout)
    (comp_bpm, blk_comp, blk_occ, blk_tbl,
     dc_code, dc_len, ac_code, ac_len) = _scan_layout(mcu_layout, huff)
    bpm_total = int(comp_bpm.sum())

    data = np.frombuffer(scan, dtype=np.uint8)
    total_blocks = mcu_count * bpm_total
    vals = np.empty(total_blocks * 63, dtype=np.int16)
    ks = np.empty(total_blocks * 63, dtype=np.uint8)
    counts = np.zeros(total_blocks, dtype=np.uint8)
    dc = np.zeros(total_blocks, dtype=np.int32)
    n = lib.jt_sparse_scan(
        _ptr(data, ctypes.c_uint8), ctypes.c_long(len(data)),
        ctypes.c_long(mcu_count), ctypes.c_int(bpm_total),
        _ptr(blk_comp, ctypes.c_uint8), _ptr(blk_occ, ctypes.c_uint8),
        _ptr(blk_tbl, ctypes.c_uint8),
        _ptr(dc_code, ctypes.c_uint32), _ptr(dc_len, ctypes.c_uint8),
        _ptr(ac_code, ctypes.c_uint32), _ptr(ac_len, ctypes.c_uint8),
        ctypes.c_long(restart_interval), ctypes.c_int(ncomp),
        _ptr(comp_bpm, ctypes.c_int32),
        _ptr(vals, ctypes.c_int16), _ptr(ks, ctypes.c_uint8),
        _ptr(counts, ctypes.c_uint8), _ptr(dc, ctypes.c_int32),
        ctypes.c_int(nthreads),
    )
    if n < 0:
        from jpeg_tpu_torch.entropy.decode_np import ScanDecodeError

        raise ScanDecodeError(f"native sparse_scan failed ({n})")
    return vals[:n], ks[:n], counts, dc
