"""The device Huffman decoders' kernels: wrappers, plain twins, counters.

Three programs of jpeg_tpu/entropy/decode_device.py (jitted XLA there, not
Pallas) as hand-written CUDA kernels:
  - kernel D, csrc/ac_indexed.cu, for `_decode_ac_indexed` (:179): the AC
    coefficients of every block from its known start (decode_ac_indexed);
  - one chunked, self-synchronizing block-start program,
    csrc/prefix_index.cu (five launches), in two modes: unanchored, program
    F, for `_jit_prefix_index` (:866): every block's start in a scan without
    restart markers (prefix_index); anchored, E's route, for `_decode_block`
    under `_jit_segments` (:71, :117): the block starts of every restart
    segment from its first byte.
A scan's whole decode on a card is one C call (csrc/scan_decode.cu,
scan_decode): the words' upload, the block-start program in either mode,
one DC-sum launch (the absolute DCs, and without markers kernel D's offsets
in component-major order) and kernel D, enqueued without the GIL;
decode_segments is that chain on words already on the card.
On a CUDA tensor a wrapper launches its kernel, on a CPU tensor it runs the
plain twin, and nothing else decides. The twins are second formulations: D's
steps all blocks together in torch ops until the slowest is done, E's is a
NumPy/Python walk like entropy/decode_np's, F's is the reference's table
program (one symbol per bit position, pointer doubling) in torch indexing,
the DC sums' the torch sums the launch replaced (dc_sums_reference).
All results are integers and a kernel equals its twin exactly.

Bit streams are big-endian 32-bit words carried as int32 (torch has no uint32
arithmetic); tables are build_tables' rows, which csrc/huff_decode.cuh
describes.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from jpeg_tpu_torch.entropy import decode_np
from jpeg_tpu_torch.ops import _cuda

# Launches since the last reset (plus one per wrapper call that launches its
# kernel, nowhere else). The block-start program counts once per
# prefix_index call or scan without markers (PREFIX_LAUNCHES) or anchored
# scan (SEGMENT_LAUNCHES, which launches kernel D too); its five launches add
# up in PREFIX_STAGE_LAUNCHES either way. NATIVE_SCANS counts the scans
# whose whole chain one scan_decode call enqueued, DC_SUM_LAUNCHES the DC
# sums' launches. RESTART_SEGMENTS sums the restart segments that
# decode_segments walked, on either device. SYNC_PASSES (a module attribute
# read through __getattr__ below) is the resolve rounds of the last call.
AC_LAUNCHES = 0
SEGMENT_LAUNCHES = 0
RESTART_SEGMENTS = 0
PREFIX_LAUNCHES = 0
PREFIX_STAGE_LAUNCHES = 0
NATIVE_SCANS = 0
DC_SUM_LAUNCHES = 0
_last_passes = None
# Worker threads launch too (parallel/pipeline), so the increments hold a lock.
_COUNT_LOCK = threading.Lock()

FULL_SIZE = 1 << 16
FIRST_BITS = 9
FIRST_SIZE = 1 << FIRST_BITS
SLOT_STRIDE = FULL_SIZE + FIRST_SIZE
MAX_SLOTS = 8
SEQ_FIELDS = 5  # anchored: comp, dc slot, ac slot, row base, rows per MCU
MAX_BPM = 10  # blocks per MCU at most (T.81 B.2.3)
MAX_COMPS = 4  # components of a scan at most
# Bit offsets are int32: a stream of 2^26 words or more is refused.
MAX_WORDS = (1 << 26) - 1
_M32 = 0xFFFFFFFF


def build_tables(htables: dict, slots) -> np.ndarray:
    """(len(slots), SLOT_STRIDE) int32 decode tables for the (is_ac, id) keys
    in `slots`: per 16-bit window (length << 16) | (symbol & 0xFFFF), windows
    that start no code as length 16 / symbol -1; then the first level by the
    top FIRST_BITS bits (0 where the code is longer)."""
    out = np.empty((len(slots), SLOT_STRIDE), dtype=np.int32)
    for i, key in enumerate(slots):
        s, l = decode_np.make_decode_lut(htables[key])
        assigned = s >= 0
        sym = np.where(assigned, s, -1).astype(np.int32)
        ln = np.where(assigned, l, 16).astype(np.int32)
        full = (ln << 16) | (sym & 0xFFFF)
        step = 1 << (16 - FIRST_BITS)
        out[i, :FULL_SIZE] = full
        out[i, FULL_SIZE:] = np.where(ln[::step] <= FIRST_BITS, full[::step], 0)
    return out


def words_from_bytes(buf: np.ndarray) -> np.ndarray:
    """uint8 (..., 4n) -> int32 (..., n): big-endian words' bit patterns."""
    return np.ascontiguousarray(buf).view(">u4").astype(np.uint32).view(np.int32)


def _sym_len(entries: torch.Tensor):
    """Table entries (int64) -> (symbol with -1 for none, code length)."""
    return ((entries & 0xFFFF) ^ 0x8000) - 0x8000, entries >> 16


def _extend(amp: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """T.81 F.2.2.1 EXTEND as arithmetic; size 0 gives 0."""
    one = torch.ones_like(size)
    half = one << (size.clamp(min=1) - 1)
    return torch.where(size == 0, 0, torch.where(amp < half,
                                                 amp - (one << size) + 1, amp))


def _check(name: str, dev, **tensors) -> None:
    for key, t in tensors.items():
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != dev:
            raise ValueError(
                f"{name}: {key} must be a contiguous int32 tensor on {dev}, "
                f"got {t.dtype} on {t.device}")


def _check_tables(name: str, tables: torch.Tensor) -> None:
    if tables.ndim != 2 or tables.shape[1] != SLOT_STRIDE or not (
            1 <= tables.shape[0] <= MAX_SLOTS):
        raise ValueError(
            f"{name}: tables must be (1..{MAX_SLOTS}, {SLOT_STRIDE}), got "
            f"{tuple(tables.shape)}")


def _check_words(name: str, nwords: int) -> None:
    if not 1 <= nwords <= MAX_WORDS:
        raise ValueError(
            f"{name}: {nwords} words; int32 bit offsets take 1 to {MAX_WORDS}")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _call(name: str, fn, dev, *args) -> None:
    """One C entry on PyTorch's current stream of `dev`. A CPU device takes
    the host build of the kernels' bodies that the tests pass as `lib`."""
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            err = fn(*args, _cuda.stream_handle(dev))
    else:
        err = fn(*args, None)
    _cuda.check(name, err)


# ---------------------------------------------------------------------------
# Kernel D: AC decode at known block starts.
# ---------------------------------------------------------------------------


def decode_ac_indexed_reference(words, off, dc, slot, tables) -> torch.Tensor:
    """Plain twin of decode_ac_indexed (any device): all blocks step one
    symbol at a time together until every one has ended."""
    dev = words.device
    w = words.to(torch.int64) & _M32
    nw = w.shape[0]
    full = tables[:, :FULL_SIZE].to(torch.int64)
    nblocks = off.shape[0]
    rows = torch.zeros((nblocks, 64), dtype=torch.int32, device=dev)
    rows[:, 0] = dc
    if nblocks == 0:
        return rows
    sl = slot.to(torch.int64).clamp(0, tables.shape[0] - 1)
    pos = off.to(torch.int64)
    k = torch.ones_like(pos)
    blk = torch.arange(nblocks, device=dev)
    active = k < 64
    while bool(active.any()):
        wi = pos >> 5
        w0 = torch.where((wi >= 0) & (wi < nw), w[wi.clamp(0, nw - 1)], 0)
        w1 = torch.where((wi >= -1) & (wi + 1 < nw),
                         w[(wi + 1).clamp(0, nw - 1)], 0)
        sh = pos & 31
        win = ((w0 << sh) & _M32) | (w1 >> (32 - sh))
        sym, ln = _sym_len(full[sl, win >> 16])
        sym = sym.clamp(min=0)  # a window that starts no code ends the block
        run, size = sym >> 4, sym & 15
        amp = (win >> (32 - ln - size)) & ((torch.ones_like(size) << size) - 1)
        eob, zrl = sym == 0, sym == 0xF0
        kw = k + run
        emit = active & ~eob & ~zrl & (kw <= 63)
        rows[blk[emit], kw[emit]] = _extend(amp, size)[emit].to(torch.int32)
        pos = torch.where(active & ~eob, pos + ln + size, pos)
        k = torch.where(active, torch.where(
            eob, 64, torch.where(zrl, k + 16, kw + 1)), k)
        active = k < 64
    return rows


def _launch_ac_indexed(words, off, dc, slot, tables, rows, lib=None) -> None:
    """Enqueue kernel D on PyTorch's current stream: prepared contiguous
    int32 tensors, no checks and no allocation. Counts the launch."""
    global AC_LAUNCHES
    lib = lib or _cuda.load("ac_indexed")
    _call("ac_indexed", lib.jt_ac_indexed, words.device, _ptr(words),
          ctypes.c_int(words.numel()), _ptr(off), _ptr(dc), _ptr(slot),
          _ptr(tables), ctypes.c_int(tables.shape[0]), _ptr(rows),
          ctypes.c_long(off.shape[0]))
    with _COUNT_LOCK:
        AC_LAUNCHES += 1


def decode_ac_indexed(words, off, dc, slot, tables) -> torch.Tensor:
    """The destuffed scan as (W,) big-endian words, per block (any order) the
    bit offset `off` just past its DC code, its absolute `dc` and its AC
    table's row `slot` in `tables` (build_tables), all int32 tensors on one
    device -> (B, 64) int32 zig-zag rows with row[0] = dc.

    Each block walks its (run, size) symbols from k = 1 until EOB, k >= 64 or
    a window that starts no code. CUDA tensors launch kernel D
    (csrc/ac_indexed.cu); CPU tensors run the plain twin."""
    dev = words.device
    if dev.type == "cpu":
        return decode_ac_indexed_reference(words, off, dc, slot, tables)
    if dev.type != "cuda":
        raise ValueError(f"decode_ac_indexed: unsupported device {dev}")
    _check("decode_ac_indexed", dev, words=words, off=off, dc=dc, slot=slot,
           tables=tables)
    _check_tables("decode_ac_indexed", tables)
    nblocks = off.shape[0]
    if words.ndim != 1 or off.ndim != 1 or dc.shape != off.shape or (
            slot.shape != off.shape):
        raise ValueError(
            f"decode_ac_indexed: words {tuple(words.shape)}, off "
            f"{tuple(off.shape)}, dc {tuple(dc.shape)}, slot "
            f"{tuple(slot.shape)}")
    _check_words("decode_ac_indexed", words.numel())
    rows = torch.empty((nblocks, 64), dtype=torch.int32, device=dev)
    if nblocks:
        _launch_ac_indexed(words, off, dc, slot, tables, rows)
    return rows


# ---------------------------------------------------------------------------
# Kernel E: one sequential walk per restart segment.
# ---------------------------------------------------------------------------


def decode_segments_reference(words, seg_off, interval: int, mcu_count: int,
                              seq, tables, nblocks: int):
    """Plain twin of decode_segments: a Python walk over each segment's
    bits, on the host whatever the tensors' device."""
    dev = words.device
    data = words.cpu().numpy().view(np.uint32).astype(">u4").tobytes()
    data += bytes(8)
    starts = (seg_off.cpu().numpy().astype(np.int64) * 8).tolist()
    nseg, nwords = len(starts), words.numel()
    full = tables[:, :FULL_SIZE].cpu().numpy()
    syms = (full & 0xFFFF).astype(np.uint16).view(np.int16).astype(np.int32)
    lens = full >> 16
    layout = seq.cpu().numpy().tolist()
    rows = np.zeros((nblocks, 64), dtype=np.int32)
    status = np.zeros((2, nseg), dtype=np.int32)
    limit, nbytes = nwords * 32, nwords * 4

    def extend(amp, size):
        if size == 0:
            return 0
        return amp - (1 << size) + 1 if amp < (1 << (size - 1)) else amp

    def window(pos):
        i = pos >> 3
        if i >= nbytes:
            return 0
        v = int.from_bytes(data[i:i + 5], "big")
        return (v >> (8 - (pos & 7))) & _M32

    for s in range(nseg):
        first_mcu = s * interval
        pos, err = min(starts[s], limit), 0
        preds = [0] * 4
        for m in range(max(0, min(interval, mcu_count - first_mcu))):
            for comp, dc_slot, ac_slot, base, per_mcu in layout:
                row = rows[base + (first_mcu + m) * per_mcu]
                win = window(pos)
                sym = int(syms[dc_slot, win >> 16])
                ln = int(lens[dc_slot, win >> 16])
                if sym < 0:
                    err = 1
                size = min(max(sym, 0), 15)
                amp = (win << ln & _M32) >> (32 - size) if size else 0
                preds[comp & 3] += extend(amp, size)
                pos = min(pos + ln + size, limit)
                row[0] = preds[comp & 3]
                k = 1
                while k < 64:
                    win = window(pos)
                    sym = int(syms[ac_slot, win >> 16])
                    ln = int(lens[ac_slot, win >> 16])
                    if sym < 0:
                        err, sym = 1, 0
                    size = sym & 15
                    pos = min(pos + ln + size, limit)
                    if sym == 0:
                        break
                    if sym == 0xF0:
                        k += 16
                        continue
                    k += sym >> 4
                    if k > 63:
                        err = 1
                    else:
                        amp = (win << ln & _M32) >> (32 - size) if size else 0
                        row[k] = extend(amp, size)
                    k += 1
        status[:, s] = (pos - starts[s], err)
    return (torch.as_tensor(rows, device=dev),
            torch.as_tensor(status, device=dev))


def decode_segments(words, seg_off, interval: int, mcu_count: int, seq,
                    tables, nblocks: int):
    """words: (W,) int32, the unstuffed restart segments one after another
    as big-endian words, with a zero guard behind; seg_off: (S,) int32, each
    segment's first byte in that stream. Segment s holds MCUs
    [s * interval, min((s + 1) * interval, mcu_count)). seq: (blocks per
    MCU, SEQ_FIELDS) int32, per block of the MCU its component, its DC and
    AC rows in `tables`, and where its rows go: row base + MCU index * rows
    per MCU, the components' rows one after another (decode_scan's layout).
    -> (rows (nblocks, 64) int32 with the DC predictors undone per
    component from 0 at every segment start, status (2, S) int32: each
    segment's length in bits as walked, then its error flag). The rows of a
    flagged segment are unspecified (decoders raise on any flag).

    CUDA tensors run scan_decode's chain on them (the anchored mode of the
    chunked block-start program, the DC sums and kernel D; no upload); CPU
    tensors run the plain twin. Either adds S to RESTART_SEGMENTS."""
    global RESTART_SEGMENTS
    dev = words.device
    if dev.type == "cpu":
        with _COUNT_LOCK:
            RESTART_SEGMENTS += seg_off.numel()
        return decode_segments_reference(words, seg_off, interval, mcu_count,
                                         seq, tables, nblocks)
    if dev.type != "cuda":
        raise ValueError(f"decode_segments: unsupported device {dev}")
    _check("decode_segments", dev, words=words, seg_off=seg_off, seq=seq,
           tables=tables)
    _check_tables("decode_segments", tables)
    if words.ndim != 1 or seg_off.ndim != 1 or seq.ndim != 2 or (
            seq.shape[1] != SEQ_FIELDS) or nblocks != mcu_count * seq.shape[0]:
        raise ValueError(
            f"decode_segments: words {tuple(words.shape)}, seg_off "
            f"{tuple(seg_off.shape)}, seq {tuple(seq.shape)}, {nblocks} "
            f"blocks of {mcu_count} MCUs")
    nseg = seg_off.shape[0]
    if interval < 1 or nseg < 1 or (nseg - 1) * interval >= max(mcu_count, 1):
        raise ValueError(
            f"decode_segments: {nseg} segments of {interval} MCUs for "
            f"{mcu_count} MCUs")
    _check_words("decode_segments", words.numel())
    return scan_decode(dev, True, words.numel(), nseg, interval, mcu_count,
                       seq, tables, (), words=words, seg_off=seg_off)


# ---------------------------------------------------------------------------
# A scan's chain in one C call, and the DC sums.
# ---------------------------------------------------------------------------


class _ScanArgs(ctypes.Structure):
    """csrc/scan_decode.cu's ScanArgs, field for field."""
    _fields_ = [
        ("anchored", ctypes.c_int), ("nwords", ctypes.c_int),
        ("nseg", ctypes.c_int), ("bpm", ctypes.c_int),
        ("interval", ctypes.c_long), ("n_mcu", ctypes.c_long),
        ("ncomp", ctypes.c_int), ("comp_bpm", ctypes.c_int * MAX_COMPS),
        ("nslots", ctypes.c_int), ("seq", ctypes.c_void_p),
        ("tables", ctypes.c_void_p), ("host", ctypes.c_void_p),
        ("host_seg", ctypes.c_long), ("host_cap", ctypes.c_long),
        ("words", ctypes.c_void_p), ("seg_off", ctypes.c_void_p),
        ("event", ctypes.c_void_p), ("workspace", ctypes.c_void_p),
        ("rows", ctypes.c_void_p),
    ]


class _DcArgs(ctypes.Structure):
    """csrc/scan_decode.cu's DcArgs, field for field."""
    _fields_ = [
        ("anchored", ctypes.c_int), ("nblocks", ctypes.c_long),
        ("n_mcu", ctypes.c_long), ("bpm", ctypes.c_int),
        ("ncomp", ctypes.c_int), ("comp_bpm", ctypes.c_int * MAX_COMPS),
        ("diff", ctypes.c_void_p), ("group", ctypes.c_void_p),
        ("ac_off", ctypes.c_void_p), ("seq", ctypes.c_void_p),
        ("dc", ctypes.c_void_p), ("off", ctypes.c_void_p),
        ("slot", ctypes.c_void_p), ("ctl", ctypes.c_void_p),
    ]


def scan_decode(dev, anchored: bool, nwords: int, nseg: int, interval: int,
                n_mcu: int, seq, tables, comp_bpm, *, words=None, seg_off=None,
                host=None, host_seg: int = 0, event=None, lib=None):
    """Enqueue a scan's whole device Huffman decode on PyTorch's current
    stream of `dev` with one C call that holds no GIL (csrc/scan_decode.cu):
    the words' upload, the block-start program (anchored at each of `nseg`
    segments of `interval` MCUs, or from bit 0), the DC sums and kernel D.

    The scan is `host`, a CPU int32 tensor (pinned, on a card) with its
    `nwords` words at 0, the segments' first bytes at word `host_seg` and
    room behind them for the DC sums' control words, which the call zeroes
    and uploads with them; `event` (a recorded torch.cuda.Event) is recorded
    again behind the upload. Or `words` and `seg_off` on `dev` (no upload).
    seq: the program's (bpm, SEQ_FIELDS) rows when anchored, program F's
    (bpm, 3) from bit 0; comp_bpm: from bit 0, the scan's components' blocks
    per MCU in order (anchored, the program's groups give the DC sums'
    resets). One workspace holds everything else. `lib` is the build (the
    CUDA one unless a host build is given, with CPU tensors).

    -> (rows (n_mcu * bpm, 64) int32, status): anchored (2, nseg), each
    segment's bits as walked and its flag; from bit 0 (2,), the end position
    and the flag. Nothing is read back. Counts the scan, its launches and
    segments."""
    global NATIVE_SCANS, SEGMENT_LAUNCHES, PREFIX_LAUNCHES, RESTART_SEGMENTS
    global PREFIX_STAGE_LAUNCHES, DC_SUM_LAUNCHES, AC_LAUNCHES
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    _check("scan_decode", dev, seq=seq, tables=tables,
           **({} if words is None else {"words": words}),
           **({} if seg_off is None else {"seg_off": seg_off}))
    _check_tables("scan_decode", tables)
    if host is not None and (host.dtype != torch.int32 or host.device.type
                             != "cpu" or not host.is_contiguous()):
        raise ValueError(
            f"scan_decode: host must be a contiguous int32 CPU tensor, got "
            f"{host.dtype} on {host.device}")
    if (host is None) == (words is None) or seq.ndim != 2 or len(
            comp_bpm) > MAX_COMPS:
        raise ValueError(
            f"scan_decode: host or words, not both; seq "
            f"{tuple(seq.shape)}; blocks per MCU {tuple(comp_bpm)}")
    lib = lib or _cuda.load("scan_decode")
    bpm = seq.shape[0]
    args = _ScanArgs(
        int(anchored), nwords, nseg, bpm, interval, n_mcu, len(comp_bpm),
        (ctypes.c_int * MAX_COMPS)(*comp_bpm), tables.shape[0],
        seq.data_ptr(), tables.data_ptr(),
        None if host is None else host.data_ptr(), host_seg,
        0 if host is None else host.numel() * host.element_size(),
        None if words is None else words.data_ptr(),
        None if seg_off is None else seg_off.data_ptr(),
        None if event is None else event.cuda_event)
    at = (ctypes.c_long * 3)()
    lib.jt_scan_workspace.restype = ctypes.c_long
    nbytes = lib.jt_scan_workspace(ctypes.byref(args), at)
    if nbytes <= 0:
        raise ValueError(
            f"scan_decode: refused {nseg} segments of {interval} MCUs, "
            f"{n_mcu} MCUs, blocks per MCU {comp_bpm} of {bpm}, {nwords} "
            f"words, {tables.shape[0]} tables")
    workspace = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    rows = torch.empty((n_mcu * bpm, 64), dtype=torch.int32, device=dev)
    args.workspace, args.rows = workspace.data_ptr(), rows.data_ptr()
    # seq and tables are read on the stream after the call returns: the
    # caller keeps them (decode_device's cache records the stream on them).
    _call("scan decode", lib.jt_scan_decode, dev, ctypes.byref(args))
    nstat = nseg if anchored else 1
    status = workspace[at[0]:at[0] + 8 * nstat].view(torch.int32)
    _note_passes(workspace[at[1]:at[1] + 4])
    with _COUNT_LOCK:
        NATIVE_SCANS += 1
        DC_SUM_LAUNCHES += 1
        AC_LAUNCHES += 1
        PREFIX_STAGE_LAUNCHES += len(_SYNC_STEPS)
        if anchored:
            SEGMENT_LAUNCHES += 1
            RESTART_SEGMENTS += nseg
        else:
            PREFIX_LAUNCHES += 1
    return rows, status.view(2, nseg) if anchored else status


def dc_sums_reference(diff, ac_off, seq, comp_bpm, interval: int, n_mcu: int,
                      anchored: bool):
    """Plain twin of the DC-sum launch (dc_sums): the torch sums it
    replaced, on any device. Anchored: diff (B,) in component-major order ->
    (dc, None, None), each block's difference summed from its component's
    first row in its segment (the row the program writes as its group). From
    bit 0: diff and ac_off (n_mcu, bpm) in MCU order, seq program F's rows
    -> (dc, off, slot) in component-major order, kernel D's inputs, DCs
    summed per component over the whole scan."""
    dev = diff.device
    if anchored:
        nblocks = diff.shape[0]
        group = _dc_groups(comp_bpm, interval, n_mcu, dev)
        sums = torch.cumsum(diff, 0, dtype=torch.int64)
        before = torch.cat([sums.new_zeros(1), sums])[group.clamp(0, nblocks)]
        return (sums - before).to(torch.int32), None, None
    # Component-major order (kernel D's and native.decode_scan's): all
    # blocks of component 0 in scan order, then component 1, ...
    off_parts, dc_parts, slot_parts, base = [], [], [], 0
    for per in comp_bpm:
        off_parts.append(ac_off[:, base:base + per].reshape(-1))
        dc_parts.append(torch.cumsum(
            diff[:, base:base + per].reshape(-1), dim=0).to(torch.int32))
        slot_parts.append(seq[base:base + per, 1].repeat(n_mcu))
        base += per
    return (torch.cat(dc_parts), torch.cat(off_parts),
            torch.cat(slot_parts).to(torch.int32))


def dc_control_bytes(nblocks: int, lib=None) -> int:
    """Bytes of the DC sums' control words for `nblocks` blocks (a tile
    counter and a word per tile), which the launch wants zeroed."""
    lib = lib or _cuda.load("scan_decode")
    lib.jt_dc_control_bytes.restype = ctypes.c_long
    return lib.jt_dc_control_bytes(ctypes.c_long(nblocks))


def _dc_groups(comp_bpm, interval: int, n_mcu: int, dev) -> torch.Tensor:
    """The anchored block-start program's groups: per block, component-major,
    its component's first block in its restart segment (the DC predictor's
    reset)."""
    group, first = [], 0
    for per in comp_bpm:
        span = interval * per
        rel = torch.arange(n_mcu * per, device=dev)
        group.append(first + rel // span * span)
        first += n_mcu * per
    return torch.cat(group)


def dc_sums(diff, ac_off, seq, comp_bpm, interval: int, n_mcu: int,
            anchored: bool, lib=None):
    """The DC-sum launch alone, as scan_decode's chain runs it
    (csrc/scan_decode.cu), with the contract of dc_sums_reference; anchored,
    it is given the groups the block-start program would write. CUDA
    tensors (or CPU ones with a host build as `lib`) launch it; CPU tensors
    without `lib` run the twin. Counts the launch."""
    global DC_SUM_LAUNCHES
    dev = diff.device
    if dev.type == "cpu" and lib is None:
        return dc_sums_reference(diff, ac_off, seq, comp_bpm, interval,
                                 n_mcu, anchored)
    lib = lib or _cuda.load("scan_decode")
    nblocks = diff.numel()
    dc = torch.empty(nblocks, dtype=torch.int32, device=dev)
    off = slot = group = None
    if anchored:
        group = _dc_groups(comp_bpm, interval, n_mcu, dev).to(torch.int32)
    else:
        off = torch.empty(nblocks, dtype=torch.int32, device=dev)
        slot = torch.empty(nblocks, dtype=torch.int32, device=dev)
    ctl = torch.zeros(dc_control_bytes(nblocks, lib) // 8, dtype=torch.int64,
                      device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    args = _DcArgs(int(anchored), nblocks, n_mcu, sum(comp_bpm),
                   len(comp_bpm), (ctypes.c_int * MAX_COMPS)(*comp_bpm),
                   ptr(diff), ptr(group), ptr(ac_off), ptr(seq), ptr(dc),
                   ptr(off), ptr(slot), ptr(ctl))
    _call("dc sum", lib.jt_dc_sum, dev, ctypes.byref(args))
    with _COUNT_LOCK:
        DC_SUM_LAUNCHES += 1
    return dc, off, slot


# ---------------------------------------------------------------------------
# Program F: block starts of a scan without restart markers.
# ---------------------------------------------------------------------------


def prefix_index_reference(words, n_mcu: int, seq, classes, tables):
    """Plain twin of prefix_index (any device): the reference's table
    program. For every bit position the step of one AC symbol, pointer-doubled
    over six levels; a binary descent to each position's block end; one MCU
    hop per position; pointer doubling over MCUs; the MCU starts read off and
    each MCU's blocks replayed."""
    dev = words.device
    w = words.to(torch.int64) & _M32
    b = torch.stack([(w >> 24) & 255, (w >> 16) & 255, (w >> 8) & 255,
                     w & 255], dim=1).reshape(-1)
    nbits = b.shape[0] * 8
    zero = torch.zeros(2, dtype=torch.int64, device=dev)
    w24 = (b << 16) | (torch.cat([b[1:], zero[:1]]) << 8) | torch.cat(
        [b[2:], zero])
    r = torch.arange(8, device=dev)
    w16 = ((w24[:, None] >> (8 - r)) & 0xFFFF).reshape(-1)
    pidx = torch.arange(nbits, device=dev)
    full = tables[:, :FULL_SIZE].to(torch.int64)
    layout = seq.cpu().numpy().tolist()
    levels = 6  # 2^5 = 32 >= the symbols any descent step needs
    mcu_levels = max(1, (n_mcu - 1).bit_length())

    def clip(idx):
        return idx.clamp(0, nbits - 1)

    def dc_step(dc_slot, windows):
        """(size with -1 for none, code length) of the DC code per window; a
        DC symbol above 16 counts as none."""
        dsym, dln = _sym_len(full[dc_slot][windows])
        bad = (dsym < 0) | (dsym > 16)
        return torch.where(bad, -1, dsym), torch.where(bad, 16, dln)

    fb_pos, fb_err = [], []
    for dc_slot, ac_slot in classes.cpu().numpy().tolist():
        sym, ln = _sym_len(full[ac_slot][w16])
        invalid = sym < 0
        symv = sym.clamp(min=0)
        adv0 = torch.where(invalid, 16, ln + (symv & 15))
        eob = (symv == 0) & ~invalid
        kinc0 = torch.where(eob | invalid, 0, torch.where(
            symv == 0xF0, 16, (symv >> 4) + 1))
        advs, kincs, terms, errs = [adv0], [kinc0], [eob], [invalid]
        for _ in range(1, levels):
            a, k, t, e = advs[-1], kincs[-1], terms[-1], errs[-1]
            nxt = clip(pidx + a)
            advs.append(a + a[nxt])
            kincs.append(k + torch.where(t, 0, k[nxt]))
            terms.append(t | t[nxt])
            errs.append(e | e[nxt])

        dsym, dln = dc_step(dc_slot, w16)
        p = clip(pidx + torch.where(dsym < 0, 16, dln + dsym.clamp(0, 16)))
        err = dsym < 0
        k = torch.ones_like(pidx)
        for j in range(levels - 1, -1, -1):
            ok = ~terms[j][p] & (k + kincs[j][p] <= 63)
            err = err | (ok & errs[j][p])
            k = torch.where(ok, k + kincs[j][p], k)
            p = torch.where(ok, clip(p + advs[j][p]), p)
        # exactly one closing symbol (EOB, or the one that crosses k = 64)
        err = err | errs[0][p] | (~terms[0][p] & (k + kincs[0][p] > 64))
        fb_pos.append(p + advs[0][p])
        fb_err.append(err)

    cur = pidx
    for _dc, _ac, ci in layout:
        cur = fb_pos[ci][clip(cur)]
    mcu_pos0 = cur
    jumps = [mcu_pos0]
    for _ in range(1, mcu_levels):
        jumps.append(jumps[-1][clip(jumps[-1])])
    m = torch.arange(n_mcu, device=dev)
    starts = torch.zeros(n_mcu, dtype=torch.int64, device=dev)
    for j in range(mcu_levels):
        starts = torch.where((m >> j) & 1 == 1, jumps[j][clip(starts)], starts)
    end_pos = mcu_pos0[clip(starts[-1])]

    cur = starts
    err_any = torch.zeros((), dtype=torch.bool, device=dev)
    ac_offs, diffs = [], []
    for dc_slot, _ac, ci in layout:
        cc = clip(cur)
        dsym, dln = dc_step(dc_slot, w16[cc])
        dsize = dsym.clamp(0, 16)
        amp = w16[clip(cur + dln)] >> (16 - dsize)
        diffs.append(_extend(amp, dsize))
        ac_offs.append(cur + dln + dsize)
        err_any = err_any | fb_err[ci][cc].any()
        cur = fb_pos[ci][cc]
    status = torch.stack([end_pos, err_any.to(torch.int64)])
    return (torch.stack(ac_offs, dim=1).to(torch.int32),
            torch.stack(diffs, dim=1).to(torch.int32),
            status.to(torch.int32))


class _SyncArgs(ctypes.Structure):
    """csrc/prefix_index.cu's SyncArgs, field for field."""
    _fields_ = [
        ("words", ctypes.c_void_p), ("nwords", ctypes.c_int),
        ("anchored", ctypes.c_int), ("seg_off", ctypes.c_void_p),
        ("nseg", ctypes.c_int), ("bpm", ctypes.c_int),
        ("interval", ctypes.c_long), ("n_mcu", ctypes.c_long),
        ("seq", ctypes.c_void_p), ("tables", ctypes.c_void_p),
        ("scratch", ctypes.c_void_p), ("ac_off", ctypes.c_void_p),
        ("diff", ctypes.c_void_p), ("slot", ctypes.c_void_p),
        ("group", ctypes.c_void_p), ("status", ctypes.c_void_p),
    ]


_SYNC_STEPS = (("layout", "jt_sync_layout"), ("speculate", "jt_sync_speculate"),
               ("link", "jt_sync_link"), ("resolve", "jt_sync_resolve"),
               ("write", "jt_sync_write"))


def _sync_steps(lib, words, seg_off, interval, n_mcu, seq, tables, scratch,
                ac_off, diff, status, slot=None, group=None) -> list:
    """The block-start program's launches, [(name, enqueue)]: anchored when
    `seg_off` is given (E's contract), else one segment at bit 0 (F's)."""
    def ptr(t):
        return None if t is None else t.data_ptr()

    args = _SyncArgs(
        ptr(words), words.numel(), int(seg_off is not None), ptr(seg_off),
        1 if seg_off is None else seg_off.numel(), seq.shape[0], interval,
        n_mcu, ptr(seq), ptr(tables), ptr(scratch), ptr(ac_off), ptr(diff),
        ptr(slot), ptr(group), ptr(status))
    dev = words.device
    # The launches hold the tensors, since args holds only their addresses.
    held = (words, seg_off, seq, tables, scratch, ac_off, diff, slot, group,
            status)
    return [(name, lambda fn=getattr(lib, entry), name=name, held=held: _call(
        f"sync {name}", fn, dev, ctypes.byref(args)))
        for name, entry in _SYNC_STEPS]


def sync_scratch(nwords: int, nseg: int, bpm: int, n_mcu: int, dev,
                 lib=None):
    """The block-start program's working memory (O(chunks x lanes) bytes)
    for `nseg` segments of `n_mcu` MCUs in all in `nwords` words. `lib` (the
    CUDA build unless a host build is given) sizes it: the chunk size goes
    by the bits per MCU."""
    lib = lib or _cuda.load("scan_decode")
    lib.jt_sync_scratch_bytes.restype = ctypes.c_long
    nbytes = lib.jt_sync_scratch_bytes(ctypes.c_int(nwords),
                                       ctypes.c_int(nseg), ctypes.c_int(bpm),
                                       ctypes.c_long(n_mcu))
    return torch.empty(nbytes, dtype=torch.uint8, device=dev)


def _note_passes(scratch) -> None:
    global _last_passes
    _last_passes = scratch[:4].view(torch.int32)


def __getattr__(name):
    if name == "SYNC_PASSES":
        # The rounds of the last call's resolve step, read where that step
        # wrote them (on a card this waits for it).
        return 0 if _last_passes is None else int(_last_passes[0])
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def prefix_launches(words, n_mcu, seq, classes, tables, ac_off, diff, status,
                    scratch, lib=None) -> list:
    """Program F as its separate launches, in order: [(name, enqueue)], each
    enqueue() putting one launch on PyTorch's current stream: the unanchored
    mode of csrc/prefix_index.cu (layout, speculate, link, resolve, write).
    Prepared contiguous int32 tensors and prefix_scratch's scratch; no
    checks and no allocation. `classes` is the contract's and goes unused:
    the walks read each block's own tables. A measurement may run one launch
    alone."""
    lib = lib or _cuda.load("scan_decode")
    return _sync_steps(lib, words, None, n_mcu, n_mcu, seq, tables, scratch,
                       ac_off, diff, status)


def _launch_prefix(words, n_mcu, seq, classes, tables, ac_off, diff, status,
                   scratch, lib=None) -> None:
    """Enqueue all of program F (prefix_launches) on PyTorch's current
    stream. Counts the call once and every launch."""
    global PREFIX_LAUNCHES, PREFIX_STAGE_LAUNCHES
    steps = prefix_launches(words, n_mcu, seq, classes, tables, ac_off, diff,
                            status, scratch, lib)
    for _name, enqueue in steps:
        enqueue()
    _note_passes(scratch)
    with _COUNT_LOCK:
        PREFIX_LAUNCHES += 1
        PREFIX_STAGE_LAUNCHES += len(steps)


def prefix_scratch(nwords: int, n_mcu: int, nclasses: int, dev, lib=None):
    """Program F's working memory for a scan of `nwords` words: sync_scratch
    of one segment, sized for the most blocks an MCU has, so that any seq
    fits."""
    return sync_scratch(nwords, 1, MAX_BPM, n_mcu, dev, lib)


def prefix_index(words, n_mcu: int, seq, classes, tables):
    """The unstuffed scan of a stream without restart markers as (W,)
    big-endian words with a zero guard; seq: (blocks per MCU, 3) int32, per
    block of the MCU its DC and AC rows in `tables` and its class; classes:
    (C, 2) int32, the distinct (DC row, AC row) pairs. -> (ac_off (n_mcu,
    blocks per MCU) int32: the bit offset just past each block's DC code;
    diff, same shape: its DC difference; status (2,) int32: the position
    after the last MCU, and whether a block on the path hit a window that
    starts no code or overshot k = 64 without EOB).

    CUDA tensors run program F, the unanchored mode of the chunked
    block-start program (csrc/prefix_index.cu); CPU tensors run the plain
    twin."""
    dev = words.device
    if n_mcu < 1:
        raise ValueError(f"prefix_index: {n_mcu} MCUs")
    if dev.type == "cpu":
        return prefix_index_reference(words, n_mcu, seq, classes, tables)
    if dev.type != "cuda":
        raise ValueError(f"prefix_index: unsupported device {dev}")
    _check("prefix_index", dev, words=words, seq=seq, classes=classes,
           tables=tables)
    _check_tables("prefix_index", tables)
    if words.ndim != 1 or seq.ndim != 2 or seq.shape[1] != 3 or (
            classes.ndim != 2 or classes.shape[1] != 2):
        raise ValueError(
            f"prefix_index: words {tuple(words.shape)}, seq "
            f"{tuple(seq.shape)}, classes {tuple(classes.shape)}")
    _check_words("prefix_index", words.numel())
    bpm = seq.shape[0]
    ac_off = torch.empty((n_mcu, bpm), dtype=torch.int32, device=dev)
    diff = torch.empty((n_mcu, bpm), dtype=torch.int32, device=dev)
    status = torch.empty(2, dtype=torch.int32, device=dev)
    _launch_prefix(words, n_mcu, seq, classes, tables, ac_off, diff, status,
                   prefix_scratch(words.numel(), n_mcu, classes.shape[0], dev))
    return ac_off, diff, status
