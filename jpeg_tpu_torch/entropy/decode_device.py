"""Device-side Huffman scan decode backends: "sparse", "indexed", "device".

Counterpart of jpeg_tpu/entropy/decode_device.py. All three return the
contract of native.decode_scan, but as per-component (blocks, 64) int32
tensors on the device, so the finish reads them with no round trip.

"sparse": the C++ runtime resolves the whole entropy layer on the host in one
walk (absolute DCs + nonzero ACs as (value, zig-zag position) pairs:
native.sparse_scan), packs them into one uint32 payload of about 2 bytes per
nonzero coefficient, and the device densifies it back into (B, 64) zig-zag
blocks. One upload instead of three dense int32 coefficient grids (128 bytes
per block). The host side (buckets, packers, build_payload and its callers)
is the reference's code with the imports rewritten; the payload is
byte-identical. The device side is written for a GPU: each element's block
comes from a binary search over the per-block end offsets and the values are
placed with one indexed store, where the reference builds (Sp, 64) one-hot
contributions and sums them by prefix differences because its target has no
cheap scatter. The reference's other densify formulations are not ported
(ROADMAP.md, "Not ported").

"indexed" (decode_scan_indexed): a light host pass (native.index_scan:
destuff, and per block the bit offset past its DC code and its absolute DC),
one upload of the scan's words with the offsets and DCs behind them, and
kernel D decodes every block's AC coefficients in parallel.

"device" (decode_scan): the host only splits the scan at its restart markers
and removes the byte stuffing. The card finds every block's start with one
chunked, self-synchronizing program (csrc/prefix_index.cu): anchored at every
segment's first byte with markers, from bit 0 without (program F,
decode_scan_prefix); one launch sums the DCs, and kernel D decodes the
blocks. On a card the host half is native code that holds no GIL: the split
(csrc/scan_decode.cu's jt_split_scan, into the thread's pinned buffer) and
one C call that enqueues the words' upload and every launch
(entropy_decode.scan_decode). On the CPU unstuffed_segments and the kernels'
plain twins run. The kernels, their twins and their table format are
ops/entropy_decode's; the reference's canonical-code tables and its second
LUT form are not carried over, since a GPU thread indexes one table.

Invalid codes never hang a kernel: a window that starts no code advances the
cursor by 16 bits and sets a flag, every loop is bounded, and the host raises
ScanDecodeError on a flag or on a cursor past the segment's true bits.

torch has no uint32 arithmetic, so payloads and bit words travel as int32;
the plain code widens once to int64 and masks to 32 bits.
"""

from __future__ import annotations

import collections
import ctypes
import threading

import numpy as np
import torch

from jpeg_tpu_torch.entropy import decode_np, native
from jpeg_tpu_torch.entropy.decode_np import ScanDecodeError
from jpeg_tpu_torch.ops import _cuda, entropy_decode
from jpeg_tpu_torch.utils.trace import span

_GUARD = 8  # zero guard bytes kept behind every uploaded bit stream
# No block is longer: a DC code and its amplitude (16 + 16 bits), then at most
# 63 AC symbols of a 16-bit code and 15 amplitude bits each.
MAX_BLOCK_BITS = 32 + 63 * 31


def _ceil16(n: int) -> int:
    return -(-n // 16) * 16


# ---------------------------------------------------------------------------
# Host side: payload layout and packers.
# ---------------------------------------------------------------------------


def sparse_bucket(S: int) -> int:
    """Upload-size bucket for S sparse elements: 1/8-octave steps
    ((8..15) << e), strictly > S, so a payload always ends in at least one
    padding element and streams of similar size share a payload geometry.
    Always a multiple of 16 (the 6-bit pack granularity; floor 1024
    guarantees the shift is >= 4)."""
    need = max(1024, S + 1)
    e = need.bit_length() - 4  # so that (8..16) << e covers `need`
    return -(-need >> e) << e


def exception_bucket(E: int) -> int:
    """Exception-stream bucket: same 1/8-octave shape, floor 256 (the stream
    is tiny; over-padding it costs ~1.5 KB)."""
    need = max(256, E + 1)
    e = need.bit_length() - 4
    return -(-need >> e) << e


def _pack6(a: np.ndarray) -> np.ndarray:
    """(n,) values <= 63, n % 16 == 0 -> (n/16*3,) uint32 (the _unpack6
    layout: value j of each 16-group at bits [6j, 6j+6) of its 96-bit
    group)."""
    g = a.reshape(-1, 16).astype(np.uint64)
    lo = np.zeros(g.shape[0], np.uint64)   # bits 0..63
    hi = np.zeros(g.shape[0], np.uint64)   # bits 64..95 (in low 32)
    for j in range(16):
        b = 6 * j
        if b < 64:
            lo |= g[:, j] << b
            if b > 58:  # straddles the 64-bit boundary (j == 10: bits 60..65)
                hi |= g[:, j] >> (64 - b)
        else:
            hi |= g[:, j] << (b - 64)
    out = np.empty((g.shape[0], 3), np.uint32)
    out[:, 0] = lo & 0xFFFFFFFF
    out[:, 1] = lo >> 32
    out[:, 2] = hi & 0xFFFFFFFF
    return out.reshape(-1)


def _pack_exc(payload, base: int, idx: np.ndarray, val: np.ndarray,
              Ep: int, cap: int) -> int:
    """Write one (idx u32, val i16) exception stream; padding entries target
    cap-1 with value 0. Returns the next write offset."""
    if idx.shape[0] > Ep:
        raise ValueError("exception bucket too small")
    ibuf = np.full(Ep, cap - 1, dtype=np.uint32)
    ibuf[: idx.shape[0]] = idx
    payload[base:base + Ep] = ibuf
    base += Ep
    ebuf = np.zeros(Ep, dtype=np.int16)
    ebuf[: idx.shape[0]] = val
    payload[base:base + Ep // 2] = ebuf.view(np.uint32)
    return base + Ep // 2


def dc_diff_exceptions(dc: np.ndarray) -> int:
    """Number of |diff| > 127 entries the dc-diff stream needs (callers size
    the Edp bucket from this)."""
    dcd = np.diff(dc.astype(np.int32), prepend=np.int32(0))
    return int(np.count_nonzero(np.abs(dcd) > 127))


def build_payload_numpy(vals, ks, counts, dc, Sp: int, Ep: int,
                        Edp: int) -> np.ndarray:
    """build_payload in NumPy: the byte-exact reference of the C++ packer."""
    B = counts.shape[0]
    S = vals.shape[0]
    B16 = _ceil16(B)
    c6w = (B16 // 16) * 3
    k6w = (Sp // 16) * 3
    v4w = Sp // 8
    d8w = (B + 3) // 4

    vals32 = vals.astype(np.int32)
    big = np.abs(vals32) > 7
    vexc_i = np.nonzero(big)[0].astype(np.uint32)
    v4 = np.where(big, -8, vals32)

    dcd = np.diff(dc.astype(np.int32), prepend=np.int32(0))
    dbig = np.abs(dcd) > 127
    dexc_i = np.nonzero(dbig)[0].astype(np.uint32)
    d8 = np.where(dbig, -128, dcd).astype(np.int8)

    payload = np.zeros(c6w + k6w + v4w + d8w + Ep + Ep // 2 + Edp + Edp // 2,
                       dtype=np.uint32)
    cbuf = np.zeros(B16, dtype=np.uint8)
    cbuf[:B] = counts
    payload[:c6w] = _pack6(cbuf)
    off = c6w
    kbuf = np.zeros(Sp, dtype=np.uint8)
    kbuf[:S] = ks
    payload[off:off + k6w] = _pack6(kbuf)
    off += k6w
    nbuf = np.zeros(Sp, dtype=np.uint8)
    nbuf[:S] = (v4 & 15).astype(np.uint8)
    payload[off:off + v4w] = (
        nbuf[0::2] | (nbuf[1::2] << 4)
    ).view(np.uint32)
    off += v4w
    dbuf = np.zeros(d8w * 4, dtype=np.int8)
    dbuf[:B] = d8
    payload[off:off + d8w] = dbuf.view(np.uint32)
    off += d8w
    off = _pack_exc(payload, off, vexc_i, vals32[big].astype(np.int16),
                    Ep, Sp)
    _pack_exc(payload, off, dexc_i, dcd[dbig].astype(np.int16), Edp, B)
    return payload


def build_payload(vals, ks, counts, dc, Sp: int, Ep: int,
                  Edp: int) -> np.ndarray:
    """Pack native.sparse_scan outputs into the uint32 upload payload
    densify_body expects ([counts 6b | ks 6b | vals 4b | dc-diff i8 |
    val_exc | dc_exc]); |v| > 7 values become the nibble sentinel -8 plus an
    exception entry, |dc diff| > 127 the int8 sentinel -128 plus its own.
    Packed by the C++ runtime (build_payload_numpy is its reference).

    The per-block counts must add up to the number of elements: densify_body
    derives every element's block from them."""
    if int(counts.sum(dtype=np.int64)) != vals.shape[0] or (
            ks.shape[0] != vals.shape[0]):
        raise ValueError(
            f"sparse payload: counts sum to {int(counts.sum(dtype=np.int64))} "
            f"for {vals.shape[0]} values and {ks.shape[0]} positions")
    if vals.shape[0] >= Sp:
        raise ValueError("sparse bucket too small")
    return native.pack_payload(vals, ks, counts, dc, Sp, Ep, Edp)


def _bucketed_payload(vals, ks, counts, dc):
    Sp = sparse_bucket(vals.shape[0])
    Ep = exception_bucket(
        int(np.count_nonzero(np.abs(vals.astype(np.int32)) > 7)))
    Edp = exception_bucket(dc_diff_exceptions(dc))
    return (build_payload(vals, ks, counts, dc, Sp, Ep, Edp),
            counts.shape[0], Sp, Ep, Edp)


def sparse_payload(
    scan: bytes,
    mcu_count: int,
    mcu_layout: list,
    htables: dict,
    restart_interval: int,
):
    """Host half of the sparse backend: run native.sparse_scan and pack its
    outputs into the single uint32 upload payload densify_body expects.
    Returns (payload (np.uint32), B, Sp, Ep, Edp)."""
    return _bucketed_payload(*native.sparse_scan(
        scan, mcu_count, mcu_layout, htables, restart_interval))


def sparse_payload_from_blocks(blocks_list):
    """Build the sparse upload payload from already-decoded dense (N, 64)
    zig-zag block arrays (one per component, DC at column 0 ABSOLUTE).

    For the walkers that produce dense per-component grids (progressive,
    multi-scan, the dense host backends): the payload feeds the same
    densify + finish as the baseline path, with no scan->raster reorder,
    since the grids are already raster. Returns (payload, B, Sp, Ep, Edp)."""
    dense = np.concatenate([np.asarray(b) for b in blocks_list], axis=0)
    dense = dense.astype(np.int32, copy=False)
    ac = dense[:, 1:]
    rows, cols = np.nonzero(ac)
    vals = ac[rows, cols].astype(np.int16)
    ks = (cols + 1).astype(np.uint8)  # zig-zag position 1..63
    counts = np.bincount(rows, minlength=dense.shape[0]).astype(np.uint8)
    dc = dense[:, 0].astype(np.int32)
    return _bucketed_payload(vals, ks, counts, dc)


# ---------------------------------------------------------------------------
# Device side: unpack and densify (plain torch, any device).
# ---------------------------------------------------------------------------


def payload_tensor(payload: np.ndarray, device) -> torch.Tensor:
    """The uint32 payload as an int32 tensor on `device` (one upload)."""
    words = np.ascontiguousarray(payload, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(words).to(device)


def _shifts(values, device) -> torch.Tensor:
    # A blocking upload: on a card the host waits for the stream first.
    with span("jt.wait.upload"):
        return torch.tensor(values, dtype=torch.int64, device=device)


def _unpack6(words: torch.Tensor, n: int) -> torch.Tensor:
    """6-bit stream unpack: (..., G*3) non-negative int64 words (32 bits
    each) -> (..., n) int64 in [0, 64). 16 values ride each 96-bit group: ten
    lie in the first two words, one straddles into the third, five lie in the
    third."""
    g = words.reshape(*words.shape[:-1], -1, 3)
    dev = words.device
    lo = g[..., 0] | (g[..., 1] << 32)  # bit 63 may be set: mask after shifting
    first = (lo[..., None] >> _shifts(range(0, 60, 6), dev)) & 63
    straddle = ((lo >> 60) & 15) | ((g[..., 2] & 3) << 4)
    last = (g[..., 2, None] >> _shifts(range(2, 32, 6), dev)) & 63
    return torch.cat([first, straddle[..., None], last], dim=-1).reshape(
        *words.shape[:-1], -1)[..., :n]


def _unpack_bytes(words: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """(..., W) words -> (..., n) int64 two's-complement fields of `bits`
    bits each (4: nibbles in [-8, 7]; 8: int8; 16: int16), low field
    first."""
    mask, sign = (1 << bits) - 1, 1 << (bits - 1)
    f = (words[..., None] >> _shifts(range(0, 32, bits), words.device)) & mask
    return (f.reshape(*words.shape[:-1], -1)[..., :n] ^ sign) - sign


def _apply_exceptions(stream: torch.Tensor, words: torch.Tensor, base: int,
                      Ep: int) -> torch.Tensor:
    """Add the (idx u32, val i16) exception stream at words[:, base:] (the
    one home of the exception wire format) onto `stream` (K, cap), in place.
    Sentinel'd slots hold 0, so the add reconstructs values exactly; padding
    entries target cap-1 with value 0 (no-op adds)."""
    n_img, cap = stream.shape
    idx = words[:, base:base + Ep].clamp(0, cap - 1)
    val = _unpack_bytes(words[:, base + Ep:base + Ep + Ep // 2], 16, Ep)
    row = torch.arange(n_img, device=stream.device)[:, None] * cap
    stream.view(-1).index_add_(0, (idx + row).reshape(-1), val.reshape(-1))
    return stream


def densify_body(payload: torch.Tensor, B: int, Sp: int, Ep: int,
                 Edp: int) -> torch.Tensor:
    """Densify the sparse payload: int32 words (the uint32 payload's bits)
    [counts 6b | ks 6b | vals 4b | dc-diff i8 | val_exc (u32+i16) |
    dc_exc (u32+i16)] -> (B, 64) int32 zig-zag blocks, on the payload's
    device. A (K, words) stack of payloads of one geometry densifies in the
    same pass to (K, B, 64).

    Counts and zig-zag positions are 6-bit packed (both <= 63), AC values
    are two's-complement nibbles (|v| > 7 rides the sentinel -8 plus a
    (u32 idx, i16 val) exception), and the DC is int8 diffs of the
    absolute-DC array (|diff| > 127 rides the sentinel -128 plus its own
    exception stream; one cumsum rebuilds it).

    Placement is direct: element i belongs to the block whose range of the
    running count holds i (a binary search over the blocks' end offsets,
    which skips empty blocks), and one indexed store writes every value at
    (block, k). Padding elements past the last block find no block and go
    to a spare row that is cut off."""
    B16 = _ceil16(B)
    c6w = (B16 // 16) * 3
    k6w = (Sp // 16) * 3
    v4w = Sp // 8
    d8w = (B + 3) // 4
    total = c6w + k6w + v4w + d8w + Ep + Ep // 2 + Edp + Edp // 2
    if payload.ndim not in (1, 2) or payload.shape[-1] != total:
        raise ValueError(
            f"sparse payload has {tuple(payload.shape)} words, geometry "
            f"(B={B}, Sp={Sp}, Ep={Ep}, Edp={Edp}) needs {total}")
    dev = payload.device
    words = payload.reshape(-1, total).to(torch.int64) & 0xFFFFFFFF
    n_img = words.shape[0]
    off = 0
    counts = _unpack6(words[:, :c6w], B)
    off += c6w
    ks = _unpack6(words[:, off:off + k6w], Sp)
    off += k6w
    v4 = _unpack_bytes(words[:, off:off + v4w], 4, Sp)
    vals = torch.where(v4 == -8, 0, v4)
    off += v4w
    d8 = _unpack_bytes(words[:, off:off + d8w], 8, B)
    dcd = torch.where(d8 == -128, 0, d8)
    off += d8w
    vals = _apply_exceptions(vals, words, off, Ep)
    off += Ep + Ep // 2
    dc = torch.cumsum(_apply_exceptions(dcd, words, off, Edp), dim=1)

    ends = torch.cumsum(counts, dim=1)
    elem = torch.arange(Sp, dtype=torch.int64, device=dev).repeat(n_img, 1)
    block = torch.searchsorted(ends, elem, right=True)  # B for padding
    rows = torch.zeros((n_img, B + 1, 64), dtype=torch.int32, device=dev)
    img = torch.arange(n_img, device=dev)[:, None]
    rows[img, block, ks] = vals.to(torch.int32)
    rows = rows[:, :B]
    # Real AC positions are 1..63, so column 0 is free for the DC.
    rows[:, :, 0] = dc.to(torch.int32)
    return rows[0] if payload.ndim == 1 else rows


def decode_scan_sparse(
    scan: bytes,
    mcu_count: int,
    mcu_layout: list,
    htables: dict,
    restart_interval: int,
    device="cuda",
):
    """Sparse backend with the contract of native.decode_scan, but the
    per-component (bpm * mcu_count, 64) int32 blocks are tensors on
    `device`."""
    payload, B, Sp, Ep, Edp = sparse_payload(
        scan, mcu_count, mcu_layout, htables, restart_interval
    )
    rows = densify_body(payload_tensor(payload, device), B, Sp, Ep, Edp)
    out, base = [], 0
    for (_comp, bpm, _, _) in mcu_layout:
        out.append(rows[base : base + bpm * mcu_count])
        base += bpm * mcu_count
    return out


# ---------------------------------------------------------------------------
# The device Huffman decoders: "indexed" (host index + kernel D) and "device"
# (the block-start program anchored at every restart segment, or program F
# without markers; kernel D after either).
# ---------------------------------------------------------------------------

# Device tensors that are built once and kept: decode tables per table set,
# slot arrays and MCU sequences per scan geometry (least recently used goes
# first). A fill waits for its upload (_cuda.settled), since the next reader
# may be another thread on another stream; a hit records the reader's stream,
# since an entry may be evicted while that stream still reads it.
_CACHE_SIZE = 16
_cache: collections.OrderedDict = collections.OrderedDict()
_cache_lock = threading.Lock()


def _cached(key: tuple, device: torch.device, build) -> tuple:
    """The tuple of tensors on `device` that build() gives as NumPy arrays,
    uploaded once per (key, device)."""
    key = (str(device),) + key
    with _cache_lock:
        hit = _cache.get(key)
        if hit is not None:
            _cache.move_to_end(key)
    if hit is not None:
        if device.type == "cuda":
            current = torch.cuda.current_stream(device)
            for t in hit:
                t.record_stream(current)
        return hit
    made = tuple(_cuda.settled(torch.as_tensor(a, device=device))
                 for a in build())
    with _cache_lock:
        _cache[key] = made
        if len(_cache) > _CACHE_SIZE:
            _cache.popitem(last=False)
    return made


def _scan_slots(mcu_layout: list):
    """The scan's table keys, DC then AC, and each key's row in its tables."""
    slots = sorted({(0, dc) for (_, _, dc, _) in mcu_layout}
                   | {(1, ac) for (_, _, _, ac) in mcu_layout})
    return slots, {k: i for i, k in enumerate(slots)}


def _device_luts(htables: dict, slots: list, device) -> torch.Tensor:
    """entropy_decode.build_tables for `slots`, on `device`."""
    key = ("luts",) + tuple(
        (k, htables[k].size.tobytes(), htables[k].code.tobytes())
        for k in slots)
    return _cached(key, device, lambda: (
        entropy_decode.build_tables(htables, slots),))[0]


def _cached_slot_array(bpm_slots: tuple, mcu_count: int, device):
    """Kernel D's AC table row per block, component-major."""
    return _cached(("slot", bpm_slots, mcu_count), device, lambda: (
        np.concatenate([np.full(bpm * mcu_count, s, dtype=np.int32)
                        for (bpm, s) in bpm_slots]),))[0]


def _split_components(rows: torch.Tensor, mcu_layout: list, mcu_count: int):
    return list(torch.split(
        rows, [bpm * mcu_count for (_, bpm, _, _) in mcu_layout]))


def _guarded_words(data: np.ndarray) -> np.ndarray:
    """uint8 bytes of a bit stream -> int32 big-endian words with at least
    _GUARD zero bytes behind them. Bit offsets are int32."""
    nwords = (len(data) + _GUARD + 3) // 4
    if nwords > entropy_decode.MAX_WORDS:
        raise ScanDecodeError(
            f"scan of {len(data)} bytes is too long for int32 bit offsets")
    buf = np.zeros(nwords * 4, dtype=np.uint8)
    buf[: len(data)] = data
    return entropy_decode.words_from_bytes(buf)


def unstuffed_segments(scan: bytes):
    """The scan split at its RSTn markers with the byte stuffing removed, as
    decode_np.split_restart_segments and decode_np.unstuff give it segment by
    segment, but in a few array operations over the whole scan and with the
    segments left one after another, so that a stream with thousands of
    short segments costs the host no more than one with none. Returns (words
    (W,) int32: the segments' bytes as one stream of big-endian words with
    the zero guard behind; seg_off (S,) int32: each segment's first byte in
    that stream; lens (S,) int64: each segment's length in bytes)."""
    buf = np.frombuffer(scan, dtype=np.uint8)
    n = len(buf)
    flat, lens = buf, np.array([n], dtype=np.int64)
    if n >= 2:
        ff = np.flatnonzero(buf[:-1] == 0xFF)  # few: one byte in 256 or so
        after = buf[ff + 1]
        stuffed = ff[after == 0x00] + 1
        markers = ff[(after & 0xF8) == 0xD0]  # RST0 .. RST7
        keep = np.ones(n, dtype=bool)
        keep[stuffed] = False
        keep[markers] = False
        keep[markers + 1] = False
        flat = buf[keep]
        first = np.concatenate([[0], markers + 2])
        end = np.concatenate([markers, [n]])
        lens = (end - first - (np.searchsorted(stuffed, end)
                               - np.searchsorted(stuffed, first))).astype(
                                   np.int64)
    return (_guarded_words(flat), (np.cumsum(lens) - lens).astype(np.int32),
            lens)


def decode_scan_indexed(
    scan: bytes,
    mcu_count: int,
    mcu_layout: list,
    htables: dict,
    restart_interval: int,
    device="cuda",
):
    """Hybrid backend: the contract of native.decode_scan, but the
    per-component blocks are tensors on `device`. The native runtime walks
    the scan once on the host (native.index_scan, threaded across restart
    segments); the scan's words, the AC offsets and the DCs go up as ONE
    int32 tensor; kernel D decodes every block's AC coefficients."""
    device = torch.device(device)
    with span("jt.decode.walk"):
        destuffed, ac_off, dc = native.index_scan(
            scan, mcu_count, mcu_layout, htables, restart_interval
        )
    slots, slot_of = _scan_slots(mcu_layout)
    tables = _device_luts(htables, slots, device)
    slot_dev = _cached_slot_array(
        tuple((bpm, slot_of[(1, ac)]) for (_, bpm, _, ac) in mcu_layout),
        mcu_count, device)

    words = _guarded_words(destuffed)
    nwords, nblocks = len(words), ac_off.shape[0]
    host = np.concatenate([words, ac_off, dc])
    with span("jt.wait.upload"):
        dev = torch.from_numpy(host).to(device)
    with span("jt.decode.entropy"):
        rows = entropy_decode.decode_ac_indexed(
            dev[:nwords], dev[nwords:nwords + nblocks], dev[nwords + nblocks:],
            slot_dev, tables)
    return _split_components(rows, mcu_layout, mcu_count)


def decode_scan_prefix(
    scan: bytes,
    mcu_count: int,
    mcu_layout: list,
    htables: dict,
    device="cuda",
):
    """Restart-free decode on the device: program F finds every block's AC
    offset and DC difference, a cumulative sum per component gives the DCs,
    kernel D decodes the blocks. Same output contract as
    decode_scan_indexed; a scan with restart markers is refused."""
    return _decode(scan, mcu_count, mcu_layout, htables, 0,
                   torch.device(device), prefix=True)


# The host side of a card's scan: each thread's pinned buffer (the words,
# the segments' offsets behind them and room for the DC sums' control
# words), its event and the segments' lengths. The buffer is written again
# only once the event, recorded behind its last upload, has completed: a
# decode that raised after its upload was enqueued leaves it in flight.
_host = threading.local()


class _Held:
    """A thread's host buffer for one device: pinned on a card, with the
    event recorded behind its last upload."""

    def __init__(self, device: torch.device, nbytes: int, nseg: int):
        card = device.type == "cuda"
        self.buf = torch.empty(-(-nbytes // 4), dtype=torch.int32,
                               pin_memory=card)
        self.words = self.buf.numpy()
        self.lens = np.empty(nseg, dtype=np.int64)
        self.event = torch.cuda.Event() if card else None
        if card:
            self.event.record(torch.cuda.current_stream(device))


def _held(device: torch.device, nbytes: int, nseg: int) -> _Held:
    """This thread's host buffer for `device`, with room for `nbytes` and
    `nseg` segments, once its last upload is done."""
    held = getattr(_host, "held", None)
    if held is None:
        held = _host.held = {}
    h = held.get(str(device))
    if h is not None and h.event is not None and not h.event.query():
        with span("jt.wait.slot"):
            h.event.synchronize()
    if h is None or h.buf.numel() * 4 < nbytes or h.lens.shape[0] < nseg:
        # Grown at least twofold, so that a stream of growing scans
        # allocates a few times only.
        old = (0, 0) if h is None else (h.buf.numel() * 4, h.lens.shape[0])
        h = held[str(device)] = _Held(device, max(nbytes, 2 * old[0]),
                                      max(nseg, 2 * old[1]))
    return h


def _split_native(scan: bytes, device: torch.device, lib=None):
    """unstuffed_segments' (words, seg_off, lens) by the native split
    (csrc/scan_decode.cu; `lib` another build of it), written into this
    thread's host buffer: views of it, and the buffer with the word where
    seg_off starts."""
    data = scan if isinstance(scan, bytes) else bytes(scan)
    n = len(data)
    words_cap = (n + _GUARD + 3) // 4
    seg_cap = n // 2 + 1
    lib = lib or _cuda.load("scan_decode")
    # The DC sums' control words go behind: a scan of n bytes is refused
    # beyond 4n blocks (two bits a block).
    h = _held(device, 4 * (words_cap + seg_cap) + 8
              + entropy_decode.dc_control_bytes(4 * n, lib), seg_cap)
    lib.jt_split_scan.restype = ctypes.c_long
    ptr = h.buf.data_ptr()
    nseg = lib.jt_split_scan(data, ctypes.c_long(n), ctypes.c_void_p(ptr),
                             ctypes.c_void_p(ptr + 4 * words_cap),
                             ctypes.c_void_p(h.lens.ctypes.data))
    lens = h.lens[:nseg]
    nwords = (int(lens.sum()) + _GUARD + 3) // 4
    return (h.words[:nwords], h.words[words_cap:words_cap + nseg], lens,
            (h, words_cap))


def decode_scan(
    scan: bytes,
    mcu_count: int,
    mcu_layout: list,
    htables: dict,
    restart_interval: int,
    device="cuda",
):
    """Device twin of decode_np.decode_scan (same contract, tables not LUTs,
    tensors on `device`): the host splits the scan at its restart markers and
    removes the byte stuffing; the Huffman walk runs on the device.

    A stream with restart markers takes the block-start program anchored at
    every segment; one without (and more than one MCU) takes program F. On a
    card the split is native (into the thread's pinned buffer) and one C
    call (entropy_decode.scan_decode) enqueues the upload, the program, the
    DC sums and kernel D; on the CPU unstuffed_segments and the kernels'
    plain twins run. Only the segments' end positions and error flags come
    back to the host."""
    return _decode(scan, mcu_count, mcu_layout, htables, restart_interval,
                   torch.device(device), prefix=False)


def _decode(scan: bytes, mcu_count: int, mcu_layout: list, htables: dict,
            restart_interval: int, device: torch.device, prefix: bool,
            lib=None):
    """decode_scan; `prefix`: program F whatever the MCU count. `lib`, a
    host build of csrc/scan_decode.cu, runs the card's route on the CPU."""
    native = device.type == "cuda" or lib is not None
    with span("jt.decode.unstuff"):
        if native:
            host_words, seg_off, seg_bytes, held = _split_native(
                scan, device, lib)
        else:
            host_words, seg_off, seg_bytes = unstuffed_segments(scan)
    if len(host_words) > entropy_decode.MAX_WORDS:
        raise ScanDecodeError(
            f"scan of {int(seg_bytes.sum())} bytes is too long for int32 bit "
            f"offsets")
    r = restart_interval if restart_interval else mcu_count
    expected = (mcu_count + r - 1) // r
    if len(seg_bytes) != expected:
        raise ScanDecodeError(
            f"expected {expected} restart segments, found {len(seg_bytes)}"
        )
    # A block is at least a DC code and an EOB, two bits: a header that
    # claims more blocks than the scan can hold is refused here, before
    # their rows are allocated on the device.
    nblocks = mcu_count * sum(bpm for (_, bpm, _, _) in mcu_layout)
    if 2 * nblocks > 8 * int(seg_bytes.sum()):
        raise ScanDecodeError("bit cursor ran past segment end")
    anchored = not prefix and (expected > 1 or mcu_count == 1)
    true_bits = int(seg_bytes[0]) * 8
    if not anchored:
        # Program F is given no more words than these blocks can span: a
        # walk that raises no flag ends inside them, and what a file
        # carries behind them is never read, nor chunked.
        keep = (nblocks * MAX_BLOCK_BITS + 31) // 32
        if keep + _GUARD // 4 < len(host_words):
            host_words = host_words[:keep + _GUARD // 4]
            host_words[keep:] = 0
            true_bits = min(true_bits, keep * 32)
    slots, slot_of = _scan_slots(mcu_layout)
    tables = _device_luts(htables, slots, device)
    if anchored:
        layout_key = tuple((bpm, slot_of[(0, dc)], slot_of[(1, ac)])
                           for (_, bpm, dc, ac) in mcu_layout)

        def sequence():
            out, base = [], 0
            for ci, (bpm, dc_slot, ac_slot) in enumerate(layout_key):
                out += [(ci, dc_slot, ac_slot, base + occ, bpm)
                        for occ in range(bpm)]
                base += bpm * mcu_count
            return (np.array(out, dtype=np.int32),)

        seq = _cached(("segments", layout_key, mcu_count), device, sequence)[0]
    else:
        pairs = [(slot_of[(0, dc)], slot_of[(1, ac)])
                 for (_, bpm, dc, ac) in mcu_layout for _ in range(bpm)]
        classes = sorted(set(pairs))
        seq, cls = _cached(("prefix", tuple(pairs)), device, lambda: (
            np.array([(d, a, classes.index((d, a))) for d, a in pairs],
                     dtype=np.int32),
            np.array(classes, dtype=np.int32)))
    comp_bpm = [bpm for (_, bpm, _, _) in mcu_layout]
    if not native:
        # The twins' upload; on a card the chain's copy does not block.
        with span("jt.wait.upload"):
            words = torch.from_numpy(host_words).to(device)
            seg_off = torch.from_numpy(seg_off).to(device)
    with span("jt.decode.entropy"):
        if native:
            h, words_cap = held
            rows, status = entropy_decode.scan_decode(
                device, anchored, len(host_words), len(seg_bytes), r,
                mcu_count, seq, tables, comp_bpm, host=h.buf,
                host_seg=words_cap if anchored else len(host_words),
                event=h.event, lib=lib)
        elif anchored:
            rows, status = entropy_decode.decode_segments(
                words, seg_off, r, mcu_count, seq, tables, nblocks)
        else:
            ac_off, diff, status = entropy_decode.prefix_index(
                words, mcu_count, seq, cls, tables)
            dc, off, slot = entropy_decode.dc_sums(
                diff, ac_off, seq, comp_bpm, r, mcu_count, False)
            rows = entropy_decode.decode_ac_indexed(
                words, off, dc, slot, tables)
    with span("jt.wait.status"):
        end_pos, err = status.cpu().numpy()
    # Kernel D ran before the flags came back: on a corrupt stream it read
    # clamped garbage, and its rows are dropped here.
    if err.any():
        if not anchored:
            raise ScanDecodeError("invalid Huffman code (device prefix index)")
        raise ScanDecodeError(
            f"invalid Huffman code in segment(s) {np.nonzero(err)[0].tolist()}"
        )
    if anchored:
        past = (end_pos.astype(np.int64) > seg_bytes * 8).any()
    else:
        past = int(end_pos) > true_bits
    if past:
        raise ScanDecodeError("bit cursor ran past segment end")
    return _split_components(rows, mcu_layout, mcu_count)
