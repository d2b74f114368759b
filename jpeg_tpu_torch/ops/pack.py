"""Device Huffman bit packer: coefficient blocks -> per-block word buffers
(level 1, kernel A) -> one big-endian word stream per restart segment
(level 2, plain torch), or straight to the finished scan (pack_scan: level
2, trim, 1-padding, 0xFF stuffing and RSTn markers in csrc/pack_scan.cu).

Counterpart of jpeg_tpu/ops/pack_pallas.py. Level 1 on a CUDA tensor
launches the hand-written kernel csrc/pack_level1.cu, which replaces the
Pallas kernel pack_pallas._kernel (pallas_call at pack_pallas.py:237); on a
CPU tensor it runs the plain twin pack_level1_reference, which follows the
Pallas kernel's arithmetic step for step and so is bit-identical to it for
every block. The kernel's source note says what bounds it on the card.

Bit words are carried as int32 tensors holding uint32 bit patterns (torch
shifts on int32 are arithmetic, so the plain code widens to int64 and masks).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from jpeg_tpu_torch.ops import _cuda, bitpack
from jpeg_tpu_torch.ops.bitpack import BLOCK_WORDS

# Kernel launches since the last reset (plus one per launch, nowhere else).
# Worker threads launch too (parallel/pipeline), so the increment holds a lock.
LAUNCHES = 0
_COUNT_LOCK = threading.Lock()
# Launches of the scan pass (csrc/pack_scan.cu) since the last reset: its
# memset and its three kernels, _SCAN_STEPS a call, under the same lock.
SCAN_LAUNCHES = 0
_SCAN_STEPS = 4

_M32 = 0xFFFFFFFF
# Blocks per slice of the plain twin: bounds its (blocks, 191) int64
# intermediates to a few tens of MB.
_CHUNK = 16384


def _to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensors with the same bit pattern."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _level1_chunk(v, tb, dc_code, dc_len, ac_code, ac_len):
    """Plain level 1 for one slice of blocks, in int64, mirroring
    pack_pallas._kernel: size classes by 12 thresholds, amplitudes, zero runs
    by cummax, direct LUT reads for the codes, the ZRL pair/single split,
    EOB, offsets from one prefix sum, and the same clamped word placement."""
    b = v.shape[0]
    dev = v.device
    mag = v.abs()
    size = torch.zeros_like(mag)
    for k in range(12):
        size += (mag >= (1 << k)).to(mag.dtype)
    one = torch.ones_like(size)
    low = (one << size) - 1
    amp = torch.where(v >= 0, v, v + low) & low

    idx = torch.arange(64, device=dev).expand(b, 64)
    nz = (v != 0) & (idx > 0)
    markers = torch.where(nz, idx, 0)
    cmax = torch.cummax(markers, dim=1).values
    prev = torch.cat([torch.zeros((b, 1), dtype=cmax.dtype, device=dev),
                      cmax[:, :-1]], dim=1)
    run = torch.where(nz, idx - prev - 1, 0)
    last_nz = cmax[:, -1:]
    base = tb[:, None] * 256

    dsize = size[:, :1]
    dbits = (dc_code[base + dsize] << dsize) | amp[:, :1]
    dnbits = dc_len[base + dsize] + dsize

    s_ac, nz_ac = size[:, 1:], nz[:, 1:]
    sym = base + ((run[:, 1:] & 15) << 4) + s_ac
    ac_c = torch.where(nz_ac, ac_code[sym], 0)
    ac_l = torch.where(nz_ac, ac_len[sym], 0)
    cbits = (ac_c << s_ac) | torch.where(nz_ac, amp[:, 1:], 0)
    cn = ac_l + torch.where(nz_ac, s_ac, 0)

    zrl_code, zrl_len = ac_code[base + 0xF0], ac_len[base + 0xF0]
    kz = torch.where(nz, run >> 4, 0)[:, 1:]
    pair = (zrl_code << zrl_len) | zrl_code
    n0 = torch.clamp(kz, max=2) * zrl_len
    b0 = torch.where(kz >= 2, pair, torch.where(kz == 1, zrl_code, 0))
    n1 = torch.clamp(kz - 2, min=0) * zrl_len
    b1 = torch.where(kz >= 3, zrl_code, 0)

    has_eob = last_nz < 63
    ebits = torch.where(has_eob, ac_code[base], 0)
    enbits = torch.where(has_eob, ac_len[base], 0)

    # Records in emission order: [DC | (zrl_pair, zrl_single, code) x 63 | EOB].
    bits = torch.cat([dbits, torch.stack([b0, b1, cbits], 2).reshape(b, 189),
                      ebits], dim=1)
    nbits = torch.cat([dnbits, torch.stack([n0, n1, cn], 2).reshape(b, 189),
                       enbits], dim=1)
    starts = torch.cumsum(nbits, dim=1) - nbits
    total = starts[:, -1] + nbits[:, -1]

    sh = starts & 31
    over = torch.clamp(sh + nbits - 32, min=0)
    hi = torch.where(over > 0, bits >> over,
                     (bits << torch.clamp(32 - sh - nbits, 0, 31)) & _M32)
    lo = torch.where(over > 0, (bits << torch.clamp(32 - over, 0, 31)) & _M32,
                     0)
    w_r = torch.clamp(starts >> 5, 0, BLOCK_WORDS - 1)
    # Disjoint bit fields: the sum equals the OR (mod 2^32, as in the
    # Pallas kernel's int32 sum for blocks past the budget).
    buf = torch.zeros((b, BLOCK_WORDS + 1), dtype=torch.int64, device=dev)
    buf.scatter_add_(1, w_r, hi)
    buf.scatter_add_(1, w_r + 1, lo)
    return _to_int32_bits(buf & _M32), total.to(torch.int32)


def pack_level1_reference(blocks, tbl, dc_code, dc_len, ac_code, ac_len):
    """Plain twin of pack_level1 (any device): the same outputs, for every
    block bit-identical to pack_pallas.pack_level1_pallas."""
    dev = blocks.device
    v = blocks.to(torch.int64)
    tb = tbl.to(torch.int64).clamp(0, 1)
    luts = [t.to(device=dev, dtype=torch.int64).reshape(-1)
            for t in (dc_code, dc_len, ac_code, ac_len)]
    parts = [_level1_chunk(v[i:i + _CHUNK], tb[i:i + _CHUNK], *luts)
             for i in range(0, v.shape[0], _CHUNK)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def pack_tables(dc_code, dc_len, ac_code, ac_len) -> torch.Tensor:
    """The four (2, 256) code/length LUT tensors -> one (2, 2, 256) int32
    tensor, [is_ac, table id, symbol] = code << 5 | length: the form kernel
    A reads. Codes have at most 16 bits and lengths at most 16, so an entry
    fits 21 bits."""
    dc, ac = ((c.to(torch.int32) << 5) | (n.to(torch.int32) & 31)
              for c, n in ((dc_code, dc_len), (ac_code, ac_len)))
    return torch.stack([dc, ac])


def _launch(blocks, tbl, packed, buf, totals) -> None:
    """Enqueue kernel A on PyTorch's current stream: prepared contiguous
    int32 CUDA tensors ((B, 64) blocks, (B,) table ids, (2, 2, 256) packed
    tables, (B, BLOCK_WORDS+1) buf and (B,) totals out), no checks and no
    allocation. Counts the launch."""
    global LAUNCHES
    dev = blocks.device
    lib = _cuda.load("pack_level1")
    with torch.cuda.device(dev):
        err = lib.jt_pack_level1(
            *(ctypes.c_void_p(t.data_ptr()) for t in
              (blocks, tbl, packed, buf, totals)),
            ctypes.c_long(blocks.shape[0]), _cuda.stream_handle(dev))
    _cuda.check("pack_level1", err)
    with _COUNT_LOCK:
        LAUNCHES += 1


def _pack_level1_cuda(blocks, tbl, dc_code, dc_len, ac_code, ac_len, packed):
    if blocks.ndim != 2 or blocks.shape[1] != 64:
        raise ValueError(f"blocks must be (B, 64), got {tuple(blocks.shape)}")
    if tbl.shape != (blocks.shape[0],):
        raise ValueError(f"tbl must be ({blocks.shape[0]},), got {tuple(tbl.shape)}")
    dev = blocks.device
    if packed is None:
        for t in (dc_code, dc_len, ac_code, ac_len):
            if t.shape != (2, 256):
                raise ValueError(
                    f"Huffman LUTs must be (2, 256), got {tuple(t.shape)}")
            if t.device != dev:
                raise ValueError(f"all pack_level1 inputs must be on {dev}")
        packed = pack_tables(dc_code, dc_len, ac_code, ac_len)
    elif packed.shape != (2, 2, 256):
        raise ValueError(
            f"packed tables must be (2, 2, 256), got {tuple(packed.shape)}")
    for t in (tbl, packed):
        if t.device != dev:
            raise ValueError(f"all pack_level1 inputs must be on {dev}")
    blocks, tbl, packed = (
        t.to(torch.int32).contiguous() for t in (blocks, tbl, packed))
    b = blocks.shape[0]
    buf = torch.empty((b, BLOCK_WORDS + 1), dtype=torch.int32, device=dev)
    totals = torch.empty((b,), dtype=torch.int32, device=dev)
    if b == 0:
        return buf, totals
    # The kernel loads coefficients and tables 16 bytes at a time.
    for name, t in (("blocks", blocks), ("packed", packed)):
        if t.data_ptr() % 16:
            raise ValueError(f"pack_level1: {name} is not 16-byte aligned")
    _launch(blocks, tbl, packed, buf, totals)
    return buf, totals


def pack_level1(blocks, tbl, dc_code, dc_len, ac_code, ac_len, packed=None):
    """(B, 64) int32 zig-zag blocks (DC already DPCM'd) + (B,) table ids
    (0 luma / 1 chroma) + the four (2, 256) code/length LUTs, all tensors on
    one device -> ((B, BLOCK_WORDS+1) int32 uint32-bit-pattern word buffers,
    (B,) int32 bit totals).

    CUDA tensors launch kernel A (csrc/pack_level1.cu), which reads the
    tables as pack_tables' words: pass them as `packed` (a tensor on the
    blocks' device) to spare their packing on every call. CPU tensors run
    the plain twin on the four LUTs. Any other device raises."""
    kind = blocks.device.type
    if kind == "cpu":
        return pack_level1_reference(blocks, tbl, dc_code, dc_len, ac_code,
                                     ac_len)
    if kind == "cuda":
        return _pack_level1_cuda(blocks, tbl, dc_code, dc_len, ac_code, ac_len,
                                 packed)
    raise ValueError(f"pack_level1: unsupported device {blocks.device}")


def pack_level2(buf, t_b, nwords: int):
    """Global assembly (level 2): shift each block's words to its bit offset
    in its segment and scatter-add them into that segment's stream.

    buf (S, B, BLOCK_WORDS+1) int32 bit patterns and t_b (S, B) bit totals,
    one row per segment -> (words (S, nwords) int64 holding uint32 values,
    total_bits (S,), ok (S,)); ok is False when a block exceeds
    BLOCK_WORDS*32 bits or a segment exceeds nwords*32.
    Indices past nwords are dropped, as pack_pallas.pack_level2's
    mode="drop" scatter does."""
    nseg, nblocks, ncols0 = buf.shape
    dev = buf.device
    t = t_b.to(torch.int64)
    off = torch.cumsum(t, dim=1) - t
    total = off[:, -1] + t[:, -1]
    base = off >> 5
    s2 = (off & 31)[:, :, None]

    w = buf.to(torch.int64) & _M32
    zero_col = torch.zeros((nseg, nblocks, 1), dtype=torch.int64, device=dev)
    buf_ext = torch.cat([w, zero_col], dim=2)
    buf_prev = torch.cat([zero_col, w], dim=2)
    contrib = (buf_ext >> s2) | torch.where(
        s2 > 0, (buf_prev << torch.clamp(32 - s2, 0, 31)) & _M32, 0)
    ncols = ncols0 + 1
    idx = base[:, :, None] + torch.arange(ncols, device=dev)
    keep = idx < nwords
    seg = torch.arange(nseg, device=dev)[:, None, None] * nwords
    flat_idx = torch.where(keep, idx + seg, 0).reshape(-1)
    words = torch.zeros(nseg * nwords, dtype=torch.int64, device=dev)
    words.index_add_(0, flat_idx, torch.where(keep, contrib, 0).reshape(-1))
    words = (words & _M32).reshape(nseg, nwords)
    ok = (t.amax(dim=1) <= BLOCK_WORDS * 32) & (total <= nwords * 32)
    return words, total, ok


def pack_scan_reference(buf, t_b, nwords: int, rst_base: int = 0):
    """Plain twin of pack_scan (any device): pack_level2, then the native
    finalize of its words on the host (bitpack.finalize_stream). The scan is exactly its bytes."""
    words, total, ok = pack_level2(buf, t_b, nwords)
    status = torch.cat([total, ok.to(total.dtype), total.new_zeros(1)]).cpu()
    if not bool(ok.all()):
        return torch.zeros(0, dtype=torch.uint8), status
    maxw = (int(status[:total.shape[0]].max()) + 31) // 32
    scan = bitpack.finalize_stream(
        words[:, :maxw].cpu().numpy().astype(np.uint32),
        status[:total.shape[0]].numpy(), rst_base)
    status[-1] = len(scan)
    return torch.tensor(np.frombuffer(scan, dtype=np.uint8)), status


def _launch_scan(buf, t_b, scratch, out, status, nwords: int,
                 rst_base: int, lib=None) -> None:
    """Enqueue the scan pass on PyTorch's current stream: contiguous (S, B,
    BLOCK_WORDS+1) int32 words and (S, B) int32 totals in, scratch of
    scan_scratch_bytes, the scan and the (2S+1,) int64 status out; no checks
    and no allocation. A CPU device takes the host build of the kernels'
    bodies that the tests pass as `lib`. Counts the launches."""
    global SCAN_LAUNCHES
    lib = lib or _cuda.load("pack_scan")
    nseg, nblocks = t_b.shape
    args = [ctypes.c_void_p(t.data_ptr()) for t in
            (buf, t_b, scratch, out, status)]
    args += [ctypes.c_long(nseg), ctypes.c_long(nblocks),
             ctypes.c_long(nwords), ctypes.c_long(rst_base)]
    dev = buf.device
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            err = lib.jt_pack_scan(*args, _cuda.stream_handle(dev))
    else:
        err = lib.jt_pack_scan(*args, None)
    _cuda.check("pack_scan", err)
    with _COUNT_LOCK:
        SCAN_LAUNCHES += _SCAN_STEPS


def scan_scratch_bytes(nseg: int, nblocks: int, nwords: int,
                       lib=None) -> int:
    """Bytes of scratch the scan pass takes for S segments of B blocks."""
    lib = lib or _cuda.load("pack_scan")
    lib.jt_pack_scan_scratch.restype = ctypes.c_long
    return int(lib.jt_pack_scan_scratch(
        ctypes.c_long(nseg), ctypes.c_long(nblocks), ctypes.c_long(nwords)))


def scan_capacity(nseg: int, nwords: int) -> int:
    """Bytes the scan can take at most: every byte of every segment's room
    stuffed, and a marker between segments."""
    return nseg * 8 * nwords + 2 * nseg


def _pack_scan_cuda(buf, t_b, nwords: int, rst_base: int, lib=None):
    if buf.ndim != 3 or buf.shape[2] != BLOCK_WORDS + 1:
        raise ValueError(
            f"buf must be (S, B, {BLOCK_WORDS + 1}), got {tuple(buf.shape)}")
    if t_b.shape != buf.shape[:2]:
        raise ValueError(
            f"t_b must be {tuple(buf.shape[:2])}, got {tuple(t_b.shape)}")
    if t_b.device != buf.device:
        raise ValueError(f"all pack_scan inputs must be on {buf.device}")
    nseg, nblocks = t_b.shape
    if nseg == 0 or nblocks == 0 or nwords < 1:
        raise ValueError(f"pack_scan: {nseg} segments of {nblocks} blocks, "
                         f"{nwords} words each")
    dev = buf.device
    buf, t_b = (t.to(torch.int32).contiguous() for t in (buf, t_b))
    scratch = torch.empty(scan_scratch_bytes(nseg, nblocks, nwords, lib),
                          dtype=torch.uint8, device=dev)
    out = torch.empty(scan_capacity(nseg, nwords), dtype=torch.uint8,
                      device=dev)
    status = torch.empty(2 * nseg + 1, dtype=torch.int64, device=dev)
    _launch_scan(buf, t_b, scratch, out, status, nwords, rst_base, lib)
    return out, status


def pack_scan(buf, t_b, nwords: int, rst_base: int = 0):
    """Level 2 and the finalize in one: kernel A's word buffers, one row per
    restart segment, to the finished entropy-coded scan.

    buf (S, B, BLOCK_WORDS+1) int32 bit patterns (a block's bits past its
    total zero, as kernel A writes them) and t_b (S, B) bit totals, each
    segment with room for nwords words -> (scan uint8, status (2S+1,) int64
    = [S bit totals, S ok flags, the scan's byte count]). The scan is the
    first `count` bytes of `scan`: each segment's bits trimmed to whole
    bytes, its last byte 1-padded, a 0x00 after every 0xFF, and FF D0+n
    between segments, n counting from rst_base mod 8: byte for byte
    native.finalize_scan of pack_level2's words. ok is pack_level2's; when a
    segment is not ok the count is 0 and `scan` holds no scan.

    CUDA tensors launch csrc/pack_scan.cu (a memset and three kernels;
    `scan` is sized for the worst case, scan_capacity, and stays on the
    card, the status with it). CPU tensors run the plain twin,
    pack_scan_reference. Any other device raises."""
    kind = buf.device.type
    if kind == "cpu":
        return pack_scan_reference(buf, t_b, nwords, rst_base)
    if kind == "cuda":
        return _pack_scan_cuda(buf, t_b, nwords, rst_base)
    raise ValueError(f"pack_scan: unsupported device {buf.device}")
