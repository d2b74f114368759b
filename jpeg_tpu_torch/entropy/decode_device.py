"""Sparse-coefficient decode backend ("sparse"): the C++ runtime resolves the
whole entropy layer on the host in one walk (absolute DCs + nonzero ACs as
(value, zig-zag position) pairs: native.sparse_scan), packs them into one
uint32 payload of about 2 bytes per nonzero coefficient, and the device
densifies it back into (B, 64) zig-zag blocks. One upload instead of three
dense int32 coefficient grids (128 bytes per block).

Counterpart of the sparse half of jpeg_tpu/entropy/decode_device.py. The
host side (buckets, packers, build_payload and its callers) is that module's
code with the imports rewritten; the payload is byte-identical. The device
side is written for a GPU: each element's block comes from a binary search
over the per-block end offsets and the values are placed with one indexed
store, where the reference builds (Sp, 64) one-hot contributions and sums
them by prefix differences because its target has no cheap scatter. The
reference's other densify formulations and its per-segment and indexed
device Huffman decoders are not ported (ROADMAP.md, "Not ported" and
Queue 1 item 8).

torch has no uint32 arithmetic, so the payload travels as int32 and is
widened once to int64 and masked to 32 bits; every shift after that works on
non-negative values.
"""

from __future__ import annotations

import numpy as np
import torch

from jpeg_tpu_torch.entropy import native


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
