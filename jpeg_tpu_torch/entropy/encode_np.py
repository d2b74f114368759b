"""Vectorized host-side entropy encoder (RLE + Huffman + bit packing).

This is the stage the reference never finished: it computes symbol frequencies
(`src/huffman.c:182-222`) but assigns no codes, packs no bits and writes no
bytes (SURVEY.md, "no fwrite anywhere"). Design here is array-parallel rather
than a serial bit loop, mirroring the device-side plan (SURVEY.md §7 step 6):

  1. every (run, size) symbol and its amplitude bits are derived with NumPy
     array ops (run lengths via nonzero-index differencing, ZRL expansion via
     np.repeat) — `build_records`;
  2. per-symbol bit lengths go through an exclusive prefix sum -> bit offsets;
  3. all code+amplitude bitfields are OR-scattered into a 32-bit word array
     (each record spans at most two words since max 27 bits per record);
  4. 0xFF byte stuffing is one more vectorized repeat/scatter pass.

Restart segments are packed independently (byte-aligned, 1-padded) and joined
with RSTn markers, which is exactly what makes them a parallel seam. The same
record stream feeds `count_frequencies` for Annex-K.2 optimized tables.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def bit_size(v: np.ndarray) -> np.ndarray:
    """JPEG magnitude category: number of bits in |v| (0 for v == 0)."""
    mag = np.abs(v).astype(np.int64)
    out = np.zeros(v.shape, dtype=np.int32)
    nz = mag > 0
    out[nz] = np.floor(np.log2(mag[nz])).astype(np.int32) + 1
    return out


def _amplitude_bits(v: np.ndarray, size: np.ndarray) -> np.ndarray:
    """Amplitude field: v if v>=0 else v + 2^size - 1 (one's-complement style)."""
    v = v.astype(np.int64)
    return np.where(v >= 0, v, v + (np.int64(1) << size.astype(np.int64)) - 1).astype(
        np.int64
    )


@dataclasses.dataclass
class SymbolRecords:
    """One entry per emitted Huffman symbol, sorted by (block, in-block order)."""

    block: np.ndarray  # (S,) owning block index in scan order
    is_ac: np.ndarray  # (S,) bool: AC-class symbol
    tbl: np.ndarray  # (S,) table id 0/1
    symbol: np.ndarray  # (S,) huffman symbol 0..255
    esize: np.ndarray  # (S,) amplitude bit count
    extra: np.ndarray  # (S,) amplitude bits value


def build_records(
    blocks: np.ndarray, dc_tbl: np.ndarray, ac_tbl: np.ndarray
) -> SymbolRecords:
    """Derive the full symbol stream for an interleaved scan.

    blocks: (B, 64) int zig-zag coefficients in MCU scan order, element 0 being
    the DPCM difference. dc_tbl/ac_tbl: (B,) table ids.
    """
    blocks = np.asarray(blocks, dtype=np.int64)
    dc_tbl = np.asarray(dc_tbl, dtype=np.int64)
    ac_tbl = np.asarray(ac_tbl, dtype=np.int64)
    nb = blocks.shape[0]

    # ---- DC: one record per block -------------------------------------------
    diff = blocks[:, 0]
    dsize = bit_size(diff)
    dc = SymbolRecords(
        block=np.arange(nb, dtype=np.int64),
        is_ac=np.zeros(nb, dtype=bool),
        tbl=dc_tbl,
        symbol=dsize.astype(np.int64),
        esize=dsize.astype(np.int64),
        extra=_amplitude_bits(diff, dsize),
    )
    dc_key = np.zeros(nb, dtype=np.int64)

    # ---- AC ------------------------------------------------------------------
    a = blocks[:, 1:]  # (nb, 63): zig-zag positions 1..63 at col 0..62
    rows, cols = np.nonzero(a)
    if len(rows):
        vals = a[rows, cols]
        same = np.empty(len(rows), dtype=bool)
        same[0] = False
        same[1:] = rows[1:] == rows[:-1]
        prev = np.where(same, np.concatenate([[0], cols[:-1]]), -1)
        run = cols - prev - 1
        zrl = run >> 4  # ZRL (0xF0) symbols preceding this one
        vsize = bit_size(vals)
        sym = ((run & 15) << 4).astype(np.int64) | vsize.astype(np.int64)
        amp = _amplitude_bits(vals, vsize)

        group = zrl + 1
        gidx = np.repeat(np.arange(len(rows)), group)
        goff = np.arange(len(gidx)) - np.repeat(np.cumsum(group) - group, group)
        is_zrl = goff < zrl[gidx]
        ac = SymbolRecords(
            block=rows[gidx].astype(np.int64),
            is_ac=np.ones(len(gidx), dtype=bool),
            tbl=ac_tbl[rows][gidx],
            symbol=np.where(is_zrl, 0xF0, sym[gidx]),
            esize=np.where(is_zrl, 0, vsize[gidx]).astype(np.int64),
            extra=np.where(is_zrl, 0, amp[gidx]),
        )
        # Groups ordered by coefficient position; ZRLs precede their symbol.
        ac_key = (cols[gidx].astype(np.int64) + 1) * 8 + goff - zrl[gidx] + 4
        last_nz = np.full(nb, -1, dtype=np.int64)
        last_nz[rows] = cols  # rows sorted => last occurrence wins
    else:
        ac = SymbolRecords(*(np.zeros(0, dtype=d) for d in
                             (np.int64, bool, np.int64, np.int64, np.int64, np.int64)))
        ac_key = np.zeros(0, dtype=np.int64)
        last_nz = np.full(nb, -1, dtype=np.int64)

    # ---- EOB: blocks whose last nonzero is before position 63 ----------------
    eob_idx = np.nonzero(last_nz < 62)[0]
    eob = SymbolRecords(
        block=eob_idx.astype(np.int64),
        is_ac=np.ones(len(eob_idx), dtype=bool),
        tbl=ac_tbl[eob_idx],
        symbol=np.zeros(len(eob_idx), dtype=np.int64),
        esize=np.zeros(len(eob_idx), dtype=np.int64),
        extra=np.zeros(len(eob_idx), dtype=np.int64),
    )
    eob_key = np.full(len(eob_idx), 1 << 40, dtype=np.int64)

    # ---- Merge in (block, key) order ----------------------------------------
    def cat(f):
        return np.concatenate([getattr(x, f) for x in (dc, ac, eob)])

    key = np.concatenate([dc_key, ac_key, eob_key])
    block = cat("block")
    order = np.lexsort((key, block))
    return SymbolRecords(
        block=block[order],
        is_ac=cat("is_ac")[order],
        tbl=cat("tbl")[order],
        symbol=cat("symbol")[order],
        esize=cat("esize")[order],
        extra=cat("extra")[order],
    )


def count_frequencies(rec: SymbolRecords) -> dict:
    """(is_ac, tbl) -> (256,) symbol counts, for Annex-K.2 optimal tables."""
    out = {}
    for is_ac in (0, 1):
        for tbl in (0, 1):
            m = (rec.is_ac == bool(is_ac)) & (rec.tbl == tbl)
            out[(is_ac, tbl)] = np.bincount(rec.symbol[m], minlength=256)[:256]
    return out


def _stuff_bytes(raw: np.ndarray) -> np.ndarray:
    """Insert a 0x00 after every 0xFF (spec F.1.2.3)."""
    is_ff = raw == 0xFF
    if not is_ff.any():
        return raw
    counts = 1 + is_ff.astype(np.int64)
    out = np.zeros(int(counts.sum()), dtype=np.uint8)
    out[np.cumsum(counts) - counts] = raw
    return out  # stuffed zeros are already 0


def _pack_bits(codes: np.ndarray, nbits: np.ndarray) -> np.ndarray:
    """OR-scatter variable-length bitfields into a big-endian byte array.

    codes[k] holds nbits[k] <= 27 significant bits. The final partial byte is
    1-padded (spec F.1.2.1.1).
    """
    nbits = nbits.astype(np.int64)
    starts = np.cumsum(nbits) - nbits
    total_bits = int(nbits.sum())
    total_bytes = (total_bits + 7) // 8
    nwords = total_bytes // 4 + 2

    word = (starts >> 5).astype(np.int64)
    bit_in_word = (starts & 31).astype(np.int64)
    val64 = codes.astype(np.uint64) << (64 - bit_in_word - nbits).astype(np.uint64)
    hi = (val64 >> np.uint64(32)).astype(np.uint32)
    lo = (val64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)

    words = np.zeros(nwords, dtype=np.uint32)
    np.bitwise_or.at(words, word, hi)
    np.bitwise_or.at(words, word + 1, lo)

    out = words.astype(">u4").view(np.uint8)[:total_bytes].copy()
    rem = total_bits & 7
    if rem:
        out[-1] |= (1 << (8 - rem)) - 1
    return out


def records_to_bitfields(rec: SymbolRecords, huff: dict):
    """Symbol records -> (codes, nbits) via gatherable code/length LUTs."""
    code_lut = np.zeros((2, 2, 256), dtype=np.int64)
    len_lut = np.zeros((2, 2, 256), dtype=np.int64)
    for (is_ac, tbl), t in huff.items():
        code_lut[is_ac, tbl] = t.code
        len_lut[is_ac, tbl] = t.size
    ac = rec.is_ac.astype(np.int64)
    code = code_lut[ac, rec.tbl, rec.symbol]
    clen = len_lut[ac, rec.tbl, rec.symbol]
    bits = (code << rec.esize) | rec.extra
    nbits = clen + rec.esize
    return bits, nbits


def encode_scan(
    blocks: np.ndarray,
    dc_tbl: np.ndarray,
    ac_tbl: np.ndarray,
    huff: dict,
    restart_interval: int = 0,
    blocks_per_mcu: int = 1,
    records: SymbolRecords | None = None,
    rst_base: int = 0,
) -> bytes:
    """Pack an interleaved scan (see build_records for argument layout).
    rst_base offsets the modulo-8 RSTn indices (streaming multi-call scans)."""
    nblocks = np.asarray(blocks).shape[0]
    if nblocks == 0:
        return b""
    rec = records if records is not None else build_records(blocks, dc_tbl, ac_tbl)
    bits, nbits = records_to_bitfields(rec, huff)

    r = int(restart_interval) * int(blocks_per_mcu)
    if r == 0 or r >= nblocks:
        return _stuff_bytes(_pack_bits(bits, nbits)).tobytes()

    # Per-restart-segment packing: record ranges found by block index.
    seg_of_record = rec.block // r
    boundaries = np.searchsorted(seg_of_record, np.arange(seg_of_record[-1] + 2))
    parts = []
    nseg = int(seg_of_record[-1]) + 1
    for s in range(nseg):
        lo, hi = boundaries[s], boundaries[s + 1]
        parts.append(_stuff_bytes(_pack_bits(bits[lo:hi], nbits[lo:hi])).tobytes())
        if s != nseg - 1:
            parts.append(bytes([0xFF, 0xD0 + ((rst_base + s) & 7)]))
    return b"".join(parts)
