"""Huffman table machinery: canonical code derivation (ITU-T T.81 Annex C) and
per-image optimal table construction (Annex K.2).

The Annex K.2 algorithm is the one the reference attempts in
`src/huffman.c:76-180` and never finishes: its value-sorting loop at
huffman.c:172-179 is infinite (verified — SURVEY.md component 10), and even the
earlier stages never feed a bitstream writer because none exists. This module
is written from the spec, not from that code.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from jpeg_tpu_torch import tables


@dataclasses.dataclass(frozen=True)
class HuffTable:
    """One Huffman table, both in DHT form (bits/vals) and as encode/decode LUTs."""

    bits: np.ndarray  # (16,) number of codes per length 1..16
    vals: np.ndarray  # (sum(bits),) symbols in canonical order
    code: np.ndarray  # (256,) code word per symbol (0 where unused)
    size: np.ndarray  # (256,) code length per symbol (0 where unused)

    @property
    def max_symbol_bits(self) -> int:
        return int(self.size.max())


def build_table(bits: np.ndarray, vals: np.ndarray) -> HuffTable:
    """Derive canonical codes from a DHT (BITS, HUFFVAL) spec — Annex C.1/C.2."""
    bits = np.asarray(bits, dtype=np.int32)
    vals = np.asarray(vals, dtype=np.int32)
    assert bits.shape == (16,)
    assert int(bits.sum()) == len(vals)

    # HUFFSIZE: code length per canonical index (Figure C.1).
    huffsize = np.repeat(np.arange(1, 17, dtype=np.int32), bits)
    # HUFFCODE (Figure C.2): consecutive codes within a length, doubled between
    # lengths. Vectorized: code[k] = (prefix of counts) pattern — do the simple
    # sequential derivation; tables are tiny (<=256 entries).
    huffcode = np.zeros(len(vals), dtype=np.int64)
    code = 0
    prev_size = huffsize[0] if len(huffsize) else 0
    for k in range(len(huffsize)):
        code <<= int(huffsize[k] - prev_size)
        prev_size = huffsize[k]
        huffcode[k] = code
        code += 1

    code_lut = np.zeros(256, dtype=np.int64)
    size_lut = np.zeros(256, dtype=np.int32)
    code_lut[vals] = huffcode
    size_lut[vals] = huffsize
    return HuffTable(bits=bits, vals=vals, code=code_lut, size=size_lut)


def optimal_table(freq_in: np.ndarray) -> HuffTable:
    """Per-image optimal Huffman table from symbol frequencies — Annex K.2.

    freq_in: (256,) counts. Returns a spec-legal table (max code length 16, no
    all-ones code thanks to the reserved pseudo-symbol 256).
    """
    freq = np.zeros(257, dtype=np.int64)
    freq[:256] = np.asarray(freq_in, dtype=np.int64)
    if not (freq[:256] > 0).any():  # unused table class (e.g. gray chroma)
        return build_table(np.zeros(16, np.int32), np.zeros(0, np.int32))
    freq[256] = 1  # reserved: guarantees no real symbol gets the all-1s code

    codesize = np.zeros(257, dtype=np.int32)
    others = np.full(257, -1, dtype=np.int32)

    # Figure K.1: repeatedly merge the two least-frequent live entries, v1 being
    # the least-frequent with the HIGHEST symbol value on ties, v2 the next.
    while True:
        live = np.nonzero(freq > 0)[0]
        if len(live) <= 1:
            break
        lf = freq[live]
        m1 = lf.min()
        cands = live[lf == m1]
        v1 = int(cands[-1])  # largest value among minima
        rest = live[live != v1]
        rf = freq[rest]
        m2 = rf.min()
        v2 = int(rest[rf == m2][-1])

        freq[v1] += freq[v2]
        freq[v2] = 0
        codesize[v1] += 1
        while others[v1] != -1:
            v1 = int(others[v1])
            codesize[v1] += 1
        others[v1] = v2
        codesize[v2] += 1
        while others[v2] != -1:
            v2 = int(others[v2])
            codesize[v2] += 1

    # Figure K.2: count codes per size (sizes can exceed 16 here).
    max_size = int(codesize.max()) if codesize.max() > 0 else 0
    bits_long = np.zeros(max(33, max_size + 1), dtype=np.int32)
    for i in range(257):
        if codesize[i] > 0:
            bits_long[codesize[i]] += 1

    # Figure K.3: limit code lengths to 16 by moving pairs up.
    for i in range(len(bits_long) - 1, 16, -1):
        while bits_long[i] > 0:
            j = i - 2
            while bits_long[j] == 0:
                j -= 1
            bits_long[i] -= 2
            bits_long[i - 1] += 1
            bits_long[j + 1] += 2
            bits_long[j] -= 1
    # Remove the reserved symbol's code from the longest nonzero length.
    i = 16
    while bits_long[i] == 0:
        i -= 1
    bits_long[i] -= 1
    bits16 = bits_long[1:17].copy()

    # Figure K.4: sort symbols by code size, then by symbol value — the loop
    # that is infinite in the reference (huffman.c:172-179). Vectorized: a
    # stable argsort over (codesize, symbol) restricted to real symbols.
    real = np.nonzero(codesize[:256] > 0)[0]
    order = real[np.argsort(codesize[real].astype(np.int64) * 1000 + real, kind="stable")]
    return build_table(bits16, order.astype(np.int32))


def standard_tables() -> dict:
    """The four Annex K.3 typical tables keyed by (is_ac, table_id)."""
    return {
        (0, 0): build_table(tables.DC_LUMA_BITS, tables.DC_LUMA_VALS),
        (0, 1): build_table(tables.DC_CHROMA_BITS, tables.DC_CHROMA_VALS),
        (1, 0): build_table(tables.AC_LUMA_BITS, tables.AC_LUMA_VALS),
        (1, 1): build_table(tables.AC_CHROMA_BITS, tables.AC_CHROMA_VALS),
    }
