"""Constant tables for baseline JFIF JPEG.

All data here comes from the public ITU-T T.81 spec (Annex K) — the same data the
reference stages in its dead `src/headers/tables.h` (see SURVEY.md component 11) and
`src/quantise.c:8-25` / `src/zig_zag.c:6-15`, re-derived from the spec rather than
copied. Quality scaling follows the libjpeg formula the reference documents in
`src/Notes:25-33` and implements at `src/quantise.c:74-86`, but as a *pure function*
(the reference mutates its global tables in place, which double-scales on a second
encode in the same process — a latent bug we fix by construction).
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Annex K.1 — default quantization tables (raster order, 8x8).
# ---------------------------------------------------------------------------

QUANT_LUMA = np.array(
    [
        [16, 11, 10, 16, 24, 40, 51, 61],
        [12, 12, 14, 19, 26, 58, 60, 55],
        [14, 13, 16, 24, 40, 57, 69, 56],
        [14, 17, 22, 29, 51, 87, 80, 62],
        [18, 22, 37, 56, 68, 109, 103, 77],
        [24, 35, 55, 64, 81, 104, 113, 92],
        [49, 64, 78, 87, 103, 121, 120, 101],
        [72, 92, 95, 98, 112, 100, 103, 99],
    ],
    dtype=np.int32,
)

QUANT_CHROMA = np.array(
    [
        [17, 18, 24, 47, 99, 99, 99, 99],
        [18, 21, 26, 66, 99, 99, 99, 99],
        [24, 26, 56, 99, 99, 99, 99, 99],
        [47, 66, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
    ],
    dtype=np.int32,
)


def quality_scaled_table(base: np.ndarray, quality: int) -> np.ndarray:
    """Scale a base quant table by the IJG quality factor (pure function).

    quality in [1, 100]; 50 returns the base table unchanged, 100 gives all-ones.
    Values are clamped to [1, 255] (baseline JPEG stores 8-bit quant values; the
    reference omits both clamps — SURVEY.md component 7).
    """
    q = int(np.clip(quality, 1, 100))
    s = 5000 // q if q < 50 else 200 - 2 * q
    t = (base.astype(np.int64) * s + 50) // 100
    return np.clip(t, 1, 255).astype(np.int32)


# ---------------------------------------------------------------------------
# Zig-zag scan (ITU-T T.81 Figure 5). ZIGZAG_ORDER[k] = raster index of the k-th
# coefficient in zig-zag order; equivalently a permutation raster -> zigzag.
# ---------------------------------------------------------------------------


def _make_zigzag_order() -> np.ndarray:
    order = np.empty(64, dtype=np.int32)
    r = c = 0
    for k in range(64):
        order[k] = r * 8 + c
        if (r + c) % 2 == 0:  # moving "up-right"
            if c == 7:
                r += 1
            elif r == 0:
                c += 1
            else:
                r -= 1
                c += 1
        else:  # moving "down-left"
            if r == 7:
                c += 1
            elif c == 0:
                r += 1
            else:
                r += 1
                c -= 1
    return order


ZIGZAG_ORDER = _make_zigzag_order()
# Inverse permutation: INV_ZIGZAG[raster_index] = zigzag position.
INV_ZIGZAG = np.argsort(ZIGZAG_ORDER).astype(np.int32)


# ---------------------------------------------------------------------------
# Annex K.3 — typical Huffman tables, given as (BITS, HUFFVAL) exactly as they
# appear in a DHT segment. BITS[i] = number of codes of length i+1 (16 entries).
# ---------------------------------------------------------------------------

DC_LUMA_BITS = np.array(
    [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], dtype=np.int32
)
DC_LUMA_VALS = np.arange(12, dtype=np.int32)

DC_CHROMA_BITS = np.array(
    [0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], dtype=np.int32
)
DC_CHROMA_VALS = np.arange(12, dtype=np.int32)

AC_LUMA_BITS = np.array(
    [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], dtype=np.int32
)
AC_LUMA_VALS = np.array(
    [
        0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12,
        0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
        0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
        0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0,
        0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16,
        0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
        0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
        0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49,
        0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
        0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
        0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
        0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
        0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98,
        0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7,
        0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
        0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5,
        0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4,
        0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
        0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA,
        0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
        0xF9, 0xFA,
    ],
    dtype=np.int32,
)

AC_CHROMA_BITS = np.array(
    [0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], dtype=np.int32
)
AC_CHROMA_VALS = np.array(
    [
        0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21,
        0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71,
        0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
        0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0,
        0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34,
        0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
        0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38,
        0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48,
        0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
        0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
        0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
        0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
        0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96,
        0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
        0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
        0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3,
        0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2,
        0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
        0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9,
        0xEA, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
        0xF9, 0xFA,
    ],
    dtype=np.int32,
)

# Sanity: BITS must sum to len(VALS) for each table.
assert int(DC_LUMA_BITS.sum()) == len(DC_LUMA_VALS)
assert int(DC_CHROMA_BITS.sum()) == len(DC_CHROMA_VALS)
assert int(AC_LUMA_BITS.sum()) == len(AC_LUMA_VALS) == 162
assert int(AC_CHROMA_BITS.sum()) == len(AC_CHROMA_VALS) == 162
