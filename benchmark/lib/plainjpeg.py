"""A plain baseline JPEG codec in PyTorch and NumPy: the benchmark's own
input maker and the reference that the port's outputs are held to.

It imports nothing of the codec under test. Every table is written out from
ITU-T T.81 (Annex K: quantization and Huffman tables; Figure 5: zig-zag) and
the JFIF colour map, and the transform is worked out here from its
definition, so a change to the port cannot change what is compared.

Encode: RGB uint8 -> the exact fixed-point transform (colour, chroma
averaged over the luma sampling's box, DCT, quantize) -> DC DPCM, reset at
every restart -> Huffman coding with the Annex K tables, or with each
image's own built by Annex K.2 (optimal_table) -> byte stuffing, each
restart interval 1-padded and followed by RSTn -> one baseline JFIF stream
at 4:2:0, 4:2:2 or 4:4:4 (SAMPLING). The transform is the one that
the port states as its contract: the composed linear map of the float32
DCT basis and JFIF matrix held in 2^15 fixed point, evaluated in exact
integer arithmetic, quantized with round half away from zero. Every step
runs as whole-tensor operations on any device (the card in a run, the CPU in
the tests); each field of the scan is placed by a prefix sum and the bits
are merged by adding fields that never overlap, so the result does not
depend on the order of the sums (place, which lib/plainprogressive's
progressive writer shares).

Decode (the reference of the decode cells): quantized coefficients ->
dequantize -> 2-D IDCT in float64 -> +128, round, clip -> libjpeg's
triangular ("fancy") chroma upsampling along each doubled axis -> the JFIF
colour map in float64 -> round, clip, crop; and the bounds within which
every decode that keeps the float32 contract lies (pixel_bounds). The
serial parser and Huffman decoder at the end of this file are for the tests
(small images only).
"""

from __future__ import annotations

import heapq
import math
import struct
import typing

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Tables (ITU-T T.81)
# ---------------------------------------------------------------------------


def _zigzag() -> np.ndarray:
    """ZIGZAG[k] = raster index (row * 8 + col) of the k-th zig-zag
    coefficient (T.81 Figure 5): anti-diagonals, alternating direction."""
    cells = sorted(((r, c) for r in range(8) for c in range(8)),
                   key=lambda rc: (rc[0] + rc[1],
                                   rc[0] if (rc[0] + rc[1]) % 2 else rc[1]))
    return np.array([r * 8 + c for r, c in cells], dtype=np.int64)


ZIGZAG = _zigzag()

# Annex K.1, Tables K.1 and K.2, in raster order.
QUANT_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
], dtype=np.int64)
QUANT_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
] + [99] * 32, dtype=np.int64)

# Annex K.3, Tables K.3-K.6: (BITS, HUFFVAL) as in a DHT segment.
DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA,
])
AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1,
    0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A,
    0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
    0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA,
])

# JFIF (BT.601 full range): ycc = RGB_TO_YCBCR @ rgb + (0, 128, 128). The
# transform's stated precision holds these entries as float32 values.
RGB_TO_YCBCR = np.array([
    [0.299, 0.587, 0.114],
    [-0.168735892, -0.331264108, 0.5],
    [0.5, -0.418687589, -0.081312411],
], dtype=np.float32)
# rgb = YCBCR_TO_RGB @ (y, cb - 128, cr - 128), in float64 here.
YCBCR_TO_RGB = np.array([
    [1.0, 0.0, 1.402],
    [1.0, -0.344136286, -0.714136286],
    [1.0, 1.772, 0.0],
], dtype=np.float64)

# Fixed point of the encode transform: the composed kernel is held as
# integers at 2^SCALE_BITS.
SCALE_BITS = 15

# Luma sampling factors (h, v) of each sampling; chroma is 1x1 in all. The
# MCU is 8h x 8v pixels: h * v luma blocks in raster order, then Cb, Cr.
SAMPLING = {"420": (2, 2), "422": (2, 1), "444": (1, 1)}


def quality_table(base: np.ndarray, quality: int) -> np.ndarray:
    """IJG quality scaling (libjpeg jcparam.c): 50 keeps the base table,
    entries clamped to [1, 255] for baseline. Raster order."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((base * scale + 50) // 100, 1, 255)


def huffman_codes(spec) -> tuple[np.ndarray, np.ndarray]:
    """(BITS, HUFFVAL) -> (code[256], length[256]) by T.81 Annex C."""
    bits, vals = spec
    code_of = np.zeros(256, dtype=np.int64)
    len_of = np.zeros(256, dtype=np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            code_of[vals[k]] = code
            len_of[vals[k]] = length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def dct_basis_f32() -> np.ndarray:
    """Orthonormal DCT-II basis D[u, x] = c(u)/2 cos((2x+1) u pi / 16),
    c(0) = 1/sqrt(2), rounded to float32 (the stated precision of the
    transform's constants), returned as float64."""
    u = np.arange(8)[:, None].astype(np.float64)
    x = np.arange(8)[None, :].astype(np.float64)
    d = 0.5 * np.cos((2.0 * x + 1.0) * u * np.pi / 16.0)
    d[0, :] *= 1.0 / np.sqrt(2.0)
    return d.astype(np.float32).astype(np.float64)


def transform_kernel(h: int = 2, v: int = 2) -> tuple[np.ndarray, np.ndarray]:
    """The encode transform of one MCU as a linear map, in float64:
    (kernel (mh * mw * 3 pixel values, (hv + 2) * 64), bias). Output
    channel blk * 64 + k is zig-zag coefficient k of the MCU's block blk
    (luma blocks in raster order, then Cb, Cr), before quantization. The
    bias is the -128 level shift of the luma DC (the chroma offsets of +128
    cancel the shift)."""
    hv = h * v
    mh, mw = 8 * v, 8 * h
    d = dct_basis_f32()
    w = np.kron(d, d)[ZIGZAG].reshape(64, 8, 8)  # (k, row, col)
    cw = RGB_TO_YCBCR.astype(np.float64)
    kern = np.zeros((mh, mw, 3, (hv + 2) * 64))
    for a in range(v):
        for b in range(h):
            blk = a * h + b
            kern[8 * a:8 * a + 8, 8 * b:8 * b + 8, :, 64 * blk:64 * blk + 64] = (
                np.einsum("kuv,c->uvck", w, cw[0]))
    for ci, row in ((hv, cw[1]), (hv + 1, cw[2])):
        full = np.einsum("kuv,c->uvck", w, row)
        kern[:, :, :, 64 * ci:64 * ci + 64] = (
            np.repeat(np.repeat(full, v, axis=0), h, axis=1) * (1.0 / hv))
    bias = np.zeros((hv + 2) * 64)
    bias[0:64 * hv:64] = -1024.0
    return kern.reshape(mh * mw * 3, -1), bias


def fixed_point_kernel(h: int = 2, v: int = 2) -> tuple[np.ndarray, np.ndarray]:
    """transform_kernel held as integers at 2^SCALE_BITS (round half to
    even), as float64 arrays of integer values."""
    kern, bias = transform_kernel(h, v)
    return np.rint(kern * (1 << SCALE_BITS)), np.rint(bias * (1 << SCALE_BITS))


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------


def pad_edges(rgb: torch.Tensor, mult_h: int, mult_w: int) -> torch.Tensor:
    """(K, H, W, 3) -> edge-replicated up to multiples of (mult_h, mult_w)."""
    _, hh, ww, _ = rgb.shape
    ph, pw = (-hh) % mult_h, (-ww) % mult_w
    if ph:
        rgb = torch.cat([rgb, rgb[:, -1:].expand(-1, ph, -1, -1)], dim=1)
    if pw:
        rgb = torch.cat([rgb, rgb[:, :, -1:].expand(-1, -1, pw, -1)], dim=2)
    return rgb


def coefficients(rgb: torch.Tensor, quality: int, precision: str = "exact",
                 subsampling: str = "420") -> torch.Tensor:
    """(K, H, W, 3) uint8 RGB -> (K, n_mcu, h * v + 2, 64) int64 quantized
    zig-zag coefficients of the scan at `subsampling`, MCU by MCU (the luma
    blocks, Cb, Cr), DC not yet differenced.

    precision "exact": the fixed-point kernel applied in float64 to integer
    pixels, so every partial sum is an integer below 2^53 and the sum is
    exact in any order; then round half away from zero of acc / (q 2^15) in
    integers. "float32" (the control): the float32 kernel applied in float32
    arithmetic (TF32 off) and the quotient rounded half away from zero in
    float32, the form a later change might be tempted to take."""
    k = rgb.shape[0]
    dev = rgb.device
    h, v = SAMPLING[subsampling]
    x = pad_edges(rgb, 8 * v, 8 * h)
    r, c = x.shape[1] // (8 * v), x.shape[2] // (8 * h)
    patches = x.reshape(k, r, 8 * v, c, 24 * h).permute(0, 1, 3, 2, 4).reshape(
        k * r * c, 192 * h * v)
    order = ZIGZAG
    qz = np.concatenate([
        np.tile(quality_table(QUANT_LUMA, quality)[order], h * v),
        np.tile(quality_table(QUANT_CHROMA, quality)[order], 2)])
    if precision == "exact":
        kern, bias = fixed_point_kernel(h, v)
        acc = patches.to(torch.float64) @ torch.as_tensor(kern, device=dev)
        acc = acc.to(torch.int64) + torch.as_tensor(bias, device=dev).to(
            torch.int64)
        d = torch.as_tensor(qz, device=dev) << SCALE_BITS
        q0 = (2 * acc.abs() + d) // (2 * d)
        q = torch.where(acc < 0, -q0, q0)
    elif precision == "float32":
        kern, bias = transform_kernel(h, v)
        acc = patches.to(torch.float32) @ torch.as_tensor(
            kern, dtype=torch.float32, device=dev)
        acc = acc + torch.as_tensor(bias, dtype=torch.float32, device=dev)
        y = acc / torch.as_tensor(qz, dtype=torch.float32, device=dev)
        q = (torch.sign(y) * torch.floor(y.abs() + 0.5)).to(torch.int64)
    else:
        raise ValueError(f"unknown precision {precision!r}")
    return q.reshape(k, r * c, h * v + 2, 64)


def _bit_length(v: torch.Tensor) -> torch.Tensor:
    """Magnitude category of each value (bits of |v|; 0 for 0), exact."""
    mag = v.abs()
    size = torch.zeros_like(mag)
    for b in range(16):
        size += (mag >= (1 << b)).to(mag.dtype)
    return size


def _code_tensors(specs, dev):
    """(BITS, HUFFVAL) tables -> (code, length) tensors (n_tables, 256) on
    `dev`; an absent table (None) is all zero."""
    luts = [huffman_codes(s) if s is not None else (np.zeros(256, np.int64),) * 2
            for s in specs]
    code = torch.as_tensor(np.stack([t[0] for t in luts]), device=dev)
    length = torch.as_tensor(np.stack([t[1] for t in luts]), device=dev)
    return code, length


ANNEX_K = (DC_LUMA, DC_CHROMA, AC_LUMA, AC_CHROMA)  # rows: DC Y, DC C, AC Y, AC C


def optimal_table(counts) -> tuple[list, list]:
    """Symbol counts (256) -> (BITS, HUFFVAL) by T.81 Annex K.2: code sizes
    from the counts (Figure K.1) with one code point reserved so that no code
    is all ones, counted by size (K.2) and cut to 16 bits (K.3), symbols in
    order of size, then value. Two least counts are merged as libjpeg's
    jpeg_gen_optimal_table merges them (of equal counts the higher value
    first, the merged node keeping the first's value), so the tables are
    cjpeg -optimize's. The walk is over at most 257 symbols."""
    heap = [(int(c), -s) for s, c in enumerate(counts) if c] + [(1, -256)]
    heapq.heapify(heap)
    under = {-s: [-s] for _, s in heap}  # node -> symbols under it
    size = dict.fromkeys(under, 0)
    while len(heap) > 1:
        f1, n1 = heapq.heappop(heap)
        f2, n2 = heapq.heappop(heap)
        for s in under[-n1] + under[-n2]:
            size[s] += 1
        under[-n1] += under.pop(-n2)
        heapq.heappush(heap, (f1 + f2, n1))
    bits = [0] * (max(size.values()) + 1)
    for n in size.values():
        bits[n] += 1
    for i in range(len(bits) - 1, 16, -1):  # Figure K.3
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    bits = (bits + [0] * 17)[:17]
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1  # the reserved code point
    vals = sorted((s for s in size if s != 256), key=lambda s: (size[s], s))
    return bits[1:], vals


def _dc_differences(dc: torch.Tensor, resets: torch.Tensor) -> torch.Tensor:
    """(K, n, ...) DC values of one component in scan order -> each minus
    the one before it, or minus 0 where `resets` (broadcast over K) marks
    the first of a restart interval."""
    prev = torch.cat([torch.zeros_like(dc[:, :1]), dc[:, :-1]], dim=1)
    return dc - prev.masked_fill(resets, 0)


def amplitude(v: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """The `size` extra bits of v (T.81 F.1.2.1): v itself, or for v < 0
    v + 2^size - 1."""
    return torch.where(v >= 0, v, v + (1 << size) - 1)


class Fields(typing.NamedTuple):
    """Bit fields of entropy-coded segments, one entry each: segment `seg`,
    order `key` in the scan (keys of one segment all below those of the
    next; equal keys only for equal fields), the Huffman code of `sym` in
    table `tab` (-1: no code) and then `elen` extra bits `extra`."""

    seg: torch.Tensor
    key: torch.Tensor
    tab: torch.Tensor
    sym: torch.Tensor
    extra: torch.Tensor
    elen: torch.Tensor


def histograms(tab: torch.Tensor, sym: torch.Tensor, n_tables: int) -> np.ndarray:
    """(n_tables, 256) counts of each table's symbols, on the host."""
    on = tab >= 0
    return torch.bincount(tab[on] * 256 + sym[on], minlength=256 * n_tables
                          ).reshape(n_tables, 256).cpu().numpy()


def place(f: Fields, code: torch.Tensor, length: torch.Tensor,
          n_seg: int) -> list[bytes]:
    """Bit fields -> the n_seg segments' bytes: each segment's fields in the
    order of their keys, from a byte of its own, 1-padded to the byte and
    byte-stuffed (a 0x00 after every 0xFF). Each field is placed by a prefix
    sum of the lengths and the bits are merged by adding fields that never
    overlap, so the result does not depend on the order of the sums."""
    dev = code.device
    order = torch.argsort(f.key)
    seg, tab, sym, extra, elen = (x[order] for x in (f.seg, f.tab, f.sym,
                                                     f.extra, f.elen))
    has = tab >= 0
    t = tab.clamp(min=0)
    ln = torch.where(has, length[t, sym], 0) + elen
    val = (torch.where(has, code[t, sym], 0) << elen) | extra
    seg_bits = torch.zeros(n_seg, dtype=torch.int64, device=dev).index_add_(
        0, seg, ln)
    seg_bytes = (seg_bits + 7) // 8
    seg_base = 8 * (torch.cumsum(seg_bytes, 0) - seg_bytes)  # bit offset
    off = (seg_base[seg] + torch.cumsum(ln, 0) - ln
           - (torch.cumsum(seg_bits, 0) - seg_bits)[seg])
    pad = 8 * seg_bytes - seg_bits
    pad_seg = torch.nonzero(pad > 0, as_tuple=True)[0]
    off = torch.cat([off, seg_base[pad_seg] + seg_bits[pad_seg]])
    val = torch.cat([val, (1 << pad[pad_seg]) - 1])
    ln = torch.cat([ln, pad[pad_seg]])
    keep = ln > 0
    off, val, ln = off[keep], val[keep], ln[keep]

    # Merge the fields into 32-bit big-endian words (a field <= 32 bits
    # spans at most two words; fields never overlap, so adding is OR-ing).
    total_bytes = int(seg_bytes.sum())
    words = torch.zeros(total_bytes // 4 + 2, dtype=torch.int64, device=dev)
    word = off >> 5
    end = (off & 31) + ln
    over = end > 32
    hi = torch.where(over, val >> (end - 32).clamp(min=0),
                     val << (32 - end).clamp(min=0))
    lo = torch.where(over, (val << (64 - end).clamp(max=63)) & 0xFFFFFFFF,
                     torch.zeros_like(val))
    words.index_add_(0, word, hi)
    words.index_add_(0, word + 1, lo)
    shifts = torch.tensor([24, 16, 8, 0], device=dev)
    raw = ((words[:, None] >> shifts) & 0xFF).reshape(-1)[:total_bytes]

    # Byte stuffing: a 0x00 after every 0xFF.
    ff = (raw == 0xFF).to(torch.int64)
    step = 1 + ff
    pos = torch.cumsum(step, 0) - step
    out = torch.zeros(int(step.sum()), dtype=torch.uint8, device=dev)
    out[pos] = raw.to(torch.uint8)
    ends = torch.cumsum(seg_bytes, 0)
    stuffed_ends = torch.cumsum(step, 0)[ends - 1]
    host = out.cpu().numpy().tobytes()
    cuts = [0] + stuffed_ends.cpu().tolist()
    return [host[a:b] for a, b in zip(cuts[:-1], cuts[1:])]


def _sequential_fields(coefs: torch.Tensor, restart_interval: int
                       ) -> tuple[Fields, torch.Tensor, int]:
    """The fields of K baseline interleaved scans (tables as ANNEX_K's rows),
    the image of each field, and the number of segments (restart intervals
    of all images)."""
    k, n_mcu, nbm = coefs.shape[:3]
    hv = nbm - 2
    dev = coefs.device
    blocks = coefs.reshape(k * n_mcu * nbm, 64).clone()
    # DC differences per image and component, in scan order.
    per_seg = restart_interval or n_mcu
    n_seg = -(-n_mcu // per_seg)
    mcu = torch.arange(n_mcu, device=dev)
    starts = mcu % per_seg == 0
    dc = coefs[..., 0]
    first_luma = (starts[:, None] & (torch.arange(hv, device=dev) == 0))
    dy = _dc_differences(dc[:, :, :hv].reshape(k, -1), first_luma.reshape(-1))
    dc_ = _dc_differences(dc[:, :, hv:], starts[:, None])
    blocks[:, 0] = torch.cat([dy.reshape(k, n_mcu, hv), dc_], dim=2).reshape(-1)
    nb = blocks.shape[0]
    chroma = (torch.arange(nb, device=dev) % nbm >= hv).to(torch.int64)

    dval = blocks[:, 0]
    dsize = _bit_length(dval)

    # AC fields: per nonzero its ZRLs (run // 16 of them) and its symbol.
    ac = blocks[:, 1:]
    rows, cols = torch.nonzero(ac, as_tuple=True)
    vals = ac[rows, cols]
    first = torch.ones_like(rows, dtype=torch.bool)
    first[1:] = rows[1:] != rows[:-1]
    prev = torch.where(first, torch.full_like(cols, -1),
                       torch.cat([cols[:1], cols[:-1]]))
    run = cols - prev - 1
    zrl = run >> 4
    vsize = _bit_length(vals)
    zidx = torch.repeat_interleave(torch.arange(rows.numel(), device=dev), zrl)
    # EOB unless the block's last nonzero is coefficient 63.
    last = torch.full((nb,), -1, dtype=torch.int64, device=dev).scatter_reduce(
        0, rows, cols, reduce="amax")
    eob = torch.nonzero(last < 62, as_tuple=True)[0]

    # Order in a block: DC (0), then per coefficient k its ZRLs (2k) and its
    # symbol (2k + 1), then the EOB (128).
    n_z, n_e = zidx.numel(), eob.numel()
    zero = torch.zeros(n_z + n_e, dtype=torch.int64, device=dev)
    owner = torch.cat([torch.arange(nb, device=dev), rows[zidx], rows, eob])
    gm = owner // nbm  # MCU of each field's block, all images
    f = Fields(
        seg=gm // n_mcu * n_seg + gm % n_mcu // per_seg,
        key=owner * 256 + torch.cat([
            torch.zeros(nb, dtype=torch.int64, device=dev),
            2 * cols[zidx] + 2, 2 * cols + 3,
            torch.full((n_e,), 128, dtype=torch.int64, device=dev)]),
        tab=torch.cat([chroma, 2 + chroma[owner[nb:]]]),
        sym=torch.cat([dsize, torch.full((n_z,), 0xF0, device=dev),
                       ((run & 15) << 4) | vsize, zero[:n_e]]),
        extra=torch.cat([amplitude(dval, dsize), zero[:n_z],
                         amplitude(vals, vsize), zero[:n_e]]),
        elen=torch.cat([dsize, zero[:n_z], vsize, zero[:n_e]]))
    return f, gm // n_mcu, k * n_seg


def entropy_code(coefs: torch.Tensor, restart_interval: int = 0,
                 optimize: bool = False) -> tuple[list, list[bytes]]:
    """(K, n_mcu, h * v + 2, 64) quantized coefficients -> (each image's
    Huffman tables as (BITS, HUFFVAL): DC Y, DC C, AC Y, AC C; the K
    entropy-coded scans, one baseline interleaved scan each).

    The tables are Annex K's, or with `optimize` each image's own, built
    from its symbol counts by Annex K.2 (one luma and one chroma table of
    each class, as libjpeg's optimize pass builds them). With a restart
    interval of r MCUs every r MCUs start an interval: the DC predictors
    restart at 0, and each interval's bits are 1-padded to the byte and
    byte-stuffed, then followed by RSTn (n = interval number mod 8), but
    for the last interval, which may be short."""
    k = coefs.shape[0]
    f, img, n_seg = _sequential_fields(coefs, restart_interval)
    if optimize:
        f = f._replace(tab=img * 4 + f.tab)
        specs = [optimal_table(c) for c in histograms(f.tab, f.sym, 4 * k)]
        tables = [specs[4 * i:4 * i + 4] for i in range(k)]
    else:
        specs = ANNEX_K
        tables = [list(ANNEX_K)] * k
    parts = place(f, *_code_tensors(specs, coefs.device), n_seg)
    per = n_seg // k
    return tables, [b"".join(p + bytes((0xFF, 0xD0 + j % 8))
                             for j, p in enumerate(parts[i:i + per - 1]))
                    + parts[i + per - 1] for i in range(0, n_seg, per)]


def scans(coefs: torch.Tensor, restart_interval: int = 0) -> list[bytes]:
    """The K entropy-coded scans of entropy_code with the Annex K tables."""
    return entropy_code(coefs, restart_interval)[1]


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload


def frame_header(width: int, height: int, quality: int,
                 subsampling: str = "420", sof: int = 0xC0) -> bytes:
    """SOI, APP0 (JFIF 1.01), DQT (tables 0 and 1, zig-zag order) and the
    frame header SOFn (8-bit, 3 components, Y at the sampling's h x v and
    Cb, Cr 1x1; SOF0 baseline, SOF2 progressive)."""
    h, v = SAMPLING[subsampling]
    out = [b"\xff\xd8", _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for tid, base in ((0, QUANT_LUMA), (1, QUANT_CHROMA)):
        t = quality_table(base, quality)[ZIGZAG]
        out.append(_segment(0xDB, bytes([tid]) + bytes(int(v) for v in t)))
    out.append(_segment(sof, struct.pack(">BHHB", 8, height, width, 3)
                        + bytes([1, h << 4 | v, 0, 2, 0x11, 1, 3, 0x11, 1])))
    return b"".join(out)


def dht(table_class: int, table_id: int, spec) -> bytes:
    """One DHT segment holding one table (BITS, HUFFVAL)."""
    bits, vals = spec
    return _segment(0xC4, bytes([table_class << 4 | table_id]) + bytes(bits)
                    + bytes(vals))


def sos(components, ss: int = 0, se: int = 63, ah: int = 0,
        al: int = 0) -> bytes:
    """SOS of a scan of `components`, [(id, DC table, AC table)]."""
    return _segment(0xDA, bytes([len(components)])
                    + b"".join(bytes([c, td << 4 | ta]) for c, td, ta in components)
                    + bytes([ss, se, ah << 4 | al]))


def jfif_header(width: int, height: int, quality: int,
                subsampling: str = "420", restart_interval: int = 0,
                tables=ANNEX_K) -> bytes:
    """frame_header with SOF0, DHT (the four tables, as ANNEX_K's rows:
    Annex K's unless given), DRI where the restart interval is above 0, and
    SOS of the interleaved scan."""
    dc_y, dc_c, ac_y, ac_c = tables
    out = [frame_header(width, height, quality, subsampling),
           dht(0, 0, dc_y), dht(1, 0, ac_y), dht(0, 1, dc_c), dht(1, 1, ac_c)]
    if restart_interval:
        out.append(_segment(0xDD, struct.pack(">H", restart_interval)))
    out.append(sos([(1, 0, 0), (2, 1, 1), (3, 1, 1)]))
    return b"".join(out)


def streams(coefs: torch.Tensor, height: int, width: int, quality: int,
            subsampling: str = "420", restart_interval: int = 0,
            optimize: bool = False) -> list[tuple[bytes, int]]:
    """(K, n_mcu, h * v + 2, 64) quantized coefficients of K images of one
    shape -> K baseline JFIF streams, each with its entropy-coded bytes."""
    tables, coded = entropy_code(coefs, restart_interval, optimize)
    return [(jfif_header(width, height, quality, subsampling,
                         restart_interval, t) + s + b"\xff\xd9", len(s))
            for t, s in zip(tables, coded)]


def encode(rgb: torch.Tensor, quality: int, subsampling: str = "420",
           restart_interval: int = 0) -> list[bytes]:
    """(K, H, W, 3) uint8 RGB of one shape -> K baseline JFIF streams."""
    hh, ww = rgb.shape[1:3]
    coefs = coefficients(rgb, quality, subsampling=subsampling)
    return [s for s, _ in streams(coefs, hh, ww, quality, subsampling,
                                  restart_interval)]


# ---------------------------------------------------------------------------
# Decode reference: coefficients -> pixels
# ---------------------------------------------------------------------------


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 stored mantissa bits, round to
    nearest even), as the card's tensor cores read their inputs."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def _samples(coefs: torch.Tensor, quality: int, precision: str) -> torch.Tensor:
    """(n_mcu, h * v + 2, 64) quantized zig-zag coefficients (DC absolute)
    -> (n_mcu, h * v + 2, 8, 8) IDCT values + 128, before rounding, in
    float64.

    precision "float64": the reference. "tf32" (the control): float32
    matrix products whose operands are rounded to TF32, the step below the
    float32 that the configuration states for the IDCT."""
    dev = coefs.device
    qz = np.stack([quality_table(QUANT_LUMA, quality)[ZIGZAG]]
                  * (coefs.shape[1] - 2)
                  + [quality_table(QUANT_CHROMA, quality)[ZIGZAG]] * 2)
    deq = coefs.to(torch.float64) * torch.as_tensor(qz, dtype=torch.float64,
                                                    device=dev)
    raster = torch.zeros_like(deq)
    raster[..., torch.as_tensor(ZIGZAG, device=dev)] = deq
    blk = raster.reshape(*coefs.shape[:2], 8, 8)
    if precision == "float64":
        d = torch.as_tensor(_dct_basis_f64(), device=dev)
        return d.T @ blk @ d + 128.0
    if precision == "tf32":
        d32 = tf32(torch.as_tensor(dct_basis_f32(), dtype=torch.float32,
                                   device=dev))
        sp = tf32(d32.T @ tf32(blk.to(torch.float32))) @ d32
        return sp.to(torch.float64) + 128.0
    raise ValueError(f"unknown precision {precision!r}")


def _planes(s: torch.Tensor, mr: int, mc: int, subsampling: str,
            fancy: bool):
    """(n_mcu, h * v + 2, 8, 8) samples of mr x mc MCUs -> Y at full size,
    Cb and Cr upsampled to it."""
    h, v = SAMPLING[subsampling]
    s = s.reshape(mr, mc, h * v + 2, 8, 8)
    y = s[:, :, :h * v].reshape(mr, mc, v, h, 8, 8).permute(
        0, 2, 4, 1, 3, 5).reshape(8 * v * mr, 8 * h * mc)
    cb = s[:, :, -2].permute(0, 2, 1, 3).reshape(8 * mr, 8 * mc)
    cr = s[:, :, -1].permute(0, 2, 1, 3).reshape(8 * mr, 8 * mc)
    return y, _upsample(cb, h, v, fancy), _upsample(cr, h, v, fancy)


def _fancy(width: int) -> bool:
    # libjpeg jdsample.c: triangular upsampling (h2v2, h2v1) where the
    # chroma's own width, half the image's, exceeds two samples,
    # replication otherwise.
    return (width + 1) // 2 > 2


def _mcus(height: int, width: int, h: int, v: int) -> tuple[int, int]:
    """MCU rows and columns of an image with luma sampling h x v, edges
    padded."""
    return -(-height // (8 * v)), -(-width // (8 * h))


def pixels(coefs: torch.Tensor, quality: int, height: int, width: int,
           precision: str = "float64",
           subsampling: str = "420") -> torch.Tensor:
    """(n_mcu, h * v + 2, 64) quantized zig-zag coefficients of one image
    at `subsampling` (DC absolute) -> (height, width, 3) uint8 RGB, as a
    baseline decoder with fancy upsampling gives them: IDCT, round half to
    even, clip, upsample, colour map, round, clip, crop. The colour map
    runs in the IDCT's precision ("float64", or with TF32 operands for
    "tf32")."""
    dev = coefs.device
    mr, mc = _mcus(height, width, *SAMPLING[subsampling])
    samples = torch.clamp(torch.round(_samples(coefs, quality, precision)),
                          0.0, 255.0)
    y, cb, cr = _planes(samples, mr, mc, subsampling, _fancy(width))
    m = torch.as_tensor(YCBCR_TO_RGB, device=dev)
    ycc = torch.stack([y, cb - 128.0, cr - 128.0], dim=-1)
    if precision == "tf32":
        rgb = (tf32(ycc.to(torch.float32)) @ tf32(m.to(torch.float32)).T).to(
            torch.float64)
    else:
        rgb = ycc @ m.T
    out = torch.clamp(torch.round(rgb), 0.0, 255.0).to(torch.uint8)
    return out[:height, :width].contiguous()


# Half-width of the band around a rounding boundary in which a float32
# result may round either way: the port's float32 sums are off the exact
# value by ~1e-4 of a level at most (64-term chains of values below 2^11).
TIE_BAND = 0.01


def pixel_bounds(coefs: torch.Tensor, quality: int, height: int, width: int,
                 band: float = TIE_BAND, subsampling: str = "420"
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The (lo, hi) uint8 RGB images that bound every decode of these
    coefficients that keeps the float32 contract: each sample rounds the
    exact IDCT value, either way only where that value lies within `band`
    of a .5 boundary; each RGB value rounds the exact colour map of samples
    so chosen, either way only within `band` of a boundary. The colour map
    is monotone in every sample (and the triangular filter's weights are
    positive), so the bounds come from the lowest and highest samples."""
    mr, mc = _mcus(height, width, *SAMPLING[subsampling])
    x = _samples(coefs, quality, "float64")
    near = (x - torch.floor(x) - 0.5).abs() < band
    lo = torch.where(near, torch.floor(x), torch.round(x)).clamp(0.0, 255.0)
    hi = torch.where(near, torch.floor(x) + 1.0, torch.round(x)).clamp(0.0, 255.0)
    fancy = _fancy(width)
    ylo, cblo, crlo = _planes(lo, mr, mc, subsampling, fancy)
    yhi, cbhi, crhi = _planes(hi, mr, mc, subsampling, fancy)
    m = YCBCR_TO_RGB
    vmin, vmax = [], []
    for row in m:
        a, b = [ylo * row[0]], [yhi * row[0]]
        for c_lo, c_hi, k in ((cblo, cbhi, row[1]), (crlo, crhi, row[2])):
            if k >= 0:
                a.append(k * (c_lo - 128.0))
                b.append(k * (c_hi - 128.0))
            else:
                a.append(k * (c_hi - 128.0))
                b.append(k * (c_lo - 128.0))
        vmin.append(sum(a))
        vmax.append(sum(b))
    vmin = torch.stack(vmin, dim=-1)
    vmax = torch.stack(vmax, dim=-1)
    out_lo = torch.ceil(vmin - band - 0.5).clamp(0.0, 255.0).to(torch.uint8)
    out_hi = torch.floor(vmax + band + 0.5).clamp(0.0, 255.0).to(torch.uint8)
    return (out_lo[:height, :width].contiguous(),
            out_hi[:height, :width].contiguous())


def _dct_basis_f64() -> np.ndarray:
    u = np.arange(8)[:, None].astype(np.float64)
    x = np.arange(8)[None, :].astype(np.float64)
    d = 0.5 * np.cos((2.0 * x + 1.0) * u * np.pi / 16.0)
    d[0, :] *= 1.0 / math.sqrt(2.0)
    return d


def _triangle(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Double one axis: output pair (3 near + far) / 4 with the far sample
    the previous and the next one, edges replicated (libjpeg h2v1/h2v2)."""
    x = x.movedim(dim, 0)
    prev = torch.cat([x[:1], x[:-1]])
    nxt = torch.cat([x[1:], x[-1:]])
    out = torch.stack([(3 * x + prev) / 4, (3 * x + nxt) / 4], dim=1)
    return out.reshape(2 * x.shape[0], *x.shape[1:]).movedim(0, dim)


def _upsample(p: torch.Tensor, h: int, v: int, fancy: bool) -> torch.Tensor:
    """A chroma plane to the luma grid, as libjpeg's jdsample.c does: h2v2
    (4:2:0) and h2v1 (4:2:2) by the triangle along each doubled axis, or by
    replication where not fancy; 1x1 (4:4:4) as it is."""
    if not fancy:
        return p.repeat_interleave(v, 0).repeat_interleave(h, 1)
    if h == 2:
        p = _triangle(p, 1)
    if v == 2:
        p = _triangle(p, 0)
    return p


# ---------------------------------------------------------------------------
# Parse and serial Huffman decode (tests: small images only)
# ---------------------------------------------------------------------------


def parse(data: bytes) -> dict:
    """Baseline JFIF -> {"width", "height", "components": [(id, h, v, tq)],
    "qtables": {id: zig-zag list}, "htables": {(class, id): (bits, vals)},
    "scan_components": [(id, td, ta)], "restart": n, "scan": bytes}. Raises
    ValueError on anything else than one baseline sequential scan."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("no SOI")
    out = {"qtables": {}, "htables": {}, "restart": 0}
    i = 2
    while i < len(data):
        if data[i] != 0xFF:
            raise ValueError(f"marker expected at {i}")
        marker = data[i + 1]
        if marker == 0xFF:
            i += 1
            continue
        (n,) = struct.unpack(">H", data[i + 2:i + 4])
        body = data[i + 4:i + 2 + n]
        if marker == 0xDB:
            j = 0
            while j < len(body):
                if body[j] >> 4:
                    raise ValueError("16-bit quantization table")
                out["qtables"][body[j] & 15] = list(body[j + 1:j + 65])
                j += 65
        elif marker == 0xC4:
            j = 0
            while j < len(body):
                bits = list(body[j + 1:j + 17])
                vals = list(body[j + 17:j + 17 + sum(bits)])
                out["htables"][(body[j] >> 4, body[j] & 15)] = (bits, vals)
                j += 17 + sum(bits)
        elif marker == 0xC0:
            _, hh, ww, nc = struct.unpack(">BHHB", body[:6])
            out["height"], out["width"] = hh, ww
            out["components"] = [
                (body[6 + 3 * c], body[7 + 3 * c] >> 4, body[7 + 3 * c] & 15,
                 body[8 + 3 * c]) for c in range(nc)]
        elif marker in (0xC1, 0xC2, 0xC3) or 0xC5 <= marker <= 0xCF and (
                marker not in (0xC8, 0xCC)):
            raise ValueError(f"not baseline: SOF{marker - 0xC0}")
        elif marker == 0xDD:
            (out["restart"],) = struct.unpack(">H", body[:2])
        elif marker == 0xDA:
            ns = body[0]
            out["scan_components"] = [
                (body[1 + 2 * c], body[2 + 2 * c] >> 4, body[2 + 2 * c] & 15)
                for c in range(ns)]
            start = i + 2 + n
            # Inside the scan 0xFF is followed by 0x00 or a restart marker.
            end = data.find(b"\xff\xd9", start)
            if end == -1:
                raise ValueError("no EOI")
            out["scan"] = data[start:end]
            return out
        i += 2 + n
    raise ValueError("no SOS")


def _scan_intervals(raw: bytes) -> list[bytes]:
    """An entropy-coded scan -> its restart intervals, unstuffed. Raises
    ValueError on a marker other than RSTn inside the scan, or an RSTn
    whose n is not the interval's number mod 8."""
    out, cur, j = [], bytearray(), 0
    while j < len(raw):
        if raw[j] != 0xFF:
            cur.append(raw[j])
            j += 1
            continue
        nxt = raw[j + 1] if j + 1 < len(raw) else -1
        if nxt == 0x00:
            cur.append(0xFF)
        elif 0xD0 <= nxt <= 0xD7 and nxt - 0xD0 == len(out) % 8:
            out.append(bytes(cur))
            cur = bytearray()
        else:
            raise ValueError(f"0xFF {nxt:#04x} at byte {j} of the scan "
                             f"(RST{len(out) % 8} or a stuffed 0 expected)")
        j += 2
    out.append(bytes(cur))
    return out


def decode_coefficients(data: bytes) -> tuple[dict, np.ndarray]:
    """A plain serial Huffman decode of a baseline interleaved stream at
    4:2:0, 4:2:2 or 4:4:4, with or without restart intervals -> (parse(data),
    (n_mcu, h * v + 2, 64) int64 zig-zag coefficients, DC absolute). Checks
    that every interval holds its MCUs and only 1-bits of padding after
    them, that RSTn counts n = 0..7 in turn, and resets the DC predictors
    at each. Raises ValueError on any other stream."""
    info = parse(data)
    comps = info["components"]
    factors = [(h, v) for _, h, v, _ in comps]
    if len(comps) != 3 or factors[1:] != [(1, 1), (1, 1)] or (
            factors[0] not in SAMPLING.values()):
        raise ValueError(f"sampling {factors} is not decoded here")
    h, v = factors[0]
    hh, ww = info["height"], info["width"]
    mr, mc = _mcus(hh, ww, h, v)
    n_mcu = mr * mc
    per = info["restart"] or n_mcu
    intervals = _scan_intervals(info["scan"])
    if len(intervals) != -(-n_mcu // per):
        raise ValueError(f"{len(intervals)} restart intervals where "
                         f"{-(-n_mcu // per)} are due")

    def table(cls, tid):
        code, length = huffman_codes(info["htables"][(cls, tid)])
        return {(int(length[s]), int(code[s])): s
                for s in range(256) if length[s]}

    tabs = {}
    for cid, td, ta in info["scan_components"]:
        tabs[cid] = (table(0, td), table(1, ta))

    bits, pos = np.zeros(0, dtype=np.uint8), 0

    def symbol(t):
        nonlocal pos
        code = 0
        for ln in range(1, 17):
            code = (code << 1) | int(bits[pos])
            pos += 1
            if (ln, code) in t:
                return t[(ln, code)]
        raise ValueError("bad Huffman code")

    def receive(s):
        nonlocal pos
        v = 0
        for _ in range(s):
            v = (v << 1) | int(bits[pos])
            pos += 1
        return v - (1 << s) + 1 if s and v < (1 << (s - 1)) else v

    out = np.zeros((n_mcu, h * v + 2, 64), dtype=np.int64)
    order = [comps[0][0]] * (h * v) + [comps[1][0], comps[2][0]]
    for n, seg in enumerate(intervals):
        bits = np.unpackbits(np.frombuffer(seg, dtype=np.uint8))
        pos = 0
        pred = {}
        for m in range(n * per, min((n + 1) * per, n_mcu)):
            for b, cid in enumerate(order):
                dct, act = tabs[cid]
                s = symbol(dct)
                pred[cid] = pred.get(cid, 0) + receive(s)
                out[m, b, 0] = pred[cid]
                k = 1
                while k < 64:
                    rs = symbol(act)
                    r, s = rs >> 4, rs & 15
                    if s == 0:
                        if r != 15:
                            break
                        k += 16
                        continue
                    k += r
                    out[m, b, k] = receive(s)
                    k += 1
        if len(bits) - pos >= 8 or not bits[pos:].all():
            raise ValueError(f"interval {n}: {len(bits) - pos} bits after "
                             "its last MCU that are not 1-padding")
    return info, out
