"""Packer constants, Huffman LUT marshalling and the host finalize of
device-packed word segments (native, and finalize_segment in NumPy)."""

from __future__ import annotations

import numpy as np

# Per-block word budget of the device packer: 9 words = 288 bits. A block
# that needs more makes level 2 report ok=False and the encoder host-packs
# (models/encoder.HOST_PACK_SPILLS counts it); typical q<=90 blocks need
# 30-150 bits.
BLOCK_WORDS = 9


def luts_from_tables(huff: dict):
    """{(is_ac, id): HuffTable} -> (dc_code, dc_len, ac_code, ac_len) stacked
    (2, 256) arrays (uint32 / int32)."""
    dc_code = np.zeros((2, 256), dtype=np.uint32)
    dc_len = np.zeros((2, 256), dtype=np.int32)
    ac_code = np.zeros((2, 256), dtype=np.uint32)
    ac_len = np.zeros((2, 256), dtype=np.int32)
    for (is_ac, tid), t in huff.items():
        if tid > 1:
            raise ValueError("device packer supports table ids 0/1")
        if is_ac:
            ac_code[tid] = t.code.astype(np.uint32)
            ac_len[tid] = t.size.astype(np.int32)
        else:
            dc_code[tid] = t.code.astype(np.uint32)
            dc_len[tid] = t.size.astype(np.int32)
    return dc_code, dc_len, ac_code, ac_len


def finalize_segment(words: np.ndarray, total_bits: int) -> np.ndarray:
    """Host side, in NumPy: one segment's big-endian words -> its scan bytes:
    trim to whole bytes, 1-pad the final byte, 0xFF-stuff."""
    from jpeg_tpu_torch.entropy import encode_np

    total_bytes = (int(total_bits) + 7) // 8
    raw = np.ascontiguousarray(words[: (total_bytes + 3) // 4]).astype(">u4")
    out = raw.view(np.uint8)[:total_bytes].copy()
    rem = int(total_bits) & 7
    if rem:
        out[-1] |= (1 << (8 - rem)) - 1
    return encode_np._stuff_bytes(out)


def finalize_stream(words: np.ndarray, totals, rst_base: int = 0) -> bytes:
    """Finalize all of a device pack's word segments into one scan: per
    segment trim/1-pad/0xFF-stuff, RSTn markers between segments, in the
    native runtime. words is the HOST (nseg, W) uint32 array; totals the
    (nseg,) bit counts."""
    from jpeg_tpu_torch.entropy import native

    words = np.asarray(words)
    if words.ndim == 1:
        words = words[None]
    totals = np.asarray(totals).astype(np.int64).reshape(-1)
    return native.finalize_scan(words, totals, rst_base)
