"""JPEG symbol statistics over zig-zag blocks, on tensors.

Counterpart of jpeg_tpu/ops/symbols.py (XLA code there, plain torch here):
every (run, size) symbol count comes from vectorized ops, with zero-run
lengths from a cumulative max over nonzero positions, reduced with
index_add_. Integer results are identical to the JAX package's.
"""

from __future__ import annotations

import torch


def bit_size(v: torch.Tensor) -> torch.Tensor:
    """JPEG magnitude category (0..11): bits in |v|, read from the f32
    exponent field (the int -> f32 convert is exact below 2^24)."""
    mag = torch.abs(v).to(torch.int32)
    exp = (mag.to(torch.float32).view(torch.int32) >> 23) - 126
    return torch.where(mag > 0, exp, 0)


def ac_run_lengths(zz: torch.Tensor):
    """Per-coefficient zero-run info for (..., 64) zig-zag blocks.

    Returns (nz, run, last_nz):
      nz[..., k]    bool, position k in 1..63 is nonzero (0 forced False)
      run[..., k]   zeros between this nonzero and the previous one
      last_nz[...]  index of the last nonzero AC position (0 if none)
    """
    idx = torch.arange(64, dtype=torch.int32, device=zz.device)
    nz = (zz != 0) & (idx > 0)
    markers = torch.where(nz, idx, 0)
    cmax = torch.cummax(markers, dim=-1).values
    prev = torch.cat([torch.zeros_like(cmax[..., :1]), cmax[..., :-1]], dim=-1)
    run = idx - prev - 1
    return nz, run, cmax[..., -1]


def symbol_histogram(zz: torch.Tensor):
    """(N, 64) zig-zag blocks (DC already DPCM'd) -> (dc_hist, ac_hist),
    each a (256,) int32 count of one table class's symbols."""
    zz = zz.to(torch.int32)
    dev = zz.device
    dsize = bit_size(zz[:, 0]).to(torch.int64)
    dc_hist = torch.zeros(256, dtype=torch.int64, device=dev)
    dc_hist.index_add_(0, dsize, torch.ones_like(dsize))

    nz, run, last_nz = ac_run_lengths(zz)
    sym = ((run % 16) << 4) | bit_size(zz)
    ac_hist = torch.zeros(256, dtype=torch.int64, device=dev)
    ac_hist.index_add_(0, torch.where(nz, sym, 0).reshape(-1).to(torch.int64),
                       nz.reshape(-1).to(torch.int64))
    # ZRL (0xF0): run // 16 emissions per nonzero; EOB (0x00): blocks whose
    # last nonzero is before position 63.
    ac_hist[0xF0] += torch.where(nz, run >> 4, 0).sum()
    ac_hist[0x00] += (last_nz < 63).sum()
    return dc_hist.to(torch.int32), ac_hist.to(torch.int32)


def bits_per_block(zz: torch.Tensor, dc_len_lut: torch.Tensor,
                   ac_len_lut: torch.Tensor) -> torch.Tensor:
    """Exact entropy-coded bit count per block for one table class;
    dc_len_lut / ac_len_lut are (256,) Huffman code lengths."""
    zz = zz.to(torch.int32)
    dc_len = torch.as_tensor(dc_len_lut, device=zz.device).to(torch.int32)
    ac_len = torch.as_tensor(ac_len_lut, device=zz.device).to(torch.int32)
    dsize = bit_size(zz[:, 0])
    bits = dc_len[dsize.long()] + dsize

    nz, run, last_nz = ac_run_lengths(zz)
    size = bit_size(zz)
    sym = ((run % 16) << 4) | size
    per_coef = torch.where(
        nz, ac_len[sym.long()] + size + (run >> 4) * ac_len[0xF0], 0)
    bits = bits + per_coef.sum(dim=-1, dtype=torch.int32)
    return bits + torch.where(last_nz < 63, ac_len[0x00], 0)
