"""Zig-zag reorder as one index gather over the trailing axis."""

from __future__ import annotations

import torch

from jpeg_tpu_torch import tables


def to_zigzag(blocks: torch.Tensor) -> torch.Tensor:
    """(..., 8, 8) -> (..., 64) in zig-zag order."""
    order = torch.as_tensor(tables.ZIGZAG_ORDER, dtype=torch.long,
                            device=blocks.device)
    return blocks.reshape(*blocks.shape[:-2], 64)[..., order]


def from_zigzag(zz: torch.Tensor) -> torch.Tensor:
    """(..., 64) zig-zag order -> (..., 8, 8) raster blocks."""
    inv = torch.as_tensor(tables.INV_ZIGZAG, dtype=torch.long, device=zz.device)
    return zz[..., inv].reshape(*zz.shape[:-1], 8, 8)
