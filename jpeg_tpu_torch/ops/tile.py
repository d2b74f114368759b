"""Padding and 8x8 block tiling as tensor reshapes/permutes."""

from __future__ import annotations

import torch


def pad_to_multiple(img: torch.Tensor, mult_h: int, mult_w: int) -> torch.Tensor:
    """Edge-replicate pad an (H, W) or (H, W, C) tensor's two leading
    spatial dims up to multiples of (mult_h, mult_w). Works for any dtype
    (uint8 included), on any device."""
    h, w = img.shape[0], img.shape[1]
    ph = (-h) % mult_h
    pw = (-w) % mult_w
    if ph:
        img = torch.cat([img, img[-1:].expand(ph, *img.shape[1:])], dim=0)
    if pw:
        last = img[:, -1:]
        img = torch.cat([img, last.expand(img.shape[0], pw, *img.shape[2:])],
                        dim=1)
    return img


def pad_batch_to_multiple(batch: torch.Tensor, mult_h: int,
                          mult_w: int) -> torch.Tensor:
    """pad_to_multiple for a (K, H, W, C) batch: every image edge-replicated
    up to multiples of (mult_h, mult_w), as one tensor."""
    ph = (-batch.shape[1]) % mult_h
    pw = (-batch.shape[2]) % mult_w
    if ph:
        batch = torch.cat([batch, batch[:, -1:].expand(-1, ph, -1, -1)], dim=1)
    if pw:
        batch = torch.cat(
            [batch, batch[:, :, -1:].expand(-1, -1, pw, -1)], dim=2)
    return batch


def blockify(plane: torch.Tensor) -> torch.Tensor:
    """(H, W) -> (H//8, W//8, 8, 8) grid of blocks. H, W must be multiples of 8."""
    h, w = plane.shape
    if h % 8 or w % 8:
        raise ValueError(f"plane {(h, w)} is not a multiple of 8")
    return plane.reshape(h // 8, 8, w // 8, 8).permute(0, 2, 1, 3)


def blocks_scan_order(plane: torch.Tensor, v: int = 1,
                      h: int = 1) -> torch.Tensor:
    """(H, W) plane -> (H*W/64, 64) row-major flattened 8x8 blocks in MCU
    scan order, as ONE permute (no gather): blocks are grouped v x h per
    MCU and emitted MCU-raster-major, v-by-h raster within each MCU (spec
    A.2.3). v = h = 1 gives plain raster block order."""
    hh, ww = plane.shape
    hb, wb = hh // 8, ww // 8
    if hh % 8 or ww % 8 or hb % v or wb % h:
        raise ValueError(f"plane {(hh, ww)} does not tile into {v}x{h} MCUs")
    x = plane.reshape(hb // v, v, 8, wb // h, h, 8)
    return x.permute(0, 3, 1, 4, 2, 5).reshape(hb * wb, 64)


def plane_from_scan_blocks(flat: torch.Tensor, hb: int, wb: int,
                           v: int = 1, h: int = 1) -> torch.Tensor:
    """Inverse of blocks_scan_order: (hb*wb, 64) scan-order flattened blocks
    -> (hb*8, wb*8) plane."""
    x = flat.reshape(hb // v, wb // h, v, h, 8, 8)
    return x.permute(0, 2, 4, 1, 3, 5).reshape(hb * 8, wb * 8)


def unblockify(blocks: torch.Tensor) -> torch.Tensor:
    """(Hb, Wb, 8, 8) -> (Hb*8, Wb*8)."""
    hb, wb = blocks.shape[0], blocks.shape[1]
    return blocks.permute(0, 2, 1, 3).reshape(hb * 8, wb * 8)
