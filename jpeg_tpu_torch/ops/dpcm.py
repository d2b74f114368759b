"""DC DPCM as a shifted subtract with restart-interval resets, and its\ninverse, a cumulative sum per restart segment."""

from __future__ import annotations

import torch


def dpcm(dc: torch.Tensor, restart_interval: int = 0) -> torch.Tensor:
    """(N,) DC values in MCU scan order -> (N,) DPCM differences.

    Position k encodes dc[k] - pred, where pred is dc[k-1], or 0 at k=0 and at
    every restart-segment start (k % restart_interval == 0).
    """
    prev = torch.cat([torch.zeros((1,), dtype=dc.dtype, device=dc.device),
                      dc[:-1]])
    if restart_interval:
        idx = torch.arange(dc.shape[0], device=dc.device)
        prev = torch.where(idx % restart_interval == 0,
                           torch.zeros_like(prev), prev)
    return dc - prev


def undpcm(diffs: torch.Tensor, restart_interval: int = 0) -> torch.Tensor:
    """Inverse of dpcm: (N,) DPCM differences -> (N,) DC values, a
    cumulative sum that starts again at every restart-segment start (the
    decoder's predictor reset). Keeps the input's dtype."""
    if not restart_interval:
        return torch.cumsum(diffs, 0, dtype=diffs.dtype)
    n = diffs.shape[0]
    r = int(restart_interval)
    pad = (-n) % r
    seg = torch.cat([diffs, diffs.new_zeros(pad)]).reshape(-1, r)
    return torch.cumsum(seg, 1, dtype=diffs.dtype).reshape(-1)[:n]
