"""DC DPCM as a shifted subtract with restart-interval resets."""

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
