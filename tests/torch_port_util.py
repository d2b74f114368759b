"""Shared inputs for the PyTorch port's tests (tests/test_torch_*.py).

Images and coefficient blocks come from numpy seeds, never from files, so
the tests run anywhere the repository does."""

from __future__ import annotations

import numpy as np
import pytest


def make_image(h, w, seed=0):
    """Gradient + uniform noise in [-10, 10] (bench.make_image's formula)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    grad = np.stack(
        [xx * 255 / w, yy * 255 / h, (xx + yy) * 128 / (h + w)], axis=-1
    )
    noise = rng.integers(-10, 11, size=(h, w, 3))
    return np.clip(grad + noise, 0, 255).astype(np.uint8)


def random_blocks(rng, n, density):
    """(n, 64) int32 zig-zag blocks: AC nonzero with probability `density`,
    values in [-200, 200]; DC differences in [-800, 800)."""
    blocks = np.zeros((n, 64), dtype=np.int32)
    mask = rng.random((n, 64)) < density
    blocks[mask] = rng.integers(-200, 201, size=mask.sum())
    blocks[:, 0] = rng.integers(-800, 800, size=n)
    return blocks


def require_cuda():
    """Skip the calling test unless a CUDA device is present (decided when
    the test runs, never at import or collection)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
