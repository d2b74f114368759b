"""Tensor ops of the port: transform, packers, IDCT, colour."""

from jpeg_tpu_torch.ops import (  # noqa: F401
    color, dct, dpcm, quant, subsample, tile, zigzag)
