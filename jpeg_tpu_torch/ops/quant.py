"""Quantization tables as pure functions of quality (the IJG scaling in
jpeg_tpu_torch.tables). Quantization itself is exact integer arithmetic
inside ops/mcu_conv; dequantization is folded into ops/fused."""

from __future__ import annotations

import numpy as np

from jpeg_tpu_torch import tables


def luma_table(quality: int) -> np.ndarray:
    return tables.quality_scaled_table(tables.QUANT_LUMA, quality)


def chroma_table(quality: int) -> np.ndarray:
    return tables.quality_scaled_table(tables.QUANT_CHROMA, quality)
