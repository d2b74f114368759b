"""Quantization tables as pure functions of quality (the IJG scaling in
jpeg_tpu_torch.tables), and the float quantizer and dequantizer in block
and image layout. The default encode quantizes in exact integer arithmetic
inside ops/mcu_conv; the full-size default decode dequantizes inside
ops/fused (kernel B2), the scaled decode and decode(use_pallas=False) on the
CPU with dequantize below."""

from __future__ import annotations

import numpy as np
import torch

from jpeg_tpu_torch import tables


def luma_table(quality: int) -> np.ndarray:
    return tables.quality_scaled_table(tables.QUANT_LUMA, quality)


def chroma_table(quality: int) -> np.ndarray:
    return tables.quality_scaled_table(tables.QUANT_CHROMA, quality)


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """Round to nearest, ties away from zero (the canonical pipeline rounding)."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def quantize(coeffs: torch.Tensor, qtable) -> torch.Tensor:
    """(..., 8, 8) f32 coefficients / broadcastable (8, 8) table, true
    division, round half away -> int32."""
    q = torch.as_tensor(qtable, dtype=torch.float32, device=coeffs.device)
    return round_half_away(coeffs.to(torch.float32) / q).to(torch.int32)


def quantize_plane(coeffs: torch.Tensor, qtable) -> torch.Tensor:
    """Image-layout (H, W) f32 coefficient plane / (8, 8) table tiled over
    blocks, true division, round half away -> (H, W) int32."""
    h, w = coeffs.shape
    q = torch.as_tensor(qtable, dtype=torch.float32, device=coeffs.device)
    q = q.reshape(8, 8).repeat(h // 8, w // 8)
    return round_half_away(coeffs / q).to(torch.int32)


def dequantize(qcoeffs: torch.Tensor, qtable) -> torch.Tensor:
    """(..., 8, 8) quantized raster blocks * (8, 8) table -> f32."""
    q = torch.as_tensor(qtable, dtype=torch.float32, device=qcoeffs.device)
    return qcoeffs.to(torch.float32) * q


def dequantize_plane(qcoeffs: torch.Tensor, qtable) -> torch.Tensor:
    """Image-layout (H, W) quantized plane * (8, 8) table tiled over
    blocks -> f32."""
    h, w = qcoeffs.shape
    q = torch.as_tensor(qtable, dtype=torch.float32, device=qcoeffs.device)
    q = q.reshape(8, 8).repeat(h // 8, w // 8)
    return qcoeffs.to(torch.float32) * q
