"""YCbCr <-> RGB (BT.601 full-range, JFIF) constants, the encode-side planes
of the fused DCT path, the decode-side colour map, and the CLI's two helpers
(rgb_to_ycbcr for --grayscale, cmyk_to_rgb for CMYK output)."""

from __future__ import annotations

import numpy as np
import torch

# y/cb/cr = RGB_TO_YCBCR @ [r, g, b] + [0, 128, 128]
RGB_TO_YCBCR = np.array(
    [
        [0.299, 0.587, 0.114],
        [-0.168735892, -0.331264108, 0.5],
        [0.5, -0.418687589, -0.081312411],
    ],
    dtype=np.float32,
)
YCBCR_OFFSET = np.array([0.0, 128.0, 128.0], dtype=np.float32)

# Inverse map: [r, g, b] = YCBCR_TO_RGB @ [y, cb - 128, cr - 128]
YCBCR_TO_RGB = np.array(
    [
        [1.0, 0.0, 1.402],
        [1.0, -0.344136286, -0.714136286],
        [1.0, 1.772, 0.0],
    ],
    dtype=np.float32,
)


def rgb_to_ycbcr(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) float/uint8 RGB in [0,255] -> (..., 3) float32 YCbCr in
    [0,255]: each channel one f32 multiply-add chain over (r, g, b) in the
    order of its RGB_TO_YCBCR row, then the offset. jpeg_tpu's form is an
    XLA dot whose summation order XLA picks per channel, so the two agree
    to f32 rounding (an ulp of 255 is 1.5e-5), not always bit for bit."""
    x = rgb.to(torch.float32)
    out = []
    for row, off in zip(RGB_TO_YCBCR, YCBCR_OFFSET):
        acc = x[..., 0] * float(row[0])
        acc = acc + x[..., 1] * float(row[1])
        acc = acc + x[..., 2] * float(row[2])
        out.append(acc + float(off))
    return torch.stack(out, dim=-1)


def cmyk_to_rgb(cmyk) -> np.ndarray:
    """(..., 4) uint8 CMYK (PIL-mode samples, as decode() returns for Adobe
    4-component streams) -> (..., 3) uint8 RGB, bit-exact with PIL's
    Image.convert("RGB"): channel = round((255-C) * (255-K) / 255).
    NumPy on the host: it runs on decoded pixels (the CLI's output paths)."""
    a = np.asarray(cmyk).astype(np.int32)
    if a.shape[-1] != 4:
        raise ValueError(f"expected (..., 4) CMYK, got {a.shape}")
    inv = 255 - a
    rgb = (inv[..., :3] * inv[..., 3:4] + 127) // 255
    return rgb.astype(np.uint8)


def rgb_to_ycbcr_planes(rgb: torch.Tensor):
    """(H, W, 3) RGB in [0,255] -> three (H, W) float32 planes (y, cb, cr).

    The FMA-chain form of jpeg_tpu's rgb_to_ycbcr_planes: the same f32
    constants, multiplied and summed left to right in the same order."""
    x = rgb.to(torch.float32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418687589 * g - 0.081312411 * b + 128.0
    return y, cb, cr


def ycbcr_to_rgb(ycc: torch.Tensor, clip: bool = True) -> torch.Tensor:
    """(..., 3) YCbCr in [0,255] -> (..., 3) float32 RGB, clipped to
    [0, 255] unless `clip` is False (the RGB decode passes False: it rounds
    and clips itself; YCCK clips here, before the complement).

    Each output channel is one explicit f32 multiply-add chain over
    (y, cb - 128, cr - 128) in the order of its YCBCR_TO_RGB row, so the
    association is fixed on every device rather than left to a matmul."""
    x = ycc.to(torch.float32)
    terms = [x[..., c] - float(YCBCR_OFFSET[c]) for c in range(3)]
    out = []
    for row in YCBCR_TO_RGB:
        acc = terms[0] * float(row[0])
        acc = acc + terms[1] * float(row[1])
        acc = acc + terms[2] * float(row[2])
        out.append(acc)
    rgb = torch.stack(out, dim=-1)
    return torch.clamp(rgb, 0.0, 255.0) if clip else rgb
