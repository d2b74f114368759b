"""Chroma box downsampling (encode side, fused DCT path) and decode-side
upsampling: pixel replication and libjpeg-style triangular ("fancy")
interpolation, on tensors."""

from __future__ import annotations

import torch

from jpeg_tpu_torch.config import Subsampling


def downsample_plane(plane: torch.Tensor, mode: Subsampling) -> torch.Tensor:
    """(H, W) chroma plane -> box-averaged (H/v, W/h) f32 plane. H, W must
    divide the factors.

    The taps are summed one at a time in row-major order, then divided by
    their count: the f32 order of jpeg_tpu's jnp.mean on the CPU, which
    torch's own mean does not keep for 2x2 boxes (an ulp apart)."""
    h, w = plane.shape
    fh, fw = mode.v_factor, mode.h_factor
    if fh == 1 and fw == 1:
        return plane
    if h % fh or w % fw:
        raise ValueError(f"plane {(h, w)} does not divide {mode}")
    x = plane.to(torch.float32).reshape(h // fh, fh, w // fw, fw)
    acc = x[:, 0, :, 0]
    for a in range(fh):
        for b in range(fw):
            if a or b:
                acc = acc + x[:, a, :, b]
    return acc / float(fh * fw)


def _triangle_axis(plane: torch.Tensor, axis: int) -> torch.Tensor:
    """Double one axis with libjpeg-style triangular weights: each output
    sample is (3*near + far) / 4, edges replicated."""
    x = plane.movedim(axis, 0)
    prev = torch.cat([x[:1], x[:-1]], dim=0)
    nxt = torch.cat([x[1:], x[-1:]], dim=0)
    a = (3.0 * x + prev) * 0.25
    b = (3.0 * x + nxt) * 0.25
    out = torch.stack([a, b], dim=1).reshape(2 * x.shape[0], *x.shape[1:])
    return out.movedim(0, axis)


def upsample_plane(plane: torch.Tensor, mode: Subsampling) -> torch.Tensor:
    """Nearest-neighbor chroma upsample back to luma resolution."""
    return upsample_factors(plane, mode.v_factor, mode.h_factor)


def fancy_upsample_plane(plane: torch.Tensor,
                         mode: Subsampling) -> torch.Tensor:
    """Triangular-filter chroma upsample (libjpeg's "fancy" h2v1/h2v2) back
    to luma resolution, as f32."""
    return fancy_upsample_factors(plane, mode.v_factor, mode.h_factor)


def upsample_factors(plane: torch.Tensor, fv: int, fh: int) -> torch.Tensor:
    """Nearest-neighbor upsample of a (..., H, W) plane (or stack of planes)
    by integer factors."""
    if fv > 1:
        plane = torch.repeat_interleave(plane, fv, dim=-2)
    if fh > 1:
        plane = torch.repeat_interleave(plane, fh, dim=-1)
    return plane


def fancy_upsample_factors(plane: torch.Tensor, fv: int, fh: int) -> torch.Tensor:
    """Triangular upsample of a (..., H, W) plane (or stack of planes: every
    sample depends on its own plane only) generalized to power-of-two
    factors (a 4x factor chains two doubling passes; other factors
    replicate)."""
    out = plane.to(torch.float32)
    f = fh
    while f > 1:
        if f % 2:
            return upsample_factors(out, fv, f)  # non-pow2: fall back
        out = _triangle_axis(out, -1)
        f //= 2
    f = fv
    while f > 1:
        if f % 2:
            return upsample_factors(out, f, 1)
        out = _triangle_axis(out, -2)
        f //= 2
    return out
