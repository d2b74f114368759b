"""jpeg_tpu_torch.decode(device="cpu") against the JAX package's decoder
with its Pallas IDCT, jpeg_tpu.decode(jpg, use_pallas=True,
entropy="native") (interpret mode on the CPU).

Tolerance: the two IDCTs sum in different f32 orders and the colour maps
associate differently (explicit per-channel chain vs a 3-term matmul), so a
sample landing on a .5 boundary may round either way. Pixels may differ by
at most 1 level, in at most 0.5% of samples; the count is printed. The plain
IDCT is held to fused_dequant_idct(interpret=True) at atol 1e-2 (the bound
of tests/test_fused.py). Kernel B against this plain twin is in
test_torch_cuda.py."""

import io

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

import jpeg_tpu
from jpeg_tpu import tables as JT
from jpeg_tpu.io import jfif as JJ
from jpeg_tpu.ops import fused as JF, quant as JQ

import jpeg_tpu_torch
from jpeg_tpu_torch.ops import fused as PF

from torch_port_util import adversarial_idct_planes, make_image


def _assert_close_to_reference(jpg):
    ref = jpeg_tpu.decode(jpg, use_pallas=True, entropy="native")
    got = jpeg_tpu_torch.decode(jpg, device="cpu")
    assert got.shape == ref.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    ndiff = int((diff != 0).sum())
    print(f"samples differing: {ndiff} of {diff.size}, max {diff.max()}")
    assert diff.max() <= 1
    assert ndiff <= 0.005 * diff.size
    return got


@pytest.mark.parametrize("mode,shape,restart", [
    ("420", (48, 64), 0), ("422", (37, 53), 0), ("444", (37, 53), 5),
    ("420", (37, 53), 3),
])
def test_decode_port_streams(mode, shape, restart):
    img = make_image(*shape, seed=2)
    jpg = jpeg_tpu_torch.encode(img, quality=85, subsampling=mode,
                                restart_interval=restart, device="cpu")
    _assert_close_to_reference(jpg)


@pytest.mark.parametrize("subsampling", [2, 1, 0])  # PIL: 4:2:0, 4:2:2, 4:4:4
def test_decode_pil_streams(subsampling):
    rng = np.random.default_rng(subsampling)
    img = np.clip(make_image(40, 56, seed=9).astype(np.int32)
                  + rng.integers(-30, 31, size=(40, 56, 3)), 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=80, subsampling=subsampling)
    got = _assert_close_to_reference(buf.getvalue())
    assert got.shape == (40, 56, 3)


def test_decode_pil_stream_with_restart_markers():
    img = make_image(64, 96, seed=4)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=70, restart_marker_blocks=3)
    jpg = buf.getvalue()
    assert JJ.parse_jpeg(jpg).restart_interval > 0
    _assert_close_to_reference(jpg)


@pytest.mark.parametrize("shape", [(64, 128), (8, 64), (48, 40)])
def test_plain_idct_matches_pallas(shape):
    rng = np.random.default_rng(shape[0])
    coeffs = rng.integers(-100, 100, size=shape).astype(np.int32)
    for qt in (JT.QUANT_LUMA, JQ.chroma_table(90)):
        ref = np.asarray(JF.fused_dequant_idct(jnp.asarray(coeffs),
                                               jnp.asarray(qt), interpret=True))
        got = PF.fused_dequant_idct(torch.as_tensor(coeffs), qt)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-2)


@pytest.mark.parametrize(
    "case", adversarial_idct_planes(), ids=lambda c: c[0])
def test_plain_idct_matches_pallas_adversarial(case):
    """The smallest plane, ragged widths, DC only, and single coefficients
    of +-2047 under a table of 255s (samples near 1e5)."""
    _, coeffs, qt = case
    ref = np.asarray(JF.fused_dequant_idct(jnp.asarray(coeffs),
                                           jnp.asarray(qt), interpret=True))
    got = PF.fused_dequant_idct(torch.as_tensor(coeffs), qt)
    assert got.shape == coeffs.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-2)

