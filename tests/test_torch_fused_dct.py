"""The port's fused level shift + DCT + quantize (plain twin of kernel C)
and the ops it is built from, against the JAX package.

fused_dct_quantize_reference is held to jpeg_tpu.ops.fused.fused_dct_quantize
(interpret=True, the Pallas kernel run on the CPU) with the bound of
tests/test_fused.py: |diff| <= 1 everywhere and a nonzero diff in at most
max(8, 5e-4 * n) coefficients, since the f32 summation orders differ and can
flip a .5 boundary. The count is printed. The small ops (round_half_away,
quantize_plane, rgb_to_ycbcr_planes, downsample_plane, blockify, to_zigzag)
are held to their JAX twins exactly: tolerance 0. Kernel C itself against
this twin is in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jpeg_tpu.config import Subsampling as JS
from jpeg_tpu.ops import color as JC, fused as JF, quant as JQ
from jpeg_tpu.ops import subsample as JSub, tile as JT, zigzag as JZ

from jpeg_tpu_torch.config import Subsampling as PS
from jpeg_tpu_torch.ops import color as PC, fused as PF, quant as PQ
from jpeg_tpu_torch.ops import subsample as PSub, tile as PT, zigzag as PZ

from torch_port_util import make_image


def assert_coef_close(got, expect):
    """The bound of tests/test_fused.py."""
    diff = got.astype(np.int64) - expect.astype(np.int64)
    ndiff = int((diff != 0).sum())
    print(f"coefficients differing: {ndiff} of {diff.size}")
    assert np.abs(diff).max(initial=0) <= 1
    assert ndiff <= max(8, 5e-4 * diff.size), ndiff


@pytest.mark.parametrize("shape", [(64, 128), (8, 64), (48, 40), (128, 384)])
@pytest.mark.parametrize("quality", [10, 75, 95])
def test_fused_dct_quantize_matches_pallas(shape, quality):
    rng = np.random.default_rng(shape[0] * 1000 + shape[1] + quality)
    plane = rng.integers(0, 256, size=shape).astype(np.float32)
    qt = JQ.luma_table(quality)
    expect = np.asarray(JF.fused_dct_quantize(
        jnp.asarray(plane), jnp.asarray(qt), interpret=True))
    got = PF.fused_dct_quantize(torch.as_tensor(plane), qt)
    assert got.dtype == torch.int32 and got.shape == shape
    assert_coef_close(got.numpy(), expect)


def test_fused_dct_quantize_refuses_unaligned_planes():
    with pytest.raises(ValueError, match="multiples of 8"):
        PF.fused_dct_quantize(torch.zeros((12, 16)), JQ.luma_table(50))


def test_round_half_away_and_quantize_plane_equal():
    rng = np.random.default_rng(4)
    x = np.concatenate([np.arange(-40, 41) / 4.0,
                        rng.normal(0, 300, 2000)]).astype(np.float32)
    np.testing.assert_array_equal(
        PQ.round_half_away(torch.as_tensor(x)).numpy(),
        np.asarray(JQ.round_half_away(jnp.asarray(x))))
    coef = rng.normal(0, 200, (24, 40)).astype(np.float32)
    qt = JQ.chroma_table(60)
    got = PQ.quantize_plane(torch.as_tensor(coef), qt)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JQ.quantize_plane(jnp.asarray(coef),
                                                  jnp.asarray(qt))))


@pytest.mark.parametrize("mode", ["444", "422", "420"])
def test_colour_planes_and_downsample_equal(mode):
    img = make_image(32, 48, seed=len(mode) + 9)
    got = PC.rgb_to_ycbcr_planes(torch.as_tensor(img))
    ref = JC.rgb_to_ycbcr_planes(jnp.asarray(img))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    cb = got[1] - 128.0
    np.testing.assert_array_equal(
        PSub.downsample_plane(cb, PS(mode)).numpy(),
        np.asarray(JSub.downsample_plane(jnp.asarray(cb.numpy()), JS(mode))))


def test_blockify_and_to_zigzag_equal():
    x = np.arange(24 * 40, dtype=np.int32).reshape(24, 40)
    got = PZ.to_zigzag(PT.blockify(torch.as_tensor(x)))
    ref = JZ.to_zigzag(JT.blockify(jnp.asarray(x)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
