"""The port's exact integer transform and DC DPCM against the JAX package.

jpeg_tpu_torch.ops.mcu_conv._mcu_transform_int (one f32 torch.matmul of
integer operands, integer combine and quantize) must be BIT-IDENTICAL to
jpeg_tpu.ops.mcu_conv._mcu_transform_int (bf16 dot with an f32 accumulator)
on the same pixels and tables: tolerance 0. So must dpcm."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jpeg_tpu.config import Subsampling as JS
from jpeg_tpu.ops import dpcm as JD, mcu_conv as JM, quant as JQ

from jpeg_tpu_torch.config import Subsampling as PS
from jpeg_tpu_torch.ops import dpcm as PD, mcu_conv as PM

from torch_port_util import make_image


@pytest.mark.parametrize("mode", ["444", "422", "420"])
@pytest.mark.parametrize("quality", [1, 50, 75, 95, 100])
def test_mcu_transform_int_bit_identical(mode, quality):
    rng = np.random.default_rng(quality * 7 + len(mode))
    # Uniform noise drives every coefficient range; the gradient image the
    # quantizer's common case.
    imgs = [rng.integers(0, 256, size=(32, 48, 3)).astype(np.uint8),
            make_image(32, 48, seed=quality)]
    qy, qc = JQ.luma_table(quality), JQ.chroma_table(quality)
    for img in imgs:
        ref = np.asarray(JM._mcu_transform_int(
            jnp.asarray(img), jnp.asarray(qy), jnp.asarray(qc), JS(mode)))
        got = PM._mcu_transform_int(torch.as_tensor(img), qy, qc, PS(mode))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)


def test_transform_refuses_tf32_precision():
    img = torch.zeros((16, 16, 3), dtype=torch.uint8)
    qy, qc = JQ.luma_table(75), JQ.chroma_table(75)
    old = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError, match="tf32|highest"):
            PM._mcu_transform_int(img, qy, qc, PS("420"))
    finally:
        torch.set_float32_matmul_precision(old)


@pytest.mark.parametrize("restart", [0, 1, 3, 7])
def test_dpcm_bit_identical(restart):
    rng = np.random.default_rng(restart)
    dc = rng.integers(-1024, 1024, size=50).astype(np.int32)
    ref = np.asarray(JD.dpcm(jnp.asarray(dc), restart))
    got = PD.dpcm(torch.as_tensor(dc), restart)
    np.testing.assert_array_equal(got.numpy(), ref)
