"""The port's transform-layer functions and decode(use_pallas=False)
against their counterparts in the JAX package, on the CPU.

Inputs come from numpy seeds at small sizes (a few hundred blocks, planes
up to 64x96). Tolerances:
  - exact (assert_array_equal): the layout permutes, the quantizer and
    dequantizer, undpcm, the upsamplers on integer planes, zigzag_qdiv,
    finalize_segment, mcu_transform (against jpeg_tpu's exact integer
    transform, the form its accelerator path runs);
  - 1e-4 absolute: the DCT products (f32 sums whose order may differ from
    XLA's) on values of pixel magnitude, where an f32 ulp is 3e-5; the
    (64, 64) matrix and the conv kernel, rounded from the same float64;
  - ycbcr_to_rgb: equal where its default clip bites, 1e-4 elsewhere (the
    port's per-channel chain against XLA's 3-term dot);
  - decode(use_pallas=False): ROADMAP.md's decode contract against
    jpeg_tpu.decode, +-1 in at most 0.5% of samples.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import jpeg_tpu
from jpeg_tpu.config import Subsampling as JS
from jpeg_tpu.ops import (
    bitpack as JB, color as JC, dct as JD, dpcm as JDP, mcu_conv as JM,
    quant as JQ, subsample as JSU, tile as JT)

import jpeg_tpu_torch
from jpeg_tpu_torch.config import Subsampling as PS
from jpeg_tpu_torch.entropy import native as PN
from jpeg_tpu_torch.models import decoder as PDEC
from jpeg_tpu_torch.ops import (
    bitpack as PB, color as PC, dct as PD, dpcm as PDP, fused as PF,
    mcu_conv as PM, quant as PQ, subsample as PSU, tile as PT)

import torch_port_fixtures as port_fixtures
from torch_port_util import jax_exact_transform, make_image  # noqa: F401

MODES = ["444", "422", "420"]
DCT_ATOL = 1e-4


def _j(x):
    """A jax result as a writable numpy array."""
    return np.array(x)


# --- layout, quantizer, DPCM, upsampling: exact -----------------------------


@pytest.mark.parametrize("v,h", [(1, 1), (1, 2), (2, 1), (2, 2)])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_blocks_scan_order_round_trip(v, h, dtype):
    rng = np.random.default_rng(10 * v + h)
    plane = rng.integers(-500, 500, size=(64, 96)).astype(dtype)
    got = PT.blocks_scan_order(torch.as_tensor(plane), v, h)
    ref = _j(JT.blocks_scan_order(jnp.asarray(plane), v, h))
    np.testing.assert_array_equal(got.numpy(), ref)
    back = PT.plane_from_scan_blocks(got, 8, 12, v, h)
    np.testing.assert_array_equal(
        back.numpy(), _j(JT.plane_from_scan_blocks(jnp.asarray(ref), 8, 12,
                                                   v, h)))
    np.testing.assert_array_equal(back.numpy(), plane)


def test_blocks_scan_order_refuses_a_ragged_grid():
    with pytest.raises(ValueError, match="MCUs"):
        PT.blocks_scan_order(torch.zeros((24, 32)), 2, 2)


@pytest.mark.parametrize("quality", [1, 50, 95])
def test_quantize_bit_identical(quality):
    rng = np.random.default_rng(quality)
    qt = JQ.luma_table(quality)
    coeffs = rng.uniform(-2000, 2000, size=(300, 8, 8)).astype(np.float32)
    # Exact .5 boundaries of both signs, where round-half-away decides.
    ties = (rng.integers(-20, 20, size=(40, 8, 8)) + 0.5) * qt
    coeffs = np.concatenate([coeffs, ties.astype(np.float32)])
    got = PQ.quantize(torch.as_tensor(coeffs), qt)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), _j(JQ.quantize(jnp.asarray(coeffs), jnp.asarray(qt))))


@pytest.mark.parametrize("quality", [1, 75])
def test_dequantize_plane_bit_identical(quality):
    rng = np.random.default_rng(quality)
    qt = JQ.chroma_table(quality)
    q = rng.integers(-300, 300, size=(64, 96)).astype(np.int32)
    got = PQ.dequantize_plane(torch.as_tensor(q), qt)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), _j(JQ.dequantize_plane(jnp.asarray(q), jnp.asarray(qt))))


@pytest.mark.parametrize("restart", [0, 1, 3, 7])
@pytest.mark.parametrize("n", [1, 50, 51])
def test_undpcm_bit_identical(restart, n):
    rng = np.random.default_rng(restart * 100 + n)
    diffs = rng.integers(-1024, 1024, size=n).astype(np.int32)
    got = PDP.undpcm(torch.as_tensor(diffs), restart)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), _j(JDP.undpcm(jnp.asarray(diffs), restart)))
    again = PDP.dpcm(got, restart)
    np.testing.assert_array_equal(again.numpy(), diffs)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fancy", [False, True])
def test_upsample_plane_bit_identical(mode, fancy):
    rng = np.random.default_rng(len(mode) + fancy)
    plane = rng.integers(0, 256, size=(24, 40)).astype(np.float32)
    pf = PSU.fancy_upsample_plane if fancy else PSU.upsample_plane
    jf = JSU.fancy_upsample_plane if fancy else JSU.upsample_plane
    got = pf(torch.as_tensor(plane), PS(mode))
    ref = _j(jf(jnp.asarray(plane), JS(mode)))
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("hv", [1, 2, 4])
def test_zigzag_qdiv_bit_identical(hv):
    qy, qc = JQ.luma_table(60), JQ.chroma_table(60)
    got = PM.zigzag_qdiv(qy, qc, hv)
    ref = _j(JM.zigzag_qdiv(jnp.asarray(qy), jnp.asarray(qc), hv))
    assert got.dtype == np.float32 and got.shape == ((hv + 2) * 64,)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("total_bits", [0, 1, 7, 8, 9, 31, 32, 33, 300, 319])
def test_finalize_segment_bit_identical(total_bits):
    rng = np.random.default_rng(total_bits)
    words = rng.integers(0, 2 ** 32, size=10, dtype=np.uint64).astype(
        np.uint32)
    words[::3] |= np.uint32(0xFF00FF00)  # bytes the stuffing must escape
    got = PB.finalize_segment(words, total_bits)
    ref = JB.finalize_segment(words, total_bits)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)


# --- DCT products: within DCT_ATOL -------------------------------------------


def _spatial_blocks(seed, n=300):
    rng = np.random.default_rng(seed)
    return rng.integers(-128, 128, size=(n, 8, 8)).astype(np.float32)


def test_zigzag_dct_matrix():
    got = PD.zigzag_dct_matrix()
    assert got.dtype == np.float32 and got.shape == (64, 64)
    np.testing.assert_allclose(got, JD.zigzag_dct_matrix(), rtol=0,
                               atol=DCT_ATOL)
    np.testing.assert_allclose(got @ got.T, np.eye(64), rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_mcu_kernel(mode):
    kern, bias = PM.mcu_kernel(PS(mode))
    jkern, jbias = JM.mcu_kernel(JS(mode))
    assert kern.dtype == bias.dtype == np.float32
    np.testing.assert_allclose(kern, jkern, rtol=0, atol=DCT_ATOL)
    np.testing.assert_allclose(bias, jbias, rtol=0, atol=DCT_ATOL)


@pytest.mark.parametrize("name", ["fdct_blocks", "fdct_zigzag_blocks"])
def test_forward_dct(name):
    x = _spatial_blocks(1)
    if name == "fdct_zigzag_blocks":
        x = x.reshape(-1, 64)
    got = getattr(PD, name)(torch.as_tensor(x))
    ref = _j(getattr(JD, name)(jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=DCT_ATOL)


@pytest.mark.parametrize("name", ["idct_blocks", "idct_zigzag_blocks"])
def test_inverse_dct(name):
    spatial = _spatial_blocks(2)
    if name == "idct_zigzag_blocks":
        c = _j(JD.fdct_zigzag_blocks(jnp.asarray(spatial.reshape(-1, 64))))
    else:
        c = _j(JD.fdct_blocks(jnp.asarray(spatial)))
    got = getattr(PD, name)(torch.as_tensor(c))
    ref = _j(getattr(JD, name)(jnp.asarray(c)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=DCT_ATOL)
    np.testing.assert_allclose(got.numpy().reshape(spatial.shape), spatial,
                               rtol=0, atol=1e-3)


@pytest.mark.parametrize("shape", [(64, 96), (8, 8), (16, 40)])
def test_dct_plane(shape):
    rng = np.random.default_rng(shape[1])
    plane = rng.integers(-128, 128, size=shape).astype(np.float32)
    got = PD.fdct_plane(torch.as_tensor(plane))
    ref = _j(JD.fdct_plane(jnp.asarray(plane)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=DCT_ATOL)
    back = PD.idct_plane(torch.as_tensor(ref))
    np.testing.assert_allclose(back.numpy(), _j(JD.idct_plane(jnp.asarray(ref))),
                               rtol=0, atol=DCT_ATOL)
    with pytest.raises(ValueError):
        PD.fdct_plane(torch.zeros((12, 16)))


def test_dct_plane_is_the_block_dct_in_image_layout():
    plane = _spatial_blocks(3, 96).reshape(8, 12, 8, 8).transpose(
        0, 2, 1, 3).reshape(64, 96)
    t = torch.as_tensor(plane)
    by_block = PT.unblockify(PD.fdct_blocks(PT.blockify(t)))
    np.testing.assert_allclose(PD.fdct_plane(t).numpy(), by_block.numpy(),
                               rtol=0, atol=DCT_ATOL)


# --- the transform and the colour map ----------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("quality", [10, 75, 100])
def test_mcu_transform_equals_the_exact_transform(jax_exact_transform, mode,
                                                  quality):  # noqa: F811
    img = make_image(32, 48, seed=quality)
    qy, qc = JQ.luma_table(quality), JQ.chroma_table(quality)
    got = PM.mcu_transform(torch.as_tensor(img), qy, qc, PS(mode))
    ref = _j(JM.mcu_transform(jnp.asarray(img), jnp.asarray(qy),
                              jnp.asarray(qc), JS(mode)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_ycbcr_to_rgb_clips_by_default():
    edge = np.array([[255, 0, 255], [0, 255, 0]], dtype=np.float32)
    got = PC.ycbcr_to_rgb(torch.as_tensor(edge)).numpy()
    ref = _j(JC.ycbcr_to_rgb(jnp.asarray(edge)))
    assert got[0, 0] == ref[0, 0] == 255.0
    assert got[1, 0] == ref[1, 0] == 0.0
    rng = np.random.default_rng(7)
    ycc = rng.uniform(-60, 320, size=(40, 40, 3)).astype(np.float32)
    got = PC.ycbcr_to_rgb(torch.as_tensor(ycc)).numpy()
    ref = _j(JC.ycbcr_to_rgb(jnp.asarray(ycc)))
    clipped = (ref == 0) | (ref == 255)
    assert clipped.mean() > 0.2
    np.testing.assert_array_equal(got[clipped], ref[clipped])
    np.testing.assert_allclose(got, ref, rtol=0, atol=DCT_ATOL)
    unclipped = PC.ycbcr_to_rgb(torch.as_tensor(ycc), clip=False).numpy()
    np.testing.assert_allclose(
        unclipped, _j(JC.ycbcr_to_rgb(jnp.asarray(ycc), clip=False)),
        rtol=0, atol=1e-3)
    assert unclipped.min() < 0 and unclipped.max() > 255


def test_native_available():
    assert PN.available() is True


# --- decode(use_pallas=False) -------------------------------------------------


def _within_contract(got, ref):
    assert got.shape == ref.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    ndiff = int((diff != 0).sum())
    print(f"samples differing: {ndiff} of {diff.size}, max {diff.max()}")
    assert diff.max() <= 1
    assert ndiff <= 0.005 * diff.size


def _stream(kind):
    if kind in port_fixtures.FIXTURES:
        return port_fixtures.read(kind)
    img = make_image(72, 104, seed=5)
    if kind == "gray":
        return jpeg_tpu_torch.encode(img[..., 1], quality=80, device="cpu")
    mode, restart = kind.split("/")
    return jpeg_tpu_torch.encode(img, quality=80, subsampling=mode,
                                 restart_interval=int(restart), device="cpu")


STREAMS = ["420/0", "422/0", "444/0", "420/3", "gray", "cmyk.jpg",
           "ycck.jpg", "progressive_420.jpg", "noninterleaved_444.jpg"]


@pytest.mark.parametrize("kind", STREAMS)
def test_decode_without_pallas_matches_reference(kind):
    jpg = _stream(kind)
    got = jpeg_tpu_torch.decode(jpg, device="cpu", use_pallas=False)
    _within_contract(got, jpeg_tpu.decode(jpg, entropy="native"))
    # The default (kernel B's twin on the CPU) holds the same contract.
    _within_contract(got, jpeg_tpu_torch.decode(jpg, device="cpu"))


@pytest.mark.parametrize("scale_denom", [1, 2, 8])
def test_decode_without_pallas_options(scale_denom):
    jpg = _stream("420/0")
    got = jpeg_tpu_torch.decode(jpg, device="cpu", use_pallas=False,
                                scale_denom=scale_denom)
    _within_contract(got, jpeg_tpu.decode(jpg, entropy="native",
                                          scale_denom=scale_denom))
    planes = jpeg_tpu_torch.decode(jpg, device="cpu", use_pallas=False,
                                   output="ycbcr", scale_denom=scale_denom)
    np.testing.assert_array_equal(jpeg_tpu_torch.finish_ycbcr(planes), got)
    ref = jpeg_tpu.decode(jpg, entropy="native", output="ycbcr",
                          scale_denom=scale_denom)
    for p, r in zip(planes.planes, ref.planes):
        _within_contract(p, np.asarray(r))


def test_use_pallas_selects_the_idct(monkeypatch):
    """use_pallas=True (the default) goes through dequant_idct_planes
    (kernel B2, its twin on the CPU) once for the three planes; False never
    does, and takes the separable block IDCT; the scaled decode takes
    neither."""
    calls = {"fused": 0, "blocks": 0}

    def count(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(PF, "dequant_idct_planes",
                        count("fused", PF.dequant_idct_planes))
    monkeypatch.setattr(PD, "idct_blocks", count("blocks", PD.idct_blocks))
    jpg = _stream("420/0")
    want = {"fused": 1, "blocks": 0}
    for kwargs in ({}, {"use_pallas": True}, {"use_pallas": False},
                   {"use_pallas": False, "scale_denom": 2}):
        calls.update(fused=0, blocks=0)
        jpeg_tpu_torch.decode(jpg, device="cpu", **kwargs)
        if kwargs.get("use_pallas") is False:
            want = ({"fused": 0, "blocks": 0} if "scale_denom" in kwargs
                    else {"fused": 0, "blocks": 3})
        assert calls == want, (kwargs, calls)


def test_use_pallas_true_is_the_default_decode():
    for kind in ("420/3", "gray", "cmyk.jpg"):
        jpg = _stream(kind)
        np.testing.assert_array_equal(
            jpeg_tpu_torch.decode(jpg, device="cpu", use_pallas=True),
            jpeg_tpu_torch.decode(jpg, device="cpu"))


def test_batch_reconstruction_without_pallas_is_per_image():
    """_reconstruct_batch with use_pallas=False equals the planes of each
    image reconstructed alone (the matmul forms run image by image)."""
    rng = np.random.default_rng(3)
    zz = torch.as_tensor(rng.integers(-40, 40, size=(3 * 24, 64)),
                         dtype=torch.int32)
    q = torch.as_tensor(JQ.luma_table(75), dtype=torch.float32)
    got = PDEC._reconstruct_batch(zz, q, (4, 6), 8, 3, use_pallas=False)
    for i, z in enumerate(zz.chunk(3)):
        np.testing.assert_array_equal(
            got[i].numpy(),
            PDEC._reconstruct_plane(z, q, (4, 6), use_pallas=False).numpy())
