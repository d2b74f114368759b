"""jpeg_tpu_torch.encode_batched / decode_batched (device="cpu") against the
port's per-image calls and against jpeg_tpu.

Tolerances:
  - encode_batched: bytes equal to K calls of the port's encode(), and to
    jpeg_tpu.encode_batched(device_pack=True) run on the exact integer
    transform (the jax_exact_transform fixture; on the CPU the reference
    would otherwise take its staged float transform, 1 off at .5
    boundaries). Tolerance 0.
  - decode_batched: exactly equal to K calls of the port's decode(), for
    every batch_mode and scale_denom; within 1 level in at most 0.5% of the
    samples of jpeg_tpu.decode_batched (f32 sums in another order).
Every emitted stream opens in PIL."""

import io

import numpy as np
import pytest
import torch
from PIL import Image

import jpeg_tpu

import jpeg_tpu_torch
from jpeg_tpu_torch.entropy import huffman
from jpeg_tpu_torch.io import jfif
from jpeg_tpu_torch.models import decoder as PD, encoder as PE
from jpeg_tpu_torch.ops import pack

from torch_port_util import jax_exact_transform, make_image  # noqa: F401


def _batch(shape, k, seed=0):
    return np.stack([make_image(*shape, seed=seed + i) for i in range(k)])


def _per_image(imgs, **kw):
    return [jpeg_tpu_torch.encode(im, device="cpu", **kw) for im in imgs]


@pytest.mark.parametrize("mode,shape,restart,k", [
    ("420", (48, 64), 0, 3), ("444", (37, 53), 0, 2), ("422", (40, 56), 0, 4),
    ("420", (64, 96), 6, 2),      # divides the 24 MCUs: K * 4 segments
    ("444", (24, 32), 12, 3),     # exactly the MCU count
    ("411", (33, 70), 1000, 2),   # beyond the MCU count: one segment each
    ("440", (16, 8), 0, 1),
])
def test_encode_batched_equals_per_image(mode, shape, restart, k):
    imgs = _batch(shape, k, seed=restart)
    kw = dict(quality=80, subsampling=mode, restart_interval=restart,
              comment="batched")
    spills, launches = PE.HOST_PACK_SPILLS, pack.LAUNCHES
    got = jpeg_tpu_torch.encode_batched(imgs, device="cpu", **kw)
    assert PE.HOST_PACK_SPILLS == spills
    assert pack.LAUNCHES == launches  # the CPU runs the twin, which counts nothing
    assert got == _per_image(imgs, **kw)
    for jpg in got:
        pil = Image.open(io.BytesIO(jpg))
        pil.load()
        assert pil.size == (shape[1], shape[0])


@pytest.mark.parametrize("mode,shape,restart,k", [
    ("420", (48, 64), 0, 3), ("444", (37, 53), 0, 2), ("422", (40, 56), 7, 2),
    ("420", (96, 128), 4, 4),
])
def test_encode_batched_matches_jax(jax_exact_transform, mode, shape, restart,
                                    k):
    imgs = _batch(shape, k, seed=5)
    kw = dict(quality=85, subsampling=mode, restart_interval=restart)
    ref = jpeg_tpu.encode_batched(imgs, device_pack=True, **kw)
    assert jpeg_tpu_torch.encode_batched(imgs, device="cpu", **kw) == ref


def test_encode_batched_quant_tables_match_jax(jax_exact_transform):
    imgs = _batch((32, 48), 2, seed=9)
    qt = (np.full((8, 8), 7), np.arange(1, 65).reshape(8, 8) * 5)  # clipped at 255
    ref = jpeg_tpu.encode_batched(imgs, subsampling="420", quant_tables=qt,
                                  device_pack=True)
    got = jpeg_tpu_torch.encode_batched(imgs, subsampling="420",
                                        quant_tables=qt, device="cpu")
    assert got == ref == _per_image(imgs, subsampling="420", quant_tables=qt)


def test_encode_batched_spills_only_the_dense_image():
    """Uniform noise at q100 overflows the packer's 288 bits per block; the
    smooth images of the same batch keep their device pack."""
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:24, 0:32]
    smooth = np.stack([xx * 4, yy * 5, xx + yy], -1).astype(np.uint8)
    noise = rng.integers(0, 256, size=(24, 32, 3)).astype(np.uint8)
    imgs = np.stack([smooth, noise, smooth[::-1].copy()])
    spills = PE.HOST_PACK_SPILLS
    got = jpeg_tpu_torch.encode_batched(imgs, 100, "444", device="cpu")
    assert PE.HOST_PACK_SPILLS == spills + 1
    assert got == _per_image(imgs, quality=100, subsampling="444")
    assert PE.HOST_PACK_SPILLS == spills + 2  # the per-image call spills too


@pytest.mark.parametrize("case", ["rank", "channels", "empty", "float",
                                  "odd_size", "unaligned_restart",
                                  "host_pack", "quality"])
def test_encode_batched_argument_cases(case):
    imgs = _batch((24, 40), 2)
    enc = jpeg_tpu_torch.encode_batched
    if case == "rank":
        with pytest.raises(ValueError, match=r"expected \(K, H, W, 3\)"):
            enc(imgs[0], device="cpu")
        with pytest.raises(ValueError, match=r"expected \(K, H, W, 3\)"):
            jpeg_tpu.encode_batched(imgs[0])
    elif case == "channels":
        with pytest.raises(ValueError, match=r"expected \(K, H, W, 3\)"):
            enc(imgs[..., :2], device="cpu")
    elif case == "empty":
        assert enc(np.zeros((0, 8, 8, 3), np.uint8), device="cpu") == []
    elif case == "float":
        f = imgs.astype(np.float64) + 0.4
        f[0, 0, 0] = (-3.0, 300.0, 254.5)
        assert enc(f, device="cpu") == _per_image(f)
    elif case == "odd_size":
        odd = _batch((13, 17), 3)
        assert enc(odd, 60, "420", device="cpu") == _per_image(
            odd, quality=60, subsampling="420")
    elif case == "unaligned_restart":
        # 6 MCUs at 4:2:0; 4 does not divide them: the host pack, per image.
        kw = dict(quality=75, subsampling="420", restart_interval=4)
        got = enc(imgs, device="cpu", **kw)
        assert got == _per_image(imgs, **kw)
        assert jfif.parse_jpeg(got[0]).restart_interval == 4
    elif case == "host_pack":
        assert enc(imgs, device_pack=False, device="cpu") == _per_image(imgs)
    else:
        with pytest.raises(ValueError, match="quality"):
            enc(imgs, quality=0, device="cpu")


def _streams(mode, shape, restart, k, quality=80):
    return [jpeg_tpu_torch.encode(
        make_image(*shape, seed=7 + i), quality, mode, restart,
        optimize_tables=i == 1, device="cpu") for i in range(k)]


@pytest.mark.parametrize("mode,shape,restart", [
    ("420", (48, 64), 0), ("444", (37, 53), 3), ("422", (40, 50), 0),
    ("411", (33, 70), 2),
])
@pytest.mark.parametrize("scale_denom", [1, 2])
@pytest.mark.parametrize("batch_mode", ["auto", "fused", "pipelined"])
def test_decode_batched_equals_per_image(mode, shape, restart, scale_denom,
                                         batch_mode):
    """Stream 1 carries its own optimal Huffman tables: table contents may
    differ inside a batch."""
    jpgs = _streams(mode, shape, restart, 3)
    ref = np.stack([jpeg_tpu_torch.decode(j, device="cpu",
                                          scale_denom=scale_denom)
                    for j in jpgs])
    got = jpeg_tpu_torch.decode_batched(
        jpgs, scale_denom=scale_denom, batch_mode=batch_mode, device="cpu")
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("scale_denom", [4, 8])
def test_decode_batched_small_scales_device_output_and_no_fancy(scale_denom):
    jpgs = _streams("420", (67, 93), 0, 2)
    kw = dict(scale_denom=scale_denom, fancy_upsample=False)
    ref = np.stack([jpeg_tpu_torch.decode(j, device="cpu", **kw)
                    for j in jpgs])
    for batch_mode in ("fused", "pipelined"):
        got = jpeg_tpu_torch.decode_batched(
            jpgs, device_output=True, batch_mode=batch_mode, device="cpu",
            **kw)
        assert isinstance(got, torch.Tensor) and got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), ref)


def test_decode_batched_single_stream_and_pil_stream():
    buf = io.BytesIO()
    Image.fromarray(make_image(45, 61, seed=4)).save(buf, "JPEG", quality=70)
    jpg = buf.getvalue()
    got = jpeg_tpu_torch.decode_batched([jpg], device="cpu")
    np.testing.assert_array_equal(
        got[0], jpeg_tpu_torch.decode(jpg, device="cpu"))


@pytest.mark.parametrize("mode,shape,scale_denom", [
    ("420", (48, 64), 1), ("444", (37, 53), 1), ("422", (40, 50), 2),
])
def test_decode_batched_close_to_jax(mode, shape, scale_denom):
    jpgs = _streams(mode, shape, 0, 3)
    ref = np.asarray(jpeg_tpu.decode_batched(jpgs, scale_denom=scale_denom))
    got = jpeg_tpu_torch.decode_batched(jpgs, scale_denom=scale_denom,
                                        device="cpu")
    assert got.shape == ref.shape
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1
    assert (diff != 0).sum() <= 0.005 * diff.size


def _rewrite(jpg, comps=None, htables=None, adobe=None):
    """The stream's scan under another header."""
    info = jfif.parse_jpeg(jpg)
    return jfif.write_jpeg(
        info.width, info.height, comps or info.components, info.qtables,
        htables or info.htables, info.scan_data, adobe_transform=adobe)


@pytest.mark.parametrize("rule", [
    "geometry", "sampling", "quant_tables", "table_ids", "component_ids",
    "adobe_transform", "progressive", "gray", "split_table_ids",
    "undefined_table", "empty", "batch_mode", "scale_denom",
])
def test_decode_batched_refuses(rule):
    """Each homogeneity rule, with the reference's error type; the port and
    jpeg_tpu refuse the same lists."""
    img = make_image(32, 48, seed=1)
    base = jpeg_tpu_torch.encode(img, 75, "420", device="cpu")
    std = huffman.standard_tables()
    C = jfif.ComponentSpec
    kw, error, match = {}, ValueError, "homogeneous"
    if rule == "geometry":
        other = jpeg_tpu_torch.encode(img[:, :40], 75, "420", device="cpu")
    elif rule == "sampling":
        other = jpeg_tpu_torch.encode(img, 75, "422", device="cpu")
    elif rule == "quant_tables":
        other = jpeg_tpu_torch.encode(img, 76, "420", device="cpu")
    elif rule == "table_ids":
        # Luma on table id 1 and chroma on 0, the tables swapped with them:
        # a valid stream, but walked with stream 0's layout it would not be.
        other = _rewrite(
            base, comps=[C(1, 2, 2, 0, 1, 1), C(2, 1, 1, 1, 0, 0),
                         C(3, 1, 1, 1, 0, 0)],
            htables={(a, 1 - t): v for (a, t), v in std.items()})
        np.testing.assert_array_equal(
            jpeg_tpu_torch.decode(other, device="cpu"),
            jpeg_tpu_torch.decode(base, device="cpu"))
    elif rule == "component_ids":
        other = _rewrite(base, comps=[
            C(0x52, 2, 2, 0, 0, 0), C(0x47, 1, 1, 1, 1, 1),
            C(0x42, 1, 1, 1, 1, 1)])
    elif rule == "adobe_transform":
        other = _rewrite(base, adobe=0)
    elif rule == "progressive":
        from jpeg_tpu_torch.models.progressive_enc import encode_progressive

        other = encode_progressive(img, 75, "420", device="cpu")
        match = "single-scan interleaved baseline"
    elif rule == "gray":
        base = jpeg_tpu_torch.encode(img[..., 0], 75, device="cpu")
        other = base
        match = "3-component"
    elif rule == "split_table_ids":
        other = _rewrite(
            base, comps=[C(1, 2, 2, 0, 0, 1), C(2, 1, 1, 1, 1, 1),
                         C(3, 1, 1, 1, 1, 1)])
        match = "table ids 0/1"
    elif rule == "undefined_table":
        other = _rewrite(base, htables={k: v for k, v in std.items()
                                        if k != (1, 1)})
        error, match = jfif.JpegFormatError, "undefined Huffman table"
    elif rule == "empty":
        with pytest.raises(ValueError, match="at least one stream"):
            jpeg_tpu_torch.decode_batched([], device="cpu")
        with pytest.raises(ValueError, match="at least one stream"):
            jpeg_tpu.decode_batched([])
        return
    elif rule == "batch_mode":
        other, kw, match = base, dict(batch_mode="vmapped"), "batch_mode"
    else:
        other, kw, match = base, dict(scale_denom=3), "scale_denom"
    with pytest.raises(error, match=match):
        jpeg_tpu_torch.decode_batched([base, other], device="cpu", **kw)
    with pytest.raises(ValueError, match=match):  # JpegFormatError is one
        jpeg_tpu.decode_batched([base, other], **kw)


def test_auto_batch_mode_is_one_of_the_two():
    assert PD.AUTO_BATCH_MODE in ("fused", "pipelined")
    assert set(PD.BATCH_MODES) == {"auto", "fused", "pipelined"}
