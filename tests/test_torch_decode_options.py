"""jpeg_tpu_torch.decode's options (scale_denom, output="ycbcr" with
finish_ycbcr, device_output, entropy=) on the CPU against jpeg_tpu.decode.

Tolerance: against the JAX package, pixels and planes may differ by at most
1 level in at most 0.5% of samples (the IDCTs and the scaled einsums sum in
different f32 orders, so a .5 boundary may round either way); the count is
printed. Inside the port everything is exact: finish_ycbcr(decode(
output="ycbcr")) equals decode(), whatever the thread count; device_output
equals the host result; the entropy backends give equal pixels."""

import io

import numpy as np
import pytest
import torch
from PIL import Image

import jpeg_tpu

import jpeg_tpu_torch
from jpeg_tpu_torch.io.jfif import JpegFormatError

from torch_port_util import make_image


def assert_close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    ndiff = int((diff != 0).sum())
    print(f"samples differing: {ndiff} of {diff.size}")
    assert diff.max(initial=0) <= 1
    assert ndiff <= 0.005 * diff.size


def stream(mode, shape, quality=80, restart=0, seed=1):
    img = make_image(*shape, seed=seed)
    if mode == "gray":
        return jpeg_tpu_torch.encode(img[..., 0], quality=quality,
                                     restart_interval=restart, device="cpu")
    return jpeg_tpu_torch.encode(img, quality=quality, subsampling=mode,
                                 restart_interval=restart, device="cpu")


@pytest.mark.parametrize("mode,shape", [
    ("420", (67, 93)), ("444", (41, 35)), ("422", (64, 96)),
    ("gray", (37, 53)),
])
@pytest.mark.parametrize("scale_denom", [2, 4, 8])
def test_scaled_decode_matches_reference(mode, shape, scale_denom):
    jpg = stream(mode, shape)
    got = jpeg_tpu_torch.decode(jpg, device="cpu", scale_denom=scale_denom)
    h, w = -(-shape[0] // scale_denom), -(-shape[1] // scale_denom)
    assert got.shape[:2] == (h, w)
    assert_close(got, jpeg_tpu.decode(jpg, scale_denom=scale_denom))


def test_scaled_decode_of_pil_stream_without_fancy_upsampling():
    buf = io.BytesIO()
    Image.fromarray(make_image(50, 70, seed=8)).save(buf, "JPEG", quality=75)
    got = jpeg_tpu_torch.decode(buf.getvalue(), device="cpu", scale_denom=2,
                                fancy_upsample=False)
    assert_close(got, jpeg_tpu.decode(buf.getvalue(), scale_denom=2,
                                      fancy_upsample=False))


@pytest.mark.parametrize("mode,shape", [("420", (67, 93)), ("444", (41, 35)),
                                        ("422", (300, 40))])
@pytest.mark.parametrize("scale_denom", [1, 2])
def test_ycbcr_planes_match_reference(mode, shape, scale_denom):
    jpg = stream(mode, shape, seed=2)
    got = jpeg_tpu_torch.decode(jpg, device="cpu", output="ycbcr",
                                scale_denom=scale_denom)
    ref = jpeg_tpu.decode(jpg, output="ycbcr", scale_denom=scale_denom)
    assert isinstance(got, jpeg_tpu_torch.YCbCrPlanes)
    assert (got.height, got.width, got.factors, got.fancy) == (
        ref.height, ref.width, ref.factors, ref.fancy)
    assert len(got.planes) == 3
    for g, r in zip(got.planes, ref.planes):
        assert isinstance(g, np.ndarray)
        assert_close(g, r)
    # The reference's host finish accepts the port's planes and vice versa.
    assert_close(jpeg_tpu_torch.finish_ycbcr(got),
                 jpeg_tpu.finish_ycbcr(ref))


@pytest.mark.parametrize("mode,shape", [
    ("420", (67, 93)), ("444", (41, 35)), ("422", (300, 40)),
    ("420", (530, 24)),
])
@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("scale_denom", [1, 2])
def test_finish_ycbcr_equals_decode_exactly(mode, shape, threads,
                                            scale_denom):
    jpg = stream(mode, shape, quality=60, seed=3)
    kw = dict(device="cpu", scale_denom=scale_denom)
    rgb = jpeg_tpu_torch.decode(jpg, **kw)
    planes = jpeg_tpu_torch.decode(jpg, output="ycbcr", **kw)
    got = jpeg_tpu_torch.finish_ycbcr(planes, threads=threads)
    assert got.shape == rgb.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, rgb)


def test_finish_ycbcr_without_fancy_and_at_extreme_quantization():
    jpg = stream("420", (270, 38), quality=1, seed=4)
    for fancy in (True, False):
        kw = dict(device="cpu", fancy_upsample=fancy)
        planes = jpeg_tpu_torch.decode(jpg, output="ycbcr", **kw)
        np.testing.assert_array_equal(
            jpeg_tpu_torch.finish_ycbcr(planes, threads=3),
            jpeg_tpu_torch.decode(jpg, **kw))


@pytest.mark.parametrize("mode", ["420", "gray"])
@pytest.mark.parametrize("scale_denom", [1, 4])
def test_device_output_is_a_tensor_equal_to_the_host_result(mode,
                                                            scale_denom):
    jpg = stream(mode, (45, 83), seed=5)
    kw = dict(device="cpu", scale_denom=scale_denom)
    host = jpeg_tpu_torch.decode(jpg, **kw)
    dev = jpeg_tpu_torch.decode(jpg, device_output=True, **kw)
    assert isinstance(dev, torch.Tensor) and dev.dtype == torch.uint8
    assert dev.device.type == "cpu"
    np.testing.assert_array_equal(dev.numpy(), host)


def test_device_output_ycbcr_planes_are_tensors():
    jpg = stream("420", (45, 83), seed=6)
    host = jpeg_tpu_torch.decode(jpg, device="cpu", output="ycbcr")
    dev = jpeg_tpu_torch.decode(jpg, device="cpu", output="ycbcr",
                                device_output=True)
    for d, h in zip(dev.planes, host.planes):
        assert isinstance(d, torch.Tensor)
        np.testing.assert_array_equal(d.numpy(), h)
    np.testing.assert_array_equal(jpeg_tpu_torch.finish_ycbcr(dev),
                                  jpeg_tpu_torch.finish_ycbcr(host))


@pytest.mark.parametrize("mode,restart", [("420", 0), ("444", 3), ("422", 5),
                                          ("gray", 0), ("gray", 4)])
def test_entropy_backends_equal(mode, restart):
    jpg = stream(mode, (37, 53), restart=restart, seed=7)
    ref = jpeg_tpu_torch.decode(jpg, device="cpu", entropy="native")
    for backend in ("numpy", "auto", "sparse"):
        np.testing.assert_array_equal(
            jpeg_tpu_torch.decode(jpg, device="cpu", entropy=backend), ref)
    assert_close(ref, jpeg_tpu.decode(jpg, entropy="numpy", use_pallas=True))


def test_auto_on_the_cpu_takes_the_dense_native_walker(monkeypatch):
    from jpeg_tpu_torch.entropy import decode_device, native

    jpg = stream("420", (24, 40))
    calls = []
    real = native.decode_scan
    monkeypatch.setattr(native, "decode_scan",
                        lambda *a, **k: calls.append("native") or real(*a, **k))
    monkeypatch.setattr(decode_device, "sparse_payload",
                        lambda *a, **k: calls.append("sparse"))
    jpeg_tpu_torch.decode(jpg, device="cpu")
    assert calls == ["native"]


@pytest.mark.parametrize("call,error", [
    (lambda jpg, gray, cmyk: jpeg_tpu_torch.decode(
        jpg, device="cpu", scale_denom=3), ValueError),
    (lambda jpg, gray, cmyk: jpeg_tpu_torch.decode(
        jpg, device="cpu", output="nope"), ValueError),
    (lambda jpg, gray, cmyk: jpeg_tpu_torch.decode(
        jpg, device="cpu", entropy="nope"), ValueError),
    (lambda jpg, gray, cmyk: jpeg_tpu_torch.decode(
        gray, device="cpu", output="ycbcr"), ValueError),
    (lambda jpg, gray, cmyk: jpeg_tpu_torch.decode(
        cmyk, device="cpu", output="ycbcr"), ValueError),
    (lambda jpg, gray, cmyk: jpeg_tpu_torch.decode(
        cmyk, device="cpu", scale_denom=2), JpegFormatError),
    (lambda jpg, gray, cmyk: jpeg_tpu_torch.decode(
        jpg, device="cpu", max_pixels=100), JpegFormatError),
    (lambda jpg, gray, cmyk: jpeg_tpu_torch.decode(
        jpg[: len(jpg) // 2], device="cpu", entropy="numpy"), ValueError),
    (lambda jpg, gray, cmyk: jpeg_tpu_torch.decode(
        b"not a jpeg", device="cpu"), JpegFormatError),
], ids=["scale_denom", "output", "entropy", "gray_ycbcr", "cmyk_ycbcr",
        "cmyk_scaled", "max_pixels", "truncated", "garbage"])
def test_error_cases_raise_the_reference_types(call, error):
    jpg, gray = stream("420", (24, 40)), stream("gray", (24, 40))
    buf = io.BytesIO()
    Image.fromarray(make_image(16, 16)).convert("CMYK").save(buf, "JPEG")
    cmyk = buf.getvalue()
    assert issubclass(JpegFormatError, ValueError)  # as in the reference
    with pytest.raises(error):
        call(jpg, gray, cmyk)


def test_error_cases_match_the_reference():
    """The reference raises the same base type for each of them."""
    jpg, gray = stream("420", (24, 40)), stream("gray", (24, 40))
    for kw in (dict(scale_denom=3), dict(output="nope"),
               dict(entropy="nope")):
        with pytest.raises(ValueError):
            jpeg_tpu.decode(jpg, **kw)
    with pytest.raises(ValueError):
        jpeg_tpu.decode(gray, output="ycbcr")
