"""Every stream type jpeg_tpu.decode takes, through jpeg_tpu_torch.decode on
the CPU: progressive (PIL's and jpeg_tpu's own encoder's, colour and gray),
non-interleaved multi-scan, Adobe CMYK and YCCK, RGB-coded components, and
Huffman table ids other than a shared 0/1.

Tolerance: against jpeg_tpu.decode, pixels may differ by at most 1 level in
at most 0.5% of samples (the two IDCTs sum in different f32 orders and a .5
boundary may round either way); the count is printed. Against PIL/libjpeg
(a fixed-point IDCT) the bounds of tests/test_progressive.py and
tests/test_cmyk.py apply: PSNR > 45 dB for progressive colour, > 50 dB for
CMYK/YCCK. The entropy backends must agree exactly inside the port. The
committed fixture streams (tests/data/torch_port) must equal what their
recipes build."""

import io

import numpy as np
import pytest
from PIL import Image

import jpeg_tpu
from jpeg_tpu.models.progressive_enc import encode_progressive

import jpeg_tpu_torch
from jpeg_tpu_torch.io import jfif as PJ

import torch_port_fixtures as fixtures
from conftest import psnr
from torch_port_util import make_image


def assert_close_to_reference(jpg, **kw):
    ref = jpeg_tpu.decode(jpg, **kw)
    got = jpeg_tpu_torch.decode(jpg, device="cpu", **kw)
    assert got.shape == ref.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    ndiff = int((diff != 0).sum())
    print(f"samples differing: {ndiff} of {diff.size}")
    assert diff.max(initial=0) <= 1
    assert ndiff <= 0.005 * diff.size
    return got


def pil_jpeg(img, mode=None, **kw):
    buf = io.BytesIO()
    Image.fromarray(img, mode=mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


def pil_decode(jpg):
    return np.asarray(Image.open(io.BytesIO(jpg)))


@pytest.mark.parametrize("subsampling", [0, 2])  # PIL: 4:4:4, 4:2:0
@pytest.mark.parametrize("shape", [(48, 64), (37, 53)])
def test_progressive_pil_colour(subsampling, shape):
    jpg = pil_jpeg(make_image(*shape, seed=11), progressive=True, quality=85,
                   subsampling=subsampling)
    assert PJ.parse_jpeg(jpg).progressive
    got = assert_close_to_reference(jpg)
    assert psnr(got, pil_decode(jpg)) > 45.0


def test_progressive_pil_gray_and_restarts():
    img = make_image(45, 83, seed=12)
    got = assert_close_to_reference(
        pil_jpeg(img[..., 0], progressive=True, quality=80))
    assert got.shape == (45, 83)
    jpg = pil_jpeg(img, progressive=True, quality=80,
                   restart_marker_blocks=2)
    assert PJ.parse_jpeg(jpg).scans[0].restart_interval > 0
    assert_close_to_reference(jpg)


@pytest.mark.parametrize("mode", ["444", "420", "gray"])
def test_progressive_from_the_reference_encoder(mode):
    img = make_image(61, 75, seed=13)
    if mode == "gray":
        jpg = encode_progressive(img[..., 2], quality=75)
    else:
        jpg = encode_progressive(img, quality=75, subsampling=mode)
    got = assert_close_to_reference(jpg)
    assert psnr(got, pil_decode(jpg)) > 45.0


@pytest.mark.parametrize("name", ["progressive_420.jpg",
                                  "progressive_gray.jpg"])
def test_progressive_backends_equal_and_scaled(name):
    jpg = fixtures.read(name)
    ref = jpeg_tpu_torch.decode(jpg, device="cpu", entropy="native")
    for backend in ("numpy", "auto", "sparse"):
        np.testing.assert_array_equal(
            jpeg_tpu_torch.decode(jpg, device="cpu", entropy=backend), ref)
    assert_close_to_reference(jpg, scale_denom=2)


@pytest.mark.parametrize("restart,optimize", [(0, False), (4, False),
                                              (0, True)])
def test_noninterleaved_multiscan(restart, optimize):
    img = make_image(43, 59, seed=14)
    jpg = jpeg_tpu.encode_noninterleaved(img, quality=80,
                                         restart_interval=restart,
                                         optimize_tables=optimize)
    assert len(PJ.parse_jpeg(jpg).scans) == 3
    got = assert_close_to_reference(jpg)
    np.testing.assert_array_equal(
        jpeg_tpu_torch.decode(jpg, device="cpu", entropy="numpy"), got)
    assert psnr(got, pil_decode(jpg)) > 45.0


@pytest.mark.parametrize("shape", [(32, 48), (17, 23)])
def test_cmyk_from_pil(shape):
    a = fixtures.cmyk_image(*shape, seed=shape[0])
    jpg = pil_jpeg(a, mode="CMYK", quality=92)
    info = PJ.parse_jpeg(jpg)
    assert len(info.components) == 4 and info.adobe_transform == 0
    got = assert_close_to_reference(jpg)
    assert got.shape == a.shape
    assert psnr(got, pil_decode(jpg)) > 50.0
    np.testing.assert_array_equal(
        jpeg_tpu_torch.decode(jpg, device="cpu", entropy="numpy"), got)


def test_ycck_fixture():
    jpg = fixtures.read("ycck.jpg")
    info = PJ.parse_jpeg(jpg)
    assert info.adobe_transform == 2 and len(info.components) == 4
    got = assert_close_to_reference(jpg)
    pil = np.asarray(Image.open(io.BytesIO(jpg)).convert("CMYK"))
    assert psnr(got, pil) > 50.0
    assert psnr(got, fixtures.cmyk_image(32, 40, 46)) > 30.0


def test_rgb_coded_components():
    img = make_image(40, 56, seed=15)
    jpg = pil_jpeg(img, keep_rgb=True, quality=90)
    info = PJ.parse_jpeg(jpg)
    assert tuple(c.comp_id for c in info.components) == (0x52, 0x47, 0x42)
    got = assert_close_to_reference(jpg)
    assert psnr(got, pil_decode(jpg)) > 45.0
    with pytest.raises(ValueError, match="YCbCr-coded"):
        jpeg_tpu_torch.decode(jpg, device="cpu", output="ycbcr")


def remap_huffman_ids(data: bytes, xor: int) -> bytes:
    """XOR every Huffman table id in the DHT headers and the SOS component
    specs with `xor`. The stream stays valid and decodes to the same pixels;
    only the id assignment differs."""
    out = bytearray(data)
    i = 2
    while i < len(out):
        assert out[i] == 0xFF
        marker = out[i + 1]
        seg = (out[i + 2] << 8) | out[i + 3]
        if marker == 0xC4:  # DHT: one or more (Tc<<4|Th, counts, syms)
            j = i + 4
            end = i + 2 + seg
            while j < end:
                out[j] ^= xor
                j += 17 + sum(out[j + 1: j + 17])
        elif marker == 0xDA:  # SOS: Ns, then (Cs, Td<<4|Ta) per component
            for c in range(out[i + 4]):
                out[i + 6 + 2 * c] ^= xor * 0x11
            break  # entropy-coded data follows
        i += 2 + seg
    return bytes(out)


@pytest.mark.parametrize("mode", ["420", "gray"])
def test_swapped_huffman_ids_stay_on_the_native_walkers(mode):
    img = make_image(37, 53, seed=16)
    normal = jpeg_tpu_torch.encode(img if mode != "gray" else img[..., 0],
                                   quality=80, device="cpu")
    swapped = remap_huffman_ids(normal, 1)
    assert swapped != normal
    want = jpeg_tpu_torch.decode(normal, device="cpu")
    for backend in ("auto", "native", "numpy", "sparse"):
        np.testing.assert_array_equal(
            jpeg_tpu_torch.decode(swapped, device="cpu", entropy=backend),
            want)
    assert_close_to_reference(swapped)


@pytest.mark.parametrize("mode", ["420", "gray"])
def test_other_huffman_ids_take_the_numpy_walker(mode):
    img = make_image(37, 53, seed=17)
    normal = jpeg_tpu_torch.encode(img if mode != "gray" else img[..., 0],
                                   quality=80, restart_interval=3,
                                   device="cpu")
    other = remap_huffman_ids(normal, 2)  # ids 2 and 3
    ids = {c.dc_id for c in PJ.parse_jpeg(other).components}
    assert ids <= {2, 3}
    want = jpeg_tpu_torch.decode(normal, device="cpu")
    for backend in ("auto", "numpy"):
        np.testing.assert_array_equal(
            jpeg_tpu_torch.decode(other, device="cpu", entropy=backend), want)
    assert_close_to_reference(other)
    for backend in ("native", "sparse"):
        with pytest.raises(PJ.JpegFormatError, match="unavailable"):
            jpeg_tpu_torch.decode(other, device="cpu", entropy=backend)
        with pytest.raises(jpeg_tpu.io.jfif.JpegFormatError):
            jpeg_tpu.decode(other, entropy=backend)


def test_undefined_huffman_table_is_a_format_error():
    jpg = jpeg_tpu_torch.encode(make_image(16, 16), device="cpu")
    out = bytearray(jpg)
    i = jpg.index(b"\xff\xda")
    out[i + 6] ^= 0x22  # the first component now names tables 2/2
    for backend in ("auto", "native", "numpy", "sparse"):
        with pytest.raises(PJ.JpegFormatError):
            jpeg_tpu_torch.decode(bytes(out), device="cpu", entropy=backend)


@pytest.mark.parametrize("name", sorted(fixtures.FIXTURES))
def test_fixture_streams(name):
    """A committed fixture equals what its recipe builds, decodes to the
    shape on record, and agrees with the reference."""
    build, shape = fixtures.FIXTURES[name]
    jpg = fixtures.read(name)
    assert jpg == build()
    got = assert_close_to_reference(jpg)
    assert got.shape == shape
