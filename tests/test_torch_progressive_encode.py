"""jpeg_tpu_torch.models.progressive_enc.encode_progressive (device="cpu")
against jpeg_tpu's.

Tolerance 0 on bytes: the reference runs on the exact integer transform (the
jax_exact_transform fixture; on the CPU it would otherwise take its staged
float transform, 1 off at .5 boundaries), and the scan emission is the same
host Python in both packages. Every stream opens in PIL, parses as SOF2 with
the script's scans, and decodes in the port to exactly the pixels of the
baseline stream of the same image (the coefficients are the same). Images
are small: the emitter is a Python loop over blocks."""

import io

import numpy as np
import pytest
from PIL import Image

from jpeg_tpu.models.progressive_enc import encode_progressive as jax_encode

import jpeg_tpu_torch
from jpeg_tpu_torch.io import jfif
from jpeg_tpu_torch.models import progressive_enc as PP

from torch_port_util import jax_exact_transform, make_image  # noqa: F401

# Spectral selection only, then one refinement of everything: a script other
# than libjpeg's, with a successive-approximation depth of 2 on the DC.
CUSTOM_SCANS = (
    ((0, 1, 2), 0, 0, 0, 2),
    ((0,), 1, 63, 0, 1),
    ((1,), 1, 63, 0, 0),
    ((2,), 1, 63, 0, 0),
    ((0, 1, 2), 0, 0, 2, 1),
    ((0, 1, 2), 0, 0, 1, 0),
    ((0,), 1, 63, 1, 0),
)
CUSTOM_GRAY_SCANS = (
    ((0,), 0, 0, 0, 0),
    ((0,), 1, 63, 0, 1),
    ((0,), 1, 63, 1, 0),
)


def _image(mode, shape, seed=0):
    img = make_image(*shape, seed=seed)
    return img[..., 0] if mode == "gray" else img


def _kw(mode, **more):
    return more if mode == "gray" else dict(subsampling=mode, **more)


@pytest.mark.parametrize("mode,shape,quality", [
    ("444", (48, 64), 75), ("422", (40, 56), 75), ("420", (48, 64), 75),
    ("gray", (48, 64), 75),
    ("444", (37, 53), 90), ("422", (37, 53), 50), ("420", (37, 53), 90),
    ("gray", (37, 53), 50),   # odd sizes: the crop to the spec block raster
    ("420", (8, 8), 75), ("411", (33, 70), 75), ("420", (64, 96), 98),
])
def test_progressive_bytes_match_jax(jax_exact_transform, mode, shape,
                                     quality):
    img = _image(mode, shape, seed=quality)
    got = PP.encode_progressive(img, quality, device="cpu", **_kw(mode))
    assert got == jax_encode(img, quality, **_kw(mode))


@pytest.mark.parametrize("mode,shape,comment", [
    ("420", (37, 53), None), ("444", (24, 40), "a comment"),
])
def test_progressive_custom_script_and_comment_match_jax(jax_exact_transform,
                                                         mode, shape,
                                                         comment):
    img = _image(mode, shape, seed=2)
    kw = _kw(mode, scans=CUSTOM_SCANS, comment=comment)
    got = PP.encode_progressive(img, 80, device="cpu", **kw)
    assert got == jax_encode(img, 80, **kw)
    info = jfif.parse_jpeg(got)
    assert [(s.ss, s.se, s.ah, s.al) for s in info.scans] == [
        s[1:] for s in CUSTOM_SCANS]
    if comment:
        assert b"\xff\xfe" + bytes([0, len(comment) + 2]) + comment.encode() in got


@pytest.mark.parametrize("mode,shape", [
    ("444", (37, 53)), ("422", (40, 56)), ("420", (37, 53)),
    ("gray", (45, 35)), ("420", (64, 96)),
])
@pytest.mark.parametrize("scans", [None, CUSTOM_SCANS])
def test_progressive_stream_decodes_to_the_baseline_pixels(mode, shape, scans):
    if mode == "gray" and scans is not None:
        scans = CUSTOM_GRAY_SCANS
    img = _image(mode, shape, seed=5)
    jpg = PP.encode_progressive(img, 85, scans=scans, device="cpu",
                                **_kw(mode))
    info = jfif.parse_jpeg(jpg)
    assert info.progressive
    script = scans or (PP.SCRIPT_GRAY if mode == "gray" else PP.SCRIPT_COLOR)
    assert len(info.scans) == len(script)
    assert (info.width, info.height) == (shape[1], shape[0])
    pil = Image.open(io.BytesIO(jpg))
    pil.load()
    assert pil.size == (shape[1], shape[0])
    base = jpeg_tpu_torch.encode(img, 85, device="cpu", **_kw(mode))
    np.testing.assert_array_equal(jpeg_tpu_torch.decode(jpg, device="cpu"),
                                  jpeg_tpu_torch.decode(base, device="cpu"))
    np.testing.assert_array_equal(
        np.asarray(pil.convert("L" if mode == "gray" else "RGB")),
        np.asarray(Image.open(io.BytesIO(base)).convert(
            "L" if mode == "gray" else "RGB")))


@pytest.mark.parametrize("scans,match", [
    ((((0, 1, 2), 0, 5, 0, 0),), "DC scans must have Ss=Se=0"),
    ((((0, 1), 1, 63, 0, 0),), "AC scans must be single-component"),
])
def test_progressive_refuses_what_the_reference_refuses(scans, match):
    img = make_image(16, 16)
    with pytest.raises(ValueError, match=match):
        PP.encode_progressive(img, scans=scans, device="cpu")
    with pytest.raises(ValueError, match=match):
        jax_encode(img, scans=scans)


def test_progressive_reads_a_bmp_path(tmp_path):
    from jpeg_tpu_torch.io import bmp

    img = make_image(20, 36, seed=3)
    path = tmp_path / "in.bmp"
    bmp.write_bmp(str(path), img)
    assert PP.encode_progressive(str(path), device="cpu") == (
        PP.encode_progressive(img, device="cpu"))


def test_scripts_are_the_reference_scripts():
    from jpeg_tpu.models import progressive_enc as JP

    assert PP.SCRIPT_COLOR == JP.SCRIPT_COLOR
    assert PP.SCRIPT_GRAY == JP.SCRIPT_GRAY
