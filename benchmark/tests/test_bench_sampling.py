"""The plain codec at every sampling it states (4:2:0, 4:2:2, 4:4:4) and
restart interval (none, 1, 7 and one MCU row), on the CPU at small odd
sizes: its streams decode back to its coefficients, Pillow's libjpeg-turbo
reads them as the sampling they state, the port's CPU decode lies inside
the reference's bounds and the port's encode writes the reference's scan;
and what a configuration may state."""

import io

import numpy as np
import pytest
import torch

from lib import inputs, plainjpeg as P

SIZES = [(37, 29), (130, 70), (250, 187)]  # width, height
FORMS = [(s, r) for s in P.SAMPLING for r in (0, 1, 7, "row")]


def plain(size, subsampling, restart, quality=75):
    """(image, restart interval in MCUs, the plain stream) of a seeded
    gradient + noise image; "row" is one MCU row."""
    w, h = size
    if restart == "row":
        restart = -(-w // (8 * P.SAMPLING[subsampling][0]))
    img = inputs.make_image(h, w, 10, inputs.generator(w * h + restart, "cpu"),
                            "cpu")
    return img, restart, P.encode(img[None], quality, subsampling, restart)[0]


def ids(forms):
    return [f"{s}-rst{r}" for s, r in forms]


@pytest.mark.parametrize("form", FORMS, ids=ids(FORMS))
@pytest.mark.parametrize("size", SIZES, ids=[f"{w}x{h}" for w, h in SIZES])
def test_plain_streams_decode_back_to_their_coefficients(size, form):
    img, restart, data = plain(size, *form)
    info, coefs = P.decode_coefficients(data)
    assert (info["width"], info["height"], info["restart"]) == (*size, restart)
    h, v = P.SAMPLING[form[0]]
    assert info["components"][0][1:3] == (h, v)
    want = P.coefficients(img[None], 75, subsampling=form[0])[0].numpy()
    assert np.array_equal(coefs, want)
    n_mcu = want.shape[0]
    rst = sum(data.count(bytes((0xFF, 0xD0 + n))) for n in range(8))
    assert rst == (-(-n_mcu // restart) - 1 if restart else 0)


@pytest.mark.parametrize("form", FORMS, ids=ids(FORMS))
@pytest.mark.parametrize("size", SIZES, ids=[f"{w}x{h}" for w, h in SIZES])
def test_pillow_reads_plain_streams_as_stated(size, form):
    Image = pytest.importorskip("PIL.Image")
    from PIL import JpegImagePlugin

    img, _, data = plain(size, *form)
    pil = Image.open(io.BytesIO(data))
    pil.load()
    assert pil.size == size and pil.mode == "RGB"
    assert JpegImagePlugin.get_sampling(pil) == {"444": 0, "422": 1,
                                                 "420": 2}[form[0]]
    coefs = P.coefficients(img[None], 75, subsampling=form[0])[0]
    ref = P.pixels(coefs, 75, size[1], size[0], subsampling=form[0]).numpy()
    diff = np.abs(np.asarray(pil).astype(int) - ref)
    # libjpeg-turbo decodes in integers: the islow IDCT (+-1 a sample), the
    # fancy upsampling with its +1/+2 rounding and its edge at the chroma's
    # own width, and the colour map's tables; a sample off by 1 in Cb moves
    # B by 1.772. Seen: at most 3, mean 0.02-0.41.
    assert diff.max() <= 4 and diff.mean() < 0.6


@pytest.mark.parametrize("form", FORMS, ids=ids(FORMS))
@pytest.mark.parametrize("size", SIZES, ids=[f"{w}x{h}" for w, h in SIZES])
def test_port_decode_lies_inside_the_bounds(size, form):
    jt = pytest.importorskip("jpeg_tpu_torch")
    img, _, data = plain(size, *form)
    coefs = P.coefficients(img[None], 75, subsampling=form[0])[0]
    lo, hi = P.pixel_bounds(coefs, 75, size[1], size[0],
                            subsampling=form[0])
    out = np.asarray(jt.decode(data, device="cpu"))
    assert out.shape == tuple(lo.shape)
    assert np.count_nonzero((out < lo.numpy()) | (out > hi.numpy())) == 0


@pytest.mark.parametrize("form", FORMS, ids=ids(FORMS))
@pytest.mark.parametrize("size", SIZES, ids=[f"{w}x{h}" for w, h in SIZES])
def test_port_encode_writes_the_reference_scan(size, form):
    jt = pytest.importorskip("jpeg_tpu_torch")
    img, restart, data = plain(size, *form)
    port = P.parse(jt.encode(img.numpy(), quality=75, subsampling=form[0],
                             restart_interval=restart, device="cpu"))
    ours = P.parse(data)
    for key in ("scan", "restart", "components", "qtables", "htables"):
        assert port[key] == ours[key], key


def test_bounds_hold_the_reference_and_the_control_leaves_them():
    """The reference's own decode lies inside its bounds at every sampling;
    the TF32 control falls outside them."""
    for sub in P.SAMPLING:
        img, _, _ = plain((130, 70), sub, 0)
        coefs = P.coefficients(img[None], 75, subsampling=sub)[0]
        lo, hi = P.pixel_bounds(coefs, 75, 70, 130, subsampling=sub)
        for precision, inside in (("float64", True), ("tf32", False)):
            px = P.pixels(coefs, 75, 70, 130, precision, sub)
            outside = int(((px < lo) | (px > hi)).sum())
            assert (outside == 0) == inside, (sub, precision, outside)


def test_the_serial_decode_checks_restart_markers():
    _, _, data = plain((130, 70), "422", 7)  # 81 MCUs: RST0-7, RST0-2
    i = data.index(b"\xff\xd1", data.index(b"\xff\xda"))
    with pytest.raises(ValueError, match="RST1"):
        P.decode_coefficients(data[:i + 1] + b"\xd2" + data[i + 2:])
    last = data.rindex(b"\xff\xd2")
    with pytest.raises(ValueError, match="11 restart intervals where 12"):
        P.decode_coefficients(data[:last] + data[last + 2:])
    gray = bytearray(data)
    sof = gray.index(b"\xff\xc0")
    gray[sof + 11] = 0x41  # Y sampled 4x1: 4:1:1
    with pytest.raises(ValueError, match="sampling"):
        P.decode_coefficients(bytes(gray))


BASE = {"kind": "frames", "width": 64, "height": 48, "quality": 75,
        "noise": 10, "roll": 97, "subsampling": "420"}


@pytest.mark.parametrize("key,value", [
    ("subsampling", "420"), ("subsampling", "422"), ("subsampling", "444"),
    ("restart_interval", 0), ("restart_interval", 1),
    ("restart_interval", 240), ("restart_interval", 65535)])
def test_check_config_takes_the_stated_sampling_and_restarts(key, value):
    inputs.check_config(dict(BASE, **{key: value}))


@pytest.mark.parametrize("key,value,why", [
    ("subsampling", "411", "1x1 chroma"), ("subsampling", 420, "1x1 chroma"),
    ("restart_interval", 65536, "16 bits"), ("restart_interval", -1, "16 bits"),
    ("restart_interval", True, "16 bits"), ("restart_interval", 240.0, "16 bits"),
    ("optimize_tables", True, "Annex K"),
    ("huffman_tables", "libjpeg-turbo optimized", "Annex K"),
    ("kind", "tiles", "frames or a mix"), ("progressive", True, "progressive")])
def test_check_config_refuses_the_rest_and_says_why(key, value, why):
    with pytest.raises(ValueError, match=key) as e:
        inputs.check_config(dict(BASE, **{key: value}))
    assert why in str(e.value)


def test_an_encode_stream_refuses_restart_intervals_at_open():
    from lib import harness

    spec = harness.load_spec()
    with pytest.raises(ValueError, match="restart_interval=7"):
        harness.run_cell(spec, "uhd-encode-stream", 1, 0.5, False,
                         device="cpu", config_override={
                             "width": 64, "height": 48, "restart_interval": 7})


def test_a_long_interval_writes_no_marker_and_each_image_counts_its_own():
    img, _, _ = plain((130, 70), "422", 0)
    coefs = P.coefficients(img[None], 75, subsampling="422")
    one = P.scans(coefs)[0]
    split = P.scans(coefs, 1000)[0]  # one interval covers every MCU
    assert one == split
    assert P.scans(torch.cat([coefs, coefs]), 7)[1] == P.scans(coefs, 7)[0]
