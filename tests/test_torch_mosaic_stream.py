"""The port's streaming mosaic encode (parallel.mosaic.encode_mosaic_stream,
device="cpu") against the port's whole-image encode() at the same restart
interval, and against jpeg_tpu's encode_mosaic_stream run on the exact
integer transform (the jax_exact_transform fixture). Tolerance 0: the same
bytes. The cases of tests/test_mosaic_stream.py but the gigapixel one.

Every stripe is packed on the device path (kernel A and the scan pass, their
plain twins here: level 2 and the native finalize); forcing every stripe's
scan pass to report an overflow sends it to the native host packer instead,
and the bytes stay the same."""

import io

import numpy as np
import pytest
from PIL import Image

from jpeg_tpu.parallel.mosaic import encode_mosaic_stream as jax_stream

import jpeg_tpu_torch
from jpeg_tpu_torch.config import Subsampling
from jpeg_tpu_torch.models import encoder as PE
from jpeg_tpu_torch.ops import pack as PP
from jpeg_tpu_torch.parallel import mosaic as PMo

from torch_port_util import jax_exact_transform  # noqa: F401


def _stream(img, **kw):
    h, w = img.shape[:2]
    return PMo.encode_mosaic_stream(lambda a, b: img[a:b], h, w,
                                    device="cpu", **kw)


def _all_stripes_spill(monkeypatch):
    orig = PP.pack_scan

    def overflow(*a, **k):
        scan, status = orig(*a, **k)
        status = status.clone()
        status[status.shape[0] // 2:] = 0  # every ok flag, and the count
        return scan, status

    monkeypatch.setattr(PP, "pack_scan", overflow)


@pytest.mark.parametrize("sub,rst_rows", [("420", 1), ("444", 2), ("422", 1)])
def test_stream_matches_whole_image_encode(jax_exact_transform, rng, sub,
                                           rst_rows, monkeypatch):
    h, w = 167, 230  # odd: bottom/right edge padding on the last stripe
    img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    mode = Subsampling(sub)
    r = rst_rows * (-(-w // mode.mcu_width))
    kw = dict(quality=80, subsampling=sub,
              stripe_rows=mode.mcu_height * rst_rows * 2, rst_rows=rst_rows)
    got = _stream(img, **kw)
    assert got == jpeg_tpu_torch.encode(img, quality=80, subsampling=sub,
                                        restart_interval=r, device="cpu")
    assert got == jax_stream(lambda a, b: img[a:b], h, w, **kw)
    _all_stripes_spill(monkeypatch)
    before = PE.HOST_PACK_SPILLS
    assert _stream(img, **kw) == got
    stripes = -(-h // kw["stripe_rows"])
    assert PE.HOST_PACK_SPILLS == before + stripes


def test_stream_optimized_tables_two_pass(jax_exact_transform, rng):
    h, w = 96, 160
    img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    r = w // 16
    calls = []

    def source(a, b):
        calls.append((a, b))
        return img[a:b]

    got = PMo.encode_mosaic_stream(source, h, w, quality=85,
                                   subsampling="420", stripe_rows=32,
                                   optimize_tables=True, device="cpu")
    assert got == jpeg_tpu_torch.encode(img, quality=85, subsampling="420",
                                        restart_interval=r,
                                        optimize_tables=True, device="cpu")
    assert got == jax_stream(lambda a, b: img[a:b], h, w, quality=85,
                             subsampling="420", stripe_rows=32,
                             optimize_tables=True)
    # Two passes over the stripes: histogram pass + pack pass.
    assert len(calls) == 2 * len(set(calls))


def test_stream_file_sink_and_decode(rng, tmp_path):
    h, w = 130, 96
    img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    path = tmp_path / "m.jpg"
    with open(path, "wb") as f:
        assert PMo.encode_mosaic_stream(lambda a, b: img[a:b], h, w,
                                        quality=90, out=f,
                                        device="cpu") is None
    data = path.read_bytes()
    assert data == _stream(img, quality=90)
    ours = jpeg_tpu_torch.decode(data, device="cpu")
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert ours.shape == (h, w, 3)
    mse = np.mean((ours.astype(np.float64) - pil) ** 2)
    assert 10 * np.log10(255.0 ** 2 / mse) > 40.0


def test_stream_validates_arguments(rng):
    img = rng.integers(0, 256, (32, 32, 3)).astype(np.uint8)
    with pytest.raises(ValueError):
        PMo.encode_mosaic_stream(lambda a, b: img[a:b], 0, 32, device="cpu")
    with pytest.raises(ValueError, match="DRI"):
        PMo.encode_mosaic_stream(lambda a, b: img[a:b], 32, 16 * 70000,
                                 device="cpu")
    with pytest.raises(ValueError, match="source returned"):
        PMo.encode_mosaic_stream(lambda a, b: img[a:b, :16], 32, 32,
                                 device="cpu")
    with pytest.raises(ValueError, match="restart groups"):
        PMo.encode_mosaic_stream(lambda a, b: img[a:b], 32, 32,
                                 stripe_rows=48, rst_rows=2, device="cpu")
