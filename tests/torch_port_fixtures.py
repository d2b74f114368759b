"""Small JPEG streams of the kinds the port's own encoder cannot write,
committed under tests/data/torch_port/ so that a machine with neither jax
nor PIL (the GPU smoke run, chip_smoke.py) can still decode them.

Each stream is built from a numpy seed by jpeg_tpu's encoders or by PIL:

    JAX_PLATFORMS=cpu python tests/torch_port_fixtures.py

rewrites every file. tests/test_torch_decode_streams.py rebuilds them and
compares bytes, so a fixture cannot drift from its recipe unnoticed.
"""

from __future__ import annotations

import io
import pathlib

import numpy as np

from torch_port_util import make_image

DATA_DIR = pathlib.Path(__file__).resolve().parent / "data" / "torch_port"


def _progressive_420():
    from jpeg_tpu.models.progressive_enc import encode_progressive

    return encode_progressive(make_image(131, 203, seed=41), quality=80,
                              subsampling="420")


def _progressive_gray():
    from jpeg_tpu.models.progressive_enc import encode_progressive

    return encode_progressive(make_image(75, 97, seed=42)[..., 1], quality=70)


def _progressive_pil_422():
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(make_image(90, 150, seed=43)).save(
        buf, "JPEG", progressive=True, quality=85, subsampling=1)
    return buf.getvalue()


def _noninterleaved():
    import jpeg_tpu

    return jpeg_tpu.encode_noninterleaved(make_image(88, 120, seed=44),
                                          quality=75, restart_interval=5)


def cmyk_image(h, w, seed):
    """(h, w, 4) uint8: smooth ramps plus noise, so every plane has detail."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    a = np.stack([xx * 4, yy * 5, (xx + yy) * 2, 255 - xx * 3], -1)
    return np.clip(a + rng.integers(-6, 7, a.shape), 0, 255).astype(np.uint8)


def _cmyk():
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(cmyk_image(48, 64, 45), mode="CMYK").save(
        buf, "JPEG", quality=90)
    return buf.getvalue()


def _ycck():
    import test_cmyk  # the JAX package's own YCCK writer

    return test_cmyk._craft_ycck(cmyk_image(32, 40, 46))


# name -> (recipe, decoded shape)
FIXTURES = {
    "progressive_420.jpg": (_progressive_420, (131, 203, 3)),
    "progressive_gray.jpg": (_progressive_gray, (75, 97)),
    "progressive_pil_422.jpg": (_progressive_pil_422, (90, 150, 3)),
    "noninterleaved_444.jpg": (_noninterleaved, (88, 120, 3)),
    "cmyk.jpg": (_cmyk, (48, 64, 4)),
    "ycck.jpg": (_ycck, (32, 40, 4)),
}


def read(name: str) -> bytes:
    return (DATA_DIR / name).read_bytes()


def write_all() -> None:
    DATA_DIR.mkdir(parents=True, exist_ok=True)
    for name, (build, _shape) in FIXTURES.items():
        data = build()
        (DATA_DIR / name).write_bytes(data)
        print(f"{name}: {len(data)} bytes")


if __name__ == "__main__":
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    import jax

    jax.config.update("jax_platforms", "cpu")
    write_all()
