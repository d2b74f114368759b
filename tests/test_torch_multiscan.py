"""jpeg_tpu_torch.encode_noninterleaved (device="cpu") against
jpeg_tpu.encode_noninterleaved, and the port's copy of the NumPy scan packer
(entropy/encode_np) against the native packer.

Tolerance 0 everywhere: the reference runs on the exact integer transform
(the jax_exact_transform fixture; on the CPU it would otherwise take its
staged float transform, 1 off at .5 boundaries), and both packers are exact.
Every stream opens in PIL, and the port decodes it to the pixels of the
4:4:4 baseline stream of the same image."""

import io

import numpy as np
import pytest
from PIL import Image

import jpeg_tpu
from jpeg_tpu.entropy import encode_np as JN

import jpeg_tpu_torch
from jpeg_tpu_torch.entropy import encode_np as PN, huffman, native
from jpeg_tpu_torch.io import jfif

from torch_port_util import jax_exact_transform, make_image, random_blocks  # noqa: F401


@pytest.mark.parametrize("shape", [(48, 64), (37, 53)])
@pytest.mark.parametrize("restart", [0, 5])
@pytest.mark.parametrize("optimize", [False, True])
def test_noninterleaved_bytes_match_jax(jax_exact_transform, shape, restart,
                                        optimize):
    img = make_image(*shape, seed=shape[0])
    kw = dict(quality=85, restart_interval=restart, optimize_tables=optimize)
    got = jpeg_tpu_torch.encode_noninterleaved(img, device="cpu", **kw)
    assert got == jpeg_tpu.encode_noninterleaved(img, **kw)


@pytest.mark.parametrize("shape,restart,optimize", [
    ((48, 64), 0, False), ((37, 53), 3, True), ((8, 8), 0, True),
    ((13, 100), 1, False),
])
def test_noninterleaved_structure_and_pixels(shape, restart, optimize):
    img = make_image(*shape, seed=shape[1])
    jpg = jpeg_tpu_torch.encode_noninterleaved(
        img, 80, restart_interval=restart, optimize_tables=optimize,
        device="cpu")
    info = jfif.parse_jpeg(jpg)
    assert (info.width, info.height) == (shape[1], shape[0])
    assert not info.progressive and len(info.scans) == 3
    assert [s.comp_ids for s in info.scans] == [
        [(1, 0, 0)], [(2, 1, 1)], [(3, 1, 1)]]
    assert info.restart_interval == restart
    pil = Image.open(io.BytesIO(jpg))
    pil.load()
    assert pil.size == (shape[1], shape[0])
    base = jpeg_tpu_torch.encode(img, 80, "444", device="cpu")
    np.testing.assert_array_equal(jpeg_tpu_torch.decode(jpg, device="cpu"),
                                  jpeg_tpu_torch.decode(base, device="cpu"))


def test_noninterleaved_inputs(tmp_path):
    from jpeg_tpu_torch.io import bmp

    img = make_image(20, 36, seed=3)
    path = tmp_path / "in.bmp"
    bmp.write_bmp(str(path), img)
    assert jpeg_tpu_torch.encode_noninterleaved(
        str(path), device="cpu") == jpeg_tpu_torch.encode_noninterleaved(
            img, device="cpu")
    with pytest.raises(ValueError, match=r"expected \(H, W, 3\)"):
        jpeg_tpu_torch.encode_noninterleaved(img[..., 0], device="cpu")
    with pytest.raises(ValueError, match="quality"):
        jpeg_tpu_torch.encode_noninterleaved(img, quality=101, device="cpu")


@pytest.mark.parametrize("density,restart,bpm", [
    (0.0, 0, 1), (0.15, 0, 1), (0.5, 7, 1), (0.15, 4, 3), (0.3, 1000, 6),
])
def test_numpy_packer_copy_matches_native_and_jax(density, restart, bpm):
    """encode_np is a copy with only its place changed: the same records,
    counts and bytes as jpeg_tpu's, and the native packer's bytes."""
    rng = np.random.default_rng(int(density * 100) + restart)
    blocks = random_blocks(rng, 240, density)
    blocks[::7, 1:40] = 0  # long zero runs: ZRL symbols
    tbl = (np.arange(240) % bpm >= max(1, bpm - 2)).astype(np.int64)
    std = huffman.standard_tables()
    rec, ref = PN.build_records(blocks, tbl, tbl), JN.build_records(
        blocks, tbl, tbl)
    for f in ("block", "is_ac", "tbl", "symbol", "esize", "extra"):
        np.testing.assert_array_equal(getattr(rec, f), getattr(ref, f))
    freq = PN.count_frequencies(rec)
    for key, want in native.count_frequencies(blocks, tbl).items():
        np.testing.assert_array_equal(freq[key], want)
    for tables in (std, {k: huffman.optimal_table(v + 1)
                         for k, v in freq.items()}):
        got = PN.encode_scan(blocks, tbl, tbl, tables,
                             restart_interval=restart, blocks_per_mcu=bpm)
        assert got == JN.encode_scan(blocks, tbl, tbl, tables,
                                     restart_interval=restart,
                                     blocks_per_mcu=bpm)
        assert got == native.encode_scan(blocks, tbl, tables,
                                         restart_interval=restart,
                                         blocks_per_mcu=bpm)
