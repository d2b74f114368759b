"""The port's single-process mesh layer (jpeg_tpu_torch.parallel: mesh,
shard, batch, encode_mosaic) on an 8-position CPU mesh, against the port's
own single-image calls and against jpeg_tpu.parallel on its 8 virtual CPU
devices.

Tolerances:
  - blocks, histograms and encoded bytes: equal to jpeg_tpu's run on the
    exact integer transform (the jax_exact_sharded fixture: on the CPU the
    reference would otherwise take its staged float transform, 1 off at .5
    boundaries), and to the port's encode() at the same restart interval.
    Tolerance 0.
  - decode_batch: exactly equal to the port's decode() per image; within 1
    level in at most 0.5% of the samples of jpeg_tpu's decode_batch, whose
    CPU finish takes a separable IDCT that sums in another order.
"""

import numpy as np
import pytest
import torch

from jpeg_tpu.parallel import batch as JB, mesh as JMesh, mosaic as JMo
from jpeg_tpu.parallel import shard as JS

import jpeg_tpu_torch
from jpeg_tpu_torch.config import Subsampling
from jpeg_tpu_torch.entropy import encode_np
from jpeg_tpu_torch.io import jfif
from jpeg_tpu_torch.models.encoder import interleave_mcus
from jpeg_tpu_torch.ops import quant
from jpeg_tpu_torch.parallel import batch as PB, mesh as PM, mosaic as PMo
from jpeg_tpu_torch.parallel import shard as PS

from torch_port_util import (  # noqa: F401
    cpu_mesh, jax_exact_sharded, jax_exact_transform, parallel_images)

DIFF_SHARE = 0.005


def _encode(img, **kw):
    return jpeg_tpu_torch.encode(img, device="cpu", **kw)


def test_mesh_shapes():
    for n, ba in ((8, None), (8, 4), (8, 2), (4, None), (1, None), (6, 2)):
        if 8 % n == 0:
            assert cpu_mesh(n, ba).shape == dict(JMesh.make_mesh(n, ba).shape)
    assert cpu_mesh(8, 4).shape == {"batch": 4, "mcu": 2}
    assert cpu_mesh(6, 2).shape == {"batch": 2, "mcu": 3}
    assert cpu_mesh(8).axis_names == ("batch", "mcu")
    with pytest.raises(ValueError):
        cpu_mesh(8, 3)
    with pytest.raises(ValueError):
        PM.make_mesh(9, devices=["cpu"] * 8)
    # Neither an address nor an initialized process group: it raises.
    with pytest.raises(RuntimeError, match="no initialized"):
        PM.make_multihost_mesh(devices=["cpu"] * 4)


def test_make_mesh_without_cuda_raises(monkeypatch):
    """No CUDA device and no devices= given: make_mesh raises, it never
    puts the mesh on the CPU; encode_batch without a mesh raises too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PM.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PB.encode_batch(parallel_images(np.random.default_rng(0), b=1))


def test_collectives_and_to_host():
    mesh = cpu_mesh(8, 2)
    x = np.arange(2 * 8 * 3).reshape(2, 8, 3)
    grid = PM.shard(x, mesh)
    assert grid.shape == (2, 4) and tuple(grid[1, 2].shape) == (1, 2, 3)
    np.testing.assert_array_equal(PM.to_host(grid), x)
    moved = PM.to_host(PM.ppermute(grid, "mcu", [(0, 1), (1, 2), (2, 3)]))
    np.testing.assert_array_equal(moved[:, 2:], x[:, :6])
    np.testing.assert_array_equal(moved[:, :2], 0)
    total = PM.psum(grid, ("batch", "mcu"))
    for t in total.flat:
        np.testing.assert_array_equal(
            t.numpy(), x.reshape(2, 1, 4, 2, 3).sum(axis=(0, 2)))
    rows = PM.psum(grid, "mcu")
    np.testing.assert_array_equal(
        rows[1, 0].numpy(), x[1:].reshape(4, 2, 3).sum(axis=0)[None])
    assert tuple(rows[1, 0].shape) == (1, 2, 3)
    with pytest.raises(ValueError):
        PM.shard(np.zeros((3, 8)), mesh)


@pytest.mark.parametrize("mode", [Subsampling.YUV444, Subsampling.YUV420])
@pytest.mark.parametrize("stripe_restart", [False, True])
def test_sharded_blocks_match_jax(jax_exact_sharded, rng, mode,
                                  stripe_restart):
    from jpeg_tpu.config import Subsampling as JSub

    imgs = parallel_images(rng, b=2, h=mode.mcu_height * 4,
                           w=mode.mcu_width * 3)
    qy, qc = quant.luma_table(75), quant.chroma_table(75)
    got = PS.sharded_encode_blocks(imgs, qy, qc, cpu_mesh(8, 2), mode,
                                   stripe_restart=stripe_restart)
    want = JS.sharded_encode_blocks(imgs, qy, qc, JMesh.make_mesh(8, 2),
                                    JSub(mode.value),
                                    stripe_restart=stripe_restart)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(PM.to_host(g), np.asarray(w))
    # Against one position: equal without stripe restarts; with them only
    # the stripes' first DC differences differ.
    one = PS.sharded_encode_blocks(imgs, qy, qc, cpu_mesh(1), mode)
    for g, o in zip(got[:3], one[:3]):
        g, o = PM.to_host(g), PM.to_host(o)
        if stripe_restart:
            np.testing.assert_array_equal(g[:, :, 1:], o[:, :, 1:])
        else:
            np.testing.assert_array_equal(g, o)
    if not stripe_restart:
        np.testing.assert_array_equal(PM.to_host(got[3]), PM.to_host(one[3]))


def test_sharded_hists_match_record_counts(rng):
    """The psum'd histograms equal the NumPy record-stream counts."""
    mode = Subsampling.YUV444
    imgs = parallel_images(rng, b=2, h=32, w=24)
    qy, qc = quant.luma_table(60), quant.chroma_table(60)
    y, cb, cr, hists = PS.sharded_encode_blocks(imgs, qy, qc, cpu_mesh(4, 2),
                                                mode)
    y, cb, cr, hists = (PM.to_host(a) for a in (y, cb, cr, hists))
    want = {k: np.zeros(256, np.int64) for k in ((0, 0), (1, 0), (0, 1),
                                                  (1, 1))}
    for i in range(imgs.shape[0]):
        blocks, tbl = interleave_mcus(y[i], cb[i], cr[i], 1)
        f = encode_np.count_frequencies(encode_np.build_records(blocks, tbl,
                                                                tbl))
        for k in want:
            want[k] += f[k]
    for row, k in enumerate(((0, 0), (1, 0), (0, 1), (1, 1))):
        np.testing.assert_array_equal(hists[row], want[k])
    np.testing.assert_array_equal(
        PM.to_host(PS.sharded_histograms(imgs, qy, qc, cpu_mesh(4, 2), mode,
                                         stripe_restart=False)), hists)


@pytest.mark.parametrize("stripe_restart,device_pack,optimize", [
    (False, False, False), (True, False, False), (True, True, False),
    (True, False, True), (True, True, True),
])
def test_encode_batch_matches_jax(jax_exact_sharded, rng, stripe_restart,
                                  device_pack, optimize):
    imgs = parallel_images(rng, b=4, h=64, w=48)
    kw = dict(quality=80, subsampling="420", stripe_restart=stripe_restart,
              optimize_tables=optimize)
    got = PB.encode_batch(imgs, mesh=cpu_mesh(8, 2), device_pack=device_pack,
                          **kw)
    want = JB.encode_batch(imgs, mesh=JMesh.make_mesh(8, 2),
                           device_pack=device_pack, **kw)
    assert got == want
    # 64 rows of 4:2:0 are 4 MCU rows: one per stripe of the 4-way axis.
    r = 3 if stripe_restart else 0
    if not optimize:
        assert got == [_encode(im, quality=80, restart_interval=r)
                       for im in imgs]
    else:
        assert got != PB.encode_batch(imgs, mesh=cpu_mesh(8, 2),
                                      device_pack=device_pack,
                                      **dict(kw, optimize_tables=False))
    if device_pack:
        assert got == PB.encode_batch(imgs, mesh=cpu_mesh(8, 2),
                                      device_pack=False, **kw)


def test_device_pack_overflow_falls_back(rng, monkeypatch):
    """A stripe over the per-block budget sends the batch to the host pack,
    counted in DEVICE_PACK_FALLBACKS; the bytes do not change."""
    imgs = parallel_images(rng, b=2, h=64, w=48)
    mesh = cpu_mesh(8, 2)
    want = PB.encode_batch(imgs, mesh=mesh, device_pack=False)
    orig = PS._stripe_step_packed

    def overflow(*a, **k):
        words, totals, ok = orig(*a, **k)
        return words, totals, torch.zeros_like(ok)

    monkeypatch.setattr(PS, "_stripe_step_packed", overflow)
    before = PB.DEVICE_PACK_FALLBACKS
    assert PB.encode_batch(imgs, mesh=mesh, device_pack=True) == want
    assert PB.DEVICE_PACK_FALLBACKS == before + 1


def test_odd_batch_padding(jax_exact_sharded, rng):
    imgs = parallel_images(rng, b=2, h=50, w=30)  # not MCU-aligned
    got = PB.encode_batch(imgs, quality=85, mesh=cpu_mesh(4, 2))
    want = JB.encode_batch(imgs, quality=85, mesh=JMesh.make_mesh(4, 2))
    assert got == want
    for jpg, img in zip(got, imgs):
        assert jpeg_tpu_torch.decode(jpg, device="cpu").shape == img.shape


def test_encode_mosaic_matches_jax_and_encode(jax_exact_sharded, rng):
    tiles = parallel_images(rng, b=16, h=64, w=64).reshape(4, 4, 64, 64, 3)
    big = PMo.assemble_tiles(tiles)
    np.testing.assert_array_equal(big, JMo.assemble_tiles(tiles))
    assert big.shape == (256, 256, 3)
    got = PMo.encode_mosaic(big, quality=80, mesh=cpu_mesh(8, 1))
    assert got == JMo.encode_mosaic(big, quality=80,
                                    mesh=JMesh.make_mesh(8, 1))
    # 16 MCU rows of 16 MCUs over 8 stripes: a restart every 32 MCUs.
    assert jfif.parse_jpeg(got).restart_interval == 32
    assert got == _encode(big, quality=80, restart_interval=32)
    assert got == PMo.encode_mosaic(big, quality=80, mesh=cpu_mesh(8, 1),
                                    device_pack=True)


@pytest.mark.parametrize("mode,w", [("444", 48), ("420", 48), ("411", 64),
                                    ("440", 48)])
def test_decode_batch_matches_decode(jax_exact_sharded, rng, mode, w):
    imgs = parallel_images(rng, b=4, h=64, w=w)
    jpgs = PB.encode_batch(imgs, quality=80, subsampling=mode,
                           mesh=cpu_mesh(8, 2))
    ref = np.stack([jpeg_tpu_torch.decode(j, device="cpu") for j in jpgs])
    for entropy in ("auto", "device", "sparse"):
        got = PB.decode_batch(jpgs, mesh=cpu_mesh(8, 2), entropy=entropy)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, ref)
    jax_px = JB.decode_batch(jpgs, mesh=JMesh.make_mesh(8, 2))
    diff = np.abs(jax_px.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1
    assert (diff != 0).sum() <= DIFF_SHARE * diff.size


def test_sharded_decode_pixels_match_decoder(rng):
    """Random coefficients through the stripes with halo rows equal the
    port's single-device finish exactly."""
    from jpeg_tpu_torch.models import decoder as D

    mode = Subsampling.YUV420
    mesh = cpu_mesh(8, 2)
    mcu_rows, mcu_cols = 8, 3
    b = 2
    y = rng.integers(-40, 40, size=(b, mcu_rows * 4 * mcu_cols, 64))
    cb = rng.integers(-20, 20, size=(b, mcu_rows * mcu_cols, 64))
    cr = rng.integers(-20, 20, size=(b, mcu_rows * mcu_cols, 64))
    y, cb, cr = (a.astype(np.int32) for a in (y, cb, cr))
    qy, qc = quant.luma_table(75), quant.chroma_table(75)
    got = PM.to_host(PS.sharded_decode_pixels(y, cb, cr, qy, qc, mcu_cols,
                                              mesh, mode))
    q = [torch.as_tensor(t, dtype=torch.float32) for t in (qy, qc, qc)]
    shapes = ((mcu_rows * 2, mcu_cols * 2), (mcu_rows, mcu_cols),
              (mcu_rows, mcu_cols))
    for i in range(b):
        want = D._finish_color(torch.as_tensor(y[i]), torch.as_tensor(cb[i]),
                               torch.as_tensor(cr[i]), *q, shapes,
                               ((1, 1), (2, 2), (2, 2)))
        np.testing.assert_array_equal(got[i], want.numpy())
    with pytest.raises(ValueError, match="MCU rows"):
        PS.sharded_decode_pixels(y[:, :72], cb[:, :18], cr[:, :18], qy, qc,
                                 mcu_cols, mesh, mode)


def test_decode_batch_errors(rng):
    mesh = cpu_mesh(8, 2)
    imgs = parallel_images(rng, b=2, h=64, w=48)
    a = PB.encode_batch(imgs, quality=80, mesh=mesh)
    b = PB.encode_batch(imgs, quality=50, mesh=mesh)
    with pytest.raises(ValueError, match="homogeneous"):
        PB.decode_batch([a[0], b[1]], mesh=mesh)
    gray = [_encode(im[..., 0]) for im in imgs]
    with pytest.raises(ValueError, match="3-component"):
        PB.decode_batch(gray, mesh=mesh)
    # 48 rows of 4:2:0: 3 MCU rows over 4 stripes.
    short = [_encode(im[:48]) for im in imgs]
    with pytest.raises(ValueError, match="MCU rows"):
        PB.decode_batch(short, mesh=mesh)
    with pytest.raises(ValueError, match="unknown entropy backend"):
        PB.decode_batch(a, mesh=mesh, entropy="gpu")


def test_decode_batch_narrow_chroma_falls_back(rng):
    """Chroma at most 2 samples wide upsamples by replication in decode();
    decode_batch decodes such streams image by image, equal to decode()."""
    imgs = parallel_images(rng, b=2, h=64, w=4)
    jpgs = [_encode(im) for im in imgs]
    got = PB.decode_batch(jpgs, mesh=cpu_mesh(8, 2))
    ref = np.stack([jpeg_tpu_torch.decode(j, device="cpu") for j in jpgs])
    np.testing.assert_array_equal(got, ref)


def _sof_components(jpg: bytes):
    """Offset of the SOF0 component specs (id, sampling, qtable id)."""
    at = jpg.index(b"\xff\xc0")
    return at + 10


@pytest.mark.parametrize("kind", ["rgb_coded", "cr_on_luma_table"])
def test_decode_batch_other_layouts_decode_per_image(rng, kind):
    """Streams the stripe finish does not take (components stored as RGB,
    Cb and Cr on different quant tables) decode image by image, equal to
    decode()."""
    imgs = parallel_images(rng, b=2, h=64, w=48)
    jpgs = []
    for im in imgs:
        data = bytearray(_encode(im))
        at = _sof_components(data)
        if kind == "rgb_coded":
            for k, cid in enumerate(b"RGB"):
                data[at + 3 * k] = cid
            sos = data.index(b"\xff\xda") + 5
            for k, cid in enumerate(b"RGB"):
                data[sos + 2 * k] = cid
        else:
            data[at + 3 * 2 + 2] = 0
        jpgs.append(bytes(data))
    ref = np.stack([jpeg_tpu_torch.decode(j, device="cpu") for j in jpgs])
    np.testing.assert_array_equal(PB.decode_batch(jpgs, mesh=cpu_mesh(8, 2)),
                                  ref)
    plain = np.stack([jpeg_tpu_torch.decode(_encode(im), device="cpu")
                      for im in imgs])
    assert not np.array_equal(ref, plain)
