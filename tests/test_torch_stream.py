"""jpeg_tpu_torch.encode_stream / decode_stream (device="cpu") against the
port's per-image calls and against jpeg_tpu, and the port's counters and
caches under threads.

Tolerances:
  - encode_stream: every yielded stream equals the port's encode() of its
    image, and jpeg_tpu.encode_stream(device_pack=True) run on the exact
    integer transform (the jax_exact_transform fixture), plain and with
    optimize_tables. Tolerance 0.
  - decode_stream: every yielded array equals the port's decode() of its
    stream exactly, in input order; within 1 level in at most 0.5% of the
    samples of jpeg_tpu.decode_stream.
Every emitted stream opens in PIL."""

import collections
import contextlib
import io
import sys
import threading

import numpy as np
import pytest
import torch
from PIL import Image

import jpeg_tpu

import jpeg_tpu_torch
from jpeg_tpu_torch.io import jfif
from jpeg_tpu_torch.models import encoder as PE
from jpeg_tpu_torch.models.progressive_enc import encode_progressive
from jpeg_tpu_torch.ops import _cuda, fused, mcu_conv, pack

from torch_port_util import jax_exact_transform, make_image  # noqa: F401

SHAPES = [(48, 64), (37, 53), (64, 96), (16, 16), (40, 50)]


def _images(shapes=SHAPES):
    return [make_image(h, w, seed=h + w) for h, w in shapes]


@pytest.mark.parametrize("depth", [0, 1, 2, 4])
@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("device_pack", [None, False])
def test_encode_stream_equals_encode(depth, optimize, device_pack):
    imgs = _images()
    got = list(jpeg_tpu_torch.encode_stream(
        iter(imgs), 80, "420", depth=depth, optimize_tables=optimize,
        device_pack=device_pack, device="cpu"))
    assert got == [jpeg_tpu_torch.encode(im, 80, "420",
                                         optimize_tables=optimize,
                                         device="cpu") for im in imgs]
    for jpg, im in zip(got, imgs):
        pil = Image.open(io.BytesIO(jpg))
        pil.load()
        assert pil.size == (im.shape[1], im.shape[0])


@pytest.mark.parametrize("mode", ["420", "444", "422"])
@pytest.mark.parametrize("optimize", [False, True])
def test_encode_stream_matches_jax(jax_exact_transform, mode, optimize):
    imgs = _images([(48, 64), (37, 53), (48, 64)])
    kw = dict(quality=85, subsampling=mode, optimize_tables=optimize)
    ref = list(jpeg_tpu.encode_stream(iter(imgs), device_pack=True, **kw))
    assert list(jpeg_tpu_torch.encode_stream(iter(imgs), device="cpu",
                                             **kw)) == ref


def test_encode_stream_pulls_images_as_it_goes():
    """With `depth` images in flight the generator has taken depth + 1 images
    when it yields the first stream: a long input is never resident."""
    taken = []

    def source():
        for i, im in enumerate(_images()):
            taken.append(i)
            yield im

    stream = jpeg_tpu_torch.encode_stream(source(), depth=2, device="cpu")
    next(stream)
    assert taken == [0, 1, 2]
    next(stream)
    assert taken == [0, 1, 2, 3]
    assert len(list(stream)) == 3


def test_encode_stream_input_conventions():
    f = make_image(24, 40).astype(np.float32) + 0.4
    got = list(jpeg_tpu_torch.encode_stream([f], device="cpu"))
    assert got == [jpeg_tpu_torch.encode(f, device="cpu")]
    with pytest.raises(ValueError, match=r"expected \(H, W, 3\)"):
        list(jpeg_tpu_torch.encode_stream([f[..., 0]], device="cpu"))
    with pytest.raises(ValueError, match=r"expected \(H, W, 3\)"):
        list(jpeg_tpu.encode_stream([f[..., 0]]))


def test_encode_stream_spills_only_the_dense_image():
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:24, 0:32]
    smooth = np.stack([xx * 4, yy * 5, xx + yy], -1).astype(np.uint8)
    noise = rng.integers(0, 256, size=(24, 32, 3)).astype(np.uint8)
    spills = PE.HOST_PACK_SPILLS
    got = list(jpeg_tpu_torch.encode_stream(
        [smooth, noise, smooth], 100, "444", device="cpu"))
    assert PE.HOST_PACK_SPILLS == spills + 1
    assert got == [jpeg_tpu_torch.encode(im, 100, "444", device="cpu")
                   for im in (smooth, noise, smooth)]


def _mixed_streams():
    """Colour streams of three samplings and sizes, a gray one, one with
    restarts and optimal tables, a progressive one."""
    imgs = _images()
    out = [jpeg_tpu_torch.encode(im, 80, mode, device="cpu")
           for im, mode in zip(imgs, ("420", "444", "422", "420", "411"))]
    out.append(jpeg_tpu_torch.encode(imgs[1][..., 0], 70, device="cpu"))
    out.append(jpeg_tpu_torch.encode(imgs[2], 90, "420", 4,
                                     optimize_tables=True, device="cpu"))
    out.append(encode_progressive(imgs[0], 75, "420", device="cpu"))
    return out


@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("scale_denom", [1, 2])
def test_decode_stream_equals_decode(depth, scale_denom):
    jpgs = _mixed_streams()
    got = list(jpeg_tpu_torch.decode_stream(
        iter(jpgs), depth=depth, scale_denom=scale_denom, device="cpu"))
    assert len(got) == len(jpgs)
    for out, jpg in zip(got, jpgs):
        assert isinstance(out, np.ndarray)
        np.testing.assert_array_equal(out, jpeg_tpu_torch.decode(
            jpg, device="cpu", scale_denom=scale_denom))


@pytest.mark.parametrize("entropy", ["native", "sparse", "numpy"])
def test_decode_stream_options(entropy):
    jpgs = _mixed_streams()[:4]
    got = list(jpeg_tpu_torch.decode_stream(
        jpgs, fancy_upsample=False, entropy=entropy, device_output=True,
        device="cpu"))
    for out, jpg in zip(got, jpgs):
        assert isinstance(out, torch.Tensor)
        np.testing.assert_array_equal(out.numpy(), jpeg_tpu_torch.decode(
            jpg, device="cpu", fancy_upsample=False))


def test_decode_stream_close_to_jax():
    jpgs = _mixed_streams()
    ref = list(jpeg_tpu.decode_stream(iter(jpgs)))
    got = list(jpeg_tpu_torch.decode_stream(iter(jpgs), device="cpu"))
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        diff = np.abs(a.astype(np.int32) - np.asarray(b).astype(np.int32))
        assert diff.max() <= 1
        assert (diff != 0).sum() <= 0.005 * diff.size


@pytest.mark.parametrize("depth", [1, 3])
def test_decode_stream_raises_a_workers_error_at_its_turn(depth):
    jpgs = _mixed_streams()[:3]
    datas = [jpgs[0], b"not a jpeg stream", jpgs[2], jpgs[0]]
    stream = jpeg_tpu_torch.decode_stream(datas, depth=depth, device="cpu")
    np.testing.assert_array_equal(
        next(stream), jpeg_tpu_torch.decode(jpgs[0], device="cpu"))
    with pytest.raises(jfif.JpegFormatError):
        next(stream)
    ref = jpeg_tpu.decode_stream(datas, depth=depth)
    next(ref)
    with pytest.raises(ValueError):
        next(ref)


@contextlib.contextmanager
def _eager_thread_switches():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


def _hammer(fn, threads: int):
    """fn(i) on `threads` threads at once; returns their results in order."""
    results, errors = [None] * threads, []
    gate = threading.Barrier(threads)

    def run(i):
        try:
            gate.wait(timeout=60)
            results[i] = fn(i)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    workers = [threading.Thread(target=run, args=(i,)) for i in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=300)
        assert not w.is_alive()
    assert not errors, errors
    return results


class _NoKernels:
    """Stands in for a built kernel library: every entry returns success."""

    def __getattr__(self, name):
        return lambda *args: 0


def test_launch_counters_are_exact_under_threads(monkeypatch):
    """The counters count launches made from worker threads (decode_stream).
    The CPU twins count nothing, so the three launch helpers run here
    against a stand-in for the kernel libraries: what is under test is the
    increment, which loses updates without its lock."""
    monkeypatch.setattr(_cuda, "load", lambda name: _NoKernels())
    monkeypatch.setattr(_cuda, "stream_handle", lambda dev: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    plane = torch.zeros((8, 8), dtype=torch.int32)
    q = torch.ones(64)
    before = pack.LAUNCHES, fused.LAUNCHES, fused.DCT_LAUNCHES
    per_thread, threads = 3000, 8

    def launch(_):
        for _ in range(per_thread):
            fused._launch_idct(plane, q, plane)
            fused._launch_dct(plane, q, plane)
            pack._launch(plane, plane, plane, plane, plane)

    with _eager_thread_switches():
        _hammer(launch, threads)
    n = per_thread * threads
    assert (pack.LAUNCHES, fused.LAUNCHES, fused.DCT_LAUNCHES) == tuple(
        b + n for b in before)


def test_constant_cache_counts_every_fill_under_threads(monkeypatch):
    """mcu_conv.constant from 16 threads over a cache of two entries, so
    that it misses and evicts all the time: every call returns its values,
    the cache stays within its bound, and CONSTANT_UPLOADS counts every fill
    (a fill settles its tensor exactly once), which a non-atomic increment
    without the lock would not."""
    monkeypatch.setattr(mcu_conv, "_constants", collections.OrderedDict())
    monkeypatch.setattr(mcu_conv, "_CONSTANTS_SIZE", 2)
    fills, lock = [0], threading.Lock()
    settled = _cuda.settled

    def counted(t):
        with lock:
            fills[0] += 1
        return settled(t)

    monkeypatch.setattr(_cuda, "settled", counted)
    before = mcu_conv.CONSTANT_UPLOADS
    per_thread, threads = 400, 16

    def work(t):
        ok = True
        for i in range(per_thread):
            values = np.array([(t + i) % 5, 7], np.int32)
            got = mcu_conv.constant(values, "cpu")
            ok &= got.tolist() == values.tolist()
        return ok

    with _eager_thread_switches():
        assert all(_hammer(work, threads))
    assert len(mcu_conv._constants) <= 2
    assert fills[0] > 5
    assert mcu_conv.CONSTANT_UPLOADS - before == fills[0]


def test_decode_and_encode_from_four_threads():
    """decode() and encode() from 4 threads at once, each with tables of its
    own (the LUT cache fills and evicts): every result equals the serial
    one, and every dense image is counted as one spill."""
    imgs = _images()
    rng = np.random.default_rng(3)
    noise = rng.integers(0, 256, size=(16, 24, 3)).astype(np.uint8)
    jpgs = [jpeg_tpu_torch.encode(im, 80, "420", device="cpu") for im in imgs]
    want_px = [jpeg_tpu_torch.decode(j, device="cpu") for j in jpgs]
    want_opt = [jpeg_tpu_torch.encode(im, 70 + i, "420", optimize_tables=True,
                                      device="cpu")
                for i, im in enumerate(imgs)]
    rounds = 3
    spills = PE.HOST_PACK_SPILLS

    def work(t):
        out = []
        for _ in range(rounds):
            for i in range(len(imgs)):
                j = (i + t) % len(imgs)
                out.append(np.array_equal(
                    jpeg_tpu_torch.decode(jpgs[j], device="cpu"), want_px[j]))
                out.append(jpeg_tpu_torch.encode(
                    imgs[j], 70 + j, "420", optimize_tables=True,
                    device="cpu") == want_opt[j])
            jpeg_tpu_torch.encode(noise, 100, "444", device="cpu")
        return all(out)

    with _eager_thread_switches():
        assert all(_hammer(work, 4))
    assert PE.HOST_PACK_SPILLS == spills + 4 * rounds
