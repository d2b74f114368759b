"""The port's grayscale encode and decode against the JAX package, on the
CPU.

- gray_transform_int: bit-identical to jpeg_tpu's (tolerance 0).
- encode(gray, device="cpu"): bytes identical to the jpeg_tpu chain
  gray_transform_int -> dpcm -> pack_level1_pallas(interpret=True) +
  pack_level2 per restart segment -> finalize_stream -> write_jpeg, and to
  the port's own host pack (device_pack=False); unaligned restart intervals
  and optimize_tables against the matching host chains.
- decode(gray): within 1 level of jpeg_tpu.decode(use_pallas=True,
  entropy="native") in at most 0.5% of samples (the IDCTs sum in other f32
  orders), on the port's streams and on PIL "L" streams; the count is
  printed. Every stream must open in PIL."""

import functools
import io

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

import jpeg_tpu
from jpeg_tpu.config import EncodeConfig as JEC
from jpeg_tpu.entropy import huffman as JH, native as JN
from jpeg_tpu.io import jfif as JF
from jpeg_tpu.models import encoder as JE
from jpeg_tpu.ops import bitpack as JB, dpcm as JD, mcu_conv as JM
from jpeg_tpu.ops import pack_pallas as JP, quant as JQ, symbols as JSym

import jpeg_tpu_torch
from jpeg_tpu_torch.models import encoder as PE
from jpeg_tpu_torch.ops import mcu_conv as PM

from torch_port_util import make_image


def _gray(h, w, seed):
    return make_image(h, w, seed=seed)[..., 1]


def _padded(plane):
    return np.pad(plane, ((0, -plane.shape[0] % 8), (0, -plane.shape[1] % 8)),
                  mode="edge")


@functools.partial(jax.jit, static_argnames=("r",))
def _jax_gray_dpcm(padded, qy, r):
    zz = JM.gray_transform_int(padded, qy)
    return zz.at[:, 0].set(JD.dpcm(zz[:, 0], r))


@functools.partial(jax.jit, static_argnames=("nseg", "nwords"))
def _jax_level2(buf, t_b, nseg, nwords):
    seg = buf.shape[0] // nseg
    return jax.vmap(lambda b2, t2: JP.pack_level2(b2, t2, nwords))(
        buf.reshape(nseg, seg, -1), t_b.reshape(nseg, seg))


def _write(img, qy, htables, scan, r):
    return JF.write_jpeg(img.shape[1], img.shape[0],
                         [JF.ComponentSpec(1, 1, 1, 0, 0, 0)], {0: qy},
                         {k: htables[k] for k in ((0, 0), (1, 0))}, scan,
                         restart_interval=r)


def _jax_device_chain(img, quality, r):
    """jpeg_tpu's exact gray transform + Pallas level 1 + level 2 chain."""
    qy = JQ.luma_table(quality)
    zz = np.asarray(_jax_gray_dpcm(jnp.asarray(_padded(img)), jnp.asarray(qy),
                                   r))
    b = zz.shape[0]
    htables = JH.standard_tables()
    luts = tuple(jnp.asarray(a) for a in JB.luts_from_tables(htables))
    # Zero blocks pad the batch to a multiple of 256 so that one compiled
    # Pallas program serves every case; the padding is sliced off.
    pad = -b % 256
    buf, t_b = JP.pack_level1_pallas(
        jnp.asarray(np.pad(zz, ((0, pad), (0, 0)))),
        jnp.zeros(b + pad, jnp.int32), *luts, interpret=True)
    nseg = 1 if r == 0 or r >= b else b // r
    words, totals, ok = _jax_level2(buf[:b], t_b[:b], nseg, b // nseg * 8 + 2)
    assert bool(np.asarray(ok).all())
    totals = np.asarray(totals)
    maxw = (int(totals.max()) + 31) // 32
    scan = JB.finalize_stream(np.asarray(words)[:, :maxw], totals)
    return _write(img, qy, htables, scan, r)


def _jax_host_chain(img, quality, r, optimize):
    """gray_transform_int -> host DPCM -> jpeg_tpu's _pack_scan (native
    symbol counts -> optimal tables when optimize)."""
    qy = JQ.luma_table(quality)
    zz = np.asarray(JM.gray_transform_int(jnp.asarray(_padded(img)),
                                          jnp.asarray(qy))).copy()
    zz[:, 0] = JE._dpcm_host(zz[:, 0], r)
    cfg = JEC(quality=quality, restart_interval=r, optimize_tables=optimize)
    scan, htables = JE._pack_scan(zz, np.zeros(zz.shape[0], np.uint8), cfg, 1)
    return _write(img, qy, htables, scan, r)


def _open_in_pil(data, shape):
    pil = Image.open(io.BytesIO(data))
    pil.load()
    assert pil.mode == "L" and pil.size == (shape[1], shape[0])


@pytest.mark.parametrize("quality", [1, 50, 95, 100])
def test_gray_transform_int_bit_identical(quality):
    rng = np.random.default_rng(quality)
    qy = JQ.luma_table(quality)
    for plane in (rng.integers(0, 256, size=(32, 48)).astype(np.uint8),
                  _gray(40, 24, quality)):
        ref = np.asarray(JM.gray_transform_int(jnp.asarray(plane),
                                               jnp.asarray(qy)))
        got = PM.gray_transform_int(torch.as_tensor(plane), qy)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("shape,quality", [((48, 64), 75), ((37, 53), 90),
                                           ((1, 1), 50)])
@pytest.mark.parametrize("restart", ["none", "aligned", "beyond"])
def test_gray_encode_bytes_match_jax_chain(shape, quality, restart):
    img = _gray(*shape, seed=quality)
    nblocks = (-(-shape[0] // 8)) * (-(-shape[1] // 8))
    r = {"none": 0, "beyond": nblocks + 3,
         "aligned": next((d for d in range(2, nblocks) if nblocks % d == 0),
                         0)}[restart]
    spills = PE.HOST_PACK_SPILLS
    got = jpeg_tpu_torch.encode(img, quality=quality, restart_interval=r,
                                device="cpu")
    assert PE.HOST_PACK_SPILLS == spills
    assert got == _jax_device_chain(img, quality, r)
    assert got == jpeg_tpu_torch.encode(img, quality=quality,
                                        restart_interval=r, device_pack=False,
                                        device="cpu")
    _open_in_pil(got, shape)


@pytest.mark.parametrize("restart", [3, 5, 7])
def test_gray_unaligned_restart_bytes_match_jax_chain(restart):
    img = _gray(37, 53, seed=restart)  # 5 x 7 = 35 blocks
    r = restart if 35 % restart else restart + 1
    got = jpeg_tpu_torch.encode(img, quality=80, restart_interval=r,
                                device="cpu")
    assert got == _jax_host_chain(img, 80, r, False)
    _open_in_pil(got, img.shape)


@pytest.mark.parametrize("restart", [0, 4])
def test_gray_optimize_tables_bytes_match_jax_chain(restart):
    img = _gray(48, 64, seed=restart + 20)
    kw = dict(quality=85, restart_interval=restart, optimize_tables=True,
              device="cpu")
    on_device = jpeg_tpu_torch.encode(img, **kw)
    assert on_device == jpeg_tpu_torch.encode(img, device_pack=False, **kw)
    assert on_device == _jax_host_chain(img, 85, restart, True)
    # The device histogram gives the same tables as the native counts.
    zz = np.asarray(_jax_gray_dpcm(jnp.asarray(_padded(img)),
                                   jnp.asarray(JQ.luma_table(85)), restart))
    dc, ac = (np.asarray(h) for h in JSym.symbol_histogram(jnp.asarray(zz)))
    info = JF.parse_jpeg(on_device)
    for key, hist in (((0, 0), dc), ((1, 0), ac)):
        opt = JH.optimal_table(hist)
        np.testing.assert_array_equal(info.htables[key].bits, opt.bits)
        np.testing.assert_array_equal(info.htables[key].vals, opt.vals)
    _open_in_pil(on_device, img.shape)


def _assert_close_to_reference(jpg):
    ref = jpeg_tpu.decode(jpg, use_pallas=True, entropy="native")
    got = jpeg_tpu_torch.decode(jpg, device="cpu")
    assert got.shape == ref.shape and got.ndim == 2 and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    ndiff = int((diff != 0).sum())
    print(f"samples differing: {ndiff} of {diff.size}, max {diff.max()}")
    assert diff.max() <= 1
    assert ndiff <= 0.005 * diff.size


@pytest.mark.parametrize("shape,quality,restart", [
    ((48, 64), 75, 0), ((37, 53), 95, 5), ((9, 17), 30, 1),
])
def test_gray_decode_port_streams(shape, quality, restart):
    img = _gray(*shape, seed=shape[0])
    _assert_close_to_reference(jpeg_tpu_torch.encode(
        img, quality=quality, restart_interval=restart, device="cpu"))


@pytest.mark.parametrize("shape,quality,optimize", [
    ((48, 64), 75, False), ((37, 53), 90, True), ((31, 45), 100, False),
])
def test_gray_decode_pil_streams(shape, quality, optimize):
    img = _gray(*shape, seed=quality)
    buf = io.BytesIO()
    Image.fromarray(img, "L").save(buf, "JPEG", quality=quality,
                                   optimize=optimize)
    _assert_close_to_reference(buf.getvalue())
