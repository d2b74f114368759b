"""The port's host-pack encode paths, optimize_tables and symbol statistics
against the JAX package, on the CPU.

- use_pallas: the port's _transform_color(use_pallas=True) coefficients are
  held to jpeg_tpu's _jit_color(mode, True) (Pallas kernel in interpret
  mode) with the bound of tests/test_fused.py (|diff| <= 1, nonzero in at
  most max(8, 5e-4 n) places; the count is printed), and the encode bytes
  to jpeg_tpu.encode(use_pallas=True), which is jpeg_tpu's whole host-pack
  path: tolerance 0.
- Unaligned restart intervals and optimize_tables: bytes identical to
  explicit jpeg_tpu chains built on the exact transform (not
  jpeg_tpu.encode(), which takes the staged float transform on the CPU).
- symbol_histogram and bits_per_block: exactly jpeg_tpu's.
Every stream must open in PIL."""

import functools
import io

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

import jpeg_tpu
from jpeg_tpu.config import EncodeConfig as JEC, Subsampling as JS
from jpeg_tpu.entropy import huffman as JH, native as JN
from jpeg_tpu.io import jfif as JF
from jpeg_tpu.models import encoder as JE, layout as JL
from jpeg_tpu.ops import mcu_conv as JM, quant as JQ, symbols as JSym

import jpeg_tpu_torch
from jpeg_tpu_torch.config import Subsampling as PS
from jpeg_tpu_torch.models import encoder as PE
from jpeg_tpu_torch.ops import symbols as PSym

from test_torch_fused_dct import assert_coef_close
from torch_port_util import make_image, random_blocks

MODES = ("444", "422", "420")


def _open_in_pil(data, shape):
    pil = Image.open(io.BytesIO(data))
    pil.load()
    assert pil.size == (shape[1], shape[0])


def _padded(img, mode):
    m = JS(mode)
    ph, pw = -img.shape[0] % m.mcu_height, -img.shape[1] % m.mcu_width
    return np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="edge")


def _n_mcu(shape, mode):
    m = JS(mode)
    return (-(-shape[0] // m.mcu_height)) * (-(-shape[1] // m.mcu_width))


@functools.partial(jax.jit, static_argnames=("mode",))
def _jax_exact(padded, qy, qc, mode):
    return JM._mcu_transform_int(padded, qy, qc, mode)


def _jax_scan_components(img, quality, mode, r):
    """jpeg_tpu's exact transform, the luma reordered to raster and back to
    scan order by the host-pack permutation, DC DPCM'd on the host:
    (y_scan, cb, cr, hv, (qy, qc))."""
    m = JS(mode)
    padded = _padded(img, mode)
    qy, qc = JQ.luma_table(quality), JQ.chroma_table(quality)
    coef = np.asarray(_jax_exact(jnp.asarray(padded), jnp.asarray(qy),
                                 jnp.asarray(qc), m))
    hf, vf = m.h_factor, m.v_factor
    hv = hf * vf
    rows, cols = padded.shape[0] // m.mcu_height, padded.shape[1] // m.mcu_width
    y_raster = coef[:, :hv].reshape(rows, cols, vf, hf, 64).transpose(
        0, 2, 1, 3, 4).reshape(-1, 64)
    y_scan = y_raster[JL.mcu_scan_permutation(rows, cols, vf, hf)]
    cb, cr = coef[:, hv].copy(), coef[:, hv + 1].copy()
    y_scan[:, 0] = JE._dpcm_host(y_scan[:, 0], r * hv)
    cb[:, 0] = JE._dpcm_host(cb[:, 0], r)
    cr[:, 0] = JE._dpcm_host(cr[:, 0], r)
    return y_scan, cb, cr, hv, (qy, qc)


# -- use_pallas ---------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape,quality", [((64, 96), 75), ((37, 53), 95)])
def test_pallas_transform_matches_jax(mode, shape, quality):
    padded = _padded(make_image(*shape, seed=quality), mode)
    qy, qc = JQ.luma_table(quality), JQ.chroma_table(quality)
    ref = JE._jit_color(JS(mode), True)(jnp.asarray(padded), jnp.asarray(qy),
                                        jnp.asarray(qc))
    got = PE._transform_color(torch.as_tensor(padded), torch.as_tensor(qy),
                              torch.as_tensor(qc), PS(mode), use_pallas=True)
    for g, r in zip(got, ref):
        assert g.dtype == torch.int32 and tuple(g.shape) == r.shape
        assert_coef_close(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape,quality,restart,optimize", [
    ((64, 96), 75, 0, False), ((37, 53), 50, 5, False),
    ((40, 56), 85, 0, True),
])
def test_pallas_encode_bytes_match_jax(mode, shape, quality, restart, optimize):
    img = make_image(*shape, seed=shape[1])
    kw = dict(quality=quality, subsampling=mode, restart_interval=restart,
              optimize_tables=optimize, use_pallas=True)
    got = jpeg_tpu_torch.encode(img, device="cpu", **kw)
    assert got == jpeg_tpu.encode(img, **kw)
    _open_in_pil(got, shape)


# -- unaligned restart intervals ------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("restart", [3, 5, 7])
def test_unaligned_restart_bytes_match_jax_chain(mode, restart):
    shape = next(s for s in ((37, 53), (45, 61), (80, 24))
                 if _n_mcu(s, mode) % restart and _n_mcu(s, mode) > restart)
    img = make_image(*shape, seed=restart)
    spills = PE.HOST_PACK_SPILLS
    got = jpeg_tpu_torch.encode(img, quality=80, subsampling=mode,
                                restart_interval=restart, device="cpu")
    assert PE.HOST_PACK_SPILLS == spills
    y_scan, cb, cr, hv, (qy, qc) = _jax_scan_components(img, 80, mode, restart)
    blocks, tbl = JE.interleave_mcus(y_scan, cb, cr, hv)
    cfg = JEC(quality=80, subsampling=mode, restart_interval=restart)
    scan, htables = JE._pack_scan(blocks, tbl, cfg, hv + 2)
    expect = JF.write_jpeg(shape[1], shape[0], JE._color_components(JS(mode)),
                           {0: qy, 1: qc}, htables, scan,
                           restart_interval=restart)
    assert got == expect
    _open_in_pil(got, shape)
    # The port's own host pack of the default transform gives the same bytes.
    assert got == jpeg_tpu_torch.encode(img, quality=80, subsampling=mode,
                                        restart_interval=restart,
                                        device_pack=False, device="cpu")


# -- optimize_tables ----------------------------------------------------------


def _jax_optimized_stream(img, quality, mode, r):
    """_mcu_transform_int -> dpcm -> symbols.symbol_histogram ->
    huffman.optimal_table -> native.encode_scan -> jfif.write_jpeg."""
    y_scan, cb, cr, hv, (qy, qc) = _jax_scan_components(img, quality, mode, r)
    dc_l, ac_l = JSym.symbol_histogram(jnp.asarray(y_scan))
    dc_1, ac_1 = JSym.symbol_histogram(jnp.asarray(cb))
    dc_2, ac_2 = JSym.symbol_histogram(jnp.asarray(cr))
    hists = [np.asarray(h) for h in (dc_l, ac_l, dc_1 + dc_2, ac_1 + ac_2)]
    htables = {k: JH.optimal_table(h) for k, h in
               zip(((0, 0), (1, 0), (0, 1), (1, 1)), hists)}
    blocks, tbl = JE.interleave_mcus(y_scan, cb, cr, hv)
    scan = JN.encode_scan(blocks, tbl, htables, restart_interval=r,
                          blocks_per_mcu=hv + 2)
    return JF.write_jpeg(img.shape[1], img.shape[0],
                         JE._color_components(JS(mode)), {0: qy, 1: qc},
                         htables, scan, restart_interval=r)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape,quality,restart", [
    ((48, 64), 75, 0), ((37, 53), 90, 2),
])
def test_optimize_tables_bytes_match_jax_chain(mode, shape, quality, restart):
    img = make_image(*shape, seed=quality + 1)
    kw = dict(quality=quality, subsampling=mode, restart_interval=restart,
              optimize_tables=True, device="cpu")
    spills = PE.HOST_PACK_SPILLS
    on_device = jpeg_tpu_torch.encode(img, **kw)
    assert PE.HOST_PACK_SPILLS == spills
    on_host = jpeg_tpu_torch.encode(img, device_pack=False, **kw)
    assert on_device == on_host == _jax_optimized_stream(img, quality, mode,
                                                         restart)
    assert len(on_device) < len(jpeg_tpu_torch.encode(
        img, quality=quality, subsampling=mode, restart_interval=restart,
        device="cpu"))
    _open_in_pil(on_device, shape)


def test_optimize_tables_spill_matches_host_pack():
    """Dense q100 noise overflows the 288-bit budget with the optimal tables
    too: the device path spills to the host packer, same bytes."""
    rng = np.random.default_rng(8)
    img = rng.integers(0, 256, size=(24, 32, 3)).astype(np.uint8)
    kw = dict(quality=100, subsampling="444", optimize_tables=True,
              device="cpu")
    spills = PE.HOST_PACK_SPILLS
    got = jpeg_tpu_torch.encode(img, **kw)
    assert PE.HOST_PACK_SPILLS == spills + 1
    assert got == jpeg_tpu_torch.encode(img, device_pack=False, **kw)
    assert got == _jax_optimized_stream(img, 100, "444", 0)


# -- symbol statistics ----------------------------------------------------------


@pytest.mark.parametrize("density", [0.0, 0.15, 0.3])
def test_symbol_histogram_and_bits_per_block_equal(density):
    rng = np.random.default_rng(int(density * 100) + 2)
    blocks = random_blocks(rng, 3000, density)
    # Long zero runs (ZRL) and blocks that end on position 63 (no EOB).
    blocks[::7, 1:40] = 0
    blocks[::11, 63] = 5
    got_dc, got_ac = PSym.symbol_histogram(torch.as_tensor(blocks))
    ref_dc, ref_ac = JSym.symbol_histogram(jnp.asarray(blocks))
    assert got_dc.dtype == torch.int32 and got_ac.dtype == torch.int32
    np.testing.assert_array_equal(got_dc.numpy(), np.asarray(ref_dc))
    np.testing.assert_array_equal(got_ac.numpy(), np.asarray(ref_ac))
    tables = [JH.standard_tables(), {
        k: JH.optimal_table(np.asarray(h)) for k, h in
        (((0, 0), ref_dc), ((1, 0), ref_ac))}]
    for t in tables:
        dc_len = t[(0, 0)].size.astype(np.int32)
        ac_len = t[(1, 0)].size.astype(np.int32)
        got = PSym.bits_per_block(torch.as_tensor(blocks),
                                  torch.as_tensor(dc_len),
                                  torch.as_tensor(ac_len))
        ref = JSym.bits_per_block(jnp.asarray(blocks), jnp.asarray(dc_len),
                                  jnp.asarray(ac_len))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_bit_size_equal():
    v = np.concatenate([np.arange(-2100, 2100), [-32767, 32767]]).astype(np.int32)
    np.testing.assert_array_equal(PSym.bit_size(torch.as_tensor(v)).numpy(),
                                  np.asarray(JSym.bit_size(jnp.asarray(v))))
