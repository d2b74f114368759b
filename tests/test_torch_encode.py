"""jpeg_tpu_torch.encode(device="cpu") against the JAX package's
accelerator chain, built explicitly:

  _mcu_transform_int -> dpcm -> MCU interleave ->
  pack_level1_pallas(interpret=True) -> pack_level2 per restart segment ->
  finalize_stream -> write_jpeg

(not jpeg_tpu.encode(), which takes the staged float transform on the CPU).
The JFIF bytes must be identical: tolerance 0. Every stream must open in
PIL. Gradient + noise images at q <= 90 keep every block inside the packer's
288-bit budget, so nothing spills; dense q100 noise must spill to the host
packer and still give the native packer's bytes."""

import functools
import io

import numpy as np
import pytest
from PIL import Image

import jax
import jax.numpy as jnp

from jpeg_tpu.config import Subsampling as JS
from jpeg_tpu.entropy import huffman as JH, native as JN
from jpeg_tpu.io import jfif as JF
from jpeg_tpu.models import encoder as JE
from jpeg_tpu.ops import bitpack as JB, dpcm as JD, mcu_conv as JM
from jpeg_tpu.ops import pack_pallas as JP, quant as JQ

import jpeg_tpu_torch
from jpeg_tpu_torch.models import encoder as PE

from torch_port_util import make_image


@functools.partial(jax.jit, static_argnames=("mode", "r"))
def _jax_interleaved(padded, qy, qc, mode, r):
    """Exact transform + DC DPCM + MCU interleave, as one JAX program."""
    coef = JM._mcu_transform_int(padded, qy, qc, mode)
    hv = mode.h_factor * mode.v_factor
    n_mcu = coef.shape[0]
    y = coef[:, :hv].reshape(-1, 64)
    y = y.at[:, 0].set(JD.dpcm(y[:, 0], r * hv))
    cb = coef[:, hv].at[:, 0].set(JD.dpcm(coef[:, hv, 0], r))
    cr = coef[:, hv + 1].at[:, 0].set(JD.dpcm(coef[:, hv + 1, 0], r))
    return jnp.concatenate(
        [y.reshape(n_mcu, hv, 64), cb[:, None], cr[:, None]], axis=1
    ).reshape(-1, 64)


@functools.partial(jax.jit, static_argnames=("nseg", "nwords"))
def _jax_level2(buf, t_b, nseg, nwords):
    """pack_pallas.pack_level2 on each restart segment (vmapped, as the JAX
    encoder runs it)."""
    seg = buf.shape[0] // nseg
    return jax.vmap(lambda b2, t2: JP.pack_level2(b2, t2, nwords))(
        buf.reshape(nseg, seg, -1), t_b.reshape(nseg, seg))


def _jax_blocks(img, quality, mode, r):
    """((B, 64) int32 DPCM'd interleaved blocks, (B,) table ids, n_mcu, bpm,
    (qy, qc)) from the JAX package."""
    m = JS(mode)
    ph, pw = -img.shape[0] % m.mcu_height, -img.shape[1] % m.mcu_width
    padded = np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="edge")
    qy, qc = JQ.luma_table(quality), JQ.chroma_table(quality)
    blocks = np.asarray(_jax_interleaved(jnp.asarray(padded), jnp.asarray(qy),
                                         jnp.asarray(qc), m, r))
    bpm = m.blocks_per_mcu
    n_mcu = blocks.shape[0] // bpm
    tbl = np.tile(np.array([0] * (bpm - 2) + [1, 1], np.int32), n_mcu)
    return blocks, tbl, n_mcu, bpm, (qy, qc)


def _jax_reference(img, quality, mode, r):
    blocks, tbl, n_mcu, bpm, (qy, qc) = _jax_blocks(img, quality, mode, r)
    htables = JH.standard_tables()
    luts = tuple(jnp.asarray(a) for a in JB.luts_from_tables(htables))
    # Zero blocks pad the batch to a multiple of 256 so that one compiled
    # Pallas program serves every case; the padding is sliced off.
    b = blocks.shape[0]
    pad = -b % 256
    buf, t_b = JP.pack_level1_pallas(
        jnp.asarray(np.pad(blocks, ((0, pad), (0, 0)))),
        jnp.asarray(np.pad(tbl, (0, pad))), *luts, interpret=True)
    nseg = 1 if r == 0 or r >= n_mcu else n_mcu // r
    nwords = b // nseg * 8 + 2
    words, totals, ok = _jax_level2(buf[:b], t_b[:b], nseg, nwords)
    assert bool(np.asarray(ok).all())
    totals = np.asarray(totals)
    maxw = (int(totals.max()) + 31) // 32
    scan = JB.finalize_stream(np.asarray(words)[:, :maxw], totals)
    return JF.write_jpeg(img.shape[1], img.shape[0], JE._color_components(JS(mode)),
                         {0: qy, 1: qc}, htables, scan, restart_interval=r)


def _restart_interval(img, mode, kind):
    """0; an interval that divides the MCU count without being it; or one
    past the MCU count (a single segment)."""
    m = JS(mode)
    n_mcu = (-(-img.shape[0] // m.mcu_height)) * (-(-img.shape[1] // m.mcu_width))
    if kind == "none":
        return 0
    if kind == "beyond":
        return n_mcu + 3
    return next(d for d in range(2, n_mcu) if n_mcu % d == 0)


@pytest.mark.parametrize("mode", ["444", "422", "420"])
@pytest.mark.parametrize("shape,quality", [((48, 64), 75), ((37, 53), 90)])
@pytest.mark.parametrize("restart", ["none", "aligned", "beyond"])
def test_encode_bytes_match_jax_chain(mode, shape, quality, restart):
    img = make_image(*shape, seed=quality)
    r = _restart_interval(img, mode, restart)
    spills = PE.HOST_PACK_SPILLS
    got = jpeg_tpu_torch.encode(img, quality=quality, subsampling=mode,
                                restart_interval=r, device="cpu")
    assert PE.HOST_PACK_SPILLS == spills
    assert got == _jax_reference(img, quality, mode, r)
    pil = Image.open(io.BytesIO(got))
    pil.load()
    assert pil.size == (shape[1], shape[0])


@pytest.mark.parametrize("mode,shape", [("444", (1, 1)), ("411", (16, 17)),
                                        ("440", (3, 100))])
def test_encode_small_frames_and_other_samplings(mode, shape):
    """Frames smaller than one MCU, and the 4:1:1 / 4:4:0 layouts the
    composed transform also covers."""
    img = make_image(*shape, seed=1)
    got = jpeg_tpu_torch.encode(img, quality=80, subsampling=mode, device="cpu")
    assert got == _jax_reference(img, 80, mode, 0)


def test_dense_q100_spills_to_native_host_pack():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, size=(24, 32, 3)).astype(np.uint8)
    spills = PE.HOST_PACK_SPILLS
    got = jpeg_tpu_torch.encode(img, quality=100, subsampling="444",
                                device="cpu")
    assert PE.HOST_PACK_SPILLS == spills + 1
    blocks, tbl, _, bpm, (qy, qc) = _jax_blocks(img, 100, "444", 0)
    htables = JH.standard_tables()
    scan = JN.encode_scan(blocks, tbl, htables, restart_interval=0,
                          blocks_per_mcu=bpm)
    expect = JF.write_jpeg(32, 24, JE._color_components(JS("444")),
                           {0: qy, 1: qc}, htables, scan)
    assert got == expect


def test_file_entry_points_match_encode(tmp_path):
    from jpeg_tpu_torch.io import bmp

    img = make_image(20, 36, seed=3)
    src = tmp_path / "in.bmp"
    bmp.write_bmp(str(src), img)
    a, b = tmp_path / "a.jpg", tmp_path / "b.jpg"
    jpeg_tpu_torch.encode_bmp_to_jpeg(str(src), str(a), quality=80,
                                      device="cpu")
    jpeg_tpu_torch.encode_rgb_to_jpeg(img, str(b), quality=80, device="cpu")
    expect = jpeg_tpu_torch.encode(img, quality=80, subsampling="444",
                                   device="cpu")
    assert a.read_bytes() == expect and b.read_bytes() == expect
    assert jpeg_tpu_torch.encode(str(src), quality=80, subsampling="444",
                                 device="cpu") == expect
