"""The port's sparse coefficient upload (entropy/decode_device.py) against
the JAX package's.

Everything here is exact, tolerance 0: the payload is a byte format (the
port's packers must write the reference's bytes for the same sparse_scan
outputs), densify_body must rebuild the reference's (B, 64) rows, which are
also the native dense walker's, and decode(entropy="sparse") must give the
pixels of decode(entropy="native") in the port. The device side runs on the
CPU here; the card against the CPU is in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jpeg_tpu.entropy import decode_device as JD, native as JN
from jpeg_tpu.models import layout as JL

import jpeg_tpu_torch
from jpeg_tpu_torch.entropy import (
    decode_device as PD, native as PN, progressive_np as PP)
from jpeg_tpu_torch.io import jfif
from jpeg_tpu_torch.models import decoder as PDec, layout as PL

import torch_port_fixtures as fixtures
from torch_port_util import scan_args


def blocky_image(h, w, seed):
    """Random 8x8 block levels plus noise: DC jumps past 127 between
    neighbours and large ACs, so both exception streams fill at high
    quality."""
    rng = np.random.default_rng(seed)
    levels = rng.integers(0, 256, size=(-(-h // 8), -(-w // 8), 3))
    img = np.kron(levels, np.ones((8, 8, 1)))[:h, :w]
    return np.clip(img + rng.integers(-40, 41, size=(h, w, 3)), 0,
                   255).astype(np.uint8)


def encode_case(mode, restart, quality, seed=0, shape=(72, 104)):
    img = blocky_image(*shape, seed=seed)
    if mode == "gray":
        return jpeg_tpu_torch.encode(img[..., 0], quality=quality,
                                     restart_interval=restart, device="cpu")
    return jpeg_tpu_torch.encode(img, quality=quality, subsampling=mode,
                                 restart_interval=restart, device="cpu")


CASES = [
    ("420", 0, 75), ("420", 4, 10), ("444", 0, 100), ("444", 3, 95),
    ("422", 0, 50), ("422", 5, 90), ("gray", 0, 75), ("gray", 6, 100),
]


@pytest.mark.parametrize("mode,restart,quality", CASES)
def test_payload_bytes_equal_reference(mode, restart, quality, monkeypatch):
    args = scan_args(encode_case(mode, restart, quality, seed=quality))
    walk = PN.sparse_scan(*args)
    for a, b in zip(walk, JN.sparse_scan(*args)):
        np.testing.assert_array_equal(a, b)
    vals, ks, counts, dc = walk
    Sp = PD.sparse_bucket(vals.shape[0])
    Ep = PD.exception_bucket(int(np.count_nonzero(np.abs(
        vals.astype(np.int32)) > 7)))
    Edp = PD.exception_bucket(PD.dc_diff_exceptions(dc))
    assert (Sp, Ep, Edp) == (
        JD.sparse_bucket(vals.shape[0]),
        JD.exception_bucket(int(np.count_nonzero(np.abs(
            vals.astype(np.int32)) > 7))),
        JD.exception_bucket(JD.dc_diff_exceptions(dc)))
    ref_native = JD.build_payload(*walk, Sp, Ep, Edp)
    monkeypatch.setattr(JN, "available", lambda: False)
    ref_numpy = JD.build_payload(*walk, Sp, Ep, Edp)
    got_native = PD.build_payload(*walk, Sp, Ep, Edp)
    got_numpy = PD.build_payload_numpy(*walk, Sp, Ep, Edp)
    assert got_native.dtype == np.uint32
    for got in (got_native, got_numpy):
        assert got.tobytes() == ref_native.tobytes() == ref_numpy.tobytes()
    # sparse_payload is the walk and the pack together.
    payload, B, Sp2, Ep2, Edp2 = PD.sparse_payload(*args)
    assert (B, Sp2, Ep2, Edp2) == (counts.shape[0], Sp, Ep, Edp)
    assert payload.tobytes() == ref_native.tobytes()


@pytest.mark.parametrize("mode,restart,quality", CASES)
def test_densify_rows_equal_reference(mode, restart, quality):
    args = scan_args(encode_case(mode, restart, quality, seed=quality + 1))
    payload, B, Sp, Ep, Edp = PD.sparse_payload(*args)
    ref = np.asarray(JD.densify_body(jnp.asarray(payload), B, Sp, Ep, Edp))
    got = PD.densify_body(PD.payload_tensor(payload, "cpu"), B, Sp, Ep, Edp)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, 64)
    np.testing.assert_array_equal(got.numpy(), ref)
    dense = np.concatenate(PN.decode_scan(*args), axis=0)
    np.testing.assert_array_equal(got.numpy(), dense)
    if quality >= 95:  # both exception streams carry entries
        vals, _, _, dc = PN.sparse_scan(*args)
        assert np.count_nonzero(np.abs(vals.astype(np.int32)) > 7) > 0
        assert PD.dc_diff_exceptions(dc) > 0
    parts = PD.decode_scan_sparse(*args, device="cpu")
    for part, want in zip(parts, PN.decode_scan(*args)):
        np.testing.assert_array_equal(part.numpy(), want)


def test_densify_with_empty_blocks_at_the_tail():
    img = blocky_image(64, 96, seed=5)
    img[24:] = 128  # flat: the last rows of blocks have no AC at all
    jpg = jpeg_tpu_torch.encode(img, quality=50, subsampling="444",
                                device="cpu")
    args = scan_args(jpg)
    _, _, counts, _ = PN.sparse_scan(*args)
    assert counts[-1] == 0 and counts[-12:].sum() == 0 and counts.sum() > 0
    payload, B, Sp, Ep, Edp = PD.sparse_payload(*args)
    ref = np.asarray(JD.densify_body(jnp.asarray(payload), B, Sp, Ep, Edp))
    got = PD.densify_body(PD.payload_tensor(payload, "cpu"), B, Sp, Ep, Edp)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_densify_all_blocks_empty():
    jpg = jpeg_tpu_torch.encode(np.full((16, 24, 3), 77, dtype=np.uint8),
                                device="cpu")
    args = scan_args(jpg)
    payload, B, Sp, Ep, Edp = PD.sparse_payload(*args)
    got = PD.densify_body(PD.payload_tensor(payload, "cpu"), B, Sp, Ep, Edp)
    np.testing.assert_array_equal(
        got.numpy(), np.concatenate(PN.decode_scan(*args), axis=0))


@pytest.mark.parametrize("mode,quality", [("420", 30), ("444", 100),
                                          ("gray", 90)])
def test_sparse_payload_from_blocks(mode, quality):
    args = scan_args(encode_case(mode, 0, quality, seed=3))
    blocks = PN.decode_scan(*args)
    payload, B, Sp, Ep, Edp = PD.sparse_payload_from_blocks(blocks)
    ref = JD.sparse_payload_from_blocks(blocks)
    assert (B, Sp, Ep, Edp) == tuple(ref[1:])
    assert payload.tobytes() == ref[0].tobytes()
    got = PD.densify_body(PD.payload_tensor(payload, "cpu"), B, Sp, Ep, Edp)
    np.testing.assert_array_equal(got.numpy(), np.concatenate(blocks, axis=0))


@pytest.mark.parametrize("mode,restart,quality", CASES)
@pytest.mark.parametrize("scale_denom", [1, 4])
def test_decode_sparse_equals_native(mode, restart, quality, scale_denom):
    jpg = encode_case(mode, restart, quality, seed=7, shape=(45, 83))
    kw = dict(device="cpu", scale_denom=scale_denom)
    a = jpeg_tpu_torch.decode(jpg, entropy="sparse", **kw)
    b = jpeg_tpu_torch.decode(jpg, entropy="native", **kw)
    assert a.dtype == np.uint8
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["progressive_420.jpg",
                                  "noninterleaved_444.jpg",
                                  "progressive_gray.jpg", "cmyk.jpg"])
def test_dense_grids_through_the_sparse_upload(name):
    """The reference re-encodes the dense host grids of progressive and
    multi-scan streams as the sparse payload; the port uploads them dense
    (the re-encode measured slower on the card) but keeps the packer: the
    payload built from such grids is the reference's, byte for byte, and
    densifies back to the grids."""
    info = jfif.parse_jpeg(fixtures.read(name))
    comps = info.components
    mcu_rows = PL.ceil_div(info.height, 8 * max(c.v for c in comps))
    mcu_cols = PL.ceil_div(info.width, 8 * max(c.h for c in comps))
    if info.progressive:
        host = PP.decode_progressive(info, backend="native")
    elif len(info.scans) > 1:
        host = PDec._decode_noninterleaved(info, mcu_rows, mcu_cols)
    else:
        host = PDec._decode_scan_host(
            info, mcu_rows * mcu_cols,
            [(i, c.h * c.v, c.dc_id, c.ac_id) for i, c in enumerate(comps)],
            "native")
    host = [np.asarray(z, dtype=np.int32).reshape(-1, 64) for z in host]
    payload, B, Sp, Ep, Edp = PD.sparse_payload_from_blocks(host)
    ref = JD.sparse_payload_from_blocks(host)
    assert (B, Sp, Ep, Edp) == tuple(ref[1:])
    assert payload.tobytes() == ref[0].tobytes()
    got = PD.densify_body(PD.payload_tensor(payload, "cpu"), B, Sp, Ep, Edp)
    np.testing.assert_array_equal(got.numpy(), np.concatenate(host, axis=0))


def test_pack6_unpack6_roundtrip_and_sign_folds():
    rng = np.random.default_rng(6)
    a = rng.integers(0, 64, size=16 * 37).astype(np.uint8)
    a[:32] = 63  # all-ones groups: bit 31 and bit 63 of the words are set
    packed = PD._pack6(a)
    np.testing.assert_array_equal(packed, JD._pack6(a))
    words = torch.from_numpy(packed.view(np.int32)).to(torch.int64) & 0xFFFFFFFF
    np.testing.assert_array_equal(PD._unpack6(words, a.size - 5).numpy(),
                                  a[:-5])
    nib = rng.integers(-8, 8, size=64)
    nib[:8] = -8  # a word of 0x88888888
    w = ((nib & 15).reshape(-1, 8) << (4 * np.arange(8))).sum(1).astype(np.uint32)
    words = torch.from_numpy(w.view(np.int32)).to(torch.int64) & 0xFFFFFFFF
    np.testing.assert_array_equal(PD._unpack_bytes(words, 4, 61).numpy(),
                                  nib[:61])
    i8 = rng.integers(-128, 128, size=40)
    i8[:4] = -128
    w = i8.astype(np.int8).view(np.uint32)
    words = torch.from_numpy(w.view(np.int32)).to(torch.int64) & 0xFFFFFFFF
    np.testing.assert_array_equal(PD._unpack_bytes(words, 8, 39).numpy(),
                                  i8[:39])


def test_payload_checks_raise():
    vals = np.array([3, -9, 1], dtype=np.int16)
    ks = np.array([1, 5, 63], dtype=np.uint8)
    dc = np.array([10, -300], dtype=np.int32)
    good = np.array([2, 1], dtype=np.uint8)
    payload = PD.build_payload(vals, ks, good, dc, 1024, 256, 256)
    rows = PD.densify_body(PD.payload_tensor(payload, "cpu"), 2, 1024, 256,
                           256).numpy()
    assert rows[0, [0, 1, 5]].tolist() == [10, 3, -9]
    assert rows[1, [0, 63]].tolist() == [-300, 1]
    assert np.count_nonzero(rows) == 5
    with pytest.raises(ValueError, match="counts sum"):
        PD.build_payload(vals, ks, np.array([2, 2], dtype=np.uint8), dc,
                         1024, 256, 256)
    with pytest.raises(ValueError, match="geometry"):
        PD.densify_body(PD.payload_tensor(payload[:-1], "cpu"), 2, 1024, 256,
                        256)


@pytest.mark.parametrize("geo", [(3, 5, 2, 2), (4, 3, 1, 2), (2, 7, 2, 1),
                                 (1, 1, 4, 4)])
def test_scan_to_raster_tensor_equals_reference(geo):
    rows, cols, v, h = geo
    n = rows * cols * v * h
    blocks = np.arange(n * 64, dtype=np.int32).reshape(n, 64)
    want = JL.scan_to_raster(blocks, *geo)
    np.testing.assert_array_equal(PL.scan_to_raster(blocks, *geo), want)
    got = PL.scan_to_raster(torch.as_tensor(blocks), *geo)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        want, blocks[JL.inverse_permutation(*geo)])
