"""The port's CUDA kernels against their plain PyTorch twins, on the card.

This file imports no jax, so it also runs where only torch is installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(--noconftest skips tests/conftest.py, which imports jax). The tests marked
`cuda` skip without a CUDA device.

Tolerances: kernel A (packer level 1) is exact under its contract: totals
equal for every block, words equal for every block of at most 288 bits.
Kernel B (dequant + IDCT) sums in another f32 order than its twin:
|diff| <= 1e-2. Kernel C (level shift + DCT + quantize) likewise, so a .5
boundary may flip: quantized coefficients within 1, and differing in at
most max(8, 5e-4 n) places (the bound of tests/test_fused.py). Encodes on
the card must equal CPU encodes byte for byte (optimize_tables, unaligned
restarts, the host pack and gray included); decodes may differ from CPU
decodes by 1 level in <= 0.5% of samples (scaled decodes too: cuBLAS and
the CPU sum the reduced bases in different orders). decode(use_pallas=False)
on the card sums each sample in a (64, 64) matmul, in another order than
kernel B and the CPU's separable form: its samples after the IDCT hold that
contract, and its pixels after a colour map differ by up to 3 (a chroma
sample 1 apart moves R or B by 1.402 or 1.772) in <= 0.5%. Exact on the card:
densify_body against the CPU's rows, entropy="sparse" against "native",
finish_ycbcr(decode(output="ycbcr")) against decode(), device_output
against the host result; encode_batched and encode_stream against encode()
on the card and on the CPU (bytes), decode_batched and decode_stream against
decode() on the card (pixels), encode_noninterleaved and encode_progressive
against their CPU bytes; kernels A and B past 2^31 bytes of input against
their twins on slices (blocks are independent). Kernels B2 (zig-zag blocks
in, uint8 samples out) and H (upsample, colour map, round, clip, crop) equal
their twins with 0 apart, past 2^31 bytes of input too (on slices: blocks
and images are independent); a colour decode launches B2 once and H
once, kernel B never. The device Huffman
decoders are integers throughout: kernels D and E and program F equal their
twins run on the same tensors, native.decode_scan and native.index_scan, with
0 apart, and entropy="indexed" / "device" give the pixels of "sparse". The
scan pass (csrc/pack_scan.cu) equals its twin, pack_level2 + the native
finalize, byte for byte and status for status."""

import threading

import numpy as np
import pytest
import torch

import jpeg_tpu_torch
from jpeg_tpu_torch.entropy import decode_device, huffman, native
from jpeg_tpu_torch.entropy.decode_np import ScanDecodeError
from jpeg_tpu_torch.models import encoder
from jpeg_tpu_torch.ops import (
    bitpack, dpcm, entropy_decode, finish, fused, mcu_conv, pack, quant, tile,
    zigzag)
from jpeg_tpu_torch.parallel import mosaic

import torch_port_fixtures as fixtures

from torch_port_util import (
    LEVEL1_SIZES, ac_indexed_inputs, adversarial_idct_planes,
    adversarial_level1_case, make_image, outside_bounds, plain_streams,
    prefix_inputs, random_blocks, regroup_prefix, require_cuda, scan_args,
    scan_block_words, segment_inputs)

BUDGET = bitpack.BLOCK_WORDS * 32


def _luts(device):
    return tuple(torch.as_tensor(a.astype(np.int32), device=device)
                 for a in bitpack.luts_from_tables(huffman.standard_tables()))


def test_wrappers_refuse_other_devices():
    blocks = torch.zeros((4, 64), dtype=torch.int32, device="meta")
    tbl = torch.zeros((4,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pack.pack_level1(blocks, tbl, *_luts("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        fused.fused_dequant_idct(torch.zeros((8, 8), dtype=torch.int32,
                                             device="meta"), quant.luma_table(50))
    with pytest.raises(ValueError, match="unsupported device"):
        fused.fused_dct_quantize(torch.zeros((8, 8), device="meta"),
                                 quant.luma_table(50))


@pytest.mark.cuda
def test_kernel_a_matches_plain():
    dev = require_cuda()
    rng = np.random.default_rng(11)
    luts = _luts(dev)
    htables = huffman.standard_tables()
    cases = [(random_blocks(rng, n, density),
              (rng.random(n) < 0.5).astype(np.int32))
             for n, density in ((1000, 0.0), (4099, 0.15), (777, 0.3), (1, 0.5))]
    # The adversarial blocks of the CPU tests, at the same ragged sizes.
    cases += [adversarial_level1_case(n, htables) for n in LEVEL1_SIZES]
    for blocks_np, tbl_np in cases:
        blocks = torch.as_tensor(blocks_np, device=dev)
        tbl = torch.as_tensor(tbl_np, device=dev)
        before = pack.LAUNCHES
        buf, tot = pack.pack_level1(blocks, tbl, *luts)
        torch.cuda.synchronize()
        assert pack.LAUNCHES == before + 1
        ref_buf, ref_tot = pack.pack_level1_reference(blocks, tbl, *luts)
        tot, ref_tot = tot.cpu().numpy(), ref_tot.cpu().numpy()
        np.testing.assert_array_equal(tot, ref_tot)
        fits = ref_tot <= BUDGET
        np.testing.assert_array_equal(buf.cpu().numpy()[fits],
                                      ref_buf.cpu().numpy()[fits])
        # Pre-packed tables give the same launch the same answer.
        buf2, tot2 = pack.pack_level1(blocks, tbl, *luts,
                                      packed=pack.pack_tables(*luts))
        assert torch.equal(buf2, buf) and np.array_equal(tot2.cpu().numpy(), tot)


@pytest.mark.cuda
def test_kernel_b_matches_plain():
    dev = require_cuda()
    rng = np.random.default_rng(3)
    cases = [(rng.integers(-300, 300, size=shape).astype(np.int32),
              quant.luma_table(50))
             for shape in ((64, 128), (8, 64), (48, 40), (1080, 1928))]
    # The adversarial planes of the CPU tests.
    cases += [(coeffs, qt) for _, coeffs, qt in adversarial_idct_planes()]
    for coeffs_np, qt in cases:
        coeffs = torch.as_tensor(coeffs_np, device=dev)
        before = fused.LAUNCHES
        got = fused.fused_dequant_idct(coeffs, qt)
        torch.cuda.synchronize()
        assert fused.LAUNCHES == before + 1
        ref = fused.fused_dequant_idct_reference(coeffs, qt)
        torch.testing.assert_close(got, ref, atol=1e-2, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (17, 126), (135, 240),
                                   (270, 480)])
def test_kernel_b2_matches_plain(shape):
    """Kernel B2 against its twin and against kernel B rounded and clamped,
    0 apart; also written into a slice of a larger buffer (out=)."""
    dev = require_cuda()
    rng = np.random.default_rng(shape[0] + shape[1])
    hb, wb = shape
    zz = torch.as_tensor(random_blocks(rng, hb * wb, 0.2), device=dev)
    qt = quant.luma_table(60)
    before = fused.ZZ_LAUNCHES
    got = fused.dequant_idct_samples(zz, qt, shape)
    torch.cuda.synchronize()
    assert fused.ZZ_LAUNCHES == before + 1
    assert got.dtype == torch.uint8 and got.shape == (hb * 8, wb * 8)
    assert torch.equal(got, fused.dequant_idct_samples_reference(
        zz, qt, shape))
    plane = fused.fused_dequant_idct(tile.unblockify(zigzag.from_zigzag(
        zz.reshape(hb, wb, 64))).contiguous(), qt)
    assert torch.equal(got, torch.clamp(torch.round(plane), 0, 255).to(
        torch.uint8))
    buf = torch.zeros(got.numel() + 64, dtype=torch.uint8, device=dev)
    fused.dequant_idct_samples(zz, qt, shape,
                               out=buf[64:].view(hb * 8, wb * 8))
    assert torch.equal(buf[64:].view(hb * 8, wb * 8), got)
    assert int(buf[:64].max()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("comps_hv", [((2, 2), (1, 1), (1, 1)),
                                      ((2, 1), (1, 1), (1, 1)),
                                      ((1, 1), (1, 1), (1, 1)),
                                      ((2, 2), (1, 2), (2, 1))])
def test_kernel_b2_one_launch_over_a_stack(comps_hv):
    """Kernel B2 over every component of n = 3 images at once: the (3, B,
    64) rows a batch densifies, each component a slice read in place at the
    stride B and in its MCU scan order; one launch, 0 apart from the
    twin, also into the slices of one flat buffer."""
    dev = require_cuda()
    rng = np.random.default_rng(sum(h * 3 + v for h, v in comps_hv))
    mcu_rows, mcu_cols = 17, 30
    shapes = [(mcu_rows * v, mcu_cols * h) for h, v in comps_hv]
    per = [hb * wb for hb, wb in shapes]
    rows = torch.as_tensor(random_blocks(rng, 3 * sum(per), 0.2).reshape(
        3, sum(per), 64), device=dev)
    bounds = np.cumsum([0] + per)
    views = [rows[:, lo:hi] for lo, hi in zip(bounds[:-1], bounds[1:])]
    scan = [(mcu_rows, mcu_cols, v, h) if h * v > 1 else None
            for h, v in comps_hv]
    qs = [quant.luma_table(60), quant.chroma_table(60),
          quant.chroma_table(70)]
    before = fused.ZZ_LAUNCHES
    got = fused.dequant_idct_planes(views, qs, shapes, scan, n_img=3)
    torch.cuda.synchronize()
    assert fused.ZZ_LAUNCHES == before + 1
    want = fused.dequant_idct_planes_reference(views, qs, shapes, scan,
                                               n_img=3)
    for g, w, (hb, wb) in zip(got, want, shapes):
        assert g.shape == (3 * hb * 8, wb * 8)
        assert torch.equal(g, w)
    sizes = [3 * n * 64 for n in per]
    buf = torch.zeros(sum(sizes), dtype=torch.uint8, device=dev)
    fused.dequant_idct_planes(views, qs, shapes, scan, n_img=3, outs=[
        piece.view(3 * hb * 8, wb * 8)
        for (hb, wb), piece in zip(shapes, buf.split(sizes))])
    assert torch.equal(buf, torch.cat([w.reshape(-1) for w in want]))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [None, 3])
def test_kernel_h_matches_plain(n):
    """Kernel H against its twin, 0 apart: every ratio pair in
    {1, 2, 3, 4}^2, fancy and not, YCbCr and RGB, crops to a width that is
    a multiple of 8 (8-byte stores), of 4 only (word stores) and of neither
    (byte stores), and the padded grid of a 1001x777 4:2:0 frame (four
    tiles of 256 columns), also cropped to 992 columns."""
    dev = require_cuda()
    rng = np.random.default_rng(7 if n is None else n)
    lead = () if n is None else (n,)
    cases = [(((1, 1), (fh, fv), (fh, fv)), (96, 120), crop)
             for fh in range(1, 5) for fv in range(1, 5)
             for crop in ((91, 113), (91, 116), (96, 120))]
    cases.append((((1, 1), (2, 2), (2, 2)), (784, 1008), (777, 1001)))
    cases.append((((2, 1), (1, 2), (1, 1)), (784, 1008), (777, 1001)))
    cases.append((((1, 1), (2, 2), (2, 2)), (784, 1008), (777, 992)))
    for factors, full, crop in cases:
        planes = [torch.as_tensor(rng.integers(
            0, 256, size=lead + (full[0] // fv, full[1] // fh)).astype(
                np.uint8), device=dev) for fh, fv in factors]
        for fan in (True, False):
            for is_rgb in (False, True):
                before = finish.LAUNCHES
                got = finish.finish_color(planes, factors, (fan,) * 3,
                                          is_rgb, *crop)
                torch.cuda.synchronize()
                assert finish.LAUNCHES == before + 1
                assert got.is_contiguous() and got.shape == lead + (*crop, 3)
                assert torch.equal(got, finish.finish_color_reference(
                    planes, factors, (fan,) * 3, is_rgb, *crop))


@pytest.mark.cuda
def test_wrappers_refuse_unaligned_tensors():
    """Kernels A, B and C move 16 bytes per load and store: a base pointer
    off a 16-byte boundary raises instead of launching."""
    dev = require_cuda()
    flat = torch.zeros(2 * 64 + 1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fused.fused_dequant_idct(flat[1:65].reshape(8, 8), quant.luma_table(50))
    with pytest.raises(ValueError, match="16-byte aligned"):
        fused.fused_dct_quantize(flat.float()[1:65].reshape(8, 8),
                                 quant.luma_table(50))
    with pytest.raises(ValueError, match="16-byte aligned"):
        pack.pack_level1(flat[1:].reshape(2, 64),
                         torch.zeros(2, dtype=torch.int32, device=dev),
                         *_luts(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("mode,shape,restart", [
    ("420", (144, 256), 0), ("422", (37, 53), 0), ("444", (101, 77), 0),
    ("420", (128, 192), 6),
])
def test_encode_decode_on_card_match_cpu(mode, shape, restart):
    require_cuda()
    img = make_image(*shape, seed=shape[0])
    spills, launches_a = encoder.HOST_PACK_SPILLS, pack.LAUNCHES
    a = jpeg_tpu_torch.encode(img, 75, mode, restart, device="cuda")
    b = jpeg_tpu_torch.encode(img, 75, mode, restart, device="cpu")
    assert a == b
    assert encoder.HOST_PACK_SPILLS == spills
    assert pack.LAUNCHES == launches_a + 1
    before = _counts()
    got = jpeg_tpu_torch.decode(a, device="cuda")
    assert _since(before) == (0, 0, 0, 1, 1)
    ref = jpeg_tpu_torch.decode(a, device="cpu")
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1
    assert (diff != 0).sum() <= 0.005 * diff.size


@pytest.mark.cuda
def test_kernel_c_matches_plain():
    dev = require_cuda()
    rng = np.random.default_rng(5)

    def close(got, ref):
        diff = (got.long().cpu() - ref.long().cpu()).abs()
        assert int(diff.max()) <= 1
        assert int((diff != 0).sum()) <= max(8, 5e-4 * diff.numel())

    # The twin on the card is two cuBLAS products, whose summation order
    # changes with the shape; on the CPU it sums as the kernel's chains do.
    # So the small and ragged shapes are held to the twin run on the CPU.
    for shape, card_twin in (((64, 128), True), ((8, 64), True),
                             ((48, 40), True), ((1080, 1928), True),
                             ((8, 8), False), ((16, 1016), False)):
        plane = torch.as_tensor(
            rng.integers(0, 256, size=shape).astype(np.float32), device=dev)
        for q in (10, 75, 95):
            qt = quant.luma_table(q)
            before = fused.DCT_LAUNCHES
            got = fused.fused_dct_quantize(plane, qt)
            torch.cuda.synchronize()
            assert fused.DCT_LAUNCHES == before + 1
            assert got.dtype == torch.int32 and tuple(got.shape) == shape
            if card_twin:
                close(got, fused.fused_dct_quantize_reference(plane, qt))
            close(got, fused.fused_dct_quantize_reference(plane.cpu(), qt))


@pytest.mark.cuda
@pytest.mark.parametrize("mode,shape,restart,device_pack", [
    ("420", (144, 256), 0, True), ("444", (101, 77), 3, True),
    ("422", (64, 96), 0, False), ("420", (128, 192), 7, None),
])
def test_optimize_tables_and_host_pack_on_card_match_cpu(mode, shape,
                                                          restart,
                                                          device_pack):
    require_cuda()
    img = make_image(*shape, seed=shape[1])
    kw = dict(quality=80, subsampling=mode, restart_interval=restart,
              optimize_tables=restart != 7, device_pack=device_pack)
    spills = encoder.HOST_PACK_SPILLS
    a = jpeg_tpu_torch.encode(img, device="cuda", **kw)
    assert a == jpeg_tpu_torch.encode(img, device="cpu", **kw)
    assert encoder.HOST_PACK_SPILLS == spills


@pytest.mark.cuda
@pytest.mark.parametrize("shape,restart,optimize", [
    ((144, 256), 0, False), ((101, 77), 4, True), ((37, 53), 7, False),
])
def test_gray_on_card_matches_cpu(shape, restart, optimize):
    require_cuda()
    img = make_image(*shape, seed=shape[0])[..., 0]
    kw = dict(quality=75, restart_interval=restart, optimize_tables=optimize)
    spills = encoder.HOST_PACK_SPILLS
    a = jpeg_tpu_torch.encode(img, device="cuda", **kw)
    assert a == jpeg_tpu_torch.encode(img, device="cpu", **kw)
    assert encoder.HOST_PACK_SPILLS == spills
    before = _counts()
    got = jpeg_tpu_torch.decode(a, device="cuda")
    assert _since(before) == (0, 0, 0, 1, 0)
    ref = jpeg_tpu_torch.decode(a, device="cpu")
    assert got.shape == shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1
    assert (diff != 0).sum() <= 0.005 * diff.size


def _assert_decode_close(got, ref, worst=1):
    assert got.shape == ref.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert diff.max(initial=0) <= worst
    assert (diff != 0).sum() <= 0.005 * diff.size


@pytest.mark.cuda
@pytest.mark.parametrize("mode,shape,restart,quality", [
    ("420", (144, 256), 0, 75), ("444", (101, 77), 3, 100),
    ("422", (37, 53), 0, 10), ("gray", (67, 93), 5, 95),
])
def test_densify_on_card_equals_cpu(mode, shape, restart, quality):
    dev = require_cuda()
    img = make_image(*shape, seed=quality)
    jpg = jpeg_tpu_torch.encode(
        img[..., 0] if mode == "gray" else img, quality=quality,
        restart_interval=restart, device="cpu",
        **({} if mode == "gray" else dict(subsampling=mode)))
    payload, B, Sp, Ep, Edp = decode_device.sparse_payload(*scan_args(jpg))
    cpu = decode_device.densify_body(
        decode_device.payload_tensor(payload, "cpu"), B, Sp, Ep, Edp)
    card = decode_device.densify_body(
        decode_device.payload_tensor(payload, dev), B, Sp, Ep, Edp)
    assert card.device.type == "cuda" and card.dtype == torch.int32
    assert torch.equal(card.cpu(), cpu)
    a = jpeg_tpu_torch.decode(jpg, device="cuda", entropy="sparse")
    b = jpeg_tpu_torch.decode(jpg, device="cuda", entropy="native")
    np.testing.assert_array_equal(a, b)
    _assert_decode_close(a, jpeg_tpu_torch.decode(jpg, device="cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("mode,shape", [("420", (144, 256)),
                                        ("422", (301, 77)),
                                        ("444", (37, 53))])
@pytest.mark.parametrize("scale_denom", [1, 2])
def test_finish_ycbcr_on_card_planes_equals_decode(mode, shape, scale_denom):
    """The host finish of the card's planes gives the card's own RGB bytes:
    the colour map is one multiply-add chain in the same order on both."""
    require_cuda()
    jpg = jpeg_tpu_torch.encode(make_image(*shape, seed=1), 60, mode,
                                device="cpu")
    kw = dict(device="cuda", scale_denom=scale_denom)
    rgb = jpeg_tpu_torch.decode(jpg, **kw)
    planes = jpeg_tpu_torch.decode(jpg, output="ycbcr", **kw)
    assert all(isinstance(p, np.ndarray) for p in planes.planes)
    for threads in (1, 4):
        np.testing.assert_array_equal(
            jpeg_tpu_torch.finish_ycbcr(planes, threads=threads), rgb)
    dev_planes = jpeg_tpu_torch.decode(jpg, output="ycbcr",
                                       device_output=True, **kw)
    assert all(p.device.type == "cuda" for p in dev_planes.planes)
    np.testing.assert_array_equal(jpeg_tpu_torch.finish_ycbcr(dev_planes),
                                  rgb)
    out = jpeg_tpu_torch.decode(jpg, device_output=True, **kw)
    assert isinstance(out, torch.Tensor) and out.device.type == "cuda"
    np.testing.assert_array_equal(out.cpu().numpy(), rgb)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["420", "444", "gray"])
@pytest.mark.parametrize("scale_denom", [2, 4, 8])
def test_scaled_decode_on_card_matches_cpu(mode, scale_denom):
    require_cuda()
    img = make_image(203, 331, seed=2)
    jpg = jpeg_tpu_torch.encode(
        img[..., 0] if mode == "gray" else img, quality=80, device="cpu",
        **({} if mode == "gray" else dict(subsampling=mode)))
    before = _counts()
    got = jpeg_tpu_torch.decode(jpg, device="cuda", scale_denom=scale_denom)
    # The scaled IDCT is no kernel; a colour image still takes kernel H.
    assert _since(before) == (0, 0, 0, 0, 0 if mode == "gray" else 1)
    _assert_decode_close(got, jpeg_tpu_torch.decode(
        jpg, device="cpu", scale_denom=scale_denom))


@pytest.mark.cuda
@pytest.mark.parametrize("stream", ["420", "422", "444", "gray",
                                    "cmyk.jpg", "ycck.jpg",
                                    "progressive_420.jpg"])
def test_decode_without_pallas_on_card(stream):
    """decode(use_pallas=False) on the card: the (64, 64) matmul form, no
    launch of kernel B. Its samples after the IDCT are within the decode
    contract (+-1 at .5 boundaries, <= 0.5%) of the CPU's separable form and
    of the default decode; where a colour map follows, a sample off by 1
    moves R or B by up to 1.772, so the pixels may differ by up to 3, still
    in <= 0.5% of samples. output="ycbcr" finishes to the same pixels."""
    require_cuda()
    if stream in fixtures.FIXTURES:
        jpg = fixtures.read(stream)
    else:
        img = make_image(203, 331, seed=3)
        jpg = jpeg_tpu_torch.encode(
            img[..., 0] if stream == "gray" else img, quality=80,
            device="cpu", **({} if stream == "gray" else dict(
                subsampling=stream)))
    launches = fused.LAUNCHES, fused.ZZ_LAUNCHES
    got = jpeg_tpu_torch.decode(jpg, device="cuda", use_pallas=False)
    assert (fused.LAUNCHES, fused.ZZ_LAUNCHES) == launches
    mapped = stream not in ("gray", "cmyk.jpg")  # a colour map follows
    for ref in (jpeg_tpu_torch.decode(jpg, device="cpu", use_pallas=False),
                jpeg_tpu_torch.decode(jpg, device="cuda")):
        _assert_decode_close(got, ref, worst=3 if mapped else 1)
    if stream in ("420", "422", "444", "progressive_420.jpg"):
        planes = jpeg_tpu_torch.decode(jpg, device="cuda", use_pallas=False,
                                       output="ycbcr")
        np.testing.assert_array_equal(jpeg_tpu_torch.finish_ycbcr(planes),
                                      got)
        ref = jpeg_tpu_torch.decode(jpg, device="cpu", use_pallas=False,
                                    output="ycbcr")
        for p, r in zip(planes.planes, ref.planes):
            _assert_decode_close(p, r)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(fixtures.FIXTURES))
def test_fixture_streams_on_card_match_cpu(name):
    require_cuda()
    jpg = fixtures.read(name)
    got = jpeg_tpu_torch.decode(jpg, device="cuda")
    assert got.shape == fixtures.FIXTURES[name][1]
    _assert_decode_close(got, jpeg_tpu_torch.decode(jpg, device="cpu"))


def _counts():
    """Launches of kernels (A, B, C, B2, H)."""
    return (pack.LAUNCHES, fused.LAUNCHES, fused.DCT_LAUNCHES,
            fused.ZZ_LAUNCHES, finish.LAUNCHES)


def _since(before):
    return tuple(a - b for a, b in zip(_counts(), before))


@pytest.mark.cuda
@pytest.mark.parametrize("mode,shape,restart,k", [
    ("420", (144, 256), 0, 4), ("444", (101, 77), 10, 3),
    ("422", (37, 53), 0, 2), ("420", (128, 192), 7, 2),
])
def test_encode_batched_on_card(mode, shape, restart, k):
    require_cuda()
    imgs = np.stack([make_image(*shape, seed=s) for s in range(k)])
    kw = dict(quality=80, subsampling=mode, restart_interval=restart)
    per_image = [jpeg_tpu_torch.encode(im, device="cuda", **kw)
                 for im in imgs]
    spills, before = encoder.HOST_PACK_SPILLS, _counts()
    scans = pack.SCAN_LAUNCHES
    got = jpeg_tpu_torch.encode_batched(imgs, device="cuda", **kw)
    torch.cuda.synchronize()
    # One launch of kernel A for the batch and the scan pass (four launches)
    # per image; restart 7 does not divide the MCU count, so that batch is
    # host-packed image by image.
    assert _since(before) == ((0 if restart == 7 else 1), 0, 0, 0, 0)
    assert pack.SCAN_LAUNCHES == scans + (0 if restart == 7 else 4 * k)
    assert encoder.HOST_PACK_SPILLS == spills
    assert got == per_image
    assert got == jpeg_tpu_torch.encode_batched(imgs, device="cpu", **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("batch_mode", ["fused", "pipelined", "auto"])
@pytest.mark.parametrize("scale_denom", [1, 2])
def test_decode_batched_on_card(batch_mode, scale_denom):
    require_cuda()
    jpgs = [jpeg_tpu_torch.encode(make_image(203, 331, seed=s), 85, "420",
                                  optimize_tables=s == 1, device="cpu")
            for s in range(3)]
    ref = np.stack([jpeg_tpu_torch.decode(j, device="cuda",
                                          scale_denom=scale_denom)
                    for j in jpgs])
    before = _counts()
    got = jpeg_tpu_torch.decode_batched(
        jpgs, scale_denom=scale_denom, batch_mode=batch_mode, device="cuda")
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got, ref)
    if scale_denom == 1 and batch_mode != "auto":
        assert _since(before) == ((0, 0, 0, 1, 1) if batch_mode == "fused"
                                  else (0, 0, 0, 3, 3))
    out = jpeg_tpu_torch.decode_batched(
        jpgs, scale_denom=scale_denom, batch_mode=batch_mode,
        device_output=True, device="cuda")
    assert isinstance(out, torch.Tensor) and out.device.type == "cuda"
    np.testing.assert_array_equal(out.cpu().numpy(), ref)


def _overwritten(imgs):
    """The images one after another in ONE caller buffer, each written over
    the one before as soon as the stream asks for the next."""
    flat = np.empty(max(im.size for im in imgs), dtype=np.uint8)
    for im in imgs:
        frame = flat[:im.size].reshape(im.shape)
        frame[...] = im
        yield frame


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["distinct", "overwritten"])
@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("depth", [0, 2])
def test_encode_stream_on_card(optimize, depth, source):
    require_cuda()
    imgs = [make_image(h, w, seed=h) for h, w in
            ((144, 256), (37, 53), (300, 200), (144, 256), (64, 64))]
    kw = dict(quality=80, subsampling="420", optimize_tables=optimize)
    before = _counts()
    got = list(jpeg_tpu_torch.encode_stream(
        iter(imgs) if source == "distinct" else _overwritten(imgs),
        depth=depth, device="cuda", **kw))
    torch.cuda.synchronize()
    assert _since(before) == (len(imgs), 0, 0, 0, 0)
    assert got == [jpeg_tpu_torch.encode(im, device="cuda", **kw)
                   for im in imgs]
    assert got == [jpeg_tpu_torch.encode(im, device="cpu", **kw)
                   for im in imgs]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["read_only", "view", "reversed"])
def test_encode_stream_on_card_stages_any_array(kind):
    """Arrays that the staging copy cannot take as a plain tensor (not
    writable, a negative stride) or takes strided (a view into a wider
    image) give encode()'s bytes."""
    require_cuda()
    wide = [make_image(96, 160, seed=s) for s in range(4)]
    if kind == "read_only":
        imgs = [im.copy() for im in wide]
        for im in imgs:
            im.setflags(write=False)
    elif kind == "view":
        imgs = [im[8:72, 16:136] for im in wide]
    else:
        imgs = [im[::-1, ::-1] for im in wide]
    got = list(jpeg_tpu_torch.encode_stream(iter(imgs), 80, device="cuda"))
    assert got == [jpeg_tpu_torch.encode(im, 80, device="cuda")
                   for im in imgs]
    assert got == [jpeg_tpu_torch.encode(im, 80, device="cpu")
                   for im in imgs]


def _scan_pass_inputs(case, dev):
    """(buf, t_b, nwords, rst_base) on the card: the seed-0 4K q75 frame's
    kernel A output (colour 4:2:0 in one segment, at restart 240, 135
    segments, or at restart 1, 32,400 segments; or its first channel,
    gray), or a 0xFF-dense synthetic set."""
    if case == "ff_dense":
        rng = np.random.default_rng(17)
        t = rng.integers(0, 257, size=(4, 3000))
        buf = np.concatenate([scan_block_words(rng, t[:2].reshape(-1), "ones"),
                              scan_block_words(rng, t[2:].reshape(-1))])
        return (torch.as_tensor(buf, device=dev).reshape(4, 3000, -1),
                torch.as_tensor(t.astype(np.int32), device=dev),
                3000 * encoder.WORDS_PER_BLOCK + 2, 6)
    img = make_image(2160, 3840)
    qy, qc = quant.luma_table(75), quant.chroma_table(75)
    luts = encoder._device_luts(huffman.standard_tables(), dev)
    if case == "gray":
        zz = mcu_conv.gray_transform_int(torch.as_tensor(
            np.ascontiguousarray(img[..., 0]), device=dev), qy)
        zz[:, 0] = dpcm.dpcm(zz[:, 0], 0)
        tbl = torch.zeros(zz.shape[0], dtype=torch.int32, device=dev)
        return encoder._level1_segments(zz, tbl, luts, zz.shape[0], 0) + (0,)
    r = {"4k_rst240": 240, "4k_rst1": 1}.get(case, 0)
    mode = encoder.Subsampling("420")
    blocks, tbl, n_mcu, _ = encoder._interleaved_blocks(
        torch.as_tensor(img, device=dev), qy, qc, mode, r)
    return encoder._level1_segments(blocks, tbl, luts, n_mcu, r) + (0,)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["4k", "ff_dense", "4k_rst240", "4k_rst1",
                                  "gray"])
def test_scan_pass_matches_twin(case):
    dev = require_cuda()
    buf, t_b, nwords, rst_base = _scan_pass_inputs(case, dev)
    before = pack.SCAN_LAUNCHES
    scan, status = pack.pack_scan(buf, t_b, nwords, rst_base)
    torch.cuda.synchronize()
    assert pack.SCAN_LAUNCHES == before + 4
    assert scan.device.type == status.device.type == "cuda"
    ref_scan, ref_status = pack.pack_scan_reference(buf, t_b, nwords,
                                                    rst_base)
    assert status.cpu().tolist() == ref_status.tolist()
    nseg = t_b.shape[0]
    assert ref_status[nseg:2 * nseg].tolist() == [1] * nseg
    assert nseg == {"4k_rst240": 135, "4k_rst1": 32400,
                    "ff_dense": 4}.get(case, 1)
    count = int(ref_status[-1])
    assert count == ref_scan.numel() > 0
    assert torch.equal(scan[:count].cpu(), ref_scan)


@pytest.mark.cuda
def test_encode_stream_through_the_scan_pass_on_card():
    """encode_stream's bytes equal encode()'s and the host pack's on the 4K
    frame and smaller ones; the pass runs once per image (its four
    launches), a spilled image's included: its status is how the spill is
    known, and its bytes are then not used."""
    require_cuda()
    imgs = [make_image(2160, 3840), make_image(144, 256, seed=3),
            make_image(37, 53, seed=4)]
    scans, spills = pack.SCAN_LAUNCHES, encoder.HOST_PACK_SPILLS
    got = list(jpeg_tpu_torch.encode_stream(iter(imgs), device="cuda"))
    assert pack.SCAN_LAUNCHES == scans + 4 * len(imgs)
    assert got == [jpeg_tpu_torch.encode(im, device="cuda") for im in imgs]
    assert got == [jpeg_tpu_torch.encode(im, device="cuda", device_pack=False)
                   for im in imgs]
    assert encoder.HOST_PACK_SPILLS == spills
    # At q100 4:4:4 noise overflows the 288-bit budget and a smooth ramp
    # does not.
    noise = np.random.default_rng(5).integers(0, 256, size=(24, 32, 3))
    yy, xx = np.mgrid[0:24, 0:32]
    smooth = np.stack([xx * 4, yy * 5, xx + yy], -1)
    pair = [noise.astype(np.uint8), smooth.astype(np.uint8)]
    scans = pack.SCAN_LAUNCHES
    got = list(jpeg_tpu_torch.encode_stream(pair, 100, "444", device="cuda"))
    assert encoder.HOST_PACK_SPILLS == spills + 1
    assert pack.SCAN_LAUNCHES == scans + 8
    assert got == [jpeg_tpu_torch.encode(im, 100, "444", device="cpu")
                   for im in pair]


@pytest.mark.cuda
def test_mosaic_stream_through_the_scan_pass_on_card():
    """encode_mosaic_stream on the card: each stripe's scan from one scan
    pass, its RSTn numbered from the stripe's first segment (past 7 from
    the third stripe on), spliced into the bytes of the CPU's stream and of
    encode() of the whole image."""
    require_cuda()
    img = make_image(720, 1280, seed=6)
    kw = dict(quality=80, subsampling="420", stripe_rows=64, rst_rows=1)
    scans = pack.SCAN_LAUNCHES
    got = mosaic.encode_mosaic_stream(lambda a, b: img[a:b], 720, 1280,
                                      device="cuda", **kw)
    assert pack.SCAN_LAUNCHES == scans + pack._SCAN_STEPS * -(-720 // 64)
    assert got == mosaic.encode_mosaic_stream(lambda a, b: img[a:b], 720,
                                              1280, device="cpu", **kw)
    assert got == jpeg_tpu_torch.encode(img, 80, "420", device="cuda",
                                        restart_interval=1280 // 16)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 4])
def test_decode_stream_on_card_counts_under_threads(depth):
    require_cuda()
    jpgs = [jpeg_tpu_torch.encode(make_image(h, w, seed=h), 80, m,
                                  device="cpu")
            for (h, w), m in zip(((144, 256), (37, 53), (300, 200), (64, 64)),
                                 ("420", "444", "422", "420"))] * 4
    ref = [jpeg_tpu_torch.decode(j, device="cuda") for j in jpgs]
    before = _counts()
    got = list(jpeg_tpu_torch.decode_stream(iter(jpgs), depth=depth,
                                            device="cuda"))
    assert _since(before) == (0, 0, 0, len(jpgs), len(jpgs))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    dev = list(jpeg_tpu_torch.decode_stream(jpgs[:4], depth=depth,
                                            device_output=True,
                                            device="cuda"))
    for a, b in zip(dev, ref):
        assert a.device.type == "cuda"
        np.testing.assert_array_equal(a.cpu().numpy(), b)


@pytest.mark.cuda
def test_decode_from_four_threads_on_side_streams_counts_exactly():
    """decode() from 4 threads, each under a CUDA stream of its own: the
    pixels of the serial decode, and no launch lost from the count."""
    require_cuda()
    jpgs = [jpeg_tpu_torch.encode(make_image(144, 256, seed=s), 80, "420",
                                  device="cpu") for s in range(4)]
    ref = [jpeg_tpu_torch.decode(j, device="cuda") for j in jpgs]
    rounds, threads = 10, 4
    bad = []

    def work(t):
        with torch.cuda.stream(torch.cuda.Stream()):
            for r in range(rounds):
                i = (t + r) % len(jpgs)
                if not np.array_equal(
                        jpeg_tpu_torch.decode(jpgs[i], device="cuda"), ref[i]):
                    bad.append((t, r))

    before = _counts()
    workers = [threading.Thread(target=work, args=(t,))
               for t in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=300)
        assert not w.is_alive()
    assert not bad
    assert _since(before) == (0, 0, 0, rounds * threads, rounds * threads)


@pytest.mark.cuda
def test_multiscan_and_progressive_on_card_match_cpu():
    from jpeg_tpu_torch.models.progressive_enc import encode_progressive

    require_cuda()
    img = make_image(101, 77, seed=3)
    for kw in (dict(), dict(restart_interval=4, optimize_tables=True)):
        a = jpeg_tpu_torch.encode_noninterleaved(img, 80, device="cuda", **kw)
        assert a == jpeg_tpu_torch.encode_noninterleaved(img, 80,
                                                         device="cpu", **kw)
    base = jpeg_tpu_torch.decode(
        jpeg_tpu_torch.encode(img, 80, "444", device="cuda"), device="cuda")
    np.testing.assert_array_equal(jpeg_tpu_torch.decode(a, device="cuda"),
                                  base)
    for im, kw in ((img, dict(subsampling="420")), (img[..., 0], {})):
        a = encode_progressive(im, 80, device="cuda", **kw)
        assert a == encode_progressive(im, 80, device="cpu", **kw)
        np.testing.assert_array_equal(
            jpeg_tpu_torch.decode(a, device="cuda"),
            jpeg_tpu_torch.decode(
                jpeg_tpu_torch.encode(im, 80, device="cuda", **kw),
                device="cuda"))


@pytest.mark.cuda
def test_kernels_past_two_gib_of_input():
    """Kernel A on 8,388,704 blocks (2,147,508,224 bytes of coefficients)
    and kernel B on a 139,824 x 3840 plane (2,147,696,640 bytes), the sizes
    a large batch stacks up: element offsets past 2^31 bytes. About 9 GB of
    device memory in all. Blocks are independent, so slices of the result
    are held to the twins on the same slices: the first blocks, the last
    (ragged) ones and those around the 2^31-byte line."""
    dev = require_cuda()
    rng = np.random.default_rng(1)
    luts = _luts(dev)
    n = (1 << 31) // 256 + 96  # one tile past the line
    part = torch.as_tensor(random_blocks(rng, 1 << 16, 0.1), device=dev)
    blocks = part.repeat(n // part.shape[0] + 1, 1)[:n].contiguous()
    tbl = (torch.arange(n, device=dev) % 3 == 0).to(torch.int32)
    buf, tot = pack.pack_level1(blocks, tbl, *luts)
    torch.cuda.synchronize()
    line = (1 << 31) // 256
    for lo, hi in ((0, 500), (line - 300, line + 96), (n - 200, n)):
        ref_buf, ref_tot = pack.pack_level1_reference(
            blocks[lo:hi], tbl[lo:hi], *luts)
        assert torch.equal(tot[lo:hi], ref_tot)
        fits = ref_tot <= BUDGET
        assert torch.equal(buf[lo:hi][fits], ref_buf[fits])
    del blocks, tbl, buf, tot

    h, w = 139_824, 3840
    tile_rows = torch.as_tensor(
        rng.integers(-60, 61, size=(1368, w)).astype(np.int32), device=dev)
    coeffs = tile_rows.repeat(h // 1368 + 1, 1)[:h].contiguous()
    assert coeffs.numel() * 4 > 1 << 31
    qt = quant.luma_table(75)
    out = fused.fused_dequant_idct(coeffs, qt)
    torch.cuda.synchronize()
    line = (1 << 31) // (4 * w) // 8 * 8
    for lo, hi in ((0, 64), (line - 64, line + 64), (h - 64, h)):
        ref = fused.fused_dequant_idct_reference(coeffs[lo:hi], qt)
        torch.testing.assert_close(out[lo:hi], ref, atol=1e-2, rtol=0)


@pytest.mark.cuda
def test_finish_kernels_past_two_gib_of_input():
    """Kernel B2 on 87,383 x 96 zig-zag blocks (2,147,524,608 bytes) and
    kernel H on 264 stacked 4:2:0 images of 2160x3840 (a 2,189,721,600-byte
    Y plane; 6.6 GB of RGB out): offsets past 2^31 bytes in and out. Blocks
    and images are independent, so slices are held to the twins, 0 apart:
    the first, the last and those around the 2^31-byte lines. About 13 GB
    of device memory."""
    dev = require_cuda()
    rng = np.random.default_rng(2)
    wb = 96
    n = ((1 << 31) // 256 // wb + 2) * wb
    part = torch.as_tensor(random_blocks(rng, 1 << 16, 0.1), device=dev)
    zz = part.repeat(n // part.shape[0] + 1, 1)[:n].contiguous()
    assert zz.numel() * 4 > 1 << 31
    qt = quant.luma_table(75)
    out = fused.dequant_idct_samples(zz, qt, (n // wb, wb))
    torch.cuda.synchronize()
    line = (1 << 31) // 256 // wb * wb
    for lo, hi in ((0, 4 * wb), (line - 2 * wb, line + 2 * wb),
                   (n - 4 * wb, n)):
        ref = fused.dequant_idct_samples_reference(
            zz[lo:hi], qt, ((hi - lo) // wb, wb))
        assert torch.equal(out[lo // wb * 8:hi // wb * 8], ref)
    del zz, out, part

    k, h, w = 264, 2160, 3840
    base = [torch.as_tensor(rng.integers(0, 256, size=(8, rows, cols)).astype(
        np.uint8), device=dev) for rows, cols in ((h, w), (h // 2, w // 2),
                                                  (h // 2, w // 2))]
    planes = [b.repeat(k // 8, 1, 1) for b in base]
    assert planes[0].numel() > 1 << 31
    factors = ((1, 1), (2, 2), (2, 2))
    rgb = finish.finish_color(planes, factors, (True,) * 3, False, h - 3,
                              w - 5)
    torch.cuda.synchronize()
    line_in, line_out = (1 << 31) // (h * w), (1 << 31) // (rgb[0].numel())
    for i in (0, line_out, line_out + 1, line_in, line_in + 1, k - 1):
        ref = finish.finish_color_reference([p[i] for p in planes], factors,
                                            (True,) * 3, False, h - 3, w - 5)
        assert torch.equal(rgb[i], ref)


# ---------------------------------------------------------------------------
# The device Huffman decoders: kernel D and the block-start program (F's
# mode and E's route).
# ---------------------------------------------------------------------------

HUFFMAN_CASES = [
    ("420", (203, 331), 0, False), ("420", (203, 331), 21, True),
    ("422", (90, 150), 7, False), ("444", (101, 77), 0, True),
    ("444", (101, 77), 10, False), ("gray", (75, 97), 0, False),
    ("gray", (75, 97), 13, True), ("420", (16, 16), 0, False),
]


def _huffman_stream(mode, shape, restart, optimize):
    img = make_image(*shape, seed=shape[0] + restart)
    kw = dict(quality=85, restart_interval=restart, optimize_tables=optimize,
              device="cpu")
    if mode == "gray":
        return jpeg_tpu_torch.encode(img[..., 0], **kw)
    return jpeg_tpu_torch.encode(img, subsampling=mode, **kw)


def _huffman_counts():
    return (entropy_decode.AC_LAUNCHES, entropy_decode.SEGMENT_LAUNCHES,
            entropy_decode.PREFIX_LAUNCHES)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,shape,restart,optimize", HUFFMAN_CASES)
def test_huffman_kernels_match_twins(mode, shape, restart, optimize):
    dev = require_cuda()
    jpg = _huffman_stream(mode, shape, restart, optimize)
    args = scan_args(jpg)
    want = np.concatenate(native.decode_scan(*args))
    # Kernel D on the host index pass's offsets.
    d_in = ac_indexed_inputs(jpg, dev)
    rows = entropy_decode.decode_ac_indexed(*d_in)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(rows.cpu().numpy(), want)
    assert torch.equal(rows, entropy_decode.decode_ac_indexed_reference(*d_in))
    # E's route on the stream's segments (one segment without markers).
    e_in, bits = segment_inputs(jpg, dev)
    rows, status = entropy_decode.decode_segments(*e_in)
    t_rows, t_status = entropy_decode.decode_segments_reference(*e_in)
    np.testing.assert_array_equal(rows.cpu().numpy(), want)
    assert torch.equal(rows, t_rows) and torch.equal(status, t_status)
    assert not status[1].any()
    assert all(b - 7 <= e <= b for e, b in zip(status[0].tolist(), bits))
    host_words, seg_off, lens = decode_device.unstuffed_segments(args[0])
    assert np.array_equal(e_in[0].cpu().numpy(), host_words)
    assert np.array_equal(e_in[1].cpu().numpy(), seg_off)
    assert (lens * 8).tolist() == bits
    # Program F, where there are no markers and more than one MCU.
    if restart == 0 and args[1] > 1:
        f_in, true_bits = prefix_inputs(jpg, dev)
        got = entropy_decode.prefix_index(*f_in)
        twin = entropy_decode.prefix_index_reference(*f_in)
        for g, t in zip(got, twin):
            assert torch.equal(g, t)
        assert got[2].tolist() == [status[0, 0].item(), 0]
        off, dc = regroup_prefix(got[0], got[1], args[2])
        _, want_off, want_dc = native.index_scan(*args)
        np.testing.assert_array_equal(off.cpu().numpy(), want_off)
        np.testing.assert_array_equal(dc.cpu().numpy(), want_dc)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,shape,restart,optimize", HUFFMAN_CASES)
def test_device_entropy_backends_on_card(mode, shape, restart, optimize):
    require_cuda()
    jpg = _huffman_stream(mode, shape, restart, optimize)
    args = scan_args(jpg)
    want = native.decode_scan(*args)
    one_mcu = args[1] == 1
    for fn, launches in (
            (decode_device.decode_scan_indexed, (1, 0, 0)),
            (decode_device.decode_scan,
             (1, 1, 0) if restart or one_mcu else (1, 0, 1))):
        before = _huffman_counts()
        got = fn(*args, device="cuda")
        torch.cuda.synchronize()
        assert tuple(a - b for a, b in zip(_huffman_counts(), before)) == (
            launches)
        for g, w in zip(got, want):
            assert g.device.type == "cuda" and g.dtype == torch.int32
            np.testing.assert_array_equal(g.cpu().numpy(), w)
    px = jpeg_tpu_torch.decode(jpg, device="cuda", entropy="sparse")
    for entropy in ("indexed", "device"):
        np.testing.assert_array_equal(
            jpeg_tpu_torch.decode(jpg, device="cuda", entropy=entropy), px)
    np.testing.assert_array_equal(
        jpeg_tpu_torch.decode(jpg, device="cuda", entropy="device",
                              scale_denom=2),
        jpeg_tpu_torch.decode(jpg, device="cuda", entropy="sparse",
                              scale_denom=2))


@pytest.mark.cuda
@pytest.mark.parametrize("entropy", ["indexed", "device"])
def test_device_entropy_on_fixtures_and_streams_on_card(entropy):
    require_cuda()
    for name in ("noninterleaved_444.jpg", "cmyk.jpg", "progressive_420.jpg"):
        jpg = fixtures.read(name)
        np.testing.assert_array_equal(
            jpeg_tpu_torch.decode(jpg, device="cuda", entropy=entropy),
            jpeg_tpu_torch.decode(jpg, device="cuda", entropy="native"))
    jpgs = [_huffman_stream(*c) for c in HUFFMAN_CASES[:6]] * 3
    ref = [jpeg_tpu_torch.decode(j, device="cuda", entropy="sparse")
           for j in jpgs]
    before = fused.ZZ_LAUNCHES
    got = list(jpeg_tpu_torch.decode_stream(iter(jpgs), depth=4,
                                            entropy=entropy, device="cuda"))
    assert fused.ZZ_LAUNCHES - before == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_camera_frames_take_the_anchored_route_on_card():
    """Three 1080p RFC 2435 type-64 frames (4:2:2, a restart every MCU row:
    135 segments) from the benchmark's plain encoder through decode_stream
    as the camera cell runs it: every segment walked by the anchored route,
    no launch of program F, the pixels inside the reference's bounds."""
    dev = require_cuda()
    imgs = [make_image(1080, 1920, seed=k) for k in range(3)]
    jpgs, coefs = plain_streams(imgs, "422", 120, device=dev)
    before = (entropy_decode.RESTART_SEGMENTS, entropy_decode.PREFIX_LAUNCHES)
    got = list(jpeg_tpu_torch.decode_stream(
        iter(jpgs), depth=2, entropy="auto", device_output=True, device=dev))
    assert (entropy_decode.RESTART_SEGMENTS - before[0],
            entropy_decode.PREFIX_LAUNCHES - before[1]) == (3 * 135, 0)
    for out, c in zip(got, coefs):
        assert outside_bounds(out, c, 1080, 1920, "422") == 0


# (n_mcu, blocks per MCU of each component, restart interval): a camera
# frame, a 500x375 4:2:0 image, a 4K 4:2:0 frame, the 4K frame at restart 1.
DC_SHAPES = {"camera": (16200, [2, 1, 1], 120),
             "imagenet": (768, [4, 1, 1], 32),
             "4k": (32400, [4, 1, 1], 240),
             "4k-restart1": (32400, [4, 1, 1], 1)}


@pytest.mark.cuda
@pytest.mark.parametrize("anchored", [True, False])
@pytest.mark.parametrize("shape", list(DC_SHAPES))
def test_dc_sum_launch_matches_its_twin(shape, anchored):
    """The DC sums' one launch (csrc/scan_decode.cu) against the torch sums
    it replaced, per (segment, component) anchored and per component from
    bit 0, on random differences (the sums wrap as int32)."""
    dev = require_cuda()
    n_mcu, comp_bpm, interval = DC_SHAPES[shape]
    bpm = sum(comp_bpm)
    rng = np.random.default_rng(bpm * n_mcu + interval)
    diff = torch.as_tensor(rng.integers(-2**31, 2**31, size=n_mcu * bpm,
                                        dtype=np.int64).astype(np.int32),
                           device=dev)
    ac_off = torch.as_tensor(rng.integers(0, 2**30, size=(n_mcu, bpm),
                                          dtype=np.int32), device=dev)
    seq = torch.as_tensor(rng.integers(0, 8, size=(bpm, 3), dtype=np.int32),
                          device=dev)
    if not anchored:
        diff = diff.view(n_mcu, bpm)
    before = entropy_decode.DC_SUM_LAUNCHES
    for _ in range(3):  # tiles race differently from launch to launch
        got = entropy_decode.dc_sums(diff, ac_off, seq, comp_bpm, interval,
                                     n_mcu, anchored)
        want = entropy_decode.dc_sums_reference(
            diff, ac_off, seq, comp_bpm, interval, n_mcu, anchored)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if w is not None:
                assert g.dtype == torch.int32 and torch.equal(g, w)
    assert entropy_decode.DC_SUM_LAUNCHES == before + 3


def _card_streams():
    """Camera frames (1080p 4:2:2, a restart every MCU row) and ImageNet
    shapes (q90 4:2:0 without markers), from the plain encoder."""
    cams, _ = plain_streams([make_image(1080, 1920, seed=k) for k in range(2)],
                            "422", 120)
    nets = []
    for k, (h, w) in enumerate(((375, 500), (333, 500), (500, 375),
                                (500, 333), (500, 500))):
        (data,), _ = plain_streams([make_image(h, w, seed=10 + k)], "420", 0,
                                   quality=90)
        nets.append(data)
    return cams + nets


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_decode_stream_takes_one_native_call_per_scan(depth):
    """decode_stream over camera frames and ImageNet shapes: the CPU twins'
    arrays exactly, and every scan's chain enqueued by one C call
    (NATIVE_SCANS), from depth worker threads."""
    dev = require_cuda()
    jpgs = _card_streams() * 2
    want = [jpeg_tpu_torch.decode(j, device="cpu", entropy="device")
            for j in jpgs]
    before = (entropy_decode.NATIVE_SCANS, entropy_decode.DC_SUM_LAUNCHES)
    got = list(jpeg_tpu_torch.decode_stream(iter(jpgs), depth=depth,
                                            device=dev))
    assert (entropy_decode.NATIVE_SCANS - before[0],
            entropy_decode.DC_SUM_LAUNCHES - before[1]) == (len(jpgs),
                                                            len(jpgs))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_a_corrupt_segment_raises_and_the_next_decode_is_right():
    """A corrupt restart segment raises ScanDecodeError on the card, and the
    next decode on the same thread, which reuses the thread's pinned
    buffer, is right; so is a wrong segment count."""
    require_cuda()
    for jpg in _card_streams()[:3]:
        scan, n_mcu, mcu_layout, htables, r = scan_args(jpg)
        want = native.decode_scan(scan, n_mcu, mcu_layout, htables, r)
        bad = bytearray(scan)
        for i in range(len(bad) // 3, len(bad) // 3 + 64):
            if 0xFF not in (bad[i - 1], bad[i], bad[i + 1]):
                bad[i] = 0xFE  # a run of 1-bits: no Huffman code is that long
        with pytest.raises(ScanDecodeError):
            decode_device.decode_scan(bytes(bad), n_mcu, mcu_layout, htables,
                                      r, device="cuda")
        with pytest.raises(ScanDecodeError, match="restart segments"):
            decode_device.decode_scan(scan, n_mcu, mcu_layout, htables,
                                      r + 1 if r else 7, device="cuda")
        for _ in range(2):
            got = decode_device.decode_scan(scan, n_mcu, mcu_layout, htables,
                                            r, device="cuda")
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.cpu().numpy(), w)


@pytest.mark.cuda
def test_corrupt_scans_on_card_raise_or_decode():
    """Flipped scan bytes and a cut scan: the kernels return, the host
    raises ScanDecodeError or gets rows, and kernel and twin decide alike."""
    dev = require_cuda()
    for case in (HUFFMAN_CASES[0], HUFFMAN_CASES[1], HUFFMAN_CASES[5]):
        jpg = _huffman_stream(*case)
        scan, n_mcu, mcu_layout, htables, r = scan_args(jpg)
        rng = np.random.default_rng(4)
        scans = [scan[: len(scan) // 2]]
        for _ in range(8):
            bad = bytearray(scan)
            i = int(rng.integers(0, len(bad)))
            bad[i] = (bad[i] ^ int(rng.integers(1, 255))) & 0xFE
            scans.append(bytes(bad))
        for bad in scans:
            outs = []
            for device in ("cuda", "cpu"):
                try:
                    outs.append(decode_device.decode_scan(
                        bad, n_mcu, mcu_layout, htables, r, device=device))
                except ScanDecodeError:
                    outs.append(None)
            torch.cuda.synchronize()
            assert (outs[0] is None) == (outs[1] is None)
            if outs[0] is not None:
                for g, t in zip(*outs):
                    np.testing.assert_array_equal(g.cpu().numpy(), t.numpy())
