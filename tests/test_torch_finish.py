"""The decode finish of the port (models/decoder._finish_color,
_finish_gray, _finish_planes) and its two kernels' plain twins, on the CPU.

Kernel B2 (csrc/idct8.cu, jt_idct8_zz_u8: zig-zag blocks in, uint8 samples
out) and kernel H (csrc/finish_color.cu: upsample, YCbCr -> RGB, round,
clip, crop) run only on a card; here their per-thread bodies are compiled
with g++ against stand-ins for the CUDA built-ins they use and driven
through the wrappers' launch functions. Tolerances:
  - exact: the twins (ops/fused.dequant_idct_samples_reference,
    ops/finish.finish_color_reference) against the chain of torch ops the
    decoder ran before them (the f32 _reconstruct_plane, the upsamplers of
    ops/subsample, ops/color.ycbcr_to_rgb, round, clip, crop), over every
    ratio pair in {1, 2, 3, 4}^2, both upsample choices, is_rgb, crops and
    a batch of three images; kernel H's body against its twin on the same
    cases (integer samples make every step before the colour map exact,
    and the kernel keeps the map's f32 operations in their order); kernel
    B2's body against kernel B's body rounded and clamped, and against a
    numpy emulation of its FMA chains; decode(device="cpu") against the
    old chain composed here from the decoder's blocks;
  - kernel B2's body against its twin: their f32 sums may differ in order
    (a CPU matrix product against FMA chains), so a sample on a .5
    boundary may round the other way: +-1 in at most 0.5% of samples;
  - against jpeg_tpu's finish (use_pallas=True: the Pallas IDCT in
    interpret mode): the decode contract, samples +-1 in at most 0.5%, and
    RGB pixels within 3 (a chroma sample 1 apart moves R or B by up to
    1.772) in at most 0.5%.
"""

import ctypes
import itertools
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jpeg_tpu.models import decoder as JDEC
from jpeg_tpu.ops import quant as JQ

import jpeg_tpu_torch
from jpeg_tpu_torch.io import jfif
from jpeg_tpu_torch.models import decoder as PDEC, layout
from jpeg_tpu_torch.ops import (
    color as PC, dct as PD, finish as PFI, fused as PF, subsample as PSU,
    tile as PT, zigzag as PZ)

import torch_port_fixtures as port_fixtures
from torch_port_util import make_image, random_blocks

CSRC = (pathlib.Path(__file__).resolve().parent.parent / "jpeg_tpu_torch"
        / "csrc")
RATIOS = list(itertools.product((1, 2, 3, 4), repeat=2))
DIFF_SHARE = 0.005

# ---------------------------------------------------------------------------
# The chain the decoder ran before kernels B2 and H, composed from torch ops.
# ---------------------------------------------------------------------------


def old_samples(zz, q, shape):
    """The f32 integer samples of the old decoder: from_zigzag, unblockify,
    kernel B's twin, round, clamp."""
    hb, wb = shape
    plane = PF.fused_dequant_idct_reference(
        PT.unblockify(PZ.from_zigzag(zz.reshape(hb, wb, 64))), q)
    return torch.clamp(torch.round(plane), 0.0, 255.0)


def old_finish(planes, factors, fancy, is_rgb, hlim, wlim):
    """The old decoder's upsample, colour map, round, clip and crop on f32
    planes of integer samples."""
    ups = []
    for p, (fh, fv), fan in zip(planes, factors, fancy):
        p = p.to(torch.float32)
        if fh > 1 or fv > 1:
            p = (PSU.fancy_upsample_factors(p, fv, fh) if fan
                 else PSU.upsample_factors(p, fv, fh))
        ups.append(p)
    ycc = torch.stack(ups, dim=-1)
    rgb = ycc if is_rgb else PC.ycbcr_to_rgb(ycc, clip=False)
    out = torch.clamp(torch.round(rgb), 0, 255).to(torch.uint8)
    return out[..., :hlim, :wlim, :]


# ---------------------------------------------------------------------------
# The kernels' bodies, compiled for the host.
# ---------------------------------------------------------------------------

_STANDIN_HEAD = r"""
#define JT_HOST_STANDIN
#include <cmath>
#include <cstdint>
#define __device__
#define __forceinline__ inline
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) int4 { int x, y, z, w; };
struct alignas(8) uint2 { unsigned x, y; };
static inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
static inline int4 __ldg(const int4* p) { return *p; }
static inline unsigned char __ldg(const unsigned char* p) { return *p; }
static inline float __fmul_rn(float a, float b) { return a * b; }
static inline float __fadd_rn(float a, float b) { return a + b; }
#include <cstring>
static inline int __float_as_int(float f) {
  int i;
  std::memcpy(&i, &f, 4);
  return i;
}
static inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, 4);
  return f;
}
"""

_STANDIN_IDCT8 = _STANDIN_HEAD + r"""
#include "idct8.cu"
// One loop iteration per CUDA thread (block), in reverse order.
extern "C" int jt_idct8_zz_u8(const void* zz, const void* qtab, void* out,
                              int hb, int wb, void*) {
  for (long t = (long)hb * wb - 1; t >= 0; --t)
    idct8_block<true>((const int32_t*)zz, (const float*)qtab, out, t, 8 * wb,
                      wb);
  return 0;
}
extern "C" int jt_idct8(const void* coeffs, const void* qtab, void* out,
                        int h, int w, void*) {
  for (long t = (long)(h / 8) * (w / 8) - 1; t >= 0; --t)
    idct8_block<false>((const int32_t*)coeffs, (const float*)qtab, out, t, w,
                       w / 8);
  return 0;
}
"""

_STANDIN_FINISH = _STANDIN_HEAD + r"""
#include "finish_color.cu"
// One loop iteration per CUDA thread (group of pixels), in reverse order.
extern "C" int jt_finish_color(const void* const* planes, const int* geo,
                               const float* m, void* out, int n, int hlim,
                               int wlim, int is_rgb, void*) {
  const Args a = make_args(planes, geo, m, out, hlim, wlim, is_rgb);
  for (int img = n - 1; img >= 0; --img)
    for (int orow = hlim - 1; orow >= 0; --orow)
      for (int g = row_groups(wlim) - 1; g >= 0; --g) {
        uint32_t b[3 * kGroup];
        group_bytes(a, img, orow, g * kGroup, b);
        store_group(a, img, orow, g * kGroup, b);
      }
  return 0;
}
"""


def _build(directory, source, flags=()):
    (directory / "standin.cc").write_text(source)
    lib = directory / "libstandin.so"
    subprocess.run(
        ["g++", "-O1", "-std=c++17", "-ffp-contract=off", "-x", "c++",
         "-shared", "-fPIC", *flags, f"-I{CSRC}", "-o", str(lib),
         str(directory / "standin.cc")],
        check=True, capture_output=True, text=True, timeout=300)
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def standin_idct8(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    return _build(tmp_path_factory.mktemp("idct8_standin"), _STANDIN_IDCT8)


@pytest.fixture(scope="module", params=[None, 4])
def standin_finish(request, tmp_path_factory):
    """Kernel H's body as built (8 pixels to a thread), and with 4
    (-DJT_GROUP=4)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    flags = [f"-DJT_GROUP={request.param}"] if request.param else []
    return _build(tmp_path_factory.mktemp("finish_standin"), _STANDIN_FINISH,
                  flags)


def b2_on_host(lib, zz, q, shape):
    """Kernel B2's body through the wrapper's launch function."""
    hb, wb = shape
    out = torch.full((hb * 8, wb * 8), 7, dtype=torch.uint8)
    qf = torch.as_tensor(q, dtype=torch.float32).reshape(64).contiguous()
    before = PF.ZZ_LAUNCHES
    PF._launch_idct_samples(zz.contiguous(), qf, out, hb, wb, lib=lib)
    assert PF.ZZ_LAUNCHES == before + 1
    return out


def b_on_host(lib, coeffs, q):
    """Kernel B's body on an image-layout plane: (H, W) f32."""
    h, w = coeffs.shape
    out = torch.empty((h, w), dtype=torch.float32)
    qf = torch.as_tensor(q, dtype=torch.float32).reshape(64).contiguous()
    assert lib.jt_idct8(
        ctypes.c_void_p(coeffs.data_ptr()), ctypes.c_void_p(qf.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), ctypes.c_int(h), ctypes.c_int(w),
        None) == 0
    return out


def h_on_host(lib, planes, factors, fancy, is_rgb, hlim, wlim):
    """Kernel H's body through the wrapper's launch function."""
    n, geo = PFI._geometry(planes, factors, fancy, hlim, wlim)
    shape = (hlim, wlim, 3) if planes[0].ndim == 2 else (n, hlim, wlim, 3)
    out = torch.full(shape, 7, dtype=torch.uint8)
    before = PFI.LAUNCHES
    PFI._launch_finish([p.contiguous() for p in planes], geo, out, n, hlim,
                       wlim, is_rgb, lib=lib)
    assert PFI.LAUNCHES == before + 1
    return out


def _fma(a, b, acc):
    """f32 fused multiply-add through f64 (the product of two f32 is exact
    there)."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + acc.astype(np.float64)).astype(np.float32)


def chain_samples(zz, q, shape):
    """Kernel B2's arithmetic in numpy: dequantize in raster order, the
    column chains over u = 0..7 from zero, the row chains over v = 0..7,
    +128, round half to even, clip."""
    hb, wb = shape
    d = PD.dct_basis()
    c = PZ.from_zigzag(torch.as_tensor(zz).reshape(hb, wb, 64)).numpy()
    c = c.astype(np.float32) * np.asarray(q, dtype=np.float32).reshape(8, 8)
    t = np.zeros_like(c)                                   # a b y v
    for u in range(8):
        t = _fma(d[None, None, u, :, None], c[:, :, u, None, :], t)
    o = np.zeros_like(c)                                   # a b y x
    for v in range(8):
        o = _fma(t[..., v, None], d[None, None, None, v, :], o)
    s = np.clip(np.rint(o + np.float32(128)), 0, 255).astype(np.uint8)
    return s.transpose(0, 2, 1, 3).reshape(hb * 8, wb * 8)


# ---------------------------------------------------------------------------
# Kernel B2 and its twin.
# ---------------------------------------------------------------------------

B2_CASES = [((1, 1), 0.3, 50), ((3, 5), 0.15, 75), ((6, 17), 0.3, 95),
            ((16, 9), 0.05, 10), ((2, 40), 0.6, 1)]


def _blocks(rng, shape, density):
    hb, wb = shape
    zz = random_blocks(rng, hb * wb, density)
    zz[:, 0] = rng.integers(-1024, 1024, size=hb * wb)
    return torch.as_tensor(zz)


@pytest.mark.parametrize("shape,density,quality", B2_CASES)
def test_samples_twin_equals_old_chain(shape, density, quality):
    rng = np.random.default_rng(shape[0] * 31 + shape[1])
    zz = _blocks(rng, shape, density)
    q = JQ.luma_table(quality)
    got = PF.dequant_idct_samples(zz, q, shape)
    assert got.dtype == torch.uint8 and got.shape == (shape[0] * 8,
                                                      shape[1] * 8)
    np.testing.assert_array_equal(got.numpy(),
                                  old_samples(zz, q, shape).numpy())
    np.testing.assert_array_equal(
        got.numpy(), PDEC._reconstruct_plane(zz, torch.as_tensor(
            q, dtype=torch.float32), shape).to(torch.uint8).numpy())
    out = torch.empty(2 * got.numel() + 8, dtype=torch.uint8)
    view = out[8:8 + got.numel()].view(got.shape)
    assert PF.dequant_idct_samples(zz, q, shape, out=view) is view
    np.testing.assert_array_equal(view.numpy(), got.numpy())


@pytest.mark.parametrize("shape,density,quality", B2_CASES)
def test_kernel_b2_body_on_host_standins(standin_idct8, shape, density,
                                         quality):
    rng = np.random.default_rng(shape[0] * 37 + shape[1])
    zz = _blocks(rng, shape, density)
    q = JQ.chroma_table(quality)
    got = b2_on_host(standin_idct8, zz, q, shape)
    # Kernel B's body on the old chain's plane, rounded and clamped.
    plane = PT.unblockify(PZ.from_zigzag(zz.reshape(*shape, 64))).contiguous()
    b = b_on_host(standin_idct8, plane, q)
    np.testing.assert_array_equal(
        got.numpy(), torch.clamp(torch.round(b), 0, 255).to(torch.uint8).numpy())
    np.testing.assert_array_equal(got.numpy(), chain_samples(zz, q, shape))
    twin = PF.dequant_idct_samples_reference(zz, q, shape)
    diff = (got.long() - twin.long()).abs()
    print(f"B2 body vs twin {shape}: {int((diff != 0).sum())} of "
          f"{diff.numel()} samples differ")
    assert int(diff.max()) <= 1
    assert int((diff != 0).sum()) <= DIFF_SHARE * diff.numel()


def test_kernel_b2_body_clamps_huge_coefficients(standin_idct8):
    """DC values past 2^22 (a corrupt stream's DC sums can run away) and
    full-scale AC under a table of 255s: samples far outside [0, 255], which
    B2's rounding must clip as the twin does."""
    rng = np.random.default_rng(5)
    zz = random_blocks(rng, 24, 0.5)
    zz[:, 0] = rng.choice([-1, 1], size=24) * rng.integers(
        1 << 22, 1 << 24, size=24)
    zz[:, 1:] *= 10
    zz = torch.as_tensor(zz)
    q = np.full((8, 8), 255)
    got = b2_on_host(standin_idct8, zz, q, (4, 6))
    np.testing.assert_array_equal(
        got.numpy(), PF.dequant_idct_samples_reference(zz, q, (4, 6)).numpy())
    assert set(np.unique(got.numpy())) <= {0, 255}


def test_samples_wrappers_refuse_bad_input():
    zz = torch.zeros((6, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="zig-zag blocks"):
        PF.dequant_idct_samples(zz, JQ.luma_table(50), (2, 2))
    with pytest.raises(ValueError, match="out must be"):
        PF.dequant_idct_samples(zz, JQ.luma_table(50), (2, 3),
                                out=torch.empty((16, 24), dtype=torch.int32))
    with pytest.raises(ValueError, match="unsupported device"):
        PF.dequant_idct_samples(zz.to("meta"), JQ.luma_table(50), (2, 3))


# ---------------------------------------------------------------------------
# Kernel H and its twin.
# ---------------------------------------------------------------------------


def _planes(rng, full, factors, n=None, extreme=False):
    """uint8 sample planes that upsample to `full` under `factors`; with
    `extreme`, mostly 0 and 255 so that the colour map clips."""
    out = []
    for fh, fv in factors:
        shape = (full[0] // fv, full[1] // fh)
        if n is not None:
            shape = (n, *shape)
        if extreme:
            p = rng.choice(np.array([0, 1, 127, 128, 254, 255], np.uint8),
                           size=shape)
        else:
            p = rng.integers(0, 256, size=shape).astype(np.uint8)
        out.append(torch.as_tensor(p))
    return out


# Every chroma ratio pair, both upsample choices, YCbCr and RGB, crops.
H_CASES = [
    (ratio, fan, is_rgb, full, crop)
    for ratio in RATIOS
    for fan in (True, False)
    for is_rgb in (False, True)
    for full, crop in (((24, 36), (19, 29)), ((12, 12), (7, 10)),
                       ((36, 288), (31, 284)))
]


@pytest.mark.parametrize("ratio,fan,is_rgb,full,crop", H_CASES)
def test_finish_twin_equals_old_chain_and_kernel_h_body(
        standin_finish, ratio, fan, is_rgb, full, crop):
    rng = np.random.default_rng(ratio[0] * 7 + ratio[1] + 3 * fan + is_rgb)
    factors = ((1, 1), ratio, ratio)
    fancy = (fan, fan, fan)
    for extreme in (False, True):
        planes = _planes(rng, full, factors, extreme=extreme)
        want = old_finish(planes, factors, fancy, is_rgb, *crop)
        got = PFI.finish_color(planes, factors, fancy, is_rgb, *crop)
        assert got.is_contiguous() and got.shape == (*crop, 3)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        host = h_on_host(standin_finish, planes, factors, fancy, is_rgb, *crop)
        np.testing.assert_array_equal(host.numpy(), want.numpy())


@pytest.mark.parametrize("factors,fancy", [
    (((1, 1), (2, 2), (2, 2)), (True, True, True)),
    (((1, 1), (2, 1), (2, 1)), (True, True, False)),
    (((1, 1), (1, 1), (1, 1)), (True, True, True)),
    (((2, 1), (1, 2), (1, 1)), (True, True, True)),
    (((1, 1), (4, 2), (2, 4)), (True, True, True)),
])
@pytest.mark.parametrize("n", [None, 3])
def test_kernel_h_body_at_1001x777_and_in_a_batch(standin_finish, factors,
                                                  fancy, n):
    """The padded grid of a 1001x777 frame (1008x784 for factors of up to
    2, 1024x800 for 4); with n = 3 the images are stacked and no vertical
    filter crosses from one into the next."""
    rng = np.random.default_rng(len(str(factors)) + (n or 0))
    full = (1024, 800) if any(4 in f for f in factors) else (1008, 784)
    planes = _planes(rng, full, factors, n=n)
    want = old_finish(planes, factors, fancy, False, 1001, 777)
    got = PFI.finish_color(planes, factors, fancy, False, 1001, 777)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    host = h_on_host(standin_finish, planes, factors, fancy, False, 1001, 777)
    np.testing.assert_array_equal(host.numpy(), want.numpy())
    if n is not None:
        for i in range(n):
            one = old_finish([p[i] for p in planes], factors, fancy, False,
                             1001, 777)
            np.testing.assert_array_equal(host[i].numpy(), one.numpy())


def test_axis_filters_follow_the_upsampler():
    """(ph, pv, rh, rv) against what upsample does to a plane's shape and to
    an impulse (the replicated axes copy, the doubled ones spread)."""
    assert PFI.axis_filters((1, 1), True) == (0, 0, 1, 1)
    assert PFI.axis_filters((2, 2), True) == (1, 1, 1, 1)
    assert PFI.axis_filters((4, 2), True) == (2, 1, 1, 1)
    assert PFI.axis_filters((2, 3), True) == (1, 0, 1, 3)
    assert PFI.axis_filters((3, 2), True) == (0, 0, 3, 2)
    assert PFI.axis_filters((4, 4), False) == (0, 0, 4, 4)


def test_finish_wrappers_refuse_bad_input():
    p = torch.zeros((8, 8), dtype=torch.uint8)
    fac = ((1, 1), (1, 1), (1, 1))
    with pytest.raises(ValueError, match="different sizes"):
        PFI.finish_color([p, p, p[:4]], fac, (True,) * 3, False, 8, 8)
    with pytest.raises(ValueError, match="uint8"):
        PFI.finish_color([p, p, p.float()], fac, (True,) * 3, False, 8, 8)
    with pytest.raises(ValueError, match="crop"):
        PFI.finish_color([p, p, p], fac, (True,) * 3, False, 9, 8)
    with pytest.raises(ValueError, match="unsupported device"):
        PFI.finish_color([p.to("meta")] * 3, fac, (True,) * 3, False, 8, 8)


# ---------------------------------------------------------------------------
# The decoder: the same pixels as the old chain, and jpeg_tpu's within the
# contract.
# ---------------------------------------------------------------------------


def old_decode(jpg):
    """decode(device="cpu") of a baseline colour or gray stream as the
    decoder ran it before kernels B2 and H: the decoder's own blocks, then
    the f32 chain, then the crop."""
    info = jfif.parse_jpeg(jpg)
    comps = info.components
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    mcu_rows = layout.ceil_div(info.height, 8 * vmax)
    mcu_cols = layout.ceil_div(info.width, 8 * hmax)
    zz = PDEC._device_blocks(info, mcu_rows, mcu_cols, "auto",
                             torch.device("cpu"))
    shapes = [(mcu_rows * c.v, mcu_cols * c.h) for c in comps]
    q = [torch.as_tensor(info.qtables[c.qtab_id], dtype=torch.float32)
         for c in comps]
    planes = [old_samples(z, t, s) for z, t, s in zip(zz, q, shapes)]
    if len(comps) == 1:
        return planes[0][:info.height, :info.width].to(torch.uint8).numpy()
    factors = [(hmax // c.h, vmax // c.v) for c in comps]
    fancy = PDEC.upsample_choices(info.width, comps, hmax, True)
    return old_finish(planes, factors, fancy, False, info.height,
                      info.width).numpy()


def _streams():
    out = {}
    for (h, w), mode in (((101, 77), "444"), ((90, 150), "422"),
                         ((131, 203), "420"), ((7, 10), "420")):
        out[f"{mode} {h}x{w}"] = jpeg_tpu_torch.encode(
            make_image(h, w, seed=h), 80, mode, device="cpu")
    out["gray 75x97"] = jpeg_tpu_torch.encode(make_image(75, 97)[..., 0], 80,
                                              device="cpu")
    return out


STREAMS = _streams()


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_decode_pixels_equal_the_old_chain(name):
    jpg = STREAMS[name]
    got = jpeg_tpu_torch.decode(jpg, device="cpu")
    np.testing.assert_array_equal(got, old_decode(jpg))


@pytest.mark.parametrize("name", sorted(port_fixtures.FIXTURES))
def test_fixture_streams_decode_as_before(name):
    """The committed streams: gray and colour ones (progressive and
    non-interleaved too) against the old chain; every one at its recorded
    shape; the colour ones also through output="ycbcr" + finish_ycbcr. The
    4-component finish (CMYK, YCCK) did not change."""
    data = port_fixtures.read(name)
    got = jpeg_tpu_torch.decode(data, device="cpu")
    assert got.shape == port_fixtures.FIXTURES[name][1]
    info = jfif.parse_jpeg(data)
    if len(info.components) in (1, 3):
        np.testing.assert_array_equal(got, old_decode(data))
    if len(info.components) == 3:
        np.testing.assert_array_equal(
            jpeg_tpu_torch.finish_ycbcr(
                jpeg_tpu_torch.decode(data, device="cpu", output="ycbcr")),
            got)


def _jax_inputs(jpg):
    info = jfif.parse_jpeg(jpg)
    comps = info.components
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    mcu_rows = layout.ceil_div(info.height, 8 * vmax)
    mcu_cols = layout.ceil_div(info.width, 8 * hmax)
    zz = PDEC._device_blocks(info, mcu_rows, mcu_cols, "auto",
                             torch.device("cpu"))
    shapes = tuple((mcu_rows * c.v, mcu_cols * c.h) for c in comps)
    factors = tuple((hmax // c.h, vmax // c.v) for c in comps)
    q = [np.asarray(info.qtables[c.qtab_id], dtype=np.float32) for c in comps]
    fancy = PDEC.upsample_choices(info.width, comps, hmax, True)
    return info, zz, q, shapes, factors, fancy


def _within_contract(got, want, worst):
    assert got.shape == want.shape
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    print(f"max |diff| {int(diff.max(initial=0))}, "
          f"{int((diff != 0).sum())} of {diff.size} differ")
    assert int(diff.max(initial=0)) <= worst
    assert int((diff != 0).sum()) <= DIFF_SHARE * diff.size


@pytest.mark.parametrize("name", [n for n in sorted(STREAMS)
                                  if not n.startswith("gray")])
def test_finish_matches_jpeg_tpu_with_pallas(name):
    info, zz, q, shapes, factors, fancy = _jax_inputs(STREAMS[name])
    qt = [torch.as_tensor(t) for t in q]
    got = PDEC._finish_color(*zz, *qt, shapes, factors, fancy)
    want = np.array(JDEC._finish_color(
        *(jnp.asarray(z.numpy()) for z in zz), *(jnp.asarray(t) for t in q),
        shapes, factors, fancy, use_pallas=True))
    _within_contract(got.numpy(), want, 3)
    got_p = PDEC._finish_planes(*zz, *qt, shapes)
    want_p = JDEC._finish_planes(*(jnp.asarray(z.numpy()) for z in zz),
                                 *(jnp.asarray(t) for t in q), shapes,
                                 use_pallas=True)
    for a, b in zip(got_p, want_p):
        _within_contract(a.numpy(), np.array(b), 1)
    flat = PDEC._finish_planes(*zz, *qt, shapes, flat=True)
    np.testing.assert_array_equal(
        flat.numpy(), np.concatenate([p.numpy().reshape(-1) for p in got_p]))


def test_gray_finish_matches_jpeg_tpu():
    info, zz, q, shapes, _, _ = _jax_inputs(STREAMS["gray 75x97"])
    got = PDEC._finish_gray(zz[0], torch.as_tensor(q[0]), shapes[0],
                            hlim=info.height, wlim=info.width)
    want = np.array(JDEC._finish_gray(jnp.asarray(zz[0].numpy()),
                                      jnp.asarray(q[0]), shapes[0]))
    _within_contract(got.numpy(), want[:info.height, :info.width], 1)


def test_batched_finish_is_per_image():
    """_finish_color over n = 3 images stacked in the blocks equals the
    images finished one by one, cropped."""
    info, zz, q, shapes, factors, fancy = _jax_inputs(STREAMS["420 131x203"])
    qt = [torch.as_tensor(t) for t in q]
    one = PDEC._finish_color(*zz, *qt, shapes, factors, fancy, hlim=131,
                             wlim=203)
    three = PDEC._finish_color(*(torch.cat([z] * 3) for z in zz), *qt, shapes,
                               factors, fancy, n_img=3, hlim=131, wlim=203)
    assert three.shape == (3, 131, 203, 3)
    for i in range(3):
        np.testing.assert_array_equal(three[i].numpy(), one.numpy())
