"""The decode finish of the port (models/decoder._finish_color,
_finish_gray, _finish_planes) and its two kernels' plain twins, on the CPU.

Kernel B2 (csrc/idct8.cu, jt_idct8_samples: every component's zig-zag
blocks in, in scan or raster order, uint8 samples out, one launch) and
kernel H (csrc/finish_color.cu: upsample, YCbCr -> RGB, round, clip, crop,
a tile per thread block) run only on a card; here their bodies are compiled
with g++ against stand-ins for the CUDA built-ins they use and run thread
by thread (B2: every thread's chunk placement into the shared tile, then
every thread's block body; H: every thread's share of the tile fill, then
every thread's patch and store) through the wrappers' launch functions.
Tolerances:
  - exact: the twins (ops/fused.dequant_idct_samples_reference,
    ops/finish.finish_color_reference) against the chain of torch ops the
    decoder ran before them (the f32 _reconstruct_plane, the upsamplers of
    ops/subsample, ops/color.ycbcr_to_rgb, round, clip, crop), over every
    ratio pair in {1, 2, 3, 4}^2, both upsample choices, is_rgb, crops and
    a batch of three images; kernel H's body against its twin on the same
    cases (integer samples make every step before the colour map exact,
    and the kernel keeps the map's f32 operations in their order); kernel
    B2's body against kernel B's body rounded and clamped, and against a
    numpy emulation of its FMA chains, in raster order and in the MCU scan
    order of the 4:2:0, 4:2:2, 4:4:4, gray and six general layouts, for a
    stack of images at a stride and into one flat buffer; B2's twin on scan
    order against the twin on the reordered blocks; decode(device="cpu")
    against the old chain composed here from the decoder's blocks;
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
from test_sampling_general import LAYOUTS
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
struct alignas(16) uint4 { unsigned x, y, z, w; };
static inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
static inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
static inline uint4 make_uint4(unsigned a, unsigned b, unsigned c,
                               unsigned d) {
  return {a, b, c, d};
}
static inline uint4 __ldg(const uint4* p) { return *p; }
static inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  const uint64_t v = ((uint64_t)y << 32) | x;
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i)
    r |= (uint32_t)((v >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i);
  return r;
}
static inline int4 __ldg(const int4* p) { return *p; }
static inline unsigned char __ldg(const unsigned char* p) { return *p; }
static inline uint32_t __ldg(const uint32_t* p) { return *p; }
static inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, int sh) {
  return (uint32_t)((((uint64_t)hi << 32) | lo) >> (sh & 31));
}
// cvt.pack.sat.u8.s32.b32 d, a, b, c (PTX ISA): d = (c << 16) |
// (sat_u8(a) << 8) | sat_u8(b).
static inline uint32_t pack_sat_u8(int a, int b, uint32_t c) {
  const uint32_t sa = a < 0 ? 0 : (a > 255 ? 255 : a);
  const uint32_t sb = b < 0 ? 0 : (b > 255 ? 255 : b);
  return (c << 16) | (sa << 8) | sb;
}
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
// Kernel B2: thread blocks in reverse order; in each, every thread's chunk
// placement into the tile (threads in reverse order), then every thread's
// block body (the kernel's one barrier lies between the two).
extern "C" int jt_idct8_samples(const void* const* zz, const void* const* q,
                                void* const* out, const int* geo, int ncomp,
                                void*) {
  ZArgs a;
  const long grid = make_zargs(zz, q, out, geo, ncomp, a);
  static int32_t s[64 * kPitch];
  for (long g = grid - 1; g >= 0; --g) {
    int i = 0;
    while (i + 1 < ncomp && g >= a.c[i + 1].first) ++i;
    const ZComp& c = a.c[i];
    const int t0 = (int)(g - c.first) * kThreads;
    const int nb = c.nblocks - t0 < kThreads ? c.nblocks - t0 : kThreads;
    for (int tid = kThreads - 1; tid >= 0; --tid) b2_fill(c, t0, nb, tid, s);
    for (int tid = nb - 1; tid >= 0; --tid) b2_body(c, t0, tid, s, c.q);
  }
  return 0;
}
// Kernel B: one loop iteration per CUDA thread (block), in reverse order.
extern "C" int jt_idct8(const void* coeffs, const void* qtab, void* out,
                        int h, int w, void*) {
  for (long t = (long)(h / 8) * (w / 8) - 1; t >= 0; --t)
    idct8_block((const int32_t*)coeffs, (const float*)qtab, (float*)out, t,
                w, w / 8);
  return 0;
}
"""

_STANDIN_FINISH = _STANDIN_HEAD + r"""
#include "finish_color.cu"
// Tiles in reverse order; in each, every thread's share of the fill
// (threads in reverse order), then every thread's patches and stores (the
// kernel's one barrier lies between the two).
extern "C" int jt_finish_color(const void* const* planes, const int* geo,
                               const float* m, void* out, int n, int hlim,
                               int wlim, int is_rgb, void*) {
  const Args a = make_args(planes, geo, m, out, hlim, wlim, is_rgb);
  const int layout = identity_entries(a) && !is_rgb ? kernel_layout(a) : -1;
  alignas(16) static uint32_t s[3 * kMaxRows * kPitch];
  for (int img = n - 1; img >= 0; --img)
    for (int R0 = (hlim - 1) / kTileRows * kTileRows; R0 >= 0;
         R0 -= kTileRows)
      for (int C0 = (wlim - 1) / kTileCols * kTileCols; C0 >= 0;
           C0 -= kTileCols) {
        Win w[3];
        tile_windows(a, R0, C0, w);
        for (int tid = kThreads - 1; tid >= 0; --tid)
          tile_fill(a, w, img, tid, s);
        for (int tid = kThreads - 1; tid >= 0; --tid) {
          switch (layout) {
            case 0: tile_thread<true, 0>(a, w, s, img, R0, C0, tid); break;
            case 1: tile_thread<true, 1>(a, w, s, img, R0, C0, tid); break;
            case 2: tile_thread<true, 2>(a, w, s, img, R0, C0, tid); break;
            case 3: tile_thread<true, 3>(a, w, s, img, R0, C0, tid); break;
            default: tile_thread<false, 0>(a, w, s, img, R0, C0, tid);
          }
        }
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
    """Kernel H's body as built (tiles of 16 output rows: 128 threads, two
    patches of 2 rows each), and with tiles of 4 (-DJT_THREADS=64
    -DJT_ROW_PAIRS=1)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    flags = ([f"-DJT_THREADS={16 * request.param}", "-DJT_ROW_PAIRS=1"]
             if request.param else [])
    return _build(tmp_path_factory.mktemp("finish_standin"), _STANDIN_FINISH,
                  flags)


def b2_planes_on_host(lib, zzs, qs, shapes, scan=None, n_img=1, outs=None):
    """Kernel B2's bodies through the wrapper's argument preparation and
    launch function: one launch for every component."""
    comps = PF._components(zzs, qs, shapes, scan, n_img, outs)
    outs = [torch.full((n_img * hb * 8, wb * 8), 7, dtype=torch.uint8)
            if o is None else o for _, _, (hb, wb), _, o in comps]
    comps = [c[:4] + (o,) for c, o in zip(comps, outs)]
    zs, qf, outs, geos = PF._prepare_planes(comps, n_img, torch.device("cpu"))
    before = PF.ZZ_LAUNCHES
    PF._launch_idct_samples(zs, qf, outs, geos, lib=lib)
    assert PF.ZZ_LAUNCHES == before + 1
    return outs


def b2_on_host(lib, zz, q, shape):
    """Kernel B2's body on one component in raster order."""
    return b2_planes_on_host(lib, [zz], [q], [shape])[0]


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


# Layouts of a colour (or gray) frame's components, (h, v) each: the
# decoder hands B2 the blocks of a component with several blocks to an MCU
# in the MCU scan order of the interleaved scan.
B2_LAYOUTS = [pytest.param([(2, 2), (1, 1), (1, 1)], id="420"),
              pytest.param([(1, 1), (1, 1), (1, 1)], id="444"),
              pytest.param([(1, 1)], id="gray")] + LAYOUTS


def _scan_components(rng, comps_hv, mcu_rows, mcu_cols, n_img=1):
    """Per component: zig-zag blocks of n_img images in the scan order the
    entropy decoder gives (n_img * blocks, 64), its table, block grid and
    scan geometry (None where one block makes an MCU)."""
    zzs, qs, shapes, scan = [], [], [], []
    for i, (h, v) in enumerate(comps_hv):
        shape = (mcu_rows * v, mcu_cols * h)
        zzs.append(_blocks(rng, (n_img * shape[0], shape[1]), 0.3))
        qs.append(JQ.luma_table(40 + 20 * i) if i == 0
                  else JQ.chroma_table(40 + 20 * i))
        shapes.append(shape)
        scan.append((mcu_rows, mcu_cols, v, h) if h * v > 1 else None)
    return zzs, qs, shapes, scan


def _in_raster_order(zz, geo, n_img=1):
    if geo is None:
        return zz
    mcu_rows, mcu_cols, v, h = geo
    return layout.scan_to_raster(zz, n_img * mcu_rows, mcu_cols, v, h)


@pytest.mark.parametrize("comps_hv", B2_LAYOUTS)
def test_kernel_b2_body_reads_scan_order(standin_idct8, comps_hv):
    """One launch for every component, each read in its MCU scan order in
    place: equal to the numpy emulation of B2's chains on the blocks put in
    raster order, and within +-1 of the twin; the twin on scan order equals
    the twin on the reordered blocks exactly."""
    rng = np.random.default_rng(sum(7 * h + v for h, v in comps_hv))
    zzs, qs, shapes, scan = _scan_components(rng, comps_hv, 3, 5)
    got = b2_planes_on_host(standin_idct8, zzs, qs, shapes, scan)
    twin = PF.dequant_idct_planes_reference(zzs, qs, shapes, scan)
    assert len(got) == len(twin) == len(comps_hv)
    for zz, q, shape, geo, g, t in zip(zzs, qs, shapes, scan, got, twin):
        raster = _in_raster_order(zz, geo)
        assert g.shape == (shape[0] * 8, shape[1] * 8)
        np.testing.assert_array_equal(g.numpy(),
                                      chain_samples(raster, q, shape))
        np.testing.assert_array_equal(
            t.numpy(), PF.dequant_idct_samples_reference(raster, q,
                                                         shape).numpy())
        diff = (g.long() - t.long()).abs()
        assert int(diff.max()) <= 1
        assert int((diff != 0).sum()) <= DIFF_SHARE * diff.numel()


@pytest.mark.parametrize("comps_hv", B2_LAYOUTS[:2])
def test_kernel_b2_body_on_a_stack_at_a_stride(standin_idct8, comps_hv):
    """decode_batched's rows: n = 3 images' (3, B, 64) blocks, each
    component a (3, blocks, 64) slice read in place at the stride B: the
    planes of the three images stacked, each equal to that image's own
    launch and to the twin's."""
    rng = np.random.default_rng(len(comps_hv) + 11)
    one = [_scan_components(rng, comps_hv, 2, 3) for _ in range(3)]
    _, qs, shapes, scan = one[0]
    rows = torch.stack([torch.cat(z[0]) for z in one])
    bounds = np.cumsum([0] + [hb * wb for hb, wb in shapes])
    views = [rows[:, lo:hi] for lo, hi in zip(bounds[:-1], bounds[1:])]
    comps = PF._components(views, qs, shapes, scan, 3, None)
    assert [g[3] for g in PF._prepare_planes(
        comps, 3, torch.device("cpu"))[3]] == [rows.shape[1]] * len(views)
    got = b2_planes_on_host(standin_idct8, views, qs, shapes, scan, n_img=3)
    twin = PF.dequant_idct_planes_reference(views, qs, shapes, scan, n_img=3)
    for c, (hb, wb) in enumerate(shapes):
        assert got[c].shape == (3 * hb * 8, wb * 8)
        diff = (got[c].long() - twin[c].long()).abs()
        assert int(diff.max()) <= 1
        for i in range(3):
            alone = b2_planes_on_host(standin_idct8, one[i][0], qs, shapes,
                                      scan)[c]
            np.testing.assert_array_equal(
                got[c][i * hb * 8:(i + 1) * hb * 8].numpy(), alone.numpy())


def test_kernel_b2_body_into_one_flat_buffer(standin_idct8):
    """output="ycbcr"'s flat buffer: the three planes written into their
    slices of one buffer by one launch, as into planes of their own."""
    rng = np.random.default_rng(29)
    zzs, qs, shapes, scan = _scan_components(rng, [(2, 2), (1, 1), (1, 1)],
                                             4, 3)
    sizes = [hb * 8 * wb * 8 for hb, wb in shapes]
    buf = torch.full((sum(sizes),), 7, dtype=torch.uint8)
    views = [piece.view(hb * 8, wb * 8)
             for (hb, wb), piece in zip(shapes, buf.split(sizes))]
    got = b2_planes_on_host(standin_idct8, zzs, qs, shapes, scan, outs=views)
    want = b2_planes_on_host(standin_idct8, zzs, qs, shapes, scan)
    for g, v, w in zip(got, views, want):
        assert g.data_ptr() == v.data_ptr()
        np.testing.assert_array_equal(v.numpy(), w.numpy())


def test_planes_wrappers_refuse_bad_input():
    zz = torch.zeros((24, 64), dtype=torch.int32)
    q = JQ.luma_table(50)
    with pytest.raises(ValueError, match="1-3 components"):
        PF.dequant_idct_planes([zz] * 4, [q] * 4, [(4, 6)] * 4)
    with pytest.raises(ValueError, match="1-3 components"):
        PF.dequant_idct_planes([zz], [q, q], [(4, 6)])
    with pytest.raises(ValueError, match="does not tile"):
        PF.dequant_idct_planes([zz], [q], [(4, 6)], scan=[(2, 2, 2, 2)])
    with pytest.raises(ValueError, match="zig-zag blocks"):
        PF.dequant_idct_planes([zz], [q], [(4, 6)], n_img=2)
    with pytest.raises(ValueError, match="out must be"):
        PF.dequant_idct_planes([zz], [q], [(4, 6)],
                               outs=[torch.empty((32, 40), dtype=torch.uint8)])
    with pytest.raises(ValueError, match="unsupported device"):
        PF.dequant_idct_planes([zz.to("meta")], [q], [(4, 6)])


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


# Every chroma ratio pair, both upsample choices, YCbCr and RGB, crops:
# widths that are not multiples of 4 (byte stores), multiples of 4 but not
# of 8 (word stores) and multiples of 8 (8-byte stores), across one, two
# and three tiles of 256 columns.
H_CASES = [
    (ratio, fan, is_rgb, full, crop)
    for ratio in RATIOS
    for fan in (True, False)
    for is_rgb in (False, True)
    for full, crop in (((24, 36), (19, 29)), ((12, 12), (7, 10)),
                       ((36, 288), (31, 284)))
] + [
    (ratio, fan, False, (24, 528), crop)
    for ratio in RATIOS
    for fan in (True, False)
    for crop in ((21, 520), (21, 512))
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


@pytest.mark.parametrize("name", ["420 131x203", "422 90x150"])
def test_kernel_b2_paths_make_no_reorder_copy(name):
    """decode, decode_batched and decode_stream read the MCU scan order in
    place (no layout.scan_to_raster call); use_pallas=False, the scaled
    decode and the mesh's raster blocks still reorder."""
    jpg = STREAMS[name]
    layout.SCAN_TO_RASTER_CALLS = 0
    one = jpeg_tpu_torch.decode(jpg, device="cpu")
    two = jpeg_tpu_torch.decode_batched([jpg, jpg], device="cpu")
    three = list(jpeg_tpu_torch.decode_stream(iter([jpg] * 3), depth=2,
                                              device="cpu"))
    assert layout.SCAN_TO_RASTER_CALLS == 0
    for px in (*two, *three):
        np.testing.assert_array_equal(px, one)
    jpeg_tpu_torch.decode(jpg, device="cpu", use_pallas=False)
    jpeg_tpu_torch.decode(jpg, device="cpu", scale_denom=2)
    assert layout.SCAN_TO_RASTER_CALLS == 2


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
