"""The port's fused level shift + DCT + quantize (plain twin of kernel C)
and the ops it is built from, against the JAX package.

fused_dct_quantize_reference is held to jpeg_tpu.ops.fused.fused_dct_quantize
(interpret=True, the Pallas kernel run on the CPU) with the bound of
tests/test_fused.py: |diff| <= 1 everywhere and a nonzero diff in at most
max(8, 5e-4 * n) coefficients, since the f32 summation orders differ and can
flip a .5 boundary. The count is printed. The small ops (round_half_away,
quantize_plane, rgb_to_ycbcr_planes, downsample_plane, blockify, to_zigzag)
are held to their JAX twins exactly: tolerance 0. Kernel C itself against
this twin is in test_torch_cuda.py; here its block body (csrc/dct8.cu,
dct8_block) is compiled with g++ against stand-ins for the CUDA built-ins it
uses and held exactly (tolerance 0) to a numpy emulation of its FMA chains,
and to the twin within the bound above. The basis constants written into
csrc/dct8.cu and csrc/idct8.cu must equal dct_basis() bit for bit."""

import ctypes
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jpeg_tpu.config import Subsampling as JS
from jpeg_tpu.ops import color as JC, fused as JF, quant as JQ
from jpeg_tpu.ops import subsample as JSub, tile as JT, zigzag as JZ

from jpeg_tpu_torch.config import Subsampling as PS
from jpeg_tpu_torch.ops import color as PC, fused as PF, quant as PQ
from jpeg_tpu_torch.ops import subsample as PSub, tile as PT, zigzag as PZ

from jpeg_tpu_torch.ops.dct import dct_basis

from torch_port_util import make_image

CSRC = pathlib.Path(PF.__file__).resolve().parent.parent / "csrc"


def assert_coef_close(got, expect):
    """The bound of tests/test_fused.py."""
    diff = got.astype(np.int64) - expect.astype(np.int64)
    ndiff = int((diff != 0).sum())
    print(f"coefficients differing: {ndiff} of {diff.size}")
    assert np.abs(diff).max(initial=0) <= 1
    assert ndiff <= max(8, 5e-4 * diff.size), ndiff


@pytest.mark.parametrize("shape", [(64, 128), (8, 64), (48, 40), (128, 384)])
@pytest.mark.parametrize("quality", [10, 75, 95])
def test_fused_dct_quantize_matches_pallas(shape, quality):
    rng = np.random.default_rng(shape[0] * 1000 + shape[1] + quality)
    plane = rng.integers(0, 256, size=shape).astype(np.float32)
    qt = JQ.luma_table(quality)
    expect = np.asarray(JF.fused_dct_quantize(
        jnp.asarray(plane), jnp.asarray(qt), interpret=True))
    got = PF.fused_dct_quantize(torch.as_tensor(plane), qt)
    assert got.dtype == torch.int32 and got.shape == shape
    assert_coef_close(got.numpy(), expect)


def test_fused_dct_quantize_refuses_unaligned_planes():
    with pytest.raises(ValueError, match="multiples of 8"):
        PF.fused_dct_quantize(torch.zeros((12, 16)), JQ.luma_table(50))


def test_round_half_away_and_quantize_plane_equal():
    rng = np.random.default_rng(4)
    x = np.concatenate([np.arange(-40, 41) / 4.0,
                        rng.normal(0, 300, 2000)]).astype(np.float32)
    np.testing.assert_array_equal(
        PQ.round_half_away(torch.as_tensor(x)).numpy(),
        np.asarray(JQ.round_half_away(jnp.asarray(x))))
    coef = rng.normal(0, 200, (24, 40)).astype(np.float32)
    qt = JQ.chroma_table(60)
    got = PQ.quantize_plane(torch.as_tensor(coef), qt)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JQ.quantize_plane(jnp.asarray(coef),
                                                  jnp.asarray(qt))))


@pytest.mark.parametrize("mode", ["444", "422", "420"])
def test_colour_planes_and_downsample_equal(mode):
    img = make_image(32, 48, seed=len(mode) + 9)
    got = PC.rgb_to_ycbcr_planes(torch.as_tensor(img))
    ref = JC.rgb_to_ycbcr_planes(jnp.asarray(img))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    cb = got[1] - 128.0
    np.testing.assert_array_equal(
        PSub.downsample_plane(cb, PS(mode)).numpy(),
        np.asarray(JSub.downsample_plane(jnp.asarray(cb.numpy()), JS(mode))))


def test_blockify_and_to_zigzag_equal():
    x = np.arange(24 * 40, dtype=np.int32).reshape(24, 40)
    got = PZ.to_zigzag(PT.blockify(torch.as_tensor(x)))
    ref = JZ.to_zigzag(JT.blockify(jnp.asarray(x)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _basis_from_source(path):
    """dct8.cu / idct8.cu's `basis(u, x)` rebuilt from the kC1..kC7 literals
    in the source, each rounded to f32 as the compiler rounds it."""
    c = {int(k): np.float32(float(v)) for k, v in re.findall(
        r"constexpr float kC(\d) = ([0-9.]+)f;", path.read_text())}
    assert sorted(c) == list(range(1, 8))
    out = np.zeros((8, 8), dtype=np.float32)
    for u in range(8):
        for x in range(8):
            if u == 0:
                out[u, x] = c[4]
                continue
            k = ((2 * x + 1) * u) % 32
            if k > 16:
                k = 32 - k
            neg = k > 8
            if neg:
                k = 16 - k
            v = c[k] if k else np.float32(0)
            out[u, x] = -v if neg else v
    return out


@pytest.mark.parametrize("name", ["dct8.cu", "idct8.cu"])
def test_kernel_basis_immediates_equal_dct_basis(name):
    got = _basis_from_source(CSRC / name)
    assert got.tobytes() == dct_basis().tobytes()


def _fma(a, b, acc):
    """f32 fused multiply-add through f64: the product of two f32 is exact
    there, so one rounding to f64 and one to f32 remain."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + acc.astype(np.float64)).astype(np.float32)


def _chain_dct_quantize(plane, qt):
    """Kernel C's arithmetic in numpy: -128, the vertical chain over y = 0..7
    from zero, the horizontal chain over x = 0..7 from zero, IEEE division,
    round half away from zero."""
    h, w = plane.shape
    d = dct_basis()
    x = (plane.astype(np.float32) - np.float32(128)).reshape(h // 8, 8, w // 8, 8)
    t = np.zeros((h // 8, 8, w // 8, 8), dtype=np.float32)      # a u b x
    for y in range(8):
        t = _fma(d[None, :, None, None, y], x[:, None, y, :, :], t)
    c = np.zeros_like(t)                                        # a u b v
    for k in range(8):
        c = _fma(t[..., k, None], d[None, None, None, :, k], c)
    q = np.asarray(qt, dtype=np.float32).reshape(1, 8, 1, 8)
    s = c / q
    r = np.copysign(np.floor(np.abs(s) + np.float32(0.5)), s)
    return r.astype(np.int32).reshape(h, w)


_STANDIN = """
#define JT_HOST_STANDIN
#include <cmath>
#include <cstdint>
#define __device__
#define __forceinline__ inline
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) int4 { int x, y, z, w; };
static inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
static inline float4 __ldg(const float4* p) { return *p; }
static inline float __fdiv_rn(float a, float b) { return a / b; }
#include "dct8.cu"
extern "C" void standin_dct8(const float* plane, const float* q, int32_t* out,
                             int h, int w) {
  for (long br = 0; br < h / 8; ++br)
    for (long bc = 0; bc < w / 8; ++bc)
      dct8_block(plane, q, out, br * 8 * w + bc * 8, w);
}
"""


@pytest.fixture(scope="module")
def standin_dct8(tmp_path_factory):
    """Kernel C's block body compiled for the host, one call per plane."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    d = tmp_path_factory.mktemp("dct8_standin")
    (d / "standin.cc").write_text(_STANDIN)
    lib = d / "libstandin.so"
    subprocess.run(
        ["g++", "-O1", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
         f"-I{CSRC}", "-o", str(lib), str(d / "standin.cc")],
        check=True, capture_output=True, text=True, timeout=300)
    fn = ctypes.CDLL(str(lib)).standin_dct8

    def run(plane, qt):
        h, w = plane.shape
        # 16-byte aligned buffers, as the wrapper demands of the card's.
        x = torch.as_tensor(np.ascontiguousarray(plane, dtype=np.float32))
        q = torch.as_tensor(np.asarray(qt, dtype=np.float32).reshape(64).copy())
        out = torch.empty((h, w), dtype=torch.int32)
        assert x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
        fn(ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(q.data_ptr()),
           ctypes.c_void_p(out.data_ptr()), ctypes.c_int(h), ctypes.c_int(w))
        return out.numpy()

    return run


@pytest.mark.parametrize("shape", [(8, 8), (16, 40), (48, 264), (64, 128)])
@pytest.mark.parametrize("quality", [10, 75, 95])
def test_kernel_c_body_on_host_standins(standin_dct8, shape, quality):
    rng = np.random.default_rng(shape[1] * 100 + quality)
    plane = rng.integers(0, 256, size=shape).astype(np.float32)
    if shape == (16, 40):  # fractional samples, as the chroma mean gives
        plane = plane + rng.integers(0, 4, size=shape).astype(np.float32) / 4
    qt = JQ.chroma_table(quality) if shape[0] == 16 else JQ.luma_table(quality)
    got = standin_dct8(plane, qt)
    np.testing.assert_array_equal(got, _chain_dct_quantize(plane, qt))
    assert_coef_close(
        got, PF.fused_dct_quantize_reference(torch.as_tensor(plane), qt).numpy())
