// Kernel H: the decode finish after the samples. Three uint8 sample planes
// -> chroma upsample (triangle or replication) -> YCbCr -> RGB -> round ->
// clip -> the cropped (n, hlim, wlim, 3) uint8 image, in one pass.
//
// Replaces the rest of the reference's jitted finish program,
// _jit_finish_color (jpeg_tpu/models/decoder.py:349-357, wrapping
// _finish_color at :94-119): everything after _reconstruct_plane's clip,
// which XLA fused around the Pallas IDCT (fused.py:121). Kernel B2
// (csrc/idct8.cu, jt_idct8_zz_u8) gives it its samples. The plain twin is
// ops/finish.finish_color_reference, the chain of torch ops the port ran
// before: finish.upsample per component (ops/subsample.py, with its
// fall-back for a ratio that is not a power of two: a horizontal factor of
// 3 replicates both axes from there on, a vertical one of 3 the rows), then
// finish.rgb_from_planes (ops/color.ycbcr_to_rgb's chain), then the crop.
//
// Exactness: the kernel equals that chain bit for bit.
// - The samples are integers in [0, 255]. One triangle doubling gives
//   (3 near + far) / 4, a multiple of 1/4; a ratio of 4 or a second axis
//   gives multiples of 1/16, and 4x4 of 1/256. Every intermediate of the
//   chain is a dyadic number of at most 16 significant bits, so each of its
//   f32 operations is exact and the result is S / 4^p for an integer S and
//   p doublings. Here S is summed in integers from the composed weights
//   (taps) and scaled once, by a power of two: the same f32 value.
// - The colour map is where the order matters: each channel is
//   ((t0 c0) + (t1 c1)) + (t2 c2) with t = (y, cb - 128, cr - 128) and c
//   the f32 row of color.YCBCR_TO_RGB (passed in, not retyped), each
//   product and sum rounded on its own (__fmul_rn / __fadd_rn, which nvcc
//   may not contract into FMAs), all three products kept even where c is 0
//   or 1. Then the rounding, half to even as torch.round (to_u8), the
//   clip, the store.
//
// Bound on the H100: memory. For the 4K 4:2:0 image it reads 8.3 MB of Y
// and 2 x 2.07 MB of chroma samples and writes 24.9 MB of RGB: 37.3 MB,
// 11.1 us at 3.35 TB/s. A pixel costs a few dozen integer operations and
// one to sixteen L1-resident byte loads per plane. The integer <-> float
// conversions go through the float's bits (exact_float, to_u8), not
// through the conversion unit, which runs at a fraction of the FP32 rate.
//
// Design: one thread owns kGroup = 8 neighbouring pixels of one output row
// (grid: x the groups of a row, y the rows, z the images: no division), so
// a warp writes 32 x 3 kGroup contiguous bytes, as 4-byte stores where the
// row width is a multiple of 4. Per plane a thread finds its one to four
// source rows once and reads one window of kGroup / 2^doublings + 2 samples
// from each (kGroup / replication where it replicates; a 4:2:0 chroma
// plane: 2 x 6 byte loads for 8 pixels),
// from which every pixel's taps sit at offsets known at compile time. The
// per-plane filter (doublings 0-2 per axis, the horizontal replication) is
// a template argument chosen by a switch that is uniform across the grid,
// so windows and taps stay in registers. The vertical filter never crosses
// an image of a batch: a row's taps are clamped inside its own image. Edge
// samples read the padding rows and columns of the block grid, as the
// chain does before its crop.
//
// JT_HOST_STANDIN: a host compiler that defines the CUDA built-ins this file
// uses (see tests/test_torch_finish.py) can compile group_bytes and
// store_group alone and run them thread by thread; the kernel and its
// launcher are left out then.

#include <cstdint>
#ifndef JT_HOST_STANDIN
#include <cuda_runtime.h>
#endif

#ifndef JT_THREADS
#define JT_THREADS 128
#endif
#ifndef JT_GROUP
#define JT_GROUP 8
#endif

namespace {

constexpr int kThreads = JT_THREADS;
constexpr int kGroup = JT_GROUP;  // pixels of one output row per thread
static_assert(kGroup % 4 == 0, "a group starts at a multiple of 4 columns");

struct Comp {
  const uint8_t* p;  // (n rows, cols) samples: n images stacked along rows
  int rows, cols;    // one image's padded plane
  int ph, pv;        // triangle doublings along columns / rows (0, 1, 2)
  int rh, rv;        // replication factor along columns / rows where 0
};

struct Args {
  Comp c[3];
  uint8_t* out;  // (n, hlim, wlim, 3)
  int hlim, wlim, is_rgb;
  float m[9];  // color.YCBCR_TO_RGB, row-major
};

template <int P>
constexpr int kTaps = P == 0 ? 1 : 2 * P;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// The float of an integer 0 <= s < 2^23, exactly, without the conversion
// unit: s in the low mantissa bits of 2^23, minus 2^23.
__device__ __forceinline__ float exact_float(int s) {
  return __int_as_float(0x4B000000 | s) - 8388608.0f;
}

// The far neighbour of doubled index m on an axis of n samples (edges
// replicated): the triangle's (3 x[m / 2] + x[far]) / 4.
__device__ __forceinline__ int far_of(int m, int n) {
  return clampi((m >> 1) + ((m & 1) ? 1 : -1), 0, n - 1);
}

// Output index o on an axis of n input samples -> the input indices and
// integer weights of P triangle doublings (weights summing to 4^P), or for
// P = 0 of replication by rep.
template <int P>
__device__ __forceinline__ void taps(int o, int n, int rep, int (&idx)[kTaps<P>],
                                     int (&wt)[kTaps<P>]) {
  if constexpr (P == 0) {
    idx[0] = rep == 1 ? o : (rep == 2 ? o >> 1 : (rep == 3 ? o / 3 : o >> 2));
    wt[0] = 1;
  } else if constexpr (P == 1) {
    idx[0] = o >> 1;
    wt[0] = 3;
    idx[1] = far_of(o, n);
    wt[1] = 1;
  } else {
    // 3 A(m) + A(m'), A being one doubling on the axis of 2n samples.
    const int m = o >> 1;
    const int m2 = clampi(m + ((o & 1) ? 1 : -1), 0, 2 * n - 1);
    idx[0] = m >> 1;
    wt[0] = 9;
    idx[1] = far_of(m, n);
    wt[1] = 3;
    idx[2] = m2 >> 1;
    wt[2] = 3;
    idx[3] = far_of(m2, n);
    wt[3] = 1;
  }
}

// The upsampled values of one plane at output row orow, columns col0 ..
// col0 + kGroup - 1, of the image whose samples start at c.p + off. The
// rows come from taps<PV>; along the row, the group reads one window of kW
// samples (indices clamped to the plane, which is the edge replication of
// every doubling) and takes each pixel's taps from it at offsets known at
// compile time: PH doublings (col0 is a multiple of 4), or replication by
// RH (for RH = 3 the window's phase col0 % 3 picks among three offsets).
// Columns past wlim are computed from clamped reads and never stored.
template <int PH, int PV, int RH>
__device__ __forceinline__ void sample_group(const Comp& c, long off, int orow,
                                             int col0, float (&v)[kGroup]) {
  constexpr int kW = PH == 0 ? kGroup : (kGroup >> PH) + 2;
  constexpr float kScale = 1.0f / static_cast<float>(1 << (2 * (PH + PV)));
  int iv[kTaps<PV>], wv[kTaps<PV>];
  taps<PV>(orow, c.rows, c.rv, iv, wv);
  const int lo = PH == 0 ? col0 / RH : (col0 >> PH) - 1;
  int x[kTaps<PV>][kW];
#pragma unroll
  for (int a = 0; a < kTaps<PV>; ++a) {
    const uint8_t* rp = c.p + off + static_cast<long>(iv[a]) * c.cols;
#pragma unroll
    for (int j = 0; j < kW; ++j)
      x[a][j] = __ldg(rp + clampi(lo + j, 0, c.cols - 1));
  }
  const int phase = RH == 3 ? col0 % 3 : 0;
#pragma unroll
  for (int k = 0; k < kGroup; ++k) {
    int s = 0;
#pragma unroll
    for (int a = 0; a < kTaps<PV>; ++a) {
      int h;
      if constexpr (PH == 0 && RH == 3) {
        h = phase == 0 ? x[a][k / 3]
                       : (phase == 1 ? x[a][(k + 1) / 3] : x[a][(k + 2) / 3]);
      } else if constexpr (PH == 0) {
        h = x[a][k / RH];
      } else if constexpr (PH == 1) {
        // o = col0 + k: near sample (col0 >> 1) + (k >> 1), window slot 1 + (k >> 1).
        const int near = 1 + (k >> 1);
        h = 3 * x[a][near] + x[a][near + ((k & 1) ? 1 : -1)];
      } else {
        // Two doublings: 3 A(m) + A(m'), m = (col0 >> 1) + j, m' = m -+ 1,
        // A(m) = 3 x[m >> 1] + x[(m >> 1) -+ 1]; window slot 1 is x[col0 >> 2].
        const int j = k >> 1;
        const int j2 = j + ((k & 1) ? 1 : -1);
        const int n1 = 1 + (j >> 1), n2 = 1 + (j2 >> 1);
        h = 3 * (3 * x[a][n1] + x[a][n1 + ((j & 1) ? 1 : -1)]) +
            (3 * x[a][n2] + x[a][n2 + ((j2 & 1) ? 1 : -1)]);
      }
      s += wv[a] * h;
    }
    v[k] = exact_float(s) * kScale;
  }
}

#define JT_PV_CASES(PH, RH)                                              \
  case (PH * 3 + 0) * 4 + RH - 1:                                        \
    sample_group<PH, 0, RH>(c, off, orow, col0, v); break;               \
  case (PH * 3 + 1) * 4 + RH - 1:                                        \
    sample_group<PH, 1, RH>(c, off, orow, col0, v); break;               \
  case (PH * 3 + 2) * 4 + RH - 1:                                        \
    sample_group<PH, 2, RH>(c, off, orow, col0, v); break;

__device__ __forceinline__ void sample_plane(const Comp& c, int img, int orow,
                                             int col0, float (&v)[kGroup]) {
  const long off = img * static_cast<long>(c.rows) * c.cols;
  switch ((c.ph * 3 + c.pv) * 4 + c.rh - 1) {
    JT_PV_CASES(0, 1)
    JT_PV_CASES(0, 2)
    JT_PV_CASES(0, 3)
    JT_PV_CASES(0, 4)
    JT_PV_CASES(1, 1)
    JT_PV_CASES(2, 1)
  }
}

#undef JT_PV_CASES

// clip(rint(x), 0, 255) for |x| < 2^22, without the conversion unit: adding
// 1.5 2^23 rounds x to an integer, half to even (the ulp there is 1), and
// leaves it in the low mantissa bits.
__device__ __forceinline__ uint32_t to_u8(float x) {
  const int r = __float_as_int(x + 12582912.0f) - 0x4B400000;
  return static_cast<uint32_t>(r < 0 ? 0 : (r > 255 ? 255 : r));
}

constexpr int kWords = 3 * kGroup / 4;  // a group's bytes as 4-byte words

// The 3 kGroup bytes of image img's output row orow from column col0, each
// in the low byte of b[i].
__device__ __forceinline__ void group_bytes(const Args& a, int img, int orow,
                                            int col0,
                                            uint32_t (&b)[3 * kGroup]) {
  float v[3][kGroup];
#pragma unroll
  for (int c = 0; c < 3; ++c) sample_plane(a.c[c], img, orow, col0, v[c]);

#pragma unroll
  for (int k = 0; k < kGroup; ++k) {
    if (a.is_rgb) {
#pragma unroll
      for (int c = 0; c < 3; ++c) b[3 * k + c] = to_u8(v[c][k]);
    } else {
      const float t0 = v[0][k];
      const float t1 = v[1][k] - 128.0f;
      const float t2 = v[2][k] - 128.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float acc = __fadd_rn(__fmul_rn(t0, a.m[3 * c]),
                                    __fmul_rn(t1, a.m[3 * c + 1]));
        b[3 * k + c] = to_u8(__fadd_rn(acc, __fmul_rn(t2, a.m[3 * c + 2])));
      }
    }
  }
}

__device__ __forceinline__ uint8_t* row_out(const Args& a, int img, int orow,
                                            int col0) {
  const long row = static_cast<long>(img) * a.hlim + orow;
  return a.out + (row * a.wlim + col0) * 3;
}

// The group's bytes: whole words where the row width is a multiple of 4
// (every group then starts at a 4-byte boundary), else byte by byte.
// Neighbouring threads store neighbouring 3 kGroup-byte runs.
__device__ __forceinline__ void store_group(const Args& a, int img, int orow,
                                            int col0,
                                            const uint32_t (&b)[3 * kGroup]) {
  uint8_t* dst = row_out(a, img, orow, col0);
  const int ncols = a.wlim - col0 < kGroup ? a.wlim - col0 : kGroup;
  if (ncols == kGroup && a.wlim % 4 == 0) {
    uint32_t* d = reinterpret_cast<uint32_t*>(dst);
#pragma unroll
    for (int i = 0; i < kWords; ++i)
      d[i] = b[4 * i] | b[4 * i + 1] << 8 | b[4 * i + 2] << 16 | b[4 * i + 3] << 24;
  } else {
#pragma unroll
    for (int i = 0; i < 3 * kGroup; ++i)
      if (i < 3 * ncols) dst[i] = static_cast<uint8_t>(b[i]);
  }
}

#ifndef JT_HOST_STANDIN

// x: groups of a row; y: output rows; z: images.
__global__ void __launch_bounds__(kThreads)
finish_color_kernel(const Args a) {
  const int col0 = (blockIdx.x * kThreads + threadIdx.x) * kGroup;
  if (col0 >= a.wlim) return;
  uint32_t b[3 * kGroup];
  group_bytes(a, blockIdx.z, blockIdx.y, col0, b);
  store_group(a, blockIdx.z, blockIdx.y, col0, b);
}

#endif  // JT_HOST_STANDIN

// Args from the C entry's plain arrays: planes[3], geo[3][6] = (rows, cols,
// ph, pv, rh, rv) per plane, m[9].
Args make_args(const void* const* planes, const int* geo, const float* m,
               void* out, int hlim, int wlim, int is_rgb) {
  Args a;
  for (int c = 0; c < 3; ++c) {
    const int* g = geo + 6 * c;
    a.c[c] = Comp{static_cast<const uint8_t*>(planes[c]), g[0], g[1], g[2],
                  g[3], g[4], g[5]};
  }
  for (int i = 0; i < 9; ++i) a.m[i] = m[i];
  a.out = static_cast<uint8_t*>(out);
  a.hlim = hlim;
  a.wlim = wlim;
  a.is_rgb = is_rgb;
  return a;
}

int row_groups(int wlim) { return (wlim + kGroup - 1) / kGroup; }

}  // namespace

#ifndef JT_HOST_STANDIN

extern "C" int jt_finish_color(const void* const* planes, const int* geo,
                               const float* m, void* out, int n, int hlim,
                               int wlim, int is_rgb, void* stream) {
  if (n <= 0 || hlim <= 0 || wlim <= 0) return 0;
  if (hlim > 65535 || n > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((row_groups(wlim) + kThreads - 1) / kThreads, hlim, n);
  finish_color_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      make_args(planes, geo, m, out, hlim, wlim, is_rgb));
  return static_cast<int>(cudaGetLastError());
}

#endif  // JT_HOST_STANDIN
