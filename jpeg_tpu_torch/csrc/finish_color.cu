// Kernel H: the decode finish after the samples. Three uint8 sample planes
// -> chroma upsample (triangle or replication) -> YCbCr -> RGB -> round ->
// clip -> the cropped (n, hlim, wlim, 3) uint8 image, in one pass.
//
// Replaces the rest of the reference's jitted finish program,
// _jit_finish_color (jpeg_tpu/models/decoder.py:349-357, wrapping
// _finish_color at :94-119): everything after _reconstruct_plane's clip,
// which XLA fused around the Pallas IDCT (fused.py:121). Kernel B2
// (csrc/idct8.cu, jt_idct8_samples) gives it its samples. The plain twin is
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
//   p doublings. Here S is summed from the composed integer weights in f32
//   (every partial sum an integer below 2^24, so exact) and scaled once, by
//   a power of two, with the -128 of a chroma plane in the same FMA (exact:
//   its result is representable): the same f32 value.
// - The colour map is where the order matters: each channel is
//   ((t0 c0) + (t1 c1)) + (t2 c2) with t = (y, cb - 128, cr - 128) and c
//   the f32 row of color.YCBCR_TO_RGB (passed in, not retyped), each
//   product and sum rounded on its own (__fmul_rn / __fadd_rn, which nvcc
//   may not contract into FMAs). Where the matrix has YCBCR_TO_RGB's exact
//   1.0 and 0.0 entries (the C entry compares the values) the kIdentity
//   form drops those products: t 1 = t, and x + (+-0) = x because x is a
//   sum with t0 >= 0, never -0. That is 8 of the map's 15 operations.
//   Then the rounding, half to even as torch.round (round_int), and the
//   clip, which cvt.pack.sat does while it packs two bytes.
//
// Bound on the H100: memory. For the 4K 4:2:0 image it reads 8.3 MB of Y
// and 2 x 2.07 MB of chroma samples and writes 24.9 MB of RGB: 37.3 MB,
// 11.1 us at 3.35 TB/s. A thread per 8 pixels of a row with a clamped byte
// load per tap is bound by instruction issue instead (~117 instructions a
// pixel, 0.35 of the bound: PERF.md section 6), so this design cuts what a
// pixel costs:
// - A tile per thread block: kTileRows = 16 output rows x kTileCols = 256
//   columns of one image (grid: x column tiles, y row tiles, z images).
//   Its threads first copy each plane's source rows and columns that the
//   tile reads, with the one-sample halo of the triangle, into shared
//   memory in 16-byte chunks, every load in flight before the first store
//   (tile_fill): the edge replication and the batch's per-image vertical
//   clamp happen there, once per chunk. TMA does not serve: a row pitch
//   must be a multiple of 16 bytes, and a 1001x777 chroma plane is 504
//   columns wide.
// - A thread makes kRowPairs = 2 patches of kRows = 2 output rows x kGroup
//   = 8 columns (tile_thread, tile_patch): per plane it reads one window of
//   a few words from each source row it needs, turns its bytes into floats
//   by byte permutes, sums each source column's vertical taps once for both
//   rows, and takes the horizontal taps from those sums in registers, at
//   offsets known at compile time. No branch and no clamp per sample. The
//   taps run in f32 because the card's INT32 pipe issues a warp instruction
//   in two clocks and the FP32 pipe in one.
// - Stores: 8-byte stores of a thread's 24-byte run of a row where the
//   width allows, else words, else bytes (tile_store); staging a tile's
//   rows for 16-byte stores timed the same.
// Each plane's filter (doublings 0-2 per axis, replication) is a template
// case: fixed at compile time in the kernel's forms for the 4:2:0, 4:2:2
// and 4:4:4 layouts of fancy upsampling (a form holds one filter's code
// per plane), else picked by a switch that is uniform across the grid.
// Measured (NVIDIA H100 80GB HBM3, 700 W; kernel_compare.py --finish-only,
// kernel only, L2 cold, in turns): 22.4 us for the 4K 4:2:0 image (0.50 of
// the bound) against 31.7 us for a thread per 8 pixels of a row.
//
// JT_HOST_STANDIN: a host compiler that defines the CUDA built-ins this file
// uses (see tests/test_torch_finish.py) can compile tile_windows, tile_fill
// and tile_thread (tile_patch, tile_store) alone and run them thread by
// thread; the kernel and its launcher are left out then.

#include <cstdint>
#ifndef JT_HOST_STANDIN
#include <cuda_runtime.h>
#endif

#ifndef JT_THREADS
#define JT_THREADS 128
#endif

namespace {

constexpr int kThreads = JT_THREADS;
constexpr int kGroup = 8;     // output columns of a thread's patch
constexpr int kRows = 2;      // output rows of a thread's patch
#ifndef JT_ROW_PAIRS
#define JT_ROW_PAIRS 2
#endif
// Patches per thread, one below the other: the fill's and the windows' cost
// is shared by more pixels, at the price of a larger tile.
constexpr int kRowPairs = JT_ROW_PAIRS;
constexpr int kLanes = 32;    // threads across a tile: a warp spans its width
constexpr int kTileCols = kGroup * kLanes;
constexpr int kTileRows = kRows * kRowPairs * (kThreads / kLanes);
static_assert(kThreads % kLanes == 0, "whole warps");
// Source rows and 16-byte chunks per row of a plane's window in shared
// memory: at most kTileRows rows (kTileRows / 2 + 3 with one doubling), and
// kTileCols / 16 + 1 chunks (a window starts at the 16-byte boundary at or
// below its first column); kPitch is the row pitch in words.
constexpr int kMaxRows = kTileRows + 2;
constexpr int kChunks = kTileCols / 16 + 1;
constexpr int kPitch = 4 * kChunks;
constexpr int kWords = 3 * kGroup / 4;  // a thread's row of RGB as words

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

// The source rows [r0, r0 + nrows) and columns [a0, a0 + 16 nch) of one
// plane that a tile reads (a0 a multiple of 16); filled clamped to the
// plane's edges.
struct Win {
  int r0, nrows, a0, nch;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// o / rep for o >= 0 and a replication factor of 1 to 4, without the
// division sequence of a divisor known only at run time.
__device__ __forceinline__ int div_rep(int o, int rep) {
  return rep == 3 ? o / 3 : o >> (rep >> 1);
}

// Source indices [lo, hi] that outputs o0 .. o0 + n - 1 of one axis read:
// p triangle doublings (the one-sample halo on both sides covers the far
// taps of every doubling), or replication by rep.
__device__ __forceinline__ void axis_span(int o0, int n, int p, int rep,
                                          int& lo, int& hi) {
  if (p > 0) {
    lo = (o0 >> p) - 1;
    hi = ((o0 + n - 1) >> p) + 1;
  } else {
    lo = div_rep(o0, rep);
    hi = div_rep(o0 + n - 1, rep);
  }
}

// Each plane's window for the tile whose first output row and column are
// R0 and C0 (the same in every thread).
__device__ __forceinline__ void tile_windows(const Args& a, int R0, int C0,
                                             Win (&w)[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    int lo, hi;
    axis_span(R0, kTileRows, a.c[c].pv, a.c[c].rv, lo, hi);
    w[c].r0 = lo;
    w[c].nrows = hi - lo + 1;
    axis_span(C0, kTileCols, a.c[c].ph, a.c[c].rh, lo, hi);
    // The columns up to hi + 1 (a window of a ratio of 3 may reach it).
    w[c].a0 = lo & ~15;
    w[c].nch = (hi + 1 - w[c].a0) / 16 + 1;
  }
}

// Tile fill, thread tid's share: of each plane's window the chunks e =
// tid, tid + kThreads, ... (row e / kChunks, chunk e % kChunks: source
// columns a0 + 16 ch .. + 15 of source row r0 + i, every index clamped to
// the image's plane) into s[plane]. All of a thread's loads, for the three
// planes, are issued before the first store, so they are in flight
// together. Where the plane's rows are 16-byte aligned and the chunk lies
// inside its row, a chunk is one 16-byte load; at the image's left and
// right edges, or in a plane whose width is no multiple of 16, sixteen
// clamped byte loads.
constexpr int kFillIters = (kMaxRows * kChunks + kThreads - 1) / kThreads;

__device__ __forceinline__ uint4 fill_chunk(const Comp& c, const Win& w,
                                            const uint8_t* img, int e) {
  const int i = e / kChunks, ch = e - i * kChunks;
  uint4 v = make_uint4(0, 0, 0, 0);
  if (e < w.nrows * kChunks && ch < w.nch) {
    const uint8_t* rp =
        img + static_cast<long>(clampi(w.r0 + i, 0, c.rows - 1)) * c.cols;
    const int col = w.a0 + 16 * ch;
    if (((reinterpret_cast<uintptr_t>(c.p) | static_cast<uintptr_t>(c.cols)) &
         15) == 0 &&
        col >= 0 && col + 16 <= c.cols) {
      v = __ldg(reinterpret_cast<const uint4*>(rp + col));
    } else {
      uint32_t b[16];
#pragma unroll
      for (int j = 0; j < 16; ++j)
        b[j] = __ldg(rp + clampi(col + j, 0, c.cols - 1));
      v.x = b[0] | b[1] << 8 | b[2] << 16 | b[3] << 24;
      v.y = b[4] | b[5] << 8 | b[6] << 16 | b[7] << 24;
      v.z = b[8] | b[9] << 8 | b[10] << 16 | b[11] << 24;
      v.w = b[12] | b[13] << 8 | b[14] << 16 | b[15] << 24;
    }
  }
  return v;
}

__device__ __forceinline__ void tile_fill(const Args& a, const Win (&w)[3],
                                          int img, int tid, uint32_t* s) {
  uint4 v[3][kFillIters];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const uint8_t* base =
        a.c[c].p + static_cast<long>(img) * a.c[c].rows * a.c[c].cols;
#pragma unroll
    for (int k = 0; k < kFillIters; ++k)
      v[c][k] = fill_chunk(a.c[c], w[c], base, tid + k * kThreads);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int k = 0; k < kFillIters; ++k) {
      const int e = tid + k * kThreads;
      if (e < w[c].nrows * kChunks)
        reinterpret_cast<uint4*>(s + c * kMaxRows * kPitch)[e] = v[c][k];
    }
}

// kW bytes of a window row from byte offset off, as floats. kSh >= 0:
// off % 4 == kSh is known at compile time, so every byte's word and place
// are; kSh < 0: a funnel shift aligns the words first. A byte b becomes the
// float 2^23 + b by one byte permute (its bits are 0x4B0000bb), then b by
// one subtraction: exact, and off the integer pipe, which on this card
// runs at half the rate of the FP32 one.
template <int kW, int kSh>
__device__ __forceinline__ void read_window(const uint32_t* row, int off,
                                            float (&x)[kW]) {
  constexpr int kLead = kSh < 0 ? 0 : kSh;
  constexpr int kN = (kLead + kW + 3) / 4 + (kSh < 0 ? 1 : 0);
  uint32_t v[kN];
  const uint32_t* p = row + (off >> 2);
#pragma unroll
  for (int i = 0; i < kN; ++i) v[i] = p[i];
  if constexpr (kSh < 0) {
    const int sh = 8 * (off & 3);
#pragma unroll
    for (int i = 0; i + 1 < kN; ++i) v[i] = __funnelshift_r(v[i], v[i + 1], sh);
  }
#pragma unroll
  for (int j = 0; j < kW; ++j)
    x[j] = __int_as_float(__byte_perm(v[(kLead + j) >> 2], 0x4B000000u,
                                      0x7540 | ((kLead + j) & 3))) -
           8388608.0f;
}

// One plane's values at the thread's output rows or0, or0 + 1 (or0 even)
// and columns oc0 .. oc0 + 7 (oc0 a multiple of 8), from the plane's window
// s: the upsampled sample S / 4^(PH + PV) - bias, where S, the sum of the
// integer taps, is formed in f32 (every partial sum is an integer below
// 2^24, so exact) and scaled and shifted by one FMA (exact: the result is
// representable). Vertically: PV = 0 reads source row (or0 + r) / rv for
// row r; PV = 1 the rows m - 1, m, m + 1 (m = or0 / 2) with weights (1, 3,
// 0) and (0, 3, 1); PV = 2 the rows q - 1, q, q + 1 (q = or0 / 4) with the
// weights of two composed doublings, which depend on the parity of or0 /
// 2. Those sums, per source column, serve both rows. Horizontally, from the
// sums: PH doublings (the window's slot 1 is column oc0 >> PH), or
// replication by RH (for RH = 3 the window's phase oc0 % 3 picks among
// three offsets).
template <int PH, int PV, int RH>
__device__ __forceinline__ void plane_values(const Comp& c, const Win& w,
                                             const uint32_t* s, int or0,
                                             int oc0, float bias,
                                             float (&t)[kRows][kGroup]) {
  constexpr int kW = PH == 0 ? (kGroup - 1 + (RH == 3 ? 2 : 0)) / RH + 1
                             : (kGroup >> PH) + 2;
  // The window's offset from a0 modulo 4, where the tile's geometry fixes it
  // (oc0 = C0 + 8 lane, a0 = the 16-byte boundary at or below the plane's
  // first column): 0 without doubling, 3 with one (4 lane + 15).
  constexpr int kSh = (PH == 0 && RH <= 2) ? 0 : (PH == 1 ? 3 : -1);
  constexpr float kScale = 1.0f / static_cast<float>(1 << (2 * (PH + PV)));
  const int wlo = PH == 0 ? oc0 / RH : (oc0 >> PH) - 1;
  const int off = wlo - w.a0;
  float V[kRows][kW];
  if constexpr (PV == 0) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = div_rep(or0 + r, c.rv) - w.r0;
      read_window<kW, kSh>(s + row * kPitch, off, V[r]);
    }
  } else {
    const int first = (or0 >> PV) - 1 - w.r0;  // window row of source m - 1
    float x0[kW], x1[kW], x2[kW];
    read_window<kW, kSh>(s + first * kPitch, off, x0);
    read_window<kW, kSh>(s + (first + 1) * kPitch, off, x1);
    read_window<kW, kSh>(s + (first + 2) * kPitch, off, x2);
    if constexpr (PV == 1) {
#pragma unroll
      for (int j = 0; j < kW; ++j) {
        V[0][j] = fmaf(3.0f, x1[j], x0[j]);
        V[1][j] = fmaf(3.0f, x1[j], x2[j]);
      }
    } else {
      // Rows 4q .. 4q + 3 weigh q - 1, q, q + 1 by (6, 10, 0), (3, 12, 1),
      // (1, 12, 3), (0, 10, 6) sixteenths: taps<2> of the twin composed.
      const bool odd = (or0 >> 1) & 1;
      const float a0 = odd ? 1.0f : 6.0f, a1 = odd ? 12.0f : 10.0f,
                  a2 = odd ? 3.0f : 0.0f;
      const float b0 = odd ? 0.0f : 3.0f, b1 = odd ? 10.0f : 12.0f,
                  b2 = odd ? 6.0f : 1.0f;
#pragma unroll
      for (int j = 0; j < kW; ++j) {
        V[0][j] = fmaf(a2, x2[j], fmaf(a1, x1[j], a0 * x0[j]));
        V[1][j] = fmaf(b2, x2[j], fmaf(b1, x1[j], b0 * x0[j]));
      }
    }
  }
  const int phase = RH == 3 ? oc0 % 3 : 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      float h;
      if constexpr (PH == 0 && RH == 3) {
        h = phase == 0 ? V[r][k / 3]
                       : (phase == 1 ? V[r][(k + 1) / 3] : V[r][(k + 2) / 3]);
      } else if constexpr (PH == 0) {
        h = V[r][k / RH];
      } else if constexpr (PH == 1) {
        // o = oc0 + k: near sample (oc0 >> 1) + (k >> 1), window slot 1 + (k >> 1).
        const int near = 1 + (k >> 1);
        h = fmaf(3.0f, V[r][near], V[r][near + ((k & 1) ? 1 : -1)]);
      } else {
        // Two doublings: 3 A(m) + A(m'), m = (oc0 >> 1) + j, m' = m -+ 1,
        // A(m) = 3 x[m >> 1] + x[(m >> 1) -+ 1]; window slot 1 is x[oc0 >> 2].
        const int j = k >> 1;
        const int j2 = j + ((k & 1) ? 1 : -1);
        const int n1 = 1 + (j >> 1), n2 = 1 + (j2 >> 1);
        h = fmaf(3.0f, fmaf(3.0f, V[r][n1], V[r][n1 + ((j & 1) ? 1 : -1)]),
                 fmaf(3.0f, V[r][n2], V[r][n2 + ((j2 & 1) ? 1 : -1)]));
      }
      t[r][k] = fmaf(h, kScale, -bias);
    }
  }
}

// The kernel's forms: kLayout 0 takes each plane's filter from a switch
// that is uniform across the grid; 1-3 fix the three planes' filters at
// compile time for the layouts most streams have (fancy upsampling), so
// that the kernel holds one filter's code per plane: 1 = 4:2:0 (Y as it
// is, chroma one doubling per axis), 2 = 4:2:2 (chroma one horizontal
// doubling), 3 = no upsampling.
#define JT_PV_CASES(PH, RH)                                              \
  case (PH * 3 + 0) * 4 + RH - 1:                                        \
    plane_values<PH, 0, RH>(c, w, s, or0, oc0, bias, t); break;          \
  case (PH * 3 + 1) * 4 + RH - 1:                                        \
    plane_values<PH, 1, RH>(c, w, s, or0, oc0, bias, t); break;          \
  case (PH * 3 + 2) * 4 + RH - 1:                                        \
    plane_values<PH, 2, RH>(c, w, s, or0, oc0, bias, t); break;

template <int kLayout, int kPlane>
__device__ __forceinline__ void layout_values(const Comp& c, const Win& w,
                                              const uint32_t* s, int or0,
                                              int oc0, float bias,
                                              float (&t)[kRows][kGroup]) {
  if constexpr (kLayout != 0) {
    constexpr bool kChroma = kPlane > 0 && kLayout != 3;
    plane_values<kChroma ? 1 : 0, kChroma && kLayout == 1 ? 1 : 0, 1>(
        c, w, s, or0, oc0, bias, t);
  } else {
    switch ((c.ph * 3 + c.pv) * 4 + c.rh - 1) {
      JT_PV_CASES(0, 1)
      JT_PV_CASES(0, 2)
      JT_PV_CASES(0, 3)
      JT_PV_CASES(0, 4)
      JT_PV_CASES(1, 1)
      JT_PV_CASES(2, 1)
    }
  }
}

#undef JT_PV_CASES

// The form of the kernel for these planes' filters (see layout_values).
int kernel_layout(const Args& a) {
  auto is = [&](int c, int ph, int pv) {
    return a.c[c].ph == ph && a.c[c].pv == pv && a.c[c].rh == 1 &&
           a.c[c].rv == 1;
  };
  if (!is(0, 0, 0)) return 0;
  if (is(1, 1, 1) && is(2, 1, 1)) return 1;
  if (is(1, 1, 0) && is(2, 1, 0)) return 2;
  if (is(1, 0, 0) && is(2, 0, 0)) return 3;
  return 0;
}

// rint(x) for |x| < 2^22, without the conversion unit: adding 1.5 2^23
// rounds x to an integer, half to even (the ulp there is 1), and leaves it
// in the low mantissa bits. pack_sat_u8 clips it.
__device__ __forceinline__ int round_int(float x) {
  return __float_as_int(x + 12582912.0f) - 0x4B400000;
}

#ifndef JT_HOST_STANDIN
// (c << 16) | (sat_u8(a) << 8) | sat_u8(b): cvt.pack.sat (sm_72 and later).
__device__ __forceinline__ uint32_t pack_sat_u8(int a, int b, uint32_t c) {
  uint32_t d;
  asm("cvt.pack.sat.u8.s32.b32 %0, %1, %2, %3;"
      : "=r"(d)
      : "r"(a), "r"(b), "r"(c));
  return d;
}
#endif

// The thread's patch: the three planes' values, the colour map (or none
// for RGB-coded streams), rounded, clipped and packed as each row's 3
// kGroup bytes in kWords words.
template <bool kIdentity, int kLayout>
__device__ __forceinline__ void tile_patch(const Args& a, const Win (&w)[3],
                                           const uint32_t* s, int or0,
                                           int oc0,
                                           uint32_t (&out)[kRows][kWords]) {
  constexpr int kPlane = kMaxRows * kPitch;  // words of one plane's window
  // The identity form serves YCbCr-coded streams only (the C entry).
  const float bias = !kIdentity && a.is_rgb ? 0.0f : 128.0f;
  float t[3][kRows][kGroup];
  layout_values<kLayout, 0>(a.c[0], w[0], s, or0, oc0, 0.0f, t[0]);
  layout_values<kLayout, 1>(a.c[1], w[1], s + kPlane, or0, oc0, bias, t[1]);
  layout_values<kLayout, 2>(a.c[2], w[2], s + 2 * kPlane, or0, oc0, bias,
                            t[2]);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    int b[3 * kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const float t0 = t[0][r][k], t1 = t[1][r][k], t2 = t[2][r][k];
      float v[3];
      if constexpr (kIdentity) {
        v[0] = __fadd_rn(t0, __fmul_rn(t2, a.m[2]));
        v[1] = __fadd_rn(__fadd_rn(t0, __fmul_rn(t1, a.m[4])),
                         __fmul_rn(t2, a.m[5]));
        v[2] = __fadd_rn(t0, __fmul_rn(t1, a.m[7]));
      } else if (a.is_rgb) {
        v[0] = t0;
        v[1] = t1;
        v[2] = t2;
      } else {
#pragma unroll
        for (int c = 0; c < 3; ++c)
          v[c] = __fadd_rn(__fadd_rn(__fmul_rn(t0, a.m[3 * c]),
                                     __fmul_rn(t1, a.m[3 * c + 1])),
                           __fmul_rn(t2, a.m[3 * c + 2]));
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) b[3 * k + c] = round_int(v[c]);
    }
#pragma unroll
    for (int i = 0; i < kWords; ++i)
      out[r][i] = pack_sat_u8(b[4 * i + 1], b[4 * i],
                              pack_sat_u8(b[4 * i + 3], b[4 * i + 2], 0u));
  }
}

// The patch's rows into image img's output: 8-byte stores of each row's 3
// kGroup bytes where the row width is a multiple of 8 (every run then
// starts at an 8-byte boundary), words where it is a multiple of 4, else
// bytes; rows past hlim and columns past wlim are not stored.
__device__ __forceinline__ void tile_store(const Args& a, int img, int or0,
                                           int oc0,
                                           const uint32_t (&v)[kRows][kWords]) {
  const int ncols = a.wlim - oc0 < kGroup ? a.wlim - oc0 : kGroup;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (or0 + r >= a.hlim) return;
    const long row = static_cast<long>(img) * a.hlim + or0 + r;
    uint8_t* dst = a.out + (row * a.wlim + oc0) * 3;
    if (ncols == kGroup && a.wlim % 8 == 0) {
      uint2* d = reinterpret_cast<uint2*>(dst);
#pragma unroll
      for (int i = 0; i < kWords / 2; ++i)
        d[i] = make_uint2(v[r][2 * i], v[r][2 * i + 1]);
    } else if (ncols == kGroup && a.wlim % 4 == 0) {
      uint32_t* d = reinterpret_cast<uint32_t*>(dst);
#pragma unroll
      for (int i = 0; i < kWords; ++i) d[i] = v[r][i];
    } else {
#pragma unroll
      for (int i = 0; i < 3 * kGroup; ++i)
        if (i < 3 * ncols)
          dst[i] = static_cast<uint8_t>(v[r][i >> 2] >> (8 * (i & 3)));
    }
  }
}

// Thread tid's pixels of the tile (R0, C0) of image img, once the windows
// s are filled: kRowPairs patches, one below the other (a warp's threads
// cover 2 kRowPairs rows of the tile's width).
template <bool kIdentity, int kLayout>
__device__ __forceinline__ void tile_thread(const Args& a, const Win (&w)[3],
                                            const uint32_t* s, int img, int R0,
                                            int C0, int tid) {
  const int oc0 = C0 + kGroup * (tid % kLanes);
  if (oc0 >= a.wlim) return;
#pragma unroll 1
  for (int p = 0; p < kRowPairs; ++p) {
    const int or0 = R0 + kRows * (kRowPairs * (tid / kLanes) + p);
    if (or0 >= a.hlim) return;
    uint32_t v[kRows][kWords];
    tile_patch<kIdentity, kLayout>(a, w, s, or0, oc0, v);
    tile_store(a, img, or0, oc0, v);
  }
}

#ifndef JT_HOST_STANDIN

// x: column tiles; y: row tiles; z: images.
template <bool kIdentity, int kLayout>
__global__ void __launch_bounds__(kThreads) finish_color_kernel(const Args a) {
  __shared__ __align__(16) uint32_t s[3 * kMaxRows * kPitch];
  const int R0 = blockIdx.y * kTileRows, C0 = blockIdx.x * kTileCols;
  Win w[3];
  tile_windows(a, R0, C0, w);
  tile_fill(a, w, blockIdx.z, threadIdx.x, s);
  __syncthreads();
  tile_thread<kIdentity, kLayout>(a, w, s, blockIdx.z, R0, C0, threadIdx.x);
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

// The matrix has color.YCBCR_TO_RGB's exact 1.0 and 0.0 entries, which the
// kIdentity form leaves out (it serves YCbCr-coded streams only).
bool identity_entries(const Args& a) {
  return a.m[0] == 1.0f && a.m[3] == 1.0f && a.m[6] == 1.0f &&
         a.m[1] == 0.0f && a.m[8] == 0.0f;
}

}  // namespace

#ifndef JT_HOST_STANDIN

extern "C" int jt_finish_color(const void* const* planes, const int* geo,
                               const float* m, void* out, int n, int hlim,
                               int wlim, int is_rgb, void* stream) {
  if (n <= 0 || hlim <= 0 || wlim <= 0) return 0;
  if (hlim > 65535 || n > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(planes, geo, m, out, hlim, wlim, is_rgb);
  const dim3 grid((wlim + kTileCols - 1) / kTileCols,
                  (hlim + kTileRows - 1) / kTileRows, n);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (identity_entries(a) && !is_rgb ? kernel_layout(a) : -1) {
    case 0: finish_color_kernel<true, 0><<<grid, kThreads, 0, st>>>(a); break;
    case 1: finish_color_kernel<true, 1><<<grid, kThreads, 0, st>>>(a); break;
    case 2: finish_color_kernel<true, 2><<<grid, kThreads, 0, st>>>(a); break;
    case 3: finish_color_kernel<true, 3><<<grid, kThreads, 0, st>>>(a); break;
    default: finish_color_kernel<false, 0><<<grid, kThreads, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

#endif  // JT_HOST_STANDIN
