// Level shift + 8x8 forward DCT + quantize over an image-layout plane.
//
// Replaces the Pallas TPU kernel jpeg_tpu/ops/fused.py `_dct8_kernel`
// (pallas_call at :101 in _dct_pass, wrapper fused_dct_quantize). On the
// TPU the 2-D transform ran as two passes of `D @ band` over 8-row bands
// with XLA transposes between and after them, because Mosaic rejects
// reshapes across the sublane axis. Here one pass does the whole block:
//
//   out[8a+u, 8b+v] = round_half_away(
//       (sum_x (sum_y D[u,y] * (X[8a+y, 8b+x] - 128)) * D[v,x]) / Q[u,v])
//
// Bound on the H100: memory. Per sample the kernel reads 4 bytes and writes
// 4 (8 H W bytes per plane: 66.4 MB for the 2160x3840 Y plane, 19.8 us at
// 3.35 TB/s; 16.6 MB, 5.0 us, for a 1080x1920 chroma plane) and does 16 FMAs
// and one IEEE division, far below the card's ratio of FLOPs to bytes. So
// the design is about keeping many wide loads in flight and nothing else in
// the way. It is kernel B's (csrc/idct8.cu) run backwards.
//
// Design: one thread owns one 8x8 block, in registers, from load to store.
// - It starts the block's 16 loads of 16 bytes (two float4 per row, 256 B in
//   flight per thread) before it uses any of them. Neighbouring threads own
//   neighbouring blocks of a band, so a warp's two loads of a row cover 1 KB
//   of that row without a gap, whole 128-byte lines.
// - The level shift (-128) is fused on the load.
// - Both 1-D passes (columns, then rows) run in registers with the basis as
//   compile-time constants (immediate operands, no table load). Each output
//   is one FMA chain from zero in the order of the plain twin's two
//   contractions (y = 0..7, then x = 0..7), which is also the order of the
//   kernel before this one, so the quantized coefficients equal both bit for
//   bit. A factored butterfly would halve the FMAs but sums in another order.
// - The quotient is a true IEEE division (__fdiv_rn: a reciprocal multiply
//   can differ by an ulp at .5 boundaries, as fused.py insists) by the table
//   (raster, row = vertical frequency), which sits in shared memory: read
//   once per thread block from global (one __syncthreads(), the kernel's
//   only one) and then by warp-wide broadcast. Round half away from zero on
//   the store, two int4 per row.
// - No shared-memory tile, no transpose, no shuffle: a thread never needs
//   another thread's samples.
// - Blocks are numbered linearly over the plane (row-major), so a ragged
//   right edge (W a multiple of 8 but not of the warp's 256 columns) costs
//   nothing: only the last thread block of the grid has idle threads. H and
//   W are multiples of 8 and the base pointers 16-byte aligned (checked by
//   the wrapper), so every row segment is.
// - TMA, wgmma and clusters are not used on purpose: this is a streaming
//   pass with reuse only inside an 8x8 block, which registers hold.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; kernel_compare.py, kernel-only,
// L2 cold, this kernel and the one before it in turns in one run): Y plane
// 34.3 us, 0.58 of its bound (1.93 TB/s), chroma plane 12.1 us, 0.41 of its
// bound; the kernel before it (one coefficient per thread, 4-byte loads and
// stores, two shared tiles, two barriers per band, the basis read from
// shared memory for each FMA) took 61.6 us and 17.2 us. 128 registers, no
// spills. With __launch_bounds__(128) alone ptxas settles on 96 registers
// and serializes part of the loads (38.3 us on the Y plane); naming the
// minimum of one resident thread block lets it take 128. 64 or 256 threads
// per thread block change the Y time by under 2%. The division is not what
// holds it: a Markstein-corrected reciprocal (bit-identical here) measured
// the same 34.2 us. The chroma plane is one partial wave (253 thread blocks
// on 132 SMs), so its time is a load's latency plus one thread's ~2,000
// dependent instructions plus the store, not a rate. Outputs are
// bit-identical to the earlier kernel's and to the twin's on the 4K planes.
// PERF.md section 6 has the table.
//
// JT_HOST_STANDIN: a host compiler that defines the CUDA built-ins this file
// uses (see tests/test_torch_fused_dct.py) can compile dct8_block alone and
// run it block by block; the kernel and its launcher are left out then.

#include <cstdint>
#ifndef JT_HOST_STANDIN
#include <cuda_runtime.h>
#endif

#ifndef JT_THREADS
#define JT_THREADS 128
#endif
#ifndef JT_MIN_BLOCKS
#define JT_MIN_BLOCKS 1  // named so that ptxas may use 128 registers (above)
#endif

namespace {

constexpr int kThreads = JT_THREADS;  // 8x8 blocks per thread block
static_assert(kThreads >= 64, "the first 64 threads load the quant table");

// c_k = cos(k pi / 16) / 2, k = 1..7, written to double precision so that
// each rounds to the same f32 as dct_basis()'s entry.
constexpr float kC1 = 0.4903926402016152f;
constexpr float kC2 = 0.46193976625564337f;
constexpr float kC3 = 0.4157348061512726f;
constexpr float kC4 = 0.3535533905932738f;
constexpr float kC5 = 0.27778511650980114f;
constexpr float kC6 = 0.19134171618254492f;
constexpr float kC7 = 0.09754516100806417f;

// The orthonormal DCT-II basis D[u][x] = c(u)/2 cos((2x+1) u pi / 16) as a
// compile-time constant: with u and x known after unrolling, every use
// folds into an immediate operand.
__device__ constexpr float basis(int u, int x) {
  if (u == 0) return kC4;
  int k = ((2 * x + 1) * u) % 32;  // angle in units of pi/16
  if (k > 16) k = 32 - k;          // cos(2 pi - t) = cos t
  const bool neg = k > 8;          // cos(pi - t) = -cos t
  if (neg) k = 16 - k;
  float c = 0.0f;
  switch (k) {
    case 1: c = kC1; break;
    case 2: c = kC2; break;
    case 3: c = kC3; break;
    case 4: c = kC4; break;
    case 5: c = kC5; break;
    case 6: c = kC6; break;
    case 7: c = kC7; break;
  }
  return neg ? -c : c;
}

// In-place 8-point forward DCT of v[0], v[S], ..., v[7 S] (samples in,
// frequencies out): X[u] = sum_n D[u][n] x[n], one FMA chain per frequency
// in the order n = 0..7 from zero.
template <int S>
__device__ __forceinline__ void dct8_1d(float* v) {
  float in[8];
#pragma unroll
  for (int n = 0; n < 8; ++n) in[n] = v[n * S];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    float acc = 0.0f;
#pragma unroll
    for (int n = 0; n < 8; ++n) acc = fmaf(basis(u, n), in[n], acc);
    v[u * S] = acc;
  }
}

// Quotient by the table entry, rounded half away from zero.
__device__ __forceinline__ int32_t quantize(float c, float q) {
  const float s = __fdiv_rn(c, q);
  return static_cast<int32_t>(copysignf(floorf(fabsf(s) + 0.5f), s));
}

// One 8x8 block whose top-left sample is plane[base], rows w apart; q is the
// 64-entry raster table (shared memory in the kernel).
__device__ __forceinline__ void dct8_block(const float* __restrict__ plane,
                                           const float* q,
                                           int32_t* __restrict__ out,
                                           long base, int w) {
  // All 16 loads first: 256 bytes in flight per thread.
  float4 raw[16];
#pragma unroll
  for (int y = 0; y < 8; ++y) {
    const float4* src =
        reinterpret_cast<const float4*>(plane + base + static_cast<long>(y) * w);
    raw[2 * y] = __ldg(src);
    raw[2 * y + 1] = __ldg(src + 1);
  }

  float r[64];
#pragma unroll
  for (int y = 0; y < 8; ++y) {
    r[8 * y + 0] = raw[2 * y].x - 128.0f;
    r[8 * y + 1] = raw[2 * y].y - 128.0f;
    r[8 * y + 2] = raw[2 * y].z - 128.0f;
    r[8 * y + 3] = raw[2 * y].w - 128.0f;
    r[8 * y + 4] = raw[2 * y + 1].x - 128.0f;
    r[8 * y + 5] = raw[2 * y + 1].y - 128.0f;
    r[8 * y + 6] = raw[2 * y + 1].z - 128.0f;
    r[8 * y + 7] = raw[2 * y + 1].w - 128.0f;
  }

  // Columns: t[u][x] = sum_y D[u][y] s[y][x]. Rows: c[u][v] = sum_x t[u][x] D[v][x].
#pragma unroll
  for (int x = 0; x < 8; ++x) dct8_1d<8>(r + x);
#pragma unroll
  for (int u = 0; u < 8; ++u) dct8_1d<1>(r + 8 * u);

#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const float4 qa = *reinterpret_cast<const float4*>(q + 8 * u);
    const float4 qb = *reinterpret_cast<const float4*>(q + 8 * u + 4);
    int4* dst = reinterpret_cast<int4*>(out + base + static_cast<long>(u) * w);
    dst[0] = make_int4(quantize(r[8 * u + 0], qa.x), quantize(r[8 * u + 1], qa.y),
                       quantize(r[8 * u + 2], qa.z), quantize(r[8 * u + 3], qa.w));
    dst[1] = make_int4(quantize(r[8 * u + 4], qb.x), quantize(r[8 * u + 5], qb.y),
                       quantize(r[8 * u + 6], qb.z), quantize(r[8 * u + 7], qb.w));
  }
}

#ifndef JT_HOST_STANDIN

__global__ void __launch_bounds__(kThreads, JT_MIN_BLOCKS)
dct8_kernel(const float* __restrict__ plane, const float* __restrict__ qtab,
            int32_t* __restrict__ out, int w, int wb, long nblocks) {
  __shared__ __align__(16) float s_q[64];
  if (threadIdx.x < 64) s_q[threadIdx.x] = qtab[threadIdx.x];
  __syncthreads();

  const long t = static_cast<long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= nblocks) return;
  const long brow = t / wb;
  const int bcol = static_cast<int>(t - brow * wb);
  dct8_block(plane, s_q, out, brow * 8 * w + static_cast<long>(bcol) * 8, w);
}

#endif  // JT_HOST_STANDIN

}  // namespace

#ifndef JT_HOST_STANDIN

extern "C" int jt_dct8(const void* plane, const void* qtab, void* out, int h,
                       int w, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  const int wb = w / 8;
  const long nblocks = static_cast<long>(h / 8) * wb;
  const long grid = (nblocks + kThreads - 1) / kThreads;
  dct8_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(plane), static_cast<const float*>(qtab),
      static_cast<int32_t*>(out), w, wb, nblocks);
  return static_cast<int>(cudaGetLastError());
}

#endif  // JT_HOST_STANDIN
