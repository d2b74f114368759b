// Dequantize + 8x8 inverse DCT + level unshift over an image-layout plane.
//
// Replaces the Pallas TPU kernel jpeg_tpu/ops/fused.py `_idct8_kernel`
// (pallas_call at :121 in _idct_pass, wrapper fused_dequant_idct). On the
// TPU the 2-D transform ran as two passes of `D^T @ band` over 8-row bands
// with XLA transposes between them, because Mosaic rejects reshapes across
// the sublane axis. Here one pass does the whole block:
//
//   out[8a+y, 8b+x] = sum_v (sum_u D[u,y] * C[8a+u, 8b+v] * Q[u,v]) * D[v,x] + 128
//
// Bound on the H100: memory. Per sample the kernel reads 4 bytes and writes
// 4 (8 H W bytes per plane: 66.4 MB for the 2160x3840 Y plane, 19.8 us at
// 3.35 TB/s; 16.6 MB, 5.0 us, for a 1080x1920 chroma plane) and does a few
// FMAs, far below the card's ratio of FLOPs to bytes. So the design is about
// keeping many wide loads in flight and nothing else in the way.
//
// Design: one thread owns one 8x8 block, in registers, from load to store.
// - It starts the block's 16 loads of 16 bytes (two int4 per row, 256 B in
//   flight per thread) before it uses any of them. Neighbouring threads own
//   neighbouring blocks of a band, so a warp's two loads of a row cover 1 KB
//   of that row without a gap, whole 128-byte lines.
// - Dequantization is fused on the load; the 64 table entries sit in shared
//   memory, read once per thread block from global (one __syncthreads(),
//   the kernel's only one) and then by warp-wide broadcast.
// - Both 1-D passes (columns, then rows) run in registers with the basis as
//   compile-time constants (immediate operands, no table load): 16 FMAs per
//   sample, a few us of the FP32 pipes against a 19.8 us memory bound. A
//   factored butterfly would halve them but sums in another order than the
//   twin; the plain chains keep the two equal where the contract's 1e-2
//   (tests/test_fused.py's bound) is only 1-2 ulp, on samples near 1e5.
// - No shared-memory tile, no transpose, no shuffle: a thread never needs
//   another thread's samples. +128 on the store, two float4 per row.
// - Blocks are numbered linearly over the plane (row-major), so a ragged
//   right edge (W a multiple of 8 but not of the warp's 256 columns) costs
//   nothing: only the last thread block of the grid has idle threads. H and
//   W are multiples of 8 and the base pointers 16-byte aligned (checked by
//   the wrapper), so every row segment is.
// - TMA, wgmma and clusters are not used on purpose: this is a streaming
//   pass with reuse only inside an 8x8 block, which registers hold; tensor
//   cores have nothing to multiply that is worth their set-up, and plain
//   16-byte loads with this many in flight reach the memory's rate.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; kernel_compare.py, kernel-only,
// L2 cold, this kernel and the one before it in turns in one run): Y plane
// 26.5 us, 0.75 of its bound (2.50 TB/s), chroma plane 9.3 us, 0.53 of its
// bound; the kernel before it (one sample per thread, two trips through
// shared memory, three barriers) took 63.0 us and 17.6 us. 110 registers,
// no spills: 4 thread blocks of 128 per SM, each thread with 256 bytes in
// flight. The chroma plane is one partial wave (253 thread blocks on 132
// SMs), so its time is a load's latency plus the arithmetic plus the store,
// not a rate. Outputs are bit-identical to the earlier kernel's and to the
// twin's on the 4K planes. PERF.md section 6 has the table.
//
// Kernel B2, the second entry (jt_idct8_zz_u8), is the same block body with
// other addressing and another epilogue, for the decoder's finish (the
// reference's _reconstruct_plane, jpeg_tpu/models/decoder.py:34-91, inside
// the jitted _jit_finish_color): it reads the entropy decoder's (hb wb, 64)
// int32 zig-zag blocks in plane raster block order and writes the (8 hb,
// 8 wb) uint8 plane of clip(round(IDCT(deq(x)) + 128), 0, 255). That is the
// de-zigzag gather, the unblockify copy, kernel B, round and clamp of the
// chain before it, in one pass.
// - Loads: a block's 64 coefficients are one contiguous 256-byte run, read
//   as 16 int4 loads; the zig-zag -> raster permutation is a compile-time
//   table (zigzag_raster), so it only renames registers.
// - The arithmetic is kernel B's, the same fmaf chains in the same order,
//   so B2's samples equal clamp(round(B(unblockify(from_zigzag(zz))))) bit
//   for bit. Rounding is half to even, as torch.round (to_u8 says how).
// - Stores: one 8-byte store per row of a block; neighbouring threads own
//   neighbouring blocks of a block row, so a warp writes 256 bytes of a row.
// - Bound: 256 bytes in and 64 out per block: 41.5 MB for the 2160x3840 Y
//   plane, 12.4 us at 3.35 TB/s (a 1080x1920 chroma plane 10.4 MB, 3.1 us).
//
// JT_HOST_STANDIN: a host compiler that defines the CUDA built-ins this file
// uses (see tests/test_torch_finish.py) can compile idct8_block alone and
// run it block by block; the kernels and their launchers are left out then.

#include <cstdint>
#include <utility>
#ifndef JT_HOST_STANDIN
#include <cuda_runtime.h>
#endif

#ifndef JT_THREADS
#define JT_THREADS 128
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

// Raster index (8 row + column) of zig-zag position k (T.81 Figure 5): the
// anti-diagonal s = row + column holds positions [first, first + length),
// walked with the row rising when s is odd and falling when s is even.
constexpr int zigzag_raster(int k) {
  int s = 0, first = 0;
  while (first + (s < 8 ? s + 1 : 15 - s) <= k) {
    first += s < 8 ? s + 1 : 15 - s;
    ++s;
  }
  const int lo = s < 8 ? 0 : s - 7, hi = s < 8 ? s : 7;
  const int row = (s % 2) ? lo + (k - first) : hi - (k - first);
  return row * 8 + (s - row);
}

template <int K>
constexpr int kRaster = zigzag_raster(K);  // evaluated by the compiler

// In-place 8-point inverse DCT of v[0], v[S], ..., v[7 S] (frequency in,
// samples out): x[n] = sum_u D[u][n] X[u], one FMA chain per sample in the
// order u = 0..7 from zero. That is the order of the plain twin's matrix
// products on the card, so the two agree far inside the contract's 1e-2
// even where samples reach 1e5 (where one f32 ulp is 8e-3).
template <int S>
__device__ __forceinline__ void idct8_1d(float* v) {
  float in[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) in[u] = v[u * S];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    float acc = 0.0f;
#pragma unroll
    for (int u = 0; u < 8; ++u) acc = fmaf(basis(u, n), in[u], acc);
    v[n * S] = acc;
  }
}

// Dequantize a block given in zig-zag order into raster order: r[j] for
// j = zigzag_raster(k) takes the k-th coefficient times table entry j.
template <int... K>
__device__ __forceinline__ void dequant_zigzag(const int (&c)[64],
                                               const float* q, float (&r)[64],
                                               std::integer_sequence<int, K...>) {
  ((r[kRaster<K>] = static_cast<float>(c[K]) * q[kRaster<K>]), ...);
}

// One sample of B2's epilogue: +128, round half to even, clamp to [0, 255],
// as clip(rint(x)) = clip(rint(clip(x, -1, 256))), without the conversion
// unit (an eighth of the FP32 rate): adding 1.5 2^23 to |x| < 2^22 rounds x
// to an integer, half to even (the ulp there is 1), in the low mantissa bits.
__device__ __forceinline__ uint32_t to_u8(float v) {
  const float x = fminf(fmaxf(v + 128.0f, -1.0f), 256.0f);
  const int r = __float_as_int(x + 12582912.0f) - 0x4B400000;
  return static_cast<uint32_t>(r < 0 ? 0 : (r > 255 ? 255 : r));
}

// One 8x8 block, block t of a (hb, wb) grid in raster order, w = 8 wb; q is
// the 64-entry raster table (shared memory in the kernel).
//   kZigzagU8 false (kernel B): coeffs is the (8 hb, w) int32 plane, out the
//     (8 hb, w) float plane of IDCT + 128.
//   kZigzagU8 true (kernel B2): coeffs is (hb wb, 64) int32 zig-zag blocks,
//     out the (8 hb, w) uint8 plane of clip(round(IDCT + 128)).
template <bool kZigzagU8>
__device__ __forceinline__ void idct8_block(const int32_t* __restrict__ coeffs,
                                            const float* q,
                                            void* __restrict__ out, long t,
                                            int w, int wb) {
  const long brow = t / wb;
  const int bcol = static_cast<int>(t - brow * wb);
  const long base = brow * 8 * w + static_cast<long>(bcol) * 8;

  // All 16 loads first: 256 bytes in flight per thread.
  int4 raw[16];
  if constexpr (kZigzagU8) {
    const int4* src = reinterpret_cast<const int4*>(coeffs + t * 64);
#pragma unroll
    for (int i = 0; i < 16; ++i) raw[i] = __ldg(src + i);
  } else {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int4* src =
          reinterpret_cast<const int4*>(coeffs + base + static_cast<long>(u) * w);
      raw[2 * u] = __ldg(src);
      raw[2 * u + 1] = __ldg(src + 1);
    }
  }

  float r[64];
  if constexpr (kZigzagU8) {
    int c[64];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      c[4 * i + 0] = raw[i].x;
      c[4 * i + 1] = raw[i].y;
      c[4 * i + 2] = raw[i].z;
      c[4 * i + 3] = raw[i].w;
    }
    dequant_zigzag(c, q, r, std::make_integer_sequence<int, 64>());
  } else {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const float4 qa = *reinterpret_cast<const float4*>(q + 8 * u);
      const float4 qb = *reinterpret_cast<const float4*>(q + 8 * u + 4);
      r[8 * u + 0] = static_cast<float>(raw[2 * u].x) * qa.x;
      r[8 * u + 1] = static_cast<float>(raw[2 * u].y) * qa.y;
      r[8 * u + 2] = static_cast<float>(raw[2 * u].z) * qa.z;
      r[8 * u + 3] = static_cast<float>(raw[2 * u].w) * qa.w;
      r[8 * u + 4] = static_cast<float>(raw[2 * u + 1].x) * qb.x;
      r[8 * u + 5] = static_cast<float>(raw[2 * u + 1].y) * qb.y;
      r[8 * u + 6] = static_cast<float>(raw[2 * u + 1].z) * qb.z;
      r[8 * u + 7] = static_cast<float>(raw[2 * u + 1].w) * qb.w;
    }
  }

  // Columns: t[y][v] = sum_u D[u][y] c[u][v]. Rows: o[y][x] = sum_v t[y][v] D[v][x].
#pragma unroll
  for (int x = 0; x < 8; ++x) idct8_1d<8>(r + x);
#pragma unroll
  for (int y = 0; y < 8; ++y) idct8_1d<1>(r + 8 * y);

  if constexpr (kZigzagU8) {
#pragma unroll
    for (int y = 0; y < 8; ++y) {
      const float* v = r + 8 * y;
      uint2 row;
      row.x = to_u8(v[0]) | to_u8(v[1]) << 8 | to_u8(v[2]) << 16 | to_u8(v[3]) << 24;
      row.y = to_u8(v[4]) | to_u8(v[5]) << 8 | to_u8(v[6]) << 16 | to_u8(v[7]) << 24;
      *reinterpret_cast<uint2*>(static_cast<uint8_t*>(out) + base +
                                static_cast<long>(y) * w) = row;
    }
  } else {
#pragma unroll
    for (int y = 0; y < 8; ++y) {
      float4* dst = reinterpret_cast<float4*>(static_cast<float*>(out) + base +
                                              static_cast<long>(y) * w);
      dst[0] = make_float4(r[8 * y + 0] + 128.0f, r[8 * y + 1] + 128.0f,
                           r[8 * y + 2] + 128.0f, r[8 * y + 3] + 128.0f);
      dst[1] = make_float4(r[8 * y + 4] + 128.0f, r[8 * y + 5] + 128.0f,
                           r[8 * y + 6] + 128.0f, r[8 * y + 7] + 128.0f);
    }
  }
}

#ifndef JT_HOST_STANDIN

template <bool kZigzagU8>
__global__ void __launch_bounds__(kThreads)
idct8_kernel(const int32_t* __restrict__ coeffs, const float* __restrict__ qtab,
             void* __restrict__ out, int w, int wb, long nblocks) {
  __shared__ __align__(16) float s_q[64];
  if (threadIdx.x < 64) s_q[threadIdx.x] = qtab[threadIdx.x];
  __syncthreads();

  const long t = static_cast<long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= nblocks) return;
  idct8_block<kZigzagU8>(coeffs, s_q, out, t, w, wb);
}

template <bool kZigzagU8>
int launch(const void* coeffs, const void* qtab, void* out, long nblocks,
           int w, int wb, void* stream) {
  if (nblocks <= 0) return 0;
  const long grid = (nblocks + kThreads - 1) / kThreads;
  idct8_kernel<kZigzagU8><<<static_cast<unsigned>(grid), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(coeffs), static_cast<const float*>(qtab), out,
      w, wb, nblocks);
  return static_cast<int>(cudaGetLastError());
}

#endif  // JT_HOST_STANDIN

}  // namespace

#ifndef JT_HOST_STANDIN

// Kernel B: (h, w) int32 coefficient plane -> (h, w) f32 samples.
extern "C" int jt_idct8(const void* coeffs, const void* qtab, void* out, int h,
                        int w, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  return launch<false>(coeffs, qtab, out, static_cast<long>(h / 8) * (w / 8), w,
                       w / 8, stream);
}

// Kernel B2: (hb wb, 64) int32 zig-zag blocks -> (8 hb, 8 wb) uint8 samples.
extern "C" int jt_idct8_zz_u8(const void* zz, const void* qtab, void* out,
                              int hb, int wb, void* stream) {
  if (hb <= 0 || wb <= 0) return 0;
  return launch<true>(zz, qtab, out, static_cast<long>(hb) * wb, 8 * wb, wb,
                      stream);
}

#endif  // JT_HOST_STANDIN
