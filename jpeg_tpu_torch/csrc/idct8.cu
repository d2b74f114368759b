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
// Kernel B2 (jt_idct8_samples) is the same block arithmetic with other
// addressing and another epilogue, for the decoder's finish (the
// reference's _reconstruct_plane, jpeg_tpu/models/decoder.py:34-91, and the
// scan -> raster reorder before it, jpeg_tpu/models/decoder.py:360-384,
// inside the jitted _jit_finish_color): ONE launch for all of a decode's
// components. It reads the entropy decoder's int32 zig-zag blocks where they
// lie, in MCU scan order or in raster order, and writes each component's
// (n 8 hb, 8 wb) uint8 plane of clip(round(IDCT(deq(x)) + 128), 0, 255).
// That is the reorder copy, the de-zigzag gather, the unblockify copy,
// kernel B, round and clamp of the chain before it, in one pass.
// - A table of 1-3 components goes to the kernel by value (ZArgs): each
//   one's blocks, image count and stride between images in blocks (so that
//   a batch's (n, B, 64) rows need no copy), MCU geometry (mcu_cols, v, h;
//   raster order is (wb, 1, 1)), 64-entry raster table and output plane.
//   The grid runs over every component's blocks, kThreads to a thread
//   block and each thread block inside one component, so the 4K 4:2:0
//   image's 194,400 blocks are one launch of 1,521 thread blocks (about 2.9
//   waves) where three launches left the two chroma planes a partial wave.
// - Scan order is read in place: block t of an image maps to its plane
//   position with layout.mcu_scan_permutation's arithmetic (block_position):
//   mcu = t / (v h), r = t % (v h), row = (mcu / mcu_cols) v + r / h,
//   column = (mcu % mcu_cols) h + r % h.
// - Loads: a thread block's 128 blocks (128 runs of 256 bytes) come into a
//   coefficient-major shared tile s[k * (kThreads + 1) + block] through
//   16-byte loads in which eight neighbouring lanes read one half block
//   (b2_fill): a warp's load covers four whole 128-byte lines, where one
//   thread reading its own block touched 32 lines per load. The one-word
//   pad makes both the placement (four words of a piece into four tile
//   rows) and each thread's 64 reads of its own block free of bank
//   conflicts, and the reads' offsets are compile-time constants, so no
//   register is indexed at run time. One __syncthreads().
// - The arithmetic is kernel B's, the same fmaf chains in the same order,
//   so B2's samples equal clamp(round(B(unblockify(from_zigzag(zz))))) bit
//   for bit. Rounding is half to even, as torch.round (to_u8 says how).
// - Stores: one 8-byte store per row of a block.
// - Bound: 256 bytes in and 64 out per block: 62.2 MB for the 4K 4:2:0
//   image's three components, 18.57 us at 3.35 TB/s.
// Measured (NVIDIA H100 80GB HBM3, 700 W; kernel_compare.py --finish-only,
// kernel only, L2 cold, in turns): 30.3 us for the 4K 4:2:0 image (0.61 of
// the bound) against 70.5 us for the scan -> raster copy and a launch per
// component of the per-plane form before it; 64 or 96 threads a block time
// the same. Not issue bound (2,567 SASS instructions a warp, ~15 us): a
// thread block loads, waits at its barrier and computes in turn.
//
// JT_HOST_STANDIN: a host compiler that defines the CUDA built-ins this file
// uses (see tests/test_torch_finish.py) can compile idct8_block, b2_fill,
// block_position and b2_body alone and run them thread by thread; the
// kernels and their launchers are left out then.

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

// Kernel B's block: block t of a (hb, wb) grid in raster order, w = 8 wb;
// coeffs is the (8 hb, w) int32 plane, out the (8 hb, w) float plane of
// IDCT + 128, q the 64-entry raster table (shared memory in the kernel).
__device__ __forceinline__ void idct8_block(const int32_t* __restrict__ coeffs,
                                            const float* q,
                                            float* __restrict__ out, long t,
                                            int w, int wb) {
  const long brow = t / wb;
  const int bcol = static_cast<int>(t - brow * wb);
  const long base = brow * 8 * w + static_cast<long>(bcol) * 8;

  // All 16 loads first: 256 bytes in flight per thread.
  int4 raw[16];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int4* src =
        reinterpret_cast<const int4*>(coeffs + base + static_cast<long>(u) * w);
    raw[2 * u] = __ldg(src);
    raw[2 * u + 1] = __ldg(src + 1);
  }

  float r[64];
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

  // Columns: t[y][v] = sum_u D[u][y] c[u][v]. Rows: o[y][x] = sum_v t[y][v] D[v][x].
#pragma unroll
  for (int x = 0; x < 8; ++x) idct8_1d<8>(r + x);
#pragma unroll
  for (int y = 0; y < 8; ++y) idct8_1d<1>(r + 8 * y);

#pragma unroll
  for (int y = 0; y < 8; ++y) {
    float4* dst = reinterpret_cast<float4*>(out + base + static_cast<long>(y) * w);
    dst[0] = make_float4(r[8 * y + 0] + 128.0f, r[8 * y + 1] + 128.0f,
                         r[8 * y + 2] + 128.0f, r[8 * y + 3] + 128.0f);
    dst[1] = make_float4(r[8 * y + 4] + 128.0f, r[8 * y + 5] + 128.0f,
                         r[8 * y + 6] + 128.0f, r[8 * y + 7] + 128.0f);
  }
}

// ---------------------------------------------------------------------------
// Kernel B2.

constexpr int kMaxComps = 3;
constexpr int kPitch = kThreads + 1;  // words per coefficient row of the tile
static_assert(kThreads % 32 == 0 && kThreads <= 128,
              "whole warps; the tile must fit in 48 KB of static shared memory");

// One component of B2's table. Block indices fit in 32 bits (the wrapper
// checks): 2^31 blocks would be 512 GiB of coefficients.
struct ZComp {
  const int32_t* zz;  // the component's first block
  const float* q;     // its 64-entry raster table
  uint8_t* out;       // its (n 8 hb, 8 wb) samples, n images stacked
  int nblocks;        // n hb wb
  int first;          // its first thread block in the grid
  int per, stride;    // blocks of one image, blocks between two images' first
  int hb, wb;         // one image's block grid
  int mcu_cols, v, h; // MCU scan order; raster order is (wb, 1, 1)
};

struct ZArgs {
  ZComp c[kMaxComps];
  int ncomp;
};

// The address of block t (0 <= t < nblocks) of a component.
__device__ __forceinline__ const int32_t* block_src(const ZComp& c, int t) {
  if (c.stride == c.per) return c.zz + static_cast<long>(t) * 64;
  const int img = t / c.per;
  return c.zz + (static_cast<long>(img) * c.stride + (t - img * c.per)) * 64;
}

// Scan-order index map: block t of a component -> its block row in the
// stacked (n hb, wb) grid and its block column.
__device__ __forceinline__ void block_position(const ZComp& c, int t,
                                               int& brow, int& bcol) {
  const int img = t / c.per;
  const int local = t - img * c.per;
  const int vh = c.v * c.h;
  const int mcu = local / vh;
  const int r = local - mcu * vh;
  const int mrow = mcu / c.mcu_cols;
  brow = img * c.hb + mrow * c.v + r / c.h;
  bcol = (mcu - mrow * c.mcu_cols) * c.h + (r - (r / c.h) * c.h);
}

// Chunk placement: thread tid moves 16 of the thread block's 16-byte pieces
// (blocks t0 .. t0 + nb - 1) into the coefficient-major tile s[k * kPitch +
// block]. In its k-th load, lane l of warp w takes piece (l % 8) + 8 (k % 2)
// of block 4 (w + (kThreads / 32) (k / 2)) + l / 8: eight lanes read one
// aligned half block, so a warp's load is four whole 128-byte lines. The
// four words of a piece go to tile rows 4 p .. 4 p + 3; with kPitch = 1 mod
// 32 the store of word e lands in bank (4 (l % 8) + l / 8 + const) % 32, a
// different bank for each of the 32 lanes.
__device__ __forceinline__ void b2_fill(const ZComp& c, int t0, int nb, int tid,
                                        int32_t* s) {
  constexpr int kWarps = kThreads / 32;
  const int lane = tid & 31, warp = tid >> 5;
  int4 raw[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int b = 4 * (warp + kWarps * (k >> 1)) + (lane >> 3);
    const int piece = (lane & 7) + 8 * (k & 1);
    if (b < nb)
      raw[k] = __ldg(reinterpret_cast<const int4*>(block_src(c, t0 + b)) + piece);
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int b = 4 * (warp + kWarps * (k >> 1)) + (lane >> 3);
    const int piece = (lane & 7) + 8 * (k & 1);
    if (b < nb) {
      int32_t* d = s + 4 * piece * kPitch + b;
      d[0] = raw[k].x;
      d[kPitch] = raw[k].y;
      d[2 * kPitch] = raw[k].z;
      d[3 * kPitch] = raw[k].w;
    }
  }
}

// Dequantize the tile's column `s` (zig-zag position K in row K) into
// raster order: r[j] for j = zigzag_raster(K) takes the K-th coefficient
// times table entry j.
template <int... K>
__device__ __forceinline__ void dequant_tile(const int32_t* s, const float* q,
                                             float (&r)[64],
                                             std::integer_sequence<int, K...>) {
  ((r[kRaster<K>] = static_cast<float>(s[K * kPitch]) * q[kRaster<K>]), ...);
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

// Thread tid's block, t0 + tid: dequantize from the tile, kernel B's two
// passes, round and clamp, and one 8-byte store per row at the block's
// place in its plane.
__device__ __forceinline__ void b2_body(const ZComp& c, int t0, int tid,
                                        const int32_t* s, const float* q) {
  float r[64];
  dequant_tile(s + tid, q, r, std::make_integer_sequence<int, 64>());
#pragma unroll
  for (int x = 0; x < 8; ++x) idct8_1d<8>(r + x);
#pragma unroll
  for (int y = 0; y < 8; ++y) idct8_1d<1>(r + 8 * y);

  int brow, bcol;
  block_position(c, t0 + tid, brow, bcol);
  const long w = 8L * c.wb;
  uint8_t* dst = c.out + 8L * brow * w + 8L * bcol;
#pragma unroll
  for (int y = 0; y < 8; ++y) {
    const float* v = r + 8 * y;
    uint2 row;
    row.x = to_u8(v[0]) | to_u8(v[1]) << 8 | to_u8(v[2]) << 16 | to_u8(v[3]) << 24;
    row.y = to_u8(v[4]) | to_u8(v[5]) << 8 | to_u8(v[6]) << 16 | to_u8(v[7]) << 24;
    *reinterpret_cast<uint2*>(dst + y * w) = row;
  }
}

// B2's table from the C entry's plain arrays: per component its blocks,
// table and plane, and geo[7 i ..] = (n, hb, wb, stride, mcu_cols, v, h).
// Returns the grid size in thread blocks.
long make_zargs(const void* const* zz, const void* const* q,
                void* const* out, const int* geo, int ncomp, ZArgs& a) {
  long grid = 0;
  a.ncomp = ncomp;
  for (int i = 0; i < kMaxComps; ++i) {
    const int* g = geo + 7 * (i < ncomp ? i : 0);
    ZComp& c = a.c[i];
    c.zz = static_cast<const int32_t*>(zz[i < ncomp ? i : 0]);
    c.q = static_cast<const float*>(q[i < ncomp ? i : 0]);
    c.out = static_cast<uint8_t*>(out[i < ncomp ? i : 0]);
    c.hb = g[1];
    c.wb = g[2];
    c.per = g[1] * g[2];
    c.nblocks = i < ncomp ? g[0] * c.per : 0;
    c.stride = g[3];
    c.mcu_cols = g[4];
    c.v = g[5];
    c.h = g[6];
    c.first = static_cast<int>(grid);
    grid += (c.nblocks + kThreads - 1) / kThreads;
  }
  return grid;
}

#ifndef JT_HOST_STANDIN

__global__ void __launch_bounds__(kThreads)
idct8_kernel(const int32_t* __restrict__ coeffs, const float* __restrict__ qtab,
             float* __restrict__ out, int w, int wb, long nblocks) {
  __shared__ __align__(16) float s_q[64];
  if (threadIdx.x < 64) s_q[threadIdx.x] = qtab[threadIdx.x];
  __syncthreads();

  const long t = static_cast<long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= nblocks) return;
  idct8_block(coeffs, s_q, out, t, w, wb);
}

// The component of thread block b, the same for all its threads.
__device__ __forceinline__ ZComp comp_of(const ZArgs& a, int b) {
  const int i = (a.ncomp > 1 && b >= a.c[1].first) +
                (a.ncomp > 2 && b >= a.c[2].first);
  return i == 0 ? a.c[0] : (i == 1 ? a.c[1] : a.c[2]);
}

__global__ void __launch_bounds__(kThreads) idct8_samples_kernel(const ZArgs a) {
  __shared__ __align__(16) float s_q[64];
  __shared__ __align__(16) int32_t s_c[64 * kPitch];
  const ZComp c = comp_of(a, blockIdx.x);
  const int t0 = (static_cast<int>(blockIdx.x) - c.first) * kThreads;
  const int nb = c.nblocks - t0 < kThreads ? c.nblocks - t0 : kThreads;
  if (threadIdx.x < 64) s_q[threadIdx.x] = c.q[threadIdx.x];
  b2_fill(c, t0, nb, threadIdx.x, s_c);
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < nb) b2_body(c, t0, threadIdx.x, s_c, s_q);
}

#endif  // JT_HOST_STANDIN

}  // namespace

#ifndef JT_HOST_STANDIN

// Kernel B: (h, w) int32 coefficient plane -> (h, w) f32 samples.
extern "C" int jt_idct8(const void* coeffs, const void* qtab, void* out, int h,
                        int w, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  const long nblocks = static_cast<long>(h / 8) * (w / 8);
  const long grid = (nblocks + kThreads - 1) / kThreads;
  idct8_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(coeffs), static_cast<const float*>(qtab),
      static_cast<float*>(out), w, w / 8, nblocks);
  return static_cast<int>(cudaGetLastError());
}

// Kernel B2: per component i < ncomp, zig-zag blocks zz[i] (geo[7 i ..] =
// (n, hb, wb, stride, mcu_cols, v, h)) and raster table q[i], both on the
// card, -> the (n 8 hb, 8 wb) uint8 plane out[i]; one launch.
extern "C" int jt_idct8_samples(const void* const* zz, const void* const* q,
                                void* const* out, const int* geo, int ncomp,
                                void* stream) {
  if (ncomp < 1 || ncomp > kMaxComps)
    return static_cast<int>(cudaErrorInvalidValue);
  ZArgs a;
  const long grid = make_zargs(zz, q, out, geo, ncomp, a);
  if (grid == 0) return 0;
  if (grid > 0x7FFFFFFFL) return static_cast<int>(cudaErrorInvalidValue);
  idct8_samples_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

#endif  // JT_HOST_STANDIN
