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
// Design: a thread block covers one 8-row band, 32 columns wide (four 8x8
// blocks, 256 threads, one output sample each). Each thread loads and
// dequantizes one coefficient (a warp reads 128 contiguous bytes of a row),
// the vertical 8-tap pass writes a shared-memory tile, and the horizontal
// 8-tap pass reads it back and stores one f32 sample. D (dct_basis()) and
// the quant table sit in shared memory. A ragged right edge (W not a
// multiple of 32) is masked.
//
// Bound on the H100: memory. Per sample it reads 4 bytes and writes 4 and
// does 16 FMAs, far below the card's ratio of FLOPs to bytes, so the design
// goal is coalesced loads and stores and a single pass over the plane.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;  // columns per thread block (four 8x8 blocks)

__global__ void __launch_bounds__(kTileW * 8)
idct8_kernel(const int32_t* __restrict__ coeffs, const float* __restrict__ qtab,
             const float* __restrict__ basis, float* __restrict__ out, int h,
             int w) {
  __shared__ float s_d[64];
  __shared__ float s_q[64];
  __shared__ float s_c[8][kTileW + 1];
  __shared__ float s_t[8][kTileW + 1];

  const int tx = threadIdx.x;  // column within the tile
  const int ty = threadIdx.y;  // row within the band
  const int lin = ty * kTileW + tx;
  if (lin < 64) {
    s_d[lin] = basis[lin];
    s_q[lin] = qtab[lin];
  }
  __syncthreads();

  const long row = static_cast<long>(blockIdx.y) * 8 + ty;
  const int col = blockIdx.x * kTileW + tx;
  const bool inside = col < w;
  const int xi = tx & 7;
  s_c[ty][tx] = inside
      ? static_cast<float>(coeffs[row * w + col]) * s_q[ty * 8 + xi]
      : 0.0f;
  __syncthreads();

  // Vertical pass: t[y][v] = sum_u D[u][y] * c[u][v].
  float acc = 0.0f;
#pragma unroll
  for (int u = 0; u < 8; ++u) acc = fmaf(s_d[u * 8 + ty], s_c[u][tx], acc);
  s_t[ty][tx] = acc;
  __syncthreads();

  // Horizontal pass: out[y][x] = sum_v t[y][v] * D[v][x], then +128.
  const int x0 = tx & ~7;
  acc = 0.0f;
#pragma unroll
  for (int v = 0; v < 8; ++v) acc = fmaf(s_t[ty][x0 + v], s_d[v * 8 + xi], acc);
  if (inside) out[row * w + col] = acc + 128.0f;
}

}  // namespace

extern "C" int jt_idct8(const void* coeffs, const void* qtab, const void* basis,
                        void* out, int h, int w, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  const dim3 block(kTileW, 8);
  const dim3 grid((w + kTileW - 1) / kTileW, h / 8);
  idct8_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(coeffs), static_cast<const float*>(qtab),
      static_cast<const float*>(basis), static_cast<float*>(out), h, w);
  return static_cast<int>(cudaGetLastError());
}
