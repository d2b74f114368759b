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
// Design: a thread block covers one 8-row band, 32 columns wide (four 8x8
// blocks, 256 threads, one coefficient each). Each thread loads one sample
// and shifts it by -128 (a warp reads 128 contiguous bytes of a row), the
// vertical 8-tap pass writes a padded shared-memory tile, and the
// horizontal 8-tap pass reads it back. The quotient is a true IEEE division
// (__fdiv_rn: a reciprocal multiply can differ by an ulp at .5 boundaries,
// as fused.py insists), then round half away from zero, stored as int32.
// D (dct_basis()) and the quant table (raster, row = vertical frequency)
// sit in shared memory. A ragged right edge (W not a multiple of 32) is
// masked; H is a multiple of 8.
//
// Bound on the H100: memory. Per sample it reads 4 bytes and writes 4 and
// does 16 FMAs and one division, far below the card's ratio of FLOPs to
// bytes, so the design goal is coalesced loads and stores and a single pass
// over the plane. Fusing the colour map and chroma downsample in front, or
// storing int16, would cut the bytes further.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;  // columns per thread block (four 8x8 blocks)

__global__ void __launch_bounds__(kTileW * 8)
dct8_kernel(const float* __restrict__ plane, const float* __restrict__ qtab,
            const float* __restrict__ basis, int32_t* __restrict__ out, int h,
            int w) {
  __shared__ float s_d[64];
  __shared__ float s_q[64];
  __shared__ float s_x[8][kTileW + 1];
  __shared__ float s_t[8][kTileW + 1];

  const int tx = threadIdx.x;  // column within the tile
  const int ty = threadIdx.y;  // row within the band
  const int lin = ty * kTileW + tx;
  if (lin < 64) {
    s_d[lin] = basis[lin];
    s_q[lin] = qtab[lin];
  }

  const long row = static_cast<long>(blockIdx.y) * 8 + ty;
  const int col = blockIdx.x * kTileW + tx;
  const bool inside = col < w;
  s_x[ty][tx] = inside ? plane[row * w + col] - 128.0f : 0.0f;
  __syncthreads();

  // Vertical pass: t[u][x] = sum_y D[u][y] * x[y][x], with u = ty.
  float acc = 0.0f;
#pragma unroll
  for (int y = 0; y < 8; ++y) acc = fmaf(s_d[ty * 8 + y], s_x[y][tx], acc);
  s_t[ty][tx] = acc;
  __syncthreads();

  // Horizontal pass: c[u][v] = sum_x t[u][x] * D[v][x], with v = tx & 7.
  const int v = tx & 7;
  const int x0 = tx & ~7;
  acc = 0.0f;
#pragma unroll
  for (int x = 0; x < 8; ++x) acc = fmaf(s_t[ty][x0 + x], s_d[v * 8 + x], acc);
  const float s = __fdiv_rn(acc, s_q[ty * 8 + v]);
  const float r = copysignf(floorf(fabsf(s) + 0.5f), s);
  if (inside) out[row * w + col] = static_cast<int32_t>(r);
}

}  // namespace

extern "C" int jt_dct8(const void* plane, const void* qtab, const void* basis,
                       void* out, int h, int w, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  const dim3 block(kTileW, 8);
  const dim3 grid((w + kTileW - 1) / kTileW, h / 8);
  dct8_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(plane), static_cast<const float*>(qtab),
      static_cast<const float*>(basis), static_cast<int32_t*>(out), h, w);
  return static_cast<int>(cudaGetLastError());
}
