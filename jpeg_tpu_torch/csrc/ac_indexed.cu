// AC Huffman decode at known block starts (kernel D).
//
// Counterpart of the jitted program jpeg_tpu/entropy/decode_device.py
// `_decode_ac_indexed` (:179; XLA in the reference, not Pallas). In: the
// destuffed scan as big-endian words, and per block (component-major scan
// order) the bit offset just past its DC code, its absolute DC and its AC
// table slot. Out: (B, 64) int32 zig-zag rows, row[0] = DC. Blocks are
// independent because their starts are known.
//
// The reference's shape answers a TPU: a 64-word tile gathered per block, the
// window picked by a one-hot select over its lanes, the code length found by
// 16 compares against the canonical tables, the symbol read by an MXU dot,
// every block stepping in lockstep until the slowest one is done. A GPU
// thread can index memory and leave its loop, so here one thread walks one
// block: a 32-bit window from two cached words (a code and its amplitude are
// at most 31 bits), one table lookup per symbol (huff_decode.cuh), the loop
// ending at EOB, at k >= 64, or at a window that starts no code (the index
// pass has validated the stream; such a window ends the block as it does in
// the reference). ZRL adds 16 to k; a coefficient past 63 is dropped.
//
// Bound on the H100: by bytes on paper (256 bytes out per block, 49.8 MB for
// the 194,400 blocks of a 3840x2160 4:2:0 image, against ~2.2 MB in), but the
// time is the walk's: a chain of dependent lookups per symbol, and a warp
// as slow as its densest block. The design keeps each step short (the window
// in registers, the tables' 2 KB first levels hot in L1) and the stores
// coalesced: a thread block of kTile threads stages its kTile rows in a
// shared tile (row stride 65 words, so the threads' scattered writes hit
// distinct banks) that was zeroed cooperatively, and then writes the tile,
// which is contiguous in the output, in order, 128 bytes per warp and store.
//
// The first levels are read where they lie, through the read-only path, and
// not copied to shared memory per thread block: a thread block here
// lives for a few microseconds, and 8 KB of table per block cost more
// than they saved. Measured in turns (kernel_compare.py, two runs, NVIDIA
// H100 80GB HBM3, 700 W, kernel only, L2 cold, the 194,400 blocks of the 4K
// q75 image): with the copy 76.8 / 43.5 / 37.1 / 31.9 / 27.6 / 29.6 us at
// tiles of 32 / 64 / 96 / 128 / 256 / 512 blocks; without it 25.6 / 25.3 /
// 25.2 us at 96 / 128 / 256. -DJT_D_TILE=n builds another tile.

#include "huff_decode.cuh"

#ifndef JT_HOST_STANDIN
#include <cuda_runtime.h>
#endif

#ifndef JT_D_TILE
#define JT_D_TILE 128
#endif

namespace jt {

// One block's AC walk from bit `pos` into `row` (64 zeroed words).
__device__ __forceinline__ void ac_block(BitReader& r, int pos, int dc,
                                         const int32_t* first,
                                         const int32_t* full, int32_t* row) {
  row[0] = dc;
  int k = 1;
  while (k < 64) {  // k grows by at least 1 per step
    const uint32_t win = r.window(pos);
    const int32_t e = lookup(first, full, win >> 16);
    const int sym = sym_of(e);
    if (sym <= 0) break;  // EOB, or a window that starts no code
    const int len = len_of(e), size = sym & 15;
    pos += len + size;
    if (sym == 0xF0) {
      k += 16;
      continue;
    }
    k += sym >> 4;
    if (k <= 63) row[k] = extend(amp_bits(win, len, size), size);
    ++k;
  }
}

}  // namespace jt

#ifndef JT_HOST_STANDIN

namespace {

constexpr int kTile = JT_D_TILE;  // blocks per tile = threads per thread block
constexpr int kStride = 65;  // shared row stride in words
static_assert(kTile * kStride * 4 <= 48 * 1024, "dynamic shared memory");

__global__ void __launch_bounds__(kTile)
ac_indexed_kernel(const uint32_t* __restrict__ words, int nwords,
                  const int32_t* __restrict__ off,
                  const int32_t* __restrict__ dc,
                  const int32_t* __restrict__ slot,
                  const int32_t* __restrict__ tables, int nslots,
                  int32_t* __restrict__ rows, long nblocks) {
  extern __shared__ int32_t s_tile[];  // kTile x kStride

  const int tid = threadIdx.x;
  const long first = static_cast<long>(blockIdx.x) * kTile;
  const long remaining = nblocks - first;
  const int nb = remaining < kTile ? static_cast<int>(remaining) : kTile;

  for (int i = tid; i < kTile * kStride; i += kTile) s_tile[i] = 0;
  __syncthreads();

  if (tid < nb) {
    const long b = first + tid;
    int s = slot[b];
    s = s < 0 ? 0 : (s >= nslots ? nslots - 1 : s);
    const int32_t* full = tables + static_cast<long>(s) * jt::kSlotStride;
    jt::BitReader r(words, nwords);
    jt::ac_block(r, off[b], dc[b], full + jt::kFullSize, full,
                 s_tile + tid * kStride);
  }
  __syncthreads();

  int32_t* dst = rows + first * 64;
  for (int j = tid; j < nb * 64; j += kTile) {
    dst[j] = s_tile[(j >> 6) * kStride + (j & 63)];
  }
}

}  // namespace

extern "C" int jt_ac_indexed(const void* words, int nwords, const void* off,
                             const void* dc, const void* slot,
                             const void* tables, int nslots, void* rows,
                             long nblocks, void* stream) {
  if (nblocks <= 0) return 0;
  if (nslots < 1 || nslots > jt::kMaxSlots) return cudaErrorInvalidValue;
  const long grid = (nblocks + kTile - 1) / kTile;
  const size_t shared = sizeof(int32_t) * kTile * kStride;
  ac_indexed_kernel<<<static_cast<unsigned>(grid), kTile, shared,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), nwords,
      static_cast<const int32_t*>(off), static_cast<const int32_t*>(dc),
      static_cast<const int32_t*>(slot), static_cast<const int32_t*>(tables),
      nslots, static_cast<int32_t*>(rows), nblocks);
  return static_cast<int>(cudaGetLastError());
}

#endif  // JT_HOST_STANDIN
