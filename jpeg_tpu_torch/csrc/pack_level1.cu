// Huffman packer, level 1: zig-zag coefficient blocks -> per-block bit words.
//
// Replaces the Pallas TPU kernel jpeg_tpu/ops/pack_pallas.py `_kernel`
// (pallas_call at :237, wrapper pack_level1_pallas). That kernel exists in
// the shape it has because a TPU has no cheap gather and no scalar bit loop:
// it finds AC zero runs by a lane cummax, looks Huffman codes up as one-hot
// MXU dots and places every record with one prefix sum and a one-hot word
// reduction, all of it over every one of the 64 positions of every block.
//
// Bound on the H100: memory. A block is 256 bytes of coefficients and a
// 4-byte table id in, 10 words and a 4-byte bit total out: 304 bytes, 59.1 MB
// for the 194,400 blocks of a 3840x2160 4:2:0 image, 17.6 us at 3.35 TB/s.
// The work per block is a few hundred integer instructions at most, so the
// design has to keep the loads wide and in flight, the stores coalesced, and
// the instruction count proportional to the nonzero coefficients, which are
// few (4.4 of 64 per block at q75, 23.8 at q95 on that image).
//
// Design: a thread block of 96 threads takes a tile of 96 8x8 blocks
// through three phases, with one __syncthreads() between each.
// 1. Load. The tile is 24 KB of contiguous coefficients. Every thread starts
//    its 16 loads of 16 bytes (thread i takes the tile's int4 number i,
//    i + 96, ...: neighbouring threads on neighbouring addresses, a warp on
//    four whole 128-byte lines) before it uses any, 256 bytes in flight per
//    thread. Each int4 goes to shared memory as it is (rows padded to 68
//    words: 16-byte aligned and conflict-free for the 16-byte stores), and
//    its four "is nonzero" bits go beside it as one byte. The packed code
//    tables (code << 5 | length, 4 KB, built once per table set on the
//    host) are copied to shared memory by 16-byte loads.
// 2. Emit. One thread per block reads its block's 16 nibble bytes (one
//    16-byte load), squeezes them into the 64-bit nonzero mask and walks
//    the mask's set bits (__ffs, m &= m - 1, 32 bits at a time), so it
//    spends instructions on nonzero coefficients only; a zero run is the
//    distance between two set bits. For each it emits the run's ZRLs and
//    the (run, size) code with the amplitude into a 64-bit accumulator,
//    MSB first; each completed 32-bit word goes into the
//    thread's own row of the shared tile, over coefficients it has already
//    read (word w completes only after more than w coefficients are behind:
//    a record has at most 28 bits, a ZRL 16 bits per 16 positions). Then EOB
//    unless coefficient 63 is nonzero, the flush, and zero fill to 10 words.
//    A warp takes as long as its densest block, but that is now tens of
//    steps of the few nonzeros, not 63 steps of every position.
// 3. Store. The tile's 96 x 10 words are contiguous in the output; the
//    thread block writes them in order, a warp 128 contiguous bytes per
//    store. Totals are one coalesced 4-byte store per thread.
// The ragged tail (B not a multiple of 96) is masked in every phase; no
// thread leaves before the last barrier. A tile of 96 measured 5% faster
// than one of 128 and 3% faster than one of 64 (31 KB of shared memory, 7
// thread blocks per SM); -DJT_TILE=n builds another size.
//
// A warp-cooperative emission (a warp per block, every lane two positions,
// masks by __reduce_or_sync, runs by __clzll, records placed by a prefix sum
// and atomicOr into shared words, lanes 0-9 storing the 40-byte run) was
// written and measured beside this one in one run: 69.1 us at q75 and
// 72.6 us at q95, against 26.6 us and 41.2 us for this kernel and 37.5 us
// and 53.2 us for the one-thread-per-block kernel before it (NVIDIA H100
// 80GB HBM3, 700 W; kernel_compare.py, kernel-only, L2 cold). It runs
// several times the instructions per block, because every lane works on its
// positions whether they are zero or not, and a block has 64 positions but
// 4 to 24 nonzeros. Two more variants of this kernel were measured and
// dropped: sorting a tile's blocks by nonzero count so that a warp's lanes
// finish together (slower: the tile still waits for its densest block), and
// a persistent thread block that copies the next tile with cp.async while
// it emits this one (slower, most at q95: two tiles of shared memory halve
// the resident warps, and the emit phase is a chain of dependent steps per
// nonzero whose latency only more warps hide). So this kernel is at about
// two thirds of its bound on the sparse image and 0.43 of it on the dense
// one; what holds it there is the 272 bytes of shared memory per block that
// limit an SM to 21 warps. PERF.md section 6 has the table.
//
// TMA, wgmma and clusters are not used on purpose: there is no matrix
// product here, and plain 16-byte loads with 256 bytes in flight per thread
// keep the memory busy without a barrier protocol.
//
// Output contract (held against the Pallas kernel): per-block bit totals
// equal for every block; the (B, 10) words equal for every block of at most
// 288 bits (9 words, the level-2 `ok` bound). Longer blocks keep their first
// 10 words and drop the rest (never wrapped into another block's words), so
// only their totals are meaningful; level 2 then reports ok=False and the
// encoder host-packs. The magnitude category is capped at 12; a table id
// other than 0 selects table 1.

#include <cstdint>
#include <cuda_runtime.h>

#ifndef JT_TILE
#define JT_TILE 96
#endif

namespace {

constexpr int kWords = 10;      // BLOCK_WORDS + 1
constexpr int kTile = JT_TILE;  // 8x8 blocks per tile = threads per thread block
static_assert(kTile % 16 == 0, "a step of the load loop covers whole 8x8 blocks");
static_assert(kTile * 68 * 4 + 4096 + kTile * 16 <= 48 * 1024, "static shared memory");
constexpr int kStride = 68;  // shared-memory row stride in words
constexpr int kVec = 16;     // int4 per 8x8 block = int4 loads per thread

__device__ __forceinline__ int bit_size(int v) {
  // Magnitude category, capped at 12 like the Pallas kernel's 12 thresholds.
  unsigned mag = v < 0 ? 0u - static_cast<unsigned>(v) : static_cast<unsigned>(v);
  int s = 32 - __clz(mag);
  return s < 12 ? s : 12;
}

__device__ __forceinline__ uint32_t amp_bits(int v, int size) {
  // v for v >= 0, v + 2^size - 1 for v < 0, in `size` bits: v - 1 has the
  // same low bits.
  return static_cast<uint32_t>(v + (v >> 31)) & ((1u << size) - 1u);
}

// Four bytes with a nibble in the low half of each -> the 16 bits in order.
__device__ __forceinline__ uint32_t squeeze_nibbles(uint32_t x) {
  x = (x | (x >> 4)) & 0x00FF00FFu;
  return (x | (x >> 8)) & 0xFFFFu;
}

struct BitWriter {
  uint32_t* out;  // this block's kWords output words
  unsigned long long acc;  // the last 64 bits appended; the low nacc pending
  int nacc;       // bits of acc not yet stored (< 32 between calls)
  int word;       // next output word index

  // Append the low n bits of `bits` (n <= 28, higher bits clear). Bits
  // already stored stay in acc above the pending ones until they shift out:
  // a store takes the 32 bits above the new nacc, and nacc + 32 <= 63.
  __device__ __forceinline__ void put(uint32_t bits, int n) {
    acc = (acc << n) | bits;
    nacc += n;
    if (nacc >= 32) {
      nacc -= 32;
      if (word < kWords) out[word] = static_cast<uint32_t>(acc >> nacc);
      ++word;
    }
  }

  __device__ __forceinline__ int total() const { return 32 * word + nacc; }

  __device__ __forceinline__ void flush() {
    if (nacc > 0) {
      if (word < kWords) out[word] = static_cast<uint32_t>(acc << (32 - nacc));
      ++word;
    }
    for (; word < kWords; ++word) out[word] = 0u;
  }
};

__global__ void __launch_bounds__(kTile)
pack_level1_kernel(const int32_t* __restrict__ blocks,
                   const int32_t* __restrict__ tbl,
                   const uint32_t* __restrict__ tables,
                   uint32_t* __restrict__ buf,
                   int32_t* __restrict__ totals,
                   long nblocks) {
  __shared__ __align__(16) int32_t s_coef[kTile * kStride];
  __shared__ __align__(16) uint32_t s_tab[1024];  // [is_ac][table id][symbol]
  __shared__ __align__(16) uint8_t s_nib[kTile * kVec];  // 4 nonzero bits each

  const int tid = threadIdx.x;
  const long first = static_cast<long>(blockIdx.x) * kTile;
  const long remaining = nblocks - first;
  const int nb = remaining < kTile ? static_cast<int>(remaining) : kTile;

  // Phase 1: all loads first, then tile and masks into shared memory.
  const int4* src = reinterpret_cast<const int4*>(blocks + first * 64);
  const int nvec = nb * kVec;
  int4 v[kVec];
#pragma unroll
  for (int m = 0; m < kVec; ++m) {
    const int j = tid + kTile * m;
    v[m] = j < nvec ? __ldg(src + j) : make_int4(0, 0, 0, 0);
  }
  const int my_tbl = tid < nb ? __ldg(tbl + first + tid) : 0;
#pragma unroll
  for (int i = tid; i < 256; i += kTile) {
    reinterpret_cast<uint4*>(s_tab)[i] =
        __ldg(reinterpret_cast<const uint4*>(tables) + i);
  }
  const int part = tid & 15;  // which int4 of its 8x8 block a thread holds
#pragma unroll
  for (int m = 0; m < kVec; ++m) {
    const int blk = (tid >> 4) + (kTile / kVec) * m;
    *reinterpret_cast<int4*>(s_coef + blk * kStride + 4 * part) = v[m];
    s_nib[blk * kVec + part] = static_cast<uint8_t>(
        (v[m].x != 0 ? 1u : 0u) | (v[m].y != 0 ? 2u : 0u) |
        (v[m].z != 0 ? 4u : 0u) | (v[m].w != 0 ? 8u : 0u));
  }
  __syncthreads();

  // Phase 2: one thread per block, one step per nonzero coefficient.
  if (tid < nb) {
    int32_t* row = s_coef + tid * kStride;
    const uint4 nib = *reinterpret_cast<const uint4*>(s_nib + tid * kVec);
    const uint32_t mask_lo = squeeze_nibbles(nib.x) | (squeeze_nibbles(nib.y) << 16);
    const uint32_t mask_hi = squeeze_nibbles(nib.z) | (squeeze_nibbles(nib.w) << 16);
    const uint32_t* dc_tab = s_tab + (my_tbl != 0 ? 256 : 0);
    const uint32_t* ac_tab = dc_tab + 512;

    BitWriter w{reinterpret_cast<uint32_t*>(row), 0ull, 0, 0};
    {
      // DC (already DPCM'd): (size) code + amplitude.
      const int c = row[0];
      const int size = bit_size(c);
      const uint32_t e = dc_tab[size];
      w.put(((e >> 5) << size) | amp_bits(c, size),
            static_cast<int>(e & 31) + size);
    }
    // AC: ZRLs for each full 16-zero run, then (run, size) code + amplitude.
    const uint32_t zrl = ac_tab[0xF0];
    int prev = 0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      for (uint32_t m = half == 0 ? mask_lo & ~1u : mask_hi; m != 0; m &= m - 1) {
        const int k = 32 * half + __ffs(static_cast<int>(m)) - 1;
        const int c = row[k];
        int run = k - prev - 1;
        prev = k;
        for (; run >= 16; run -= 16) w.put(zrl >> 5, static_cast<int>(zrl & 31));
        const int size = bit_size(c);
        const uint32_t e = ac_tab[(run << 4) + size];
        w.put(((e >> 5) << size) | amp_bits(c, size),
              static_cast<int>(e & 31) + size);
      }
    }
    if ((mask_hi >> 31) == 0) {
      const uint32_t eob = ac_tab[0];
      w.put(eob >> 5, static_cast<int>(eob & 31));
    }
    totals[first + tid] = w.total();
    w.flush();
  }
  __syncthreads();

  // Phase 3: the tile's words, contiguous in the output, in order.
  uint32_t* dst = buf + first * kWords;
  for (int j = tid; j < nb * kWords; j += kTile) {
    const int blk = j / kWords;
    dst[j] = static_cast<uint32_t>(s_coef[blk * kStride + (j - blk * kWords)]);
  }
}

}  // namespace

extern "C" int jt_pack_level1(const void* blocks, const void* tbl,
                              const void* tables, void* buf, void* totals,
                              long nblocks, void* stream) {
  if (nblocks <= 0) return 0;
  const long grid = (nblocks + kTile - 1) / kTile;
  pack_level1_kernel<<<static_cast<unsigned>(grid), kTile, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(blocks), static_cast<const int32_t*>(tbl),
      static_cast<const uint32_t*>(tables), static_cast<uint32_t*>(buf),
      static_cast<int32_t*>(totals), nblocks);
  return static_cast<int>(cudaGetLastError());
}
