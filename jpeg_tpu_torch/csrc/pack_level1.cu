// Huffman packer, level 1: zig-zag coefficient blocks -> per-block bit words.
//
// Replaces the Pallas TPU kernel jpeg_tpu/ops/pack_pallas.py `_kernel`
// (pallas_call at :237, wrapper pack_level1_pallas). That kernel exists in
// the shape it has because a TPU has no cheap gather and no scalar bit loop:
// it finds AC zero runs by a lane cummax, looks Huffman codes up as one-hot
// MXU dots and places every record with one prefix sum and a one-hot word
// reduction. A GPU thread can walk a block's 64 coefficients in order and
// read the code tables directly, so this kernel does exactly that.
//
// Design: one thread per 8x8 block, 128 blocks per thread block.
// - The tile's (128, 64) int32 coefficients are staged through shared memory
//   with coalesced loads; rows are padded to 65 words so the per-thread row
//   walk is bank-conflict free.
// - The (2, 256) DC and AC code tables live in shared memory, packed as
//   code << 5 | length.
// - Records are appended MSB-first to a 64-bit accumulator; each full 32-bit
//   word is stored as it completes. Emission order per block: DC, then for
//   each nonzero AC its ZRLs (one per 16 zeros of run) and its (run, size)
//   code + amplitude, then EOB unless coefficient 63 is nonzero.
// - The ragged tail (B not a multiple of 128) is masked here; nothing is
//   padded.
//
// Output contract (held against the Pallas kernel): per-block bit totals
// equal for every block; the (B, 10) words equal for every block of at most
// 288 bits (9 words, the level-2 `ok` bound). Longer blocks keep their first
// 10 words and drop the rest, so only their totals are meaningful; level 2
// then reports ok=False and the encoder host-packs.
//
// Bound on the H100: memory. Each block reads 256 bytes and writes 44, and a
// thread does ~64 cheap steps, so the kernel should run near the bandwidth
// of its 300 bytes per block. Warp divergence from blocks of unequal density
// is the cost this simple form accepts; warp-parallel emission is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 10;    // BLOCK_WORDS + 1
constexpr int kThreads = 128; // blocks per thread block
constexpr int kStride = 65;   // shared-memory row stride in words

__device__ __forceinline__ int bit_size(int v) {
  // Magnitude category, capped at 12 like the Pallas kernel's 12 thresholds.
  unsigned mag = v < 0 ? 0u - static_cast<unsigned>(v) : static_cast<unsigned>(v);
  int s = 32 - __clz(mag);
  return s < 12 ? s : 12;
}

__device__ __forceinline__ uint32_t amp_bits(int v, int size) {
  int a = v >= 0 ? v : v + (1 << size) - 1;
  return static_cast<uint32_t>(a) & ((1u << size) - 1u);
}

struct BitWriter {
  uint32_t* out;  // this block's kWords output words
  unsigned long long acc;
  int nacc;       // bits held in acc (< 32 between calls)
  int word;       // next output word index
  int total;      // bits emitted

  __device__ __forceinline__ void put(uint32_t bits, int n) {
    if (n <= 0) return;
    if (n < 32) bits &= (1u << n) - 1u;
    acc = (acc << n) | bits;
    nacc += n;
    total += n;
    if (nacc >= 32) {
      nacc -= 32;
      if (word < kWords) out[word] = static_cast<uint32_t>(acc >> nacc);
      ++word;
      acc &= (1ull << nacc) - 1ull;
    }
  }

  __device__ __forceinline__ void flush() {
    if (nacc > 0) {
      if (word < kWords) out[word] = static_cast<uint32_t>(acc << (32 - nacc));
      ++word;
    }
    for (; word < kWords; ++word) out[word] = 0u;
  }
};

__global__ void __launch_bounds__(kThreads)
pack_level1_kernel(const int32_t* __restrict__ blocks,
                   const int32_t* __restrict__ tbl,
                   const int32_t* __restrict__ dc_code,
                   const int32_t* __restrict__ dc_len,
                   const int32_t* __restrict__ ac_code,
                   const int32_t* __restrict__ ac_len,
                   uint32_t* __restrict__ buf,
                   int32_t* __restrict__ totals,
                   long nblocks) {
  __shared__ int32_t s_coef[kThreads * kStride];
  __shared__ uint32_t s_dc[512];
  __shared__ uint32_t s_ac[512];

  for (int i = threadIdx.x; i < 512; i += kThreads) {
    s_dc[i] = (static_cast<uint32_t>(dc_code[i]) << 5) | (dc_len[i] & 31);
    s_ac[i] = (static_cast<uint32_t>(ac_code[i]) << 5) | (ac_len[i] & 31);
  }
  const long first = static_cast<long>(blockIdx.x) * kThreads;
  const long remaining = nblocks - first;
  const int nb = remaining < kThreads ? static_cast<int>(remaining) : kThreads;
  const int32_t* src = blocks + first * 64;
  for (int i = threadIdx.x; i < nb * 64; i += kThreads) {
    s_coef[(i >> 6) * kStride + (i & 63)] = src[i];
  }
  __syncthreads();

  const int t = threadIdx.x;
  if (t >= nb) return;
  const long b = first + t;
  const int32_t* c = s_coef + t * kStride;
  const int tb = tbl[b] != 0 ? 256 : 0;

  BitWriter w{buf + b * kWords, 0ull, 0, 0, 0};

  // DC (already DPCM'd): (size) code + amplitude.
  {
    const int v = c[0];
    const int size = bit_size(v);
    const uint32_t e = s_dc[tb + size];
    w.put(((e >> 5) << size) | amp_bits(v, size), static_cast<int>(e & 31) + size);
  }
  // AC: ZRLs for each full 16-zero run, then (run, size) code + amplitude.
  const uint32_t zrl = s_ac[tb + 0xF0];
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    const int v = c[k];
    if (v == 0) {
      ++run;
      continue;
    }
    for (; run >= 16; run -= 16) w.put(zrl >> 5, static_cast<int>(zrl & 31));
    const int size = bit_size(v);
    const uint32_t e = s_ac[tb + (run << 4) + size];
    w.put(((e >> 5) << size) | amp_bits(v, size), static_cast<int>(e & 31) + size);
    run = 0;
  }
  if (c[63] == 0) {
    const uint32_t eob = s_ac[tb];
    w.put(eob >> 5, static_cast<int>(eob & 31));
  }
  w.flush();
  totals[b] = w.total;
}

}  // namespace

extern "C" int jt_pack_level1(const void* blocks, const void* tbl,
                              const void* dc_code, const void* dc_len,
                              const void* ac_code, const void* ac_len,
                              void* buf, void* totals, long nblocks,
                              void* stream) {
  if (nblocks <= 0) return 0;
  const long grid = (nblocks + kThreads - 1) / kThreads;
  pack_level1_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(blocks), static_cast<const int32_t*>(tbl),
      static_cast<const int32_t*>(dc_code), static_cast<const int32_t*>(dc_len),
      static_cast<const int32_t*>(ac_code), static_cast<const int32_t*>(ac_len),
      static_cast<uint32_t*>(buf), static_cast<int32_t*>(totals), nblocks);
  return static_cast<int>(cudaGetLastError());
}
