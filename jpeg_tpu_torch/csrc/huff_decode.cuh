// Shared pieces of the device Huffman decoders (ac_indexed.cu,
// prefix_index.cu): the bit reader, the table lookup and the amplitude
// arithmetic. A thread walks its own bits; nothing here is
// cooperative, so the same code compiles for the host when JT_HOST_STANDIN is
// defined (the CPU tests run the kernels' per-thread bodies that way).
//
// Bit stream: the destuffed scan as big-endian 32-bit words; bit 0 is the
// top bit of word 0. A read past the last word gives zeros, so no cursor can
// leave the buffer.
//
// Tables: one int32 row of kSlotStride entries per Huffman table ("slot").
// The first kFullSize entries are indexed by a left-aligned 16-bit window:
// (code length << 16) | (symbol & 0xFFFF); a window that starts no code holds
// length 16 and symbol -1, so a corrupt stream always advances. The last
// kFirstSize entries are a first level indexed by the window's top
// kFirstBits bits: the same entry when the code is that short, else 0 (no
// full entry is 0). The first levels (2 KB per table) stay hot in L1; the
// 256 KB full table in L2 is read only for the rare long codes.

#pragma once

#include <cstdint>

namespace jt {

constexpr int kFullSize = 1 << 16;
constexpr int kFirstBits = 9;
constexpr int kFirstSize = 1 << kFirstBits;
constexpr int kSlotStride = kFullSize + kFirstSize;
constexpr int kMaxSlots = 8;  // 4 DC + 4 AC table ids (T.81 B.2.4.2)
constexpr uint32_t kErrBit = 0x80000000u;

struct BitReader {
  const uint32_t* words;
  int nwords;
  int wi;  // index of the word held in w0 (w1 is the next one)
  uint32_t w0, w1;

  __device__ __forceinline__ BitReader(const uint32_t* w, int n)
      : words(w), nwords(n), wi(-2), w0(0u), w1(0u) {}

  __device__ __forceinline__ uint32_t load(int i) const {
    return (i >= 0 && i < nwords) ? words[i] : 0u;
  }

  // The 32 bits that start at bit `pos`.
  __device__ __forceinline__ uint32_t window(int pos) {
    const int i = pos >> 5;
    if (i != wi) {
      w0 = (i == wi + 1) ? w1 : load(i);
      w1 = load(i + 1);
      wi = i;
    }
    const int sh = pos & 31;
    return sh ? (w0 << sh) | (w1 >> (32 - sh)) : w0;
  }
};

__device__ __forceinline__ int32_t lookup(const int32_t* first,
                                          const int32_t* full, uint32_t w16) {
  const int32_t e = first[w16 >> (16 - kFirstBits)];
  return e != 0 ? e : full[w16];
}

__device__ __forceinline__ int sym_of(int32_t e) {
  return static_cast<int>(static_cast<int16_t>(e & 0xFFFF));
}

__device__ __forceinline__ int len_of(int32_t e) { return e >> 16; }

// The `size` bits that follow the first `len` bits of a 32-bit window
// (len + size <= 32).
__device__ __forceinline__ uint32_t amp_bits(uint32_t win, int len, int size) {
  return size ? (win << len) >> (32 - size) : 0u;
}

// T.81 F.2.2.1 EXTEND; size 0 gives 0.
__device__ __forceinline__ int extend(uint32_t amp, int size) {
  if (size == 0) return 0;
  return amp < (1u << (size - 1)) ? static_cast<int>(amp) - (1 << size) + 1
                                  : static_cast<int>(amp);
}

__device__ __forceinline__ int min_int(int a, int b) { return a < b ? a : b; }

}  // namespace jt
