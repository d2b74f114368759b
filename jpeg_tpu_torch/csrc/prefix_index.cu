// Block starts of a scan with no restart markers (program F).
//
// Counterpart of the jitted program jpeg_tpu/entropy/decode_device.py
// `_jit_prefix_index` (:866; XLA in the reference, not Pallas), with its
// contract: from the unstuffed bytes and the MCU's block sequence, every
// block's AC bit offset and DC difference in (MCU, block of the MCU) order,
// the position after the last MCU, and one error flag; exact, not
// speculative. Huffman codes do not self-synchronize, so where block n+1
// starts is known only once block n is decoded. The way around the serial
// chain is to compute "where does a block that starts HERE end" for every bit
// position at once, and then to compose those steps.
//
// The reference tabulates one SYMBOL per bit position, pointer-doubles symbols
// over six levels and descends to a block end, because a TPU cannot walk. A
// GPU thread can, so here:
//   1. jt_prefix_block_ends: one thread per bit position and table class
//      walks the one block that would start there (DC code and amplitude,
//      then AC symbols to EOB or k >= 64; at most 64 symbols) and stores its
//      end position, with an error bit on top;
//   2. jt_prefix_mcu_hop: one thread per position chains the block ends
//      through the MCU's sequence: where an MCU that starts here ends;
//   3. jt_prefix_double, once per level: J <- J o J over all positions (a
//      jump of 2^j MCUs becomes one of 2^(j+1)), and in the same launch the
//      known MCU starts double: start[m + 2^j] = J[start[m]] for m < 2^j.
//      ceil(log2(MCUs)) launches, no table kept but two;
//   4. jt_prefix_replay: one thread per MCU replays its blocks from its
//      start for the AC offsets and DC differences, ORs the error bits of the
//      blocks on the path and stores the end position.
// Garbage decoded from positions where no block starts sets no flag: only
// step 4 reads error bits, and only on the path.
//
// Error rule, as the reference (:941-947): a window that starts no code (a DC
// symbol above 16 counts as none) advances 16 bits and flags; a block whose
// last symbol takes k past 64 without EOB flags (ZRL included). Positions are
// clamped to the last bit of the buffer, whose tail is a zero guard.
//
// Bound on the H100: by bytes on paper (the scan in, 8 bytes per block out),
// in fact by the walks of step 1 (one per bit position: 5.1 M for a
// 3840x2160 q75 4:2:0 scan, times the table classes) and the 2 x 4 bytes per
// position of every doubling level. The tables' first levels are read where
// they lie (2 KB each, hot in L1): a copy to shared memory per thread block,
// as kernel E makes, cost step 1 more than it saved (269.8 us against 240.8
// without, in turns in one run of kernel_compare.py on those 5.1 M positions;
// NVIDIA H100 80GB HBM3, 700 W, kernel only).

#include "huff_decode.cuh"

#ifndef JT_HOST_STANDIN
#include <cuda_runtime.h>
#endif

namespace jt {

constexpr uint32_t kPosMask = 0x7FFFFFFFu;

// End of the block that starts at bit p, | kErrBit.
__device__ __forceinline__ uint32_t block_end(BitReader& r, int p, int nbits,
                                              const int32_t* dc_first,
                                              const int32_t* dc_full,
                                              const int32_t* ac_first,
                                              const int32_t* ac_full) {
  const int last = nbits - 1;
  uint32_t err = 0u;
  uint32_t win = r.window(p);
  int32_t e = lookup(dc_first, dc_full, win >> 16);
  int sym = sym_of(e);
  int adv = len_of(e) + sym;
  if (sym < 0 || sym > 16) {
    err = kErrBit;
    adv = 16;
  }
  int q = min_int(p + adv, last);
  int k = 1;
  for (int it = 0; it < 64; ++it) {
    win = r.window(q);
    e = lookup(ac_first, ac_full, win >> 16);
    sym = sym_of(e);
    if (sym < 0) {
      err = kErrBit;
      q = min_int(q + 16, last);
      continue;
    }
    q = min_int(q + len_of(e) + (sym & 15), last);
    if (sym == 0) break;
    const int kinc = sym == 0xF0 ? 16 : (sym >> 4) + 1;
    if (k + kinc > 63) {  // the closing symbol
      if (k + kinc > 64) err = kErrBit;
      break;
    }
    k += kinc;
  }
  return static_cast<uint32_t>(q) | err;
}

// Where the MCU that starts at bit p ends. fb: (classes, nbits) block ends.
__device__ __forceinline__ uint32_t mcu_end(const uint32_t* fb, int p,
                                            int nbits, const int32_t* seq,
                                            int bpm) {
  int cur = p;
  for (int bi = 0; bi < bpm; ++bi) {
    const uint32_t v =
        fb[static_cast<long>(seq[3 * bi + 2]) * nbits + min_int(cur, nbits - 1)];
    cur = static_cast<int>(v & kPosMask);
  }
  return static_cast<uint32_t>(cur);
}

// One level for index t: compose the jump table and extend the starts.
__device__ __forceinline__ void double_step(const uint32_t* jin, uint32_t* jout,
                                            int32_t* starts, long t, int nbits,
                                            long half, long n_mcu,
                                            int compose) {
  const int last = nbits - 1;
  if (compose && t < nbits) {
    jout[t] = jin[min_int(static_cast<int>(jin[t]), last)];
  }
  if (t < half && t + half < n_mcu) {
    starts[t + half] = static_cast<int32_t>(jin[min_int(starts[t], last)]);
  }
}

// MCU m: its blocks' AC offsets and DC differences; true if a block on the
// path carries an error bit. The last MCU stores the end position.
__device__ __forceinline__ bool replay_mcu(
    const uint32_t* words, int nwords, const uint32_t* fb,
    const int32_t* starts, long m, long n_mcu, const int32_t* seq, int bpm,
    const int32_t* tables, int32_t* ac_off, int32_t* diff, int32_t* status) {
  const int nbits = nwords * 32;
  BitReader r(words, nwords);
  int cur = starts[m];
  uint32_t err = 0u;
  for (int bi = 0; bi < bpm; ++bi) {
    const int32_t* q = seq + 3 * bi;
    const int cc = min_int(cur, nbits - 1);
    const int32_t* dc_full = tables + static_cast<long>(q[0]) * kSlotStride;
    const uint32_t win = r.window(cc);
    const int32_t e = lookup(dc_full + kFullSize, dc_full, win >> 16);
    int size = sym_of(e);
    int len = len_of(e);
    if (size < 0 || size > 16) {
      size = 0;
      len = 16;
    }
    diff[m * bpm + bi] = extend(amp_bits(win, len, size), size);
    ac_off[m * bpm + bi] = cc + len + size;
    const uint32_t v = fb[static_cast<long>(q[2]) * nbits + cc];
    err |= v & kErrBit;
    cur = static_cast<int>(v & kPosMask);
  }
  if (m == n_mcu - 1) status[0] = cur;
  return err != 0u;
}

}  // namespace jt

#ifndef JT_HOST_STANDIN

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
block_ends_kernel(const uint32_t* __restrict__ words, int nwords,
                  const int32_t* __restrict__ classes,
                  const int32_t* __restrict__ tables,
                  uint32_t* __restrict__ fb) {
  const int nbits = nwords * 32;
  const long p = static_cast<long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= nbits) return;
  const int c = blockIdx.y;
  const int32_t* dc = tables + static_cast<long>(classes[2 * c]) * jt::kSlotStride;
  const int32_t* ac =
      tables + static_cast<long>(classes[2 * c + 1]) * jt::kSlotStride;
  jt::BitReader r(words, nwords);
  fb[static_cast<long>(c) * nbits + p] = jt::block_end(
      r, static_cast<int>(p), nbits, dc + jt::kFullSize, dc,
      ac + jt::kFullSize, ac);
}

__global__ void __launch_bounds__(kThreads)
mcu_hop_kernel(const uint32_t* __restrict__ fb, int nbits,
               const int32_t* __restrict__ seq, int bpm,
               uint32_t* __restrict__ jump) {
  const long p = static_cast<long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= nbits) return;
  jump[p] = jt::mcu_end(fb, static_cast<int>(p), nbits, seq, bpm);
}

__global__ void __launch_bounds__(kThreads)
double_kernel(const uint32_t* __restrict__ jin, uint32_t* __restrict__ jout,
              int32_t* starts, int nbits, long half, long n_mcu, int compose) {
  const long t = static_cast<long>(blockIdx.x) * kThreads + threadIdx.x;
  jt::double_step(jin, jout, starts, t, nbits, half, n_mcu, compose);
}

__global__ void __launch_bounds__(kThreads)
replay_kernel(const uint32_t* __restrict__ words, int nwords,
              const uint32_t* __restrict__ fb,
              const int32_t* __restrict__ starts, long n_mcu,
              const int32_t* __restrict__ seq, int bpm,
              const int32_t* __restrict__ tables,
              int32_t* __restrict__ ac_off, int32_t* __restrict__ diff,
              int32_t* status) {
  const long m = static_cast<long>(blockIdx.x) * kThreads + threadIdx.x;
  if (m >= n_mcu) return;
  if (jt::replay_mcu(words, nwords, fb, starts, m, n_mcu, seq, bpm, tables,
                     ac_off, diff, status)) {
    atomicOr(status + 1, 1);
  }
}

unsigned blocks_for(long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

// fb: (nclasses, 32 * nwords) uint32. classes: (nclasses, 2) dc slot, ac slot.
extern "C" int jt_prefix_block_ends(const void* words, int nwords,
                                    const void* classes, int nclasses,
                                    const void* tables, int nslots, void* fb,
                                    void* stream) {
  if (nslots < 1 || nslots > jt::kMaxSlots || nclasses < 1 || nwords < 1) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(blocks_for(static_cast<long>(nwords) * 32), nclasses);
  block_ends_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), nwords,
      static_cast<const int32_t*>(classes),
      static_cast<const int32_t*>(tables), static_cast<uint32_t*>(fb));
  return static_cast<int>(cudaGetLastError());
}

// seq: (bpm, 3) dc slot, ac slot, class. jump: (nbits,) uint32.
extern "C" int jt_prefix_mcu_hop(const void* fb, int nbits, const void* seq,
                                 int bpm, void* jump, void* stream) {
  mcu_hop_kernel<<<blocks_for(nbits), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(fb), nbits,
      static_cast<const int32_t*>(seq), bpm, static_cast<uint32_t*>(jump));
  return static_cast<int>(cudaGetLastError());
}

// Level j (half = 2^j): jin jumps 2^j MCUs; starts[0 .. half) are known.
extern "C" int jt_prefix_double(const void* jin, void* jout, void* starts,
                                int nbits, long half, long n_mcu, int compose,
                                void* stream) {
  const long n = compose && nbits > half ? nbits : half;
  double_kernel<<<blocks_for(n), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(jin), static_cast<uint32_t*>(jout),
      static_cast<int32_t*>(starts), nbits, half, n_mcu, compose);
  return static_cast<int>(cudaGetLastError());
}

// status: (2,) int32 zeroed by the caller: the end position, the error flag.
extern "C" int jt_prefix_replay(const void* words, int nwords, const void* fb,
                                const void* starts, long n_mcu,
                                const void* seq, int bpm, const void* tables,
                                void* ac_off, void* diff, void* status,
                                void* stream) {
  replay_kernel<<<blocks_for(n_mcu), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), nwords,
      static_cast<const uint32_t*>(fb), static_cast<const int32_t*>(starts),
      n_mcu, static_cast<const int32_t*>(seq), bpm,
      static_cast<const int32_t*>(tables), static_cast<int32_t*>(ac_off),
      static_cast<int32_t*>(diff), static_cast<int32_t*>(status));
  return static_cast<int>(cudaGetLastError());
}

#endif  // JT_HOST_STANDIN
