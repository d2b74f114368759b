// Sequential Huffman walk, one restart segment per thread (kernel E).
//
// Counterpart of jpeg_tpu/entropy/decode_device.py `_decode_block` (:71) under
// `_jit_segments` (:117; XLA in the reference, not Pallas). Every RSTn marker
// byte-aligns the stream and resets the DC predictors, so segments decode
// independently; inside one the walk is serial. In: the unstuffed segments,
// one after another, as one stream of big-endian words with a zero guard
// behind it, and each segment's first byte in it (segments start on bytes,
// not on words); the restart interval and the MCU count (a segment's valid
// MCUs follow from them), the MCU's block sequence and the tables. The
// reference pads every segment to one length instead, for its vmap; a
// thread needs only to know where its bits begin. Out: the rows of every
// block of every valid MCU, written straight into the component-major
// (B, 64) layout that kernel D writes (the reference returns (S, max_mcu,
// blocks, 64) and joins on the host); per segment its length in bits as
// walked and an error flag. MCUs past a tail segment's count write nothing;
// rows arrive zeroed.
//
// Rules, as the reference: the DC size is clipped to 15 and a window that
// starts no DC code advances 16 bits and sets the flag; a window that starts
// no AC code sets the flag, advances 16 bits and ends the block; a
// (run, size) symbol that lands past 63 sets the flag and writes nothing;
// ZRL past 63 just ends the block. Every loop is bounded (k < 64 per block,
// the MCU count per segment) and the cursor is clamped to the buffer, where
// all further windows are zero. A cursor that leaves its segment reads the
// next one's bits; the host sees its end position past the segment's length
// and refuses the scan, so what it decoded there does not matter.
//
// Bound on the H100: nothing the card is good at. The kernel is as parallel
// as the stream has segments (135 for a 3840x2160 4:2:0 image with a restart
// interval of one MCU row), and each thread runs a chain of dependent table
// lookups. So the design spreads the segments: with few of them each gets a
// warp of its own (one active lane), so that they run on as many SMs as
// there are segments and no lane waits for another's branch; from 32 x 528
// segments on, lanes fill up. First-level tables sit in shared memory.

#include "huff_decode.cuh"

#ifndef JT_HOST_STANDIN
#include <cuda_runtime.h>
#endif

namespace jt {

constexpr int kSeqFields = 5;  // comp, dc slot, ac slot, row base, rows per MCU
constexpr int kMaxComps = 4;

// Walk the segment that starts at bit `start`; *end_pos is its length in
// bits as walked. seq: kSeqFields ints per block of the MCU; block bi of MCU
// m goes to row seq[3] + m * seq[4]. first_base/first_stride address the
// first-level table of a slot (shared memory in the kernel).
__device__ __forceinline__ void walk_segment(
    const uint32_t* words, int nwords, int start, long n_valid, long first_mcu,
    const int32_t* seq, int bpm, const int32_t* first_base, int first_stride,
    const int32_t* tables, int32_t* rows, int32_t* end_pos, int32_t* err_out) {
  BitReader r(words, nwords);
  const int limit = nwords * 32;
  int pos = start < limit ? start : limit, err = 0;
  int preds[kMaxComps] = {0, 0, 0, 0};
  for (long m = 0; m < n_valid; ++m) {
    for (int bi = 0; bi < bpm; ++bi) {
      const int32_t* q = seq + kSeqFields * bi;
      const int comp = q[0] & (kMaxComps - 1);
      int32_t* row = rows + (q[3] + (first_mcu + m) * q[4]) * 64;

      // DC
      uint32_t win = r.window(pos);
      int32_t e = lookup(first_base + q[1] * first_stride,
                         tables + static_cast<long>(q[1]) * kSlotStride,
                         win >> 16);
      int sym = sym_of(e);
      int len = len_of(e);
      if (sym < 0) err = 1;
      int size = sym < 0 ? 0 : (sym > 15 ? 15 : sym);
      preds[comp] += extend(amp_bits(win, len, size), size);
      pos = min_int(pos + len + size, limit);
      row[0] = preds[comp];

      // AC
      const int32_t* ac_first = first_base + q[2] * first_stride;
      const int32_t* ac_full = tables + static_cast<long>(q[2]) * kSlotStride;
      int k = 1;
      while (k < 64) {
        win = r.window(pos);
        e = lookup(ac_first, ac_full, win >> 16);
        sym = sym_of(e);
        len = len_of(e);
        if (sym < 0) {
          err = 1;
          sym = 0;
        }
        size = sym & 15;
        pos = min_int(pos + len + size, limit);
        if (sym == 0) break;
        if (sym == 0xF0) {
          k += 16;
          continue;
        }
        k += sym >> 4;
        if (k > 63) {
          err = 1;
        } else {
          row[k] = extend(amp_bits(win, len, size), size);
        }
        ++k;
      }
    }
  }
  *end_pos = pos - start;
  *err_out = err;
}

}  // namespace jt

#ifndef JT_HOST_STANDIN

namespace {

constexpr int kThreads = 32;
constexpr int kSpread = 528;  // 132 SMs x 4: below this many, a warp each

__global__ void __launch_bounds__(kThreads)
segment_walk_kernel(const uint32_t* __restrict__ words, int nwords,
                    const int32_t* __restrict__ seg_off, int nseg,
                    long interval, long mcu_count,
                    const int32_t* __restrict__ seq, int bpm,
                    const int32_t* __restrict__ tables, int nslots,
                    int per_block, int32_t* __restrict__ rows,
                    int32_t* __restrict__ status) {
  extern __shared__ int32_t s_first[];
  jt::load_first_levels(s_first, tables, nslots);
  __syncthreads();
  const int tid = threadIdx.x;
  const long s = static_cast<long>(blockIdx.x) * per_block + tid;
  if (tid >= per_block || s >= nseg) return;
  const long first_mcu = s * interval;
  long n_valid = mcu_count - first_mcu;
  if (n_valid > interval) n_valid = interval;
  jt::walk_segment(words, nwords, seg_off[s] * 8, n_valid, first_mcu, seq,
                   bpm, s_first, jt::kFirstSize, tables, rows, status + s,
                   status + nseg + s);
}

}  // namespace

// seg_off: each segment's first byte in the stream. status: (2, nseg) int32,
// the segments' lengths in bits as walked, then the error flags.
extern "C" int jt_segment_walk(const void* words, int nwords,
                               const void* seg_off, int nseg, long interval,
                               long mcu_count, const void* seq,
                               int bpm, const void* tables, int nslots,
                               void* rows, void* status, void* stream) {
  if (nseg <= 0) return 0;
  if (nslots < 1 || nslots > jt::kMaxSlots) return cudaErrorInvalidValue;
  int per_block = nseg / kSpread;
  per_block = per_block < 1 ? 1 : (per_block > kThreads ? kThreads : per_block);
  const int grid = (nseg + per_block - 1) / per_block;
  const size_t shared = sizeof(int32_t) * nslots * jt::kFirstSize;
  segment_walk_kernel<<<grid, kThreads, shared,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), nwords,
      static_cast<const int32_t*>(seg_off), nseg, interval, mcu_count,
      static_cast<const int32_t*>(seq), bpm,
      static_cast<const int32_t*>(tables), nslots, per_block,
      static_cast<int32_t*>(rows), static_cast<int32_t*>(status));
  return static_cast<int>(cudaGetLastError());
}

#endif  // JT_HOST_STANDIN
