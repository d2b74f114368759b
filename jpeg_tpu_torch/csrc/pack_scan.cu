// The device pack's tail: kernel A's per-block words -> the finished
// entropy-coded scan (level-2 placement, trim, 1-padding, 0xFF stuffing and
// RSTn markers), plus the status the host reads back.
//
// Replaces no TPU kernel. In the reference the placement is jnp
// (jpeg_tpu/ops/pack_pallas.py pack_level2) and the finalize is native C on
// the host (jt_finalize_scan); the port ran both the same way, about 35 torch
// operations and then a host loop over every byte of the scan, which set the
// pace of encode_stream (~1.9 ms of host time a 4K frame). Here the card
// hands the host finished bytes.
//
// In: kernel A's (S * B, 10) words and (S * B,) bit totals, S restart
// segments of B blocks, each segment with room for nwords words (level 2's
// capacity). Out: the scan, byte for byte what native finalize_scan makes
// of pack_level2's words, and int64 status [S bit totals | S ok flags | the
// scan's byte count]. A segment is ok when no block of it has more than 288
// bits and its bits fit its nwords words; when one is not, the count is 0
// and the bytes are not the scan (the host packs that image itself).
// Contract on the input, as kernel A writes it: a block's bits past its
// total are zero.
//
// Bound on the H100: bytes. The 4K q75 4:2:0 frame has 194,400 blocks of
// ~26 bits: the totals (0.78 MB), the words that hold bits (~0.8 MB) and the
// scan out (0.64 MB) take ~0.7 us at 3.35 TB/s, so the launches and their
// tails, not the bytes, set the time. Three kernels and one memset, every
// sum over tiles linear in the tiles:
// 0. memset: the placed words (the boundary words are ORed into), the
//    placement's tile sums and the two counters, one call.
// 1. place_kernel: a thread block per tile of 512 blocks of one segment,
//    taken in order from a counter (so every tile it waits for runs). A
//    block scan of the totals gives each block its bit offset in the tile;
//    the tile publishes its sum, ORs each block's words, shifted to that
//    offset, into the tile's words in shared memory (only the words its
//    bits reach are zeroed), then adds up the sums of the segment's tiles
//    before it (waiting for each flag; a thread reads one sum for each 512
//    tiles of the segment) and writes its words funnel-shifted to that
//    offset: coalesced plain stores, and atomicOr only for the first and
//    last word, which it shares with the tiles beside it. The last tile of
//    a segment writes its bit total.
// 2. count_kernel: a thread block per 4 KB of each segment's room; a
//    thread takes 16 bytes (one 16-byte load of four words), 1-pads the
//    segment's last byte and counts its 0xFF bytes; the block writes its
//    tile's output bytes (a segment's last tile adds the marker after the
//    segment). The block that finishes last, known from a counter, turns
//    them into offsets (one exclusive scan, a run of tiles a thread), and
//    writes every segment's status and the marker before it, and the count.
// 3. write_kernel: the same tiles; those that hold bytes of their segment
//    place each thread's stuffed bytes by a block scan from the tile's
//    offset.
// A segment's room (8 words a block) is ~10x what a q75 frame uses, so most
// tiles of steps 2-3 find nothing and leave at once.
// Measured at 4K (NVIDIA H100 80GB HBM3, 700 W): 31.9 us for the four
// launches kernel only (chip_smoke.py phase 8, L2 cold), 0.024 of the bytes
// bound; by the profiler place 9.4, count 8.3, write 6.8, memset 2.6 us. At
// restart 1 (32,400 segments of 6 blocks) 635 us: every segment still takes
// a 512-thread placement tile and a 256-thread stuffing tile.
//
// The kernels do the indexing, the block scans and the waits; what a thread
// or a tile does between them is in the functions before them, which
// JT_HOST_STANDIN builds alone: a host compiler that defines the CUDA
// built-ins they use (see tests/test_torch_pack.py) drives them tile by
// tile, thread by thread.

#include <cstdint>
#ifndef JT_HOST_STANDIN
#include <cuda_runtime.h>
#endif

namespace jt_scan {

constexpr int kBlockWords = 10;       // words per block row (BLOCK_WORDS + 1)
constexpr int kOkBits = 288;          // BLOCK_WORDS * 32: level 2's ok bound
constexpr int kPlaceThreads = 512;    // blocks per placement tile
constexpr int kTileWords = kPlaceThreads * 9 + 2;  // an ok tile's words
constexpr int kStuffThreads = 256;
constexpr int kChunk = 16;            // stream bytes per stuffing thread
constexpr long kStuffTile = kStuffThreads * kChunk;
constexpr unsigned long long kReady = 1ull << 63;

inline long round_up(long x, long m) { return (x + m - 1) / m * m; }

// The scratch buffer, in bytes from its start: [words | tile sums | bad
// flags | two counters] zeroed by the memset, then [segment bit totals | per
// stuffing tile: its output bytes, then its offset], written before they
// are read.
struct Layout {
  long stride;  // words per segment row: nwords rounded up to 4
  long ptiles;  // placement tiles per segment
  long stiles;  // stuffing tiles per segment
  long agg, bad, counter, zero_bytes, seg_bits, tile_out, bytes;
};

inline Layout layout(long nseg, long nblocks, long nwords) {
  Layout l;
  l.stride = round_up(nwords, 4);
  l.ptiles = (nblocks + kPlaceThreads - 1) / kPlaceThreads;
  l.stiles = (nwords * 4 + kStuffTile - 1) / kStuffTile;
  l.agg = nseg * l.stride * 4;
  l.bad = l.agg + nseg * l.ptiles * 8;
  l.counter = l.bad + nseg * 4;
  l.zero_bytes = round_up(l.counter + 8, 16);
  l.seg_bits = l.zero_bytes;
  l.tile_out = l.seg_bits + nseg * 8;
  l.bytes = round_up(l.tile_out + nseg * l.stiles * 8, 16);
  return l;
}

struct Args {
  const uint32_t* buf;           // (nseg * nblocks, kBlockWords) words
  const int32_t* bits;           // (nseg * nblocks,) bit totals
  uint32_t* words;               // (nseg, stride) the placed stream
  unsigned long long* agg;       // (nseg * ptiles,) tile sums | kReady
  uint32_t* bad;                 // (nseg,) a block over kOkBits
  uint32_t* counter;             // [placement tiles taken, count tiles done]
  unsigned long long* seg_bits;  // (nseg,) segment bit totals
  long long* tile_out;           // (nseg * stiles,) bytes out, then offsets
  uint8_t* out;                  // the scan
  int64_t* status;               // (2 * nseg + 1,)
  long nseg, nblocks, nwords, stride, ptiles, stiles, rst_base;
};

inline Args make_args(const void* buf, const void* bits, void* scratch,
                      void* out, void* status, long nseg, long nblocks,
                      long nwords, long rst_base) {
  const Layout l = layout(nseg, nblocks, nwords);
  char* s = static_cast<char*>(scratch);
  Args a;
  a.buf = static_cast<const uint32_t*>(buf);
  a.bits = static_cast<const int32_t*>(bits);
  a.words = reinterpret_cast<uint32_t*>(s);
  a.agg = reinterpret_cast<unsigned long long*>(s + l.agg);
  a.bad = reinterpret_cast<uint32_t*>(s + l.bad);
  a.counter = reinterpret_cast<uint32_t*>(s + l.counter);
  a.seg_bits = reinterpret_cast<unsigned long long*>(s + l.seg_bits);
  a.tile_out = reinterpret_cast<long long*>(s + l.tile_out);
  a.out = static_cast<uint8_t*>(out);
  a.status = static_cast<int64_t*>(status);
  a.nseg = nseg;
  a.nblocks = nblocks;
  a.nwords = nwords;
  a.stride = l.stride;
  a.ptiles = l.ptiles;
  a.stiles = l.stiles;
  a.rst_base = rst_base;
  return a;
}

// OR v into word i of a tile's shared words. Only a block over the budget
// reaches past an ok tile's words; what lies past them is dropped.
__device__ __forceinline__ void or_tile_word(uint32_t* tw, long long i,
                                             uint32_t v) {
  if (v != 0u && i < kTileWords) atomicOr(tw + i, v);
}

// A block's nbits bits (its first words) into the tile's words from bit
// `at` of the tile.
__device__ __forceinline__ void place_block(uint32_t* tw, long long at,
                                            const uint32_t* w, int nbits) {
  int nw = (nbits + 31) >> 5;
  if (nw > kBlockWords) nw = kBlockWords;
  const long long base = at >> 5;
  const int sh = static_cast<int>(at & 31);
  for (int k = 0; k < nw; ++k) {
    const uint32_t v = w[k];
    or_tile_word(tw, base + k, v >> sh);
    if (sh != 0) or_tile_word(tw, base + k + 1, v << (32 - sh));
  }
}

// Word k of a tile's span in its segment's stream, the tile starting sh
// bits into the span's first word.
__device__ __forceinline__ uint32_t span_word(const uint32_t* tw, int k,
                                              int sh) {
  uint32_t v = tw[k] >> sh;
  if (sh != 0 && k > 0) v |= tw[k - 1] << (32 - sh);
  return v;
}

// Store word k of a span of `count` words from word `first` of a segment's
// row. Its first and last word share bits with the tiles beside it and are
// ORed in; the others are the tile's alone. Words past the segment's room
// are dropped, as level 2 drops them.
__device__ __forceinline__ void store_span_word(uint32_t* row, long nwords,
                                                long long first, int k,
                                                int count, uint32_t v) {
  const long long g = first + k;
  if (g >= nwords) return;
  if (k == 0 || k == count - 1) {
    if (v != 0u) atomicOr(row + g, v);
  } else {
    row[g] = v;
  }
}

// A segment's stream bytes: its bits rounded up to whole bytes, at most its
// room.
__device__ __forceinline__ long seg_bytes(unsigned long long bits,
                                          long nwords) {
  const unsigned long long nb = (bits + 7) >> 3;
  const unsigned long long room = 4ull * static_cast<unsigned long long>(nwords);
  return static_cast<long>(nb < room ? nb : room);
}

__device__ __forceinline__ bool seg_ok(const Args& a, long s) {
  return a.bad[s] == 0u &&
         a.seg_bits[s] <= 32ull * static_cast<unsigned long long>(a.nwords);
}

// Bytes [at, at + 16) of a segment's stream (those below nb; `at` a
// multiple of 16) into b, big-endian from its words, the segment's last
// byte 1-padded. Returns how many there are.
__device__ __forceinline__ int chunk_bytes(const uint32_t* row, long nb,
                                           unsigned long long bits, long at,
                                           uint8_t* b) {
  if (at >= nb) return 0;
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(row + (at >> 2)));
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
  for (int i = 0; i < kChunk; ++i)
    b[i] = static_cast<uint8_t>(w[i >> 2] >> (24 - 8 * (i & 3)));
  const long left = nb - at;
  const int n = left < kChunk ? static_cast<int>(left) : kChunk;
  const int rem = static_cast<int>(bits & 7);
  if (at + n == nb && rem != 0)
    b[n - 1] = static_cast<uint8_t>(b[n - 1] | ((1u << (8 - rem)) - 1u));
  return n;
}

// The n bytes' length once stuffed: each 0xFF takes a 0x00 after it.
__device__ __forceinline__ int stuffed_length(const uint8_t* b, int n) {
  int c = n;
  for (int i = 0; i < n; ++i) c += b[i] == 0xFF;
  return c;
}

// The n bytes, each 0xFF followed by a 0x00.
__device__ __forceinline__ void put_stuffed(uint8_t* out, const uint8_t* b,
                                            int n) {
  int o = 0;
  for (int i = 0; i < n; ++i) {
    out[o++] = b[i];
    if (b[i] == 0xFF) out[o++] = 0;
  }
}

__device__ __forceinline__ uint8_t marker(long rst_base, long seg) {
  return static_cast<uint8_t>(0xD0 + ((rst_base + seg - 1) & 7));
}

// ---- Placement: tile `tile` is tile j of segment tile / ptiles; thread
// tid holds block j * kPlaceThreads + tid of the segment.

// The thread's block's bit total, 0 past the segment; a block over the
// budget marks its segment bad.
__device__ __forceinline__ int place_bits(const Args& a, long tile, int tid) {
  const long seg = tile / a.ptiles, j = tile - seg * a.ptiles;
  const long blk = j * kPlaceThreads + tid;
  if (blk >= a.nblocks) return 0;
  const int nbits = __ldg(a.bits + seg * a.nblocks + blk);
  if (nbits > kOkBits) atomicOr(a.bad + seg, 1u);
  return nbits;
}

// Words of a tile's shared copy that its bits reach, and the one after:
// those place_put and place_store touch, and so those to zero.
__device__ __forceinline__ int tile_words_used(long long tile_bits) {
  const long long n = (tile_bits + 31) / 32 + 1;
  return n < kTileWords ? static_cast<int>(n) : kTileWords;
}

// The tile's bit sum, for the tiles after it in its segment.
__device__ __forceinline__ void place_publish(const Args& a, long tile,
                                              long long tile_bits) {
  atomicExch(a.agg + tile, static_cast<unsigned long long>(tile_bits) | kReady);
}

// The thread's block's bits into the tile's words from bit `at` of the tile.
__device__ __forceinline__ void place_put(const Args& a, uint32_t* tw,
                                          long tile, int tid, long long at,
                                          int nbits) {
  if (nbits == 0) return;
  const long seg = tile / a.ptiles, j = tile - seg * a.ptiles;
  const long row = seg * a.nblocks + j * kPlaceThreads + tid;
  place_block(tw, at, a.buf + row * kBlockWords, nbits);
}

// The thread's share of the bits of the segment's tiles before this one:
// every nthreads-th sum from tid, each waited for. Those tiles took their
// places first, so they are running or done, and publish before they wait
// for anything.
__device__ __forceinline__ long long place_before(const Args& a, long tile,
                                                  int tid, int nthreads) {
  const long seg = tile / a.ptiles, j = tile - seg * a.ptiles;
  const unsigned long long* prev = a.agg + seg * a.ptiles;
  long long before = 0;
  for (long i = tid; i < j; i += nthreads) {
    unsigned long long v;
    do {
      v = *reinterpret_cast<const volatile unsigned long long*>(prev + i);
    } while ((v & kReady) == 0);
    before += static_cast<long long>(v & ~kReady);
  }
  return before;
}

// The thread's words of the tile's span, which starts `before` bits into
// the segment (every nthreads-th word from tid); the segment's last tile
// also writes the segment's bit total.
__device__ __forceinline__ void place_store(const Args& a, const uint32_t* tw,
                                            long tile, int tid, int nthreads,
                                            long long before,
                                            long long tile_bits) {
  const long seg = tile / a.ptiles, j = tile - seg * a.ptiles;
  if (tid == 0 && j == a.ptiles - 1)
    a.seg_bits[seg] = static_cast<unsigned long long>(before + tile_bits);
  if (tile_bits == 0) return;
  const long long first = before >> 5;
  long long count = ((before + tile_bits - 1) >> 5) - first + 1;
  if (count > kTileWords) count = kTileWords;
  const int sh = static_cast<int>(before & 31);
  uint32_t* row = a.words + seg * a.stride;
  for (long long k = tid; k < count; k += nthreads)
    store_span_word(row, a.nwords, first, static_cast<int>(k),
                    static_cast<int>(count),
                    span_word(tw, static_cast<int>(k), sh));
}

// ---- Stuffing: tile `tile` is tile j of segment tile / stiles, its bytes
// [j * kStuffTile, (j + 1) * kStuffTile) of the segment's stream; thread
// tid takes kChunk of them.

// The thread's bytes of the tile into b (see chunk_bytes); how many.
__device__ __forceinline__ int stuff_chunk(const Args& a, long tile, int tid,
                                           uint8_t* b) {
  const long seg = tile / a.stiles, j = tile - seg * a.stiles;
  const unsigned long long bits = a.seg_bits[seg];
  return chunk_bytes(a.words + seg * a.stride, seg_bytes(bits, a.nwords),
                     bits, j * kStuffTile + tid * kChunk, b);
}

// The tile's output bytes: its `stuffed` bytes and, for a segment's last
// tile, the marker after the segment (none after the last).
__device__ __forceinline__ void count_publish(const Args& a, long tile,
                                              long long stuffed) {
  const long seg = tile / a.stiles, j = tile - seg * a.stiles;
  a.tile_out[tile] =
      stuffed + (j == a.stiles - 1 && seg < a.nseg - 1 ? 2 : 0);
}

// The last count tile turns the tiles' output bytes into their offsets in
// the scan. Thread tid takes a run of consecutive tiles: offsets_sum adds
// up the run's bytes, offsets_write writes the run's offsets, from `before`
// (the bytes of the runs before it).
__device__ __forceinline__ long run_tiles(const Args& a, int nthreads) {
  return (a.nseg * a.stiles + nthreads - 1) / nthreads;
}

__device__ __forceinline__ long long offsets_sum(const Args& a, int tid,
                                                 int nthreads) {
  const long n = a.nseg * a.stiles, per = run_tiles(a, nthreads);
  long long s = 0;
  for (long i = tid * per; i < n && i < (tid + 1) * per; ++i)
    s += __ldcg(a.tile_out + i);
  return s;
}

__device__ __forceinline__ void offsets_write(const Args& a, int tid,
                                              int nthreads, long long before) {
  const long n = a.nseg * a.stiles, per = run_tiles(a, nthreads);
  for (long i = tid * per; i < n && i < (tid + 1) * per; ++i) {
    const long long v = __ldcg(a.tile_out + i);
    a.tile_out[i] = before;
    before += v;
  }
}

// Then each segment (every nthreads-th from tid): its bit total and ok flag,
// and the marker before it, which ends at its first tile's offset. Returns
// how many of them are not ok.
__device__ __forceinline__ long long segments_finish(const Args& a, int tid,
                                                     int nthreads) {
  long long bad = 0;
  for (long s = tid; s < a.nseg; s += nthreads) {
    const bool ok = seg_ok(a, s);
    a.status[s] = static_cast<int64_t>(a.seg_bits[s]);
    a.status[a.nseg + s] = ok ? 1 : 0;
    bad += !ok;
    if (s > 0) {
      const long long at = a.tile_out[s * a.stiles];
      a.out[at - 2] = 0xFF;
      a.out[at - 1] = marker(a.rst_base, s);
    }
  }
  return bad;
}

// And the scan's byte count: all `total` of them, or 0 when a segment is
// not ok.
__device__ __forceinline__ void count_total(const Args& a, long long total,
                                            long long bad) {
  a.status[2 * a.nseg] = bad != 0 ? 0 : total;
}

// Whether the tile holds bytes of its segment (the write pass skips the
// others).
__device__ __forceinline__ bool stuff_has_bytes(const Args& a, long tile) {
  const long seg = tile / a.stiles, j = tile - seg * a.stiles;
  return j * kStuffTile < seg_bytes(a.seg_bits[seg], a.nwords);
}

// The thread's n bytes of b, stuffed, `pos` bytes into the tile's output.
__device__ __forceinline__ void stuff_write(const Args& a, long tile,
                                            long long pos, const uint8_t* b,
                                            int n) {
  put_stuffed(a.out + a.tile_out[tile] + pos, b, n);
}

#ifndef JT_HOST_STANDIN

// Every thread's v summed, to every thread. s_warp: NT / 32 words.
template <int NT>
__device__ __forceinline__ long long block_sum(long long v,
                                               long long* s_warp) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();  // s_warp's last readers are done
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
  __syncthreads();
  long long t = 0;
#pragma unroll
  for (int i = 0; i < NT / 32; ++i) t += s_warp[i];
  return t;
}

// v summed over the threads before this one; *total over all of them.
template <int NT>
__device__ __forceinline__ long long block_exclusive(long long v,
                                                     long long* s_warp,
                                                     long long* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long u = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += u;
  }
  __syncthreads();
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  long long before = 0, all = 0;
#pragma unroll
  for (int i = 0; i < NT / 32; ++i) {
    const long long x = s_warp[i];
    before += i < warp ? x : 0;
    all += x;
  }
  *total = all;
  return before + inc - v;
}

__global__ void __launch_bounds__(kPlaceThreads) place_kernel(Args a) {
  __shared__ uint32_t s_words[kTileWords];
  __shared__ long long s_warp[kPlaceThreads / 32];
  __shared__ long s_tile;
  const int tid = threadIdx.x;
  if (tid == 0) s_tile = static_cast<long>(atomicAdd(a.counter, 1u));
  __syncthreads();
  const long tile = s_tile;
  const int nbits = place_bits(a, tile, tid);
  long long tile_bits;
  const long long at =
      block_exclusive<kPlaceThreads>(nbits, s_warp, &tile_bits);
  if (tid == 0) place_publish(a, tile, tile_bits);
  const int used = tile_words_used(tile_bits);
  for (int i = tid; i < used; i += kPlaceThreads) s_words[i] = 0u;
  __syncthreads();
  place_put(a, s_words, tile, tid, at, nbits);
  // place_before reads only the tile sums; block_sum's first barrier then
  // completes s_words for place_store.
  const long long before = block_sum<kPlaceThreads>(
      place_before(a, tile, tid, kPlaceThreads), s_warp);
  place_store(a, s_words, tile, tid, kPlaceThreads, before, tile_bits);
}

__global__ void __launch_bounds__(kStuffThreads) count_kernel(Args a) {
  __shared__ long long s_warp[kStuffThreads / 32];
  __shared__ bool s_last;
  const int tid = threadIdx.x;
  const long tile = blockIdx.x;
  uint8_t b[kChunk];
  const int n = stuff_chunk(a, tile, tid, b);
  const long long stuffed =
      block_sum<kStuffThreads>(stuffed_length(b, n), s_warp);
  if (tid == 0) {
    count_publish(a, tile, stuffed);
    __threadfence();  // the bytes out before the count that reveals them
    s_last = atomicAdd(a.counter + 1, 1u) ==
             static_cast<unsigned>(a.nseg * a.stiles - 1);
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  long long total;
  const long long before = block_exclusive<kStuffThreads>(
      offsets_sum(a, tid, kStuffThreads), s_warp, &total);
  offsets_write(a, tid, kStuffThreads, before);
  __syncthreads();  // segments_finish reads other runs' offsets
  const long long bad = block_sum<kStuffThreads>(
      segments_finish(a, tid, kStuffThreads), s_warp);
  if (tid == 0) count_total(a, total, bad);
}

__global__ void __launch_bounds__(kStuffThreads) write_kernel(Args a) {
  __shared__ long long s_warp[kStuffThreads / 32];
  const long tile = blockIdx.x;
  if (!stuff_has_bytes(a, tile)) return;
  uint8_t b[kChunk];
  const int n = stuff_chunk(a, tile, threadIdx.x, b);
  long long total;
  const long long pos = block_exclusive<kStuffThreads>(
      stuffed_length(b, n), s_warp, &total);
  stuff_write(a, tile, pos, b, n);
}

#endif  // JT_HOST_STANDIN

}  // namespace jt_scan

// Bytes of scratch jt_pack_scan needs (16-byte aligned, like its start).
extern "C" long jt_pack_scan_scratch(long nseg, long nblocks, long nwords) {
  return jt_scan::layout(nseg, nblocks, nwords).bytes;
}

#ifndef JT_HOST_STANDIN

extern "C" int jt_pack_scan(const void* buf, const void* bits, void* scratch,
                            void* out, void* status, long nseg, long nblocks,
                            long nwords, long rst_base, void* stream) {
  using namespace jt_scan;
  if (nseg <= 0 || nblocks <= 0 || nwords <= 0) return 0;
  const Layout l = layout(nseg, nblocks, nwords);
  const Args a = make_args(buf, bits, scratch, out, status, nseg, nblocks,
                           nwords, rst_base);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = cudaMemsetAsync(scratch, 0, l.zero_bytes, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  place_kernel<<<static_cast<unsigned>(nseg * l.ptiles), kPlaceThreads, 0,
                 st>>>(a);
  count_kernel<<<static_cast<unsigned>(nseg * l.stiles), kStuffThreads, 0,
                 st>>>(a);
  write_kernel<<<static_cast<unsigned>(nseg * l.stiles), kStuffThreads, 0,
                 st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

#endif  // JT_HOST_STANDIN
