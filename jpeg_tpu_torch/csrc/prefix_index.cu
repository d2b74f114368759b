// Block starts of a scan, with or without restart markers: one chunked,
// self-synchronizing program for programs F and E of the reference.
//
// Counterpart of jpeg_tpu/entropy/decode_device.py `_jit_prefix_index` (:866,
// program F) and of `_decode_block` under `_jit_segments` (:71, :117, kernel
// E); XLA in the reference, not Pallas. Both find where every block starts,
// given one known start: bit 0 of a scan without markers ("unanchored", F's
// contract), or the first byte of every restart segment, where the DC
// predictors reset ("anchored", E's). Out, per block of every valid MCU: the
// bit offset just past its DC code and its DC difference (kernel D decodes
// the AC coefficients from them), the position after the last MCU (per
// segment when anchored) and an error flag.
//
// Huffman codes do not say where a block starts, but a walk begun at a wrong
// bit falls into step with the true one within a few symbols. So the scan is
// cut into chunks of chunk_bits bits (each segment into its own when
// anchored), and a walk state is (bit of a block start, index bi of that block
// in the MCU's block sequence). The launches:
//   1. layout (one thread block): each segment's chunks, an exclusive scan of
//      their counts; the status zeroed;
//   2. speculate, one thread per chunk and lane: a walk of whole blocks from
//      the chunk's first bit with bi = lane, until the first block start at or
//      past the next chunk; its exit state and block count. A segment's first
//      chunk walks once from its true start. bpm lanes, because the phase bi
//      is what a walk on flat content (runs of identical blocks) gets wrong and
//      keeps: with one lane, the walks of a solid black 4:2:0 frame fall into
//      step a block of the MCU off, and the truth then moves by one chunk per
//      resolve round;
//   3. link, one thread per chunk and lane: a walk through the chunk from the
//      predecessor's exit of that lane, and which of the chunk's own lanes it
//      ends in (psi), if any. Once it is in step with a lane it is that
//      lane: it compares its state with the lanes' at their first block start
//      a quarter into the chunk and, on a match, takes the rest
//      of that lane's walk without walking it;
//   4. resolve (one thread block of 1024 threads), in rounds: a scan of the
//      chunks' 4-bit lane maps (psi; constant for a segment's first chunk and
//      for every chunk resolved before) gives the true exit lane of every
//      chunk that a chain of lanes reaches from a resolved one, and with it
//      that chunk's entry, exit and block count; a chunk whose predecessor's
//      true exit is no lane's (the lanes all fell into a wrong step, which
//      dense content makes common at short chunks) is walked from it. Until
//      every chunk is resolved; each round resolves at least the next chunk
//      of every segment, so there are at most as many rounds as chunks, and
//      none is given up. Exactness: every segment's first chunk enters at its
//      true start and every other chunk at its predecessor's exact exit, so
//      by induction every chunk walked the serial path. Then an exclusive
//      scan of the chunks' block counts. Where every chunk starts its
//      segment (short restart intervals) there is nothing to resolve;
//   5. write, one thread per chunk: a walk from its resolved entry that
//      writes each block's outputs up to the segment's block count; only this
//      walk sets error bits, and the block count ends the last chunk of each
//      segment. Blocks past the MCU count are neither walked nor written.
// Steps 2, 3 and 5 read a thread block's words from shared memory, where the
// block copies them first (a walk's next word is then no global load).
// Scratch: O(chunks x lanes), jt_sync_scratch_bytes (53 bytes per lane and
// chunk, 29 per chunk); the resolve rounds of a call at its first word
// (SYNC_PASSES in the wrapper).
//
// Rules, by mode (each route keeps its reference's verdicts):
//   unanchored (F, as decode_device.py:941-947): a window that starts no code
//     (a DC symbol above 16 counts as none) advances 16 bits and flags; a
//     block whose last symbol takes k past 64 without EOB flags (ZRL
//     included). Positions clamp to the last bit of the buffer;
//   anchored (E): the DC size is clipped to 15 and a window that starts no DC
//     code advances 16 bits and flags; a window that starts no AC code flags,
//     advances 16 bits and ends the block; a (run, size) symbol that lands
//     past 63 flags; ZRL past 63 just ends the block. Positions clamp to the
//     end of the buffer. A cursor that leaves its segment reads the next
//     one's bits; the host sees its end past the segment's length.
// A walk that reaches the clamp stays there: the write walk takes one more
// MCU's blocks for their error bits and stops (that end lies past the true
// bits, and the host refuses the scan).
//
// Bound on the H100: the walks are chains of dependent table lookups, a few
// tens of integer instructions per symbol, and their bytes (the scan in, 8
// bytes per block out) take under a microsecond: each launch is as long as
// its slowest chunk. -DJT_CHUNK_BITS=n builds another chunk size,
// -DJT_LANES=n caps the lanes (1: one speculative walk per chunk).

#include "huff_decode.cuh"

#ifndef JT_HOST_STANDIN
#include <cuda_runtime.h>
#endif

#ifndef JT_LANES
#define JT_LANES 10
#endif

// The arguments of every launch, as the Python wrapper fills them.
struct SyncArgs {
  const uint32_t* words;  // the unstuffed scan (segments back to back)
  int nwords;
  int anchored;           // 0: F's mode and rules; 1: E's
  const int32_t* seg_off; // (nseg,) first byte of each segment; null: one at 0
  int nseg;
  int bpm;                // blocks per MCU
  long interval;          // MCUs per segment (the MCU count when unanchored)
  long n_mcu;             // MCUs in all
  // Per block of the MCU: unanchored (dc slot, ac slot, class), out index
  // m * bpm + bi; anchored (component, dc slot, ac slot, row base, rows per
  // MCU), out index row base + m * rows per MCU.
  const int32_t* seq;
  const int32_t* tables;
  void* scratch;          // jt_sync_scratch_bytes
  int32_t* ac_off;        // per block: bit offset past its DC code
  int32_t* diff;          // per block: DC difference
  int32_t* slot;          // anchored, or null: the block's AC table slot
  int32_t* group;         // anchored, or null: first row of its component's
                          // blocks in its segment (the DC predictor's reset)
  int32_t* status;        // unanchored (2,): end, flag; anchored (2, nseg):
                          // bits walked per segment, flags
};

namespace jt {

// A chunk is the smallest power of two of bits, from kMinChunk to
// kMaxChunk, that holds kChunkMcus MCUs' worth of the scan's bits on average
// (the lanes must fall into step within it; dense content needs long chunks)
// and cuts the scan into at most kMaxChunks chunks (the resolve step runs in
// one thread block, at a cost that grows with the chunks, and again with
// every round). Measured in turns (kernel_compare.py, NVIDIA H100 80GB HBM3,
// 700 W, kernel only, one run), us (resolve rounds): 4K q75 4:2:0, 158 bits
// per MCU, 343.4 (4) / 349.8 (1) at 512 / 1024 bits; 280-row black bars,
// 128 bits per MCU, 953.3 (17) / 351.5 (1) at 256 / 1024; 4K gray, 7.2 Mbit,
// 327.7 / 290.4 at 256 / 1024 (1 round each; the resolve step alone 235 us
// at 256); q95, 723 bits per MCU, 212,010 / 9,917 / 1,803 (22) at 256 /
// 1024 / 2048. -DJT_CHUNK_BITS=n fixes the size.
constexpr int kChunkMcus = 3;
constexpr long kMaxChunks = 16384;
constexpr int kMinChunk = 256;
constexpr int kMaxChunk = 8192;
constexpr int kMaxLanes = JT_LANES < 10 ? JT_LANES : 10;
constexpr int kNoLane = 15;  // lane maps hold 16 nibbles; 15 is "no lane"
constexpr int kNoExitLane = 14;  // resolved, but its exit is no lane's
constexpr int64_t kUnknown = -1;
constexpr int kResolveThreads = 1024;
static_assert(kMaxLanes >= 1, "lanes");

// The arguments with the scratch carved and the derived sizes.
struct Sync {
  SyncArgs a;
  int nbits, limit, lanes;
  int chunk;          // bits per chunk
  long maxc;          // chunks at most: nseg + ceil(nbits / chunk)
  int32_t* passes;    // [0] rounds of the resolve step
  int32_t* base;      // (nseg + 1,) each segment's first chunk; [nseg] total
  int32_t* seg_of;    // (maxc,)
  int32_t* cstart;    // (maxc,) each chunk's first bit
  uint8_t* ckind;     // (maxc,) kFirst | kLast | kSecond
  int64_t* out;       // (maxc, lanes) speculative exits
  int32_t* scnt;      // (maxc, lanes) their block counts
  int64_t* chk;       // (maxc, lanes) each lane's checkpoint: its first
  int32_t* chkn;      // block start a quarter into the chunk, and the
                      // blocks before it
  int64_t* lx;        // (maxc, lanes) link exits
  int32_t* lcnt;      // (maxc, lanes) their block counts
  uint8_t* psi;       // (maxc, lanes) the own lane each link walk ends in
  uint8_t* fix;       // (maxc,) resolved: exit lane or kNoExitLane; else 15
  int64_t* entry;     // (maxc,) resolved entry and exit states
  int64_t* exit;
  int32_t* cnt;       // (maxc,) blocks walked from entry to exit
  int32_t* pre;       // (maxc,) exclusive scan of cnt
};

inline int chunk_bits(int nwords, long n_mcu) {
#ifdef JT_CHUNK_BITS
  (void)nwords;
  (void)n_mcu;
  return JT_CHUNK_BITS;
#else
  const long nbits = static_cast<long>(nwords) * 32;
  const long per_mcu = nbits * kChunkMcus / (n_mcu > 0 ? n_mcu : 1);
  const long want = per_mcu > nbits / kMaxChunks ? per_mcu : nbits / kMaxChunks;
  int c = kMinChunk;
  while (c < want && c < kMaxChunk) c <<= 1;
  return c;
#endif
}

inline long sync_maxc(int nwords, int nseg, int chunk) {
  return nseg + (static_cast<long>(nwords) * 32 + chunk - 1) / chunk;
}

inline int sync_lanes(int bpm) { return bpm < kMaxLanes ? bpm : kMaxLanes; }

inline long align8(long n) { return (n + 7) & ~7L; }

inline long sync_bytes(int nwords, int nseg, int bpm, long n_mcu) {
  const long c = sync_maxc(nwords, nseg, chunk_bits(nwords, n_mcu));
  const long cl = c * sync_lanes(bpm);
  return 8 + 8 * (3 * cl + 2 * c) + align8(4 * (3 * cl + 5 * c + nseg + 1)) +
         align8(cl) + 2 * align8(c);
}

inline Sync make_sync(const SyncArgs& a) {
  Sync s;
  s.a = a;
  s.nbits = a.nwords * 32;
  s.limit = a.anchored ? s.nbits : s.nbits - 1;
  s.lanes = sync_lanes(a.bpm);
  s.chunk = chunk_bits(a.nwords, a.n_mcu);
  s.maxc = sync_maxc(a.nwords, a.nseg, s.chunk);
  const long cl = s.maxc * s.lanes;
  char* p = static_cast<char*>(a.scratch);
  s.passes = reinterpret_cast<int32_t*>(p);
  p += 8;
  int64_t* w = reinterpret_cast<int64_t*>(p);
  s.out = w;
  s.lx = w + cl;
  s.chk = w + 2 * cl;
  s.entry = w + 3 * cl;
  s.exit = w + 3 * cl + s.maxc;
  p += 8 * (3 * cl + 2 * s.maxc);
  int32_t* q = reinterpret_cast<int32_t*>(p);
  s.scnt = q;
  s.lcnt = q + cl;
  s.chkn = q + 2 * cl;
  s.seg_of = q + 3 * cl;
  s.cnt = q + 3 * cl + s.maxc;
  s.pre = q + 3 * cl + 2 * s.maxc;
  s.cstart = q + 3 * cl + 3 * s.maxc;
  s.base = q + 3 * cl + 4 * s.maxc;
  p += align8(4 * (3 * cl + 5 * s.maxc + a.nseg + 1));
  s.psi = reinterpret_cast<uint8_t*>(p);
  s.fix = s.psi + align8(cl);
  s.ckind = s.fix + align8(s.maxc);
  return s;
}

__device__ __forceinline__ int64_t state_of(int pos, int bi) {
  return (static_cast<int64_t>(pos) << 8) | bi;
}
__device__ __forceinline__ int pos_of(int64_t st) {
  return static_cast<int>(st >> 8);
}
__device__ __forceinline__ int bi_of(int64_t st) {
  return static_cast<int>(st & 255);
}

__device__ __forceinline__ int seg_bit(const Sync& s, int seg) {
  if (!s.a.seg_off) return 0;
  const long b = static_cast<long>(s.a.seg_off[seg]) * 8;
  return b < 0 ? 0 : (b > s.nbits ? s.nbits : static_cast<int>(b));
}

// Chunk c: its segment, its index j in the segment, whether it is the
// segment's last, and the bit where the next chunk starts.
struct ChunkInfo {
  int seg, j;
  bool first, last;
  int start, stop;
};

__device__ __forceinline__ ChunkInfo chunk_info_of(const Sync& s, long c,
                                                 int seg) {
  ChunkInfo k;
  k.seg = seg;
  const int b0 = s.base[k.seg], n = s.base[k.seg + 1] - b0;
  k.j = static_cast<int>(c - b0);
  k.first = k.j == 0;
  k.last = k.j == n - 1;
  const int sb = seg_bit(s, k.seg);
  k.start = sb + k.j * s.chunk;
  k.stop = k.last ? 0x7FFFFFFF : sb + (k.j + 1) * s.chunk;
  return k;
}

__device__ __forceinline__ ChunkInfo chunk_info(const Sync& s, long c) {
  return chunk_info_of(s, c, s.seg_of[c]);
}

// What the resolve step needs of chunk c, from two loads: first, last, j ==
// 1 (second), start and stop; not its segment.
constexpr int kFirst = 1, kLast = 2, kSecond = 4;

__device__ __forceinline__ ChunkInfo quick_info(const Sync& s, long c) {
  ChunkInfo k;
  const int kind = s.ckind[c];
  k.seg = -1;
  k.first = kind & kFirst;
  k.last = kind & kLast;
  k.j = k.first ? 0 : ((kind & kSecond) ? 1 : 2);
  k.start = s.cstart[c];
  k.stop = k.last ? 0x7FFFFFFF : k.start + s.chunk;
  return k;
}

__device__ __forceinline__ void atomic_or_int(int32_t* p, int v) {
#ifdef JT_HOST_STANDIN
  *p |= v;
#else
  atomicOr(p, v);
#endif
}

template <int kAnchored>
__device__ __forceinline__ const int32_t* dc_row(const Sync& s, int bi) {
  return s.a.tables +
         static_cast<long>(s.a.seq[kAnchored ? 5 * bi + 1 : 3 * bi]) *
             kSlotStride;
}

template <int kAnchored>
__device__ __forceinline__ const int32_t* ac_row(const Sync& s, int bi) {
  return s.a.tables +
         static_cast<long>(s.a.seq[kAnchored ? 5 * bi + 2 : 3 * bi + 1]) *
             kSlotStride;
}

// Words [lo, hi) of the scan copied where they are read faster (shared
// memory in the kernels); none by default.
struct Stage {
  const uint32_t* w = nullptr;
  int lo = 0, hi = 0;
};

// The walks' bit reader: BitReader's window over a Stage, falling back to
// the scan in global memory outside it.
struct StagedReader {
  const uint32_t* words;
  int nwords;
  Stage st;
  int wi;
  uint32_t w0, w1;

  __device__ __forceinline__ StagedReader(const uint32_t* w, int n,
                                          const Stage& stage)
      : words(w), nwords(n), st(stage), wi(-2), w0(0u), w1(0u) {}

  __device__ __forceinline__ uint32_t load(int i) const {
    if (i >= st.lo && i < st.hi) return st.w[i - st.lo];
    return (i >= 0 && i < nwords) ? words[i] : 0u;
  }

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

__device__ __forceinline__ int32_t load_ro(const int32_t* p) {
#ifdef JT_HOST_STANDIN
  return *p;
#else
  return __ldg(p);
#endif
}

// A walk's position in its block: k = 0 before the DC code, else the
// coefficient index (E's rules) or the AC symbols read so far (it, F's).
struct Cursor {
  int p, bi, k, it;
  const int32_t* dc;
  const int32_t* ac;
};

template <int kAnchored>
__device__ __forceinline__ void enter_block(const Sync& s, Cursor& w) {
  w.k = 0;
  w.it = 0;
  w.dc = dc_row<kAnchored>(s, w.bi);
  w.ac = ac_row<kAnchored>(s, w.bi);
}

// One symbol of a walk: the block's DC code when k = 0 (then *ac_off and
// *diff as the outputs want them), else one AC symbol. True when the block
// ended with it. ORs 1 into *err where the rules flag. Every walk steps one
// symbol per iteration of one loop, so that the threads of a warp, each on
// its own chunk, stay on the same instructions.
template <int kAnchored, typename Reader>
__device__ __forceinline__ bool step(Reader& r, Cursor& w, int limit,
                                     int* ac_off, int* diff, int* err) {
  const uint32_t win = r.window(w.p);
  const int32_t* row = w.k == 0 ? w.dc : w.ac;
  int32_t e = load_ro(row + kFullSize + (win >> (32 - kFirstBits)));
  if (e == 0) e = load_ro(row + (win >> 16));
  int sym = sym_of(e), len = len_of(e);
  if (w.k == 0) {
    int size;
    if (kAnchored) {
      if (sym < 0) *err = 1;
      size = sym < 0 ? 0 : (sym > 15 ? 15 : sym);
      *diff = extend(amp_bits(win, len, size), size);
      w.p = min_int(w.p + len + size, limit);
      *ac_off = w.p;
    } else {
      size = sym;
      if (size < 0 || size > 16) {
        *err = 1;
        size = 0;
        len = 16;
      }
      *diff = extend(amp_bits(win, len, size), size);
      *ac_off = w.p + len + size;
      w.p = min_int(w.p + len + size, limit);
    }
    w.k = 1;
    return false;
  }
  if (kAnchored) {
    if (sym < 0) {
      *err = 1;
      sym = 0;
    }
    w.p = min_int(w.p + len + (sym & 15), limit);
    if (sym == 0) return true;
    if (sym == 0xF0) {
      w.k += 16;
    } else {
      w.k += sym >> 4;
      if (w.k > 63) *err = 1;
      ++w.k;
    }
    return w.k >= 64;
  }
  ++w.it;  // F: at most 64 AC symbols, a window that starts no code included
  if (sym < 0) {
    *err = 1;
    w.p = min_int(w.p + 16, limit);
    return w.it >= 64;
  }
  w.p = min_int(w.p + len + (sym & 15), limit);
  if (sym == 0) return true;
  const int kinc = sym == 0xF0 ? 16 : (sym >> 4) + 1;
  if (w.k + kinc > 63) {  // the closing symbol
    if (w.k + kinc > 64) *err = 1;
    return true;
  }
  w.k += kinc;
  return w.it >= 64;
}

// Whole blocks from `st` until one starts at or past `stop` (or at the
// clamp): that state; *count += the blocks walked. No outputs, no flags.
template <int kAnchored>
__device__ __forceinline__ int64_t advance(const Sync& s, int64_t st, int stop,
                                           int* count, const Stage& stage) {
  StagedReader r(s.a.words, s.a.nwords, stage);
  Cursor w;
  w.p = pos_of(st);
  w.bi = bi_of(st);
  enter_block<kAnchored>(s, w);
  int n = 0, off, d, err = 0;
  for (;;) {
    if (w.k == 0 && (w.p >= stop || w.p >= s.limit)) break;
    if (step<kAnchored>(r, w, s.limit, &off, &d, &err)) {
      ++n;
      if (++w.bi == s.a.bpm) w.bi = 0;
      enter_block<kAnchored>(s, w);
    }
  }
  *count += n;
  return state_of(w.p, w.bi);
}

// Chunk c (not a segment's first or last) from state `st` to its exit: up
// to the checkpoint, and the rest of the lane it then matches, if any. The
// exit state; *count the blocks; *lane the own lane whose exit it is, if any.
template <int kAnchored>
__device__ __forceinline__ int64_t walk_through(const Sync& s, long c,
                                                int start, int stop,
                                                int64_t st, int* count,
                                                int* lane, const Stage& stage) {
  int n = 0;
  const int check = start + s.chunk / 4 < stop ? start + s.chunk / 4 : stop;
  st = advance<kAnchored>(s, st, check, &n, stage);
  int64_t x = kUnknown;
  for (int l = 0; l < s.lanes && x == kUnknown; ++l) {
    if (s.chk[c * s.lanes + l] == st) {
      x = s.out[c * s.lanes + l];
      n += s.scnt[c * s.lanes + l] - s.chkn[c * s.lanes + l];
    }
  }
  if (x == kUnknown) x = advance<kAnchored>(s, st, stop, &n, stage);
  *count = n;
  int own = kNoLane;
  for (int l = 0; l < s.lanes && own == kNoLane; ++l)
    if (s.out[c * s.lanes + l] == x) own = l;
  *lane = own;
  return x;
}

// Step 1, serial part: segment seg's chunk count.
__device__ __forceinline__ int segment_chunks(const Sync& s, int seg) {
  const int b = seg_bit(s, seg);
  const int e = seg + 1 < s.a.nseg ? seg_bit(s, seg + 1) : s.nbits;
  const int n = e > b ? (e - b + s.chunk - 1) / s.chunk : 1;
  return n < 1 ? 1 : n;
}

// Zero the status the write step ORs into.
__device__ __forceinline__ void clear_status(const Sync& s, int i) {
  if (i < (s.a.anchored ? 2 * s.a.nseg : 2)) s.a.status[i] = 0;
}

// The segment of chunk c (base: exclusive chunk counts, base[nseg] total).
__device__ __forceinline__ int find_segment(const Sync& s, long c) {
  int lo = 0, hi = s.a.nseg - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (s.base[mid] <= c) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Step 2's thread for chunk c: its segment, found once (binary search).
__device__ __forceinline__ ChunkInfo first_look(const Sync& s, long c, int b) {
  const int seg = find_segment(s, c);
  const ChunkInfo k = chunk_info_of(s, c, seg);
  if (b == 0) {
    s.seg_of[c] = seg;
    s.cstart[c] = k.start;
    s.ckind[c] = static_cast<uint8_t>((k.first ? kFirst : 0) |
                                      (k.last ? kLast : 0) |
                                      (k.j == 1 ? kSecond : 0));
  }
  return k;
}

__device__ __forceinline__ void unresolve_range(const Sync& s, long lo,
                                                long hi) {
  for (long c = lo; c < hi; ++c) s.fix[c] = kNoLane;
}

// Step 2 for chunk c (info k) and lane b.
template <int kAnchored>
__device__ __forceinline__ void speculate(const Sync& s, long c, int b,
                                          const ChunkInfo& k,
                                          const Stage& stage) {
  if (k.last || (k.first && b > 0)) return;
  const long i = c * s.lanes + b;
  int n = 0;
  const int check = k.start + s.chunk / 4 < k.stop ? k.start + s.chunk / 4
                                                   : k.stop;
  const int64_t at =
      advance<kAnchored>(s, state_of(k.start, b), check, &n, stage);
  s.chk[i] = pos_of(at) < k.stop ? at : kUnknown;
  s.chkn[i] = n;
  s.out[i] = advance<kAnchored>(s, at, k.stop, &n, stage);
  s.scnt[i] = n;
}

// Step 3 for chunk c (info k) and lane b of its predecessor's exits.
template <int kAnchored>
__device__ __forceinline__ void link(const Sync& s, long c, int b,
                                     const ChunkInfo& k, const Stage& stage) {
  if (k.first || k.last) return;
  const long i = c * s.lanes + b;
  if (b > 0 && k.j == 1) {  // the first chunk has one exit, lane 0's
    s.psi[i] = kNoLane;
    return;
  }
  int n, own;
  s.lx[i] = walk_through<kAnchored>(s, c, k.start, k.stop,
                                    s.out[(c - 1) * s.lanes + b], &n, &own,
                                    stage);
  s.lcnt[i] = n;
  s.psi[i] = static_cast<uint8_t>(own);
}

// Step 4's lane maps: 16 nibbles, nibble l = the chunk's exit lane when its
// predecessor exits in lane l.
__device__ __forceinline__ uint64_t identity_map() {
  return 0xFEDCBA9876543210ull;
}

__device__ __forceinline__ int apply_map(uint64_t f, int l) {
  return static_cast<int>((f >> (4 * l)) & 15);
}

// g after f.
__device__ __forceinline__ uint64_t compose_maps(uint64_t f, uint64_t g) {
  uint64_t h = 0;
  for (int l = 0; l < 16; ++l)
    h |= static_cast<uint64_t>(apply_map(g, apply_map(f, l))) << (4 * l);
  return h;
}

// A chunk's lane map. Resolved chunks (fix) map everything to their exit
// lane, or to none when no lane ends where they do.
__device__ __forceinline__ uint64_t chunk_map(const Sync& s, long c) {
  const ChunkInfo k = quick_info(s, c);
  if (k.first) return 0;  // whatever came before: lane 0 of its own walk
  const int fixed = s.fix[c];
  if (fixed != kNoLane) {
    const uint64_t v = fixed == kNoExitLane ? kNoLane : fixed;
    return v * 0x1111111111111111ull;
  }
  uint64_t f = 0xF000000000000000ull;  // "no lane" stays "no lane"
  for (int l = 0; l < 15; ++l) {
    const int v = (!k.last && l < s.lanes) ? s.psi[c * s.lanes + l] : kNoLane;
    f |= static_cast<uint64_t>(v) << (4 * l);
  }
  return f;
}

// Chunks [lo, hi): their map, composed in order.
__device__ __forceinline__ uint64_t range_map(const Sync& s, long lo, long hi) {
  uint64_t f = identity_map();
  for (long c = lo; c < hi; ++c) f = compose_maps(f, chunk_map(s, c));
  return f;
}

// Chunk c, entered exactly at its predecessor's exit `e`: its entry, exit
// and count, and whether it is resolved (its exit lane, kNoExitLane where no
// lane ends there). pred_lane: the lane e is, if any.
template <int kAnchored>
__device__ __forceinline__ void resolve_chunk(const Sync& s, long c,
                                              const ChunkInfo& k, int64_t e,
                                              int pred_lane,
                                              const Stage& stage) {
  s.entry[c] = e;
  if (k.last) {
    s.cnt[c] = 0;
    s.fix[c] = kNoExitLane;
    return;
  }
  int n, lane;
  if (pred_lane != kNoLane) {
    const long i = c * s.lanes + pred_lane;
    s.exit[c] = s.lx[i];
    n = s.lcnt[i];
    lane = s.psi[i];
  } else {
    s.exit[c] = walk_through<kAnchored>(s, c, k.start, k.stop, e, &n, &lane,
                                        stage);
  }
  s.cnt[c] = n;
  s.fix[c] = static_cast<uint8_t>(lane == kNoLane ? kNoExitLane : lane);
}

// Resolve what the lane maps reach in chunks [lo, hi), given the lane of
// chunk lo - 1's exit (none if not known).
template <int kAnchored>
__device__ __forceinline__ void seed_range(const Sync& s, long lo, long hi,
                                           int lane) {
  for (long c = lo; c < hi; ++c) {
    const ChunkInfo k = quick_info(s, c);
    const int fixed = s.fix[c];
    if (fixed != kNoLane) {
      lane = fixed == kNoExitLane ? kNoLane : fixed;
      continue;
    }
    if (k.first) {
      s.entry[c] = state_of(k.start, 0);
      if (k.last) {
        s.cnt[c] = 0;
        s.fix[c] = kNoExitLane;
        lane = kNoLane;
      } else {
        s.exit[c] = s.out[c * s.lanes];
        s.cnt[c] = s.scnt[c * s.lanes];
        s.fix[c] = 0;
        lane = 0;
      }
    } else if (lane != kNoLane) {
      resolve_chunk<kAnchored>(s, c, k, s.out[(c - 1) * s.lanes + lane], lane,
                               Stage());
      lane = s.fix[c] == kNoExitLane ? kNoLane : s.fix[c];
    }
  }
}

// Walk every chunk of [lo, hi), in order, whose predecessor is resolved but
// which is not; true while some chunk of the range stays unresolved.
template <int kAnchored>
__device__ __forceinline__ bool walk_range(const Sync& s, long lo, long hi) {
  bool open = false;
  for (long c = lo; c < hi; ++c) {
    if (s.fix[c] != kNoLane) continue;
    const int pred = s.fix[c - 1];  // c is no first chunk: seed took those
    if (pred == kNoLane) {
      open = true;
      continue;
    }
    const ChunkInfo k = quick_info(s, c);
    resolve_chunk<kAnchored>(s, c, k, s.exit[c - 1],
                             pred == kNoExitLane ? kNoLane : pred, Stage());
  }
  return open;
}

__device__ __forceinline__ int range_count(const Sync& s, long lo, long hi) {
  int n = 0;
  for (long c = lo; c < hi; ++c) n += s.cnt[c];
  return n;
}

__device__ __forceinline__ void range_prefix(const Sync& s, long lo, long hi,
                                             int before) {
  for (long c = lo; c < hi; ++c) {
    s.pre[c] = before;
    before += s.cnt[c];
  }
}

// Step 5 for chunk c.
template <int kAnchored>
__device__ __forceinline__ void write_chunk(const Sync& s, long c,
                                           const ChunkInfo& k,
                                           const Stage& stage) {
  const int bpm = s.a.bpm;
  const long first_mcu = static_cast<long>(k.seg) * s.a.interval;
  long mcus = s.a.n_mcu - first_mcu;
  if (mcus > s.a.interval) mcus = s.a.interval;
  const long total = mcus * bpm;
  // A segment's first chunk enters at its start, whatever the resolve step
  // did (it skips streams whose every chunk is one).
  long g = k.first ? 0 : s.pre[c] - s.pre[s.base[k.seg]];
  if (g >= total) return;
  const int64_t st = k.first ? state_of(k.start, 0) : s.entry[c];
  Cursor w;
  w.p = pos_of(st);
  w.bi = bi_of(st);
  enter_block<kAnchored>(s, w);
  int err = 0, sat = 0, end = -1, off = 0, d = 0;
  long m = first_mcu + g / bpm;
  StagedReader r(s.a.words, s.a.nwords, stage);
  while (g < total) {
    if (w.k == 0) {
      if (w.p >= k.stop) break;
      if (w.p >= s.limit && ++sat > bpm) {  // every further block is the same
        end = s.limit;
        break;
      }
    }
    const bool dc = w.k == 0;
    const bool ended = step<kAnchored>(r, w, s.limit, &off, &d, &err);
    if (dc) {
      long o;
      if (kAnchored) {
        const int32_t* f = s.a.seq + 5 * w.bi;
        o = f[3] + m * f[4];
        int row0 = f[3];  // the component's first row: its lowest row base
        for (int l = 0; l < bpm; ++l)
          if (s.a.seq[5 * l] == f[0] && s.a.seq[5 * l + 3] < row0)
            row0 = s.a.seq[5 * l + 3];
        s.a.slot[o] = f[2];
        s.a.group[o] = static_cast<int32_t>(row0 + first_mcu * f[4]);
      } else {
        o = m * bpm + w.bi;
      }
      s.a.ac_off[o] = off;
      s.a.diff[o] = d;
    }
    if (ended) {
      ++g;
      if (++w.bi == bpm) {
        w.bi = 0;
        ++m;
      }
      enter_block<kAnchored>(s, w);
      if (g == total) end = w.p;
    }
  }
  int32_t* status = s.a.status;
  if (kAnchored) {
    if (end >= 0)
      status[k.seg] = static_cast<int32_t>(
          end - static_cast<long>(s.a.seg_off[k.seg]) * 8);
    if (err) atomic_or_int(status + s.a.nseg + k.seg, 1);
  } else {
    if (end >= 0) status[0] = end;
    if (err) atomic_or_int(status + 1, 1);
  }
}

}  // namespace jt

extern "C" long jt_sync_scratch_bytes(int nwords, int nseg, int bpm,
                                      long n_mcu) {
  return jt::sync_bytes(nwords, nseg, bpm, n_mcu);
}


#ifndef JT_HOST_STANDIN

namespace {

constexpr int kThreads = 128;
constexpr int kScanThreads = jt::kResolveThreads;

unsigned blocks_for(long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

// Scan of v over the thread block (kScanThreads threads, 32 warps): warp
// scans by shuffles, then a scan of the warp totals. Returns the inclusive
// value; *excl gets the exclusive one (`none` for thread 0). sh: 32 slots.
template <typename T, typename Op>
__device__ T block_scan(T v, T* sh, Op op, T none, T* excl) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = 1; d < 32; d <<= 1) {
    const T o = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v = op(o, v);
  }
  if (lane == 31) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    T w = sh[lane];
    for (int d = 1; d < 32; d <<= 1) {
      const T o = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w = op(o, w);
    }
    sh[lane] = w;
  }
  __syncthreads();
  const T before = warp > 0 ? sh[warp - 1] : none;
  T e = __shfl_up_sync(0xffffffffu, v, 1);
  e = lane > 0 ? (warp > 0 ? op(before, e) : e) : before;
  if (warp > 0) v = op(before, v);
  *excl = e;
  __syncthreads();  // sh may be written again
  return v;
}

struct AddInt {
  __device__ int operator()(int a, int b) const { return a + b; }
};
struct ComposeMaps {  // a covers earlier chunks than b
  __device__ uint64_t operator()(uint64_t a, uint64_t b) const {
    return jt::compose_maps(a, b);
  }
};

__device__ __forceinline__ void thread_range(long n, long* lo, long* hi) {
  const long per = (n + kScanThreads - 1) / kScanThreads;
  *lo = threadIdx.x * per;
  *hi = *lo + per < n ? *lo + per : n;
  if (*lo > n) *lo = n;
}

// Segments in tiles of kScanThreads, one per thread (coalesced reads), each
// tile scanned and carried on.
__global__ void __launch_bounds__(kScanThreads) layout_kernel(jt::Sync s) {
  __shared__ int sh[32];
  __shared__ int carry;
  const int nseg = s.a.nseg;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int tile = 0; tile < nseg; tile += kScanThreads) {
    const int g = tile + threadIdx.x;
    const int n = g < nseg ? jt::segment_chunks(s, g) : 0;
    int excl;
    const int incl = block_scan(n, sh, AddInt(), 0, &excl);
    if (g < nseg) s.base[g] = carry + excl;
    __syncthreads();
    if (threadIdx.x == kScanThreads - 1) carry += incl;
    __syncthreads();
  }
  if (threadIdx.x == 0) s.base[nseg] = carry;
  for (int i = threadIdx.x; i < 2 * nseg + 2; i += kScanThreads)
    jt::clear_status(s, i);
}

// Shared memory for a thread block's words.
constexpr int kStageWords = 4096;
constexpr int kMarginWords = 64;  // words past a chunk's end a walk may read

// Copy the words the block's active threads' chunks span (from_bit to
// to_bit, and a margin) to shared memory, at most kStageWords of them.
__device__ jt::Stage stage_block(const jt::Sync& s, bool active, int from_bit,
                                 int to_bit, uint32_t* sm, int* lims) {
  if (threadIdx.x == 0) {
    lims[0] = 0x7FFFFFFF;
    lims[1] = -1;
  }
  __syncthreads();
  if (active) {
    atomicMin(lims, from_bit >> 5);
    atomicMax(lims + 1, (to_bit >> 5) + kMarginWords);
  }
  __syncthreads();
  jt::Stage st;
  const int lo = lims[0];
  int hi = lims[1] < s.a.nwords ? lims[1] : s.a.nwords;
  if (hi > lo + kStageWords) hi = lo + kStageWords;
  if (hi > lo) {
    for (int i = threadIdx.x; i < hi - lo; i += blockDim.x)
      sm[i] = __ldg(s.a.words + lo + i);
    st.w = sm;
    st.lo = lo;
    st.hi = hi;
  }
  __syncthreads();
  return st;
}

template <int kAnchored>
__global__ void __launch_bounds__(kThreads) speculate_kernel(jt::Sync s) {
  __shared__ uint32_t sm[kStageWords];
  __shared__ int lims[2];
  const long i = static_cast<long>(blockIdx.x) * kThreads + threadIdx.x;
  const long c = i / s.lanes;
  const int b = static_cast<int>(i - c * s.lanes);
  const bool active = i < s.maxc * s.lanes && c < s.base[s.a.nseg];
  jt::ChunkInfo k{};
  if (active) k = jt::first_look(s, c, b);
  const jt::Stage st =
      stage_block(s, active && !k.last && !(k.first && b > 0), k.start,
                  k.start + s.chunk, sm, lims);
  if (active) jt::speculate<kAnchored>(s, c, b, k, st);
}

template <int kAnchored>
__global__ void __launch_bounds__(kThreads) link_kernel(jt::Sync s) {
  __shared__ uint32_t sm[kStageWords];
  __shared__ int lims[2];
  const long i = static_cast<long>(blockIdx.x) * kThreads + threadIdx.x;
  const long c = i / s.lanes;
  const bool active = i < s.maxc * s.lanes && c < s.base[s.a.nseg];
  jt::ChunkInfo k{};
  if (active) k = jt::chunk_info(s, c);
  const jt::Stage st = stage_block(s, active && !k.first && !k.last, k.start,
                                   k.start + s.chunk, sm, lims);
  if (active)
    jt::link<kAnchored>(s, c, static_cast<int>(i - c * s.lanes), k, st);
}

template <int kAnchored>
__global__ void __launch_bounds__(kScanThreads) resolve_kernel(jt::Sync s) {
  __shared__ uint64_t maps[32];
  __shared__ int sums[32];
  __shared__ int any_open;
  const long total = s.base[s.a.nseg];
  if (total == s.a.nseg) {  // every chunk starts its segment: nothing to do
    if (threadIdx.x == 0) s.passes[0] = 0;
    return;
  }
  long lo, hi;
  thread_range(total, &lo, &hi);
  jt::unresolve_range(s, lo, hi);
  __syncthreads();
  int rounds = 0;
  for (;;) {
    // The maps before this range, applied to lane 0 (chunk 0 is a first
    // chunk, whose map is constant, so the start lane does not matter).
    uint64_t before;
    block_scan(jt::range_map(s, lo, hi), maps, ComposeMaps(),
               jt::identity_map(), &before);
    jt::seed_range<kAnchored>(s, lo, hi, jt::apply_map(before, 0));
    __syncthreads();
    if (threadIdx.x == 0) any_open = 0;
    __syncthreads();
    if (jt::walk_range<kAnchored>(s, lo, hi)) any_open = 1;
    __syncthreads();
    ++rounds;
    if (!any_open) break;
  }
  int before_n;
  block_scan(jt::range_count(s, lo, hi), sums, AddInt(), 0, &before_n);
  jt::range_prefix(s, lo, hi, before_n);
  if (threadIdx.x == 0) s.passes[0] = rounds;
}

template <int kAnchored>
__global__ void __launch_bounds__(kThreads) write_kernel(jt::Sync s) {
  __shared__ uint32_t sm[kStageWords];
  __shared__ int lims[2];
  const long c = static_cast<long>(blockIdx.x) * kThreads + threadIdx.x;
  const bool active = c < s.maxc && c < s.base[s.a.nseg];
  jt::ChunkInfo k{};
  if (active) k = jt::chunk_info(s, c);
  const jt::Stage st = stage_block(s, active, k.start,
                                   k.start + s.chunk, sm, lims);
  if (active) jt::write_chunk<kAnchored>(s, c, k, st);
}

int launched() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

extern "C" int jt_sync_layout(const SyncArgs* a, void* stream) {
  if (a->nseg < 1 || a->bpm < 1 || a->nwords < 1) return cudaErrorInvalidValue;
  layout_kernel<<<1, kScanThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      jt::make_sync(*a));
  return launched();
}

extern "C" int jt_sync_speculate(const SyncArgs* a, void* stream) {
  const jt::Sync s = jt::make_sync(*a);
  const unsigned grid = blocks_for(s.maxc * s.lanes);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->anchored) speculate_kernel<1><<<grid, kThreads, 0, st>>>(s);
  else speculate_kernel<0><<<grid, kThreads, 0, st>>>(s);
  return launched();
}

extern "C" int jt_sync_link(const SyncArgs* a, void* stream) {
  const jt::Sync s = jt::make_sync(*a);
  const unsigned grid = blocks_for(s.maxc * s.lanes);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->anchored) link_kernel<1><<<grid, kThreads, 0, st>>>(s);
  else link_kernel<0><<<grid, kThreads, 0, st>>>(s);
  return launched();
}

extern "C" int jt_sync_resolve(const SyncArgs* a, void* stream) {
  const jt::Sync s = jt::make_sync(*a);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->anchored) resolve_kernel<1><<<1, kScanThreads, 0, st>>>(s);
  else resolve_kernel<0><<<1, kScanThreads, 0, st>>>(s);
  return launched();
}

extern "C" int jt_sync_write(const SyncArgs* a, void* stream) {
  const jt::Sync s = jt::make_sync(*a);
  const unsigned grid = blocks_for(s.maxc);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->anchored) write_kernel<1><<<grid, kThreads, 0, st>>>(s);
  else write_kernel<0><<<grid, kThreads, 0, st>>>(s);
  return launched();
}

#endif  // JT_HOST_STANDIN
