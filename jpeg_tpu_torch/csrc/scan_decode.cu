// A scan's device Huffman decode, enqueued from one C call: the host half of
// the "device" route of entropy/decode_device.
//
// No counterpart of its own in the reference: it strings together what
// jpeg_tpu/entropy/decode_device.py runs as separate jitted programs
// (`_jit_prefix_index` :866 or `_jit_segments` :117, then
// `_decode_ac_indexed` :179), with the host steps between them.
//
// Two entries, both plain C and both without the GIL (ctypes releases it):
//   - jt_split_scan: the scan's bytes split at RST0-7 with the 0x00 after
//     each 0xFF removed, in one pass: the segments one after another as
//     big-endian words with a zero guard behind them, each segment's first
//     byte and its length. The caller's buffer is pinned on a card, so that
//     the upload below does not block;
//   - jt_scan_decode: on the given stream, in order, the words' copy to the
//     card (with the segments' offsets and the DC sums' zeroed control words
//     behind them, one copy), an event behind it (the host buffer's reuse
//     waits for it), the five launches of the block-start program
//     (prefix_index.cu; anchored at every segment, or from bit 0 without
//     markers), the DC sums (dc_sum_kernel, below) and kernel D
//     (ac_indexed.cu). Its workspace, one allocation sized by
//     jt_scan_workspace, holds the upload, the program's scratch, the
//     per-block arrays, kernel D's offsets and DCs and the status.
//
// The DC sums, one launch. Kernel D wants per block, component-major, the
// bit offset past its DC code and its absolute DC. The block-start program
// writes each block's DC difference: component-major when anchored, in MCU
// order (m * bpm + block of the MCU) from bit 0. The absolute DC is a sum of
// the differences of the block's component from the last predictor reset:
// in component-major order a segmented inclusive scan. Anchored, a block is
// a reset where the program's group (its component's first block in its
// segment) is the block itself; from bit 0, at each component's first
// block. Tiles of kDcThreads x kDcItems blocks, taken in order from a
// counter (so every tile a tile waits for runs, as in pack_scan.cu). A tile
// loads its blocks striped (thread t's k-th block is k * kDcThreads + t, so
// a warp's loads and stores are coalesced; from bit 0 the gather from MCU
// order, and kernel D's offsets and AC table slots written in
// component-major order) into shared memory, each thread then scans its
// kDcItems consecutive blocks there (the run: a sum since the last reset,
// and whether there was one), a block scan of the runs gives the tile's,
// which it publishes. It reads the runs of the tiles before it, kDcThreads
// at a time and nearest first, up to the first that holds a reset or is
// complete (a tile that has its prefix publishes its run since the last
// reset before it, marked as complete), writes its DCs into shared memory
// and stores them striped. Sums wrap at 32 bits, as the int64 sums cast to int32 did.
//
// Bound on the H100: the differences (and anchored the groups) in and the
// DCs out (12 bytes a block; from bit 0 also the offsets in, and the offsets
// and slots out: 20) take ~1.2 us at 3.35 TB/s for the 194,400 blocks of a
// 4K 4:2:0 frame from bit 0; a launch of a few tiles is as long as its
// latency: the counter, a load, the block scan, the runs before it, a store.
//
// What a thread does between the barriers and the waits is in the jt::
// functions before the kernel, which JT_HOST_STANDIN builds alone: the tests
// drive them with g++ (tests/test_torch_entropy_device.py), and the chain
// then calls the other kernels' host stand-ins by their C names.

#include <cstring>

#include "prefix_index.cu"
#include "ac_indexed.cu"

// The C entries of the two other kernels the chain enqueues (defined in
// prefix_index.cu and ac_indexed.cu; by the host stand-ins under
// JT_HOST_STANDIN).
extern "C" int jt_sync_layout(const SyncArgs* a, void* stream);
extern "C" int jt_sync_speculate(const SyncArgs* a, void* stream);
extern "C" int jt_sync_link(const SyncArgs* a, void* stream);
extern "C" int jt_sync_resolve(const SyncArgs* a, void* stream);
extern "C" int jt_sync_write(const SyncArgs* a, void* stream);
extern "C" int jt_ac_indexed(const void* words, int nwords, const void* off,
                             const void* dc, const void* slot,
                             const void* tables, int nslots, void* rows,
                             long nblocks, void* stream);

constexpr int kMaxComps = 4;

// The DC sums' arguments.
struct DcArgs {
  int anchored;
  long nblocks;
  long n_mcu;
  int bpm;              // blocks per MCU
  int ncomp;            // from bit 0: the components
  int comp_bpm[kMaxComps];  // from bit 0: their blocks per MCU, scan order
  const int32_t* diff;  // per block: DC difference (program's order)
  const int32_t* group;   // anchored: per block, its predictor's reset
  const int32_t* ac_off;  // from bit 0: per block, MCU order
  const int32_t* seq;     // from bit 0: (bpm, 3) dc slot, ac slot, class
  int32_t* dc;          // out, component-major
  int32_t* off;         // from bit 0, out: AC offsets, component-major
  int32_t* slot;        // from bit 0, out: AC table slots, component-major
  unsigned long long* ctl;  // zeroed: [0] tile counter, [1 + t] tile t's run
};

// The whole chain's arguments, as the Python wrapper fills them.
struct ScanArgs {
  int anchored;         // 1: a segment per restart interval; 0: from bit 0
  int nwords;           // the scan's words, guard included
  int nseg;             // segments (1 from bit 0)
  int bpm;
  long interval;        // MCUs per segment (the MCU count from bit 0)
  long n_mcu;
  int ncomp;            // from bit 0: the components
  int comp_bpm[kMaxComps];  // from bit 0: their blocks per MCU, scan order
  int nslots;           // rows of tables
  const int32_t* seq;   // anchored (bpm, 5), from bit 0 (bpm, 3)
  const int32_t* tables;
  // The scan in host memory (words at 0, the segments' offsets at word
  // host_seg; host_cap bytes, the control words are zeroed behind them),
  // or null: then words and seg_off are on the card already.
  int32_t* host;
  long host_seg;
  long host_cap;
  const int32_t* words;
  const int32_t* seg_off;
  void* event;          // recorded behind the upload, or null
  void* workspace;      // jt_scan_workspace bytes
  int32_t* rows;        // out: (n_mcu * bpm, 64)
};

namespace jt {

// 256 x 4 blocks a tile: of the tile sizes timed on the H100 (128-512
// threads, 4-16 blocks a thread) the shortest at every size, as a tile's
// latency grows with its blocks a thread (PERF.md section 6).
#ifndef JT_DC_THREADS
#define JT_DC_THREADS 256
#endif
#ifndef JT_DC_ITEMS
#define JT_DC_ITEMS 4
#endif

constexpr int kDcThreads = JT_DC_THREADS;
constexpr int kDcItems = JT_DC_ITEMS;
constexpr int kDcTile = kDcThreads * kDcItems;
constexpr unsigned long long kDcReady = 1ull << 63;
constexpr unsigned long long kDcHead = 1ull << 62;

// A tile's blocks in shared memory: one word of padding every 32, so that
// neither a warp's striped nor its consecutive reads share a bank.
__device__ __forceinline__ int dc_at(int i) { return i + i / 32; }
constexpr int kDcShared = kDcTile + kDcTile / 32;

inline long dc_tiles(long nblocks) {
  return nblocks > 0 ? (nblocks + kDcTile - 1) / kDcTile : 0;
}

// A run: the sum since the last reset (low 32 bits) and whether it holds one.
__device__ __forceinline__ unsigned long long dc_run(uint32_t v, bool head) {
  return (head ? kDcHead : 0ull) | v;
}

// Run a, then run b.
__device__ __forceinline__ unsigned long long dc_combine(unsigned long long a,
                                                         unsigned long long b) {
  if (b & kDcHead) return b;
  return (a & kDcHead) | static_cast<uint32_t>(static_cast<uint32_t>(a) +
                                               static_cast<uint32_t>(b));
}

// From bit 0, block o of the component-major order: its difference's index
// in MCU order, its block of the MCU, and whether it is its component's
// first. Counts below 2^31: a scan holds at most 2^30 blocks (2 bits a
// block, 2^26 words). The components' sizes are read at constant indices:
// an array in the kernel's arguments indexed at run time would be copied to
// local memory.
__device__ __forceinline__ bool dc_place(const DcArgs& a, long o, int* src,
                                         int* bi) {
  long base = 0;
  int bi0 = 0, per = a.comp_bpm[0];
  bool more = true;
#pragma unroll
  for (int c = 0; c + 1 < kMaxComps; ++c) {
    const long n = a.n_mcu * a.comp_bpm[c];
    if (more && c + 1 < a.ncomp && o >= base + n) {
      base += n;
      bi0 += a.comp_bpm[c];
      per = a.comp_bpm[c + 1];
    } else {
      more = false;
    }
  }
  const int p = static_cast<int>(o - base);
  const int m = p / per;
  *bi = bi0 + p - m * per;
  *src = m * a.bpm + *bi;
  return p == 0;
}

// Thread t of the tile at block `base`: its blocks base + k * kDcThreads + t,
// their differences into sh (at dc_at of their place in the tile) and
// whether each is a reset into heads; from bit 0 also kernel D's offset and
// AC table slot of each. All loads before any store.
__device__ __forceinline__ void dc_load(const DcArgs& a, long base, int t,
                                        uint32_t* sh, bool* heads) {
  uint32_t v[kDcItems];
  bool h[kDcItems];
  int32_t off[kDcItems], slot[kDcItems];
#pragma unroll
  for (int k = 0; k < kDcItems; ++k) {
    const long o = base + k * kDcThreads + t;
    v[k] = 0;
    h[k] = false;
    if (o >= a.nblocks) continue;
    if (a.anchored) {
      v[k] = static_cast<uint32_t>(a.diff[o]);
      h[k] = a.group[o] == o;
    } else {
      int src, bi;
      h[k] = dc_place(a, o, &src, &bi);
      v[k] = static_cast<uint32_t>(a.diff[src]);
      off[k] = a.ac_off[src];
      slot[k] = a.seq[3 * bi + 1];
    }
  }
#pragma unroll
  for (int k = 0; k < kDcItems; ++k) {
    const int i = k * kDcThreads + t;
    sh[dc_at(i)] = v[k];
    heads[dc_at(i)] = h[k];
    const long o = base + i;
    if (!a.anchored && o < a.nblocks) {
      a.off[o] = off[k];
      a.slot[o] = slot[k];
    }
  }
}

// Thread t's run: its blocks t * kDcItems + j of the tile, in order.
__device__ __forceinline__ unsigned long long dc_thread_run(
    int t, const uint32_t* sh, const bool* heads) {
  unsigned long long r = 0;
#pragma unroll
  for (int j = 0; j < kDcItems; ++j) {
    const int i = dc_at(t * kDcItems + j);
    r = dc_combine(r, dc_run(sh[i], heads[i]));
  }
  return r;
}

// Thread t's DCs, from the run that flows into it, in place of its
// differences.
__device__ __forceinline__ void dc_thread_write(int t, uint32_t carry,
                                                uint32_t* sh,
                                                const bool* heads) {
#pragma unroll
  for (int j = 0; j < kDcItems; ++j) {
    const int i = dc_at(t * kDcItems + j);
    carry = heads[i] ? sh[i] : carry + sh[i];
    sh[i] = carry;
  }
}

// Thread t's stores of the tile's DCs, striped as they were loaded.
__device__ __forceinline__ void dc_store(const DcArgs& a, long base, int t,
                                         const uint32_t* sh) {
#pragma unroll
  for (int k = 0; k < kDcItems; ++k) {
    const int i = k * kDcThreads + t;
    if (base + i < a.nblocks)
      a.dc[base + i] = static_cast<int32_t>(sh[dc_at(i)]);
  }
}

}  // namespace jt

// Workspace layout of one call, byte offsets (each 8-aligned).
struct ScanCarve {
  long ctl, ctl_bytes, scratch, ac_off, diff, slot, group, off, dc, status,
      total;
};

inline long scan_align8(long n) { return (n + 7) & ~7L; }

inline ScanCarve scan_carve(const ScanArgs& a) {
  const long nblocks = a.n_mcu * a.bpm;
  const long per_block = scan_align8(4 * nblocks);
  ScanCarve c;
  long p = a.host ? scan_align8(4 * (a.host_seg + a.nseg)) : 0;
  c.ctl = p;
  c.ctl_bytes = 8 * (1 + jt::dc_tiles(nblocks));
  p += c.ctl_bytes;
  c.scratch = p;
  p += scan_align8(jt::sync_bytes(a.nwords, a.anchored ? a.nseg : 1, a.bpm,
                                  a.n_mcu));
  c.ac_off = p;
  p += per_block;
  c.diff = p;
  p += per_block;
  c.slot = p;
  p += per_block;
  c.group = p;
  p += a.anchored ? per_block : 0;
  c.off = p;
  p += a.anchored ? 0 : per_block;
  c.dc = p;
  p += per_block;
  c.status = p;
  p += scan_align8(4 * 2 * (a.anchored ? a.nseg : 1));
  c.total = p;
  return c;
}

inline bool scan_valid(const ScanArgs& a) {
  int sum = 0;
  for (int c = 0; c < a.ncomp && c < kMaxComps; ++c) sum += a.comp_bpm[c];
  return a.nwords >= 1 && a.nseg >= 1 && a.bpm >= 1 && a.bpm <= 10 &&
         a.interval >= 1 && a.n_mcu >= 1 &&
         (a.anchored ||
          (a.ncomp >= 1 && a.ncomp <= kMaxComps && sum == a.bpm)) &&
         a.nslots >= 1 &&
         a.nslots <= jt::kMaxSlots && (a.anchored || a.nseg == 1) &&
         (a.host ? a.host_seg >= a.nwords
                 : a.words && (a.seg_off || !a.anchored));
}

// Bytes of the workspace jt_scan_decode takes; at[0] the status's offset in
// it, at[1] the program's scratch (its first word: the resolve rounds),
// at[2] the host bytes the upload reads. 0 for arguments it refuses.
extern "C" long jt_scan_workspace(const ScanArgs* a, long* at) {
  if (!scan_valid(*a)) return 0;
  const ScanCarve c = scan_carve(*a);
  at[0] = c.status;
  at[1] = c.scratch;
  at[2] = a->host ? c.ctl + c.ctl_bytes : 0;
  return c.total;
}

// Bytes of the DC sums' control words for `nblocks` blocks, zeroed before
// their launch: the tile counter and a run per tile.
extern "C" long jt_dc_control_bytes(long nblocks) {
  return 8 * (1 + jt::dc_tiles(nblocks));
}

// The scan split at RST0-7 and unstuffed, as entropy/decode_device's
// unstuffed_segments gives it: `words` (room for (n + 11) / 4 words) gets
// the segments' bytes one after another as big-endian words with at least 8
// zero bytes behind; seg_off and lens (room for n / 2 + 1 each) each
// segment's first byte in them and its length. Returns the segment count.
extern "C" long jt_split_scan(const uint8_t* scan, long n, int32_t* words,
                              int32_t* seg_off, int64_t* lens) {
  uint8_t* out = reinterpret_cast<uint8_t*>(words);
  long w = 0, nseg = 0, seg_start = 0, i = 0;
  while (i < n) {
    // Bytes up to the next 0xFF that has a byte after it go as they are.
    const void* hit = n - 1 > i ? std::memchr(scan + i, 0xFF, n - 1 - i)
                                : nullptr;
    const long stop = hit ? static_cast<const uint8_t*>(hit) - scan : n;
    std::memcpy(out + w, scan + i, stop - i);
    w += stop - i;
    i = stop;
    if (!hit) break;
    const uint8_t next = scan[i + 1];
    if (next == 0x00) {  // stuffing: the 0xFF stays, the 0x00 goes
      out[w++] = 0xFF;
      i += 2;
    } else if ((next & 0xF8) == 0xD0) {  // RST0-7 ends a segment
      seg_off[nseg] = static_cast<int32_t>(seg_start);
      lens[nseg++] = w - seg_start;
      seg_start = w;
      i += 2;
    } else {  // any other byte after 0xFF is read again as it is
      out[w++] = 0xFF;
      i += 1;
    }
  }
  seg_off[nseg] = static_cast<int32_t>(seg_start);
  lens[nseg++] = w - seg_start;
  const long nwords = (w + 8 + 3) / 4;
  std::memset(out + w, 0, nwords * 4 - w);
  for (long k = 0; k < nwords; ++k) {
    uint32_t v;
    std::memcpy(&v, out + 4 * k, 4);
    v = __builtin_bswap32(v);
    std::memcpy(out + 4 * k, &v, 4);
  }
  return nseg;
}

#ifndef JT_HOST_STANDIN

namespace {

struct CombineRuns {
  __device__ unsigned long long operator()(unsigned long long a,
                                           unsigned long long b) const {
    return jt::dc_combine(a, b);
  }
};

__global__ void __launch_bounds__(jt::kDcThreads) dc_sum_kernel(DcArgs a) {
  __shared__ uint32_t sh[jt::kDcShared];
  __shared__ bool heads[jt::kDcShared];
  __shared__ unsigned long long scan_sh[32];
  __shared__ long s_tile;
  __shared__ int s_head;
  __shared__ unsigned s_carry;
  const int t = threadIdx.x;
  if (t == 0) {
    s_tile = static_cast<long>(atomicAdd(a.ctl, 1ull));
    s_head = -1;
    s_carry = 0u;
  }
  __syncthreads();
  const long tile = s_tile;
  const long base = tile * jt::kDcTile;
  jt::dc_load(a, base, t, sh, heads);
  __syncthreads();
  unsigned long long excl;
  const unsigned long long incl = block_scan(
      jt::dc_thread_run(t, sh, heads), scan_sh, CombineRuns(), 0ull, &excl);
  unsigned long long* runs = a.ctl + 1;
  if (t == jt::kDcThreads - 1) atomicExch(runs + tile, incl | jt::kDcReady);
  // The tiles before this one, kDcThreads at a time from the nearest: the
  // last that holds a reset (or is complete), then the sum of the runs from
  // it on. Each run is read once, as it may turn complete meanwhile.
  for (long hi = tile; hi > 0; hi -= jt::kDcThreads) {
    const long q = hi - 1 - t;
    unsigned long long v = 0;
    if (q >= 0) {
      do {
        v = *reinterpret_cast<const volatile unsigned long long*>(runs + q);
      } while ((v & jt::kDcReady) == 0);
      if (v & jt::kDcHead) atomicMax(&s_head, static_cast<int>(q));
    }
    __syncthreads();
    const int head = s_head;
    if (q >= 0 && q >= head) atomicAdd(&s_carry, static_cast<unsigned>(v));
    __syncthreads();
    if (head >= 0) break;
  }
  // Whatever flows in is complete: from a reset, or from the scan's start.
  const unsigned long long in = jt::kDcHead | s_carry;
  if (t == jt::kDcThreads - 1)
    atomicExch(runs + tile, jt::dc_combine(in, incl) | jt::kDcHead |
                                jt::kDcReady);
  jt::dc_thread_write(t, static_cast<uint32_t>(jt::dc_combine(in, excl)), sh,
                      heads);
  __syncthreads();
  jt::dc_store(a, base, t, sh);
}

}  // namespace

extern "C" int jt_dc_sum(const DcArgs* a, void* stream) {
  const long ntiles = jt::dc_tiles(a->nblocks);
  if (ntiles == 0) return 0;
  dc_sum_kernel<<<static_cast<unsigned>(ntiles), jt::kDcThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

#else

extern "C" int jt_dc_sum(const DcArgs* a, void* stream);

#endif  // JT_HOST_STANDIN

namespace {

int scan_upload(void* dst, const void* src, long bytes, void* event,
                void* stream) {
#ifdef JT_HOST_STANDIN
  (void)event;
  (void)stream;
  std::memcpy(dst, src, bytes);
  return 0;
#else
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemcpyAsync(dst, src, bytes, cudaMemcpyHostToDevice, st);
  if (e == cudaSuccess && event)
    e = cudaEventRecord(static_cast<cudaEvent_t>(event), st);
  return static_cast<int>(e);
#endif
}

int scan_zero(void* dst, long bytes, void* stream) {
#ifdef JT_HOST_STANDIN
  (void)stream;
  std::memset(dst, 0, bytes);
  return 0;
#else
  return static_cast<int>(
      cudaMemsetAsync(dst, 0, bytes, static_cast<cudaStream_t>(stream)));
#endif
}

}  // namespace

// The chain on `stream`; 0, or the first error (1: arguments refused).
extern "C" int jt_scan_decode(const ScanArgs* a, void* stream) {
  if (!scan_valid(*a) || !a->workspace || !a->rows || !a->seq || !a->tables)
    return 1;
  const ScanCarve c = scan_carve(*a);
  char* ws = static_cast<char*>(a->workspace);
  const int32_t* words = a->words;
  const int32_t* seg_off = a->seg_off;
  int err;
  if (a->host) {
    if (c.ctl + c.ctl_bytes > a->host_cap) return 1;
    char* h = reinterpret_cast<char*>(a->host);
    std::memset(h + c.ctl, 0, c.ctl_bytes);
    err = scan_upload(ws, h, c.ctl + c.ctl_bytes, a->event, stream);
    words = reinterpret_cast<const int32_t*>(ws);
    seg_off = words + a->host_seg;
  } else {
    err = scan_zero(ws + c.ctl, c.ctl_bytes, stream);
  }
  if (err) return err;
  int32_t* ac_off = reinterpret_cast<int32_t*>(ws + c.ac_off);
  int32_t* diff = reinterpret_cast<int32_t*>(ws + c.diff);
  int32_t* slot = reinterpret_cast<int32_t*>(ws + c.slot);
  int32_t* dc = reinterpret_cast<int32_t*>(ws + c.dc);
  const SyncArgs s = {
      reinterpret_cast<const uint32_t*>(words), a->nwords, a->anchored,
      a->anchored ? seg_off : nullptr, a->anchored ? a->nseg : 1, a->bpm,
      a->interval, a->n_mcu, a->seq, a->tables, ws + c.scratch, ac_off, diff,
      a->anchored ? slot : nullptr,
      a->anchored ? reinterpret_cast<int32_t*>(ws + c.group) : nullptr,
      reinterpret_cast<int32_t*>(ws + c.status)};
  int (*const steps[])(const SyncArgs*, void*) = {
      jt_sync_layout, jt_sync_speculate, jt_sync_link, jt_sync_resolve,
      jt_sync_write};
  for (auto step : steps)
    if ((err = step(&s, stream)) != 0) return err;
  DcArgs d;
  d.anchored = a->anchored;
  d.nblocks = a->n_mcu * a->bpm;
  d.n_mcu = a->n_mcu;
  d.bpm = a->bpm;
  d.ncomp = a->ncomp;
  for (int k = 0; k < kMaxComps; ++k) d.comp_bpm[k] = a->comp_bpm[k];
  d.diff = diff;
  d.group = a->anchored ? reinterpret_cast<int32_t*>(ws + c.group) : nullptr;
  d.ac_off = ac_off;
  d.seq = a->seq;
  d.dc = dc;
  d.off = a->anchored ? nullptr : reinterpret_cast<int32_t*>(ws + c.off);
  d.slot = a->anchored ? nullptr : slot;
  d.ctl = reinterpret_cast<unsigned long long*>(ws + c.ctl);
  if ((err = jt_dc_sum(&d, stream)) != 0) return err;
  return jt_ac_indexed(words, a->nwords, a->anchored ? ac_off : d.off, dc,
                       slot, a->tables, a->nslots, a->rows, d.nblocks, stream);
}
