// Native entropy runtime for the TPU JPEG engine.
//
// The serial inner loops XLA is wrong for — Huffman bit packing and Huffman
// scan decoding — implemented as a small C++ library, multithreaded across
// restart segments (the spec's parallel seam; SURVEY.md §5). This replaces
// nothing in the reference (which never wrote a bitstream at all,
// src/huffman.c stops at symbol statistics); design is from ITU-T T.81
// Annex C/F.
//
// Build: g++ -O3 -shared -fPIC -pthread entropy.cc -o libjtentropy.so

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Bit writer with 0xFF stuffing (T.81 F.1.2.3), 64-bit accumulator.
// ---------------------------------------------------------------------------
struct BitWriter {
  uint8_t* out;
  long cap;
  long pos = 0;
  uint64_t acc = 0;
  int nbits = 0;
  bool overflow = false;

  inline void put(uint32_t code, int len) {
    acc = (acc << len) | (code & ((1ull << len) - 1));
    nbits += len;
    while (nbits >= 8) {
      uint8_t b = static_cast<uint8_t>(acc >> (nbits - 8));
      nbits -= 8;
      if (pos + 2 > cap) { overflow = true; return; }
      out[pos++] = b;
      if (b == 0xFF) out[pos++] = 0x00;
    }
  }

  inline void flush() {
    // Pad remaining bits with 1s to a byte boundary (T.81 F.1.2.1.1).
    if (nbits > 0) {
      int pad = 8 - nbits;
      put((1u << pad) - 1, pad);
    }
  }
};

inline int bit_size(int32_t v) {
  uint32_t m = v < 0 ? -v : v;
  return m ? 32 - __builtin_clz(m) : 0;
}

// Logical (unstuffed) payload bits of a stuffed entropy segment: every
// 0xFF 0x00 pair carries one payload byte. Decoder overrun checks must bound
// against this, not the raw byte length, to match the NumPy walkers
// (BitReader.check() in decode_np/progressive_np).
inline long unstuffed_bits(const uint8_t* d, long len) {
  long n = 0;
  for (long i = 0; i < len; ++i) {
    ++n;
    if (d[i] == 0xFF && i + 1 < len && d[i + 1] == 0x00) ++i;
  }
  return n * 8;
}

// Encode one run of blocks into w. blocks: nblocks*64 int32 zig-zag, DC already
// DPCM-differenced. tbl[b] selects table set 0/1.
void encode_blocks(const int32_t* blocks, const uint8_t* tbl, long nblocks,
                   const uint32_t* dc_code, const uint8_t* dc_len,
                   const uint32_t* ac_code, const uint8_t* ac_len,
                   BitWriter& w) {
  for (long b = 0; b < nblocks && !w.overflow; ++b) {
    const int32_t* blk = blocks + b * 64;
    const int t = tbl[b];
    const uint32_t* dcc = dc_code + t * 256;
    const uint8_t* dcl = dc_len + t * 256;
    const uint32_t* acc_ = ac_code + t * 256;
    const uint8_t* acl = ac_len + t * 256;

    int32_t diff = blk[0];
    int size = bit_size(diff);
    w.put(dcc[size], dcl[size]);
    if (size) {
      uint32_t amp = diff >= 0 ? diff : diff + (1 << size) - 1;
      w.put(amp, size);
    }

    int run = 0;
    for (int k = 1; k < 64; ++k) {
      int32_t v = blk[k];
      if (v == 0) { ++run; continue; }
      while (run > 15) { w.put(acc_[0xF0], acl[0xF0]); run -= 16; }
      int s = bit_size(v);
      int sym = (run << 4) | s;
      w.put(acc_[sym], acl[sym]);
      uint32_t amp = v >= 0 ? v : v + (1 << s) - 1;
      w.put(amp, s);
      run = 0;
    }
    if (run > 0) w.put(acc_[0x00], acl[0x00]);  // EOB
  }
}

}  // namespace

extern "C" {

// Pack a full scan: restart_blocks = blocks per restart segment (0 = one
// segment, no markers). Segments are packed on worker threads and stitched
// with RSTn markers. rst_base offsets the modulo-8 RSTn indices so a caller
// can stream stripes of one scan through multiple calls (streaming mosaic).
// Returns bytes written, or -1 on buffer overflow.
long jt_encode_scan(const int32_t* blocks, const uint8_t* tbl, long nblocks,
                    const uint32_t* dc_code, const uint8_t* dc_len,
                    const uint32_t* ac_code, const uint8_t* ac_len,
                    long restart_blocks, long rst_base, uint8_t* out,
                    long out_cap, int nthreads) {
  if (nblocks == 0) return 0;
  if (restart_blocks <= 0 || restart_blocks >= nblocks) {
    BitWriter w{out, out_cap};
    encode_blocks(blocks, tbl, nblocks, dc_code, dc_len, ac_code, ac_len, w);
    w.flush();
    return w.overflow ? -1 : w.pos;
  }

  const long nseg = (nblocks + restart_blocks - 1) / restart_blocks;
  // Worst case bytes per block: DC 27 bits + 63 AC * 26 bits, x2 for stuffing.
  const long seg_cap = restart_blocks * 420 + 16;
  std::vector<std::vector<uint8_t>> bufs(nseg);
  std::vector<long> lens(nseg);
  std::atomic<long> next{0};
  std::atomic<bool> failed{false};

  int nt = nthreads > 0 ? nthreads : (int)std::thread::hardware_concurrency();
  if (nt > nseg) nt = (int)nseg;
  if (nt < 1) nt = 1;

  auto worker = [&]() {
    for (;;) {
      long s = next.fetch_add(1);
      if (s >= nseg || failed.load(std::memory_order_relaxed)) return;
      long lo = s * restart_blocks;
      long hi = lo + restart_blocks;
      if (hi > nblocks) hi = nblocks;
      bufs[s].resize(seg_cap);
      BitWriter w{bufs[s].data(), seg_cap};
      encode_blocks(blocks + lo * 64, tbl + lo, hi - lo, dc_code, dc_len,
                    ac_code, ac_len, w);
      w.flush();
      if (w.overflow) failed.store(true);
      lens[s] = w.pos;
    }
  };
  std::vector<std::thread> threads;
  for (int i = 1; i < nt; ++i) threads.emplace_back(worker);
  worker();
  for (auto& t : threads) t.join();
  if (failed.load()) return -1;

  long pos = 0;
  for (long s = 0; s < nseg; ++s) {
    if (pos + lens[s] + 2 > out_cap) return -1;
    std::memcpy(out + pos, bufs[s].data(), lens[s]);
    pos += lens[s];
    if (s != nseg - 1) {
      out[pos++] = 0xFF;
      out[pos++] = 0xD0 + ((rst_base + s) & 7);
    }
  }
  return pos;
}

// ---------------------------------------------------------------------------
// Decoder
// ---------------------------------------------------------------------------

namespace {

struct BitReader {
  const uint8_t* data;
  long len;
  long pos = 0;       // byte position
  uint64_t acc = 0;   // left-aligned bits
  int nbits = 0;
  bool error = false;

  inline void fill() {
    while (nbits <= 48) {
      uint8_t b = 0;
      if (pos < len) {
        b = data[pos++];
        if (b == 0xFF) {
          if (pos < len && data[pos] == 0x00) {
            ++pos;  // stuffing
          } else {
            // Hit a marker: treat as end of data (feed zero bits).
            --pos;
            b = 0;
          }
        }
      }
      acc = (acc << 8) | b;
      nbits += 8;
    }
  }

  long used = 0;  // bits consumed — overrun check against len*8

  inline uint32_t peek16() {
    fill();
    return (uint32_t)((acc >> (nbits - 16)) & 0xFFFF);
  }

  inline void drop(int n) { nbits -= n; used += n; }

  inline int32_t read_amp(int size) {
    if (size == 0) return 0;
    fill();
    uint32_t v = (uint32_t)((acc >> (nbits - size)) & ((1u << size) - 1));
    nbits -= size;
    used += size;
    if (v < (1u << (size - 1))) return (int32_t)v - (1 << size) + 1;
    return (int32_t)v;
  }

  // Raw MSB-first bits (no EXTEND) — progressive EOB-run extension bits.
  inline uint32_t read_raw(int n) {
    if (n == 0) return 0;
    fill();
    uint32_t v = (uint32_t)((acc >> (nbits - n)) & ((1u << n) - 1));
    nbits -= n;
    used += n;
    return v;
  }

  inline int read_bit() {
    fill();
    int b = (int)((acc >> (nbits - 1)) & 1);
    --nbits;
    ++used;
    return b;
  }
};

struct DecodeLut {
  // Flat 16-bit-window LUT: sym<0 means invalid code.
  std::vector<int16_t> sym;
  std::vector<uint8_t> len;
  void build(const uint32_t* code, const uint8_t* lens) {
    sym.assign(1 << 16, -1);
    len.assign(1 << 16, 0);
    for (int v = 0; v < 256; ++v) {
      int l = lens[v];
      if (!l) continue;
      uint32_t lo = code[v] << (16 - l);
      uint32_t hi = lo + (1u << (16 - l));
      for (uint32_t i = lo; i < hi; ++i) { sym[i] = (int16_t)v; len[i] = (uint8_t)l; }
    }
  }
};

// One MCU-interleaved segment. layout arrays are per block-in-MCU.
int decode_segment(const uint8_t* data, long dlen, long first_mcu, long n_mcu,
                   int bpm, const uint8_t* blk_comp, const uint8_t* blk_occ,
                   const uint8_t* blk_tbl,
                   const DecodeLut* dc_luts, const DecodeLut* ac_luts,
                   int32_t* out, long* comp_base, int ncomp,
                   const int* comp_bpm) {
  BitReader r{data, dlen};
  int32_t preds[8] = {0};
  const long ubits = unstuffed_bits(data, dlen);

  for (long m = 0; m < n_mcu; ++m) {
    for (int bi = 0; bi < bpm; ++bi) {
      int comp = blk_comp[bi];
      int t = blk_tbl[bi];
      const DecodeLut& dl = dc_luts[t];
      const DecodeLut& al = ac_luts[t];
      long block_index =
          comp_base[comp] + (first_mcu + m) * comp_bpm[comp] + blk_occ[bi];
      int32_t* blk = out + block_index * 64;

      uint32_t w = r.peek16();
      int size = dl.sym[w];
      // size > 16 would shift read_amp out of range (a hostile DHT can bind
      // codes to any symbol value); the NumPy walker errors on the same
      // stream (negative shift in decode_np._decode_segment).
      if (size < 0 || size > 16) return -2;
      r.drop(dl.len[w]);
      int32_t diff = r.read_amp(size);
      preds[comp] += diff;
      blk[0] = preds[comp];

      int k = 1;
      while (k < 64) {
        w = r.peek16();
        int sym = al.sym[w];
        if (sym < 0) return -3;
        r.drop(al.len[w]);
        if (sym == 0) break;       // EOB
        if (sym == 0xF0) { k += 16; continue; }
        k += sym >> 4;
        if (k > 63) return -4;
        blk[k] = r.read_amp(sym & 15);
        ++k;
      }
    }
    if (r.used > ubits) return -5;  // ran past the segment's payload bits
  }
  return 0;
}

}  // namespace

// Decode a full scan (data includes RSTn markers). Layout:
//   bpm: total blocks per MCU; blk_comp/blk_tbl: per block-in-MCU component
//   index and table id; comp_bpm: blocks per MCU per component;
//   comp_base: starting block index of each component in `out` (blocks of one
//   component are contiguous, scan order).
// out must hold sum(comp_bpm)*mcu_count blocks, zero-initialized.
// restart_interval in MCUs (0 = none). Returns 0 or negative error.
long jt_decode_scan(const uint8_t* data, long dlen, long mcu_count,
                    int bpm, const uint8_t* blk_comp, const uint8_t* blk_occ,
                    const uint8_t* blk_tbl,
                    const uint32_t* dc_code, const uint8_t* dc_len,
                    const uint32_t* ac_code, const uint8_t* ac_len,
                    long restart_interval, int ncomp, const int* comp_bpm,
                    int32_t* out, int nthreads) {
  DecodeLut dc_luts[2], ac_luts[2];
  for (int t = 0; t < 2; ++t) {
    dc_luts[t].build(dc_code + t * 256, dc_len + t * 256);
    ac_luts[t].build(ac_code + t * 256, ac_len + t * 256);
  }
  std::vector<long> comp_base(ncomp);
  long base = 0;
  for (int c = 0; c < ncomp; ++c) { comp_base[c] = base; base += comp_bpm[c] * mcu_count; }

  // Split on RST markers.
  struct Seg { long off, len, first_mcu, n_mcu; };
  std::vector<Seg> segs;
  long r = restart_interval > 0 ? restart_interval : mcu_count;
  long start = 0, mcu0 = 0;
  for (long i = 0; i + 1 < dlen; ++i) {
    if (data[i] == 0xFF && data[i + 1] >= 0xD0 && data[i + 1] <= 0xD7) {
      long n = r < mcu_count - mcu0 ? r : mcu_count - mcu0;
      segs.push_back({start, i - start, mcu0, n});
      mcu0 += n;
      start = i + 2;
      ++i;
    }
  }
  segs.push_back({start, dlen - start, mcu0, mcu_count - mcu0});

  std::atomic<long> next{0};
  std::atomic<int> err{0};
  int nt = nthreads > 0 ? nthreads : (int)std::thread::hardware_concurrency();
  if (nt > (int)segs.size()) nt = (int)segs.size();
  if (nt < 1) nt = 1;
  auto worker = [&]() {
    for (;;) {
      long s = next.fetch_add(1);
      if (s >= (long)segs.size() || err.load(std::memory_order_relaxed)) return;
      const Seg& g = segs[s];
      if (g.n_mcu <= 0) continue;
      int e = decode_segment(data + g.off, g.len, g.first_mcu, g.n_mcu, bpm,
                             blk_comp, blk_occ, blk_tbl, dc_luts, ac_luts, out,
                             comp_base.data(), ncomp, comp_bpm);
      if (e) err.store(e);
    }
  };
  std::vector<std::thread> threads;
  for (int i = 1; i < nt; ++i) threads.emplace_back(worker);
  worker();
  for (auto& t : threads) t.join();
  return err.load();
}

// ---------------------------------------------------------------------------
// Index pass for the hybrid host-index/device-decode path (decode_device
// decode_scan_indexed): one light walk over the scan that destuffs the bytes
// and records, per block, the bit offset of its first AC code plus its
// absolute DC value — the device then entropy-decodes every block's AC
// coefficients in parallel (the nvJPEG-style hybrid split, done TPU-shaped).
// Roughly 2x cheaper than a full decode: no coefficient stores, no zig-zag
// writes, amplitude bits skipped rather than EXTENDed (except DC).
// ---------------------------------------------------------------------------

namespace {

// Bit cursor over already-destuffed bytes: one unaligned 64-bit load +
// byteswap per peek. Requires >= 8 readable bytes past every position it
// touches — the caller over-allocates the destuffed buffer (guard bytes);
// mid-buffer over-reads see the next segment's bytes, which is equivalent to
// zero-fill for valid streams (prefix-complete LUTs resolve a final code from
// its own bits alone) and still errors for overruns (the per-block position
// check fires regardless of the bits read).
struct FastCursor {
  const uint8_t* d;
  long bit = 0;  // absolute bit position

  inline uint32_t peek16() const {
    uint64_t w;
    std::memcpy(&w, d + (bit >> 3), 8);
    w = __builtin_bswap64(w);
    return (uint32_t)((w >> (48 - (bit & 7))) & 0xFFFF);
  }
};

// Packed one-load-per-symbol LUTs for the index walk (128 KB per table,
// cache-resident — the separate sym/len int16 arrays of DecodeLut cost two
// dependent loads per symbol and measured as the decode bottleneck).
struct IdxLut {
  // AC: (advance << 8) | sym, advance = code len + amplitude bits skipped.
  // DC: (code len << 8) | size. 0xFFFF = invalid window.
  std::vector<uint16_t> ac, dc;
  void build(const DecodeLut& dcl, const DecodeLut& acl) {
    ac.assign(1 << 16, 0xFFFF);
    dc.assign(1 << 16, 0xFFFF);
    for (int w = 0; w < (1 << 16); ++w) {
      int s = acl.sym[w];
      if (s >= 0) ac[w] = (uint16_t)(((acl.len[w] + (s & 15)) << 8) | s);
      s = dcl.sym[w];
      // size > 16 would shift the amplitude read out of range (hostile DHT);
      // map to invalid so the walker errors like the NumPy twin.
      if (s >= 0 && s <= 16) dc[w] = (uint16_t)((dcl.len[w] << 8) | s);
    }
  }
};

int index_segment(const uint8_t* data, long dlen, long bit_base,
                  long first_mcu, long n_mcu, int bpm,
                  const uint8_t* blk_comp, const uint8_t* blk_occ,
                  const uint8_t* blk_tbl,
                  const IdxLut* luts,
                  int32_t* ac_off, int32_t* dc_out,
                  long* comp_base, const int* comp_bpm) {
  FastCursor r{data};
  const long end_bit = dlen * 8;
  int32_t preds[8] = {0};

  for (long m = 0; m < n_mcu; ++m) {
    for (int bi = 0; bi < bpm; ++bi) {
      int comp = blk_comp[bi];
      const IdxLut& lu = luts[blk_tbl[bi]];
      long block_index =
          comp_base[comp] + (first_mcu + m) * comp_bpm[comp] + blk_occ[bi];

      uint32_t e = lu.dc[r.peek16()];
      if (e == 0xFFFF) return -2;
      r.bit += e >> 8;
      int size = e & 0xFF;
      if (size) {
        uint32_t amp = r.peek16() >> (16 - size);
        r.bit += size;
        preds[comp] += amp < (1u << (size - 1))
                           ? (int32_t)amp - (1 << size) + 1
                           : (int32_t)amp;
      }
      dc_out[block_index] = preds[comp];
      ac_off[block_index] = (int32_t)(bit_base + r.bit);

      int k = 1;
      while (k < 64) {
        e = lu.ac[r.peek16()];
        if (e == 0xFFFF) return -3;
        r.bit += e >> 8;  // code + amplitude bits, skipped together
        int sym = e & 0xFF;
        if (sym == 0) break;              // EOB
        if (sym == 0xF0) { k += 16; continue; }
        k += (sym >> 4) + 1;
        if (k > 64) return -4;
      }
      if (r.bit > end_bit) return -5;
    }
  }
  return 0;
}

}  // namespace

// Destuff + index a full scan (same layout contract as jt_decode_scan).
// destuffed must hold dlen bytes PLUS >= 8 guard bytes (the fast cursor
// does unaligned 64-bit loads; guard past the final segment must be zero).
// ac_off/dc_out hold one int32 per block.
// Returns the destuffed byte length, or a negative error code.
long jt_index_scan(const uint8_t* data, long dlen, long mcu_count,
                   int bpm, const uint8_t* blk_comp, const uint8_t* blk_occ,
                   const uint8_t* blk_tbl,
                   const uint32_t* dc_code, const uint8_t* dc_len,
                   const uint32_t* ac_code, const uint8_t* ac_len,
                   long restart_interval, int ncomp, const int* comp_bpm,
                   uint8_t* destuffed, int32_t* ac_off, int32_t* dc_out,
                   int nthreads) {
  DecodeLut dc_luts[2], ac_luts[2];
  IdxLut idx_luts[2];
  for (int t = 0; t < 2; ++t) {
    dc_luts[t].build(dc_code + t * 256, dc_len + t * 256);
    ac_luts[t].build(ac_code + t * 256, ac_len + t * 256);
    idx_luts[t].build(dc_luts[t], ac_luts[t]);
  }
  std::vector<long> comp_base(ncomp);
  long base = 0;
  for (int c = 0; c < ncomp; ++c) {
    comp_base[c] = base;
    base += comp_bpm[c] * mcu_count;
  }

  // Pass 1 (serial, one memcpy-like sweep): split on RSTn and destuff each
  // segment into `destuffed`, recording per-segment byte offsets there.
  struct Seg { long dst_off, dst_len, first_mcu, n_mcu; };
  std::vector<Seg> segs;
  long r = restart_interval > 0 ? restart_interval : mcu_count;
  long mcu0 = 0, dst = 0, i = 0, seg_start = 0;
  auto close_segment = [&](long end) {
    long off0 = dst;
    for (long j = seg_start; j < end; ++j) {
      uint8_t b = data[j];
      destuffed[dst++] = b;
      if (b == 0xFF && j + 1 < end && data[j + 1] == 0x00) ++j;
    }
    long n = r < mcu_count - mcu0 ? r : mcu_count - mcu0;
    segs.push_back({off0, dst - off0, mcu0, n});
    mcu0 += n;
  };
  for (; i + 1 < dlen; ++i) {
    if (data[i] == 0xFF && data[i + 1] >= 0xD0 && data[i + 1] <= 0xD7) {
      close_segment(i);
      seg_start = i + 2;
      ++i;
    }
  }
  close_segment(dlen);

  // Pass 2: index segments on worker threads.
  std::atomic<long> next{0};
  std::atomic<int> err{0};
  int nt = nthreads > 0 ? nthreads : (int)std::thread::hardware_concurrency();
  if (nt > (int)segs.size()) nt = (int)segs.size();
  if (nt < 1) nt = 1;
  auto worker = [&]() {
    for (;;) {
      long s = next.fetch_add(1);
      if (s >= (long)segs.size() || err.load(std::memory_order_relaxed)) return;
      const Seg& g = segs[s];
      if (g.n_mcu <= 0) continue;
      int e = index_segment(destuffed + g.dst_off, g.dst_len, g.dst_off * 8,
                            g.first_mcu, g.n_mcu, bpm, blk_comp, blk_occ,
                            blk_tbl, idx_luts, ac_off, dc_out,
                            comp_base.data(), comp_bpm);
      if (e) err.store(e);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < nt; ++t) threads.emplace_back(worker);
  worker();
  for (auto& t : threads) t.join();
  if (err.load()) return err.load();
  return dst;
}

// ---------------------------------------------------------------------------
// Sparse pass for the sparse-coefficient device decode path (decode_device
// decode_scan_sparse): one walk over the scan that fully resolves the entropy
// layer on the host — absolute DC per block plus the nonzero AC coefficients
// as (value, zig-zag position) pairs — leaving the device a single dense
// gather-free densify + finish program. ~2-3 B per nonzero coefficient cross
// the host link (vs 128 B/block of dense coefficients), and the device spends
// no time in a serial symbol chain at all: the measured v5e floor for the
// per-symbol while_loop kernel was ~164 ms on a 4K stream
// (tools/tpu_probe7g.py) against ~15 ms for this walk.
// ---------------------------------------------------------------------------

namespace {

int sparse_segment(const uint8_t* data, long dlen,
                   long first_mcu, long n_mcu, int bpm,
                   const uint8_t* blk_comp, const uint8_t* blk_occ,
                   const uint8_t* blk_tbl, const IdxLut* luts,
                   int16_t* vals, uint8_t* ks, uint8_t* counts,
                   int32_t* dc_out,
                   long* comp_base, const int* comp_bpm) {
  FastCursor r{data};
  const long end_bit = dlen * 8;
  int32_t preds[8] = {0};

  for (long m = 0; m < n_mcu; ++m) {
    for (int bi = 0; bi < bpm; ++bi) {
      int comp = blk_comp[bi];
      const IdxLut& lu = luts[blk_tbl[bi]];
      long block_index =
          comp_base[comp] + (first_mcu + m) * comp_bpm[comp] + blk_occ[bi];
      int16_t* bv = vals + block_index * 63;
      uint8_t* bk = ks + block_index * 63;
      int cnt = 0;

      uint32_t e = lu.dc[r.peek16()];
      if (e == 0xFFFF) return -2;
      r.bit += e >> 8;
      int size = e & 0xFF;
      if (size) {
        uint32_t amp = r.peek16() >> (16 - size);
        r.bit += size;
        preds[comp] += amp < (1u << (size - 1))
                           ? (int32_t)amp - (1 << size) + 1
                           : (int32_t)amp;
      }
      dc_out[block_index] = preds[comp];

      int k = 1;
      while (k < 64) {
        e = lu.ac[r.peek16()];
        if (e == 0xFFFF) return -3;
        int sym = e & 0xFF;
        int adv = e >> 8;  // code len + amplitude bits
        if (sym == 0) { r.bit += adv; break; }        // EOB
        if (sym == 0xF0) { r.bit += adv; k += 16; continue; }
        int s = sym & 15;
        k += sym >> 4;
        if (k > 63) return -4;
        if (s) {
          r.bit += adv - s;  // the Huffman code alone
          uint32_t amp = r.peek16() >> (16 - s);
          r.bit += s;
          bv[cnt] = (int16_t)(amp < (1u << (s - 1))
                                  ? (int32_t)amp - (1 << s) + 1
                                  : (int32_t)amp);
          bk[cnt] = (uint8_t)k;
          ++cnt;
        } else {
          // Nonstandard (run, 0) symbol: a zero coefficient — advances k,
          // emits nothing (the dense walkers store an explicit 0 there).
          r.bit += adv;
        }
        ++k;
      }
      counts[block_index] = (uint8_t)cnt;
      if (r.bit > end_bit) return -5;
    }
  }
  return 0;
}

}  // namespace

// Sparse-coefficient scan pass (same layout contract as jt_index_scan).
// vals/ks must hold total_blocks*63 entries, counts/dc_out one per block.
// On success the first return-value entries of vals/ks are the compacted
// per-block nonzero runs (block-major, zig-zag order within a block) and
// counts[b] gives each block's share. Returns the total nonzero count, or a
// negative error code.
long jt_sparse_scan(const uint8_t* data, long dlen, long mcu_count,
                    int bpm, const uint8_t* blk_comp, const uint8_t* blk_occ,
                    const uint8_t* blk_tbl,
                    const uint32_t* dc_code, const uint8_t* dc_len,
                    const uint32_t* ac_code, const uint8_t* ac_len,
                    long restart_interval, int ncomp, const int* comp_bpm,
                    int16_t* vals, uint8_t* ks, uint8_t* counts,
                    int32_t* dc_out, int nthreads) {
  DecodeLut dc_luts[2], ac_luts[2];
  IdxLut idx_luts[2];
  for (int t = 0; t < 2; ++t) {
    dc_luts[t].build(dc_code + t * 256, dc_len + t * 256);
    ac_luts[t].build(ac_code + t * 256, ac_len + t * 256);
    idx_luts[t].build(dc_luts[t], ac_luts[t]);
  }
  std::vector<long> comp_base(ncomp);
  long base = 0;
  for (int c = 0; c < ncomp; ++c) {
    comp_base[c] = base;
    base += comp_bpm[c] * mcu_count;
  }
  const long total_blocks = base;

  // Pass 1: split on RSTn and destuff into an internal scratch (guard bytes
  // for the 64-bit cursor).
  std::vector<uint8_t> destuffed((size_t)(dlen > 0 ? dlen : 1) + 512, 0);
  struct Seg { long dst_off, dst_len, first_mcu, n_mcu; };
  std::vector<Seg> segs;
  long r = restart_interval > 0 ? restart_interval : mcu_count;
  long mcu0 = 0, dst = 0, i = 0, seg_start = 0;
  auto close_segment = [&](long end) {
    long off0 = dst;
    for (long j = seg_start; j < end; ++j) {
      uint8_t b = data[j];
      destuffed[dst++] = b;
      if (b == 0xFF && j + 1 < end && data[j + 1] == 0x00) ++j;
    }
    long n = r < mcu_count - mcu0 ? r : mcu_count - mcu0;
    segs.push_back({off0, dst - off0, mcu0, n});
    mcu0 += n;
  };
  for (; i + 1 < dlen; ++i) {
    if (data[i] == 0xFF && data[i + 1] >= 0xD0 && data[i + 1] <= 0xD7) {
      close_segment(i);
      seg_start = i + 2;
      ++i;
    }
  }
  close_segment(dlen);

  // Pass 2: walk segments on worker threads (disjoint block ranges).
  std::atomic<long> next{0};
  std::atomic<int> err{0};
  int nt = nthreads > 0 ? nthreads : (int)std::thread::hardware_concurrency();
  if (nt > (int)segs.size()) nt = (int)segs.size();
  if (nt < 1) nt = 1;
  auto worker = [&]() {
    for (;;) {
      long s = next.fetch_add(1);
      if (s >= (long)segs.size() || err.load(std::memory_order_relaxed)) return;
      const Seg& g = segs[s];
      if (g.n_mcu <= 0) continue;
      int e = sparse_segment(destuffed.data() + g.dst_off, g.dst_len,
                             g.first_mcu, g.n_mcu, bpm, blk_comp, blk_occ,
                             blk_tbl, idx_luts, vals, ks, counts, dc_out,
                             comp_base.data(), comp_bpm);
      if (e) err.store(e);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < nt; ++t) threads.emplace_back(worker);
  worker();
  for (auto& t : threads) t.join();
  if (err.load()) return err.load();

  // Pass 3: compact the strided per-block runs in place (dst <= src always).
  long sp = 0;
  for (long b = 0; b < total_blocks; ++b) {
    int c = counts[b];
    if (c && sp != b * 63) {
      std::memmove(vals + sp, vals + b * 63, (size_t)c * sizeof(int16_t));
      std::memmove(ks + sp, ks + b * 63, (size_t)c);
    }
    sp += c;
  }
  return sp;
}

// ---------------------------------------------------------------------------
// Progressive (SOF2) scan decoding — native twin of entropy/progressive_np.py
// (ITU-T T.81 Annex G decode side; the reference has no decoder at all).
// One call decodes one scan into the caller's per-component zig-zag grids;
// restart segments are independent (DC predictors and the EOB run reset at
// RSTn, F.2.1.3.1) and are decoded on worker threads.
// ---------------------------------------------------------------------------

namespace {

// Per-scan-component geometry into its (gh, gw, 64) int32 coefficient grid.
struct ProgComp {
  int32_t* grid;
  int v, h, gw, bw;
};

// Enumerates the coefficient rows of one restart segment in scan order:
// interleaved MCU order (DC scans over >1 component) or the single
// component's own block raster order.
struct BlockIter {
  const ProgComp* comps;
  int ncomp;
  long mcu_cols;
  bool interleaved;
  // state
  long u, end;  // unit cursor (MCUs or blocks)
  int ci = 0, a = 0, b = 0;

  BlockIter(const ProgComp* c, int n, long cols, bool il, long first, long cnt)
      : comps(c), ncomp(n), mcu_cols(cols), interleaved(il),
        u(first), end(first + cnt) {}

  // Returns the next block's coefficients (and its component index via *ci_out),
  // or nullptr when the segment is exhausted.
  int32_t* next(int* ci_out) {
    if (u >= end) return nullptr;
    if (!interleaved) {
      const ProgComp& c = comps[0];
      int32_t* p = c.grid + ((u / c.bw) * c.gw + (u % c.bw)) * 64;
      *ci_out = 0;
      ++u;
      return p;
    }
    const ProgComp& c = comps[ci];
    long i = u / mcu_cols, j = u % mcu_cols;
    int32_t* p = c.grid + (((i * c.v + a) * c.gw) + (j * c.h + b)) * 64;
    *ci_out = ci;
    if (++b == c.h) {
      b = 0;
      if (++a == c.v) {
        a = 0;
        if (++ci == ncomp) { ci = 0; ++u; }
      }
    }
    return p;
  }
};

int prog_dc_first_seg(BitReader& r, BlockIter it, const DecodeLut* luts,
                      int al) {
  int32_t preds[4] = {0, 0, 0, 0};
  const int32_t scale = 1 << al;
  int ci;
  while (int32_t* coef = it.next(&ci)) {
    uint32_t w = r.peek16();
    int size = luts[ci].sym[w];
    // A hostile DHT can bind codes to symbols > 16; read_amp would then
    // shift out of range (UB). The NumPy twin raises on the same stream.
    if (size < 0 || size > 16) return -2;
    r.drop(luts[ci].len[w]);
    preds[ci] += r.read_amp(size);
    coef[0] = preds[ci] * scale;
  }
  return 0;
}

int prog_dc_refine_seg(BitReader& r, BlockIter it, int al) {
  const int32_t p1 = 1 << al;
  int ci;
  while (int32_t* coef = it.next(&ci)) {
    if (r.read_bit()) coef[0] |= p1;
  }
  return 0;
}

int prog_ac_first_seg(BitReader& r, BlockIter it, const DecodeLut& lut,
                      int ss, int se, int al) {
  long eobrun = 0;
  const int32_t scale = 1 << al;
  int ci;
  while (int32_t* coef = it.next(&ci)) {
    if (eobrun > 0) { --eobrun; continue; }
    int k = ss;
    while (k <= se) {
      uint32_t w = r.peek16();
      int sym = lut.sym[w];
      if (sym < 0) return -3;
      r.drop(lut.len[w]);
      int run = sym >> 4, s = sym & 15;
      if (s == 0) {
        if (run != 15) {
          eobrun = (1L << run) - 1;
          if (run) eobrun += r.read_raw(run);
          break;
        }
        k += 16;  // ZRL
      } else {
        k += run;
        if (k > se) return -4;
        int32_t v = (int32_t)r.read_raw(s);
        if (v < (1 << (s - 1))) v += -(1 << s) + 1;  // EXTEND (F.2.2.1)
        coef[k] = v * scale;
        ++k;
      }
    }
  }
  return 0;
}

int prog_ac_refine_seg(BitReader& r, BlockIter it, const DecodeLut& lut,
                       int ss, int se, int al) {
  const int32_t p1 = 1 << al;
  const int32_t m1 = -(1 << al);
  long eobrun = 0;
  int ci;
  while (int32_t* coef = it.next(&ci)) {
    int k = ss;
    if (eobrun == 0) {
      while (k <= se) {
        uint32_t w = r.peek16();
        int sym = lut.sym[w];
        if (sym < 0) return -3;
        r.drop(lut.len[w]);
        int run = sym >> 4, s = sym & 15;
        int32_t val = 0;
        if (s) {
          // s is 1 by spec; the new coefficient's sign bit.
          val = r.read_bit() ? p1 : m1;
        } else if (run != 15) {
          eobrun = 1L << run;
          if (run) eobrun += r.read_raw(run);
          break;  // EOB run includes this block: handled below
        }
        // Advance over `run` zero-history coefficients, emitting correction
        // bits for every nonzero-history one passed.
        while (k <= se) {
          if (coef[k] != 0) {
            if (r.read_bit() && !(coef[k] & p1))
              coef[k] += coef[k] >= 0 ? p1 : m1;
          } else {
            if (run == 0) break;
            --run;
          }
          ++k;
        }
        if (val) {
          if (k > se) return -4;
          coef[k] = val;
        }
        ++k;
      }
    }
    if (eobrun > 0) {
      // Remaining band positions: correction bits for nonzero history.
      while (k <= se) {
        if (coef[k] != 0 && r.read_bit() && !(coef[k] & p1))
          coef[k] += coef[k] >= 0 ? p1 : m1;
        ++k;
      }
      --eobrun;
    }
  }
  return 0;
}

}  // namespace

// Decode one progressive scan. kind: 0 = DC first, 1 = DC refine,
// 2 = AC first, 3 = AC refine. data includes RSTn markers. n_units counts
// MCUs for interleaved DC scans, blocks otherwise. comp_* arrays and `grids`
// are per scan component (AC scans: exactly 1); codes/lens are (ncomp, 256)
// stacked Huffman tables (DC tables for kind 0, the AC table for kinds 2/3;
// ignored for kind 1). Returns 0 or a negative error code.
long jt_progressive_scan(const uint8_t* data, long dlen, int kind,
                         int ss, int se, int al,
                         long n_units, long restart_interval, long mcu_cols,
                         int ncomp, const int32_t* comp_v,
                         const int32_t* comp_h, const int32_t* comp_gw,
                         const int32_t* comp_bw, int32_t** grids,
                         const uint32_t* codes, const uint8_t* lens,
                         int nthreads) {
  if (ncomp < 1 || ncomp > 4) return -7;
  ProgComp comps[4];
  for (int c = 0; c < ncomp; ++c)
    comps[c] = ProgComp{grids[c], comp_v[c], comp_h[c], comp_gw[c],
                        comp_bw[c]};
  std::vector<DecodeLut> luts(kind == 1 ? 0 : ncomp);
  for (int c = 0; c < (int)luts.size(); ++c)
    luts[c].build(codes + c * 256, lens + c * 256);
  const bool interleaved = ncomp > 1;

  // Split on RST markers (same framing as jt_decode_scan).
  struct Seg { long off, len, first, n; };
  std::vector<Seg> segs;
  long r = restart_interval > 0 ? restart_interval : n_units;
  long start = 0, u0 = 0;
  for (long i = 0; i + 1 < dlen; ++i) {
    if (data[i] == 0xFF && data[i + 1] >= 0xD0 && data[i + 1] <= 0xD7) {
      long n = r < n_units - u0 ? r : n_units - u0;
      segs.push_back({start, i - start, u0, n});
      u0 += n;
      start = i + 2;
      ++i;
    }
  }
  segs.push_back({start, dlen - start, u0, n_units - u0});
  if ((long)segs.size() != (n_units + r - 1) / r) return -6;

  std::atomic<long> next{0};
  std::atomic<int> err{0};
  int nt = nthreads > 0 ? nthreads : (int)std::thread::hardware_concurrency();
  if (nt > (int)segs.size()) nt = (int)segs.size();
  if (nt < 1) nt = 1;
  auto worker = [&]() {
    for (;;) {
      long s = next.fetch_add(1);
      if (s >= (long)segs.size() || err.load(std::memory_order_relaxed))
        return;
      const Seg& g = segs[s];
      if (g.n <= 0) continue;
      BitReader br{data + g.off, g.len};
      BlockIter it(comps, ncomp, mcu_cols, interleaved, g.first, g.n);
      int e;
      switch (kind) {
        case 0: e = prog_dc_first_seg(br, it, luts.data(), al); break;
        case 1: e = prog_dc_refine_seg(br, it, al); break;
        case 2: e = prog_ac_first_seg(br, it, luts[0], ss, se, al); break;
        case 3: e = prog_ac_refine_seg(br, it, luts[0], ss, se, al); break;
        default: e = -7;
      }
      // Bound against the unstuffed payload length (not raw bytes): matches
      // the NumPy walker's BitReader.check() in progressive_np.py.
      if (!e && br.used > unstuffed_bits(data + g.off, g.len)) e = -5;
      if (e) err.store(e);
    }
  };
  std::vector<std::thread> threads;
  for (int i = 1; i < nt; ++i) threads.emplace_back(worker);
  worker();
  for (auto& t : threads) t.join();
  return err.load();
}

// Symbol frequency counting for Annex-K.2 optimized tables: the native twin
// of encode_np.count_frequencies / ops/symbols.py. hists: 4x256 int64
// [dc_tbl0, ac_tbl0, dc_tbl1, ac_tbl1], zero-initialized by caller.
void jt_count_symbols(const int32_t* blocks, const uint8_t* tbl, long nblocks,
                      int64_t* hists) {
  for (long b = 0; b < nblocks; ++b) {
    const int32_t* blk = blocks + b * 64;
    int t = tbl[b];
    int64_t* dc = hists + (t ? 512 : 0);
    int64_t* ac = dc + 256;
    dc[bit_size(blk[0])]++;
    int run = 0;
    for (int k = 1; k < 64; ++k) {
      int32_t v = blk[k];
      if (v == 0) { ++run; continue; }
      while (run > 15) { ac[0xF0]++; run -= 16; }
      ac[(run << 4) | bit_size(v)]++;
      run = 0;
    }
    if (run > 0) ac[0x00]++;
  }
}

// Finalize device-packed word segments into one entropy-coded scan: for each
// segment emit ceil(total_bits/8) big-endian bytes from its uint32 words,
// 1-pad the final partial byte (spec F.1.2.1.1), stuff a 0x00 after every
// 0xFF (F.1.2.3), and join segments with RSTn markers (n = (rst_base + s)
// mod 8). The C-speed twin of ops/bitpack.finalize_segment, one call per
// image instead of a Python pass per segment (r3 host_ms was ~30 of the
// sustained-encode tail). Returns bytes written, or -1 if cap is too small.
long jt_finalize_scan(const uint32_t* words, long words_stride,
                      const int64_t* total_bits, long nseg, long rst_base,
                      uint8_t* out, long cap) {
  long o = 0;
  for (long s = 0; s < nseg; ++s) {
    const uint32_t* w = words + s * words_stride;
    long tb = total_bits[s];
    long nbytes = (tb + 7) / 8;
    if (nbytes > words_stride * 4 || o + nbytes * 2 + 2 > cap) return -1;
    for (long i = 0; i < nbytes; ++i) {
      uint8_t b = (uint8_t)(w[i >> 2] >> (24 - 8 * (i & 3)));
      if (i == nbytes - 1) {
        int rem = (int)(tb & 7);
        if (rem) b |= (uint8_t)((1u << (8 - rem)) - 1);
      }
      out[o++] = b;
      if (b == 0xFF) out[o++] = 0;
    }
    if (s != nseg - 1) {
      out[o++] = 0xFF;
      out[o++] = (uint8_t)(0xD0 + ((rst_base + s) & 7));
    }
  }
  return o;
}

// Pack sparse-scan outputs into the v2 uint32 upload payload (byte-exact
// twin of decode_device.build_payload, which documents the layout):
// [counts 6b | ks 6b | vals 4b | dc-diff i8 | val_exc u32+i16 |
//  dc_exc u32+i16]. Returns words written, or -1 if an exception bucket is
// too small / cap insufficient. out must be zero-initialized by the caller
// only if cap exceeds the returned size (we write every word we own).
static void pack6(const uint8_t* v, long n16, uint32_t* out) {
  // n16 groups of 16 values -> 3 words each (value j at bits [6j, 6j+6)).
  for (long g = 0; g < n16; ++g) {
    const uint8_t* p = v + g * 16;
    uint64_t lo = 0, hi = 0;
    for (int j = 0; j < 16; ++j) {
      long b = 6 * j;
      if (b < 64) {
        lo |= (uint64_t)p[j] << b;
        if (b > 58) hi |= (uint64_t)p[j] >> (64 - b);
      } else {
        hi |= (uint64_t)p[j] << (b - 64);
      }
    }
    out[g * 3] = (uint32_t)lo;
    out[g * 3 + 1] = (uint32_t)(lo >> 32);
    out[g * 3 + 2] = (uint32_t)hi;
  }
}

long jt_pack_payload(const int16_t* vals, const uint8_t* ks,
                     const uint8_t* counts, const int32_t* dc,
                     long B, long S, long Sp, long Ep, long Edp,
                     uint32_t* out, long cap) {
  long B16 = ((B + 15) / 16) * 16;
  long c6w = (B16 / 16) * 3;
  long k6w = (Sp / 16) * 3;
  long v4w = Sp / 8;
  long d8w = (B + 3) / 4;
  long total = c6w + k6w + v4w + d8w + Ep + Ep / 2 + Edp + Edp / 2;
  if (total > cap) return -1;
  std::memset(out, 0, total * sizeof(uint32_t));

  // counts (pad to B16 with zeros)
  {
    std::vector<uint8_t> buf(B16, 0);
    std::memcpy(buf.data(), counts, B);
    pack6(buf.data(), B16 / 16, out);
  }
  long off = c6w;
  // ks (pad to Sp)
  {
    std::vector<uint8_t> buf(Sp, 0);
    std::memcpy(buf.data(), ks, S);
    pack6(buf.data(), Sp / 16, out + off);
  }
  off += k6w;
  // vals nibbles + exceptions
  uint8_t* nib = reinterpret_cast<uint8_t*>(out + off);
  long nv = 0;
  uint32_t* vexc_i = out + off + v4w + d8w;
  int16_t* vexc_v = reinterpret_cast<int16_t*>(vexc_i + Ep);
  for (long i = 0; i < S; ++i) {
    int v = vals[i];
    int enc;
    if (v < -7 || v > 7) {
      if (nv >= Ep) return -2;
      vexc_i[nv] = (uint32_t)i;
      vexc_v[nv] = (int16_t)v;
      ++nv;
      enc = -8;
    } else {
      enc = v;
    }
    uint8_t n4 = (uint8_t)(enc & 15);
    if (i & 1) nib[i >> 1] |= (uint8_t)(n4 << 4);
    else nib[i >> 1] = n4;
  }
  for (long i = nv; i < Ep; ++i) { vexc_i[i] = (uint32_t)(Sp - 1); vexc_v[i] = 0; }
  // dc diffs + exceptions
  int8_t* d8 = reinterpret_cast<int8_t*>(out + off + v4w);
  long nd = 0;
  uint32_t* dexc_i = vexc_i + Ep + Ep / 2;
  int16_t* dexc_v = reinterpret_cast<int16_t*>(dexc_i + Edp);
  int32_t prev = 0;
  for (long b = 0; b < B; ++b) {
    int32_t diff = dc[b] - prev;
    prev = dc[b];
    if (diff < -127 || diff > 127) {
      if (nd >= Edp) return -3;
      dexc_i[nd] = (uint32_t)b;
      dexc_v[nd] = (int16_t)diff;
      ++nd;
      d8[b] = (int8_t)-128;
    } else {
      d8[b] = (int8_t)diff;
    }
  }
  for (long i = nd; i < Edp; ++i) { dexc_i[i] = (uint32_t)(B - 1); dexc_v[i] = 0; }
  return total;
}

int jt_version() { return 9; }

}  // extern "C"
