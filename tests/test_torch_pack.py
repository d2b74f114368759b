"""The port's bit packer against the JAX package's Pallas packer.

Level 1 is held to kernel A's contract against
pack_pallas.pack_level1_pallas(interpret=True): per-block bit totals equal
for every block, word buffers equal for every block of at most 288 bits
(BLOCK_WORDS * 32). Level 2 must equal pack_pallas.pack_level2 word for word
on the same level-1 output. A finalized scan must equal the native host
packer's bytes. The packed tables kernel A reads (code << 5 | length) must
hold luts_from_tables' codes and lengths. Tolerance 0 throughout. Kernel A
against this plain twin, on the same adversarial blocks, is in
test_torch_cuda.py.

The scan pass (pack_scan): its twin, pack_level2 + native.finalize_scan,
must give exactly the bytes of finalize_segment and the RSTn join over words
built bit by bit from the blocks, with the status (bit totals, ok flags, byte
count) beside them; the kernels' per-thread code (csrc/pack_scan.cu),
compiled for the host with g++ against stand-ins for the CUDA keywords and
run tile by tile and thread by thread through the wrapper's launch, must
equal the twin byte for byte and status for status. The kernels themselves
are held to the twin in test_torch_cuda.py."""

import pathlib
import shutil
import subprocess
import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jpeg_tpu.entropy import huffman as JH, native as JN
from jpeg_tpu.ops import bitpack as JB, pack_pallas as JP

from jpeg_tpu_torch.ops import bitpack as PB, pack as PP

from jpeg_tpu_torch.entropy import huffman as PH, native as PN
from jpeg_tpu_torch.models import encoder as PE

from torch_port_util import (
    LEVEL1_SIZES, adversarial_level1_case, level1_bits, random_blocks,
    scan_block_words)

BUDGET = PB.BLOCK_WORDS * 32


def _luts_np():
    return JB.luts_from_tables(JH.standard_tables())


def _luts_torch():
    return tuple(torch.as_tensor(a.astype(np.int32)) for a in _luts_np())


def _pallas_level1(blocks, tbl):
    buf, tot = JP.pack_level1_pallas(
        jnp.asarray(blocks), jnp.asarray(tbl),
        *(jnp.asarray(a) for a in _luts_np()), interpret=True)
    return np.array(buf), np.array(tot)  # writable copies for torch


def _assert_level1_contract(buf, tot, ref_buf, ref_tot):
    """buf, ref_buf as uint32 (B, 10); tot, ref_tot (B,)."""
    np.testing.assert_array_equal(tot, ref_tot)
    fits = ref_tot <= BUDGET
    np.testing.assert_array_equal(buf[fits], ref_buf[fits])


@pytest.mark.parametrize("n,density", [(16, 0.0), (40, 0.15), (33, 0.3)])
def test_level1_plain_matches_pallas(n, density):
    rng = np.random.default_rng(n)
    blocks = random_blocks(rng, n, density)
    tbl = (rng.random(n) < 0.5).astype(np.int32)
    ref_buf, ref_tot = _pallas_level1(blocks, tbl)
    buf, tot = PP.pack_level1(torch.as_tensor(blocks), torch.as_tensor(tbl),
                              *_luts_torch())
    assert buf.dtype == torch.int32 and tot.dtype == torch.int32
    assert buf.shape == (n, PB.BLOCK_WORDS + 1)
    _assert_level1_contract(buf.numpy().view(np.uint32), tot.numpy(),
                            ref_buf, ref_tot)


@pytest.mark.parametrize("n,density", [(40, 0.15), (33, 0.3)])
def test_level2_plain_matches_pallas(n, density):
    rng = np.random.default_rng(100 + n)
    blocks = random_blocks(rng, n, density)
    tbl = (rng.random(n) < 0.5).astype(np.int32)
    ref_buf, ref_tot = _pallas_level1(blocks, tbl)
    nwords = n * 8 + 2
    w_ref, t_ref, ok_ref = JP.pack_level2(jnp.asarray(ref_buf),
                                          jnp.asarray(ref_tot), nwords)
    buf = torch.as_tensor(ref_buf.view(np.int32))
    words, total, ok = PP.pack_level2(buf[None], torch.as_tensor(ref_tot)[None],
                                      nwords)
    np.testing.assert_array_equal(words[0].numpy().astype(np.uint32),
                                  np.asarray(w_ref))
    assert int(total[0]) == int(t_ref) and bool(ok[0]) == bool(ok_ref)


def test_level2_segments_match_per_segment_pallas():
    """The batched (segments, blocks) level 2 equals the JAX level 2 run on
    each restart segment alone."""
    rng = np.random.default_rng(7)
    nseg, seg_blocks = 3, 12
    blocks = random_blocks(rng, nseg * seg_blocks, 0.08)
    tbl = (rng.random(nseg * seg_blocks) < 0.5).astype(np.int32)
    ref_buf, ref_tot = _pallas_level1(blocks, tbl)
    nwords = seg_blocks * 8 + 2
    words, totals, ok = PP.pack_level2(
        torch.as_tensor(ref_buf.view(np.int32)).reshape(nseg, seg_blocks, -1),
        torch.as_tensor(ref_tot).reshape(nseg, seg_blocks), nwords)
    for s in range(nseg):
        sl = slice(s * seg_blocks, (s + 1) * seg_blocks)
        w_ref, t_ref, ok_ref = JP.pack_level2(
            jnp.asarray(ref_buf[sl]), jnp.asarray(ref_tot[sl]), nwords)
        np.testing.assert_array_equal(words[s].numpy().astype(np.uint32),
                                      np.asarray(w_ref))
        assert int(totals[s]) == int(t_ref) and bool(ok[s]) == bool(ok_ref)


@pytest.mark.parametrize("restart_blocks", [0, 16])
def test_finalized_scan_matches_native_encode_scan(restart_blocks):
    """level 1 -> level 2 -> finalize equals the JAX package's native host
    packer on the same blocks (sparse enough for the 288-bit budget)."""
    rng = np.random.default_rng(restart_blocks + 3)
    n = 48
    blocks = np.zeros((n, 64), dtype=np.int32)
    mask = rng.random((n, 64)) < 0.06
    blocks[mask] = rng.integers(-60, 61, size=mask.sum())
    blocks[:, 0] = rng.integers(-300, 300, size=n)
    tbl = np.tile(np.array([0, 0, 0, 0, 1, 1], np.int32), n // 6)
    nseg = 1 if restart_blocks == 0 else n // restart_blocks
    seg = n // nseg
    buf, tot = PP.pack_level1(torch.as_tensor(blocks), torch.as_tensor(tbl),
                              *_luts_torch())
    words, totals, ok = PP.pack_level2(buf.reshape(nseg, seg, -1),
                                       tot.reshape(nseg, seg), seg * 8 + 2)
    assert bool(ok.all())
    got = PB.finalize_stream(words.numpy().astype(np.uint32), totals.numpy())
    # restart every 16 blocks = every 16/6 MCUs is not an MCU multiple, so
    # pass the block count directly (blocks_per_mcu=1).
    expect = JN.encode_scan(blocks, tbl, JH.standard_tables(),
                            restart_interval=restart_blocks, blocks_per_mcu=1)
    assert got == expect


@pytest.mark.parametrize("n", LEVEL1_SIZES)
def test_level1_plain_matches_pallas_adversarial(n):
    """The adversarial blocks (long zero runs, every magnitude category,
    blocks at and over the 288-bit budget, mixed table ids) at ragged
    sizes: the twin against the Pallas kernel, and both totals against a
    position-by-position count."""
    blocks, tbl = adversarial_level1_case(n, JH.standard_tables())
    ref_buf, ref_tot = _pallas_level1(blocks, tbl)
    buf, tot = PP.pack_level1(torch.as_tensor(blocks), torch.as_tensor(tbl),
                              *_luts_torch())
    _assert_level1_contract(buf.numpy().view(np.uint32), tot.numpy(),
                            ref_buf, ref_tot)
    want = [level1_bits(b, int(t), JH.standard_tables())
            for b, t in zip(blocks, tbl)]
    np.testing.assert_array_equal(tot.numpy(), want)


def _skewed_tables():
    """Optimal tables of geometrically skewed counts: the 16-bit length
    limit binds, and ZRL gets another code than the standard one."""
    out = {}
    for is_ac, nsym in ((0, 12), (1, 162)):
        std = PH.standard_tables()[(is_ac, 0)]
        freq = np.zeros(256, dtype=np.int64)
        for rank, sym in enumerate(np.flatnonzero(std.size)[::-1][:nsym]):
            freq[sym] = max(1, int(2 ** 40 * 0.55 ** rank))
        out[(is_ac, 0)] = out[(is_ac, 1)] = PH.optimal_table(freq)
    return out


@pytest.mark.parametrize("tables", ["standard", "skewed"])
def test_packed_tables_hold_codes_and_lengths(tables):
    htables = PH.standard_tables() if tables == "standard" else _skewed_tables()
    if tables == "skewed":
        assert max(int(t.size.max()) for t in htables.values()) == 16
    dc_code, dc_len, ac_code, ac_len = PB.luts_from_tables(htables)
    packed = PP.pack_tables(*(torch.as_tensor(a.astype(np.int32)) for a in
                              (dc_code, dc_len, ac_code, ac_len)))
    assert packed.shape == (2, 2, 256) and packed.dtype == torch.int32
    for half, code, length in ((0, dc_code, dc_len), (1, ac_code, ac_len)):
        np.testing.assert_array_equal(packed[half].numpy() >> 5, code)
        np.testing.assert_array_equal(packed[half].numpy() & 31, length)


def test_device_luts_cache_follows_the_table_set():
    """The standard set is built once; another set (the optimize_tables
    path) gets its own entry, with its own packed words."""
    std = PE._device_luts(PH.standard_tables(), "cpu")
    assert PE._device_luts(PH.standard_tables(), "cpu") is std
    skew = PE._device_luts(_skewed_tables(), "cpu")
    assert skew is not std
    assert not torch.equal(skew[4], std[4])
    for luts in (std, skew):
        assert torch.equal(luts[4], PP.pack_tables(*luts[:4]))
    # More table sets than the cache holds: the oldest goes, the newest stays.
    for seed in range(PE._LUT_CACHE_SIZE + 1):
        freq = np.random.default_rng(seed).integers(1, 1000, size=256)
        t = PH.optimal_table(freq)
        last = PE._device_luts({(0, 0): t, (1, 0): t, (0, 1): t, (1, 1): t},
                               "cpu")
    assert len(PE._lut_cache) == PE._LUT_CACHE_SIZE
    assert PE._device_luts({(0, 0): t, (1, 0): t, (0, 1): t, (1, 1): t},
                           "cpu") is last



# ---------------------------------------------------------------------------
# The scan pass.
# ---------------------------------------------------------------------------


def _scan_case(name):
    """(buf (S, B, 10) int32, t_b (S, B) int32, nwords, rst_base) of one
    named case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    nseg, nblocks, rst_base = 1, 40, 0
    fill = "random"
    if name == "aligned":  # every total a multiple of 8
        t = rng.integers(0, 37, size=(nseg, nblocks)) * 8
    elif name == "unaligned":
        t = rng.integers(0, 289, size=(nseg, nblocks))
    elif name == "pad_makes_ff":  # ... ending in 1111 + 4 bits of padding
        t = rng.integers(1, 100, size=(nseg, nblocks))
        t[0, -1] = 12
    elif name == "all_ones":  # 8 full words a block: the segment's room
        t = np.full((2, 600), PE.WORDS_PER_BLOCK * 32)
        nseg, fill = 2, "ones"
    elif name == "no_bits":
        t = np.zeros((1, 9), dtype=np.int64)
    elif name == "empty_segment":
        t = rng.integers(0, 120, size=(3, 20))
        t[0] = 0
        t[1] = 0
        nseg = 3
    elif name == "multi_tile":  # several placement and stuffing tiles
        t = rng.integers(0, 289, size=(2, 1500))
        nseg = 2
    elif name == "real":  # kernel A's twin on blocks of a q75-like density
        blocks = random_blocks(rng, 2 * 700, 0.03)
        tbl = (rng.random(blocks.shape[0]) < 0.3).astype(np.int32)
        buf, tot = PP.pack_level1(torch.as_tensor(blocks),
                                  torch.as_tensor(tbl), *_luts_torch())
        return (buf.reshape(2, 700, -1), tot.reshape(2, 700),
                700 * PE.WORDS_PER_BLOCK + 2, 3)
    elif name == "block_over_budget":
        t = rng.integers(0, 200, size=(2, 30))
        t[1, 7] = PB.BLOCK_WORDS * 32 + 20
        nseg = 2
    elif name == "segment_over_room":  # room for 30 words a segment
        t = rng.integers(100, 200, size=(2, 30))
        t[0] = rng.integers(0, 33, size=30)
        return (_case_tensors(rng, t, fill) + (30, 0))
    else:  # "<S> segments, rst_base <n>"
        nseg, rst_base = (int(v) for v in name.split("-"))
        nblocks = 8
        t = rng.integers(0, 200, size=(nseg, nblocks))
        t[0, 0] = 12  # a few bytes that the padding turns into 0xFF
    nblocks = t.shape[1]
    return (_case_tensors(rng, t, fill)
            + (nblocks * PE.WORDS_PER_BLOCK + 2, rst_base))


def _case_tensors(rng, t, fill):
    nseg, nblocks = t.shape
    ones = fill == "ones" or None
    buf = scan_block_words(rng, t.reshape(-1), "ones" if ones else "random")
    if not ones:
        # the 12-bit blocks end in all-ones bits, so that the padding makes
        # the last byte 0xFF when they close a segment
        twelve = t.reshape(-1) == 12
        buf[twelve, 0] = np.int32(-(1 << 20))  # 0xFFF00000
    return (torch.as_tensor(buf).reshape(nseg, nblocks, -1),
            torch.as_tensor(t.astype(np.int32)))


SCAN_OK = ["aligned", "unaligned", "pad_makes_ff", "all_ones", "no_bits",
           "empty_segment", "multi_tile", "real", "1-0", "1-5", "2-0", "2-5",
           "135-0", "135-5", "300-3"]
SCAN_NOT_OK = ["block_over_budget", "segment_over_room"]


def _scan_oracle(buf, t_b, rst_base):
    """Each segment's words made bit by bit from its blocks' first bits,
    finalized by bitpack.finalize_segment, joined with RSTn."""
    parts = []
    nseg = t_b.shape[0]
    for s in range(nseg):
        rows = buf[s].numpy().view(np.uint32)
        bits = [np.unpackbits(r.astype(">u4").view(np.uint8))[:int(t)]
                for r, t in zip(rows, t_b[s].numpy())]
        bits = np.concatenate(bits + [np.zeros(0, np.uint8)])
        nbits = bits.shape[0]
        padded = np.zeros(-(-max(nbits, 1) // 32) * 32, dtype=np.uint8)
        padded[:nbits] = bits
        words = np.packbits(padded).view(">u4").astype(np.uint32)
        parts.append(PB.finalize_segment(words, nbits).tobytes())
        if s < nseg - 1:
            parts.append(bytes([0xFF, 0xD0 + ((rst_base + s) & 7)]))
    return b"".join(parts)


@pytest.mark.parametrize("case", SCAN_OK)
def test_scan_twin_matches_finalize_segment(case):
    buf, t_b, nwords, rst_base = _scan_case(case)
    scan, status = PP.pack_scan(buf, t_b, nwords, rst_base)
    want = _scan_oracle(buf, t_b, rst_base)
    nseg = t_b.shape[0]
    assert status.dtype == torch.int64 and status.shape == (2 * nseg + 1,)
    np.testing.assert_array_equal(status[:nseg].numpy(),
                                  t_b.to(torch.int64).sum(1).numpy())
    assert status[nseg:2 * nseg].tolist() == [1] * nseg
    assert int(status[-1]) == len(want) == scan.numel()
    assert scan.numpy().tobytes() == want
    if case == "all_ones":
        assert len(want) == 2 * 2 * 600 * 32 + 2  # every byte stuffed
    if case == "pad_makes_ff":
        assert want.endswith(b"\xff\x00")
    if case == "empty_segment":
        assert want.startswith(bytes([0xFF, 0xD0, 0xFF, 0xD1]))


@pytest.mark.parametrize("case", SCAN_NOT_OK)
def test_scan_twin_reports_what_level2_does_not_fit(case):
    buf, t_b, nwords, rst_base = _scan_case(case)
    _, total, ok = PP.pack_level2(buf, t_b, nwords)
    scan, status = PP.pack_scan(buf, t_b, nwords, rst_base)
    nseg = t_b.shape[0]
    assert status[:nseg].tolist() == total.tolist()
    assert status[nseg:2 * nseg].tolist() == ok.to(torch.int64).tolist()
    assert ok.tolist() == [True, False] and int(status[-1]) == 0
    assert scan.numel() == 0


_SCAN_STANDIN = r"""
#define JT_HOST_STANDIN
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>
#define __device__
#define __forceinline__ inline
struct uint4 {
  uint32_t x, y, z, w;
};
template <class T>
static inline T __ldg(const T* p) {
  return *p;
}
template <class T>
static inline T __ldcg(const T* p) {
  return *p;
}
static inline unsigned atomicOr(unsigned* p, unsigned v) {
  const unsigned old = *p;
  *p = old | v;
  return old;
}
static inline unsigned long long atomicExch(unsigned long long* p,
                                            unsigned long long v) {
  const unsigned long long old = *p;
  *p = v;
  return old;
}
#include "pack_scan.cu"

using namespace jt_scan;

// The kernels' orchestration with a loop iteration per CUDA thread: a
// tile's threads one after another, block scans as running sums. Every
// placement tile publishes its sum first (as each does before it waits);
// then the tiles finish even ones first, then odd ones, so that a store of a
// word two tiles share lands after the other tile's in one pair and before
// it in the next, each from shared words that hold junk past those zeroed.
// The stuffing's tiles run in reverse order.
extern "C" int jt_pack_scan(const void* buf, const void* bits, void* scratch,
                            void* out, void* status, long nseg, long nblocks,
                            long nwords, long rst_base, void*) {
  if (nseg <= 0 || nblocks <= 0 || nwords <= 0) return 0;
  std::memset(scratch, 0, layout(nseg, nblocks, nwords).zero_bytes);
  const Args a = make_args(buf, bits, scratch, out, status, nseg, nblocks,
                           nwords, rst_base);
  std::vector<int> nb(kPlaceThreads);
  std::vector<long long> at(kPlaceThreads);
  auto place_scan = [&](long tile) {
    long long sum = 0;
    for (int t = 0; t < kPlaceThreads; ++t) {
      nb[t] = place_bits(a, tile, t);
      at[t] = sum;
      sum += nb[t];
    }
    return sum;
  };
  const long nplace = nseg * a.ptiles;
  for (long tile = 0; tile < nplace; ++tile)
    place_publish(a, tile, place_scan(tile));
  std::vector<uint32_t> tw(kTileWords);
  for (long step = 0; step < nplace; ++step) {
    const long half = (nplace + 1) / 2;
    const long tile = step < half ? 2 * step : 2 * (step - half) + 1;
    const long long tile_bits = place_scan(tile);
    std::fill(tw.begin(), tw.end(), 0xA5C3E187u);
    std::fill(tw.begin(), tw.begin() + tile_words_used(tile_bits), 0u);
    long long before = 0;
    for (int t = 0; t < kPlaceThreads; ++t) {
      place_put(a, tw.data(), tile, t, at[t], nb[t]);
      before += place_before(a, tile, t, kPlaceThreads);
    }
    for (int t = 0; t < kPlaceThreads; ++t)
      place_store(a, tw.data(), tile, t, kPlaceThreads, before, tile_bits);
  }
  const long nstuff = nseg * a.stiles;
  uint8_t b[kChunk];
  for (long tile = nstuff - 1; tile >= 0; --tile) {
    long long stuffed = 0;
    for (int t = 0; t < kStuffThreads; ++t)
      stuffed += stuffed_length(b, stuff_chunk(a, tile, t, b));
    count_publish(a, tile, stuffed);
  }
  std::vector<long long> run(kStuffThreads);
  long long total = 0, bad = 0;
  for (int t = 0; t < kStuffThreads; ++t) {
    run[t] = total;
    total += offsets_sum(a, t, kStuffThreads);
  }
  for (int t = 0; t < kStuffThreads; ++t)
    offsets_write(a, t, kStuffThreads, run[t]);
  for (int t = 0; t < kStuffThreads; ++t)
    bad += segments_finish(a, t, kStuffThreads);
  count_total(a, total, bad);
  for (long tile = nstuff - 1; tile >= 0; --tile) {
    if (!stuff_has_bytes(a, tile)) continue;
    long long pos = 0;
    for (int t = 0; t < kStuffThreads; ++t) {
      const int n = stuff_chunk(a, tile, t, b);
      stuff_write(a, tile, pos, b, n);
      pos += stuffed_length(b, n);
    }
  }
  return 0;
}
"""

CSRC = pathlib.Path(PP.__file__).resolve().parent.parent / "csrc"


@pytest.fixture(scope="module")
def scan_standin(tmp_path_factory):
    """The scan pass's per-thread code behind its C entry, built with g++
    for the host."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    d = tmp_path_factory.mktemp("scan_standin")
    (d / "standin.cc").write_text(_SCAN_STANDIN)
    lib = d / "libscan_standin.so"
    subprocess.run(
        ["g++", "-O1", "-std=c++17", "-x", "c++", "-shared", "-fPIC",
         f"-I{CSRC}", "-o", str(lib), str(d / "standin.cc")],
        check=True, capture_output=True, text=True, timeout=300)
    return ctypes.CDLL(str(lib))


@pytest.mark.parametrize("case", SCAN_OK + SCAN_NOT_OK)
def test_scan_kernel_bodies_on_host_standin(scan_standin, case):
    buf, t_b, nwords, rst_base = _scan_case(case)
    before = PP.SCAN_LAUNCHES
    scan, status = PP._pack_scan_cuda(buf, t_b, nwords, rst_base,
                                      lib=scan_standin)
    assert PP.SCAN_LAUNCHES == before + 4
    assert scan.numel() == PP.scan_capacity(t_b.shape[0], nwords)
    want_scan, want_status = PP.pack_scan_reference(buf, t_b, nwords,
                                                    rst_base)
    assert status.tolist() == want_status.tolist()
    count = int(status[-1])
    assert scan[:count].numpy().tobytes() == want_scan.numpy().tobytes()


def test_finish_takes_the_spill_when_a_segment_is_not_ok():
    """Two restart segments, the second dense noise at q100: the scan pass
    reports it not ok, and the finish packs the whole image on the host
    (counted once), exactly as the native packer does."""
    rng = np.random.default_rng(5)
    sparse = np.zeros((10, 64), dtype=np.int32)
    sparse[:, 0] = rng.integers(-30, 30, size=10)
    dense = rng.integers(-900, 900, size=(10, 64)).astype(np.int32)
    blocks = torch.as_tensor(np.concatenate([sparse, dense]))
    tbl = torch.zeros(20, dtype=torch.int32)
    htables = PH.standard_tables()
    luts = PE._device_luts(htables, "cpu")
    scan, status = PP.pack_scan(*PE._level1_segments(blocks, tbl, luts, 20,
                                                     10))
    status = status.numpy()
    assert status[2:4].tolist() == [1, 0] and status[-1] == 0
    spills = PE.HOST_PACK_SPILLS
    got = PE._scan_or_spill(scan, status, blocks, tbl, htables, 10, 1,
                            lambda b: b)
    assert PE.HOST_PACK_SPILLS == spills + 1
    assert got == PN.encode_scan(blocks.numpy(), tbl.numpy(), htables,
                                 restart_interval=10, blocks_per_mcu=1)
