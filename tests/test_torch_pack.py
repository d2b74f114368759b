"""The port's bit packer against the JAX package's Pallas packer.

Level 1 is held to kernel A's contract against
pack_pallas.pack_level1_pallas(interpret=True): per-block bit totals equal
for every block, word buffers equal for every block of at most 288 bits
(BLOCK_WORDS * 32). Level 2 must equal pack_pallas.pack_level2 word for word
on the same level-1 output. A finalized scan must equal the native host
packer's bytes. The packed tables kernel A reads (code << 5 | length) must
hold luts_from_tables' codes and lengths. Tolerance 0 throughout. Kernel A
against this plain twin, on the same adversarial blocks, is in
test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jpeg_tpu.entropy import huffman as JH, native as JN
from jpeg_tpu.ops import bitpack as JB, pack_pallas as JP

from jpeg_tpu_torch.ops import bitpack as PB, pack as PP

from jpeg_tpu_torch.entropy import huffman as PH
from jpeg_tpu_torch.models import encoder as PE

from torch_port_util import (
    LEVEL1_SIZES, adversarial_level1_case, level1_bits, random_blocks)

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

