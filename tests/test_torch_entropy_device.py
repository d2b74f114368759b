"""The port's device Huffman decoders (entropy="indexed", entropy="device")
against the JAX package's, on the CPU.

Everything here is integers: tolerance 0 for coefficients, offsets, DC
differences, end positions and error flags, and for pixels between the
port's own backends. Against jpeg_tpu.decode the port's stated decode
tolerance applies (at most 1 level in at most 0.5% of samples: the two IDCTs
sum in different f32 orders).

On the CPU the wrappers of ops/entropy_decode run their plain twins, so these
tests hold the twins (and the host halves around them) to the reference's
jitted programs. The CUDA kernels' own per-thread code is compiled for the
host with g++ against stand-ins for the CUDA keywords and driven through the
same launch functions, so its arithmetic is exercised here too."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import jpeg_tpu
from jpeg_tpu.entropy import decode_device as JD

import jpeg_tpu_torch
from jpeg_tpu_torch.entropy import decode_device as PD, native
from jpeg_tpu_torch.entropy.decode_np import ScanDecodeError
from jpeg_tpu_torch.io import jfif as PJ
from jpeg_tpu_torch.models import decoder as PDEC
from jpeg_tpu_torch.ops import entropy_decode as ED

import torch_port_fixtures as fixtures
from test_torch_decode_streams import remap_huffman_ids
from torch_port_util import (
    ac_indexed_inputs, make_image, plain_streams, prefix_inputs,
    regroup_prefix, scan_args, segment_inputs)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "jpeg_tpu_torch", "csrc")

# Mode -> image size. 7 divides none of the MCU counts (24, 20, 48, 48).
SIZES = {"420": (64, 96), "422": (40, 56), "444": (48, 64), "gray": (48, 64)}
CASES = [(m, r, o) for m in SIZES for r in (0, 3, 7) for o in (False, True)]
_streams: dict = {}


def stream(mode, restart, optimal):
    key = (mode, restart, optimal)
    if key not in _streams:
        h, w = SIZES[mode]
        img = make_image(h, w, seed=h + restart)
        if mode == "gray":
            img, kw = img[..., 1], {}
        else:
            kw = dict(subsampling=mode)
        _streams[key] = jpeg_tpu_torch.encode(
            img, quality=75, restart_interval=restart,
            optimize_tables=optimal, device="cpu", **kw)
    return _streams[key]


def assert_blocks_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("mode,restart,optimal", CASES)
def test_scan_functions_equal_the_reference(mode, restart, optimal):
    args = scan_args(stream(mode, restart, optimal))
    want = native.decode_scan(*args)
    for port_fn, ref_fn in ((PD.decode_scan_indexed, JD.decode_scan_indexed),
                            (PD.decode_scan, JD.decode_scan)):
        got = port_fn(*args, device="cpu")
        assert all(isinstance(g, torch.Tensor) and g.dtype == torch.int32
                   for g in got)
        assert_blocks_equal(got, want)
        try:
            ref = ref_fn(*args)
        except JD.ScanDecodeError:
            # The reference's segment program freezes the cursor and the
            # predictors of the MCUs it masks past a short tail segment, but
            # not its error flag (jpeg_tpu/entropy/decode_device.py:136-148),
            # so garbage decoded there can fail a valid stream. The port
            # walks no MCU past the count.
            assert ref_fn is JD.decode_scan and restart == 7
            continue
        assert_blocks_equal(got, ref)
    if restart == 0:
        got = PD.decode_scan_prefix(*args[:4], device="cpu")
        assert_blocks_equal(got, want)
        assert_blocks_equal(got, JD.decode_scan_prefix(*args[:4]))


def reference_prefix_inputs(jpg):
    """The key and the arguments of the reference's _jit_prefix_index program
    for one restart-free stream, and the padded size of its buffer."""
    scan, n_mcu, mcu_layout, htables, _ = scan_args(jpg)
    unstuffed = PD.decode_np.unstuff(scan)
    nbytes = 1 << max(8, int(len(unstuffed) + 8).bit_length())
    buf = np.zeros(nbytes, dtype=np.uint8)
    buf[: len(unstuffed)] = unstuffed
    seq = [(dc, ac) for (_, bpm, dc, ac) in mcu_layout for _ in range(bpm)]
    # The reference numbers DC and AC tables apart; the port in one list.
    dc_slots = tuple(sorted({(0, dc) for dc, _ in seq}))
    ac_slots = tuple(sorted({(1, ac) for _, ac in seq}))
    ref_seq = tuple((dc_slots.index((0, dc)), ac_slots.index((1, ac)))
                    for dc, ac in seq)
    ac_luts = np.stack([
        (np.where(s >= 0, l, 16).astype(np.int32) << 16)
        | (np.where(s >= 0, s, -1).astype(np.int32) & 0xFFFF)
        for s, l in (JD.decode_np.make_decode_lut(htables[k])
                     for k in ac_slots)])
    args = (jnp.asarray(buf),
            jnp.asarray(JD._packed_dc_luts(htables, dc_slots)),
            jnp.asarray(ac_luts))
    return (nbytes * 8, ref_seq, n_mcu), args, nbytes


@pytest.mark.parametrize("mode,optimal", [(m, o) for m in SIZES
                                          for o in (False, True)])
def test_prefix_twin_equals_the_reference_program(mode, optimal):
    jpg = stream(mode, 0, optimal)
    ref_key, ref_args, nbytes = reference_prefix_inputs(jpg)
    port_args, true_bits = prefix_inputs(jpg, nbytes=nbytes)
    ac_off, diff, status = ED.prefix_index(*port_args)
    r_off, r_diff, r_end, r_err = JD._jit_prefix_index(*ref_key)(*ref_args)
    np.testing.assert_array_equal(ac_off.numpy(), np.asarray(r_off))
    np.testing.assert_array_equal(diff.numpy(), np.asarray(r_diff))
    assert status.tolist() == [int(r_end), int(bool(r_err))]
    assert status[1] == 0 and true_bits - 7 <= status[0] <= true_bits


def assert_close(got, ref):
    assert got.shape == ref.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert diff.max(initial=0) <= 1
    assert int((diff != 0).sum()) <= 0.005 * diff.size


@pytest.mark.parametrize("entropy", ["indexed", "device"])
@pytest.mark.parametrize("mode,restart,optimal", CASES)
def test_decode_equals_sparse(mode, restart, optimal, entropy):
    jpg = stream(mode, restart, optimal)
    want = jpeg_tpu_torch.decode(jpg, device="cpu", entropy="sparse")
    got = jpeg_tpu_torch.decode(jpg, device="cpu", entropy=entropy)
    np.testing.assert_array_equal(got, want)
    # Restart 7 leaves a short tail segment, where the reference's "device"
    # program can flag a valid stream (test_scan_functions_equal_the_reference
    # says how); "indexed" is held to the reference there too.
    if restart != 7 or entropy == "indexed":
        assert_close(got, jpeg_tpu.decode(jpg, use_pallas=True,
                                          entropy=entropy))


@pytest.mark.parametrize("entropy", ["indexed", "device"])
def test_decode_options_with_the_device_backends(entropy):
    jpg = stream("420", 3, False)
    for kw in (dict(scale_denom=2), dict(fancy_upsample=False)):
        np.testing.assert_array_equal(
            jpeg_tpu_torch.decode(jpg, device="cpu", entropy=entropy, **kw),
            jpeg_tpu_torch.decode(jpg, device="cpu", entropy="sparse", **kw))
    planes = jpeg_tpu_torch.decode(jpg, device="cpu", entropy=entropy,
                                   output="ycbcr")
    want = jpeg_tpu_torch.decode(jpg, device="cpu", entropy="sparse")
    np.testing.assert_array_equal(jpeg_tpu_torch.finish_ycbcr(planes), want)
    out = jpeg_tpu_torch.decode(jpg, device="cpu", entropy=entropy,
                                device_output=True)
    assert isinstance(out, torch.Tensor) and out.dtype == torch.uint8
    np.testing.assert_array_equal(out.numpy(), want)


@pytest.mark.parametrize("entropy", ["indexed", "device"])
@pytest.mark.parametrize("name", ["noninterleaved_444.jpg", "cmyk.jpg",
                                  "ycck.jpg", "progressive_420.jpg"])
def test_fixture_streams_with_the_device_backends(name, entropy):
    """Multi-scan baseline streams decode each scan on the device;
    4-component streams finish as with any backend; progressive streams take
    the host walkers whatever `entropy` says."""
    jpg = fixtures.read(name)
    np.testing.assert_array_equal(
        jpeg_tpu_torch.decode(jpg, device="cpu", entropy=entropy),
        jpeg_tpu_torch.decode(jpg, device="cpu", entropy="native"))


@pytest.mark.parametrize("restart", [0, 4])
def test_noninterleaved_scans_pad_on_the_device(restart):
    img = make_image(43, 59, seed=14)  # chroma grids smaller than the MCU grid
    jpg = jpeg_tpu_torch.encode_noninterleaved(
        img, quality=80, restart_interval=restart, device="cpu")
    want = jpeg_tpu_torch.decode(jpg, device="cpu", entropy="native")
    for entropy in ("indexed", "device"):
        np.testing.assert_array_equal(
            jpeg_tpu_torch.decode(jpg, device="cpu", entropy=entropy), want)
    assert_close(want, jpeg_tpu.decode(jpg, use_pallas=True,
                                       entropy="device"))


@pytest.mark.parametrize("mode", ["420", "gray"])
def test_other_huffman_ids(mode):
    """Table ids 2 and 3: "device" takes any ids, "indexed" needs the native
    runtime's layout."""
    img = make_image(37, 53, seed=17)
    normal = jpeg_tpu_torch.encode(img if mode != "gray" else img[..., 0],
                                   quality=80, restart_interval=3,
                                   device="cpu")
    other = remap_huffman_ids(normal, 2)
    assert {c.dc_id for c in PJ.parse_jpeg(other).components} <= {2, 3}
    want = jpeg_tpu_torch.decode(normal, device="cpu")
    np.testing.assert_array_equal(
        jpeg_tpu_torch.decode(other, device="cpu", entropy="device"), want)
    assert_close(want, jpeg_tpu.decode(other, use_pallas=True,
                                       entropy="device"))
    with pytest.raises(PJ.JpegFormatError, match="unavailable"):
        jpeg_tpu_torch.decode(other, device="cpu", entropy="indexed")
    with pytest.raises(jpeg_tpu.io.jfif.JpegFormatError):
        jpeg_tpu.decode(other, entropy="indexed")
    if mode == "gray":
        return  # one table pair only
    # Mixed ids (DC 0 with AC 1 and the reverse) need the joint slot list.
    mixed = bytearray(normal)
    i = normal.index(b"\xff\xda")
    for c in range(mixed[i + 4]):
        mixed[i + 6 + 2 * c] ^= 0x01
    np.testing.assert_array_equal(
        jpeg_tpu_torch.decode(bytes(mixed), device="cpu", entropy="device"),
        jpeg_tpu_torch.decode(bytes(mixed), device="cpu", entropy="numpy"))


@pytest.mark.parametrize("entropy", ["indexed", "device"])
def test_undefined_huffman_table_is_a_format_error(entropy):
    jpg = jpeg_tpu_torch.encode(make_image(16, 16), device="cpu")
    out = bytearray(jpg)
    out[jpg.index(b"\xff\xda") + 6] ^= 0x22  # component 1 names tables 2/2
    with pytest.raises(PJ.JpegFormatError):
        jpeg_tpu_torch.decode(bytes(out), device="cpu", entropy=entropy)


def test_wrong_segment_count_raises():
    """On the CPU; on a card the native split counts the segments
    (test_native_split_equals_unstuffed_segments holds its counts,
    tests/test_torch_cuda.py the error there)."""
    scan, n_mcu, mcu_layout, htables, r = scan_args(stream("420", 3, False))
    cpu = dict(device="cpu")
    for fn, interval, kw in ((PD.decode_scan, 0, cpu),
                             (PD.decode_scan, 5, cpu),
                             (JD.decode_scan, 0, {})):
        with pytest.raises(ValueError) as e:
            fn(scan, n_mcu, mcu_layout, htables, interval, **kw)
        assert type(e.value).__name__ == "ScanDecodeError"
    with pytest.raises(ScanDecodeError, match="restart segments"):
        PD.decode_scan(scan_args(stream("420", 0, False))[0], n_mcu,
                       mcu_layout, htables, 3, device="cpu")


@pytest.mark.parametrize("mode,restart", [("420", 0), ("420", 3), ("gray", 0),
                                          ("444", 7)])
def test_truncated_and_corrupt_scans_raise_or_decode(mode, restart):
    """A cut scan runs its cursor past the true bits; flipped bytes give
    codes no table has, or decode to something: never a hang, never another
    exception, and the twins stay inside their buffers."""
    jpg = stream(mode, restart, False)
    scan, n_mcu, mcu_layout, htables, r = scan_args(jpg)
    cut = scan[: len(scan) // 2]
    for fn in (PD.decode_scan, PD.decode_scan_indexed):
        with pytest.raises(ScanDecodeError):
            fn(cut, n_mcu, mcu_layout, htables, r, device="cpu")
    rng = np.random.default_rng(5)
    for _ in range(12):
        bad = bytearray(scan)
        i = int(rng.integers(1, len(bad)))
        while 0xFF in (bad[i - 1], bad[i]):  # leave markers and stuffing whole
            i = int(rng.integers(1, len(bad)))
        bad[i] = (bad[i] ^ int(rng.integers(1, 255))) & 0xFE  # never 0xFF
        outs = []
        for fn, kw in ((PD.decode_scan, dict(device="cpu")),
                       (PD.decode_scan_indexed, dict(device="cpu")),
                       (native.decode_scan, {})):
            try:
                outs.append(fn(bytes(bad), n_mcu, mcu_layout, htables, r,
                               **kw))
            except ValueError as e:  # the native runtime raises the base
                assert fn is native.decode_scan or isinstance(
                    e, ScanDecodeError)
                outs.append(None)
        # The backends agree: all raise, or all give the same rows.
        assert len({o is None for o in outs}) == 1, (i, bad[i])
        if outs[0] is not None:
            assert_blocks_equal(outs[0], outs[2])
            assert_blocks_equal(outs[1], outs[2])


def test_a_scan_too_short_for_its_blocks_is_refused_before_any_allocation(
        monkeypatch):
    """A header may claim far more blocks than the scan's bits can hold (two
    at least per block): "device" raises before it sizes anything by the
    claim."""
    scan, n_mcu, mcu_layout, htables, _ = scan_args(stream("420", 0, False))
    monkeypatch.setattr(ED, "decode_segments", None)
    monkeypatch.setattr(ED, "prefix_index", None)
    for claimed in (len(scan) * 4, 1 << 40):
        with pytest.raises(ScanDecodeError, match="past segment end"):
            PD.decode_scan(scan, claimed, mcu_layout, htables, 0, device="cpu")
    # The true count passes the check (and then needs the wrapper).
    with pytest.raises(TypeError):
        PD.decode_scan(scan, n_mcu, mcu_layout, htables, 0, device="cpu")


def test_table_format():
    """build_tables: the 16-bit-window entries, the filler for windows that
    start no code, and a first level that never contradicts the full one."""
    htables = PJ.parse_jpeg(stream("420", 0, True)).htables
    slots, _ = PD._scan_slots([(0, 4, 0, 0), (1, 1, 1, 1), (2, 1, 1, 1)])
    t = ED.build_tables(htables, slots)
    assert t.shape == (4, ED.SLOT_STRIDE) and t.dtype == np.int32
    for i, key in enumerate(slots):
        sym, ln = PD.decode_np.make_decode_lut(htables[key])
        full = t[i, :ED.FULL_SIZE]
        np.testing.assert_array_equal(full >> 16, np.where(sym >= 0, ln, 16))
        np.testing.assert_array_equal(
            (full & 0xFFFF).astype(np.uint16).view(np.int16),
            np.where(sym >= 0, sym, -1))
        first = t[i, ED.FULL_SIZE:]
        w = np.arange(ED.FULL_SIZE)
        hit = first[w >> 7] != 0
        np.testing.assert_array_equal(first[w >> 7][hit], full[hit])
        assert ((full[~hit] >> 16) > ED.FIRST_BITS).all() and (full != 0).all()


def test_decode_refuses_unknown_backend_and_lists_all_six():
    assert PDEC.ENTROPY_BACKENDS == ("auto", "native", "numpy", "device",
                                     "indexed", "sparse")
    with pytest.raises(ValueError, match="unknown entropy backend"):
        jpeg_tpu_torch.decode(stream("420", 0, False), entropy="gpu",
                              device="cpu")


def test_undefined_quantization_table_is_a_format_error():
    jpg = jpeg_tpu_torch.encode(make_image(24, 40), device="cpu")
    out = bytearray(jpg)
    i = jpg.index(b"\xff\xc0")
    out[i + 4 + 6 + 2] = 3  # SOF0: component 1's Tq
    for entropy in PDEC.ENTROPY_BACKENDS:
        with pytest.raises(PJ.JpegFormatError, match="quantization table"):
            jpeg_tpu_torch.decode(bytes(out), device="cpu", entropy=entropy)
    with pytest.raises(PJ.JpegFormatError, match="quantization table"):
        jpeg_tpu_torch.decode_batched([jpg, bytes(out)], device="cpu")


def test_wrappers_refuse_what_the_kernels_do_not_take():
    words = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="MCUs"):
        ED.prefix_index(words, 0, None, None, None)
    meta = torch.device("meta")
    for call in (
            lambda: ED.decode_ac_indexed(words.to(meta), None, None, None,
                                         None),
            lambda: ED.decode_segments(words.to(meta), None, 1, 1, None,
                                       None, 1),
            lambda: ED.prefix_index(words.to(meta), 2, None, None, None)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
    with pytest.raises(ScanDecodeError, match="int32 bit offsets"):
        PD._guarded_words(np.zeros(4 * ED.MAX_WORDS, dtype=np.uint8))


def test_scan_decode_refuses_what_it_cannot_pass_to_c():
    """scan_decode hands raw addresses to C: it checks every tensor's dtype,
    layout and device first, and the host buffer's, as the other wrappers
    do, before it loads any build."""
    cpu = torch.device("cpu")
    seq = torch.zeros((3, ED.SEQ_FIELDS), dtype=torch.int32)
    tables = torch.zeros((2, ED.SLOT_STRIDE), dtype=torch.int32)
    words = torch.zeros(8, dtype=torch.int32)
    seg_off = torch.zeros(1, dtype=torch.int32)
    host = torch.zeros(64, dtype=torch.int32)

    def call(**kw):
        args = dict(dev=cpu, anchored=True, nwords=8, nseg=1, interval=1,
                    n_mcu=1, seq=seq, tables=tables, comp_bpm=())
        args.update(kw)
        dev, anchored, nwords, nseg, interval, n_mcu, sq, tb, bpm = (
            args.pop(k) for k in ("dev", "anchored", "nwords", "nseg",
                                  "interval", "n_mcu", "seq", "tables",
                                  "comp_bpm"))
        return ED.scan_decode(dev, anchored, nwords, nseg, interval, n_mcu,
                              sq, tb, bpm, **args)

    for kw, match in (
            (dict(seq=seq.long(), host=host), "seq must be"),
            (dict(tables=tables[:, :-1].contiguous(), host=host), "tables"),
            (dict(tables=tables.t().contiguous().t(), host=host), "tables"),
            (dict(words=words.long(), seg_off=seg_off), "words must be"),
            (dict(words=words, seg_off=seg_off[:0].long()), "seg_off"),
            (dict(host=host.long()), "host must be"),
            (dict(host=host[::2]), "host must be"),
            (dict(host=host.to("meta")), "host must be"),
            (dict(), "host or words"),
            (dict(host=host, words=words, seg_off=seg_off), "host or words"),
            (dict(anchored=False, comp_bpm=(1,) * 5, host=host),
             "blocks per MCU")):
        with pytest.raises(ValueError, match=match):
            call(**kw)


# ---------------------------------------------------------------------------
# The kernels' per-thread code, compiled for the host.
# ---------------------------------------------------------------------------

_STANDIN = r"""
#define JT_HOST_STANDIN
#include <cstdint>
#include <vector>
#define __device__
#define __forceinline__ inline
#include "scan_decode.cu"

using namespace jt;
typedef const int32_t* I32;
typedef const uint32_t* U32;

extern "C" int jt_ac_indexed(const void* words, int nwords, const void* off,
                             const void* dc, const void* slot,
                             const void* tables, int nslots, void* rows,
                             long nblocks, void*) {
  for (long b = 0; b < nblocks; ++b) {
    int s = ((I32)slot)[b];
    s = s < 0 ? 0 : (s >= nslots ? nslots - 1 : s);
    int32_t* row = (int32_t*)rows + b * 64;
    for (int i = 0; i < 64; ++i) row[i] = 0;
    BitReader r((U32)words, nwords);
    I32 full = (I32)tables + (long)s * kSlotStride;
    ac_block(r, ((I32)off)[b], ((I32)dc)[b], full + kFullSize, full, row);
  }
  return 0;
}

// The block-start program: one loop iteration per CUDA thread, and the
// threads of a launch in reverse order.
extern "C" int jt_sync_layout(const SyncArgs* a, void*) {
  Sync s = make_sync(*a);
  int acc = 0;
  for (int g = 0; g < a->nseg; ++g) {
    s.base[g] = acc;
    acc += segment_chunks(s, g);
  }
  s.base[a->nseg] = acc;
  for (int i = 0; i < 2 * a->nseg + 2; ++i) clear_status(s, i);
  return 0;
}

template <int A> void speculate_all(const Sync& s) {
  const long total = s.base[s.a.nseg];
  for (long i = s.maxc * s.lanes - 1; i >= 0; --i) {
    const long c = i / s.lanes;
    const int b = (int)(i % s.lanes);
    if (c < total) speculate<A>(s, c, b, first_look(s, c, b), Stage());
  }
}

extern "C" int jt_sync_speculate(const SyncArgs* a, void*) {
  Sync s = make_sync(*a);
  if (a->anchored) speculate_all<1>(s); else speculate_all<0>(s);
  return 0;
}

template <int A> void link_all(const Sync& s) {
  const long total = s.base[s.a.nseg];
  for (long i = s.maxc * s.lanes - 1; i >= 0; --i) {
    const long c = i / s.lanes;
    if (c < total) link<A>(s, c, (int)(i % s.lanes), chunk_info(s, c), Stage());
  }
}

extern "C" int jt_sync_link(const SyncArgs* a, void*) {
  Sync s = make_sync(*a);
  if (a->anchored) link_all<1>(s); else link_all<0>(s);
  return 0;
}

// One chunk per thread: each round's scan of the lane maps, then its seeds,
// then its walks in reverse order, so that a round resolves no more than
// the kernel's would.
template <int A> void resolve_all(const Sync& s) {
  const long total = s.base[s.a.nseg];
  if (total == s.a.nseg) {  // as the kernel: every chunk starts its segment
    s.passes[0] = 0;
    return;
  }
  std::vector<int> lane(total);
  unresolve_range(s, 0, total);
  int rounds = 0;
  bool open = true;
  while (open) {
    uint64_t f = identity_map();
    for (long c = 0; c < total; ++c) {
      lane[c] = apply_map(f, 0);
      f = compose_maps(f, chunk_map(s, c));
    }
    for (long c = 0; c < total; ++c) seed_range<A>(s, c, c + 1, lane[c]);
    open = false;
    for (long c = total - 1; c >= 0; --c)
      open = walk_range<A>(s, c, c + 1) || open;
    ++rounds;
  }
  range_prefix(s, 0, total, 0);
  s.passes[0] = rounds;
}

extern "C" int jt_sync_resolve(const SyncArgs* a, void*) {
  Sync s = make_sync(*a);
  if (a->anchored) resolve_all<1>(s); else resolve_all<0>(s);
  return 0;
}

template <int A> void write_all(const Sync& s) {
  const long total = s.base[s.a.nseg];
  for (long c = total - 1; c >= 0; --c)
    write_chunk<A>(s, c, chunk_info(s, c), Stage());
}

extern "C" int jt_sync_write(const SyncArgs* a, void*) {
  Sync s = make_sync(*a);
  if (a->anchored) write_all<1>(s); else write_all<0>(s);
  return 0;
}

// The DC sums: every tile takes its number, loads and scans its blocks and
// publishes its run (as each does before it waits); then the tiles finish,
// the odd ones from the last down (each sees only the runs of the tiles
// before it) and then the even ones in order (each sees the complete run
// its odd neighbour left), each reading the runs before it kDcThreads at a
// time and nearest first as the kernel does, its threads one by one between
// the kernel's barriers.
struct DcTile {
  uint32_t sh[kDcShared];
  bool heads[kDcShared];
  unsigned long long excl[kDcThreads];
  unsigned long long incl;
};

extern "C" int jt_dc_sum(const DcArgs* a, void*) {
  const long ntiles = dc_tiles(a->nblocks);
  std::vector<DcTile> tiles(ntiles);
  for (long n = 0; n < ntiles; ++n) {
    const long tile = static_cast<long>(a->ctl[0]++);
    DcTile& d = tiles[tile];
    for (int t = 0; t < kDcThreads; ++t)
      dc_load(*a, tile * kDcTile, t, d.sh, d.heads);
    unsigned long long run = 0;
    for (int t = 0; t < kDcThreads; ++t) {
      d.excl[t] = run;
      run = dc_combine(run, dc_thread_run(t, d.sh, d.heads));
    }
    d.incl = run;
    a->ctl[1 + tile] = run | kDcReady;
  }
  std::vector<long> order;
  for (long tile = ntiles - 1; tile >= 0; --tile)
    if (tile % 2) order.push_back(tile);
  for (long tile = 0; tile < ntiles; tile += 2) order.push_back(tile);
  for (long tile : order) {
    DcTile& d = tiles[tile];
    long head = -1;
    uint32_t carry = 0;
    for (long hi = tile; hi > 0 && head < 0; hi -= kDcThreads) {
      unsigned long long v[kDcThreads];
      for (int t = 0; t < kDcThreads; ++t) {
        const long q = hi - 1 - t;
        if (q < 0) continue;
        v[t] = a->ctl[1 + q];
        if (!(v[t] & kDcReady)) return 1;
        if ((v[t] & kDcHead) && q > head) head = q;
      }
      for (int t = 0; t < kDcThreads; ++t) {
        const long q = hi - 1 - t;
        if (q >= 0 && q >= head) carry += static_cast<uint32_t>(v[t]);
      }
    }
    const unsigned long long in = kDcHead | carry;
    a->ctl[1 + tile] = dc_combine(in, d.incl) | kDcHead | kDcReady;
    for (int t = 0; t < kDcThreads; ++t)
      dc_thread_write(t, static_cast<uint32_t>(dc_combine(in, d.excl[t])),
                      d.sh, d.heads);
    for (int t = 0; t < kDcThreads; ++t)
      dc_store(*a, tile * kDcTile, t, d.sh);
  }
  return 0;
}
"""


def build_standin(directory, flags=()):
    """The kernels' per-thread bodies behind their C entry points, built
    with g++ into `directory`."""
    (directory / "standin.cc").write_text(_STANDIN)
    lib = directory / "libstandin.so"
    subprocess.run(
        ["g++", "-O1", "-std=c++17", "-x", "c++", "-shared", "-fPIC",
         *flags, f"-I{CSRC}", "-o", str(lib), str(directory / "standin.cc")],
        check=True, capture_output=True, text=True, timeout=300)
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def standins(tmp_path_factory):
    """standins(chunk_bits=None, lanes=None, dc_tile=None): the host build
    of the kernels at that chunk size (None: the size the program picks
    from the bits per MCU), lane cap and DC-sum tile (threads, blocks a
    thread), built once per module."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    built = {}

    def get(chunk_bits=None, lanes=None, dc_tile=None):
        key = (chunk_bits, lanes, dc_tile)
        if key not in built:
            flags = [f"-DJT_CHUNK_BITS={chunk_bits}"] if chunk_bits else []
            if lanes:
                flags.append(f"-DJT_LANES={lanes}")
            if dc_tile:
                flags += [f"-DJT_DC_THREADS={dc_tile[0]}",
                          f"-DJT_DC_ITEMS={dc_tile[1]}"]
            built[key] = build_standin(
                tmp_path_factory.mktemp("huffman_standin"), flags)
        return built[key]

    return get


@pytest.fixture(scope="module")
def standin(standins):
    return standins()


# Fixed chunk sizes, and the program's own choice (None).
CHUNK_BITS = [32, 64, 1024, None]


@pytest.mark.parametrize("mode,restart,optimal", [
    ("420", 0, False), ("420", 3, True), ("422", 7, False), ("444", 0, True),
    ("gray", 3, False)])
def test_kernel_d_body_on_host_standins(standin, mode, restart, optimal):
    jpg = stream(mode, restart, optimal)
    inputs = ac_indexed_inputs(jpg)
    want = np.concatenate(native.decode_scan(*scan_args(jpg)))
    rows = torch.full((want.shape[0], 64), -7, dtype=torch.int32)
    before = ED.AC_LAUNCHES
    ED._launch_ac_indexed(*inputs, rows, lib=standin)
    assert ED.AC_LAUNCHES == before + 1
    np.testing.assert_array_equal(rows.numpy(), want)
    np.testing.assert_array_equal(
        ED.decode_ac_indexed_reference(*inputs).numpy(), want)
    # Garbage offsets (every block starting mid-code somewhere) stay in
    # bounds and equal the twin.
    rng = np.random.default_rng(3)
    off = torch.as_tensor(rng.integers(
        0, inputs[0].numel() * 32 + 64, size=want.shape[0]).astype(np.int32))
    ED._launch_ac_indexed(inputs[0], off, *inputs[2:], rows, lib=standin)
    np.testing.assert_array_equal(
        rows.numpy(),
        ED.decode_ac_indexed_reference(inputs[0], off, *inputs[2:]).numpy())


def run_segments_standin(lib, words, seg_off, interval, n_mcu, seq, tables,
                         nblocks):
    """The anchored chain (scan_decode, no upload) through the host build."""
    comps = seq[:, 0].tolist()
    names = ("SEGMENT_LAUNCHES", "PREFIX_STAGE_LAUNCHES", "AC_LAUNCHES",
             "RESTART_SEGMENTS", "NATIVE_SCANS", "DC_SUM_LAUNCHES")
    before = [getattr(ED, n) for n in names]
    rows, status = ED.scan_decode(
        words.device, True, words.numel(), seg_off.shape[0], interval, n_mcu,
        seq, tables, [comps.count(c) for c in sorted(set(comps))],
        words=words, seg_off=seg_off, lib=lib)
    assert rows.shape == (nblocks, 64)
    assert [getattr(ED, n) - b for n, b in zip(names, before)] == [
        1, 5, 1, seg_off.shape[0], 1, 1]
    return rows, status


def segment_of_rows(seg_off, interval, n_mcu, seq, nblocks):
    """The restart segment of every row, from kernel E's row layout."""
    out = np.empty(nblocks, dtype=np.int64)
    m = np.arange(n_mcu)
    for _comp, _dc, _ac, base, per in seq.tolist():
        out[base + m * per] = m // interval
    return out


@pytest.mark.parametrize("chunk_bits", CHUNK_BITS)
@pytest.mark.parametrize("mode,restart,optimal", [
    ("420", 3, False), ("420", 7, True), ("422", 3, True), ("444", 7, False),
    ("gray", 3, False), ("420", 0, False), ("444", 1, False)])
def test_kernel_e_body_on_host_standins(standins, mode, restart, optimal,
                                        chunk_bits):
    """The anchored block-start program + DC sums + kernel D, E's route."""
    lib = standins(chunk_bits)
    jpg = stream(mode, restart, optimal)
    inputs, bits = segment_inputs(jpg)
    words, seg_off, interval, n_mcu, seq, tables, nblocks = inputs
    want = np.concatenate(native.decode_scan(*scan_args(jpg)))
    rows, status = run_segments_standin(lib, *inputs)
    t_rows, t_status = ED.decode_segments_reference(*inputs)
    np.testing.assert_array_equal(rows.numpy(), want)
    np.testing.assert_array_equal(t_rows.numpy(), want)
    np.testing.assert_array_equal(status.numpy(), t_status.numpy())
    assert (status[1] == 0).all()
    assert all(b - 7 <= int(e) <= b for e, b in zip(status[0], bits))
    # Corrupt words: flags and end positions equal the twin's always, rows
    # where the segment's status is clean.
    rng = np.random.default_rng(8)
    bad = words.clone()
    for _ in range(6):
        bad[int(rng.integers(0, bad.shape[0]))] ^= int(
            rng.integers(1, 1 << 30))
    rows, status = run_segments_standin(lib, bad, *inputs[1:])
    t_rows, t_status = ED.decode_segments_reference(bad, *inputs[1:])
    np.testing.assert_array_equal(status.numpy(), t_status.numpy())
    clean = (status[1] == 0).numpy()[segment_of_rows(
        seg_off, interval, n_mcu, seq, nblocks)]
    np.testing.assert_array_equal(rows.numpy()[clean], t_rows.numpy()[clean])


def run_prefix_standin(standin, words, n_mcu, seq, classes, tables):
    bpm = seq.shape[0]
    ac_off = torch.full((n_mcu, bpm), -1, dtype=torch.int32)
    diff = torch.full((n_mcu, bpm), -1, dtype=torch.int32)
    status = torch.full((2,), -1, dtype=torch.int32)
    ED._launch_prefix(
        words, n_mcu, seq, classes, tables, ac_off, diff, status,
        ED.prefix_scratch(words.numel(), n_mcu, classes.shape[0],
                          words.device, lib=standin), lib=standin)
    return ac_off, diff, status


@pytest.mark.parametrize("chunk_bits", CHUNK_BITS)
@pytest.mark.parametrize("mode,optimal", [("420", False), ("420", True),
                                          ("422", False), ("444", True),
                                          ("gray", False)])
def test_program_f_bodies_on_host_standins(standins, mode, optimal,
                                           chunk_bits):
    lib = standins(chunk_bits)
    jpg = stream(mode, 0, optimal)
    (words, n_mcu, seq, classes, tables), _ = prefix_inputs(jpg)
    before = (ED.PREFIX_LAUNCHES, ED.PREFIX_STAGE_LAUNCHES)
    ac_off, diff, status = run_prefix_standin(
        lib, words, n_mcu, seq, classes, tables)
    assert (ED.PREFIX_LAUNCHES, ED.PREFIX_STAGE_LAUNCHES) == (
        before[0] + 1, before[1] + 5)
    assert ED.SYNC_PASSES >= 1
    t_off, t_diff, t_status = ED.prefix_index_reference(
        words, n_mcu, seq, classes, tables)
    np.testing.assert_array_equal(ac_off.numpy(), t_off.numpy())
    np.testing.assert_array_equal(diff.numpy(), t_diff.numpy())
    assert status.tolist() == t_status.tolist() and status[1] == 0
    # And against the host index pass: offsets and cumulated DCs.
    args = scan_args(jpg)
    _, want_off, want_dc = native.index_scan(*args)
    off, dc = regroup_prefix(ac_off, diff, args[2])
    np.testing.assert_array_equal(off.numpy(), want_off)
    np.testing.assert_array_equal(dc.numpy(), want_dc)


@pytest.mark.parametrize("chunk_bits", CHUNK_BITS)
@pytest.mark.parametrize("mode", ["420", "gray"])
def test_program_f_on_corrupt_words(standins, mode, chunk_bits):
    """Kernel bodies and twin decide alike on corrupt data: both flag, or
    both run past the true bits, or both give the same offsets."""
    lib = standins(chunk_bits)
    jpg = stream(mode, 0, False)
    (words, n_mcu, seq, classes, tables), true_bits = prefix_inputs(jpg)
    nbytes = true_bits // 8
    rng = np.random.default_rng(21)
    verdicts = set()
    for _ in range(10):
        bad = words.clone()
        bad[int(rng.integers(0, nbytes // 4))] ^= int(rng.integers(1, 1 << 30))
        got = run_prefix_standin(lib, bad, n_mcu, seq, classes, tables)
        twin = ED.prefix_index_reference(bad, n_mcu, seq, classes, tables)

        def verdict(out):
            end, err = out[2].tolist()
            return "flag" if err else ("overrun" if end > nbytes * 8 else "ok")

        assert verdict(got) == verdict(twin)
        verdicts.add(verdict(got))
        if verdict(got) == "ok":
            np.testing.assert_array_equal(got[0].numpy(), twin[0].numpy())
            np.testing.assert_array_equal(got[1].numpy(), twin[1].numpy())
            assert got[2].tolist() == twin[2].tolist()
    print("verdicts seen:", sorted(verdicts))


@pytest.mark.parametrize("chunk_bits", CHUNK_BITS)
def test_one_segment_walk_equals_prefix_plus_ac(standins, chunk_bits):
    """The anchored route over the whole restart-free scan as one segment
    gives the rows of program F + kernel D: the program's two modes, with
    host code of their own around each."""
    lib = standins(chunk_bits)
    jpg = stream("420", 0, True)
    inputs, _ = segment_inputs(jpg)
    words, nblocks = inputs[0], inputs[-1]
    rows_e, status = run_segments_standin(lib, *inputs)
    (pwords, n_mcu, seq3, classes, tables), _ = prefix_inputs(jpg)
    assert torch.equal(pwords, words)
    ac_off, diff, pstatus = run_prefix_standin(
        lib, pwords, n_mcu, seq3, classes, tables)
    assert pstatus.tolist() == [int(status[0, 0]), 0]
    off, dc = regroup_prefix(ac_off, diff, scan_args(jpg)[2])
    rows_d = torch.empty((nblocks, 64), dtype=torch.int32)
    ED._launch_ac_indexed(pwords, off, dc, ac_indexed_inputs(jpg)[3], tables,
                          rows_d, lib=lib)
    np.testing.assert_array_equal(rows_d.numpy(), rows_e.numpy())


def flat_stream(kind: str, restart: int) -> bytes:
    """Flat content, where runs of identical blocks can hold a walk that
    starts at a wrong block of the MCU in step with the wrong one."""
    if kind == "gray bars":
        img = make_image(64, 80, seed=4)[..., 0]
        img[:24] = 0
        return jpeg_tpu_torch.encode(img, quality=75, device="cpu",
                                     restart_interval=restart)
    if kind == "bars 420":
        img = make_image(64, 80, seed=5)
        img[:24] = 0
        img[-16:] = 0
        sub = "420"
    else:
        img = np.zeros((48, 96, 3), np.uint8)
        img[..., 1] = 30 if kind == "solid 444" else 0
        sub = kind.split()[1]
    return jpeg_tpu_torch.encode(img, quality=75, subsampling=sub,
                                 device="cpu", restart_interval=restart)


FLAT_KINDS = ["solid 420", "solid 444", "bars 420", "gray bars"]
FLAT_PASSES: dict = {}


@pytest.mark.parametrize("kind", FLAT_KINDS)
def test_flat_streams_on_host_standins(standins, kind):
    """Solid frames and flat bars at a small chunk size, with every lane and
    with one (speculation from block 0 of the MCU only): both modes equal
    their twins and the host walkers exactly, and the resolve rounds run."""
    passes = []
    for lanes in (None, 1):
        lib = standins(64, lanes)
        for restart in (0, 5):
            jpg = flat_stream(kind, restart)
            args = scan_args(jpg)
            want = np.concatenate(native.decode_scan(*args))
            inputs, bits = segment_inputs(jpg)
            rows, status = run_segments_standin(lib, *inputs)
            passes.append(ED.SYNC_PASSES)
            np.testing.assert_array_equal(rows.numpy(), want)
            t_rows, t_status = ED.decode_segments_reference(*inputs)
            np.testing.assert_array_equal(status.numpy(), t_status.numpy())
            if restart:
                continue
            f_in, _ = prefix_inputs(jpg)
            got = run_prefix_standin(lib, *f_in)
            passes.append(ED.SYNC_PASSES)
            twin = ED.prefix_index_reference(*f_in)
            for g, t in zip(got, twin):
                np.testing.assert_array_equal(g.numpy(), t.numpy())
            _, want_off, want_dc = native.index_scan(*args)
            off, dc = regroup_prefix(got[0], got[1], args[2])
            np.testing.assert_array_equal(off.numpy(), want_off)
            np.testing.assert_array_equal(dc.numpy(), want_dc)
    print(f"{kind}: resolve rounds {passes}")
    FLAT_PASSES[kind] = passes


def test_flat_streams_ran_repair_passes(standins):
    """On at least one flat stream the one-lane build needed more than two
    resolve rounds: the loop that makes the program exact really ran."""
    for kind in FLAT_KINDS:
        if kind not in FLAT_PASSES:  # this test alone, or another order
            test_flat_streams_on_host_standins(standins, kind)
    assert max(max(v) for v in FLAT_PASSES.values()) > 2, FLAT_PASSES


def geometry_stream(kind):
    """A camera frame (1080p 4:2:2, a restart every MCU row) or a 500x375
    q90 4:2:0 ImageNet image, from the benchmark's plain encoder."""
    if kind == "camera":
        (data,), _ = plain_streams([make_image(1080, 1920, seed=2)], "422",
                                   120)
    else:
        (data,), _ = plain_streams([make_image(375, 500, seed=3)], "420", 0,
                                   quality=90)
    return data


def split_cases():
    rng = np.random.default_rng(0)
    cases = [b"", b"\xff", b"\xff\xd0", b"\x00\xff\xd1", b"\xff\xd0\xff\xd1",
             b"\xff\x00", b"\xff\xff\xd0\x00", b"\xff\x00\xff\xd3\x00\xff\x00",
             b"\x12\xff", b"\xff\xd7\x34\xff\xd0", b"\xff\xd2" * 5 + b"\xff",
             b"\xff\x00" * 40 + b"\xff", b"\xff\xff\xff\x00\xff\xd5\xff",
             scan_args(stream("420", 3, False))[0],
             scan_args(stream("444", 0, True))[0]]
    for kind in ("camera", "imagenet"):
        cases.append(scan_args(geometry_stream(kind))[0])
    for _ in range(500):
        n = int(rng.integers(0, 60))
        cases.append(bytes(rng.choice(
            [0xFF, 0x00, 0xD0, 0xD7, 0x12, 0xFF, 0x00], size=n).astype(
                np.uint8)))
    for _ in range(40):  # long scans with dense 0xFF00 runs and markers
        body = rng.integers(0, 256, size=int(rng.integers(100, 4000)),
                            dtype=np.uint8)
        body[body == 0xFF] = 0x7F
        at = rng.random(body.shape[0])
        body[at < 0.2] = 0xFF
        out = bytearray()
        for b, u in zip(body.tolist(), at.tolist()):
            out.append(b)
            if b == 0xFF:
                out.append(0xD0 + int(u * 40) % 8 if u < 0.02 else 0x00)
        cases.append(bytes(out))
    return cases


@pytest.mark.parametrize("split", ["numpy", "native"])
def test_unstuffed_segments_equal_the_per_segment_functions(split, request):
    """The whole-scan split + unstuff against decode_np's two functions
    applied segment by segment: in array operations (unstuffed_segments,
    the CPU's) and in one byte pass of csrc/scan_decode.cu (jt_split_scan,
    the card's, built here with g++) into a reused buffer."""
    lib = request.getfixturevalue("standin") if split == "native" else None
    cpu = torch.device("cpu")
    for scan in split_cases():
        parts = [PD.decode_np.unstuff(s)
                 for s in PD.decode_np.split_restart_segments(scan)]
        flat = np.concatenate(parts)
        if lib is None:
            words, seg_off, lens = PD.unstuffed_segments(scan)
        else:
            words, seg_off, lens, _ = PD._split_native(scan, cpu, lib)
            assert lens.dtype == np.int64
        np.testing.assert_array_equal(words, PD._guarded_words(flat))
        assert lens.tolist() == [len(u) for u in parts]
        assert seg_off.tolist() == np.cumsum([0] + lens.tolist())[:-1].tolist()
        assert words.dtype == seg_off.dtype == np.int32


def test_the_card_route_raises_as_the_cpu_route(standin):
    """The card's route run on the CPU through the host build (the native
    split into a reused buffer, the chain in one call): the segment-count
    and bit-cursor errors of unstuffed_segments and the twins."""
    cpu = torch.device("cpu")
    scan, n_mcu, mcu_layout, htables, r = scan_args(stream("420", 3, False))
    plain = scan_args(stream("420", 0, False))[0]
    for lib in (None, standin):
        for data, interval, match in (
                (scan, 0, "restart segments"), (scan, 5, "restart segments"),
                (plain, 3, "restart segments"),
                (scan[: len(scan) // 2], r, "restart segments|past segment"),
                (plain[: len(plain) // 3], 0, "past segment end")):
            with pytest.raises(ScanDecodeError, match=match):
                PD._decode(data, n_mcu, mcu_layout, htables, interval, cpu,
                           prefix=False, lib=lib)
        with pytest.raises(ScanDecodeError, match="past segment end"):
            PD._decode(plain, len(plain) * 4, mcu_layout, htables, 0, cpu,
                       prefix=False, lib=lib)


@pytest.mark.parametrize("mode,restart,optimal", [
    ("420", 0, False), ("420", 3, True), ("422", 7, False), ("444", 0, True),
    ("gray", 3, False), ("gray", 0, False), ("444", 1, False)])
def test_the_card_route_on_host_standins(standin, mode, restart, optimal):
    """decode_scan's card route on the CPU through the host build: the rows
    of native.decode_scan, one native scan and one DC sum per decode; a
    corrupt scan raises where the CPU route raises, and the next decode
    from the same buffer is right again."""
    cpu = torch.device("cpu")
    args = scan_args(stream(mode, restart, optimal))
    want = native.decode_scan(*args)
    for prefix in (False, True) if restart == 0 else (False,):
        before = (ED.NATIVE_SCANS, ED.DC_SUM_LAUNCHES)
        got = PD._decode(*args, cpu, prefix=prefix, lib=standin)
        assert (ED.NATIVE_SCANS, ED.DC_SUM_LAUNCHES) == (
            before[0] + 1, before[1] + 1)
        assert_blocks_equal(got, want)
    rng = np.random.default_rng(11)
    scan = args[0]
    for _ in range(6):
        bad = bytearray(scan)
        i = int(rng.integers(1, len(bad)))
        while 0xFF in (bad[i - 1], bad[i]):
            i = int(rng.integers(1, len(bad)))
        bad[i] = (bad[i] ^ int(rng.integers(1, 255))) & 0xFE
        outs = []
        for lib in (None, standin):
            try:
                outs.append(PD._decode(bytes(bad), *args[1:], cpu,
                                       prefix=False, lib=lib))
            except ScanDecodeError:
                outs.append(None)
        assert (outs[0] is None) == (outs[1] is None)
        if outs[0] is not None:
            assert_blocks_equal(outs[1], outs[0])
        assert_blocks_equal(PD._decode(*args, cpu, prefix=False, lib=standin),
                            want)


# (n_mcu, blocks per MCU of each component, restart interval) of the sizes
# the program takes: a camera frame, a 500x375 4:2:0 image, a 4K 4:2:0
# frame, the 4K frame at restart 1; and small ones whose components and
# resets fall inside a thread's blocks.
DC_SHAPES = {"camera": (16200, [2, 1, 1], 120),
             "imagenet": (768, [4, 1, 1], 32),
             "4k": (32400, [4, 1, 1], 240),
             "4k-restart1": (32400, [4, 1, 1], 1),
             "gray": (7, [1], 3), "odd-420": (77, [4, 1, 1], 5),
             "odd-422": (13, [2, 1, 1], 3)}


@pytest.mark.parametrize("dc_tile", [None, (32, 2)], ids=["tile", "small"])
@pytest.mark.parametrize("anchored", [True, False])
@pytest.mark.parametrize("shape", list(DC_SHAPES))
def test_dc_sums_on_host_standins(standins, shape, anchored, dc_tile):
    """The DC-sum launch (csrc/scan_decode.cu) built with g++ and driven
    tile by tile against the torch sums it replaced, in both modes: random
    differences, so that the sums wrap as int32. Also built with tiles of
    64 blocks, so that a tile reads the runs before it in many rounds of
    32 (from bit 0, back to its component's first block)."""
    standin = standins(dc_tile=dc_tile)
    n_mcu, comp_bpm, interval = DC_SHAPES[shape]
    bpm = sum(comp_bpm)
    rng = np.random.default_rng(bpm * n_mcu + interval)
    diff = torch.as_tensor(rng.integers(-2**31, 2**31, size=n_mcu * bpm,
                                        dtype=np.int64).astype(np.int32))
    ac_off = torch.as_tensor(rng.integers(0, 2**30, size=(n_mcu, bpm),
                                          dtype=np.int32))
    seq = torch.as_tensor(rng.integers(0, 8, size=(bpm, 3), dtype=np.int32))
    if not anchored:
        diff = diff.view(n_mcu, bpm)
    before = ED.DC_SUM_LAUNCHES
    got = ED.dc_sums(diff, ac_off, seq, comp_bpm, interval, n_mcu, anchored,
                     lib=standin)
    assert ED.DC_SUM_LAUNCHES == before + 1
    want = ED.dc_sums_reference(diff, ac_off, seq, comp_bpm, interval, n_mcu,
                                anchored)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_auto_takes_the_device_decoders_on_a_card():
    """entropy="auto": the host walkers on the CPU, "device" on a card."""
    assert PDEC._auto_backend(torch.device("cpu")) == "host"
    assert PDEC._auto_backend(torch.device("cuda")) == "device"
    assert PDEC._auto_backend(torch.device("cuda", 1)) == "device"


@pytest.mark.parametrize("mode", ["420", "gray"])
def test_program_f_is_given_no_more_than_the_blocks_can_span(mode,
                                                             monkeypatch):
    """Bytes behind the last MCU of a scan without markers (a file may carry
    megabytes of them) do not size program F's working memory: it gets the
    words the scan's blocks can span at most, and the rows stay the same."""
    scan, n_mcu, mcu_layout, htables, _ = scan_args(stream(mode, 0, False))
    want = native.decode_scan(scan, n_mcu, mcu_layout, htables, 0)
    nblocks = n_mcu * sum(bpm for (_, bpm, _, _) in mcu_layout)
    most = (nblocks * PD.MAX_BLOCK_BITS + 31) // 32 + 2
    assert PD.MAX_BLOCK_BITS == 1985
    seen = []
    inner = ED.prefix_index

    def spy(words, *args):
        seen.append(words.numel())
        return inner(words, *args)

    monkeypatch.setattr(ED, "prefix_index", spy)
    rng = np.random.default_rng(3)
    tail = rng.integers(0, 255, size=2 * most * 4, dtype=np.uint8).tobytes()
    for fn, args in ((PD.decode_scan, (0,)), (PD.decode_scan_prefix, ())):
        for data in (scan, scan + tail, scan + bytes(len(tail))):
            got = fn(data, n_mcu, mcu_layout, htables, *args, device="cpu")
            assert_blocks_equal(got, want)
    assert len(seen) == 6 and max(seen) == most
    assert seen[0] == (len(PD.decode_np.unstuff(scan)) + 8 + 3) // 4 < most
    # A scan that ends inside the kept words still runs out of bits.
    with pytest.raises(ScanDecodeError, match="past segment end"):
        PD.decode_scan_prefix(scan[: len(scan) // 2], n_mcu, mcu_layout,
                              htables, device="cpu")


def test_a_header_edit_rebuilds_the_kernels_that_include_it(tmp_path,
                                                            monkeypatch):
    """Kernels D, E and F share csrc/huff_decode.cuh, and scan_decode.cu
    includes prefix_index.cu and ac_indexed.cu: a library older than any
    header beside its source, or than a source it includes, is built
    again; a source it does not include changes nothing."""
    from jpeg_tpu_torch.ops import _cuda
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'echo built >> "$2.log"\ntouch "$2"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(_cuda, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_cuda, "_BUILD_DIR", tmp_path)
    src, header = tmp_path / "k.cu", tmp_path / "shared.cuh"
    lib = tmp_path / "k.so"
    src.write_text("")
    header.write_text("")

    def builds():
        _cuda._build("k", src, lib)
        logs = list(tmp_path.glob("k.*.tmp.log"))
        return sum(len(p.read_text().splitlines()) for p in logs)

    os.utime(src, (100, 100))
    os.utime(header, (100, 100))
    assert builds() == 1 and builds() == 1
    os.utime(header, (4e9, 4e9))
    assert builds() == 2
    os.utime(lib, (5e9, 5e9))
    assert builds() == 2
    os.utime(src, (6e9, 6e9))
    assert builds() == 3
    inner, other = tmp_path / "inner.cu", tmp_path / "other.cu"
    inner.write_text("")
    other.write_text("")
    src.write_text('#include "shared.cuh"\n#include "inner.cu"\n')
    for p in (src, header, inner, other, lib):
        os.utime(p, (7e9, 7e9))
    os.utime(other, (8e9, 8e9))
    assert builds() == 3
    os.utime(inner, (9e9, 9e9))
    assert builds() == 4
