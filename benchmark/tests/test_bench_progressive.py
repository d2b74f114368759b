"""The plain progressive writer (lib/plainprogressive), the Annex K.2 table
builder and the optimized baseline streams (lib/plainjpeg), and the
configuration keys that state them (lib/inputs), on the CPU at small sizes.

Independent decoders judge the streams: PIL (libjpeg) must give the pixels
it gives for the baseline stream of the same coefficients, and the port's
progressive scan walkers (NumPy and native) the coefficients themselves."""

import io
import struct

import numpy as np
import pytest
import torch

from lib import harness, inputs, plainjpeg as P, plainprogressive as PP

Image = pytest.importorskip("PIL.Image")

K2 = {"progressive": True, "optimize_tables": True,
      "huffman_tables": inputs.ANNEX_K2}
SHAPES = [(500, 333), (9, 17)]  # (height, width): edge MCUs both ways


def image(h, w, seed):
    g = inputs.generator(seed, "cpu")
    return inputs.make_image(h, w, 10, g, "cpu")[None]


def pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def markers(data: bytes) -> list:
    """[(marker, payload)] of a stream's segments in order; the
    entropy-coded data after an SOS is skipped."""
    out, i = [], 2
    while i < len(data):
        m = data[i + 1]
        if m == 0xD9:
            out.append((m, b""))
            break
        (n,) = struct.unpack(">H", data[i + 2:i + 4])
        out.append((m, data[i + 4:i + 2 + n]))
        i += 2 + n
        if m == 0xDA:
            while not (data[i] == 0xFF and data[i + 1] not in (0x00,)
                       and not 0xD0 <= data[i + 1] <= 0xD7):
                i += 1
    return out


def port_grids(data: bytes, backend: str) -> list:
    jfif = pytest.importorskip("jpeg_tpu_torch.io.jfif")
    from jpeg_tpu_torch.entropy import progressive_np

    return progressive_np.decode_progressive(jfif.parse_jpeg(data), backend)


def assert_grids_equal(data, coefs, h, w, sub):
    """The port's grids (padded to whole MCUs) hold the coefficients: every
    block's DC, and the AC of the blocks each component's own raster has
    (a non-interleaved scan codes no other)."""
    own = PP.component_blocks(coefs, h, w, sub)
    hh, vv = P.SAMPLING[sub]
    mr, mc = P._mcus(h, w, hh, vv)
    dc = [coefs[0, :, :hh * vv, 0].reshape(mr, mc, vv, hh).permute(
        0, 2, 1, 3).reshape(-1), coefs[0, :, -2, 0], coefs[0, :, -1, 0]]
    for backend in ("numpy", "native"):
        grids = port_grids(data, backend)
        y = grids[0].reshape(mr * vv, mc * hh, 64)[:-(-h // 8), :-(-w // 8)]
        got = [y.reshape(-1, 64), grids[1], grids[2]]
        for c in range(3):
            assert np.array_equal(got[c], own[c][0].numpy()), (backend, c)
            assert np.array_equal(grids[c][:, 0], dc[c].numpy()), (backend, c)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shape", SHAPES, ids=["333x500", "17x9"])
@pytest.mark.parametrize("sub", ["420", "422", "444"])
def test_progressive_streams_decode_as_the_baseline_stream(sub, shape, seed):
    h, w = shape
    coefs = P.coefficients(image(h, w, seed), 90, subsampling=sub)
    (prog, nbytes), = PP.streams(coefs, h, w, 90, sub)
    (base, _), = P.streams(coefs, h, w, 90, sub)
    assert np.array_equal(pil(prog), pil(base))
    assert_grids_equal(prog, coefs, h, w, sub)
    assert nbytes == len(prog) - len(markers_bytes(prog))


def markers_bytes(data: bytes) -> bytes:
    """The stream without its entropy-coded data."""
    return b"\xff\xd8" + b"".join(
        struct.pack(">BBH", 0xFF, m, len(p) + 2) + p if m != 0xD9 else b"\xff\xd9"
        for m, p in markers(data))


def test_each_stream_states_sof2_and_the_ten_scans():
    coefs = P.coefficients(image(40, 72, 5), 75)
    (data, _), = PP.streams(coefs, 40, 72, 75)
    segs = markers(data)
    kinds = [m for m, _ in segs]
    assert 0xC2 in kinds and 0xC0 not in kinds
    scans = [(p[1 + 2 * p[0]:], p[1:1 + 2 * p[0]]) for m, p in segs
             if m == 0xDA]
    got = [(tuple(comps[::2]), rest[0], rest[1], rest[2] >> 4, rest[2] & 15)
           for rest, comps in scans]
    assert got == [((1, 2, 3), 0, 0, 0, 1), ((1,), 1, 5, 0, 2),
                   ((3,), 1, 63, 0, 1), ((2,), 1, 63, 0, 1),
                   ((1,), 6, 63, 0, 2), ((1,), 1, 63, 2, 1),
                   ((1, 2, 3), 0, 0, 1, 0), ((3,), 1, 63, 1, 0),
                   ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0)]
    # Table selectors (DC << 4 | AC) as libjpeg writes them: the scan's own
    # class, 0 for the other and for DC refinement.
    assert [tuple(comps[1::2]) for _, comps in scans] == [
        (0x00, 0x10, 0x10), (0x00,), (0x01,), (0x01,), (0x00,), (0x00,),
        (0x00, 0x00, 0x00), (0x01,), (0x01,), (0x00,)]
    # A DHT before every scan but the DC refinement, with that scan's
    # tables: DC 0 and 1 for DC first, one AC table for an AC scan.
    pos = [i for i, m in enumerate(kinds) if m == 0xDA]
    for n, (i, (_, ss, _, ah, _)) in enumerate(zip(pos, got)):
        before = [p[0] for m, p in segs[(pos[n - 1] if n else 0):i]
                  if m == 0xC4]
        if ss == 0 and ah:
            assert before == []
        elif ss == 0:
            assert before == [0x00, 0x01]
        else:
            assert before == [0x10 | (got[n][0] != (1,))]


def test_k2_lengths_of_a_hand_worked_histogram():
    # Counts 5, 3, 1 of symbols 0, 1, 2 and the reserved point (1): merge
    # {2, reserved} (2), then with 1 (5), then with 0 (10): sizes 1, 2, 3,
    # and the reserved point's 3 dropped.
    counts = np.zeros(256, np.int64)
    counts[[0, 1, 2]] = [5, 3, 1]
    assert P.optimal_table(counts) == ([1, 1, 1] + [0] * 13, [0, 1, 2])
    # Counts 2, 1, 1: of equal counts libjpeg merges the higher values
    # first ({2, reserved}, then 1 with it, as the merged node keeps value
    # 256), so 0 gets one bit; merging the lower first would give every
    # symbol two.
    counts = np.zeros(256, np.int64)
    counts[[0, 1, 2]] = [2, 1, 1]
    assert P.optimal_table(counts) == ([1, 1, 1] + [0] * 13, [0, 1, 2])
    # One symbol alone still gets a code, of one bit.
    counts = np.zeros(256, np.int64)
    counts[0x37] = 9
    assert P.optimal_table(counts) == ([1] + [0] * 15, [0x37])


def fibonacci(n):
    a, b = 1, 1
    for _ in range(n):
        yield a
        a, b = b, a + b


@pytest.mark.parametrize("seed", range(6))
def test_k2_codes_are_prefix_free_short_and_never_all_ones(seed):
    rng = np.random.default_rng(seed)
    counts = np.zeros(256, np.int64)
    # Fibonacci counts need codes far past 16 bits (Figure K.3's cut).
    n = int(rng.integers(1, 257)) if seed % 2 else int(rng.integers(20, 41))
    sym = rng.choice(256, n, replace=False)
    counts[sym] = rng.integers(1, 10**6, n) if seed % 2 else list(
        fibonacci(n))
    bits, vals = P.optimal_table(counts)
    assert sorted(vals) == sorted(sym.tolist()) and len(bits) == 16
    code, length = P.huffman_codes((bits, vals))
    lens = length[vals]
    assert lens.max() <= 16 and (lens >= 1).all()
    assert sum(2.0 ** -int(x) for x in lens) < 1.0  # Kraft, one point spare
    assert not any(code[v] == (1 << length[v]) - 1 for v in vals)


def test_an_eob_run_longer_than_0x7fff_is_cut():
    # A flat 4:4:4 frame of 33,000 luma blocks: every AC band is zero, so
    # each AC scan is one EOB run of them, cut at 0x7FFF.
    h, w = 64, 33000
    n = (h // 8) * (w // 8)
    coefs = torch.zeros(1, n, 3, 64, dtype=torch.int64)
    coefs[0, :, :, 0] = torch.arange(n)[:, None] % 50 - 25
    y = PP.component_blocks(coefs, h, w, "444")[0]
    f = PP._ac_first(y, 1, 5, 2)
    runs = [(int(s), int(x), int(e)) for s, x, e in zip(f[3], f[4], f[5])]
    # 33,000 = 0x7FFF + 233: EOB14 with 14 low bits, then EOB7 with 7.
    assert sorted(runs) == [(0x70, 233 - 128, 7), (0xE0, 0x3FFF, 14)]
    (prog, _), = PP.streams(coefs, h, w, 50, "444")
    (base, _), = P.streams(coefs, h, w, 50, "444")
    assert np.array_equal(pil(prog), pil(base))
    grids = port_grids(prog, "native")
    assert all(np.array_equal(g, coefs[0, :, c].numpy())
               for c, g in enumerate(grids))


def synthetic(n_mcu, rng, low, high, zero_share):
    """(1, n_mcu, 6, 64) random coefficients, |AC| in [low, high] or 0."""
    mag = torch.as_tensor(rng.integers(low, high + 1, (1, n_mcu, 6, 64)))
    sign = torch.as_tensor(rng.choice([-1, 1], (1, n_mcu, 6, 64)))
    keep = torch.as_tensor(rng.random((1, n_mcu, 6, 64)) >= zero_share)
    out = mag * sign * keep
    out[..., 0] = torch.as_tensor(rng.integers(-300, 300, (1, n_mcu, 6)))
    return out


def test_a_refinement_scan_flushes_its_correction_bits_past_937():
    # |AC| in {2, 3}: in the last Y refinement every coefficient was seen
    # before and none is new, so each block is an EOB adding 63 correction
    # bits; 15 blocks pass 937 and the run is emitted.
    h, w = 64, 64
    coefs = synthetic(16, np.random.default_rng(1), 2, 3, 0.0)
    y = PP.component_blocks(coefs, h, w, "420")[0]
    f = PP._ac_refine(y, 1, 63, 0)
    eob = (f[2] == 0) & ((f[3] & 15) == 0) & (f[3] != 0xF0)
    lengths = (1 << (f[3][eob] >> 4)) + f[4][eob]
    assert sorted(lengths.tolist()) == [4, 15, 15, 15, 15]
    assert int((f[2] < 0).sum()) == 64 * 63  # every bit, once
    (prog, _), = PP.streams(coefs, h, w, 90)
    (base, _), = P.streams(coefs, h, w, 90)
    assert np.array_equal(pil(prog), pil(base))
    assert_grids_equal(prog, coefs, h, w, "420")


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sparse_random_coefficients(seed):
    """Long zero runs between new and seen coefficients: ZRLs inside
    refinement scans, correction bits after a ZRL, EOB runs across blocks."""
    rng = np.random.default_rng(seed)
    h, w = 48, 80
    coefs = synthetic(15, rng, 1, 40, 0.85 + 0.04 * seed)
    (prog, _), = PP.streams(coefs, h, w, 90)
    (base, _), = P.streams(coefs, h, w, 90)
    assert np.array_equal(pil(prog), pil(base))
    assert_grids_equal(prog, coefs, h, w, "420")


@pytest.mark.parametrize("rst", [0, 5])
@pytest.mark.parametrize("sub", ["420", "422", "444"])
def test_optimized_baseline_streams(sub, rst):
    """One interleaved scan with each image's four Annex K.2 tables: the
    serial decoder reads the coefficients back, PIL the baseline's pixels."""
    imgs = torch.cat([image(33, 50, s) for s in range(3)])
    coefs = P.coefficients(imgs, 90, subsampling=sub)
    opt = P.streams(coefs, 33, 50, 90, sub, rst, optimize=True)
    base = P.streams(coefs, 33, 50, 90, sub, rst)
    tables, _ = P.entropy_code(coefs, rst, optimize=True)
    for i, ((o, n), (b, _)) in enumerate(zip(opt, base)):
        info, got = P.decode_coefficients(o)
        assert np.array_equal(got, coefs[i].numpy())
        assert len(info["scan"]) == n
        assert np.array_equal(pil(o), pil(b))
        specs = [info["htables"][k] for k in ((0, 0), (0, 1), (1, 0), (1, 1))]
        assert specs == [tuple(map(list, t)) for t in tables[i]]
        assert specs != list(P.ANNEX_K)
    assert tables[0] != tables[1]  # each image its own


def test_optimized_streams_decode_with_the_port_on_the_cpu():
    jt = pytest.importorskip("jpeg_tpu_torch")
    img = image(37, 50, 4)
    coefs = P.coefficients(img, 90)
    (opt, _), = P.streams(coefs, 37, 50, 90, optimize=True)
    (base, _), = P.streams(coefs, 37, 50, 90)
    (prog, _), = PP.streams(coefs, 37, 50, 90)
    want = np.asarray(jt.decode(base, device="cpu"))
    assert np.array_equal(np.asarray(jt.decode(opt, device="cpu")), want)
    assert np.array_equal(np.asarray(jt.decode(prog, device="cpu")), want)


def config(**kw):
    return dict({"kind": "frames", "width": 72, "height": 40, "quality": 75,
                 "noise": 10, "roll": 97, "subsampling": "420"}, **kw)


@pytest.mark.parametrize("override,word", [
    ({"progressive": True}, "progressive"),
    ({"progressive": True, "optimize_tables": True}, "huffman_tables"),
    (dict(K2, restart_interval=8), "restart_interval"),
    ({"optimize_tables": True, "huffman_tables": inputs.ANNEX_K3},
     "optimize_tables"),
    ({"huffman_tables": inputs.ANNEX_K2}, "optimize_tables"),
    ({"progressive": 1}, "progressive"),
])
def test_contradictory_configurations_are_refused(override, word):
    with pytest.raises(ValueError, match=word):
        inputs.check_config(config(**override))


@pytest.mark.parametrize("override", [K2, dict(K2, progressive=False)],
                         ids=["progressive", "optimized"])
def test_an_encode_stream_over_k2_tables_is_refused_at_open(override):
    inputs.check_config(config(**override))
    with pytest.raises(ValueError, match="progressive" if override[
            "progressive"] else "optimize_tables"):
        harness.run_cell(harness.load_spec(), "uhd-encode-stream", 3, 0.5,
                         False, device="cpu",
                         config_override=dict(override, width=64, height=32))


@pytest.mark.parametrize("override", [K2, dict(K2, progressive=False)],
                         ids=["progressive", "optimized"])
def test_stated_streams_are_built(override):
    inp = inputs.build(config(**override), 0, 3, 2**31 + 9, "cpu")
    for frame, data, n in zip(inp.frames, inp.streams, inp.scan_bytes):
        kinds = [m for m, _ in markers(data)]
        assert (0xC2 in kinds) == override["progressive"]
        assert n == len(data) - len(markers_bytes(data))
        want = P.coefficients(torch.as_tensor(frame)[None], 75)
        (base, _), = P.streams(want, 40, 72, 75)
        assert np.array_equal(pil(data), pil(base))
