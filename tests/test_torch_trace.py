"""jpeg_tpu_torch's stage spans (utils/trace.span) on the CPU: which spans
each entry point leaves in a torch.profiler Chrome trace, on which thread,
nested how, and that tracing changes no output.

Leaves are the stages of one image and never nest in one another; each sits
inside one of the three parents (jt.decode, jt.encode.dispatch,
jt.encode.finish) on the same thread. jt.wait.slot and encode_stream's
jt.encode.stage exist only on a card (the CPU path has no ring of CUDA
streams), and so does decode_stream's jt.wait.stream: the tests marked
`cuda` check them there, that every call that blocks the host on the card
lies inside a jt.wait.* leaf, and that encode_stream's dispatch waits for
nothing once the transform's constants are on the card
(python -m pytest tests/test_torch_trace.py --noconftest -m cuda).

Every test that counts an encode's leaves encodes the same image first:
that fills the transform's constant cache (ops/mcu_conv.constant), whose
uploads are leaves only when they happen."""

import collections
import json
import os
import tempfile
import threading

import numpy as np
import pytest
import torch

import jpeg_tpu_torch
from jpeg_tpu_torch.models import encoder as PE
from jpeg_tpu_torch.models.progressive_enc import encode_progressive
from jpeg_tpu_torch.ops import mcu_conv
from jpeg_tpu_torch.utils import trace as PT

from torch_port_util import (  # noqa: F401
    jax_exact_transform, make_image, require_cuda)

PARENTS = {"jt.decode", "jt.encode.dispatch", "jt.encode.finish"}
CPU = "cpu"


def _all_threads_config():
    try:
        return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


def traced(fn, all_threads=False, events=None):
    """(fn(), [(name, start, end, tid)] of the jt.* spans in the trace). A
    list passed as `events` receives the trace's other complete events (the
    card's activity too, which is then recorded)."""
    kw = {}
    if all_threads:
        cfg = _all_threads_config()
        if cfg is None:
            pytest.skip("this torch cannot profile every thread")
        kw["experimental_config"] = cfg
    acts = [torch.profiler.ProfilerActivity.CPU]
    if events is not None:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts, **kw) as prof:
        out = fn()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            raw = json.load(f)
    finally:
        os.unlink(path)
    found = []
    for e in raw["traceEvents"]:
        if e.get("ph") != "X":
            continue
        ev = (e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]),
              e.get("tid"))
        if e.get("cat") == "user_annotation" and e["name"].startswith("jt."):
            found.append(ev)
        elif events is not None:
            events.append(ev + (e.get("cat"),))
    return out, found


def leaves(found):
    return [s for s in found if s[0] not in PARENTS]


def counts(found):
    return collections.Counter(s[0] for s in leaves(found))


def inside(a, b):
    return a[3] == b[3] and b[1] <= a[1] and a[2] <= b[2]


def check_nesting(found, parent_of):
    """Every leaf inside a parent of the kind parent_of names, on its
    thread; no leaf inside another leaf."""
    parents = [s for s in found if s[0] in PARENTS]
    lv = leaves(found)
    for leaf in lv:
        holders = {p[0] for p in parents if inside(leaf, p)}
        assert holders & parent_of(leaf[0]), (leaf, holders)
        for other in lv:
            if other is not leaf and other[3] == leaf[3]:
                assert not (other[1] < leaf[2] and leaf[1] < other[2]), (
                    leaf, other)


def test_span_without_a_profile_is_one_shared_null_context():
    a, b = PT.span("jt.decode"), PT.span("jt.wait.upload")
    assert a is b
    with a:
        pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        inner = PT.span("jt.decode")
        assert inner is not a
        with inner:
            pass
    assert PT.span("jt.decode") is a


def _frames():
    return [make_image(h, w, seed=h * w) for h, w in ((24, 32), (40, 48),
                                                      (17, 29))]


ENCODE_STREAM_PARENT = {
    "jt.encode.stage": "jt.encode.dispatch",
    "jt.wait.upload": "jt.encode.dispatch",
    "jt.encode.transform": "jt.encode.dispatch",
    "jt.encode.pack": "jt.encode.dispatch",
    "jt.wait.download": "jt.encode.finish",
    "jt.encode.finalize": "jt.encode.finish",
    "jt.encode.spill": "jt.encode.finish",
    "jt.wait.status": "jt.encode.finish",
}


# The leaves of one frame's device-pack encode, colour or gray, once the
# transform's constants are cached: the frame's upload, then three transform
# leaves (the pad, the transform itself, the DPCM) with no wait between.
FRAME = {"jt.wait.upload": 1, "jt.encode.transform": 3, "jt.encode.pack": 1,
         "jt.wait.download": 1, "jt.encode.finalize": 1}
# On a card encode_stream's dispatch stages the frame instead of waiting for
# its upload.
CARD_FRAME = {"jt.encode.stage": 1, "jt.encode.transform": 3,
              "jt.encode.pack": 1, "jt.wait.download": 1,
              "jt.encode.finalize": 1}


def test_encode_stream_gives_every_leaf_for_every_frame():
    frames = _frames()
    want = list(jpeg_tpu_torch.encode_stream(iter(frames), depth=2,
                                             device=CPU))
    got, found = traced(lambda: list(jpeg_tpu_torch.encode_stream(
        iter(frames), depth=2, device=CPU)))
    assert counts(found) == {n: 3 * c for n, c in FRAME.items()}
    assert collections.Counter(s[0] for s in found if s[0] in PARENTS) == {
        "jt.encode.dispatch": 3, "jt.encode.finish": 3}
    check_nesting(found, lambda n: {ENCODE_STREAM_PARENT[n]})
    assert len({s[3] for s in found}) == 1  # the consumer's own thread
    assert got == want


def test_a_spilled_frame_gives_one_spill_span():
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:24, 0:32]
    smooth = np.stack([xx * 4, yy * 5, xx + yy], -1).astype(np.uint8)
    noise = rng.integers(0, 256, size=(24, 32, 3)).astype(np.uint8)
    want = [jpeg_tpu_torch.encode(im, 100, "444", device=CPU)
            for im in (smooth, noise, smooth)]
    spills = PE.HOST_PACK_SPILLS
    got, found = traced(lambda: list(jpeg_tpu_torch.encode_stream(
        [smooth, noise, smooth], 100, "444", device=CPU)))
    assert PE.HOST_PACK_SPILLS == spills + 1
    n = counts(found)
    assert n["jt.encode.spill"] == 1
    assert n["jt.encode.finalize"] == n["jt.wait.download"] == 2
    check_nesting(found, lambda n: {ENCODE_STREAM_PARENT[n]})
    assert got == want


HOST_PACK = {"jt.wait.upload": 1, "jt.encode.transform": 2,
             "jt.wait.download": 1, "jt.encode.finalize": 1}


@pytest.mark.parametrize("image,kw,expect", [
    ("rgb", {}, dict(FRAME, **{"jt.wait.status": 1})),
    ("rgb", {"optimize_tables": True, "restart_interval": 2},
     dict(FRAME, **{"jt.encode.pack": 2, "jt.wait.status": 2})),
    ("rgb", {"device_pack": False}, HOST_PACK),
    ("gray", {}, dict(FRAME, **{"jt.wait.status": 1})),
    ("gray", {"device_pack": False}, HOST_PACK),
])
def test_encode_gives_its_leaves(image, kw, expect):
    img = make_image(40, 56, seed=9)
    if image == "gray":
        img = img[..., 0]
    want = jpeg_tpu_torch.encode(img, device=CPU, **kw)
    got, found = traced(lambda: jpeg_tpu_torch.encode(img, device=CPU, **kw))
    assert counts(found) == expect
    check_nesting(found, lambda n: {"jt.encode.dispatch", "jt.encode.finish"})
    assert got == want


@pytest.fixture
def fresh_constants(monkeypatch):
    """An empty constant cache for the test, the process's own after it."""
    monkeypatch.setattr(mcu_conv, "_constants", collections.OrderedDict())
    return mcu_conv


def _uploads_of(fn):
    before = mcu_conv.CONSTANT_UPLOADS
    out = fn()
    return mcu_conv.CONSTANT_UPLOADS - before, out


@pytest.mark.parametrize("image", ["rgb", "gray"])
def test_the_transform_constants_go_up_once_per_table_set(
        image, fresh_constants, jax_exact_transform):
    import jpeg_tpu

    img = make_image(24, 40, seed=3)
    if image == "gray":
        img = img[..., 0]
    rng = np.random.default_rng(7)
    own = [rng.integers(1, 256, size=(8, 8)) for _ in range(2)]
    # The first encode of a mode uploads its divisors and, in colour, its
    # table-id row; after it only a new table set uploads, once.
    cases = [({"quality": 75}, 2 if image == "rgb" else 1),
             ({"quality": 75}, 0), ({"quality": 31}, 1), ({"quality": 31}, 0),
             ({"quant_tables": own}, 1), ({"quant_tables": own}, 0),
             ({"quality": 75, "device_pack": False}, 0)]
    for kw, uploads in cases:
        n, got = _uploads_of(lambda: jpeg_tpu_torch.encode(img, device=CPU,
                                                           **kw))
        assert n == uploads, kw
        assert got == jpeg_tpu.encode(img, **kw), kw
    # A hit opens no span: the transform's leaves no longer split.
    _, found = traced(lambda: jpeg_tpu_torch.encode(img, 31, device=CPU))
    assert counts(found)["jt.wait.upload"] == 1  # the frame's


def test_eviction_past_the_bound_keeps_the_bytes(
        fresh_constants, monkeypatch, jax_exact_transform):
    import jpeg_tpu

    monkeypatch.setattr(mcu_conv, "_CONSTANTS_SIZE", 2)
    img = make_image(16, 32, seed=4)
    # Two entries hold the table-id row and one table set, so each new
    # quality evicts the set before it, which goes up again when its
    # quality comes back.
    qualities, uploads = (40, 50, 60, 40, 50), (2, 1, 1, 1, 1)
    want = {q: jpeg_tpu.encode(img, q) for q in set(qualities)}
    for q, expect in zip(qualities, uploads):
        n, got = _uploads_of(lambda: jpeg_tpu_torch.encode(img, q,
                                                           device=CPU))
        assert len(mcu_conv._constants) == 2
        assert n == expect
        assert got == want[q]
    n, got = _uploads_of(lambda: jpeg_tpu_torch.encode(img, 50, device=CPU))
    assert n == 0 and got == want[50]


def _stream(kind):
    img = make_image(40, 56, seed=11)
    if kind == "gray":
        return jpeg_tpu_torch.encode(img[..., 0], 80, device=CPU)
    if kind == "restart":
        return jpeg_tpu_torch.encode(img, 80, "420", 2, device=CPU)
    if kind == "progressive":
        return encode_progressive(img, 80, "420", device=CPU)
    return jpeg_tpu_torch.encode(img, 80, "420", device=CPU)


DEVICE_LEAVES = {"jt.decode.parse": 1, "jt.decode.unstuff": 1,
                 "jt.wait.upload": 2, "jt.decode.entropy": 1,
                 "jt.wait.status": 1, "jt.decode.finish": 1,
                 "jt.wait.download": 1}
WALK_LEAVES = {"jt.decode.parse": 1, "jt.decode.walk": 1,
               "jt.wait.upload": 2, "jt.decode.finish": 1,
               "jt.wait.download": 1}


@pytest.mark.parametrize("kind,entropy,expect", [
    ("baseline", "device", DEVICE_LEAVES),
    ("restart", "device", DEVICE_LEAVES),
    ("gray", "device", DEVICE_LEAVES),
    ("baseline", "indexed", dict(WALK_LEAVES, **{"jt.decode.entropy": 1})),
    # The densify's eight shift vectors are blocking uploads of their own.
    ("baseline", "sparse", dict(WALK_LEAVES, **{"jt.wait.upload": 10})),
    ("baseline", "auto", WALK_LEAVES),
    ("baseline", "numpy", WALK_LEAVES),
    ("progressive", "auto", WALK_LEAVES),
])
def test_decode_gives_its_leaves(kind, entropy, expect):
    data = _stream(kind)
    got, found = traced(lambda: jpeg_tpu_torch.decode(
        data, device=CPU, entropy=entropy))
    assert counts(found) == expect
    check_nesting(found, lambda n: {"jt.decode"})
    np.testing.assert_array_equal(got, jpeg_tpu_torch.decode(
        data, device=CPU, entropy=entropy))


@pytest.mark.parametrize("kw,download", [
    ({"device_output": True}, 0),
    ({"output": "ycbcr"}, 1),
    ({"scale_denom": 2}, 1),
])
def test_decode_downloads_only_a_host_result(kw, download):
    data = _stream("baseline")
    _, found = traced(lambda: jpeg_tpu_torch.decode(data, device=CPU, **kw))
    assert counts(found)["jt.wait.download"] == download
    assert counts(found)["jt.decode.finish"] == 1


def test_decode_stream_leaves_are_on_the_worker_threads():
    jpgs = [_stream(k) for k in ("baseline", "restart", "gray", "baseline")]
    main = threading.get_native_id()
    got, found = traced(lambda: list(jpeg_tpu_torch.decode_stream(
        iter(jpgs), depth=2, device=CPU, entropy="device")), all_threads=True)
    parse = [s for s in found if s[0] == "jt.decode.parse"]
    assert len(parse) == len(jpgs)
    tids = {s[3] for s in leaves(found)}
    assert main not in tids and 1 <= len(tids) <= 2
    assert counts(found)["jt.decode.entropy"] == len(jpgs)
    check_nesting(found, lambda n: {"jt.decode"})
    for a, b in zip(got, jpgs):
        np.testing.assert_array_equal(a, jpeg_tpu_torch.decode(b, device=CPU))


@pytest.mark.cuda
def test_on_the_card_the_host_blocks_only_inside_wait_leaves():
    dev = require_cuda()
    frames = [make_image(64, 96, seed=s) for s in range(4)]
    want = list(jpeg_tpu_torch.encode_stream(iter(frames), device=dev))
    jpgs = want[:2]
    plain = [jpeg_tpu_torch.decode(j, device=dev) for j in jpgs]
    events: list = []

    def run():
        enc = list(jpeg_tpu_torch.encode_stream(iter(frames), device=dev))
        dec = list(jpeg_tpu_torch.decode_stream(iter(jpgs), device=dev))
        return enc, dec

    (enc, dec), found = traced(run, all_threads=True, events=events)
    assert enc == want
    for a, b in zip(dec, plain):
        np.testing.assert_array_equal(a, b)
    main = {s[3] for s in found if s[0] == "jt.encode.dispatch"}
    assert len(main) == 1
    enc_counts = collections.Counter(s[0] for s in leaves(found)
                                     if s[3] in main)
    assert enc_counts == dict({n: 4 * c for n, c in CARD_FRAME.items()},
                              **{"jt.wait.slot": 4})
    workers = [s for s in leaves(found) if s[3] not in main]
    assert collections.Counter(s[0] for s in workers)["jt.wait.stream"] == 2
    assert sum(s[0] == "jt.decode.parse" for s in workers) == 2
    check_nesting([s for s in found if s[3] in main],
                  lambda n: {ENCODE_STREAM_PARENT.get(n, "jt.encode.finish")})
    # From the first dispatch to the last finish: the profiler's own
    # synchronize at its end falls outside.
    ours = [s for s in found if s[3] in main]
    lo, hi = min(s[1] for s in ours), max(s[2] for s in ours)
    waits = [s for s in found if s[0].startswith("jt.wait.")]
    blocking = [e for e in events if e[4] == "cuda_runtime"
                and e[3] in main and "Synchronize" in e[0]
                and lo <= e[1] <= hi]
    assert blocking
    for e in blocking:
        assert any(w[3] == e[3] and w[1] <= e[1] and e[2] <= w[2]
                   for w in waits), e


@pytest.mark.cuda
@pytest.mark.parametrize("optimize", [False, True])
def test_on_the_card_encode_stream_dispatch_waits_for_nothing(optimize):
    """Once the transform's constants are on the card, a frame's dispatch
    stages it (one jt.encode.stage leaf) and blocks on no upload: no
    jt.wait.* leaf under jt.encode.dispatch, and without optimize_tables
    every host-to-card copy of the stream comes from pinned memory (with
    it, finish uploads each frame's own Huffman tables)."""
    dev = require_cuda()
    frames = [make_image(120, 200, seed=s) for s in range(5)]
    kw = dict(quality=85, optimize_tables=optimize, device=dev)
    want = list(jpeg_tpu_torch.encode_stream(iter(frames), **kw))
    events: list = []
    uploads = mcu_conv.CONSTANT_UPLOADS
    got, found = traced(lambda: list(jpeg_tpu_torch.encode_stream(
        iter(frames), **kw)), events=events)
    assert got == want
    assert mcu_conv.CONSTANT_UPLOADS == uploads
    dispatches = [s for s in found if s[0] == "jt.encode.dispatch"]
    assert len(dispatches) == len(frames)
    for d in dispatches:
        under = collections.Counter(s[0] for s in leaves(found)
                                    if inside(s, d))
        assert under["jt.encode.stage"] == 1, under
        assert not [n for n in under if n.startswith("jt.wait.")], under
    h2d = [e for e in events if e[0].startswith("Memcpy HtoD")]
    assert len(h2d) >= len(frames)
    if not optimize:
        assert all("Pageable" not in e[0] for e in h2d), h2d
