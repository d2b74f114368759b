"""The readers of the program's own spans (lib/spans and the metrics
wait_ms_per_image, enqueue_ms_per_image, finalize_ms_per_image, spill_share,
parse_ms_per_image and unstuff_ms_per_image) on hand-made profiler events
(times in microseconds): a window of two frames, their leaves on two threads,
a parent, spans that straddle the window's edges, two decodes on two worker
threads, and a trace without any program span; and the profiler's own events
of a span on a worker thread."""

import pytest

from lib import harness, spans, trace as tr


def ev(name, ts, dur, tid=1, cat="user_annotation"):
    return {"cat": cat, "name": name, "ts": float(ts), "dur": float(dur),
            "tid": tid}


def window():
    return [ev(tr.WINDOW, 100, 1000),
            ev("stream_next", 100, 500), ev("stream_next", 600, 500),
            ev("kernel_a", 300, 50, cat="kernel")]


def frames():
    """Two frames in [100, 1100]. Frame 1's upload starts 20 us before the
    window; frame 2's finalize ends 30 us after it."""
    return [
        # Frame 1: dispatch on thread 1 with its leaves.
        ev("jt.encode.dispatch", 80, 200),
        ev("jt.wait.upload", 80, 60),  # 40 us inside the window
        ev("jt.encode.transform", 140, 50),
        ev("jt.encode.pack", 190, 40),
        ev("jt.encode.finish", 400, 300),
        ev("jt.wait.slot", 400, 100),
        ev("jt.wait.download", 500, 20),
        ev("jt.encode.finalize", 520, 150),
        # Frame 2: spilled, and its finalize-side span crosses the end.
        ev("jt.encode.dispatch", 700, 100, tid=2),
        ev("jt.wait.upload", 700, 30, tid=2),
        ev("jt.encode.transform", 730, 30, tid=2),
        ev("jt.encode.pack", 760, 20, tid=2),
        ev("jt.encode.spill", 1000, 130),  # 100 us inside
        # A span of the program entirely after the window.
        ev("jt.encode.finalize", 1200, 50),
        # A decode leaf counts towards the enqueue quantity too.
        ev("jt.decode.entropy", 900, 10, tid=3),
    ]


def trace(events, images=2):
    return tr.Trace(events, images, {"pixels": 0, "blocks": 0,
                                     "scan_bytes": 0})


def read(name, t):
    return harness.reader(name)(t)


def test_clipped_spans_stay_inside_the_window():
    t = trace(window() + frames())
    got = spans.clipped(t, lambda n: n.startswith("jt.wait."))
    assert sorted(got) == [("jt.wait.download", 500, 520),
                           ("jt.wait.slot", 400, 500),
                           ("jt.wait.upload", 100, 140),
                           ("jt.wait.upload", 700, 730)]
    # Harness spans and spans outside the window are not the program's.
    assert not spans.clipped(t, lambda n: n == "stream_next")
    assert not [s for s in spans.clipped(t, lambda n: True) if s[1] >= 1100]


@pytest.mark.parametrize("name,us", [
    # upload 40 (clipped) + slot 100 + download 20 + upload 30
    ("wait_ms_per_image.encode", 190),
    # transform 50 + pack 40 + transform 30 + pack 20 + decode entropy 10
    ("enqueue_ms_per_image.encode", 150),
    # frame 1's finalize; the one after the window is left out
    ("finalize_ms_per_image", 150),
])
def test_durations_per_image(name, us):
    assert read(name, trace(window() + frames())) == pytest.approx(
        us / 1000 / 2)


def test_the_enqueue_list_names_leaves_of_the_program():
    from metrics import enqueue_ms_per_image as m

    assert m.NAMES == {"jt.encode.transform", "jt.encode.pack",
                       "jt.decode.entropy", "jt.decode.finish"}


def test_spill_share_counts_spills_over_images():
    t = trace(window() + frames())
    assert read("spill_share", t) == pytest.approx(50.0)
    no_spill = [e for e in frames() if e["name"] != "jt.encode.spill"]
    no_spill.append(ev("jt.encode.finalize", 900, 40))
    assert read("spill_share", trace(window() + no_spill)) == 0.0


@pytest.mark.parametrize("name", [
    "wait_ms_per_image.encode", "enqueue_ms_per_image.encode",
    "finalize_ms_per_image", "spill_share"])
def test_a_trace_without_program_spans_reads_nothing(name):
    assert read(name, trace(window())) is None
    # Spans but no finished image: nothing to divide by.
    assert read(name, trace(window() + frames(), images=0)) is None


def decodes():
    """Two images decoded on two worker threads (tids 7 and 8) in [100,
    1100], as decode_stream runs them; the harness's stream_next is on
    thread 1. Image 2's finish wait ends 40 us after the window."""
    return [
        ev("jt.decode", 110, 400, tid=7),
        ev("jt.decode.parse", 110, 60, tid=7),
        ev("jt.decode.unstuff", 170, 30, tid=7),
        ev("jt.decode.entropy", 200, 50, tid=7),
        ev("jt.wait.status", 250, 90, tid=7),
        ev("jt.decode.finish", 340, 70, tid=7),
        ev("jt.decode", 600, 540, tid=8),
        ev("jt.decode.parse", 600, 80, tid=8),
        ev("jt.decode.unstuff", 680, 20, tid=8),
        ev("jt.decode.entropy", 700, 40, tid=8),
        ev("jt.wait.upload", 740, 10, tid=8),
        ev("jt.decode.finish", 750, 50, tid=8),
        ev("jt.wait.stream", 1060, 80, tid=8),  # 40 us inside
    ]


@pytest.mark.parametrize("name,us", [
    ("parse_ms_per_image.decode", 60 + 80),
    ("unstuff_ms_per_image.decode", 30 + 20),
    # entropy 50 + finish 70 + entropy 40 + finish 50
    ("enqueue_ms_per_image.decode", 210),
    # status 90 + upload 10 + stream 40 (clipped)
    ("wait_ms_per_image.decode", 140),
])
def test_decode_leaves_on_worker_threads(name, us):
    assert read(name, trace(window() + decodes())) == pytest.approx(
        us / 1000 / 2)
    assert read(name, trace(window())) is None


def test_a_gap_is_named_by_a_worker_thread_span():
    # The card idles from 350 to 1100 but for kernel_a at 300-350; at the
    # gap's middle (725) worker 8 is inside jt.decode.entropy.
    b = trace(window() + decodes()).breakdown()
    assert b["idle_gaps"][0][0] == "jt.decode.entropy"


def test_the_traced_stretch_records_every_thread():
    """A span opened on a thread that the program starts, inside
    trace.profiled(), is among the events, on a thread of its own."""
    import threading

    import torch

    out = {}

    def worker():
        with torch.profiler.record_function("jt.decode.parse"):
            torch.ones(8).sum()

    with tr.profiled(out):
        with torch.profiler.record_function("main_side"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=60)
    assert not t.is_alive()
    tids = {e["name"]: e["tid"] for e in out["events"]
            if e["cat"] == "user_annotation"}
    assert "jt.decode.parse" in tids and "main_side" in tids
    assert tids["jt.decode.parse"] != tids["main_side"]
