"""The readers of the program's own spans (lib/spans and the metrics
wait_ms_per_image, enqueue_ms_per_image, finalize_ms_per_image and
spill_share) on hand-made profiler events (times in microseconds): a window
of two frames, their leaves on two threads, a parent, spans that straddle
the window's edges, and a trace without any program span."""

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
