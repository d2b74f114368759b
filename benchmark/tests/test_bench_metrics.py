"""The trace readers and the work-byte counts, on a small synthetic
profiler event list (times in microseconds, as a Chrome trace has them)."""

import json
import pathlib

import pytest

from lib import harness, trace as tr
from metrics import work_bytes

ROOT = pathlib.Path(__file__).resolve().parents[2]


def ev(cat, name, ts, dur, tid=1):
    return {"cat": cat, "name": name, "ts": float(ts), "dur": float(dur),
            "tid": tid}


def synthetic():
    """A 100 us window holding two images: kernels, copies and a memset,
    and spans of the harness."""
    return [
        ev("user_annotation", tr.WINDOW, 0, 100),
        ev("user_annotation", "stream_next", 0, 60),
        ev("user_annotation", "stream_next", 60, 40),
        ev("user_annotation", "decode_call", 10, 30),
        ev("cpu_op", "aten::copy_", 45, 10),
        ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 0, 10),
        ev("kernel", "void layout_kernel(jt::Sync)", 10, 5),
        ev("kernel", "ac_indexed_kernel(unsigned int const*, int)", 12, 8),
        ev("kernel", "void jt::idct8_samples_kernel<3>(ZArgs)", 20, 10),
        ev("kernel", "finish_color_kernel(Args)", 30, 10),
        ev("gpu_memset", "Memset (Device)", 40, 2),
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 70, 20),
        ev("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 92, 2),
        ev("kernel", "outside_kernel", 120, 50),  # after the window
        ev("gpu_user_annotation", tr.WINDOW, 0, 100),
    ]


WORK = {"pixels": 2 * 3840 * 2160, "blocks": 2 * 194_400,
        "scan_bytes": 2 * 640_000}


def trace():
    return tr.Trace(synthetic(), 2, dict(WORK))


def read(name):
    return harness.reader(name)(trace())


def test_busy_idle_and_gaps():
    t = trace()
    # Busy: [0, 42] and [70, 90] and [92, 94] -> 64 of 100 us.
    assert t.busy_us() == pytest.approx(64.0)
    assert t.idle_share() == pytest.approx(0.36)
    assert read("device_idle.decode") == pytest.approx(36.0)
    assert read("device_idle.encode") == pytest.approx(36.0)
    assert t.gaps() == [(42.0, 70.0), (90.0, 92.0), (94.0, 100.0)]
    # Inside the decode_call span [10, 40] the card is busy throughout.
    assert t.idle_share(("decode_call",)) == pytest.approx(0.0)
    assert t.idle_share(("encode_call",)) is None  # no such span


def test_copy_time_and_launches_per_image():
    # H2D 10 us + D2H 20 us (the D2D copy is not a host copy) over 2 images.
    assert read("copy_ms_per_image.decode") == pytest.approx(0.015)
    assert read("copy_ms_per_image.encode") == pytest.approx(0.015)
    # 4 kernels + 3 copies + 1 memset inside the window.
    assert read("launches_per_image.decode") == pytest.approx(4.0)


def test_kernel_shares_from_the_name_lists():
    t = trace()
    assert t.kernel_us(["layout_kernel", "ac_indexed_kernel"]) == 13.0
    ent = work_bytes.entropy_bytes(WORK["scan_bytes"], WORK["blocks"])
    assert read("entropy_roofline") == pytest.approx(
        100 * ent / 3.35e12 / 13e-6)
    fin = work_bytes.finish_bytes(WORK["blocks"], WORK["pixels"])
    assert read("finish_roofline") == pytest.approx(100 * fin / 3.35e12 / 20e-6)
    enc = work_bytes.encode_bytes(WORK["pixels"], WORK["scan_bytes"])
    assert read("encode_roofline") == pytest.approx(100 * enc / 3.35e12 / 33e-6)
    lists = sorted((ROOT / "benchmark" / "metrics").glob("*.kernels.json"))
    assert [p.name for p in lists] == ["entropy_roofline.kernels.json",
                                       "finish_roofline.kernels.json"]
    for p in lists:
        assert all(isinstance(n, str) and n for n in json.loads(p.read_text()))


def test_no_kernel_no_share():
    events = [e for e in synthetic() if e["cat"] != "kernel"]
    t = tr.Trace(events, 2, dict(WORK))
    for name in ("entropy_roofline", "finish_roofline", "encode_roofline"):
        assert harness.reader(name)(t) is None


def test_kernel_names():
    assert tr.kernel_base("void jt::idct8_samples_kernel<3>(ZArgs)") == (
        "idct8_samples_kernel")
    assert tr.kernel_base("finish_color_kernel(Args)") == "finish_color_kernel"
    assert tr.kernel_base("void at::native::(anonymous namespace)::f<float>(int)"
                          ) == "f"


def test_breakdown():
    b = trace().breakdown()
    names = [n for n, _ in b["device_ops"]]
    assert names[0] == "Memcpy DtoH (Device -> Pageable)"
    assert "idct8_samples_kernel" in names and "outside_kernel" not in names
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    gap, secs = b["idle_gaps"][0]
    assert secs == pytest.approx(28e-6)
    # The host was inside stream_next [0, 60] and then [60, 100] at 56 us.
    assert gap.startswith("stream_next")


def test_work_bytes_of_a_4k_frame():
    blocks = work_bytes.blocks_420(3840, 2160)
    assert blocks == 194_400
    assert work_bytes.finish_bytes(blocks, 3840 * 2160) == (
        194_400 * 128 + 3840 * 2160 * 3)
    assert work_bytes.entropy_bytes(1000, blocks) == 1000 + 194_400 * 128
    assert work_bytes.encode_bytes(3840 * 2160, 1000) == 3840 * 2160 * 3 + 1000
    assert work_bytes.blocks_420(500, 333) == 32 * 21 * 6
    assert work_bytes.roofline_pct(3.35e6, 1.0) == pytest.approx(100.0)
    assert work_bytes.roofline_pct(1, 0.0) is None


def test_every_metric_has_a_reader_and_every_reader_a_metric():
    spec = harness.load_spec()
    names = {m["name"] for m in spec["end_to_end"] + spec["per_layer"]}
    used = {harness.reader_path(n).name[:-3] for n in names}
    files = {p.name[:-3] for p in (ROOT / "benchmark" / "metrics").glob("*.py")}
    assert used <= files
    assert files - used == {"__init__", "work_bytes"}


def test_a_split_metric_shares_its_quantitys_reader():
    metrics = ROOT / "benchmark" / "metrics"
    assert harness.reader_path("copy_ms_per_image.encode") == (
        metrics / "copy_ms_per_image.py")
    assert harness.reader_path("decode_mpix_s") == metrics / "decode_mpix_s.py"
    assert read("copy_ms_per_image.encode") == read("copy_ms_per_image.decode")


def test_traffic_kinds_are_found_by_name():
    spec = harness.load_spec()
    for w in spec["workloads"]:
        _, _, traffic = harness.cell_files(spec, w["name"])
        kind = harness.kind_module(traffic["kind"])
        for fn in ("inputs_needed", "keeps_images", "warm", "run"):
            assert callable(getattr(kind, fn)), (traffic["kind"], fn)
    with pytest.raises(SystemExit, match="no_such_kind"):
        harness.kind_module("no_such_kind")


def test_end_to_end_readers():
    from lib.traffic import Run

    run = Run("stream", "decode", window_s=2.0, images=10,
              pixels=10 * 3840 * 2160)
    run.setup_s = 12.5
    assert harness.reader("decode_mpix_s")(run) == pytest.approx(
        10 * 3840 * 2160 / 2.0 / 1e6)
    assert harness.reader("encode_mpix_s")(run) is None
    assert harness.reader("setup_s")(run) == 12.5
    enc = Run("stream", "encode", window_s=4.0, images=8, pixels=8 * 1000)
    assert harness.reader("encode_mpix_s")(enc) == pytest.approx(0.002)
    assert harness.reader("decode_mpix_s")(enc) is None


def test_metrics_for_each_cell():
    spec = harness.load_spec()
    for cell in [w["name"] for w in spec["workloads"]]:
        e2e = harness.metrics_for(spec, cell, False)
        per = harness.metrics_for(spec, cell, True)
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert per and {m["moves"] for m in per} <= {m["name"] for m in e2e}
