"""The traced stretch: torch.profiler (CPU and CUDA activity) around a bounded
part of a run, read back from its Chrome trace into device operations and
the benchmark's own spans, and the arithmetic the per-layer readers share.

Spans are torch.profiler.record_function ranges (user annotations) that a
traffic kind puts around its calls into the program, such as stream_next,
or that the program puts around its own stages; they share the device
events' clock. Times are in microseconds, as the trace has them.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile

# The stretch the per-layer metrics read.
WINDOW = "bench_window"

_DEVICE_CATS = {"kernel": "kernel", "gpu_memcpy": "memcpy",
                "memcpy": "memcpy", "gpu_memset": "memset",
                "memset": "memset"}


@contextlib.contextmanager
def profiled(out: dict):
    """Profile the block, every thread of the process (the program decodes
    and stages on threads of its own); on exit put the trace's events in
    out["events"] (a list of dicts with cat, name, ts, dur, tid)."""
    import torch
    from torch._C._profiler import _ExperimentalConfig

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(
            activities=acts,
            experimental_config=_ExperimentalConfig(profile_all_threads=True)
    ) as prof:
        yield
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            raw = json.load(f)
    finally:
        os.unlink(path)
    out["events"] = [
        {"cat": str(e.get("cat", "")), "name": str(e.get("name", "")),
         "ts": float(e["ts"]), "dur": float(e.get("dur", 0.0)),
         "tid": e.get("tid")}
        for e in raw.get("traceEvents", [])
        if e.get("ph") == "X" and "ts" in e]


def merge(intervals) -> list:
    """Sorted, disjoint union of (start, end) intervals."""
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals, lo: float, hi: float) -> list:
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if min(b, hi) > max(a, lo)]


def kernel_base(name: str) -> str:
    """A kernel's function name without return type, namespace or
    arguments ("void jt::idct8_samples_kernel<3>(ZArgs)" ->
    "idct8_samples_kernel")."""
    s = name.replace("(anonymous namespace)", "anon")
    while True:
        inner = re.sub(r"<[^<>]*>", "", s)
        if inner == s:
            break
        s = inner
    head = s.split("(", 1)[0].strip().split(" ")[-1].split("::")[-1]
    return head or name


class Trace:
    """One traced stretch: the device operations inside the WINDOW span,
    the spans in it, and the work of the images completed in it."""

    def __init__(self, events, images: int, work: dict):
        self.images = images
        self.work = work  # totals over the stretch: pixels, blocks, scan_bytes
        win = [e for e in events if e["name"] == WINDOW
               and e["cat"].lower() == "user_annotation"]
        if not win:
            raise ValueError("the trace has no bench_window span")
        w = max(win, key=lambda e: e["dur"])
        self.lo, self.hi = w["ts"], w["ts"] + w["dur"]
        self.device = []
        for e in events:
            kind = _DEVICE_CATS.get(e["cat"].lower())
            if kind is None:
                continue
            iv = clip([(e["ts"], e["ts"] + e["dur"])], self.lo, self.hi)
            if iv:
                self.device.append(dict(e, kind=kind, ts=iv[0][0],
                                        dur=iv[0][1] - iv[0][0]))
        self.spans = [(e["name"], e["ts"], e["ts"] + e["dur"])
                      for e in events if e["name"] != WINDOW
                      and e["cat"].lower() == "user_annotation"
                      and e["ts"] < self.hi and e["ts"] + e["dur"] > self.lo]
        self.host_ops = [e for e in events if e["cat"].lower() in (
            "cpu_op", "cuda_runtime") and e["ts"] < self.hi
            and e["ts"] + e["dur"] > self.lo]

    @property
    def window_us(self) -> float:
        return self.hi - self.lo

    def busy(self, lo=None, hi=None) -> list:
        """Merged intervals in which some operation ran on the device."""
        lo = self.lo if lo is None else lo
        hi = self.hi if hi is None else hi
        return clip(merge((e["ts"], e["ts"] + e["dur"]) for e in self.device),
                    lo, hi)

    def busy_us(self) -> float:
        return sum(b - a for a, b in self.busy())

    def idle_share(self, spans=None) -> float | None:
        """Idle share of the window, or of the union of the named spans."""
        if spans is None:
            ranges = [(self.lo, self.hi)]
        else:
            ranges = clip(merge((a, b) for n, a, b in self.spans if n in spans),
                          self.lo, self.hi)
        total = sum(b - a for a, b in ranges)
        if total <= 0:
            return None
        busy = sum(sum(y - x for x, y in self.busy(a, b)) for a, b in ranges)
        return 1.0 - busy / total

    def ops(self, kinds=None) -> list:
        return [e for e in self.device if kinds is None or e["kind"] in kinds]

    def kernel_us(self, names) -> float:
        """Summed time of the kernels whose function name is in `names`."""
        names = set(names)
        return sum(e["dur"] for e in self.ops(("kernel",))
                   if kernel_base(e["name"]) in names)

    def gaps(self) -> list:
        """[(start, end)] of the device's idle stretches in the window."""
        out, t = [], self.lo
        for a, b in self.busy():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.hi > t:
            out.append((t, self.hi))
        return out

    def host_at(self, t: float) -> str:
        """What the host was doing at time t: the innermost span, then the
        innermost host operation of any thread that covers t."""
        span = [s for s in self.spans if s[1] <= t < s[2]]
        name = min(span, key=lambda s: s[2] - s[1])[0] if span else "harness"
        ops = [e for e in self.host_ops if e["ts"] <= t < e["ts"] + e["dur"]]
        if ops:
            op = min(ops, key=lambda e: e["dur"])["name"]
            name += " > " + op
        return name

    def breakdown(self) -> dict:
        """The ten device operations that took most time (summed by name)
        and the ten longest idle gaps, named by the host's activity at their
        middle, in seconds."""
        by: dict = {}
        for e in self.device:
            key = kernel_base(e["name"]) if e["kind"] == "kernel" else e["name"]
            by[key] = by.get(key, 0.0) + e["dur"]
        top = sorted(by.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:10]
        return {"device_ops": [[k, v * 1e-6] for k, v in top],
                "idle_gaps": [[self.host_at((a + b) / 2), (b - a) * 1e-6]
                              for a, b in gaps]}
