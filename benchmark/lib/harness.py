"""One run of one cell, found by name: BENCHMARK.json names the cell, its
configuration file and its metrics; the harness reads

- benchmark/configs/<config>.json (sizes, content, quality, the limits of
  nothing: a configuration states what is made),
- benchmark/traffic/<cell>.json (kind, the entry's arguments, distinct
  inputs, traced stretch, answer sampling and the limits of `correct`),
- benchmark/traffic/kinds/<kind>.py, the code of each kind of traffic
  (lib/traffic says what such a module provides),
- benchmark/metrics/<metric>.py, one reader per metric: read(run) for an
  end-to-end metric, read(trace) for a per-layer one, returning None where
  it finds nothing to read. A metric split by the end-to-end metric it
  moves, <quantity>.<part>, may share the reader <quantity>.py.

A cell, a configuration or a metric is added by adding such files and
entries; no file here names one.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import pathlib
import sys
import time

from lib import check, inputs, trace as tr, traffic as tf

BENCH = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
# Modules that no run may hold once its window has closed (whole top-level
# names: the port's own name starts with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "jpeg_tpu")


def load_spec(root=ROOT) -> dict:
    return json.loads((pathlib.Path(root) / "BENCHMARK.json").read_text())


def cell_files(spec: dict, name: str, root=ROOT) -> tuple[dict, dict, dict]:
    """(workload entry, configuration, traffic) of the cell `name`."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = json.loads((pathlib.Path(root) / cfg_entry["file"]).read_text())
    traffic = json.loads((pathlib.Path(root) / "benchmark" / "traffic"
                          / f"{cell['traffic']}.json").read_text())
    return cell, config, traffic


def metrics_for(spec: dict, cell: str, traced: bool) -> list:
    """The metric entries a run of `cell` reports: its end-to-end metrics,
    or in a traced run its per-layer ones (those that list the cell, or
    without a list those whose end-to-end metric the cell reports)."""
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    out = []
    for m in spec["per_layer"]:
        listed = m.get("workloads")
        if (cell in listed) if listed is not None else (m["moves"] in names):
            out.append(m)
    return out


def _load(path: pathlib.Path, prefix: str):
    mod_name = prefix + path.stem.replace(".", "_").replace("-", "_")
    mod_spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def reader_path(name: str, bench=BENCH) -> pathlib.Path:
    """metrics/<name>.py, or for <quantity>.<part> without a file of its
    own, metrics/<quantity>.py."""
    path = pathlib.Path(bench) / "metrics" / f"{name}.py"
    if not path.exists():
        path = path.with_name(f"{name.split('.')[0]}.py")
    return path


def reader(name: str, bench=BENCH):
    return _load(reader_path(name, bench), "bench_metric_").read


def kind_module(name: str, bench=BENCH):
    """The code of the traffic kind `name`: traffic/kinds/<name>.py."""
    path = pathlib.Path(bench) / "traffic" / "kinds" / f"{name}.py"
    if not path.exists():
        raise SystemExit(f"unknown traffic kind {name!r}: no {path}")
    return _load(path, "bench_kind_")


def process_age() -> float:
    """Seconds since this process started (from /proc; the kernel's clock
    ticks since boot)."""
    import os

    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as f:
        return float(f.read().split()[0]) - start


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_info(device) -> dict:
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": dev.type, "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
             "-i", str(dev.index or 0)], capture_output=True, text=True,
            timeout=20)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        pass
    return info


def spread(run) -> dict:
    """How the window's work was spread: answers in each second of the
    window, for standard error."""
    import numpy as np

    if not run.done_at:
        return {}
    edges = np.arange(0.0, max(run.done_at) + 1.0)
    return {"per_s": np.histogram(run.done_at, edges)[0].tolist()}


def run_cell(spec: dict, name: str, seed: int, seconds: float, traced: bool,
             device="cuda", config_override: dict | None = None,
             port=None, control: bool = False) -> dict:
    """Everything of a run after the look for a card: inputs, warm-up,
    window (or traced stretch), the comparison and the metrics. Returns the
    result line's object (without the forbidden-module check) and, under
    "_info", what the run did; with `control`, also the control's numbers
    on the same inputs (tools/calibrate.py)."""
    import torch

    if port is None:
        import jpeg_tpu_torch as port
    _, config, traffic = cell_files(spec, name)
    config = dict(config, **(config_override or {}))
    kind = kind_module(traffic["kind"])
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    n_frames, n_streams = kind.inputs_needed(traffic)
    t_in = process_age()
    inp = inputs.build(config, n_frames, n_streams, seed, device)
    t_in = (t_in, process_age())
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    marks: list = []

    def mark():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        marks.append(process_age())

    raw: dict = {}
    run = tf.drive(kind, port, inp, traffic, config, device, seconds, seed,
                   traced, raw, mark)
    run.setup_s = marks[0] if marks else 0.0
    dev = device_info(device)
    if not marks:
        run.error = run.error or "the warm-up failed"

    metrics: dict = {}
    breakdown = None
    source = None if traced else run
    if traced and "events" in raw:
        t = tr.Trace(raw["events"], run.images, {
            "pixels": run.pixels, "blocks": run.blocks,
            "scan_bytes": run.scan_bytes})
        dev["busy_s"] = t.busy_us() * 1e-6
        dev["window_s"] = t.window_us * 1e-6
        breakdown = t.breakdown()
        source = t
    for m in metrics_for(spec, name, traced) if source is not None else ():
        value = reader(m["name"])(source)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    kept = run.kept
    run.kept = []
    gc.collect()
    t0 = time.perf_counter()
    numbers = check.compare(kept, inp, config, device) if not run.failed else {}
    ok, shown = check.judge(numbers, traffic["limits"])
    ok = ok and not run.failed and bool(marks)
    result = {"correct": ok, "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = shown
    result["_info"] = {"error": run.error, "window_s": run.window_s,
                       "images": run.images, "kept": len(kept),
                       "inputs_at_s": t_in[0], "inputs_s": t_in[1] - t_in[0],
                       "reference_s": time.perf_counter() - t0}
    result["_info"]["spread"] = spread(run)
    if control:  # the control's readings on the same answers' inputs
        result["_info"]["control"] = check.compare(kept, inp, config, device,
                                                   control=True)
    return result
