"""Run one cell of the benchmark of jpeg_tpu_torch once.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up (inputs made on the card from the seed,
the program's kernels built into jpeg_tpu_torch/build/ on a checkout's first
run, a warm-up of every shape the cell uses), then the measured window (or,
with --trace 1, a bounded stretch under torch.profiler), then the comparison
with the plain reference. The last line of standard output is one JSON
object: correct, attempted, failed, metrics, device (and breakdown when
traced), and last the numbers compared with their limits; standard error
ends with the same numbers. Exits non-zero, printing no result, without
enough CUDA cards, outside a checkout that holds the program, or when jax,
jaxlib, flax or jpeg_tpu is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(BENCH.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from lib import harness

    spec = harness.load_spec()
    cell, _, _ = harness.cell_files(spec, args.workload)
    import torch

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell["chips"]):
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    with contextlib.redirect_stdout(sys.stderr):
        result = harness.run_cell(spec, args.workload, args.seed,
                                  args.seconds, bool(args.trace))
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"forbidden modules loaded: {loaded}", file=sys.stderr)
        return 3
    info = result.pop("_info")
    print(json.dumps({"info": info}), file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
