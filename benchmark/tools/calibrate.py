"""Readings from which the limits of `correct` are set: for each seed one
run of a cell (its inputs, warm-up and a short window at the cell's own
load and sizes) compared with the plain reference, and on the same inputs
the control: the reference put in the program's place in the precision
below the stated one (decode: the IDCT and colour map with TF32 operands;
encode: the transform in float32 instead of exact integers).

    python3 benchmark/tools/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds 2 --json calib.json [--override '{"progressive": true}']

Runs on the card only, in one process for all seeds. --override replaces
keys of the cell's configuration, as a configuration file would state them.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(BENCH.parent))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--json", default="")
    ap.add_argument("--override", default="{}")
    args = ap.parse_args()
    import torch

    from lib import harness

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    spec = harness.load_spec()
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        r = harness.run_cell(spec, args.workload, seed, args.seconds, False,
                             config_override=json.loads(args.override),
                             control=True)
        info = r["_info"]
        row = {"seed": seed, "correct": r["correct"],
               "inputs_s": info["inputs_s"],
               "program": {k: v["value"] for k, v in r["checks"].items()},
               "control": info["control"], "kept": info["kept"],
               "images": info["images"], "error": info["error"],
               "metrics": {k: v["value"] for k, v in r["metrics"].items()}}
        rows.append(row)
        print(json.dumps(row), file=sys.stderr, flush=True)
    if args.json:
        pathlib.Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.json).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
