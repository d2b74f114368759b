"""What the benchmark loads: no module of a run imports jax or the JAX
package (compared by whole top-level name: the port's name starts with the
JAX package's), and the plain reference imports nothing of the port."""

import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "jpeg_tpu"}
REFERENCE = ["lib/plainjpeg.py", "lib/plainprogressive.py", "lib/check.py",
             "lib/inputs.py", "metrics/work_bytes.py"]


def top_level_imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def run_sources():
    return sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def test_no_source_of_a_run_imports_jax_or_the_jax_package():
    for path in run_sources():
        assert not top_level_imports(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_port():
    for rel in REFERENCE:
        names = top_level_imports(BENCH / rel)
        assert "jpeg_tpu_torch" not in names and not names & FORBIDDEN, rel


def test_whole_name_comparison():
    from lib import harness

    saved = dict(sys.modules)
    try:
        sys.modules["jpeg_tpu_torch_fake"] = object()
        sys.modules["jpeg_tpu_torch.sub"] = object()
        assert "jpeg_tpu" not in harness.forbidden_modules()
        sys.modules["jpeg_tpu.x"] = object()
        assert "jpeg_tpu" in harness.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_run_loads_no_jax_module():
    """Import everything a run imports, the port included, every metric
    reader and every traffic kind, in a fresh interpreter; then look at
    sys.modules."""
    code = (
        "import sys, json; sys.path[:0] = [%r, %r]\n"
        "from lib import harness, traffic, check, inputs, plainjpeg, trace\n"
        "import jpeg_tpu_torch, jpeg_tpu_torch.parallel\n"
        "spec = harness.load_spec()\n"
        "for m in spec['end_to_end'] + spec['per_layer']:\n"
        "    harness.reader(m['name'])\n"
        "for w in spec['workloads']:\n"
        "    harness.kind_module(harness.cell_files(spec, w['name'])[2]['kind'])\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    ) % (str(BENCH), str(ROOT))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_no_card_no_result(tmp_path):
    """Without a card (this machine) a run exits non-zero and prints no
    result on standard output."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "uhd-encode-stream", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
