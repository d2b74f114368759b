"""The comparison sees a broken timed path: a run driven on the CPU (past
the look for a card) with the program's answers altered where they are
produced, or with a stream that hands back its first answer every time (a
step that returns its state unchanged), comes out not correct; the sound
program comes out correct. The cells have no batch mean and no exchange
between chips, so those faults have nothing to break here."""

import types

import numpy as np
import pytest
import torch

from lib import harness

SMALL = {"width": 80, "height": 48}
MIX = {"shapes": [[50, 37, 40], [50, 33, 25], [37, 50, 15], [33, 50, 10],
                  [50, 50, 10]]}


def small_cells(frames, mix):
    """Every cell of BENCHMARK.json with the override that shrinks its
    configuration (a "frames" one to `frames`, a "mix" one to `mix`)."""
    spec = harness.load_spec()
    out = []
    for w in spec["workloads"]:
        _, config, _ = harness.cell_files(spec, w["name"])
        out.append((w["name"], frames if config["kind"] == "frames" else mix))
    return out


K2 = {"optimize_tables": True, "huffman_tables": "ITU-T T.81 Annex K.2"}
# Every cell, and a cell's configuration at another sampling with restart
# intervals, with each image's Annex K.2 tables, and as progressive streams.
CELLS = small_cells(SMALL, MIX) + [
    ("ilsvrc-decode-stream", dict(MIX, subsampling="422", restart_interval=4)),
    ("ilsvrc-decode-stream", dict(MIX, **K2)),
    ("ilsvrc-decode-stream", dict(MIX, progressive=True, **K2))]
IDS = [c + ("-progressive" if o.get("progressive") else
            "-optimized" if o.get("optimize_tables") else
            "" if "subsampling" not in o else
            f"-{o['subsampling']}-rst{o['restart_interval']}")
       for c, o in CELLS]


def altered(out):
    if isinstance(out, (bytes, bytearray)):
        b = bytearray(out)
        b[len(b) // 2] ^= 0x01  # a bit of the scan, where it is produced
        return bytes(b)
    if isinstance(out, torch.Tensor):
        out = out.clone()
        out.view(-1)[out.numel() // 2] ^= 0x80
        return out
    out = np.array(out)
    out.reshape(-1)[out.size // 2] ^= 0x80
    return out


def faulty_port(kind: str):
    import jpeg_tpu_torch as jt

    def stream_fault(fn):
        def wrapped(*a, **k):
            first = None
            for out in fn(*a, **k):
                if kind == "altered":
                    yield altered(out)
                else:
                    first = out if first is None else first
                    yield first
        return wrapped

    return types.SimpleNamespace(
        decode_stream=stream_fault(jt.decode_stream),
        encode_stream=stream_fault(jt.encode_stream))


def run(cell, override, port=None, seed=2**31 + 5):
    spec = harness.load_spec()
    return harness.run_cell(spec, cell, seed, 0.5, False, device="cpu",
                            config_override=override, port=port)


@pytest.mark.parametrize("cell,override", CELLS, ids=IDS)
def test_sound_program_is_correct(cell, override):
    r = run(cell, override)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0


@pytest.mark.parametrize("kind", ["altered", "stale"])
@pytest.mark.parametrize("cell,override", CELLS, ids=IDS)
def test_broken_path_is_not_correct(cell, override, kind):
    r = run(cell, override, faulty_port(kind))
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("key,value", [
    ("subsampling", "411"), ("restart_interval", 240),
    ("optimize_tables", True), ("progressive", True)])
def test_a_configuration_the_reference_does_not_implement_is_refused(
        key, value):
    with pytest.raises(ValueError, match=key):
        run("uhd-encode-stream", dict(SMALL, **{key: value}))
