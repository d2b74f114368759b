"""The control: the plain reference put in the program's place, in the
precision below the one the configuration states (decode: the IDCT and
colour map with TF32 operands instead of float32; encode: the transform in
float32 instead of exact integers), must come out not correct, where the
program comes out correct. On the CPU at small sizes here, also at 4:2:2
and 4:4:4 and with restart intervals; the cuda-marked case repeats it on
the card at the cells' own sizes."""

import pytest
import torch

from lib import harness
from test_bench_faults import small_cells

SMALL = {"width": 256, "height": 160}
MIX = {"shapes": [[250, 187, 40], [250, 166, 25], [187, 250, 15],
                  [166, 250, 10], [250, 250, 10]]}
# The cells' configurations at other samplings and with restart intervals
# (16 MCUs: one MCU row of the 250-pixel widths at 4:2:2), and as
# progressive streams.
FORMS = [("ilsvrc-decode-stream", dict(MIX, subsampling="422",
                                       restart_interval=16)),
         ("ilsvrc-decode-stream", dict(MIX, subsampling="444",
                                       restart_interval=7)),
         ("uhd-encode-stream", dict(SMALL, subsampling="444")),
         ("uhd-encode-stream", dict(SMALL, subsampling="422")),
         ("ilsvrc-decode-stream", dict(
             MIX, progressive=True, optimize_tables=True,
             huffman_tables="ITU-T T.81 Annex K.2"))]


def readings(cell, seed, device, override=None, seconds=0.5):
    spec = harness.load_spec()
    _, _, traffic = harness.cell_files(spec, cell)
    r = harness.run_cell(spec, cell, seed, seconds, False, device=device,
                         config_override=override, control=True)
    return r, r["_info"]["control"], traffic["limits"]


@pytest.mark.parametrize("seed", [3, 2**31 + 17, 99991])
@pytest.mark.parametrize("cell,override", small_cells(SMALL, MIX) + FORMS)
def test_control_fails_where_the_program_passes(cell, override, seed):
    r, control, limits = readings(cell, seed, "cpu", override)
    assert r["correct"], r["checks"]
    assert any(v > limits[k] for k, v in control.items()), control


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c for c, _ in small_cells(SMALL, MIX)])
def test_control_fails_at_the_cells_size_on_the_card(card, cell):
    for seed in (5, 6, 7):
        r, control, limits = readings(cell, seed, card, seconds=2.0)
        assert r["correct"], r["checks"]
        assert any(v > limits[k] for k, v in control.items()), control
