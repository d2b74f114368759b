"""General per-component sampling factors through jpeg_tpu_torch.decode.

The six layouts of tests/test_sampling_general.py (4:4:0, 4:2:2, 4:1:1, two
mixed-chroma layouts, a horizontal factor of 3; up to 10 blocks per MCU),
hand-crafted by that file's _craft_stream, with and without restart
markers, through every entropy backend of the port: the pixels must equal the
NumPy walker's exactly (tolerance 0), and the reference's within the port's
stated decode tolerance (at most 1 level in at most 0.5% of samples). The MCU
sequences here are long and uneven, which is what the device decoders' layout
tables must carry as data."""

import numpy as np
import pytest

import jpeg_tpu

import jpeg_tpu_torch
from jpeg_tpu_torch.entropy import decode_device as PD, native

from test_sampling_general import LAYOUTS, _craft_stream
from torch_port_util import scan_args

BACKENDS = ("auto", "native", "sparse", "indexed", "device")
_streams: dict = {}


def crafted(comps_hv, restart):
    key = (tuple(comps_hv), restart)
    if key not in _streams:
        rng = np.random.default_rng(len(_streams) + 40)
        _streams[key] = _craft_stream(rng, comps_hv, h=41, w=59,
                                      restart=restart)
    return _streams[key]


@pytest.mark.parametrize("entropy", BACKENDS)
@pytest.mark.parametrize("restart", [0, 3])
@pytest.mark.parametrize("comps_hv", LAYOUTS)
def test_general_sampling_backends_equal_numpy(comps_hv, restart, entropy):
    jpg = crafted(comps_hv, restart)
    want = jpeg_tpu_torch.decode(jpg, device="cpu", entropy="numpy")
    assert want.shape == (41, 59, 3)
    np.testing.assert_array_equal(
        jpeg_tpu_torch.decode(jpg, device="cpu", entropy=entropy), want)


@pytest.mark.parametrize("restart", [0, 3])
@pytest.mark.parametrize("comps_hv", LAYOUTS)
def test_general_sampling_close_to_the_reference(comps_hv, restart):
    jpg = crafted(comps_hv, restart)
    got = jpeg_tpu_torch.decode(jpg, device="cpu", entropy="device")
    ref = jpeg_tpu.decode(jpg, use_pallas=True, entropy="native")
    assert got.shape == ref.shape
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert diff.max(initial=0) <= 1
    assert int((diff != 0).sum()) <= 0.005 * diff.size


@pytest.mark.parametrize("restart", [0, 3])
@pytest.mark.parametrize("comps_hv", LAYOUTS)
def test_general_sampling_coefficients_equal_native(comps_hv, restart):
    args = scan_args(crafted(comps_hv, restart))
    want = native.decode_scan(*args)
    for fn in (PD.decode_scan, PD.decode_scan_indexed):
        got = fn(*args, device="cpu")
        assert len(got) == 3
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
