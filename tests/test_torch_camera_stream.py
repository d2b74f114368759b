"""The port against the benchmark's plain reference (benchmark/lib/plainjpeg.py,
loaded by its path, so no jax comes in through it) on RFC 2435 type-64
camera streams: 4:2:2 scans with restart markers every 1, 7 or one row of
MCUs, at 130x70, 250x187 and a 1920x16 strip (two MCU rows at a 1080p
camera's width), seeded, on the CPU.

- decode() of the plain encoder's streams lies inside the reference's
  pixel_bounds, on the host walk ("auto" here) and on the device route's
  twins ("device": the restart split, the anchored walk, kernel D's twin);
- decode_stream() over these streams mixed with unrestarted 4:2:0 ones gives
  each stream's decode() exactly;
- encode(subsampling="422", restart_interval=r) writes the reference's scan
  byte for byte;
- the bounds are tight: the reference with TF32 operands, one precision
  below the float32 that the configuration states, falls outside them;
- entropy_decode.RESTART_SEGMENTS counts the segments that decode_segments
  walked, and program F adds none;
- on a card (marked `cuda`), decode_stream at depth 1, 2 and 4 gives the CPU
  twins' arrays, each scan's chain enqueued by one native call
  (entropy_decode.NATIVE_SCANS)."""

import functools

import numpy as np
import pytest
import torch

import jpeg_tpu_torch
from jpeg_tpu_torch.ops import entropy_decode as ED

from torch_port_util import (
    make_image, outside_bounds, plain_streams, plainjpeg, prefix_inputs,
    require_cuda, segment_inputs)

SIZES = [(130, 70), (250, 187), (1920, 16)]  # width, height
RESTARTS = [1, 7, "row"]
CASES = [(s, r) for s in SIZES for r in RESTARTS]
IDS = [f"{w}x{h}-rst{r}" for (w, h), r in CASES]
SIZE_IDS = [f"{w}x{h}" for w, h in SIZES]


def interval(size, restart, subsampling="422") -> int:
    """A restart interval in MCUs; "row" is one MCU row."""
    if restart == "row":
        return -(-size[0] // (8 * plainjpeg().SAMPLING[subsampling][0]))
    return restart


@functools.cache
def camera(size, restart, subsampling="422"):
    """(image, interval, stream, coefficients) of one seeded frame."""
    w, h = size
    r = interval(size, restart, subsampling) if restart else 0
    img = make_image(h, w, seed=w * h + r)
    (data,), (coefs,) = plain_streams([img], subsampling, r)
    return img, r, data, coefs


def segments(size, r, subsampling="422") -> int:
    h, v = plainjpeg().SAMPLING[subsampling]
    n_mcu = -(-size[0] // (8 * h)) * -(-size[1] // (8 * v))
    return -(-n_mcu // r)


@pytest.mark.parametrize("entropy", ["auto", "device"])
@pytest.mark.parametrize("size,restart", CASES, ids=IDS)
def test_decode_lies_inside_the_reference_bounds(size, restart, entropy):
    _, _, data, coefs = camera(size, restart)
    out = jpeg_tpu_torch.decode(data, device="cpu", entropy=entropy)
    assert outside_bounds(out, coefs, size[1], size[0], "422") == 0


@pytest.mark.parametrize("device_output", [False, True])
@pytest.mark.parametrize("entropy", ["auto", "device"])
def test_decode_stream_equals_each_streams_decode(entropy, device_output):
    datas = [camera(s, r, sub)[2] for s in SIZES
             for r, sub in [(0, "420")] + [(r, "422") for r in RESTARTS]]
    got = list(jpeg_tpu_torch.decode_stream(
        iter(datas), depth=2, entropy=entropy, device_output=device_output,
        device="cpu"))
    assert len(got) == len(datas)
    for out, data in zip(got, datas):
        assert isinstance(out, torch.Tensor) == device_output
        np.testing.assert_array_equal(np.asarray(out), jpeg_tpu_torch.decode(
            data, device="cpu", entropy=entropy))


@pytest.mark.parametrize("size,restart", CASES, ids=IDS)
def test_encode_writes_the_reference_scan(size, restart):
    img, r, data, _ = camera(size, restart)
    P = plainjpeg()
    port = P.parse(jpeg_tpu_torch.encode(
        img, quality=75, subsampling="422", restart_interval=r, device="cpu"))
    ref = P.parse(data)
    assert port["restart"] == ref["restart"] == r
    for key in ("components", "qtables", "htables", "scan"):
        assert port[key] == ref[key], key


def test_the_tf32_control_leaves_the_bounds():
    """The reference's own float64 decode lies inside the bounds of every
    stream; its TF32 control lies outside them on at least one."""
    P = plainjpeg()
    control = []
    for size, restart in CASES:
        _, _, _, coefs = camera(size, restart)
        w, h = size
        exact = P.pixels(coefs, 75, h, w, "float64", "422")
        assert outside_bounds(exact, coefs, h, w, "422") == 0
        tf32 = P.pixels(coefs, 75, h, w, "tf32", "422")
        control.append(outside_bounds(tf32, coefs, h, w, "422"))
    assert max(control) > 0, control


@pytest.mark.parametrize("size,restart", CASES, ids=IDS)
def test_restart_segments_counts_the_segments_walked(size, restart):
    _, r, data, _ = camera(size, restart)
    want = segments(size, r)
    inputs, bits = segment_inputs(data)
    assert len(bits) == want
    before = ED.RESTART_SEGMENTS
    ED.decode_segments(*inputs)
    assert ED.RESTART_SEGMENTS - before == want
    jpeg_tpu_torch.decode(data, device="cpu", entropy="device")
    assert ED.RESTART_SEGMENTS - before == 2 * want


@pytest.mark.parametrize("size", SIZES, ids=SIZE_IDS)
def test_program_f_adds_no_restart_segment(size):
    _, _, data, _ = camera(size, 0, "420")
    before = ED.RESTART_SEGMENTS
    f_in, _ = prefix_inputs(data)
    ED.prefix_index(*f_in)
    jpeg_tpu_torch.decode(data, device="cpu", entropy="device")
    assert ED.RESTART_SEGMENTS == before


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_decode_stream_on_the_card_equals_the_twins(depth):
    dev = require_cuda()
    datas = [camera(s, r, sub)[2] for s in SIZES
             for r, sub in [(0, "420")] + [(r, "422") for r in RESTARTS]]
    want = [jpeg_tpu_torch.decode(d, device="cpu", entropy="device")
            for d in datas]
    before = ED.NATIVE_SCANS
    got = list(jpeg_tpu_torch.decode_stream(iter(datas), depth=depth,
                                            device=dev))
    assert ED.NATIVE_SCANS - before == len(datas)
    for out, w in zip(got, want):
        np.testing.assert_array_equal(out, w)
