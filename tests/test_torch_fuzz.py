"""Hostile input through jpeg_tpu_torch.decode, every entropy backend.

Garbage bytes and seeded 1-4-byte mutations of valid small streams must
either decode or raise one of JpegFormatError, ScanDecodeError (a
ValueError), ValueError or IndexError: never a KeyError or another
exception, and never a hang: each decode runs on a thread of its own and
must return within its time limit. The device Huffman decoders run their
plain twins here; their loops are bounded in the same way as the
kernels'."""

import threading

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import jpeg_tpu_torch
from jpeg_tpu_torch.io import jfif as PJ
from jpeg_tpu_torch.models.decoder import ENTROPY_BACKENDS

from torch_port_util import make_image

ALLOWED = (PJ.JpegFormatError, ValueError, IndexError)
SECONDS = 60
MUTANTS = 60


def decode_within(data: bytes, entropy: str):
    """decode() on its own thread: the array, or the exception it raised."""
    box = []

    def work():
        try:
            box.append(jpeg_tpu_torch.decode(
                data, device="cpu", entropy=entropy, max_pixels=1_000_000))
        except BaseException as e:  # reported below, whatever it is
            box.append(e)

    t = threading.Thread(target=work, daemon=True)
    t.start()
    t.join(SECONDS)
    assert not t.is_alive(), f"decode(entropy={entropy!r}) did not return"
    return box[0]


def assert_clean(out):
    if isinstance(out, BaseException):
        assert isinstance(out, ALLOWED), repr(out)
    else:
        assert out.dtype == np.uint8


@pytest.mark.parametrize("entropy", ENTROPY_BACKENDS)
@settings(max_examples=50, deadline=None, derandomize=True)
@given(data=st.binary(min_size=0, max_size=300))
def test_garbage_never_crashes_decoder(entropy, data):
    assert_clean(decode_within(b"\xff\xd8" + data, entropy))


def valid_stream(kind: str) -> bytes:
    img = make_image(40, 56, seed=9)
    if kind == "gray":
        return jpeg_tpu_torch.encode(img[..., 0], quality=80, device="cpu")
    return jpeg_tpu_torch.encode(
        img, quality=80, subsampling="420",
        restart_interval=3 if kind == "420-restart" else 0, device="cpu")


@pytest.mark.parametrize("entropy", ENTROPY_BACKENDS)
@pytest.mark.parametrize("kind", ["420", "420-restart", "gray"])
def test_mutated_streams_raise_cleanly_or_decode(kind, entropy):
    jpg = valid_stream(kind)
    rng = np.random.default_rng(len(kind) * 7)
    decoded = 0
    for _ in range(MUTANTS):
        bad = bytearray(jpg)
        for _ in range(int(rng.integers(1, 5))):
            bad[int(rng.integers(2, len(bad)))] = int(rng.integers(0, 256))
        out = decode_within(bytes(bad), entropy)
        assert_clean(out)
        decoded += not isinstance(out, BaseException)
    print(f"{decoded} of {MUTANTS} mutants decoded")


@pytest.mark.parametrize("kind", ["420", "420-restart", "gray"])
def test_mutants_of_the_scan_agree_across_backends(kind):
    """A mutation inside the entropy-coded data: the host walkers and the
    device decoders' twins either all raise or all give the same pixels,
    except where their rules differ on purpose (a ZRL that runs past
    coefficient 63 is an error to the prefix index alone)."""
    jpg = valid_stream(kind)
    scan_at = jpg.index(b"\xff\xda") + 14
    rng = np.random.default_rng(31)
    agree = 0
    for _ in range(24):
        bad = bytearray(jpg)
        i = int(rng.integers(scan_at, len(bad) - 2))
        bad[i] = (bad[i] ^ int(rng.integers(1, 255))) & 0xFE  # no new marker
        outs = [decode_within(bytes(bad), e)
                for e in ("sparse", "indexed", "device")]
        for o in outs:
            assert_clean(o)
        kinds = {isinstance(o, BaseException) for o in outs}
        if kinds == {False}:
            np.testing.assert_array_equal(outs[0], outs[1])
            np.testing.assert_array_equal(outs[0], outs[2])
        agree += len(kinds) == 1
    assert agree >= 20, f"only {agree} of 24 mutants got one verdict"
