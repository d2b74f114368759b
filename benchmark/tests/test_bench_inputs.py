"""The benchmark's inputs and its plain codec, on the CPU at small sizes."""

import hashlib
import json
import pathlib

import numpy as np
import pytest
import torch

from lib import check, inputs, plainjpeg as P
from metrics import work_bytes

CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "configs"

SMALL = {"kind": "frames", "width": 72, "height": 40, "quality": 75,
         "noise": 10, "roll": 97, "subsampling": "420"}
MIX = {"kind": "mix", "quality": 90, "noise": 10, "subsampling": "420",
       "shapes": [[50, 37, 40], [50, 33, 25], [37, 50, 15], [33, 50, 10],
                  [50, 50, 10]]}
BIG_SEED = 2**31 + 977


@pytest.mark.parametrize("config", [SMALL, MIX], ids=["frames", "mix"])
def test_same_seed_same_inputs_other_seed_other_inputs(config):
    a = inputs.build(config, 6, 6, BIG_SEED, "cpu")
    b = inputs.build(config, 6, 6, BIG_SEED, "cpu")
    c = inputs.build(config, 6, 6, BIG_SEED + 1, "cpu")
    assert a.streams == b.streams
    assert all(np.array_equal(x, y) for x, y in zip(a.frames, b.frames))
    assert a.streams != c.streams
    assert not all(np.array_equal(x, y) for x, y in zip(a.frames, c.frames)
                   if x.shape == y.shape)


def test_frames_are_the_image_rolled():
    inp = inputs.build(SMALL, 3, 0, 5, "cpu")
    for k in range(3):
        assert np.array_equal(inp.frames[k], np.roll(inp.frames[0], k * 97, axis=1))
    assert inp.streams == []


def test_ilsvrc_shape_mix():
    shapes = [[500, 375, 40], [500, 333, 25], [375, 500, 15], [333, 500, 10],
              [500, 500, 10]]
    assert inputs.shape_counts(shapes, 256) == [
        (500, 375, 102), (500, 333, 64), (375, 500, 38), (333, 500, 26),
        (500, 500, 26)]
    cfg = {"kind": "mix", "shapes": shapes}
    one = inputs.image_shapes(cfg, 256, 1)
    two = inputs.image_shapes(cfg, 256, 2)
    assert sorted(one) == sorted(two)  # the same work on every seed
    assert one != two  # in another order
    mean_w = np.mean([w for w, _ in one])
    mean_h = np.mean([h for _, h in one])
    assert 440 < mean_w < 480 and 390 < mean_h < 420


def test_gradient_and_noise():
    g = inputs.generator(3, "cpu")
    img = inputs.make_image(40, 60, 10, g, "cpu").numpy().astype(int)
    yy, xx = np.mgrid[0:40, 0:60]
    grad = np.stack([xx * 255 / 60, yy * 255 / 40, (xx + yy) * 128 / 100], -1)
    noise = img - grad.astype(int)
    inner = (grad > 12) & (grad < 240)
    assert np.abs(noise[inner]).max() <= 11  # truncation adds < 1


@pytest.mark.parametrize("config", [SMALL, MIX], ids=["frames", "mix"])
def test_plain_streams_decode_with_the_plain_reference(config):
    inp = inputs.build(config, 5, 5, 11, "cpu")
    q = config["quality"]
    for frame, data, nbytes in zip(inp.frames, inp.streams, inp.scan_bytes):
        info, coefs = P.decode_coefficients(data)
        assert (info["width"], info["height"]) == (frame.shape[1], frame.shape[0])
        assert len(info["scan"]) == nbytes
        want = P.coefficients(torch.as_tensor(frame)[None], q)[0].numpy()
        assert np.array_equal(coefs, want)
        px = P.pixels(torch.as_tensor(coefs), q, *frame.shape[:2]).numpy()
        # A q75/q90 round trip keeps the gradient and smooths the +-10 noise.
        assert np.abs(px.astype(int) - frame).mean() < 8


@pytest.mark.parametrize("config", [SMALL, MIX], ids=["frames", "mix"])
def test_reference_decode_agrees_with_the_port_on_the_cpu(config):
    """The port's CPU decode (its kernels' plain twins) of the plain
    streams lands on the reference's pixels but for rounding ties."""
    jt = pytest.importorskip("jpeg_tpu_torch")
    inp = inputs.build(config, 5, 5, 12, "cpu")
    q = config["quality"]
    for frame, data in zip(inp.frames, inp.streams):
        ref = P.pixels(P.coefficients(torch.as_tensor(frame)[None], q)[0], q,
                       *frame.shape[:2]).numpy()
        out = jt.decode(data, device="cpu")
        assert out.shape == ref.shape
        assert np.count_nonzero(out != ref) <= 0.005 * ref.size


def test_zigzag_and_tables_match_the_standard():
    assert P.ZIGZAG[:10].tolist() == [0, 1, 8, 16, 9, 2, 3, 10, 17, 24]
    assert P.ZIGZAG[-3:].tolist() == [55, 62, 63]
    assert sorted(P.ZIGZAG.tolist()) == list(range(64))
    code, length = P.huffman_codes(P.DC_LUMA)
    assert (code[0], length[0]) == (0b00, 2)
    assert (code[11], length[11]) == (0b111111110, 9)
    code, length = P.huffman_codes(P.AC_LUMA)
    assert (code[0x00], length[0x00]) == (0b1010, 4)  # EOB
    assert (code[0xF0], length[0xF0]) == (0b11111111001, 11)  # ZRL
    assert P.quality_table(P.QUANT_LUMA, 50).tolist() == P.QUANT_LUMA.tolist()
    assert P.quality_table(P.QUANT_LUMA, 100).max() == 1


@pytest.mark.parametrize("shape", [(48, 64), (33, 50), (37, 129), (16, 16)])
@pytest.mark.parametrize("quality", [75, 90])
def test_plain_encoder_equals_the_port_on_the_cpu(shape, quality):
    """The reference's encode is the port's stated transform: its scans
    equal jpeg_tpu_torch.encode's on the CPU, byte for byte."""
    jt = pytest.importorskip("jpeg_tpu_torch")
    g = inputs.generator(sum(shape) + quality, "cpu")
    img = inputs.make_image(*shape, 10, g, "cpu")
    ours = P.parse(P.encode(img[None], quality)[0])
    port = P.parse(jt.encode(img.numpy(), quality=quality, subsampling="420",
                             device="cpu"))
    assert ours["scan"] == port["scan"]
    assert ours["qtables"] == port["qtables"]
    assert ours["htables"] == port["htables"]


def test_scans_of_a_batch_equal_one_by_one():
    g = inputs.generator(4, "cpu")
    imgs = torch.stack([inputs.make_image(32, 48, 10, g, "cpu") for _ in range(3)])
    coefs = P.coefficients(imgs, 75)
    together = P.scans(coefs)
    alone = [P.scans(coefs[i:i + 1])[0] for i in range(3)]
    assert together == alone


def _sha(*parts) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(p if isinstance(p, bytes) else np.ascontiguousarray(p).tobytes())
    return h.hexdigest()


# SHA-256 of what the benchmark made of each configuration before the plain
# codec took other samplings and restart intervals: the streams of the first
# 4 images (build(config, 0, 4, seed)) at seeds 0 and 1, their block and
# scan-byte counts, and for image 0 of seed 0 the reference bounds, the
# control's decode and the reference and control encodes. uhd-q75-420 runs
# at a stated crop, 3840x72 (its 4K frames are too slow for a test; 72 rows
# leave a part MCU row); ilsvrc-q90-420 at its own shapes.
IDENTITY = {
    "uhd-q75-420": ({"height": 72}, {
        "streams/0": "d2f8a2f39abb6db06a42e0cfcd1147c6719626b72d307b3be02d9311064112bc",
        "blocks/0": [7200, 7200, 7200, 7200],
        "scan_bytes/0": [31243, 31409, 31322, 31332],
        "streams/1": "55da76f5265857e42ae5abf64823cf975c291436db6d4f2676c084659f57cd3e",
        "blocks/1": [7200, 7200, 7200, 7200],
        "scan_bytes/1": [31340, 31518, 31480, 31562],
        "bounds": "627940f9c543335bb1cd97d2feec05c45dabbbf2aab06ccc0e4ca0bf08fe53a8",
        "control": "26f298e1bc291763e3c2801cfa2e8169758ff189179fc166c9937cb3f88f9ea0",
        "stream": "59e2e51d7ea392f5b1b9fa4e5ee32e4eef8b3ceb447b8bdc0615acc9240cc5cf",
        "stream_f32": "d5c540b83cebaa834f2b8028dd11551fd0b2f3aea4fe6cde2eab4694c99040af",
    }),
    "ilsvrc-q90-420": ({}, {
        "streams/0": "915477884c0a39fba565e8e1ecba40c4505dc8eba5d841d565c7be3e294ef81b",
        "blocks/0": [4032, 4608, 4608, 4608],
        "scan_bytes/0": [37092, 41784, 41842, 41676],
        "streams/1": "aaff9bc9a4f91a2b47f245887cf8574f3bfeab4333c64f040fe671e1597cbebb",
        "blocks/1": [4608, 4608, 4032, 4608],
        "scan_bytes/1": [41890, 41953, 37074, 41578],
        "bounds": "c07582c0b4748fedd19c001a3fad233232d3d4c5c71734e8b4feabcac57066ce",
        "control": "2ac056047b38abeb169572256f7b82559d34ec847f8888b4b78ad8724dd70fde",
        "stream": "dc9841446e941044e41e8e1dcf17be75b8dd919ddb913a53f7c2ed9eb8949dec",
        "stream_f32": "8b26af847c56fc4e1e636d4bb738eaee3babf3320bf6412a401e56d93a119288",
    }),
}


@pytest.mark.parametrize("name", sorted(IDENTITY))
def test_existing_configurations_make_the_same_bytes(name):
    override, want = IDENTITY[name]
    config = dict(json.loads((CONFIGS / f"{name}.json").read_text()), **override)
    got = {}
    for seed in (0, 1):
        inp = inputs.build(config, 0, 4, seed, "cpu")
        got[f"streams/{seed}"] = _sha(*inp.streams)
        got[f"blocks/{seed}"] = inp.blocks
        got[f"scan_bytes/{seed}"] = inp.scan_bytes
        if seed == 0:
            frame, q = inp.frames[0], config["quality"]
            got["bounds"] = _sha(*check.reference_bounds(frame, q, "cpu"))
            got["control"] = _sha(check.control_pixels(frame, q, "cpu"))
            got["stream"] = _sha(check.reference_stream(frame, q, "cpu"))
            got["stream_f32"] = _sha(check.reference_stream(frame, q, "cpu",
                                                            "float32"))
    assert got == want


def test_block_counts_of_the_existing_configurations():
    shapes = [(3840, 2160)]
    shapes += [(w, h) for w, h, _ in json.loads(
        (CONFIGS / "ilsvrc-q90-420.json").read_text())["shapes"]]
    for w, h in shapes:
        assert work_bytes.blocks(w, h, "420") == work_bytes.blocks_420(w, h)
    assert work_bytes.blocks(3840, 2160, "422") == 240 * 270 * 4
    assert work_bytes.blocks(500, 375, "444") == 63 * 47 * 3
