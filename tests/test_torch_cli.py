"""The port's command line (jpeg_tpu_torch.cli, python -m jpeg_tpu_torch)
with --device cpu: every subcommand writes the files that the library calls
give, byte for byte (JPEG) or sample for sample (BMP); `info` prints what
jpeg_tpu's CLI prints. Also the helpers the CLI calls: utils.metrics equals
jpeg_tpu's exactly, ops.color.cmyk_to_rgb exactly, ops.color.rgb_to_ycbcr to
f32 rounding (jpeg_tpu's XLA dot picks its own summation order per
channel: within 2e-5 of samples up to 255.5, whose ulp is 1.5e-5)."""

import json
import os
import subprocess
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpeg_tpu import cli as JCLI
from jpeg_tpu.ops import color as JC
from jpeg_tpu.utils import metrics as JMet

import jpeg_tpu_torch
from jpeg_tpu_torch import cli
from jpeg_tpu_torch.io import bmp
from jpeg_tpu_torch.models.progressive_enc import encode_progressive
from jpeg_tpu_torch.ops import color as PC
from jpeg_tpu_torch.parallel import mesh as PM, mosaic as PMo
from jpeg_tpu_torch.parallel.pipeline import decode_stream, encode_stream
from jpeg_tpu_torch.utils import metrics as PMet

from torch_port_util import make_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "data", "torch_port")
CPU = ["--device", "cpu"]


@pytest.fixture
def bmp_file(tmp_path):
    img = make_image(72, 104, seed=5)
    path = str(tmp_path / "in.bmp")
    bmp.write_bmp(path, img)
    return path, img


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _encode(img, **kw):
    return jpeg_tpu_torch.encode(img, device="cpu", **kw)


@pytest.mark.parametrize("flags,kw", [
    ([], {}),
    (["-q", "90", "-s", "444", "-r", "3", "--optimize-tables"],
     dict(quality=90, subsampling="444", restart_interval=3,
          optimize_tables=True)),
])
def test_encode(bmp_file, tmp_path, flags, kw):
    src, img = bmp_file
    out = str(tmp_path / "o.jpg")
    assert cli.main(["encode", src, out, *CPU, *flags]) == 0
    assert _read(out) == _encode(img, **kw)


def test_encode_grayscale_progressive_and_trace(bmp_file, tmp_path):
    src, img = bmp_file
    gray_out, prog_out = str(tmp_path / "g.jpg"), str(tmp_path / "p.jpg")
    assert cli.main(["encode", src, gray_out, "--grayscale", *CPU]) == 0
    y = PC.rgb_to_ycbcr(torch.as_tensor(img))[..., 0]
    gray = torch.clamp(torch.round(y), 0, 255).to(torch.uint8).numpy()
    assert _read(gray_out) == _encode(gray)
    trace = tmp_path / "trace"
    assert cli.main(["encode", src, prog_out, "--progressive", "-q", "80",
                     "--trace-dir", str(trace), *CPU]) == 0
    assert _read(prog_out) == encode_progressive(img, quality=80,
                                                 device="cpu")
    assert (trace / "trace.json").stat().st_size > 0
    with pytest.raises(SystemExit):
        cli.main(["encode", src, prog_out, "--progressive", "-r", "2", *CPU])


@pytest.mark.parametrize("entropy", ["auto", "native", "sparse", "device"])
def test_decode(bmp_file, tmp_path, entropy):
    src, img = bmp_file
    jpg = tmp_path / "i.jpg"
    jpg.write_bytes(_encode(img, restart_interval=4))
    out = str(tmp_path / "o.bmp")
    assert cli.main(["decode", str(jpg), out, "--entropy", entropy,
                     *CPU]) == 0
    want = jpeg_tpu_torch.decode(jpg.read_bytes(), device="cpu")
    np.testing.assert_array_equal(bmp.read_bmp(out), want)
    assert cli.main(["decode", str(jpg), out, "--scale-denom", "2",
                     "--entropy", entropy, *CPU]) == 0
    np.testing.assert_array_equal(
        bmp.read_bmp(out),
        jpeg_tpu_torch.decode(jpg.read_bytes(), device="cpu", scale_denom=2))


def test_decode_gray_and_cmyk_streams(bmp_file, tmp_path):
    """Gray output is replicated to RGB, CMYK converted (cmyk_to_rgb)."""
    src, img = bmp_file
    gray = tmp_path / "g.jpg"
    gray.write_bytes(_encode(img[..., 1]))
    out = str(tmp_path / "o.bmp")
    assert cli.main(["decode", str(gray), out, *CPU]) == 0
    g = jpeg_tpu_torch.decode(gray.read_bytes(), device="cpu")
    np.testing.assert_array_equal(bmp.read_bmp(out), np.repeat(g[..., None],
                                                               3, axis=2))
    cmyk = os.path.join(FIXTURES, "cmyk.jpg")
    assert cli.main(["decode", cmyk, out, *CPU]) == 0
    np.testing.assert_array_equal(
        bmp.read_bmp(out),
        PC.cmyk_to_rgb(jpeg_tpu_torch.decode(_read(cmyk), device="cpu")))


def test_roundtrip(bmp_file, capsys):
    src, img = bmp_file
    assert cli.main(["roundtrip", src, "-q", "85", *CPU]) == 0
    data = _encode(img, quality=85)
    out = jpeg_tpu_torch.decode(data, device="cpu")
    assert capsys.readouterr().out.strip() == (
        f"quality=85 subsampling=420: {len(data)} bytes, "
        f"bpp={PMet.bits_per_pixel(data, img.shape):.3f}, "
        f"PSNR={PMet.psnr(out, img):.2f} dB")


@pytest.mark.parametrize("name", ["baseline", "progressive_420.jpg",
                                  "noninterleaved_444.jpg", "ycck.jpg"])
def test_info_prints_what_jpeg_tpu_prints(bmp_file, tmp_path, capsys, name):
    if name == "baseline":
        path = str(tmp_path / "b.jpg")
        with open(path, "wb") as f:
            f.write(_encode(bmp_file[1], restart_interval=5,
                            optimize_tables=True))
    else:
        path = os.path.join(FIXTURES, name)
    assert cli.main(["info", path]) == 0
    ours = capsys.readouterr().out
    assert JCLI.main(["info", path]) == 0
    assert ours == capsys.readouterr().out


def test_mosaic(tmp_path):
    img = make_image(96, 104, seed=6)
    src = str(tmp_path / "big.bmp")
    bmp.write_bmp(src, img)
    out = str(tmp_path / "m.jpg")
    assert cli.main(["mosaic", src, out, "--devices", "3", "-q", "80",
                     *CPU]) == 0
    mesh = PM.make_mesh(3, batch_axis=1, devices=["cpu"] * 3)
    assert _read(out) == PMo.encode_mosaic(img, quality=80, mesh=mesh)
    # 96 rows of 4:2:0 are 3 stripes of 2 MCU rows of 7 MCUs.
    assert _read(out) == _encode(img, quality=80, restart_interval=14)
    assert cli.main(["mosaic", src, out, "--stream", "--stripe-rows", "32",
                     "--optimize-tables", *CPU]) == 0
    assert _read(out) == PMo.encode_mosaic_stream(
        lambda a, b: img[a:b], 96, 104, stripe_rows=32, optimize_tables=True,
        device="cpu")


def test_mosaic_devices_beyond_the_machine_raise(bmp_file, tmp_path,
                                                 monkeypatch):
    """On the card (the default device) --devices counts CUDA devices, as
    jpeg_tpu's counts its own: more than there are raises."""
    src, _ = bmp_file
    out = str(tmp_path / "m.jpg")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        cli.main(["mosaic", src, out, "--devices", "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["mosaic", src, out])


def test_batch_encode_and_decode(tmp_path):
    imgs = [make_image(40, 56, seed=s) for s in range(3)]
    imgs.append(make_image(24, 32, seed=9))
    os.makedirs(tmp_path / "a")
    paths = []
    for i, im in enumerate(imgs):
        sub = tmp_path / ("a" if i == 1 else "")
        p = str(sub / ("x.bmp" if i < 2 else f"f{i}.bmp"))
        bmp.write_bmp(p, im)
        paths.append(p)
    outdir = tmp_path / "out"
    assert cli.main(["batch", *paths, "-o", str(outdir), "-q", "70",
                     "--depth", "2", *CPU]) == 0
    names = ["x.jpg", "x_1.jpg", "f2.jpg", "f3.jpg"]
    want = list(encode_stream(iter(imgs), quality=70, depth=2, device="cpu"))
    assert want == [_encode(im, quality=70) for im in imgs]
    assert [_read(outdir / n) for n in names] == want
    jpgs = [str(outdir / n) for n in names]
    assert cli.main(["batch", *jpgs, "--decode", "-o", str(tmp_path / "d"),
                     *CPU]) == 0
    got = [bmp.read_bmp(str(tmp_path / "d" / n.replace(".jpg", ".bmp")))
           for n in names]
    for g, w in zip(got, decode_stream(iter(want), device="cpu")):
        np.testing.assert_array_equal(g, w)


def _trace_spans(trace_dir):
    """{jt.* span name: set of thread ids} in the CLI's trace."""
    with open(trace_dir / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    out: dict = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"].startswith("jt."):
            out.setdefault(e["name"], set()).add(e.get("tid"))
    return out


@pytest.mark.parametrize("cmd", ["decode", "roundtrip", "batch"])
def test_trace_dir_holds_the_stage_spans(bmp_file, tmp_path, cmd):
    """--trace-dir writes the torch.profiler trace with the program's
    spans; batch --decode's decodes run on decode_stream's worker threads,
    whose spans are recorded too."""
    src, img = bmp_file
    jpg = tmp_path / "i.jpg"
    jpg.write_bytes(_encode(img))
    trace = tmp_path / "trace"
    args = {"decode": ["decode", str(jpg), str(tmp_path / "o.bmp")],
            "roundtrip": ["roundtrip", src],
            "batch": ["batch", str(jpg), str(jpg), "--decode", "-o",
                      str(tmp_path / "d")]}[cmd]
    assert cli.main([*args, "--trace-dir", str(trace), *CPU]) == 0
    spans = _trace_spans(trace)
    main = threading.get_native_id()
    for name in ("jt.decode", "jt.decode.parse", "jt.decode.walk",
                 "jt.decode.finish", "jt.wait.download"):
        assert name in spans, name
        assert (main in spans[name]) == (cmd != "batch"), name
    if cmd == "roundtrip":
        assert {"jt.encode.dispatch", "jt.encode.finalize"} <= set(spans)


def test_python_dash_m(bmp_file, tmp_path):
    """`python -m jpeg_tpu_torch` runs main() (and importing the package's
    __main__ module does not)."""
    src, img = bmp_file
    out = str(tmp_path / "o.jpg")
    proc = subprocess.run(
        [sys.executable, "-m", "jpeg_tpu_torch", "encode", src, out, *CPU],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert _read(out) == _encode(img)
    proc = subprocess.run([sys.executable, "-m", "jpeg_tpu_torch"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2 and "usage" in proc.stderr


def test_metrics_equal_jpeg_tpu():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 256, (33, 47, 3)).astype(np.uint8)
    b = np.clip(a.astype(np.int32) + rng.integers(-3, 4, a.shape), 0, 255)
    assert PMet.psnr(a, b) == JMet.psnr(a, b)
    assert PMet.psnr(a, a) == JMet.psnr(a, a) == float("inf")
    assert PMet.bits_per_pixel(b"x" * 1234, a.shape) == JMet.bits_per_pixel(
        b"x" * 1234, a.shape)


def test_colour_helpers_equal_jpeg_tpu():
    rng = np.random.default_rng(4)
    cmyk = rng.integers(0, 256, (29, 31, 4)).astype(np.uint8)
    np.testing.assert_array_equal(PC.cmyk_to_rgb(cmyk), JC.cmyk_to_rgb(cmyk))
    with pytest.raises(ValueError):
        PC.cmyk_to_rgb(cmyk[..., :3])
    rgb = rng.integers(0, 256, (61, 67, 3)).astype(np.uint8)
    got = PC.rgb_to_ycbcr(torch.as_tensor(rgb)).numpy()
    want = np.asarray(JC.rgb_to_ycbcr(jnp.asarray(rgb)))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
