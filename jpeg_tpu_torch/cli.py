"""Command-line driver of the PyTorch/CUDA port: the subcommands of
jpeg_tpu/cli.py, on the card unless --device says otherwise.

  python -m jpeg_tpu_torch encode in.bmp out.jpg --quality 85 --subsampling 420
  python -m jpeg_tpu_torch decode in.jpg out.bmp --entropy device
  python -m jpeg_tpu_torch roundtrip in.bmp --quality 75     # PSNR / bpp report
  python -m jpeg_tpu_torch info in.jpg                       # marker dump
  python -m jpeg_tpu_torch mosaic big.bmp big.jpg --devices 1 [--stream]
  python -m jpeg_tpu_torch batch a.bmp b.bmp -o outdir [--decode]
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np

SUBSAMPLINGS = ["444", "422", "420", "411", "440"]


def _add_encode_flags(p):
    p.add_argument("--quality", "-q", type=int, default=75)
    p.add_argument("--subsampling", "-s", default="420", choices=SUBSAMPLINGS)
    p.add_argument("--restart-interval", "-r", type=int, default=0,
                   help="MCUs per restart segment (0 = none)")
    p.add_argument("--optimize-tables", action="store_true",
                   help="per-image optimal Huffman tables")
    p.add_argument("--grayscale", action="store_true",
                   help="encode luma only")
    p.add_argument("--progressive", action="store_true",
                   help="progressive (SOF2) stream: libjpeg's standard "
                        "scan script, per-scan optimal tables")
    _add_trace_flag(p)


def _add_trace_flag(p):
    p.add_argument("--trace-dir", default=None,
                   help="write a torch.profiler trace (trace.json) of the "
                        "command's work here, with the jt.* stage spans")


def _tracer(trace_dir, device):
    """A torch.profiler context that writes a Chrome trace into trace_dir
    when it exits (the card's activity too when `device` is a card), or a
    null context. Every thread is recorded where torch can, so the stage
    spans of decode_stream's worker threads are in the trace."""
    if not trace_dir:
        return contextlib.nullcontext()
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    kw = {}
    try:
        kw["experimental_config"] = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except (AttributeError, TypeError):
        pass  # this torch records the profiling thread only
    os.makedirs(trace_dir, exist_ok=True)

    @contextlib.contextmanager
    def run():
        with profile(activities=acts, **kw) as prof:
            yield
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))

    return run()


def _rgb_out(img: np.ndarray) -> np.ndarray:
    """A decoded image as RGB for a BMP: gray replicated, CMYK converted."""
    if img.ndim == 2:
        return np.repeat(img[:, :, None], 3, axis=2)
    if img.shape[-1] == 4:  # Adobe CMYK/YCCK stream
        from jpeg_tpu_torch.ops import color

        return color.cmyk_to_rgb(img)
    return img


def _gray(img: np.ndarray, device) -> np.ndarray:
    """The luma of an RGB image, rounded and clipped to uint8."""
    import torch

    from jpeg_tpu_torch.ops import color

    y = color.rgb_to_ycbcr(torch.as_tensor(img, device=device))[..., 0]
    return torch.clamp(torch.round(y), 0, 255).to(torch.uint8).cpu().numpy()


def _out_names(inputs, ext):
    """Output names for the batch subcommand; colliding basenames
    (a/x.bmp + b/x.bmp) are numbered instead of overwriting each other."""
    seen: dict = {}
    names = []
    for p in inputs:
        base = os.path.splitext(os.path.basename(p))[0]
        n = seen.get(base, 0)
        seen[base] = n + 1
        names.append((base if n == 0 else f"{base}_{n}") + ext)
    return names


def _parser() -> argparse.ArgumentParser:
    dev = argparse.ArgumentParser(add_help=False)
    dev.add_argument("--device", default="cuda",
                     help="torch device to run on (default: cuda)")
    ap = argparse.ArgumentParser(prog="jpeg_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    enc = sub.add_parser("encode", help="BMP -> JPEG", parents=[dev])
    enc.add_argument("input")
    enc.add_argument("output")
    _add_encode_flags(enc)

    from jpeg_tpu_torch.models.decoder import ENTROPY_BACKENDS

    dec = sub.add_parser("decode", help="JPEG -> BMP", parents=[dev])
    dec.add_argument("input")
    dec.add_argument("output")
    dec.add_argument("--entropy", default="auto", choices=ENTROPY_BACKENDS,
                     help="Huffman scan decode backend (all bit-identical)")
    dec.add_argument("--scale-denom", type=int, default=1,
                     choices=[1, 2, 4, 8],
                     help="DCT-domain scaled decode: output is "
                          "ceil(H/d) x ceil(W/d)")
    _add_trace_flag(dec)

    rt = sub.add_parser("roundtrip", help="encode+decode, report PSNR/bpp",
                        parents=[dev])
    rt.add_argument("input")
    _add_encode_flags(rt)

    info = sub.add_parser("info", help="dump JPEG structure")
    info.add_argument("input")

    mos = sub.add_parser("mosaic", help="stripe-sharded single-JFIF encode",
                         parents=[dev])
    mos.add_argument("input")
    mos.add_argument("output")
    mos.add_argument("--quality", "-q", type=int, default=75)
    mos.add_argument("--subsampling", "-s", default="420",
                     choices=SUBSAMPLINGS)
    mos.add_argument("--devices", "-d", type=int, default=None,
                     help="number of devices to stripe over (default: all; "
                          "with --device cpu, positions on the CPU)")
    mos.add_argument("--optimize-tables", action="store_true")
    mos.add_argument("--stream", action="store_true",
                     help="stream stripes from disk (bounded memory; for "
                          "inputs too large to materialize)")
    mos.add_argument("--stripe-rows", type=int, default=None,
                     help="rows per streamed stripe (default ~32 MB)")

    bat = sub.add_parser(
        "batch", help="pipelined many-file encode (BMP->JPEG) or decode "
        "(JPEG->BMP) via the streaming serving APIs", parents=[dev])
    bat.add_argument("inputs", nargs="+")
    bat.add_argument("--outdir", "-o", required=True)
    bat.add_argument("--decode", action="store_true",
                     help="decode JPEGs to BMPs instead of encoding")
    bat.add_argument("--quality", "-q", type=int, default=75)
    bat.add_argument("--subsampling", "-s", default="420",
                     choices=SUBSAMPLINGS)
    bat.add_argument("--depth", type=int, default=2,
                     help="device dispatches kept in flight")
    _add_trace_flag(bat)
    return ap


def _encode(args) -> int:
    from jpeg_tpu_torch import encode
    from jpeg_tpu_torch.io import bmp

    img = bmp.read_bmp(args.input)
    if args.grayscale:
        img = _gray(img, args.device)
    t0 = time.time()
    with _tracer(args.trace_dir, args.device):
        if args.progressive:
            from jpeg_tpu_torch.models.progressive_enc import (
                encode_progressive)

            if args.restart_interval:
                raise SystemExit(
                    "--progressive does not emit restart intervals")
            data = encode_progressive(img, quality=args.quality,
                                      subsampling=args.subsampling,
                                      device=args.device)
        else:
            data = encode(
                img, quality=args.quality, subsampling=args.subsampling,
                restart_interval=args.restart_interval,
                optimize_tables=args.optimize_tables, device=args.device)
    dt = time.time() - t0
    with open(args.output, "wb") as f:
        f.write(data)
    mp = img.shape[0] * img.shape[1] / 1e6
    print(f"{args.input} -> {args.output}: {len(data)} bytes, "
          f"{dt*1e3:.1f} ms ({mp/dt:.1f} MPix/s)")
    return 0


def _decode(args) -> int:
    from jpeg_tpu_torch import decode
    from jpeg_tpu_torch.io import bmp

    with open(args.input, "rb") as f:
        data = f.read()
    t0 = time.time()
    with _tracer(args.trace_dir, args.device):
        img = decode(data, entropy=args.entropy,
                     scale_denom=args.scale_denom, device=args.device)
    dt = time.time() - t0
    img = _rgb_out(img)
    bmp.write_bmp(args.output, img)
    print(f"{args.input} -> {args.output}: {img.shape[1]}x{img.shape[0]}, "
          f"{dt*1e3:.1f} ms")
    return 0


def _roundtrip(args) -> int:
    from jpeg_tpu_torch import decode, encode
    from jpeg_tpu_torch.io import bmp
    from jpeg_tpu_torch.utils import metrics

    img = bmp.read_bmp(args.input)
    with _tracer(args.trace_dir, args.device):
        data = encode(
            img, quality=args.quality, subsampling=args.subsampling,
            restart_interval=args.restart_interval,
            optimize_tables=args.optimize_tables, device=args.device)
        out = decode(data, device=args.device)
    print(f"quality={args.quality} subsampling={args.subsampling}: "
          f"{len(data)} bytes, "
          f"bpp={metrics.bits_per_pixel(data, img.shape):.3f}, "
          f"PSNR={metrics.psnr(out, img):.2f} dB")
    return 0


def _mosaic(args) -> int:
    import torch

    from jpeg_tpu_torch.io import bmp
    from jpeg_tpu_torch.parallel.mesh import make_mesh
    from jpeg_tpu_torch.parallel.mosaic import (
        encode_mosaic, encode_mosaic_stream)

    if args.stream:
        t0 = time.time()
        with bmp.BmpRowReader(args.input) as src, \
                open(args.output, "wb") as f:
            mp = src.height * src.width / 1e6
            encode_mosaic_stream(
                src.rows, src.height, src.width, quality=args.quality,
                subsampling=args.subsampling, stripe_rows=args.stripe_rows,
                optimize_tables=args.optimize_tables, out=f,
                device=args.device)
        dt = time.time() - t0
        print(f"{args.input} ({mp:.1f} MPix) -> {args.output}: "
              f"{os.path.getsize(args.output)} bytes streamed, "
              f"{dt*1e3:.0f} ms")
        return 0

    img = bmp.read_bmp(args.input)
    device = torch.device(args.device)
    if device.type == "cuda":
        mesh = make_mesh(args.devices, batch_axis=1)
    else:
        mesh = make_mesh(batch_axis=1, devices=[device] * (args.devices or 1))
    t0 = time.time()
    data = encode_mosaic(img, quality=args.quality,
                         subsampling=args.subsampling, mesh=mesh,
                         optimize_tables=args.optimize_tables)
    dt = time.time() - t0
    with open(args.output, "wb") as f:
        f.write(data)
    mp = img.shape[0] * img.shape[1] / 1e6
    print(f"{args.input} ({mp:.1f} MPix) -> {args.output}: {len(data)} "
          f"bytes via {mesh.shape['mcu']} stripes, {dt*1e3:.0f} ms")
    return 0


def _batch(args) -> int:
    from jpeg_tpu_torch.io import bmp
    from jpeg_tpu_torch.parallel.pipeline import decode_stream, encode_stream

    os.makedirs(args.outdir, exist_ok=True)
    t0 = time.time()
    mpix = 0.0
    with _tracer(args.trace_dir, args.device):
        if args.decode:
            def read_jpegs():
                for p in args.inputs:
                    with open(p, "rb") as f:
                        yield f.read()

            stream = decode_stream(read_jpegs(), depth=args.depth,
                                   device=args.device)
            for name, img in zip(_out_names(args.inputs, ".bmp"), stream):
                img = _rgb_out(img)
                mpix += img.shape[0] * img.shape[1] / 1e6
                bmp.write_bmp(os.path.join(args.outdir, name), img)
        else:
            tally = [0.0]

            def read_all():
                # A generator: the host holds about depth + 1 frames, not the
                # whole batch, before the first encode.
                for p in args.inputs:
                    img = bmp.read_bmp(p)
                    tally[0] += img.shape[0] * img.shape[1] / 1e6
                    yield img

            stream = encode_stream(read_all(), quality=args.quality,
                                   subsampling=args.subsampling,
                                   depth=args.depth, device=args.device)
            for name, data in zip(_out_names(args.inputs, ".jpg"), stream):
                with open(os.path.join(args.outdir, name), "wb") as f:
                    f.write(data)
            mpix = tally[0]
    dt = time.time() - t0
    verb = "decoded" if args.decode else "encoded"
    print(f"{verb} {len(args.inputs)} files ({mpix:.1f} MPix) in "
          f"{dt*1e3:.0f} ms ({mpix/dt:.1f} MPix/s)")
    return 0


def _info(args) -> int:
    from jpeg_tpu_torch.io import jfif

    with open(args.input, "rb") as f:
        info_ = jfif.parse_jpeg(f.read())
    print(f"{info_.width}x{info_.height}, {len(info_.components)} components")
    for c in info_.components:
        print(f"  comp {c.comp_id}: sampling {c.h}x{c.v}, "
              f"qtable {c.qtab_id}, DC/AC tables {c.dc_id}/{c.ac_id}")
    print(f"  quant tables: {sorted(info_.qtables)}")
    print(f"  huffman tables: {sorted(info_.htables)}")
    print(f"  restart interval: {info_.restart_interval}")
    print(f"  scan bytes: {len(info_.scan_data)}")
    return 0


COMMANDS = {"encode": _encode, "decode": _decode, "roundtrip": _roundtrip,
            "mosaic": _mosaic, "batch": _batch, "info": _info}


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    return COMMANDS[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
