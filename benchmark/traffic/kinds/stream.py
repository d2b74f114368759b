"""Traffic kind "stream": the program's streaming entry, decode_stream or
encode_stream by the traffic file's "direction", fed an endless cycle of the
cell's "distinct" inputs. The file's "args" are passed to the entry as they
are (depth, entropy, device_output, ...); an encode stream also gets the
configuration's quality and subsampling, and refuses a configuration with
restart intervals, which encode_stream cannot write, and one with progressive
scans or optimized tables, which the reference's encode does not hold the
program to. One client takes each answer as it comes and stops at the first
answer after the window's end."""

from __future__ import annotations

import itertools
import time

from lib import traffic as tf


def inputs_needed(traffic: dict) -> tuple[int, int]:
    n = traffic["distinct"]
    return (0, n) if traffic["direction"] == "decode" else (n, 0)


def keeps_images(traffic: dict) -> bool:
    return traffic["direction"] == "decode"


def warm(traffic: dict, inp) -> list:
    """Every shape once, then the ring filled twice from the first input."""
    n = traffic["distinct"]
    first = tf.first_of_each_shape(inp.frames, n)
    return [(i, 1) for i in first] + [(0, 2 * (traffic["args"]["depth"] + 1))]


def _open(port, traffic: dict, config: dict, device):
    """(inputs list name, function that opens the stream over an iterator)."""
    args = dict(traffic["args"], device=device)
    if traffic["direction"] == "decode":
        return "streams", lambda it: port.decode_stream(it, **args)
    if config.get("restart_interval", 0):
        raise ValueError(
            f"configuration restart_interval={config['restart_interval']!r} "
            "cannot be encoded as stated: encode_stream takes no restart "
            "interval")
    if config.get("progressive", False):
        raise ValueError("configuration progressive=True cannot be encoded as "
                         "stated: encode_stream writes no progressive stream")
    if config.get("optimize_tables", False):
        raise ValueError(
            "configuration optimize_tables=True cannot be encoded as stated: "
            "the reference's encode has no Annex K.2 tables held to the "
            "program's")
    args.update(quality=config["quality"], subsampling=config["subsampling"])
    return "frames", lambda it: port.encode_stream(it, **args)


def run(port, inp, traffic: dict, config: dict, device, seconds: float,
        start: int, count: int | None, sampler, spans: bool = False) -> tf.Run:
    field, open_stream = _open(port, traffic, config, device)
    n = traffic["distinct"]
    src = getattr(inp, field)[:n]
    order = itertools.count(start) if count is None else range(start,
                                                              start + count)
    out_run = tf.Run("stream", traffic["direction"])
    gen = open_stream(src[i % n] for i in order)
    t0 = time.perf_counter()
    try:
        while True:
            with tf.span("stream_next", spans):
                out = next(gen, None)
            if out is None:
                break
            idx = (start + out_run.images) % n
            out_run.images += 1
            out_run.pixels += inp.pixels[idx]
            out_run.blocks += inp.blocks[idx]
            out_run.scan_bytes += (inp.scan_bytes[idx]
                                   if out_run.direction == "decode"
                                   else len(out))
            if sampler is not None:
                sampler.offer(out_run.direction, idx, out)
            now = time.perf_counter() - t0
            out_run.done_at.append(now)
            if count is None and now >= seconds:
                break
    except Exception as e:  # noqa: BLE001 - a failed answer is counted
        out_run.failed += 1
        out_run.error = f"{type(e).__name__}: {e}"
    out_run.window_s = time.perf_counter() - t0
    out_run.attempted = out_run.images + out_run.failed
    gen.close()  # waits for the decodes in flight; drops queued encodes
    tf.settle(device)
    return out_run
