"""The general traffic generator: one closed-loop client per cell, driven
by the parameters of the cell's traffic file. The file's "kind" names a
module benchmark/traffic/kinds/<kind>.py that drives the program's entry
point; this module holds what every kind shares: the record of a pass
(Run), the sample of answers kept for the comparison (Sampler), the spans,
and the warm-up and window around a kind's passes (drive).

A kind module provides

- inputs_needed(traffic) -> (n_frames, n_streams): the distinct inputs;
- keeps_images(traffic) -> bool: whether its answers are decoded images;
- warm(traffic, inp) -> [(start, count)]: the passes that warm every shape
  it uses;
- run(port, inp, traffic, config, device, seconds, start, count, sampler,
  spans=False) -> Run: one pass from input `start`, for `seconds` (count
  None) or for exactly `count` answers.

Every answer is counted; a sample of them, drawn from the seed, is kept for
the comparison with the reference after the window.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import mmap

import numpy as np

from lib import trace as tr


@dataclasses.dataclass
class Run:
    """What one pass of the traffic did."""

    kind: str
    direction: str
    window_s: float = 0.0
    images: int = 0  # answers completed in the window
    pixels: int = 0  # pixels of those images
    blocks: int = 0
    scan_bytes: int = 0
    attempted: int = 0
    failed: int = 0
    error: str = ""
    kept: list = dataclasses.field(default_factory=list)  # (kind, idx, out)
    setup_s: float = 0.0
    done_at: list = dataclasses.field(default_factory=list)  # s into window


def _buffer(nbytes: int) -> mmap.mmap:
    """An anonymous mapping outside the allocator the program uses, its
    pages touched now (in set-up) so that a copy into it in the window is a
    plain memcpy."""
    buf = mmap.mmap(-1, max(nbytes, 1))
    np.frombuffer(buf, dtype=np.uint8).fill(0)
    return buf


class Sampler:
    """Keeps a copy of answer n with probability `rate` (a draw from the
    seed per answer), at most `limit` of them, and of each kind of answer
    the last one offered (the client holds it until the next one, as a loop
    that assigns each answer to one name does).

    A kept image is copied into one of `limit` buffers of `nbytes` made in
    set-up, and the program's own array or tensor goes back at once, as a
    client's would: kept arrays that the program allocated would stay in
    its malloc arenas all window long and change how later answers are
    allocated. Encoded streams are kept as they are."""

    def __init__(self, seed: int, rate: float, limit: int, nbytes: int = 0):
        self.rng = np.random.default_rng(int(seed) % (1 << 63))
        self.rate, self.limit = rate, limit
        self.free = [_buffer(nbytes) for _ in range(limit)] if nbytes else []
        self.kept: list = []
        self.last: dict = {}

    def _copy(self, out):
        if isinstance(out, (bytes, bytearray)):
            return out
        buf = self.free.pop()
        view = np.frombuffer(buf, dtype=np.uint8, count=math.prod(out.shape))
        view = view.reshape(tuple(out.shape))
        if isinstance(out, np.ndarray):
            view[...] = out
        else:  # a tensor on the card: straight into the buffer
            import torch

            torch.from_numpy(view).copy_(out)
        return view

    def offer(self, kind: str, idx: int, out) -> None:
        if self.rng.random() < self.rate and len(self.kept) < self.limit:
            self.kept.append((kind, idx, self._copy(out)))
            self.last.pop(kind, None)
        else:
            self.last[kind] = (kind, idx, out)

    def result(self) -> list:
        return self.kept + list(self.last.values())


def span(name: str, on: bool):
    if not on:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(name)


def settle(device) -> None:
    """Wait for whatever the program left queued on the card."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def first_of_each_shape(frames, n: int) -> list:
    """Position of the first of the n first frames of every distinct shape."""
    seen, first = set(), []
    for i in range(n):
        shape = frames[i].shape
        if shape not in seen:
            seen.add(shape)
            first.append(i)
    return first


def drive(kind, port, inp, traffic: dict, config: dict, device,
          seconds: float, seed: int, trace_on: bool, out_trace: dict,
          mark=None) -> Run:
    """Warm up (the kind's passes), call mark() and run the window; with
    trace_on a bounded traced stretch of traffic["trace_items"] answers in
    place of the timed window. `kind` is the cell's kind module."""
    for i, c in kind.warm(traffic, inp):
        run = kind.run(port, inp, traffic, config, device, 0.0, i, c, None)
        if run.failed:
            return run
    sampler = Sampler(seed, traffic["check_rate"], traffic["check_max"],
                      3 * max(inp.pixels) if kind.keeps_images(traffic) else 0)
    if mark is not None:
        mark()
    if not trace_on:
        run = kind.run(port, inp, traffic, config, device, seconds, 0, None,
                       sampler)
    else:
        import torch

        with tr.profiled(out_trace):
            kind.run(port, inp, traffic, config, device, 0.0, 0, 2, None)
            with torch.profiler.record_function(tr.WINDOW):
                run = kind.run(port, inp, traffic, config, device, 0.0, 0,
                               traffic["trace_items"], sampler, spans=True)
    run.kept = sampler.result()
    return run
