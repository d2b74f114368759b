"""Named spans of the port's stages, for torch.profiler.

    with span("jt.decode.parse"):
        info = jfif.parse_jpeg(data)

While a torch.profiler profile runs anywhere in the process, span() is a
record_function range: Kineto keeps it, on the clock of the card's activity,
and writes it into the caller's trace. Otherwise it is one shared null
context, so a span costs a flag read. There is nothing else: no switch, no
store, no exporter. Only the thread that started the profile is recorded
unless the profile asks for every thread (profile_all_threads in its
experimental config); decode_stream decodes on worker threads.

Names are fixed strings, so a reader can group them. Leaves are the stages
of one image and never nest in one another: their durations add up across
threads. The jt.wait.* leaves are the only places where a thread of the
program waits for the card. Three parents, jt.decode, jt.encode.dispatch and
jt.encode.finish, hold the leaves of one image and the glue between them.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A record_function range named `name` while a profile runs, else a
    null context."""
    # Read through the module each call: the profiler rebinds the flag.
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF
