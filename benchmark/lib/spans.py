"""The program's own spans in a traced stretch: jpeg_tpu_torch's stage
ranges (jpeg_tpu_torch/utils/trace.span), named "jt.<...>", on the device
events' clock. Leaves never nest in one another, so their durations add up
across threads; a program without them leaves the readers nothing to read.
"""

from __future__ import annotations

PREFIX = "jt."


def clipped(t, match) -> list:
    """[(name, start, end)] of the program's spans whose name `match`
    accepts, clipped to the traced stretch."""
    return [(n, max(a, t.lo), min(b, t.hi)) for n, a, b in t.spans
            if n.startswith(PREFIX) and match(n)
            and min(b, t.hi) > max(a, t.lo)]


def ms_per_image(t, match) -> float | None:
    """Summed duration (ms) of those spans per image of the stretch, or
    None without images or spans."""
    found = clipped(t, match)
    if not t.images or not found:
        return None
    return sum(b - a for _, a, b in found) / 1000.0 / t.images
