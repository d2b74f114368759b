"""Time (ms) per image that the program's threads waited for the card: its
jt.wait.* spans (an upload from pageable memory, a stream or event
synchronize, a readback) summed over the traced stretch."""

from lib import spans


def read(t):
    return spans.ms_per_image(t, lambda n: n.startswith("jt.wait."))
