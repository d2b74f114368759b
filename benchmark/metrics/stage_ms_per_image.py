"""Host time (ms) per encoded image spent staging the frame for its upload:
the copy into the stream slot's pinned buffer and the enqueue of its
asynchronous copy to the card (the program's jt.encode.stage spans), summed
over the traced stretch. A program that uploads from the caller's array
without staging has no such span and reads nothing."""

from lib import spans


def read(t):
    return spans.ms_per_image(t, lambda n: n == "jt.encode.stage")
