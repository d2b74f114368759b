"""Host time (ms) per encoded image of the finalize: the native trim,
1-padding and 0xFF stuffing of the device pack's words and the JFIF write
(the program's jt.encode.finalize spans), summed over the traced stretch."""

from lib import spans


def read(t):
    return spans.ms_per_image(t, lambda n: n == "jt.encode.finalize")
