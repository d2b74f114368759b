"""Host time (ms) per decoded image spent splitting the scan at its restart
markers and removing the stuffed zero bytes (the program's jt.decode.unstuff
spans, on whichever thread decodes), summed over the traced stretch."""

from lib import spans


def read(t):
    return spans.ms_per_image(t, lambda n: n == "jt.decode.unstuff")
