"""Host time (ms) per decoded image spent parsing the stream: its markers,
tables and frame, and the header checks (the program's jt.decode.parse
spans, on whichever thread decodes), summed over the traced stretch."""

from lib import spans


def read(t):
    return spans.ms_per_image(t, lambda n: n == "jt.decode.parse")
