"""Host time (ms) per image spent enqueueing the card's work: the program's
spans named in enqueue_ms_per_image.spans.json (the encode's transform and
pack, the decode's entropy and finish), summed over the traced stretch."""

import json
import pathlib

from lib import spans

NAMES = frozenset(json.loads(pathlib.Path(__file__).with_name(
    "enqueue_ms_per_image.spans.json").read_text()))


def read(t):
    return spans.ms_per_image(t, NAMES.__contains__)
