"""Share (%) of the Huffman decode's roofline: the scan read once and 128 B
of coefficients per block written once, at the card's peak bandwidth, over
the summed time of the kernels named in entropy_roofline.kernels.json."""

import json
import pathlib

from metrics import work_bytes

KERNELS = json.loads(
    pathlib.Path(__file__).with_name("entropy_roofline.kernels.json").read_text())


def read(t):
    nbytes = work_bytes.entropy_bytes(t.work["scan_bytes"], t.work["blocks"])
    return work_bytes.roofline_pct(nbytes, t.kernel_us(KERNELS))
