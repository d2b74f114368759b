"""Share (%) of the IDCT + finish's roofline: 128 B of coefficients per
block read once and 3 B per RGB pixel written once, at the card's peak
bandwidth, over the summed time of the kernels named in
finish_roofline.kernels.json."""

import json
import pathlib

from metrics import work_bytes

KERNELS = json.loads(
    pathlib.Path(__file__).with_name("finish_roofline.kernels.json").read_text())


def read(t):
    nbytes = work_bytes.finish_bytes(t.work["blocks"], t.work["pixels"])
    return work_bytes.roofline_pct(nbytes, t.kernel_us(KERNELS))
