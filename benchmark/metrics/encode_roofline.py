"""Share (%) of the encode's roofline on the card: 3 B per RGB pixel read
once and the scan written once, at the card's peak bandwidth, over the time
of every kernel in the traced stretch (copies and memsets excluded)."""

from metrics import work_bytes


def read(t):
    nbytes = work_bytes.encode_bytes(t.work["pixels"], t.work["scan_bytes"])
    us = sum(e["dur"] for e in t.ops(("kernel",)))
    return work_bytes.roofline_pct(nbytes, us)
