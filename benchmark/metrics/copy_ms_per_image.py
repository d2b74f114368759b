"""Host-to-card and card-to-host copy time on the card (ms) per image (decoded
or encoded) in the traced stretch."""


def read(t):
    if not t.images:
        return None
    us = sum(e["dur"] for e in t.ops(("memcpy",))
             if "HtoD" in e["name"] or "DtoH" in e["name"])
    return us / 1000.0 / t.images
