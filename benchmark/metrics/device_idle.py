"""Share (%) of the traced stretch of a stream in which no kernel, copy or
memset ran on the card."""


def read(t):
    if not t.images:
        return None
    return 100.0 * t.idle_share()
