"""Megapixels per second through the encode stream: the pixels of every image
completed in the window, over all the window's seconds."""


def read(run):
    if run.kind != "stream" or run.direction != "encode" or run.window_s <= 0:
        return None
    return run.pixels / run.window_s / 1e6
