"""Seconds from the start of the process to the first timed call: imports,
CUDA start-up, making the inputs from the seed, kernel builds in a
checkout's first run, and the warm-up of every shape the cell uses."""


def read(run):
    return run.setup_s if run.setup_s > 0 else None
