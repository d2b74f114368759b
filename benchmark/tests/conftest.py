import os
import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(BENCH.parent))

if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    import torch

    # Each worker's runs of the harness on the CPU would start torch's
    # intra-op pool over every core: 6 workers on 8 cores took a 5 s decode
    # case to 360-570 s. Split the cores between the workers instead.
    torch.set_num_threads(max(1, (os.cpu_count() or 1)
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))
