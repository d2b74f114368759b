"""Worker process for tests/test_torch_multiprocess.py.

One rank of a torch.distributed gloo group on localhost, holding 4 CPU
positions, that runs jpeg_tpu_torch's mesh layer over the global (2, 4) and
(1, 8) meshes of make_multihost_mesh: encode_batch, encode_mosaic,
decode_batch and the collectives, with the rank boundary on the batch axis
of (2, 4) and between stripes 3 and 4 of (1, 8). Imports no jax and nothing
of jpeg_tpu. The cases and their inputs are defined here, and the test
holds the results against single-process runs of the same cases.

Usage: python tests/torch_mp_worker.py <host:port> <world size> <rank> <outdir>

Writes <outdir>/rank<r>.pkl: {case name: result} (streams as lists of
bytes, pixels and collective results as NumPy arrays).
"""

from __future__ import annotations

import datetime
import pathlib
import pickle
import sys

import numpy as np

POSITIONS = 4  # per rank
TIMEOUT_S = 120  # of every collective, init included
QUALITY = 80
LAYOUTS = {"2x4": 2, "1x8": 1}  # mesh name -> batch axis of 8 positions

# name -> (mesh, input, encode_batch arguments). On 1x8 the DC chain of
# stripe_restart=False crosses the rank boundary by ppermute.
ENCODE_CASES = {
    "device_pack_2x4": ("2x4", "imgs", dict(device_pack=True)),
    "host_pack_2x4": ("2x4", "imgs", dict()),
    "no_restart_2x4": ("2x4", "imgs", dict(stripe_restart=False)),
    "optimize_device_pack_2x4": ("2x4", "imgs",
                                 dict(device_pack=True, optimize_tables=True)),
    "optimize_host_pack_2x4": ("2x4", "imgs", dict(optimize_tables=True)),
    "device_pack_1x8": ("1x8", "tall", dict(device_pack=True)),
    "no_restart_1x8": ("1x8", "tall", dict(stripe_restart=False)),
    "optimize_device_pack_1x8": ("1x8", "tall",
                                 dict(device_pack=True, optimize_tables=True)),
}
# name -> encode_mosaic arguments, on 1x8.
MOSAIC_CASES = {
    "mosaic_device_pack_1x8": dict(device_pack=True),
    "mosaic_host_pack_1x8": dict(),
}
# name -> (mesh, the encode case whose streams are decoded, entropy). On
# 1x8 the halo rows of the chroma upsample cross the rank boundary.
DECODE_CASES = {
    "auto_2x4": ("2x4", "device_pack_2x4", "auto"),
    "sparse_2x4": ("2x4", "device_pack_2x4", "sparse"),
    "auto_1x8": ("1x8", "device_pack_1x8", "auto"),
    "device_1x8": ("1x8", "device_pack_1x8", "device"),
}
# name -> (mesh, collective, argument), over grid_input() sharded.
COLLECTIVE_CASES = {
    "ppermute_batch_down_2x4": ("2x4", "ppermute", ("batch", [(0, 1)])),
    "ppermute_batch_up_2x4": ("2x4", "ppermute", ("batch", [(1, 0)])),
    "ppermute_mcu_forward_1x8": ("1x8", "ppermute",
                                 ("mcu", [(i, i + 1) for i in range(7)])),
    "ppermute_mcu_back_1x8": ("1x8", "ppermute",
                              ("mcu", [(i, i - 1) for i in range(1, 8)])),
    "psum_batch_2x4": ("2x4", "psum", "batch"),
    "psum_mcu_2x4": ("2x4", "psum", "mcu"),
    "psum_both_2x4": ("2x4", "psum", ("batch", "mcu")),
    "psum_batch_1x8": ("1x8", "psum", "batch"),
    "psum_mcu_1x8": ("1x8", "psum", "mcu"),
    "psum_both_1x8": ("1x8", "psum", ("batch", "mcu")),
    "to_host_2x4": ("2x4", "to_host", None),
    "to_host_1x8": ("1x8", "to_host", None),
}


def inputs() -> dict:
    """The cases' images, from one seed: imgs (4, 64, 48, 3) (4 MCU rows of
    4:2:0), tall (2, 128, 48, 3) (8 MCU rows: one per stripe of 1x8) and
    big (256, 80, 3) for the mosaic."""
    from torch_port_util import parallel_images

    rng = np.random.default_rng(7)
    return {"imgs": parallel_images(rng, b=4, h=64, w=48),
            "tall": parallel_images(rng, b=2, h=128, w=48),
            "big": rng.integers(0, 256, size=(256, 80, 3)).astype(np.uint8)}


def grid_input() -> np.ndarray:
    """(2, 8, 3) int64: splits as (1, 2, 3) parts on 2x4, (2, 1, 3) on 1x8."""
    return np.arange(2 * 8 * 3, dtype=np.int64).reshape(2, 8, 3)


def run_collective(pm, mesh, op, arg):
    """One collective case through the mesh functions: a host array."""
    grid = pm.shard(grid_input(), mesh)
    if op == "ppermute":
        return pm.to_host(pm.ppermute(grid, *arg, mesh), mesh)
    if op == "psum":
        return pm.to_host(pm.psum(grid, arg, mesh), mesh)
    return pm.to_host(grid, mesh)


def main() -> None:
    address, world, rank, outdir = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
        pathlib.Path(sys.argv[4]))
    import torch.distributed as dist

    from jpeg_tpu_torch.parallel import batch as PB, mesh as PM, mosaic as PMo

    dist.init_process_group(
        "gloo", init_method=f"tcp://{address}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    meshes = {name: PM.make_multihost_mesh(batch_axis=ba,
                                           devices=["cpu"] * POSITIONS,
                                           backend="gloo")
              for name, ba in LAYOUTS.items()}
    data = inputs()
    out = {"ranks_" + name: m.ranks for name, m in meshes.items()}
    for name, m in meshes.items():
        grid = PM.shard(grid_input(), m)
        out["shard_none_" + name] = np.vectorize(
            lambda t: t is None, otypes=[bool])(grid)
        out["shard_local_" + name] = np.concatenate(
            [grid[idx].numpy().ravel() for idx in m.local_positions()])
    for name, (layout, src, kw) in ENCODE_CASES.items():
        out[name] = PB.encode_batch(data[src], quality=QUALITY,
                                    mesh=meshes[layout], **kw)
    for name, kw in MOSAIC_CASES.items():
        out[name] = PMo.encode_mosaic(data["big"], quality=QUALITY,
                                      mesh=meshes["1x8"], **kw)
    for name, (layout, src, entropy) in DECODE_CASES.items():
        out[name] = PB.decode_batch(out[src], mesh=meshes[layout],
                                    entropy=entropy)
    for name, (layout, op, arg) in COLLECTIVE_CASES.items():
        before = PM.XRANK_BYTES
        out[name] = run_collective(PM, meshes[layout], op, arg)
        out["xrank_bytes_" + name] = PM.XRANK_BYTES - before
    dist.destroy_process_group()
    leaked = [m for m in ("jax", "jpeg_tpu") if m in sys.modules]
    if leaked:
        raise RuntimeError(f"the worker imported {leaked}")
    with open(outdir / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    print(f"rank {rank} done", flush=True)


if __name__ == "__main__":
    main()
