"""The port's mesh layer across processes: 2 torch.distributed gloo ranks
on localhost, 4 CPU positions each (tests/torch_mp_worker.py), over the
global (2, 4) and (1, 8) meshes of make_multihost_mesh. The counterpart of
tests/test_multiprocess.py + tests/mp_worker.py.

Tolerances:
  - every result of rank 1 equals rank 0's exactly;
  - encode_batch and encode_mosaic bytes: equal to the port's
    single-process 8-position mesh and to jpeg_tpu.parallel on its 8
    virtual devices under jax_exact_sharded. Tolerance 0;
  - decode_batch pixels: exactly equal to the port's decode() per image;
    within 1 level in at most 0.5% of the samples of jpeg_tpu's
    decode_batch (tests/test_torch_parallel.py states why);
  - collectives (shard, ppermute, psum, to_host) across the rank boundary:
    equal to the same calls on the single-process mesh, and the bytes that
    cross ranks equal to what the parts weigh.
"""

import os
import pathlib
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from jpeg_tpu.parallel import batch as JB, mesh as JMesh, mosaic as JMo

import jpeg_tpu_torch
from jpeg_tpu_torch.parallel import batch as PB, mesh as PM, mosaic as PMo

import torch_mp_worker as W
from torch_port_util import cpu_mesh, jax_exact_sharded  # noqa: F401
from torch_port_util import jax_exact_transform  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
WORKER_TIMEOUT_S = 240
DIFF_SHARE = 0.005


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results: [rank 0's, rank 1's] {case name: result}."""
    outdir = tmp_path_factory.mktemp("torch_mp")
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["GLOO_SOCKET_IFNAME"] = "lo"  # the ranks meet on localhost
    procs = [
        subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "torch_mp_worker.py"),
             f"127.0.0.1:{port}", "2", str(rank), str(outdir)],
            env=env, cwd=str(REPO),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        pytest.fail("\n".join(
            f"rank {rank}: rc={p.returncode}\n{out[-3000:]}"
            for rank, (p, out) in enumerate(zip(procs, outs))))
    results = []
    for rank in range(2):
        with open(outdir / f"rank{rank}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


def _agreed(ranks, name):
    """The case's result, after checking that both ranks got it."""
    a, b = ranks[0][name], ranks[1][name]
    if isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b, f"{name}: rank 1 differs from rank 0"
    return a


def test_mesh_layout(ranks):
    """Rank-major positions: rank 0 holds batch row 0 of (2, 4) and
    stripes 0-3 of (1, 8); shard leaves None at the other rank's
    positions and puts each local part where the single-process mesh
    does."""
    want = {"2x4": np.repeat([[0], [1]], 4, axis=1),
            "1x8": np.repeat([[0, 1]], 4, axis=1)}
    x = W.grid_input()
    for layout, ba in W.LAYOUTS.items():
        one = PM.shard(x, cpu_mesh(8, ba))
        for rank in range(2):
            got = ranks[rank]
            np.testing.assert_array_equal(got["ranks_" + layout],
                                          want[layout])
            local = want[layout] == rank
            np.testing.assert_array_equal(got["shard_none_" + layout],
                                          ~local)
            parts = [one[idx].numpy().ravel() for idx in np.ndindex(one.shape)
                     if local[idx]]
            np.testing.assert_array_equal(got["shard_local_" + layout],
                                          np.concatenate(parts))


@pytest.mark.parametrize("name", sorted(W.COLLECTIVE_CASES))
def test_collectives_across_ranks(ranks, name):
    layout, op, arg = W.COLLECTIVE_CASES[name]
    got = _agreed(ranks, name)
    want = W.run_collective(PM, cpu_mesh(8, W.LAYOUTS[layout]), op, arg)
    np.testing.assert_array_equal(got, want)
    # What reached each rank from the other: the tensors of a ppermute that
    # cross the boundary, or the other rank's stack of group sums of a psum;
    # then the other rank's 4 parts of the to_host.
    part = W.grid_input().nbytes // 8
    groups = {"batch": 8 // W.LAYOUTS[layout], "mcu": W.LAYOUTS[layout]}
    crossing = {
        "ppermute_batch_down_2x4": (0, 4), "ppermute_batch_up_2x4": (4, 0),
        "ppermute_mcu_forward_1x8": (0, 1), "ppermute_mcu_back_1x8": (1, 0),
    }
    if op == "ppermute":
        want_parts = crossing[name]
    elif op == "psum":
        want_parts = (1 if isinstance(arg, tuple) else groups[arg],) * 2
    else:
        want_parts = (0, 0)
    assert ([r["xrank_bytes_" + name] for r in ranks]
            == [(n + 4) * part for n in want_parts])


@pytest.mark.parametrize("name", sorted(W.ENCODE_CASES))
def test_encode_batch_across_ranks(ranks, jax_exact_sharded, name):
    layout, src, kw = W.ENCODE_CASES[name]
    imgs = W.inputs()[src]
    got = _agreed(ranks, name)
    ba = W.LAYOUTS[layout]
    assert got == PB.encode_batch(imgs, quality=W.QUALITY,
                                  mesh=cpu_mesh(8, ba), **kw)
    assert got == JB.encode_batch(imgs, quality=W.QUALITY,
                                  mesh=JMesh.make_mesh(8, ba), **kw)


@pytest.mark.parametrize("name", sorted(W.MOSAIC_CASES))
def test_encode_mosaic_across_ranks(ranks, jax_exact_sharded, name):
    kw = W.MOSAIC_CASES[name]
    big = W.inputs()["big"]
    got = _agreed(ranks, name)
    assert got == PMo.encode_mosaic(big, quality=W.QUALITY,
                                    mesh=cpu_mesh(8, 1), **kw)
    assert got == JMo.encode_mosaic(big, quality=W.QUALITY,
                                    mesh=JMesh.make_mesh(8, 1), **kw)


@pytest.mark.parametrize("name", sorted(W.DECODE_CASES))
def test_decode_batch_across_ranks(ranks, name):
    layout, src, _ = W.DECODE_CASES[name]
    got = _agreed(ranks, name)
    jpgs = ranks[0][src]
    ref = np.stack([jpeg_tpu_torch.decode(j, device="cpu") for j in jpgs])
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)
    jax_px = JB.decode_batch(jpgs, mesh=JMesh.make_mesh(8, W.LAYOUTS[layout]))
    diff = np.abs(jax_px.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1
    assert (diff != 0).sum() <= DIFF_SHARE * diff.size


def test_world_of_one_rank_in_process():
    """make_multihost_mesh starting the group itself (coordinator_address,
    num_processes=1): the distributed collectives on one rank of 8 CPU
    positions give the single-process mesh's bytes and pixels."""
    import torch.distributed as dist

    imgs = W.inputs()["imgs"]
    mesh = PM.make_multihost_mesh(
        batch_axis=2, coordinator_address=f"127.0.0.1:{_free_port()}",
        num_processes=1, process_id=0, devices=["cpu"] * 8)
    try:
        assert mesh.shape == {"batch": 2, "mcu": 4}
        assert mesh.backend == "gloo" and mesh.rank == 0
        assert not mesh.ranks.any() and "rank 0 of 1, gloo" in repr(mesh)
        for kw in (dict(device_pack=True, optimize_tables=True),
                   dict(stripe_restart=False)):
            jpgs = PB.encode_batch(imgs, quality=W.QUALITY, mesh=mesh, **kw)
            assert jpgs == PB.encode_batch(imgs, quality=W.QUALITY,
                                           mesh=cpu_mesh(8, 2), **kw)
        np.testing.assert_array_equal(
            PB.decode_batch(jpgs, mesh=mesh),
            PB.decode_batch(jpgs, mesh=cpu_mesh(8, 2)))
    finally:
        dist.destroy_process_group()


def test_multihost_mesh_errors(monkeypatch):
    """No address and no initialized group; no devices= without CUDA (it
    never falls back to the CPU); NCCL on CPU positions."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no initialized"):
        PM.make_multihost_mesh(devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="NCCL needs every position"):
        PM.make_multihost_mesh(coordinator_address="127.0.0.1:1",
                               num_processes=1, process_id=0,
                               devices=["cpu"] * 4, backend="nccl")
    with pytest.raises(ValueError, match="unsupported backend"):
        PM.make_multihost_mesh(coordinator_address="127.0.0.1:1",
                               num_processes=1, process_id=0,
                               devices=["cpu"] * 4, backend="mpi")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PM.make_multihost_mesh(coordinator_address="127.0.0.1:1",
                               num_processes=1, process_id=0)
    assert not dist.is_initialized()
