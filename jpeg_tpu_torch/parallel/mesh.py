"""The (batch, mcu) device mesh of the parallel layer, single-process.

Two mesh axes, as in jpeg_tpu.parallel.mesh:
  * ``batch``: data parallelism over independent images;
  * ``mcu``:   horizontal MCU stripes of one image: restart segments and DC
               predictor chains are the sequence being sharded.

jpeg_tpu runs one shard_map program over a jax Mesh from one process. The
port keeps that model: a Mesh is a (batch, mcu) grid of torch devices held
by one process, a sharded value is a grid of per-position tensors (a NumPy
object array of the mesh's shape), and the collectives of the per-stripe
programs are plain functions over such grids (ppermute, psum: a .to(device)
plus arithmetic). A position may repeat a device, as the reference's
virtual CPU devices do: the tests use eight positions on "cpu", and one card
holds a whole mesh of positions on "cuda:0". The per-position programs run
in a plain loop over the positions, each on its device's current stream.
"""

from __future__ import annotations

import numpy as np
import torch


class Mesh:
    """A (batch, mcu) grid of torch devices; ``shape`` is a dict, as on
    jax.sharding.Mesh."""

    axis_names = ("batch", "mcu")

    def __init__(self, devices):
        arr = np.array(devices, dtype=object)
        if arr.ndim != 2 or arr.size == 0:
            raise ValueError(f"a mesh needs a 2-D grid of devices, got "
                             f"shape {arr.shape}")
        self.devices = np.vectorize(torch.device, otypes=[object])(arr)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {sorted({str(d) for d in self.devices.flat})})"


def make_mesh(n_devices: int | None = None, batch_axis: int | None = None,
              devices=None) -> Mesh:
    """Build a (batch, mcu) mesh over the first n of `devices`.

    devices: the positions' devices (names or torch.device; one may repeat).
    None takes every CUDA device; with none present this raises: the mesh
    never falls back to the CPU. batch_axis: size of the data-parallel axis;
    defaults to the largest power-of-two divisor <= sqrt(n) so both axes get
    parallelism (jpeg_tpu's factorization)."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError(
                "make_mesh: no CUDA device; pass devices= (e.g. ['cpu'] * 8) "
                "for a mesh of CPU positions")
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = [torch.device(d) for d in devices]
    n = len(devices) if n_devices is None else n_devices
    if n > len(devices):
        raise ValueError(f"requested {n} devices, have {len(devices)}")
    if n < 1:
        raise ValueError(f"a mesh needs at least one device, got {n}")
    if batch_axis is None:
        batch_axis = 1
        while (
            batch_axis * 2 <= n // (batch_axis * 2)
            and n % (batch_axis * 2) == 0
        ):
            batch_axis *= 2
    if n % batch_axis:
        raise ValueError(f"{n} devices not divisible by batch axis {batch_axis}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(batch_axis, n // batch_axis))


def make_multihost_mesh(*args, **kwargs) -> Mesh:
    """The multi-process mesh (jpeg_tpu.parallel.mesh.make_multihost_mesh)
    is not ported yet: ROADMAP.md Queue 1 item 7 ports it on
    torch.distributed."""
    raise NotImplementedError(
        "make_multihost_mesh is not ported yet (ROADMAP.md Queue 1 item 7: "
        "the multi-process mesh on torch.distributed)")


def is_grid(x) -> bool:
    """A grid of per-position values: a 2-D NumPy object array."""
    return isinstance(x, np.ndarray) and x.dtype == object and x.ndim == 2


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to_host(x) -> np.ndarray:
    """A NumPy array of `x`: a tensor, an array, or a grid of per-position
    tensors split along dims 0 (batch) and 1 (mcu), which is assembled:
    each position's part is copied into its place in one array."""
    if not is_grid(x):
        return _to_numpy(x)
    row0 = np.cumsum([0] + [t.shape[0] for t in x[:, 0]])
    col0 = np.cumsum([0] + [t.shape[1] for t in x[0]])
    out = None
    for i, j in np.ndindex(x.shape):
        part = _to_numpy(x[i, j])
        if out is None:
            out = np.empty((row0[-1], col0[-1], *part.shape[2:]), part.dtype)
        out[row0[i]:row0[i + 1], col0[j]:col0[j + 1]] = part
    return out


def shard(x, mesh: Mesh):
    """Split `x` (a host array or a tensor) along dim 0 over the batch axis
    and dim 1 over the mcu axis: a grid of tensors, each on its position's
    device. The counterpart of jpeg_tpu's host_to_global with
    PartitionSpec("batch", "mcu"). A grid passes through unchanged."""
    if is_grid(x):
        if x.shape != mesh.devices.shape:
            raise ValueError(f"grid {x.shape} does not match mesh {mesh.shape}")
        return x
    dp, sp = mesh.devices.shape
    b, h = x.shape[0], x.shape[1]
    if b % dp or h % sp:
        raise ValueError(
            f"shape {tuple(x.shape)} does not split over mesh {mesh.shape}")
    bl, hl = b // dp, h // sp
    out = np.empty((dp, sp), dtype=object)
    for i in range(dp):
        # A batch row is contiguous on the host: it goes up in one copy to
        # the row's first position, and its stripes are cut there.
        row = x[i * bl:(i + 1) * bl]
        if not isinstance(row, torch.Tensor):
            row = torch.as_tensor(np.ascontiguousarray(row))
        row = row.to(mesh.devices[i, 0])
        for j in range(sp):
            out[i, j] = row[:, j * hl:(j + 1) * hl].to(mesh.devices[i, j])
    return out


def grid_map(fn, *grids):
    """fn applied at every position to the grids' values there: a grid."""
    out = np.empty(grids[0].shape, dtype=object)
    for idx in np.ndindex(out.shape):
        out[idx] = fn(*(g[idx] for g in grids))
    return out


def _axis_dim(axis: str) -> int:
    if axis not in Mesh.axis_names:
        raise ValueError(f"unknown mesh axis {axis!r}")
    return Mesh.axis_names.index(axis)


def ppermute(grid, axis: str, pairs):
    """jax.lax.ppermute over a grid: along `axis`, position `dst` receives
    position `src`'s tensor for every (src, dst) in `pairs` (a copy, on
    dst's device); a position that receives nothing gets zeros."""
    dim = _axis_dim(axis)
    out = np.empty(grid.shape, dtype=object)
    for idx in np.ndindex(grid.shape):
        out[idx] = torch.zeros_like(grid[idx])
    for src, dst in pairs:
        for other in range(grid.shape[1 - dim]):
            s = (src, other) if dim == 0 else (other, src)
            d = (dst, other) if dim == 0 else (other, dst)
            out[d] = grid[s].to(grid[d].device, copy=True)
    return out


def psum(grid, axes):
    """jax.lax.psum over a grid: every position gets the sum of the values
    of the positions that share its coordinates off `axes`, on its own
    device. Summed in position order."""
    if isinstance(axes, str):
        axes = (axes,)
    dims = {_axis_dim(a) for a in axes}
    out = np.empty(grid.shape, dtype=object)
    for idx in np.ndindex(grid.shape):
        members = [m for m in np.ndindex(grid.shape)
                   if all(m[k] == idx[k] for k in range(2) if k not in dims)]
        dev = grid[idx].device
        total = grid[members[0]].to(dev)
        for m in members[1:]:
            total = total + grid[m].to(dev)
        out[idx] = total
    return out
