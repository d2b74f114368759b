"""The (batch, mcu) device mesh of the parallel layer, in one process or
over the ranks of a torch.distributed process group.

Two mesh axes, as in jpeg_tpu.parallel.mesh:
  * ``batch``: data parallelism over independent images;
  * ``mcu``:   horizontal MCU stripes of one image: restart segments and DC
               predictor chains are the sequence being sharded.

jpeg_tpu runs one shard_map program over a jax Mesh. The port's Mesh is a
(batch, mcu) grid of torch devices, a sharded value is a grid of
per-position tensors (a NumPy object array of the mesh's shape), and the
collectives of the per-stripe programs are plain functions over such grids
(ppermute, psum, to_host). A position may repeat a device, as the
reference's virtual CPU devices do: the tests use eight positions on "cpu",
and one card holds a whole mesh of positions on "cuda:0". The per-position
programs run in a plain loop over the positions, each on its device's
current stream.

make_multihost_mesh spreads the grid over the ranks of the default
torch.distributed process group, one rank per process (the reference's
jax.distributed processes). Every rank holds the whole host input, runs the
programs of its own positions only (a grid holds None where another rank's
position is), and gets the whole host output: a ppermute pair between two
ranks is a send and a receive, psum one all_reduce, to_host one all_gather.
Under gloo every tensor that crosses ranks is staged through host memory;
under NCCL a rank's positions share one CUDA device, where the collectives
run. XRANK_BYTES counts the bytes that reach this rank from other ranks.
"""

from __future__ import annotations

import threading

import numpy as np
import torch
import torch.distributed as dist

# Bytes this rank received from other ranks since the last reset: a
# ppermute's tensors, the other ranks' terms of a psum and their parts of a
# to_host. Worker threads may use a mesh, so the increment holds a lock.
XRANK_BYTES = 0
_COUNT_LOCK = threading.Lock()


def _count_xrank(nbytes: int) -> None:
    global XRANK_BYTES
    with _COUNT_LOCK:
        XRANK_BYTES += nbytes


class Mesh:
    """A (batch, mcu) grid of torch devices (another rank's positions as
    that rank names them); ``shape`` is a dict, as on jax.sharding.Mesh.
    ``ranks`` is the grid of the ranks that hold the positions (all 0 in
    one process), ``rank`` this process's rank and ``backend`` the process
    group's ("gloo" or "nccl"; None: one process, no process group)."""

    axis_names = ("batch", "mcu")

    def __init__(self, devices, ranks=None, rank: int = 0,
                 backend: str | None = None):
        arr = np.array(devices, dtype=object)
        if arr.ndim != 2 or arr.size == 0:
            raise ValueError(f"a mesh needs a 2-D grid of devices, got "
                             f"shape {arr.shape}")
        self.devices = np.vectorize(torch.device, otypes=[object])(arr)
        self.ranks = np.zeros(arr.shape, dtype=np.int64)
        if ranks is not None:
            self.ranks[:] = np.reshape(ranks, arr.shape)
        self.rank = rank
        self.backend = backend

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def is_local(self, idx) -> bool:
        """Whether this process holds position `idx`."""
        return bool(self.ranks[idx] == self.rank)

    def local_positions(self) -> list:
        """This process's positions, in position order."""
        return [idx for idx in np.ndindex(self.ranks.shape)
                if self.ranks[idx] == self.rank]

    @property
    def comm_device(self) -> torch.device:
        """Where tensors that cross ranks are staged: host memory under
        gloo, the rank's one device under NCCL."""
        if self.backend == "nccl":
            return self.devices[self.local_positions()[0]]
        return torch.device("cpu")

    def __repr__(self) -> str:
        where = sorted({str(d) for d in self.devices.flat})
        if self.backend is None:
            return f"Mesh({self.shape}, {where})"
        return (f"Mesh({self.shape}, {where}, rank {self.rank} of "
                f"{int(self.ranks.max()) + 1}, {self.backend})")


def _device_list(devices, caller: str) -> list:
    """`devices` as torch.device objects; None takes every CUDA device and
    raises without one: a mesh never falls back to the CPU."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError(
                f"{caller}: no CUDA device; pass devices= (e.g. ['cpu'] * 8) "
                "for a mesh of CPU positions")
        devices = [torch.device("cuda", i) for i in range(count)]
    return [torch.device(d) for d in devices]


def _grid_shape(n: int, batch_axis: int | None) -> tuple:
    """(batch, mcu) of a mesh of n positions. batch_axis defaults to the
    largest power-of-two divisor <= sqrt(n), so both axes get parallelism
    (jpeg_tpu's factorization)."""
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
    return batch_axis, n // batch_axis


def make_mesh(n_devices: int | None = None, batch_axis: int | None = None,
              devices=None) -> Mesh:
    """Build a (batch, mcu) mesh over the first n of `devices`, held by
    this process alone.

    devices: the positions' devices (names or torch.device; one may repeat).
    None takes every CUDA device; with none present this raises: the mesh
    never falls back to the CPU. batch_axis: size of the data-parallel axis;
    defaults to the largest power-of-two divisor <= sqrt(n) so both axes get
    parallelism (jpeg_tpu's factorization)."""
    devices = _device_list(devices, "make_mesh")
    n = len(devices) if n_devices is None else n_devices
    if n > len(devices):
        raise ValueError(f"requested {n} devices, have {len(devices)}")
    shape = _grid_shape(n, batch_axis)
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(shape))


def make_multihost_mesh(batch_axis: int | None = None,
                        coordinator_address: str | None = None,
                        num_processes: int | None = None,
                        process_id: int | None = None,
                        devices=None, backend: str | None = None) -> Mesh:
    """A (batch, mcu) mesh over every rank of the default torch.distributed
    process group; call it once per process, on every rank in the same
    order.

    coordinator_address ("host:port"), num_processes and process_id start
    the group (init_process_group over tcp://); without an address the
    group must be initialized already, and its backend is taken. devices:
    this rank's positions (None: every CUDA device this process sees; none
    raises, the mesh never falls back to the CPU). backend: None picks
    "nccl" when the positions are CUDA devices and "gloo" otherwise; NCCL
    needs all of a rank's positions on one CUDA device (it refuses two
    ranks on one card; gloo takes them).

    The ranks exchange their positions; the global order is rank-major
    (rank 0's positions first), factorized as make_mesh does: with 2 ranks
    of 4 positions, (2, 4) gives rank 0 batch row 0 and (1, 8) gives it
    stripes 0-3."""
    local = _device_list(devices, "make_multihost_mesh")
    if coordinator_address is None and not dist.is_initialized():
        raise RuntimeError(
            "make_multihost_mesh: no coordinator_address and no initialized "
            "torch.distributed process group")
    if backend is None:
        backend = (dist.get_backend() if dist.is_initialized() else
                   "nccl" if all(d.type == "cuda" for d in local) else "gloo")
    if backend == "nccl":
        if len(set(local)) != 1 or local[0].type != "cuda":
            raise ValueError(
                f"NCCL needs every position of a rank on one CUDA device, "
                f"got {sorted({str(d) for d in local})}")
        torch.cuda.set_device(local[0])
    elif backend != "gloo":
        raise ValueError(f"unsupported backend {backend!r}")
    if coordinator_address is not None:
        dist.init_process_group(backend,
                                init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    elif dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, "
                         f"not {backend!r}")
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, [str(d) for d in local])
    shape = _grid_shape(sum(map(len, names)), batch_axis)
    ranks = [r for r, part in enumerate(names) for _ in part]
    arr = np.empty(len(ranks), dtype=object)
    arr[:] = [d for part in names for d in part]
    return Mesh(arr.reshape(shape), np.reshape(ranks, shape),
                rank=dist.get_rank(), backend=backend)


def is_grid(x) -> bool:
    """A grid of per-position values: a 2-D NumPy object array."""
    return isinstance(x, np.ndarray) and x.dtype == object and x.ndim == 2


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _owners(grid, mesh: Mesh | None):
    """(ranks grid, this rank) of a grid's positions: all local without a
    mesh."""
    if mesh is None:
        return np.zeros(grid.shape, dtype=np.int64), 0
    if grid.shape != mesh.devices.shape:
        raise ValueError(f"grid {grid.shape} does not match mesh {mesh.shape}")
    return mesh.ranks, mesh.rank


def _gathered_parts(x, mesh: Mesh):
    """Every position's part of the grid `x`, on every rank: one all_gather
    of each rank's parts stacked in position order (padded with zeros to
    the largest rank's count). Returns a function position -> tensor."""
    world = dist.get_world_size()
    comm = mesh.comm_device
    local = mesh.local_positions()
    stack = torch.stack([x[idx].to(comm) for idx in local])
    n_max = int(np.bincount(mesh.ranks.ravel(), minlength=world).max())
    if len(local) < n_max:
        pad = stack.new_zeros((n_max - len(local), *stack.shape[1:]))
        stack = torch.cat([stack, pad])
    bufs = [torch.empty_like(stack) for _ in range(world)]
    dist.all_gather(bufs, stack)
    _count_xrank(stack.nbytes * (world - 1))
    slot, seen = {}, [0] * world
    for idx in np.ndindex(x.shape):
        r = int(mesh.ranks[idx])
        slot[idx] = (r, seen[r])
        seen[r] += 1
    return lambda idx: bufs[slot[idx][0]][slot[idx][1]]


def to_host(x, mesh: Mesh | None = None) -> np.ndarray:
    """A NumPy array of `x`: a tensor, an array, or a grid of per-position
    tensors of one shape, split along dims 0 (batch) and 1 (mcu), which is
    assembled: each position's part is copied into its place in one array.
    On a mesh over several ranks (pass it) the parts are all-gathered first,
    so every rank gets the whole array."""
    if not is_grid(x):
        return _to_numpy(x)
    if mesh is not None and mesh.backend is not None:
        part_at = _gathered_parts(x, mesh)
    else:
        part_at = x.__getitem__
    out = None
    for i, j in np.ndindex(x.shape):
        part = _to_numpy(part_at((i, j)))
        if out is None:
            b, h = part.shape[:2]
            out = np.empty((x.shape[0] * b, x.shape[1] * h, *part.shape[2:]),
                           part.dtype)
        elif part.shape[:2] != (b, h):
            raise ValueError(f"grid parts differ in shape: {part.shape} at "
                             f"({i}, {j}), {(b, h)} at (0, 0)")
        out[i * b:(i + 1) * b, j * h:(j + 1) * h] = part
    return out


def shard(x, mesh: Mesh):
    """Split `x` (a host array or a tensor) along dim 0 over the batch axis
    and dim 1 over the mcu axis: a grid of tensors, each on its position's
    device, None at another rank's positions (every rank holds the whole
    `x`). The counterpart of jpeg_tpu's host_to_global with
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
        cols = [j for j in range(sp) if mesh.is_local((i, j))]
        if not cols:
            continue
        # A batch row's local stripes go up in one copy to its first local
        # position, and are cut there.
        j0 = cols[0]
        part = x[i * bl:(i + 1) * bl, j0 * hl:(cols[-1] + 1) * hl]
        if not isinstance(part, torch.Tensor):
            part = torch.as_tensor(np.ascontiguousarray(part))
        part = part.to(mesh.devices[i, j0])
        for j in cols:
            out[i, j] = part[:, (j - j0) * hl:(j - j0 + 1) * hl].to(
                mesh.devices[i, j])
    return out


def grid_map(fn, *grids):
    """fn applied at every local position to the grids' values there: a
    grid, None where the first grid holds None (another rank's position)."""
    out = np.empty(grids[0].shape, dtype=object)
    for idx in np.ndindex(out.shape):
        if grids[0][idx] is not None:
            out[idx] = fn(*(g[idx] for g in grids))
    return out


def _axis_dim(axis: str) -> int:
    if axis not in Mesh.axis_names:
        raise ValueError(f"unknown mesh axis {axis!r}")
    return Mesh.axis_names.index(axis)


def ppermute(grid, axis: str, pairs, mesh: Mesh | None = None):
    """jax.lax.ppermute over a grid: along `axis`, position `dst` receives
    position `src`'s tensor for every (src, dst) in `pairs` (a copy, on
    dst's device); a position that receives nothing gets zeros. Every
    position's tensor has one shape and dtype. On a mesh over several ranks
    (pass it) a pair between two ranks is a send and a receive, posted in
    one order on every rank and waited for together."""
    dim = _axis_dim(axis)
    ranks, me = _owners(grid, mesh)
    out = np.empty(grid.shape, dtype=object)
    for idx in np.ndindex(grid.shape):
        if ranks[idx] == me:
            out[idx] = torch.zeros_like(grid[idx])
    ops, landed = [], []
    for src, dst in pairs:
        for other in range(grid.shape[1 - dim]):
            s = (src, other) if dim == 0 else (other, src)
            d = (dst, other) if dim == 0 else (other, dst)
            tag = int(np.ravel_multi_index(d, grid.shape))
            if ranks[s] == me and ranks[d] == me:
                out[d] = grid[s].to(grid[d].device, copy=True)
            elif ranks[s] == me:
                ops.append(dist.P2POp(
                    dist.isend, grid[s].to(mesh.comm_device).contiguous(),
                    int(ranks[d]), tag=tag))
            elif ranks[d] == me:
                buf = torch.empty(grid[d].shape, dtype=grid[d].dtype,
                                  device=mesh.comm_device)
                ops.append(dist.P2POp(dist.irecv, buf, int(ranks[s]), tag=tag))
                landed.append((d, buf))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for d, buf in landed:
        out[d] = buf.to(grid[d].device)
        _count_xrank(buf.nbytes)
    return out


def psum(grid, axes, mesh: Mesh | None = None):
    """jax.lax.psum over a grid: every position gets the sum of the values
    of the positions that share its coordinates off `axes`, on its own
    device. Each group is summed in position order. On a mesh over several
    ranks (pass it) each rank sums its own members of every group, then one
    all_reduce adds the ranks' partial sums of all groups (exact for the
    integer histograms the layer sums)."""
    if isinstance(axes, str):
        axes = (axes,)
    dims = {_axis_dim(a) for a in axes}
    ranks, me = _owners(grid, mesh)

    def group(idx):
        return tuple(idx[k] for k in range(2) if k not in dims)

    totals = {}
    for idx in np.ndindex(grid.shape):
        if ranks[idx] == me:
            g = group(idx)
            totals[g] = (grid[idx] if g not in totals
                         else totals[g] + grid[idx].to(totals[g].device))
    if mesh is not None and mesh.backend is not None:
        keys = sorted({group(idx) for idx in np.ndindex(grid.shape)})
        comm = mesh.comm_device
        like = next(iter(totals.values()))
        stack = torch.stack([
            totals[g].to(comm) if g in totals
            else torch.zeros_like(like, device=comm) for g in keys])
        dist.all_reduce(stack)
        _count_xrank(stack.nbytes * (dist.get_world_size() - 1))
        totals = dict(zip(keys, stack))
    out = np.empty(grid.shape, dtype=object)
    for idx in np.ndindex(grid.shape):
        if ranks[idx] == me:
            out[idx] = totals[group(idx)].to(grid[idx].device, copy=True)
    return out
