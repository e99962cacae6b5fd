"""The ('data', 'space') mesh of process ranks: data parallelism over
``torch.distributed``.

Counterpart of ``voxelmorph_tpu/parallel/mesh.py``. A ``Mesh`` is a grid of
the ranks of the default process group (one process per card) with the JAX
mesh's axis names and shape arithmetic; the batch is split over 'data' and
each rank holds its rows of every batched array (``shard_batch``), reads
the rest back with ``gather_batch`` and keeps its weights equal to rank 0's
(``replicate``). The 'space' axis (sharding the first spatial dim, which
needs a halo exchange around every conv and warp) is not ported:
``batch_sharding`` raises where it would be used.

Every rank of the world takes part in every collective, so a rank that the
batch leaves idle in JAX (``gcd(batch, n)`` ranks on 'data') holds the rows
of data slice ``rank % data``: each slice is held ``n / data`` times, and the
mean over all ranks equals the global batch's. Inside ``sharded_step`` (a
train step of the ``Trainer`` over more than one rank) random draws are made
at the global batch's shape and each rank keeps its rows (``draw_rows``),
and batch means are the global batch's (``batch_mean``), as in the JAX step,
which draws and reduces at the global shape and shards.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
import warnings
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["make_mesh", "make_mesh_for_batch", "batch_sharding", "replicated",
           "shard_batch", "replicate", "initialize_distributed", "gather_batch"]

SPATIAL_SHARDING = ("spatial sharding (a 'space' mesh axis > 1, --spatial-shard) is not "
                    "ported to voxelmorph_tpu_torch; it is the next slice of the port")


def world() -> Tuple[int, int]:
    """This process's rank and the world size of the default process group
    (``(0, 1)`` without one)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def initialize_distributed(coordinator: Optional[str] = None, num_processes: int = 1,
                           process_id: int = 0, device="cuda"):
    """Join a job of ``num_processes`` processes (a no-op for one).

    Calls ``torch.distributed.init_process_group`` with NCCL for ``cuda``
    and gloo for ``cpu``, at ``tcp://{coordinator}`` (the address of process
    0, ``host:port``; an address with a scheme, such as ``file://...``, is
    taken as it is), and on ``cuda`` makes card ``process_id % count`` the
    current device, one process per card. The train CLI exposes this as
    ``--coordinator``, ``--num-processes`` and ``--process-id``."""
    if num_processes <= 1:
        return
    if not coordinator:
        raise ValueError(f"a job of {num_processes} processes needs the coordinator's address")
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method=init,
                            world_size=num_processes, rank=process_id)


class Mesh:
    """A grid of process ranks with named axes (``('data', 'space')``).

    ``shape`` maps each axis name to its length, ``devices`` is the grid of
    ranks and ``axis_names`` the names. It needs no process group: a mesh of
    any list of ranks can be built and its arithmetic read in one process.
    """

    def __init__(self, devices, axis_names: Sequence[str] = ("data", "space")):
        self.devices = np.asarray(devices)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def data_index(self, rank: int) -> int:
        """The data slice whose rows ``rank`` holds: its row in the grid, or
        for a rank outside the grid (one the batch leaves idle),
        ``rank % data``."""
        where = np.argwhere(self.devices == rank)
        return int(where[0][0]) if len(where) else rank % self.shape["data"]

    def __repr__(self):
        return f"Mesh({self.shape}, devices={self.devices.tolist()})"


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              axis_names: Tuple[str, str] = ("data", "space"), devices=None) -> Mesh:
    """Create a ('data', 'space') mesh of ``devices`` (by default the ranks
    of the world, ``[0]`` without a process group).

    The default puts every rank on the data axis; ``shape=(d, s)`` asks for
    ``s``-way spatial sharding (``d * s`` must equal the number of ranks)."""
    devices = list(range(world()[1])) if devices is None else list(devices)
    n = len(devices)
    if shape is None:
        shape = (n, 1)
    assert shape[0] * shape[1] == n, f"mesh shape {shape} != device count {n}"
    return Mesh(np.asarray(devices).reshape(shape), axis_names)


def make_mesh_for_batch(batch_size: int, spatial_size: Optional[int] = None,
                        devices=None) -> Mesh:
    """Build a ('data', 'space') mesh adapted to a batch size, as the JAX
    package does: the data axis gets the largest rank count dividing the
    batch; the leftover ranks go to the space axis when they divide the
    first spatial dim (otherwise they are idle, and a warning says so)."""
    devices = list(range(world()[1])) if devices is None else list(devices)
    n = len(devices)
    data = math.gcd(batch_size, n)
    space = 1
    rest = n // data
    if spatial_size is not None and rest > 1 and spatial_size % rest == 0:
        space = rest
    used = devices[: data * space]
    if len(used) < n:
        warnings.warn(
            f"make_mesh_for_batch: using {len(used)} of {n} devices "
            f"(batch_size={batch_size} gives {data}-way data parallelism"
            + ("" if spatial_size is None else
               f", spatial_size={spatial_size} not divisible by {rest}")
            + "). Increase the batch size to a multiple of the device count, "
            "or pass spatial_size (--spatial-shard) to use the idle devices "
            "for spatial sharding.", stacklevel=2)
    return make_mesh(shape=(data, space), devices=used)


class Sharding:
    """How an array lies on a mesh: ``spec`` names the mesh axis each dim
    is split over (None: whole), as a ``PartitionSpec``; ``()`` is
    replicated. ``rows(batch)`` is the slice of dim 0 this rank holds."""

    def __init__(self, mesh: Mesh, spec: tuple):
        self.mesh = mesh
        self.spec = tuple(spec)

    def rows(self, batch: int, rank: Optional[int] = None) -> slice:
        if not self.spec or self.spec[0] is None:
            return slice(None)
        data = self.mesh.shape["data"]
        if batch % data:
            raise ValueError(f"a batch of {batch} does not split over {data} data ranks")
        per = batch // data
        i = self.mesh.data_index(world()[0] if rank is None else rank)
        return slice(i * per, (i + 1) * per)


def batch_sharding(mesh: Mesh, ndim: int, spatial: bool = False) -> Sharding:
    """The sharding of a batched array ``(B, *spatial, C)``: the batch over
    'data'. Sharding the first spatial dim over 'space' (``spatial`` on a
    mesh whose space axis is > 1) raises NotImplementedError."""
    if spatial and ndim >= 3 and mesh.shape.get("space", 1) > 1:
        raise NotImplementedError(SPATIAL_SHARDING)
    return Sharding(mesh, ("data",) + (None,) * (ndim - 1))


def replicated(mesh: Mesh) -> Sharding:
    """The sharding of an array that every rank holds whole."""
    return Sharding(mesh, ())


def _tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: Mesh, tree, spatial: bool = False, device="cuda"):
    """This rank's rows of each batched array of ``tree`` (numpy arrays or
    tensors; tuples, lists and dicts of them), as float32 tensors on
    ``device``. A tensor already there is sliced, not copied."""
    device = torch.device(device)

    def put(a):
        rows = batch_sharding(mesh, np.ndim(a), spatial=spatial).rows(int(np.shape(a)[0]))
        return torch.as_tensor(a if rows == slice(None) else a[rows], dtype=torch.float32,
                               device=device)

    return _tree_map(put, tree)


def replicate(mesh: Mesh, tree, device="cuda"):
    """``tree`` as tensors on ``device`` (tensors stay where they are),
    every rank's made equal to rank 0's (a broadcast, in place)."""
    device = torch.device(device)
    n = world()[1]

    def put(a):
        t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a), device=device)
        if n > 1:
            with torch.no_grad():
                dist.broadcast(t, src=0)
        return t

    return _tree_map(put, tree)


def gather_batch(mesh: Mesh, tree):
    """The whole batch of each array of ``tree`` that ``shard_batch`` split
    (this rank's rows): every data slice's rows, gathered from the ranks in
    rank order. Tensors stay on their device; ``.cpu()`` reads them."""
    n = world()[1]
    if n == 1:
        return tree
    owners = {}
    for r in range(n):
        owners.setdefault(mesh.data_index(r), r)
    order = [owners[i] for i in range(mesh.shape["data"])]

    def gather(t):
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t.contiguous())
        return torch.cat([parts[r] for r in order])

    return _tree_map(gather, tree)


class _SumAcrossRanks(torch.autograd.Function):
    """The sum of a tensor over the ranks, whose gradient is the sum of the
    ranks' cotangents (each rank's loss reaches every rank's input)."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


class _Step:
    def __init__(self, mesh: Mesh, batch: int):
        self.batch = batch
        self.rows = batch_sharding(mesh, 1).rows(batch)
        self.local = len(range(batch)[self.rows])
        self.world = world()[1]


_STEP: contextvars.ContextVar = contextvars.ContextVar("sharded_step", default=None)


@contextlib.contextmanager
def sharded_step(mesh: Mesh, batch: int):
    """A train step over ``mesh`` on a global batch of ``batch`` rows, of
    which this rank holds its own: inside, ``draw_rows`` and ``batch_mean``
    act on the global batch. A no-op on a world of one rank."""
    if world()[1] == 1:
        yield
        return
    token = _STEP.set(_Step(mesh, batch))
    try:
        yield
    finally:
        _STEP.reset(token)


def draw_rows(draw: Callable[[int], object], batch: int):
    """``draw(batch)``, random draws for ``batch`` samples; inside
    ``sharded_step``, ``batch`` being this rank's rows, the draws of the
    global batch's rows that this rank holds (every rank draws the global
    batch from a generator in step with the others', so the draws are
    those of one process at the global batch)."""
    step = _STEP.get()
    if step is None:
        return draw(batch)
    if batch != step.local:
        raise ValueError(f"a draw for {batch} samples in a sharded step whose rank holds "
                         f"{step.local} of {step.batch}")
    return draw(step.batch)[step.rows]


def batch_mean(x: torch.Tensor) -> Tuple[int, torch.Tensor]:
    """The number of samples and the mean over dim 0 of the batch ``x``;
    inside ``sharded_step``, of the global batch (an all-reduce, through
    which the gradient reaches every rank's rows)."""
    step = _STEP.get()
    if step is None:
        return x.shape[0], x.mean(dim=0)
    total = _SumAcrossRanks.apply(x.sum(dim=0))
    return step.batch, total / (step.local * step.world)
