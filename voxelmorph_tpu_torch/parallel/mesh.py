"""The ('data', 'space') mesh of process ranks: data parallelism and
spatial sharding over ``torch.distributed``.

Counterpart of ``voxelmorph_tpu/parallel/mesh.py``. A ``Mesh`` is a grid of
the ranks of the default process group (one process per card) with the JAX
mesh's axis names and shape arithmetic; the batch is split over 'data' and
each rank holds its rows of every batched array (``shard_batch``), reads
the rest back with ``gather_batch`` and keeps its weights equal to rank 0's
(``replicate``).

Every rank of the world takes part in every collective, so a rank that the
batch leaves idle in JAX (``gcd(batch, n)`` ranks on 'data') holds the rows
of data slice ``rank % data``: each slice is held ``n / data`` times, and the
mean over all ranks equals the global batch's. Inside ``sharded_step`` (a
train step of the ``Trainer`` over more than one rank) random draws are made
at the global batch's shape and each rank keeps its rows (``draw_rows``),
and batch means are the global batch's (``batch_mean``), as in the JAX step,
which draws and reduces at the global shape and shards.

The 'space' axis shards the first spatial dim of the volumes, as the JAX
package's GSPMD partitions it, with a layout of its own: each rank of a data
row holds one slab (``slab_bounds``), whose ends fall on multiples of
``align``, the product of the U-Net's pool windows, so that no pool or
upsampling straddles two ranks. ``shard_batch(spatial=True)`` cuts the
slabs and ``gather_batch(spatial=True)`` puts them back; ``shard_inputs``
cuts a model's inputs as the model takes them (its ``slab_inputs``). Inside
``spatial`` (a train step of the ``Trainer``, or a serving call) a model
runs its convolutional network on the slab, each conv on the slab widened
by one plane of each neighbour's (``halo_exchange``; zeros at the volume's
faces), and gathers the flow field (``gather_space``): the integration, the
warps and the losses then run on the whole field on every rank of the data
row. A tensor computed whole on every rank enters a slab network through
``slab_of``, the adjoint of ``gather_space``, so that every cotangent that
reaches a gather is whole and alike on the ranks of a row. The collectives
are differentiable and are built from ``all_reduce`` alone (each rank
writes its planes into its place in a zeroed buffer, which is summed), the
one collective that every backend takes on CUDA tensors; the space groups
are one process group per data row (``space_group``).

A model that takes a 'space' axis says how (the slab protocol, which the
``Trainer`` reads): ``slab_inputs``, the positions of the inputs that arrive
as slabs (volumes on its slab grid; every other input arrives whole);
``slab_depth`` and ``slab_align``, the first spatial dim of the volume it
cuts and the unit of its slabs; and ``whole_parameters()``, the parameters
it uses whole on every rank of a row, whose gradients are averaged over
'space' where every other parameter's, a slab's part, is summed.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
import warnings
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["make_mesh", "make_mesh_for_batch", "batch_sharding", "replicated",
           "shard_batch", "replicate", "initialize_distributed", "gather_batch"]


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

    def position(self, rank: int) -> Optional[Tuple[int, int]]:
        """``rank``'s (row, column) in the grid: its data slice and its
        place on the 'space' axis; None for a rank outside the grid."""
        where = np.argwhere(self.devices == rank)
        return (int(where[0][0]), int(where[0][1])) if len(where) else None

    def data_index(self, rank: int) -> int:
        """The data slice whose rows ``rank`` holds: its row in the grid, or
        for a rank outside the grid (one the batch leaves idle),
        ``rank % data``."""
        where = self.position(rank)
        return where[0] if where is not None else rank % self.shape["data"]

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


def slab_bounds(size: int, space: int, align: int = 1) -> List[Tuple[int, int]]:
    """The ``(start, stop)`` of each of ``space`` slabs of a first spatial
    dim of ``size`` planes: whole units of ``align`` planes, split as evenly
    as they go (the first slabs take one unit more), the planes past the
    last whole unit on the last slab. At 160 planes in units of 16: 80/80
    over 2 ranks, 48/48/32/32 over 4."""
    units = size // align
    if units < space:
        raise ValueError(
            f"a first spatial dim of {size} planes does not split into {space} slabs of "
            f"whole {align}-plane units (the U-Net's pool windows): spatial sharding "
            f"(--spatial-shard) over {space} ranks needs at least {space * align} planes")
    base, extra = divmod(units, space)
    bounds, start = [], 0
    for i in range(space):
        stop = start + (base + (i < extra)) * align
        bounds.append((start, stop))
        start = stop
    bounds[-1] = (bounds[-1][0], size)
    return bounds


class Sharding:
    """How an array lies on a mesh: ``spec`` names the mesh axis each dim
    is split over (None: whole), as a ``PartitionSpec``; ``()`` is
    replicated. ``rows(batch)`` is the slice of dim 0 this rank holds,
    ``slab(size)`` that of dim 1 (its ``slab_bounds`` in units of
    ``align``, where dim 1 is split over 'space')."""

    def __init__(self, mesh: Mesh, spec: tuple, align: int = 1):
        self.mesh = mesh
        self.spec = tuple(spec)
        self.align = align

    def rows(self, batch: int, rank: Optional[int] = None) -> slice:
        if not self.spec or self.spec[0] is None:
            return slice(None)
        data = self.mesh.shape["data"]
        if batch % data:
            raise ValueError(f"a batch of {batch} does not split over {data} data ranks")
        per = batch // data
        i = self.mesh.data_index(world()[0] if rank is None else rank)
        return slice(i * per, (i + 1) * per)

    def slab(self, size: int, rank: Optional[int] = None) -> slice:
        if self.spec[1:2] != ("space",):
            return slice(None)
        where = self.mesh.position(world()[0] if rank is None else rank)
        if where is None:
            raise ValueError("a mesh whose 'space' axis is > 1 holds every rank of the world")
        return slice(*slab_bounds(size, self.mesh.shape["space"], self.align)[where[1]])

    def index(self, shape, rank: Optional[int] = None) -> tuple:
        """The slices of an array of ``shape`` that this rank holds."""
        if not self.spec:
            return ()
        cut = (self.rows(int(shape[0]), rank),)
        if self.spec[1:2] == ("space",):
            cut += (self.slab(int(shape[1]), rank),)
        return cut


def batch_sharding(mesh: Mesh, ndim: int, spatial: bool = False, align: int = 1) -> Sharding:
    """The sharding of a batched array ``(B, *spatial, C)``: the batch over
    'data', and with ``spatial`` on a mesh whose 'space' axis is > 1 the
    first spatial dim over 'space', in slabs of whole ``align``-plane
    units."""
    spec = ["data"] + [None] * (ndim - 1)
    if spatial and ndim >= 3 and mesh.shape.get("space", 1) > 1:
        spec[1] = "space"
    return Sharding(mesh, tuple(spec), align)


def replicated(mesh: Mesh) -> Sharding:
    """The sharding of an array that every rank holds whole."""
    return Sharding(mesh, ())


def _tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: Mesh, tree, spatial: bool = False, device="cuda", align: int = 1):
    """This rank's part of each batched array of ``tree`` (numpy arrays or
    tensors; tuples, lists and dicts of them), as float32 tensors on
    ``device``: its rows, and with ``spatial`` its slab of the first spatial
    dim (``batch_sharding``; ``align``, the model's ``slab_align``). A
    tensor already there is sliced, not copied."""
    device = torch.device(device)

    def put(a):
        index = batch_sharding(mesh, np.ndim(a), spatial, align).index(np.shape(a))
        if all(cut == slice(None) for cut in index):
            index = ()
        return torch.as_tensor(a[index] if index else a, dtype=torch.float32, device=device)

    return _tree_map(put, tree)


def shard_inputs(mesh: Mesh, model, inputs, device="cuda"):
    """This rank's part of each of a model's ``inputs``: its rows, and on a
    mesh whose 'space' axis is > 1 its slab of each input the model takes
    as a slab (``model.slab_inputs``, in units of ``model.slab_align``);
    every other input whole."""
    slabbed = tuple(model.slab_inputs) if mesh.shape.get("space", 1) > 1 else ()
    align = model.slab_align if slabbed else 1
    return tuple(shard_batch(mesh, a, spatial=i in slabbed, device=device, align=align)
                 for i, a in enumerate(inputs))


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


def gather_batch(mesh: Mesh, tree, spatial: bool = False):
    """The whole batch of each array of ``tree`` that ``shard_batch`` split
    (this rank's rows, and with ``spatial`` its slab of the first spatial
    dim of an array of 3 dims or more): one all-reduce of a zeroed buffer
    of the whole array, into which the first rank holding each part writes
    it. Tensors stay on their device; ``.cpu()`` reads them."""
    rank, n = world()
    if n == 1:
        return tree
    where = mesh.position(rank)
    cut_space = spatial and mesh.shape.get("space", 1) > 1

    def gather(t):
        cut = cut_space and t.dim() >= 3
        shape, start = [t.shape[0] * mesh.shape["data"], *t.shape[1:]], 0
        if cut:
            # every rank's slab length, for the slabs' offsets
            lengths = torch.zeros(n, dtype=torch.int64, device=t.device)
            lengths[rank] = t.shape[1]
            dist.all_reduce(lengths)
            row = lengths.cpu()[torch.as_tensor(mesh.devices[where[0]])]
            shape[1], start = int(row.sum()), int(row[:where[1]].sum())
        buf = t.new_zeros(shape)
        if where is not None and (cut or where[1] == 0):
            part = buf[where[0] * t.shape[0]:(where[0] + 1) * t.shape[0]]
            (part.narrow(1, start, t.shape[1]) if cut else part).copy_(t)
        dist.all_reduce(buf)
        return buf

    with torch.no_grad():
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


# --- the 'space' axis ---------------------------------------------------------

def space_group(mesh: Mesh):
    """The process group of this rank's data row, the ranks that share its
    rows on the 'space' axis. The first call makes one group per row, every
    rank every group in the same order, so every rank makes it at the same
    point (the ``Trainer`` when it takes the mesh, or ``spatial``)."""
    rank, n = world()
    if mesh.size != n:
        raise ValueError(f"a mesh whose 'space' axis is > 1 holds every rank of the world: "
                         f"{mesh} in a world of {n}")
    groups = getattr(mesh, "_space_groups", None)
    if groups is None:
        groups = mesh._space_groups = [dist.new_group([int(r) for r in row])
                                       for row in mesh.devices]
    return groups[mesh.position(rank)[0]]


class Space:
    """This rank's place on the 'space' axis: ``size`` ranks of the group
    ``group``, this one at ``index``; inside a model's forward (``slabs``)
    also the volume's first spatial dim, ``depth`` planes, and this rank's
    slab of it, ``lo:hi``. ``all_reduce`` sums a buffer over the group."""

    def __init__(self, size: int, index: int, group=None, depth: Optional[int] = None,
                 align: int = 1):
        self.size, self.index, self.group = size, index, group
        self.depth = depth
        if depth is not None:
            self.lo, self.hi = slab_bounds(depth, size, align)[index]

    def all_reduce(self, buf: torch.Tensor) -> None:
        dist.all_reduce(buf, group=self.group)

    def extent(self, planes: int) -> Tuple[int, int]:
        """The first spatial dim's length and this slab's offset at a level
        of the U-Net where the slab has ``planes`` planes."""
        if self.depth is None:
            raise ValueError("spatial sharding splits the volume of a model's forward; "
                             "this rank's slab is known only inside one (slabs)")
        own = self.hi - self.lo
        return self.depth * planes // own, self.lo * planes // own


_SPACE: contextvars.ContextVar = contextvars.ContextVar("space", default=None)


def current_space() -> Optional[Space]:
    """The 'space' axis of the enclosing ``spatial``, or None."""
    return _SPACE.get()


@contextlib.contextmanager
def spatial(mesh: Mesh):
    """A forward over ``mesh``'s 'space' axis: inside, a model takes this
    rank's slabs of its ``slab_inputs`` (``shard_inputs``) and the rest
    whole, and returns outputs whole on every rank of its data row but
    ``unet_out``, a slab. A no-op where the 'space' axis is 1."""
    if mesh.shape.get("space", 1) == 1:
        yield
        return
    group = space_group(mesh)
    token = _SPACE.set(Space(mesh.shape["space"], mesh.position(world()[0])[1], group))
    try:
        yield
    finally:
        _SPACE.reset(token)


@contextlib.contextmanager
def slabs(depth: int, align: int):
    """Inside ``spatial``: a model's forward on a volume whose first spatial
    dim has ``depth`` planes, in slabs of whole ``align``-plane units;
    yields the ``Space`` that knows this rank's slab (None outside
    ``spatial``)."""
    space = _SPACE.get()
    if space is None:
        yield None
        return
    token = _SPACE.set(Space(space.size, space.index, space.group, depth, align))
    try:
        yield _SPACE.get()
    finally:
        _SPACE.reset(token)


def _layout(x: torch.Tensor):
    """x's memory layout: channels-last for a 5-D tensor whose channels are
    its innermost dim (a slice of a channels-last tensor too), else
    contiguous."""
    last = x.dim() == 5 and not x.is_contiguous() and x.stride(1) == 1
    return torch.channels_last_3d if last else torch.contiguous_format


def _empty_as(x: torch.Tensor, shape) -> torch.Tensor:
    """An empty tensor of ``shape`` in x's dtype, device and layout."""
    return torch.empty(shape, dtype=x.dtype, device=x.device, memory_format=_layout(x))


def _swap_faces(space: Space, x: torch.Tensor, width: int, dim: int, send_low, send_high):
    """Each rank's ``send_low`` (planes for the rank before it) and
    ``send_high`` (for the rank after it) delivered: one all-reduce of a
    zeroed buffer with two slots for each boundary between neighbours.
    Returns what the ranks before and after sent this one (None at a
    face of the volume)."""
    k, i = space.size, space.index
    face = list(x.shape)
    face[dim] = width
    buf = x.new_zeros((k - 1, 2, *face))
    if i < k - 1:
        buf[i, 0].copy_(send_high)
    if i > 0:
        buf[i - 1, 1].copy_(send_low)
    space.all_reduce(buf)
    return (buf[i - 1, 0] if i > 0 else None), (buf[i, 1] if i < k - 1 else None)


class _HaloExchange(torch.autograd.Function):
    """The slab widened by ``width`` planes of each neighbour's along
    ``dim`` (zeros at the volume's faces: SAME padding's zero); the
    backward sends the halo planes' cotangents to their owners, which add
    them to their own."""

    @staticmethod
    def forward(ctx, x, width, dim, space):
        n = x.shape[dim]
        if n < width:
            raise ValueError(f"a slab of {n} planes cannot lend a halo of {width}")
        ctx.width, ctx.dim, ctx.space = width, dim, space
        low, high = _swap_faces(space, x, width, dim, x.narrow(dim, 0, width),
                                x.narrow(dim, n - width, width))
        shape = list(x.shape)
        shape[dim] = n + 2 * width
        out = _empty_as(x, shape)
        out.narrow(dim, width, n).copy_(x)
        for part, start in ((low, 0), (high, n + width)):
            target = out.narrow(dim, start, width)
            target.zero_() if part is None else target.copy_(part)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        width, dim, space = ctx.width, ctx.dim, ctx.space
        n = g.shape[dim] - 2 * width
        low, high = _swap_faces(space, g.narrow(dim, width, n), width, dim,
                                g.narrow(dim, 0, width), g.narrow(dim, n + width, width))
        shape = list(g.shape)
        shape[dim] = n
        gx = _empty_as(g, shape)
        gx.copy_(g.narrow(dim, width, n))
        if low is not None:
            gx.narrow(dim, 0, width).add_(low)
        if high is not None:
            gx.narrow(dim, n - width, width).add_(high)
        return gx, None, None, None


def halo_exchange(x: torch.Tensor, width: int, dim: int,
                  space: Optional[Space] = None) -> torch.Tensor:
    """This rank's slab ``x`` widened along ``dim`` by ``width`` planes of
    each neighbour's on the 'space' axis (of ``space``, by default the
    enclosing ``spatial``'s), zeros at the volume's faces; differentiable.
    A channels-last 5-D slab gives a channels-last result."""
    return _HaloExchange.apply(x, width, dim, space or current_space())


class _DropHalo(torch.autograd.Function):
    """The inverse of the widening: ``width`` planes off each end of
    ``dim``; the backward pads the cotangent with zeros in its layout."""

    @staticmethod
    def forward(ctx, x, width, dim):
        ctx.width, ctx.dim, ctx.shape, ctx.layout = width, dim, x.shape, _layout(x)
        return x.narrow(dim, width, x.shape[dim] - 2 * width)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        gx = torch.empty(ctx.shape, dtype=g.dtype, device=g.device,
                         memory_format=ctx.layout).zero_()
        gx.narrow(ctx.dim, ctx.width, g.shape[ctx.dim]).copy_(g)
        return gx, None, None


def drop_halo(x: torch.Tensor, width: int, dim: int) -> torch.Tensor:
    """``x`` without ``width`` planes at each end of ``dim``: a SAME
    convolution's output on a ``halo_exchange``d slab, cut back to the
    slab; the cotangent keeps the layout of ``x``."""
    return _DropHalo.apply(x, width, dim)


class _GatherSpace(torch.autograd.Function):
    """The whole volume from the slabs of a data row; the backward keeps
    this rank's slab of the cotangent, which is whole and the same on every
    rank of the row where everything after the gather is computed alike on
    each."""

    @staticmethod
    def forward(ctx, x, dim, space, total, start):
        n = x.shape[dim]
        ctx.dim, ctx.start, ctx.n = dim, start, n
        shape = list(x.shape)
        shape[dim] = total
        buf = x.new_zeros(shape)
        buf.narrow(dim, start, n).copy_(x)
        space.all_reduce(buf)
        return buf

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.start, ctx.n), None, None, None, None


def gather_space(x: torch.Tensor, dim: int, space: Optional[Space] = None,
                 extent: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """The whole volume, on every rank of the data row, from each rank's
    slab ``x`` along ``dim`` (inside ``slabs``); differentiable under the
    rule that what follows is computed alike on every rank of the row.
    ``extent``, ``(total, start)``: the whole dim's length and this slab's
    offset, for parts that are not the ``slab_bounds`` of a level (a VALID
    convolution's output); by default ``space.extent``."""
    space = space or current_space()
    total, start = extent or space.extent(x.shape[dim])
    return _GatherSpace.apply(x, dim, space, total, start)


class _SlabOf(torch.autograd.Function):
    """This rank's planes ``lo:hi`` of a tensor whole and alike on every
    rank of the data row; the backward puts the ranks' slabs of the
    cotangent together, so that every rank gets the whole of it (the
    adjoint of ``_GatherSpace``)."""

    @staticmethod
    def forward(ctx, x, dim, lo, hi, space):
        ctx.dim, ctx.lo, ctx.shape, ctx.space = dim, lo, x.shape, space
        return x.narrow(dim, lo, hi - lo)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        buf = g.new_zeros(ctx.shape)
        buf.narrow(ctx.dim, ctx.lo, g.shape[ctx.dim]).copy_(g)
        ctx.space.all_reduce(buf)
        return buf, None, None, None, None


def slab_of(x: torch.Tensor, dim: int, align: int = 1,
            space: Optional[Space] = None) -> torch.Tensor:
    """This rank's slab along ``dim`` (``slab_bounds`` in units of
    ``align``) of ``x``, a tensor whole and alike on every rank of the data
    row (of ``space``, by default the enclosing ``spatial``'s; x itself
    outside one). Differentiable: every rank's input gets the whole
    cotangent, the sum of the ranks' slabs of it, so that what feeds x
    (parameters used whole on every rank) sees the gradient of one
    process."""
    space = space or current_space()
    if space is None:
        return x
    lo, hi = slab_bounds(x.shape[dim], space.size, align)[space.index]
    return _SlabOf.apply(x, dim, lo, hi, space)
