"""Named mesh axes over the ranks of a `torch.distributed` world.

Counterpart of `elasticdl_tpu/parallel/mesh.py`. The reference lays its
devices out in a `jax.sharding.Mesh` and lets GSPMD insert the
collectives; here one process drives one device, so a mesh is the
world's ranks laid out row-major over named axes, with a process group
for each axis through this rank:

- the `data` axis carries the batch: a rank takes its contiguous block of
  the global batch (`batch_block`, `shard_batch`), and ranks that share a
  data coordinate take the same block;
- the `seq` axis carries the sequence: a leaf whose partition names it on
  its second dimension (the LM's tokens) is cut there too, to the rank's
  contiguous columns (`seq_block`); the ring and Ulysses attention of
  `ops/attention.py` exchange blocks over it (`ring_shift`,
  `all_to_all`), and every parameter is replicated over it, its gradient
  summed over data and seq;
- embedding tables are sharded by contiguous row ranges over every axis
  (`table_rows`), indexed by the rank's linear index over all axes,
  row-major — what `jax.lax.axis_index(axes)` gives the reference;
- a leaf of an expert, pipeline or tensor-parallel layer is cut along one
  dimension over one axis (`axis_rows`: experts over `expert`, stages
  over `pp`, Megatron's column and row splits over `model`) and
  replicated over the others;
- every other parameter is replicated.

The Megatron pair of autograd Functions joins a split layer to its
replicated neighbours: `copy_to_axis` (identity forward, all-reduce
backward) where a replicated tensor enters a split computation,
`reduce_from_axis` (all-reduce forward, identity backward) where its
partial sums leave it; `gather_from_axis` concatenates the ranks' slices
along a dimension and hands each rank its slice of the gradient.

A process with no process group, or a world of one rank, has a mesh of
size 1 with no group: every collective helper below is then the identity,
and the callers take their one-device paths, as the reference routes a
one-device mesh to its auto path.

Each rank drives one device, so `--mesh_shape` names as many devices as
the world has ranks; a plain worker (no world) given more than one device
raises (`build_job_mesh`). The hybrid multi-slice mesh
(`--dcn_mesh_shape`) is ROADMAP item 33.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from elasticdl_tpu_torch.common.constants import MeshAxis


@dataclass(frozen=True)
class RowShard:
    """Rows [start, stop) along dimension `dim` of a leaf that has `rows`
    of them: one rank's range. `axis` None: the range is indexed by the
    rank's linear index over every axis of the mesh (an embedding table,
    whose gradient the manual lookup makes whole on each rank); an axis
    name: by the rank's coordinate on that axis alone, the leaf
    replicated over the other axes (an expert, pipeline or
    tensor-parallel leaf, whose gradient the data axis sums)."""

    start: int
    stop: int
    rows: int
    dim: int = 0
    axis: Optional[str] = None

    @property
    def size(self) -> int:
        return self.stop - self.start


class Mesh:
    """Named axes over `ranks` (world ranks in row-major mesh order), as
    seen from the member `rank`. `group(axis)` is the process group of the
    ranks that differ from this one only along `axis` (None where the axis
    has size 1); `world` spans the whole mesh (None for a mesh of one)."""

    def __init__(self, axis_sizes: Dict[str, int], ranks: Sequence[int],
                 rank: int, groups: Dict[str, Any], world: Any):
        self.shape = dict(axis_sizes)
        self.axis_names = tuple(self.shape)
        self.ranks = tuple(ranks)
        self.index = self.ranks.index(rank)
        self.coords = dict(zip(
            self.axis_names,
            (int(c) for c in np.unravel_index(
                self.index, tuple(self.shape.values())))))
        self._groups = groups
        self.world = world

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def is_leader(self) -> bool:
        return self.index == 0

    def group(self, axis: str):
        return self._groups.get(axis)

    def axis_size(self, axis: str) -> int:
        """The axis's size; 1 for an axis the mesh does not have."""
        return self.shape.get(axis, 1)

    def rank_at(self, **coords: int) -> int:
        """The world rank whose coordinates are this rank's with `coords`
        put in."""
        at = dict(self.coords, **coords)
        return self.ranks[int(np.ravel_multi_index(
            tuple(at[a] for a in self.axis_names),
            tuple(self.shape.values())))]


def _world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def build_mesh(axis_sizes: Optional[Dict[str, int]] = None,
               ranks: Optional[Sequence[int]] = None) -> Optional[Mesh]:
    """A mesh over `ranks` (default: every rank of the world, or this
    process alone when there is no process group). `axis_sizes` maps axis
    name -> size, default every rank on `data`; their product must equal
    the number of ranks.

    Collective: every rank of the world calls it with the same arguments
    (process groups are created by all ranks, members or not). A rank
    outside `ranks` gets None."""
    world, me = _world()
    ranks = list(range(world) if ranks is None else ranks)
    if not axis_sizes:
        axis_sizes = {MeshAxis.DATA: len(ranks)}
    sizes = tuple(int(s) for s in axis_sizes.values())
    total = int(np.prod(sizes))
    if total != len(ranks) or not set(ranks) <= set(range(world)):
        raise ValueError(f"mesh {dict(axis_sizes)} needs {total} devices, "
                         f"have {len(ranks)} of a world of {world} "
                         "(one device a process)")
    grid = np.asarray(ranks).reshape(sizes)
    groups: Dict[str, Any] = {}
    for axis_i, name in enumerate(axis_sizes):
        if sizes[axis_i] == 1:
            continue
        # every line of ranks along this axis, in a fixed order on all
        # ranks: new_group is collective over the whole world
        lines = np.moveaxis(grid, axis_i, -1).reshape(-1, sizes[axis_i])
        for line in lines:
            group = dist.new_group([int(r) for r in line])
            if me in line:
                groups[name] = group
    mesh_world = None
    if total > 1:
        mesh_world = (dist.group.WORLD if total == world
                      else dist.new_group(ranks))
    if me not in ranks:
        return None
    return Mesh(dict(axis_sizes), ranks, me, groups, mesh_world)


def build_job_mesh(cfg) -> Mesh:
    """The mesh a job's config asks for, over the world's ranks: flat
    (`--mesh_shape`, or every rank on `data`). The single entry point of
    the worker and cohort paths."""
    if cfg.dcn_axes_sizes():
        raise NotImplementedError(
            "the hybrid multi-slice mesh (--dcn_mesh_shape) is ROADMAP "
            "item 33")
    world, _ = _world()
    sizes = None
    if cfg.mesh_shape:
        try:
            sizes = cfg.mesh_axes_sizes(world)
        except ValueError as e:
            raise ValueError(
                f"{e}: each process of the port drives one device, so a "
                "mesh of more devices needs a cohort of that many "
                "processes (--num_processes)") from e
    return build_mesh(sizes)


_MODEL_AXES = (MeshAxis.MODEL, MeshAxis.EXPERT, MeshAxis.PIPE, MeshAxis.SEQ)


def data_axis(mesh: Mesh) -> str:
    """The axis the batch is split over: `data`, else the mesh's first
    axis that is not a model-parallel one (as the reference takes its
    first axis), else `data` all the same, which the mesh then lacks
    (size 1: every rank holds the whole batch)."""
    if MeshAxis.DATA in mesh.axis_names:
        return MeshAxis.DATA
    return next((a for a in mesh.axis_names if a not in _MODEL_AXES),
                MeshAxis.DATA)


def shard_rows(index: int, count: int, rows: int) -> RowShard:
    """Range `index` of `count` over a `rows`-row table: ranges of
    ceil(rows / count) rows, so when count does not divide the rows the
    last ranges are short."""
    per = math.ceil(rows / count)
    start = min(rows, index * per)
    return RowShard(start, min(rows, start + per), rows)


def table_rows(mesh: Mesh, rows: int) -> RowShard:
    """This rank's row range of a `rows`-row table sharded over every
    axis, by the rank's linear index (the reference's `table_sharding`,
    whose shards are even)."""
    return shard_rows(mesh.index, mesh.size, rows)


def axis_rows(mesh: Mesh, axis: str, rows: int, dim: int = 0) -> RowShard:
    """This rank's equal part, along `dim`, of a leaf with `rows` entries
    there cut over `axis` (the whole leaf where the axis has size 1).
    Raises ValueError where the axis's size does not divide `rows`."""
    n = mesh.axis_size(axis)
    if rows % n:
        raise ValueError(f"{rows} entries along dim {dim} do not split "
                         f"evenly over mesh axis {axis!r} of size {n}")
    per = rows // n
    c = mesh.coords.get(axis, 0)
    return RowShard(c * per, (c + 1) * per, rows, dim, axis)


def batch_block(mesh: Mesh, batch_size: int) -> Tuple[int, int]:
    """Rows [start, stop) of a global batch that this rank takes: its
    contiguous block along the data axis."""
    d = mesh.axis_size(data_axis(mesh))
    if batch_size % d:
        raise ValueError(f"batch size {batch_size} is not a multiple of the "
                         f"data axis ({d})")
    per = batch_size // d
    c = mesh.coords.get(data_axis(mesh), 0)
    return c * per, (c + 1) * per


def seq_block(mesh: Mesh, length: int) -> Tuple[int, int]:
    """Columns [start, stop) of a sequence of `length` that this rank
    takes: its contiguous block along the `seq` axis (the whole sequence
    where the mesh has none)."""
    n = mesh.axis_size(MeshAxis.SEQ)
    if length % n:
        raise ValueError(f"sequence length {length} is not a multiple of "
                         f"the seq axis ({n})")
    per = length // n
    c = mesh.coords.get(MeshAxis.SEQ, 0)
    return c * per, (c + 1) * per


def cuts_seq(axes) -> bool:
    """Whether a leaf's partition (axis names, one a dimension) cuts its
    second dimension over `seq`."""
    return bool(axes) and len(axes) > 1 and axes[1] == MeshAxis.SEQ


def shard_batch(mesh: Mesh, batch: Any,
                partition: Optional[Dict[str, Sequence]] = None) -> Any:
    """This rank's block of every leaf of a global batch pytree (dicts,
    numpy arrays or tensors, None kept): the reference's `shard_batch` and
    `make_global_batch`, since every rank holds the whole batch. A leaf
    under a top-level key whose `partition` entry names `seq` on the
    second dimension is also cut there (`seq_block`). Views, not
    copies."""
    def cut(x, axes):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: cut(v, axes) for k, v in x.items()}
        start, stop = batch_block(mesh, x.shape[0])
        x = x[start:stop]
        if cuts_seq(axes):
            start, stop = seq_block(mesh, x.shape[1])
            x = x[:, start:stop]
        return x

    if isinstance(batch, dict):
        return {k: cut(v, (partition or {}).get(k))
                for k, v in batch.items()}
    return cut(batch, None)


# ---------------------------------------------------------------------- #
# collectives over one axis (the identity where the axis has size 1)


def all_gather(mesh: Mesh, axis: str, x: torch.Tensor,
               dim: int = 0) -> torch.Tensor:
    """Concatenate `x` of every rank along `axis`, in axis order, on
    dimension `dim`: (n, ...) into (size * n, ...) for dim 0."""
    group = mesh.group(axis)
    if group is None:
        return x
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((mesh.shape[axis] * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim)


def reduce_scatter(mesh: Mesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` (size * n, ...) over `axis`, this rank's block of n
    rows of it."""
    group = mesh.group(axis)
    if group is None:
        return x
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // mesh.shape[axis],) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=group)
    return out


def all_reduce(mesh: Mesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over `axis`, in place."""
    group = mesh.group(axis)
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


def gather_rows(mesh: Mesh, shard: torch.Tensor,
                rows: RowShard) -> Optional[torch.Tensor]:
    """The whole leaf on the mesh's leader from every rank's range along
    `rows.dim` (each range padded to ceil(rows / n) for the gather, then
    cut); None on every other rank. Collective over the mesh: every rank
    sends, and a leaf cut over one axis is taken from the ranks along
    that axis through the leader."""
    if mesh.world is None:
        return shard
    n = mesh.size if rows.axis is None else mesh.axis_size(rows.axis)
    per = math.ceil(rows.rows / n)
    part = shard.movedim(rows.dim, 0)
    padded = part.new_zeros((per,) + tuple(part.shape[1:]))
    padded[: rows.size] = part
    parts = ([torch.empty_like(padded) for _ in range(mesh.size)]
             if mesh.is_leader else None)
    dist.gather(padded, parts, dst=mesh.ranks[0], group=mesh.world)
    if not mesh.is_leader:
        return None
    if rows.axis is not None:
        # the leader's coordinates are all 0: its line along the axis
        parts = [parts[mesh.ranks.index(mesh.rank_at(**{rows.axis: c}))]
                 for c in range(n)]
    return torch.cat(parts)[: rows.rows].movedim(0, rows.dim).contiguous()


# ---------------------------------------------------------------------- #
# the Megatron pair, and a gather, over one axis (autograd Functions; the
# identity where the axis has size 1)


class _CopyToAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(ctx.mesh, ctx.axis, grad.contiguous().clone()), \
            None, None


class _ReduceFromAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(mesh, axis, x.contiguous().clone())

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _GatherFromAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.slice = (dim, mesh.coords[axis], x.shape[dim])
        parts = all_gather(mesh, axis, x.movedim(dim, 0))
        return parts.movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, grad):
        dim, c, size = ctx.slice
        return grad.narrow(dim, c * size, size), None, None, None


def copy_to_axis(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """`x` as it is; its gradient summed over `axis` (a replicated tensor
    entering a computation split over the axis, each rank's gradient
    partial)."""
    return _CopyToAxis.apply(x, mesh, axis)


def reduce_from_axis(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum of `x` over `axis` (partial sums leaving a split
    computation); the gradient reaches each rank as it is."""
    return _ReduceFromAxis.apply(x, mesh, axis)


def gather_from_axis(x: torch.Tensor, mesh: Mesh, axis: str,
                     dim: int) -> torch.Tensor:
    """The ranks' equal slices of `x` along `dim`, concatenated in axis
    order; each rank's gradient is its slice of the whole one's."""
    return _GatherFromAxis.apply(x, mesh, axis, dim % x.dim())


# ---------------------------------------------------------------------- #
# point-to-point and all-to-all exchanges over one axis (autograd
# Functions; each rank of the axis calls them alike)


def _shift(x: torch.Tensor, mesh: Mesh, axis: str, step: int) -> torch.Tensor:
    """Send `x` to the rank `step` places on along `axis` (mod its size)
    and receive the one from `step` places back, in one batch of
    point-to-point ops, so no order of posting can deadlock."""
    n, c = mesh.axis_size(axis), mesh.coords[axis]
    x = x.contiguous()
    out = torch.empty_like(x)
    group = mesh.group(axis)
    ops = [dist.P2POp(dist.isend, x, mesh.rank_at(**{axis: (c + step) % n}),
                      group),
           dist.P2POp(dist.irecv, out,
                      mesh.rank_at(**{axis: (c - step) % n}), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    """One step of a ring: every rank's `x` moves to the next rank along
    the axis. Backward: the gradient moves one step back (the transpose
    of `lax.ppermute`)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _shift(x, mesh, axis, 1)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.mesh, ctx.axis, -1), None, None


class _AllToAll(torch.autograd.Function):
    """`x` (n, ...) over an axis of n ranks: block j goes to the axis's
    rank j, and block j of the result came from rank j. The exchange is
    its own transpose, so the backward is the same exchange."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _exchange(x, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.mesh, ctx.axis), None, None


def _exchange(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=mesh.group(axis))
    return out


def ring_shift(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """`x` of the rank one place back along `axis` (coordinate - 1 mod
    n): every rank sends its own to the next, point to point. The
    gradient takes the way back."""
    return _RingShift.apply(x, mesh, axis)


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The axis's all-to-all over the leading dimension of `x` (n, ...),
    n the axis's size (`_AllToAll`); differentiable."""
    if x.shape[0] != mesh.axis_size(axis):
        raise ValueError(f"all_to_all over {axis!r} of size "
                         f"{mesh.axis_size(axis)} needs that many blocks, "
                         f"got {tuple(x.shape)}")
    return _AllToAll.apply(x, mesh, axis)


# ---------------------------------------------------------------------- #
# the batch block of a forward, for randomness drawn per example


_BLOCK: contextvars.ContextVar = contextvars.ContextVar(
    "edl_batch_block", default=None)
_COLUMNS: contextvars.ContextVar = contextvars.ContextVar(
    "edl_seq_columns", default=None)


@contextlib.contextmanager
def batch_block_of(batch_size: int, start: int, stop: int,
                   mesh: Optional[Mesh] = None,
                   columns: Optional[Tuple[int, int, int]] = None
                   ) -> Iterator[None]:
    """Within it, `batch_rand` draws for a global batch of `batch_size`
    rows and keeps rows [start, stop), and `sum_over_data` sums over
    `mesh`'s data axis: the trainer sets it around a forward on a rank's
    block, so a dropout mask and BatchNorm's statistics do not depend on
    the world's size (the reference's mask is one global array, and its
    batch statistics are the global batch's). `columns` (the global
    sequence length, start, stop), on a mesh with a `seq` axis: the
    rank's columns, which positions and per-token draws read
    (`seq_columns`) and which make `ops.attention`'s sequence-parallel
    attention exchange blocks over the axis."""
    token = _BLOCK.set((int(batch_size), int(start), int(stop), mesh))
    cols = _COLUMNS.set(None if columns is None
                        else tuple(int(c) for c in columns))
    try:
        yield
    finally:
        _COLUMNS.reset(cols)
        _BLOCK.reset(token)


def seq_columns() -> Optional[Tuple[int, int, int]]:
    """(global sequence length, start, stop) of this rank's columns inside
    `batch_block_of` with `columns`, else None."""
    return _COLUMNS.get()


class _SumOverData(torch.autograd.Function):
    """All-reduce (sum) over the data axis; its backward all-reduces the
    gradient, the transpose of a sum that every rank's loss reads."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_reduce(mesh, data_axis(mesh), x.clone())

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(ctx.mesh, data_axis(ctx.mesh), grad.clone()), None


def data_block():
    """(global rows, start, stop, mesh) inside `batch_block_of` with a
    mesh, else None."""
    block = _BLOCK.get()
    return block if block is not None and block[3] is not None else None


def in_data_parallel_block() -> bool:
    """Inside `batch_block_of` with a mesh."""
    block = _BLOCK.get()
    return block is not None and block[3] is not None


def sum_over_data(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(the sum of this rank's `x` over the data axis, differentiable; the
    global batch's rows), inside `batch_block_of` with a mesh."""
    rows, _, _, mesh = _BLOCK.get()
    return _SumOverData.apply(x, mesh), rows


def batch_rand(shape: Sequence[int], generator: Optional[torch.Generator],
               device) -> torch.Tensor:
    """`torch.rand(shape)` for a tensor whose first axis is the batch
    (and, on a `seq` mesh, whose second is the sequence). Inside
    `batch_block_of` it draws the global batch's values and returns this
    rank's rows (and columns), so every rank consumes the generator alike
    and its part equals the one-process draw's."""
    block = _BLOCK.get()
    if block is None:
        return torch.rand(tuple(shape), generator=generator, device=device)
    rows, start, stop, _ = block
    if shape[0] != stop - start:
        raise ValueError(f"batch_rand: shape {tuple(shape)} does not lead "
                         f"with the block's {stop - start} rows")
    shape = tuple(shape)
    cols = _COLUMNS.get()
    if cols is None:
        full = torch.rand((rows,) + shape[1:], generator=generator,
                          device=device)
        return full[start:stop]
    length, c0, c1 = cols
    if len(shape) < 2 or shape[1] != c1 - c0:
        raise ValueError(f"batch_rand: shape {shape} does not hold the "
                         f"block's {c1 - c0} columns second")
    full = torch.rand((rows, length) + shape[2:], generator=generator,
                      device=device)
    return full[start:stop, c0:c1]
