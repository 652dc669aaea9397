"""Named mesh axes over the ranks of a `torch.distributed` world.

Counterpart of `elasticdl_tpu/parallel/mesh.py`. The reference lays its
devices out in a `jax.sharding.Mesh` and lets GSPMD insert the
collectives; here one process drives one device, so a mesh is the
world's ranks laid out row-major over named axes, with a process group
for each axis through this rank:

- the `data` axis carries the batch: a rank takes its contiguous block of
  the global batch (`batch_block`, `shard_batch`), and ranks that share a
  data coordinate take the same block;
- embedding tables are sharded by contiguous row ranges over every axis
  (`table_rows`), indexed by the rank's linear index over all axes,
  row-major — what `jax.lax.axis_index(axes)` gives the reference;
- dense parameters are replicated.

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
    """Rows [start, stop) of a table of `rows` rows: one rank's range."""

    start: int
    stop: int
    rows: int

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


def data_axis(mesh: Mesh) -> str:
    return (MeshAxis.DATA if MeshAxis.DATA in mesh.axis_names
            else mesh.axis_names[0])


def model_axis(mesh: Mesh) -> Optional[str]:
    return MeshAxis.MODEL if MeshAxis.MODEL in mesh.axis_names else None


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


def batch_block(mesh: Mesh, batch_size: int) -> Tuple[int, int]:
    """Rows [start, stop) of a global batch that this rank takes: its
    contiguous block along the data axis."""
    d = mesh.shape[data_axis(mesh)]
    if batch_size % d:
        raise ValueError(f"batch size {batch_size} is not a multiple of the "
                         f"data axis ({d})")
    per = batch_size // d
    c = mesh.coords[data_axis(mesh)]
    return c * per, (c + 1) * per


def shard_batch(mesh: Mesh, batch: Any) -> Any:
    """This rank's block of every leaf of a global batch pytree (dicts,
    numpy arrays or tensors, None kept): the reference's `shard_batch` and
    `make_global_batch`, since every rank holds the whole batch. Views,
    not copies."""
    if batch is None:
        return None
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    start, stop = batch_block(mesh, batch.shape[0])
    return batch[start:stop]


# ---------------------------------------------------------------------- #
# collectives over one axis (the identity where the axis has size 1)


def all_gather(mesh: Mesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """Concatenate `x` (n, ...) of every rank along `axis`, in axis order,
    into (size * n, ...)."""
    group = mesh.group(axis)
    if group is None:
        return x
    x = x.contiguous()
    out = x.new_empty((mesh.shape[axis] * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out


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
    """The whole table on the mesh's leader from every rank's row range
    (each range padded to ceil(rows / n) for the gather, then cut);
    None on every other rank. Collective over the mesh."""
    if mesh.world is None:
        return shard
    per = math.ceil(rows.rows / mesh.size)
    padded = shard.new_zeros((per,) + tuple(shard.shape[1:]))
    padded[: rows.size] = shard
    parts = ([torch.empty_like(padded) for _ in range(mesh.size)]
             if mesh.is_leader else None)
    dist.gather(padded, parts, dst=mesh.ranks[0], group=mesh.world)
    if not mesh.is_leader:
        return None
    return torch.cat(parts)[: rows.rows]


# ---------------------------------------------------------------------- #
# the batch block of a forward, for randomness drawn per example


_BLOCK: contextvars.ContextVar = contextvars.ContextVar(
    "edl_batch_block", default=None)


@contextlib.contextmanager
def batch_block_of(batch_size: int, start: int, stop: int,
                   mesh: Optional[Mesh] = None) -> Iterator[None]:
    """Within it, `batch_rand` draws for a global batch of `batch_size`
    rows and keeps rows [start, stop), and `sum_over_data` sums over
    `mesh`'s data axis: the trainer sets it around a forward on a rank's
    block, so a dropout mask and BatchNorm's statistics do not depend on
    the world's size (the reference's mask is one global array, and its
    batch statistics are the global batch's)."""
    token = _BLOCK.set((int(batch_size), int(start), int(stop), mesh))
    try:
        yield
    finally:
        _BLOCK.reset(token)


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
    """`torch.rand(shape)` for a tensor whose first axis is the batch.
    Inside `batch_block_of` it draws the global batch's values and
    returns this rank's rows, so every rank consumes the generator alike
    and the rows equal the one-process draw's."""
    block = _BLOCK.get()
    if block is None:
        return torch.rand(tuple(shape), generator=generator, device=device)
    rows, start, stop, _ = block
    if shape[0] != stop - start:
        raise ValueError(f"batch_rand: shape {tuple(shape)} does not lead "
                         f"with the block's {stop - start} rows")
    full = torch.rand((rows,) + tuple(shape[1:]), generator=generator,
                      device=device)
    return full[start:stop]
