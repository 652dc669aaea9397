"""Embedding lookup with a hand-written gradient placement.

Counterpart of `elasticdl_tpu/ops/embedding.py`. The forward gather is a
plain index (the reference's is `jnp.take`, outside any kernel). The
backward sorts the ids outside the kernel, as the reference does, and
places the dense table gradient with kernel K1
(`ops/placement.place_sorted_grads`) — on the CPU with its plain version.
The reference's strategy menu (`EDL_EMB_SCATTER`: tiled, unique, sorted
paths; window, dedupe and flat fallbacks) works around XLA and Mosaic on
the TPU and has no counterpart here: K1 takes any id distribution.

Under a mesh (`parallel/mesh.py`) of more than one rank, a table is
sharded by contiguous row ranges over every axis and the lookup runs the
reference's manual schedule (its `shard_map` body, `embedding_lookup`
562-591): all-gather the ids over data, gather the owned rows
(`shard_part`, no collectives), reduce-scatter the sum over data, and
all-reduce over the other axes; the backward all-gathers the cotangent
over data and places the shard's gradient with K1 (`shard_part_grad`).
Ids the shard does not own map to `OOB_ID`, which K1 drops like any
out-of-range id. Only batch-shaped tensors cross ranks, so a table whose
rows the ranks do not divide keeps this schedule, with a short last
shard (the reference falls back to its auto partitioner there).

Table shapes are part of checkpoint geometry, so `padded_vocab` and
`geometry_descriptor` keep the reference's values exactly: converted
tables keep their row count.
"""

from __future__ import annotations

from typing import Optional

import torch

from elasticdl_tpu_torch.ops import placement
from elasticdl_tpu_torch.parallel import mesh as mesh_lib

# Table rows are padded to a multiple of VOCAB_ALIGN, and vocabularies of
# at least PALLAS_VOCAB_MIN rows to PALLAS_VOCAB_ALIGN (the reference's
# geometry v2; see elasticdl_tpu/ops/embedding.py).
VOCAB_ALIGN = 256
PALLAS_VOCAB_MIN = 64 * 1024
PALLAS_VOCAB_ALIGN = 8192

# Out-of-range ids are routed here: beyond every padded vocab, so the
# sorted backward stream carries them past the last real row and the
# placement drops them.
OOB_ID = (2**31 - 1) // 2


def padded_vocab(vocab_size: int, align: Optional[int] = None) -> int:
    if align is None:
        align = (PALLAS_VOCAB_ALIGN
                 if vocab_size >= PALLAS_VOCAB_MIN else VOCAB_ALIGN)
    return ((vocab_size + align - 1) // align) * align


def geometry_descriptor() -> dict:
    """The vocab-padding rule baked into embedding-table shapes, as data
    (identical to the reference's, so a checkpoint's recorded geometry
    means the same thing to both packages)."""
    return {
        "geometry_version": 2,
        "vocab_align": VOCAB_ALIGN,
        "pallas_vocab_align": PALLAS_VOCAB_ALIGN,
        "pallas_vocab_min": PALLAS_VOCAB_MIN,
    }


def sorted_stream(ids: torch.Tensor, ct: torch.Tensor):
    """K1's input for the gradient of a gather at `ids` with cotangent
    `ct` (..., D): the ids flattened to int32 in a stable ascending sort,
    and the cotangent's rows in float32 in the same order."""
    flat = ids.reshape(-1).to(torch.int32)
    cf = ct.reshape(-1, ct.shape[-1]).to(torch.float32)
    sf, order = torch.sort(flat, stable=True)
    return sf.contiguous(), cf[order].contiguous()


def _table_grad(ids: torch.Tensor, ct: torch.Tensor, num_rows: int,
                dtype: torch.dtype) -> torch.Tensor:
    """Dense (num_rows, D) gradient of a gather at `ids` with cotangent
    `ct` (..., D): the sorted stream, then K1 through its dispatcher op."""
    if ids.numel() == 0:
        return torch.zeros((num_rows, ct.shape[-1]), dtype=dtype,
                           device=ct.device)
    d_table = placement.place_sorted_grads_op(*sorted_stream(ids, ct),
                                             num_rows)
    return d_table.to(dtype)


class _GatherRows(torch.autograd.Function):
    """`table[ids]` with K1 in the backward. It saves only the ids, so
    under a checkpoint the recompute re-runs the gather alone; K1 runs
    once a backward either way."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(ids)
        ctx.num_rows = table.shape[0]
        ctx.table_dtype = table.dtype
        # gather at a clamped index: an out-of-range id on CUDA would
        # raise a device-side assert, where jnp.take tolerates it. The
        # backward keeps the raw id, so the placement drops it.
        safe = ids.to(torch.int64).clamp(0, table.shape[0] - 1)
        return table[safe]

    @staticmethod
    def backward(ctx, ct: torch.Tensor):
        (ids,) = ctx.saved_tensors
        return _table_grad(ids, ct, ctx.num_rows, ctx.table_dtype), None


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """`table[ids]` whose backward is the dense K1 placement.

    Ids outside [0, table rows) read a clamped row and receive no
    gradient; `embedding_lookup` zeroes their vectors."""
    return _GatherRows.apply(table, ids)


def scatter_add_dense(ids: torch.Tensor, rows: torch.Tensor, num_rows: int,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Dense (num_rows, D) sum of `rows` placed at `ids` (duplicates add;
    out-of-range ids, negative or >= num_rows, drop) — `gather_rows`'s
    backward applied to an explicit cotangent."""
    ids = ids.reshape(-1).to(torch.int32)
    rows = rows.reshape(-1, rows.shape[-1])
    in_range = (ids >= 0) & (ids < num_rows)
    safe_ids = torch.where(in_range, ids, OOB_ID)
    rows = torch.where(in_range[:, None], rows, 0)
    return _table_grad(safe_ids, rows, num_rows, dtype)


def shard_ids(all_ids: torch.Tensor, row_start: int, shard_rows: int):
    """(ids local to the shard of rows [row_start, row_start +
    shard_rows), as int32, OOB_ID where the shard does not own them; the
    owned mask)."""
    local = all_ids.to(torch.int64) - row_start
    owned = (local >= 0) & (local < shard_rows)
    return torch.where(owned, local, OOB_ID).to(torch.int32), owned


def shard_part(table_shard: torch.Tensor, all_ids: torch.Tensor,
               row_start: int) -> torch.Tensor:
    """The per-rank compute of the manual schedule, with no collectives:
    for `all_ids` (B, L) of the whole batch, the rows of `table_shard`
    (the table's rows [row_start, row_start + n)) for the ids it owns and
    zero vectors for the rest, (B, L, D). The sum over every shard's part
    is the one-device gather."""
    local, owned = shard_ids(all_ids, row_start, table_shard.shape[0])
    if table_shard.shape[0] == 0:
        return table_shard.new_zeros(tuple(all_ids.shape)
                                     + (table_shard.shape[1],))
    rows = table_shard[local.to(torch.int64).clamp(0, table_shard.shape[0] - 1)]
    return torch.where(owned[..., None], rows, 0)


def shard_part_grad(all_ids: torch.Tensor, ct: torch.Tensor, row_start: int,
                    shard_rows: int,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The per-rank backward: the (shard_rows, D) gradient of `shard_part`
    for the cotangent `ct` (B, L, D) of the whole batch, placed by K1.
    Ids the shard does not own go to OOB_ID, which K1 drops."""
    local, _ = shard_ids(all_ids, row_start, shard_rows)
    return _table_grad(local, ct, shard_rows, dtype)


class _ShardedLookup(torch.autograd.Function):
    """The manual schedule on one rank: (table shard, this rank's ids
    (B/d, L)) -> this rank's vectors (B/d, L, D). The backward is its
    exact transpose."""

    @staticmethod
    def forward(ctx, table_shard, ids, mesh, rows: mesh_lib.RowShard):
        data = mesh_lib.data_axis(mesh)
        all_ids = mesh_lib.all_gather(mesh, data, ids)          # (B, L)
        part = shard_part(table_shard, all_ids, rows.start)     # (B, L, D)
        out = mesh_lib.reduce_scatter(mesh, data, part)         # (B/d, L, D)
        for axis in mesh.axis_names:
            if axis != data:
                mesh_lib.all_reduce(mesh, axis, out)
        ctx.save_for_backward(all_ids)
        ctx.mesh, ctx.rows = mesh, rows
        ctx.table_dtype = table_shard.dtype
        return out

    @staticmethod
    def backward(ctx, ct):
        (all_ids,) = ctx.saved_tensors
        # every rank along the other axes holds the same output and its
        # cotangent: the transpose of their sum hands each its own copy
        all_ct = mesh_lib.all_gather(ctx.mesh, mesh_lib.data_axis(ctx.mesh),
                                     ct)
        d_shard = shard_part_grad(all_ids, all_ct, ctx.rows.start,
                                  ctx.rows.size, ctx.table_dtype)
        return d_shard, None, None, None


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor,
                     mode: str = "manual", mesh: Optional[mesh_lib.Mesh] = None,
                     rows: Optional[mesh_lib.RowShard] = None) -> torch.Tensor:
    """Rows of `table` for `ids` (B, ...) -> (B, ..., D). Out-of-range
    ids return zero vectors (padding sentinels).

    With a `mesh` of more than one rank, `table` is this rank's row range
    `rows` of the whole table, `ids` this rank's block of the batch, and
    the lookup runs the manual schedule (both modes: the reference's auto
    mode is GSPMD's partitioning of the same gather). Without one, or on
    a one-rank mesh, it gathers from the whole table, as the reference
    routes a one-device mesh to auto."""
    if mode not in ("manual", "auto"):
        raise ValueError(f"unknown embedding lookup mode {mode!r}")
    num_rows = rows.rows if rows is not None else table.shape[0]
    in_range = (ids >= 0) & (ids < num_rows)
    safe_ids = torch.where(in_range, ids, OOB_ID).to(torch.int32)
    if mesh is None or mesh.size == 1:
        out = gather_rows(table, safe_ids)
    else:
        ids2d = safe_ids.reshape(safe_ids.shape[0], -1)
        out = _ShardedLookup.apply(table, ids2d, mesh, rows).reshape(
            *safe_ids.shape, table.shape[1])
    return torch.where(in_range[..., None], out, 0)


def combine(vectors: torch.Tensor, combiner: Optional[str], ids: torch.Tensor,
            weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bag-combine (B, L, D) lookups over L. Pad slots are marked by
    negative ids. combiner: None -> (B, L, D); 'sum'|'mean'|'sqrtn' ->
    (B, D)."""
    if combiner is None:
        return vectors
    valid = (ids >= 0).to(vectors.dtype)
    w = valid if weights is None else weights.to(vectors.dtype) * valid
    s = torch.sum(vectors * w[..., None], dim=-2)
    if combiner == "sum":
        return s
    denom = torch.sum(w, dim=-1, keepdim=True)
    if combiner == "mean":
        return s / torch.clamp_min(denom, 1e-9)
    if combiner == "sqrtn":
        return s / torch.sqrt(torch.clamp_min(denom, 1e-9))
    raise ValueError(f"unknown combiner {combiner!r}")
