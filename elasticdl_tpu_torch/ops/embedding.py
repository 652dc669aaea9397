"""Embedding lookup with a hand-written gradient placement.

Counterpart of `elasticdl_tpu/ops/embedding.py`, auto mode on one device.
The forward gather is a plain index (the reference's is `jnp.take`,
outside any kernel). The backward sorts the ids outside the kernel, as the
reference does, and places the dense table gradient with kernel K1
(`ops/placement.place_sorted_grads`) — on the CPU with its plain version.
The reference's strategy menu (`EDL_EMB_SCATTER`: tiled, unique, sorted
paths; window, dedupe and flat fallbacks) works around XLA and Mosaic on
the TPU and has no counterpart here: K1 takes any id distribution.

Table shapes are part of checkpoint geometry, so `padded_vocab` and
`geometry_descriptor` keep the reference's values exactly: converted
tables keep their row count.
"""

from __future__ import annotations

from typing import Optional

import torch

from elasticdl_tpu_torch.ops import placement

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


def _table_grad(ids: torch.Tensor, ct: torch.Tensor, num_rows: int,
                dtype: torch.dtype) -> torch.Tensor:
    """Dense (num_rows, D) gradient of a gather at `ids` with cotangent
    `ct` (..., D): ids flattened to int32 and the cotangent to float32,
    a stable sort outside the kernel, then K1."""
    flat = ids.reshape(-1).to(torch.int32)
    cf = ct.reshape(-1, ct.shape[-1]).to(torch.float32)
    if flat.numel() == 0:
        return torch.zeros((num_rows, ct.shape[-1]), dtype=dtype,
                           device=ct.device)
    sf, order = torch.sort(flat, stable=True)
    d_table = placement.place_sorted_grads(
        sf.contiguous(), cf[order].contiguous(), num_rows)
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


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor,
                     mode: str = "manual") -> torch.Tensor:
    """Rows of `table` (V, D) for `ids` (B, ...) -> (B, ..., D).
    Out-of-range ids return zero vectors (padding sentinels).

    On one device the reference's manual (shard_map) schedule falls back
    to auto; the port has one device per process so far and does the
    same for both modes."""
    if mode not in ("manual", "auto"):
        raise ValueError(f"unknown embedding lookup mode {mode!r}")
    in_range = (ids >= 0) & (ids < table.shape[0])
    safe_ids = torch.where(in_range, ids, OOB_ID).to(torch.int32)
    out = gather_rows(table, safe_ids)
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
