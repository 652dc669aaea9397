"""Switch-style top-1 Mixture-of-Experts over flat tokens.

Counterpart of `elasticdl_tpu/ops/moe.py`. The routing is the
reference's, step for step:

- the router is float32: logits = x.f32 @ wg.f32, softmax, argmax (the
  first expert on ties), and the gate is the chosen expert's probability;
- each token's slot in its expert's buffer is its arrival order (a cumsum
  over the tokens), and the capacity is max(1, int(capacity_factor * N /
  E)) with Python's `int`; a token past it is dropped and gets 0 (the
  caller's residual carries it);
- the expert FFN is float32, gelu is the tanh form, and the output is
  cast back to x's dtype;
- the auxiliary load-balancing loss is E * sum_e(fraction_e *
  mean router probability_e) (Switch Transformer, eq. 4).

Two routes to the same (E, Cap, C) buffers:

- `switch_moe_plain` is the reference's dense dispatch: a (N, E, Cap)
  one-hot mask and the dispatch and combine einsums;
- `switch_moe`, the layer's route, fills the buffers by index: each kept
  token's row is copied into its (expert, slot), and each output row
  gathers its slot's row times its gate. Every output of the dense
  einsums is a sum with exactly one nonzero term, so the two routes give
  the same outputs bit for bit (signed zeros aside), and the same
  gradients of the expert kernels; the other gradients (tokens, router,
  gate, the last bias) differ only in the order of their sums. The index
  route skips the 2 N E Cap C multiply-adds of each one-hot product.

Both run the expert FFN as two batched matmuls (`_expert_ffn`), as the
reference's einsums do outside any kernel.

Under a mesh the routing is the global batch's, as the reference's GSPMD
program computes it over the (B, T) tokens flattened row-major: inside
the trainer's `parallel.mesh.batch_block_of` a rank holds its (rows,
columns) block of the tokens, a block of rows over data and of columns
over `seq` (`Blocks`), so the capacity counts the global batch's B T
tokens, each expert's slots continue the counts of the tokens before
them in that order (`block_slots`: every token of the earlier data
blocks, the earlier rows of this data block over all column blocks, the
same row's earlier column blocks; an all-gather of per-row counts over
seq and of totals over data), and the aux loss's fractions and mean
probabilities are the global batch's (a sum over data and seq). The
counts reach `route` through `Blocks`' functions, so one process can
route simulated blocks with the code a mesh runs (`blocks_local`, the
card's and the CPU test's check). With `experts` (an `expert` axis:
`expert_range`) a rank holds only its experts' weights; tokens are
replicated over the axis, so each rank fills its experts' slots,
combines its part of the output and the parts are summed over the axis.
Only token-sized tensors cross the mesh: the summed output, and in the
backward the gradients of the tokens and of the gates
(`parallel.mesh.copy_to_axis`), whose parts are partial.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from elasticdl_tpu_torch.common.constants import MeshAxis
from elasticdl_tpu_torch.parallel import mesh as mesh_lib

EXPERT_AXIS = MeshAxis.EXPERT


class Routing(NamedTuple):
    probs: torch.Tensor     # (N, E) float32
    idx: torch.Tensor       # (N,) chosen expert
    gate: torch.Tensor      # (N,) its probability
    pos: torch.Tensor       # (N,) slot in the expert's buffer
    keep: torch.Tensor      # (N,) slot < capacity
    cap: int
    aux: torch.Tensor       # () float32


def expert_range(mesh: mesh_lib.Mesh, num_experts: int) -> mesh_lib.RowShard:
    """This rank's experts on the mesh's `expert` axis (all of them where
    it has none): the counterpart of the reference's
    `expert_partition_names`, whose leaves shard over that axis only when
    the mesh has it."""
    return mesh_lib.axis_rows(mesh, EXPERT_AXIS, num_experts)


class Blocks(NamedTuple):
    """Where a rank's tokens sit in the global (B, T) batch: its `rows`
    of the batch and a block of columns, the `seq_index`-th over the
    `seq` axis, in the `data_index`-th block of rows over data; `tokens`
    is B T. Its tokens come flattened row-major over (rows, columns), as
    the reference flattens the whole batch. `gather_seq` takes this
    block's per-row expert counts (rows, E) to those of every column
    block of these rows (S, rows, E); `gather_data` takes this data
    block's expert totals (E,) to every data block's (D, E); `sum_blocks`
    takes a float (E,) to its sum over every block, differentiably."""
    tokens: int
    rows: int
    seq_index: int
    data_index: int
    gather_seq: Callable[[torch.Tensor], torch.Tensor]
    gather_data: Callable[[torch.Tensor], torch.Tensor]
    sum_blocks: Callable[[torch.Tensor], torch.Tensor]


def mesh_blocks(n_local: int) -> Optional[Blocks]:
    """The `Blocks` of this rank's `n_local` tokens inside the trainer's
    `batch_block_of` with a mesh (None outside it): its gathers run over
    the mesh's `seq` and data axes."""
    block = mesh_lib.data_block()
    if block is None:
        return None
    rows, start, stop, mesh = block
    cols = mesh_lib.seq_columns()
    length = n_local // (stop - start) if cols is None else cols[0]
    data = mesh_lib.data_axis(mesh)
    return Blocks(
        tokens=rows * length, rows=stop - start,
        seq_index=mesh.coords.get(MeshAxis.SEQ, 0),
        data_index=mesh.coords.get(data, 0),
        gather_seq=lambda c: mesh_lib.all_gather(mesh, MeshAxis.SEQ, c[None]),
        gather_data=lambda c: mesh_lib.all_gather(mesh, data, c[None]),
        sum_blocks=mesh_lib.sum_over_batch)


def block_slots(idx: torch.Tensor, seq_counts: torch.Tensor,
                seq_index: int, before: torch.Tensor) -> torch.Tensor:
    """Each token's slot in its expert's buffer: its arrival order among
    the global batch's tokens routed to the same expert, the batch
    flattened row-major. idx (rows L,): this block's chosen experts, its
    (rows, L) tokens row-major; seq_counts (S, rows, E): the tokens each
    expert got in each row of each column block of these rows (this
    block's at `seq_index`); before (E,): the tokens each expert got in
    the earlier data blocks. A token (b, t) comes after those, after rows
    r0 .. b - 1 of every column block, after row b of the earlier column
    blocks, and after the earlier tokens of its own row here. Integers,
    so exact."""
    _, rows, e = seq_counts.shape
    whole = seq_counts.sum(0)                                  # (rows, E)
    offset = (before[None] + torch.cumsum(whole, 0) - whole
              + seq_counts[:seq_index].sum(0))                 # (rows, E)
    # the scan runs along the contiguous axis of (E, rows, L)
    onehot = F.one_hot(idx, e).t().contiguous().view(e, rows, -1)
    arrived = torch.cumsum(onehot, dim=2) + offset.t()[:, :, None]
    return arrived.view(e, -1).gather(0, idx[None])[0] - 1


def _router(x: torch.Tensor, wg: torch.Tensor):
    """(probs, chosen expert, its probability) of the tokens x (N, C)."""
    logits = x.to(torch.float32) @ wg.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    idx = torch.argmax(probs, dim=-1)
    return probs, idx, probs.gather(1, idx[:, None])[:, 0]


def route(x: torch.Tensor, wg: torch.Tensor, capacity_factor: float,
          blocks: Optional[Blocks] = None) -> Routing:
    """Top-1 routing of the tokens x (N, C) by the router wg (C, E). With
    `blocks` (by default the trainer's mesh block, `mesh_blocks`) x is
    one block of the global batch, and the routing is the global batch's
    (module docstring): the capacity counts its B T tokens, the slots
    follow its row-major order (`block_slots`), and the aux loss is its
    own."""
    e = wg.shape[1]
    probs, idx, gate = _router(x, wg)
    blocks = blocks or mesh_blocks(x.shape[0])
    if blocks is None:
        n, prob_sum = x.shape[0], probs.sum(0)
        # arrival order by expert: the scan runs along the contiguous axis
        # of (E, N) (down the N rows of (N, E) it is one thread a column)
        arrived = torch.cumsum(F.one_hot(idx, e).t().contiguous(), dim=1)
        pos = arrived.gather(0, idx[None])[0] - 1
        counts = arrived[:, -1]
    else:
        n = blocks.tokens
        per_row = F.one_hot(idx, e).view(blocks.rows, -1, e).sum(1)
        seq_counts = blocks.gather_seq(per_row)             # (S, rows, E)
        totals = blocks.gather_data(seq_counts.sum((0, 1)))  # (D, E)
        pos = block_slots(idx, seq_counts, blocks.seq_index,
                          totals[:blocks.data_index].sum(0))
        counts = totals.sum(0)
        prob_sum = blocks.sum_blocks(probs.sum(0))
    # symbolic where n is (a traced batch): `int` would specialize it
    cap = torch.sym_max(1, torch.sym_int(capacity_factor * n / e))
    keep = pos < cap
    aux = e * torch.sum((counts.to(torch.float32) / n) * (prob_sum / n))
    return Routing(probs, idx, gate, pos, keep, cap, aux)


def blocks_local(x: torch.Tensor, wg: torch.Tensor, data: int,
                 seq: int) -> List[Tuple[torch.Tensor, Blocks]]:
    """The (data, seq) blocks of the (B, T, C) tokens x in this process,
    in row-major order: each block's tokens (flat, row-major) and its
    `Blocks`, whose functions hand over the counts and the probability
    sums that a mesh's gathers would bring (each block's own router,
    `_router`), so `route` and `switch_moe` run on each block as they
    run on a rank of a {data, seq} mesh."""
    b, t, c = x.shape
    if b % data or t % seq:
        raise ValueError(f"tokens {tuple(x.shape)} do not split into "
                         f"{data} x {seq} blocks")
    rows, cols, e = b // data, t // seq, wg.shape[1]
    parts = [[x[d * rows:(d + 1) * rows, s * cols:(s + 1) * cols]
              .reshape(-1, c) for s in range(seq)] for d in range(data)]
    routed = [[_router(p, wg) for p in line] for line in parts]
    per_row = [torch.stack([F.one_hot(idx, e).view(rows, -1, e).sum(1)
                            for _, idx, _ in line]) for line in routed]
    totals = torch.stack([counts.sum((0, 1)) for counts in per_row])
    prob_sum = sum(probs.sum(0) for line in routed for probs, _, _ in line)
    return [(parts[d][s], Blocks(
        tokens=b * t, rows=rows, seq_index=s, data_index=d,
        gather_seq=lambda _, d=d: per_row[d],
        gather_data=lambda _: totals,
        sum_blocks=lambda _: prob_sum))
        for d in range(data) for s in range(seq)]


def _expert_ffn(buf, w1, b1, w2, b2):
    """The experts' FFN on their (E, Cap, C) float32 buffers."""
    h = torch.bmm(buf, w1.to(torch.float32)) + b1[:, None, :].to(torch.float32)
    h = F.gelu(h, approximate="tanh")
    return torch.bmm(h, w2.to(torch.float32)) + b2[:, None, :].to(torch.float32)


def switch_moe(x: torch.Tensor, wg: torch.Tensor, w1: torch.Tensor,
               b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
               capacity_factor: float = 1.25,
               experts: Optional[mesh_lib.RowShard] = None,
               mesh: Optional[mesh_lib.Mesh] = None,
               blocks: Optional[Blocks] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-1 MoE over flat tokens by index. x (N, C); wg (C, E); w1 (E', C,
    H), b1 (E', H), w2 (E', H, C), b2 (E', C) for the E' experts of
    `experts` on `mesh`'s expert axis (all E without them); `blocks` as
    `route` takes it. Returns (out (N, C) in x's dtype, aux ()): dropped
    tokens' rows are 0."""
    n, c = x.shape
    r = route(x, wg, capacity_factor, blocks)
    x32, gate = x.to(torch.float32), r.gate
    split = experts is not None and mesh is not None and \
        mesh.axis_size(EXPERT_AXIS) > 1
    first, count = (experts.start, experts.size) if split else (0, w1.shape[0])
    if split:
        # the parts of these gradients each rank computes are partial
        x32 = mesh_lib.copy_to_axis(x32, mesh, EXPERT_AXIS)
        gate = mesh_lib.copy_to_axis(gate, mesh, EXPERT_AXIS)
    mine = r.keep & (r.idx >= first) & (r.idx < first + count)
    # the index route gathers the kept rows by a data-dependent count (a
    # host sync a layer); a fixed-shape route with a spare row is ROADMAP
    # P8's: edl-lint: disable=EDL201
    rows = torch.nonzero(mine)[:, 0]
    expert, pos = (r.idx - first)[rows], r.pos[rows]
    slots = expert * r.cap + pos
    buf = x32.new_zeros((count * r.cap, c)).index_copy(0, slots, x32[rows])
    y = _expert_ffn(buf.view(count, r.cap, c), w1, b1, w2, b2)
    # by (expert, slot): a flat view of y would need a reshape that a
    # symbolic capacity (a traced batch) cannot prove
    picked = y[expert, pos] * gate[rows, None]
    out = x32.new_zeros((n, c)).index_copy(0, rows, picked)
    if split:
        out = mesh_lib.reduce_from_axis(out, mesh, EXPERT_AXIS)
    return out.to(x.dtype), r.aux


def switch_moe_plain(x: torch.Tensor, wg: torch.Tensor, w1: torch.Tensor,
                     b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                     capacity_factor: float = 1.25
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`switch_moe`'s plain version, every expert on this device: the
    reference's dense dispatch through the (N, E, Cap) one-hot mask."""
    e = wg.shape[1]
    r = route(x, wg, capacity_factor)
    x32 = x.to(torch.float32)
    onehot_e = F.one_hot(r.idx, e).to(torch.float32)
    onehot_c = F.one_hot(torch.clamp(r.pos, 0, r.cap - 1),
                         r.cap).to(torch.float32)
    dispatch = (onehot_e[:, :, None] * onehot_c[:, None, :]
                * r.keep[:, None, None].to(torch.float32))    # (N, E, Cap)
    expert_in = torch.einsum("nec,nd->ecd", dispatch, x32)
    y = _expert_ffn(expert_in, w1, b1, w2, b2)
    combine = dispatch * r.gate[:, None, None]
    out = torch.einsum("nec,ecd->nd", combine, y)
    return out.to(x.dtype), r.aux
