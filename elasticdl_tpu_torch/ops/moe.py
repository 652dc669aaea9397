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
program computes it: inside the trainer's `parallel.mesh.batch_block_of`
a rank holds its block of the tokens, so the capacity counts the global
batch's tokens, each expert's slots continue the counts of the blocks
before this one (an all-gather of E counts over data), and the aux
loss's fractions and mean probabilities are the global batch's (a sum
over data). With `experts` (an `expert` axis: `expert_range`) a rank
holds only its experts' weights; tokens are replicated over the axis, so
each rank fills its experts' slots, combines its part of the output and
the parts are summed over the axis. Only token-sized tensors cross the
mesh: the summed output, and in the backward the gradients of the tokens
and of the gates (`parallel.mesh.copy_to_axis`), whose parts are partial.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

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


def route(x: torch.Tensor, wg: torch.Tensor,
          capacity_factor: float) -> Routing:
    """Top-1 routing of the tokens x (N, C) by the router wg (C, E): the
    global batch's under a mesh (module docstring)."""
    n_local = x.shape[0]
    e = wg.shape[1]
    logits = x.to(torch.float32) @ wg.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    idx = torch.argmax(probs, dim=-1)
    gate = probs.gather(1, idx[:, None])[:, 0]
    onehot = F.one_hot(idx, e)
    counts = onehot.sum(0)
    block = mesh_lib.data_block()
    if block is None:
        n, prefix, prob_sum = n_local, torch.zeros_like(counts), probs.sum(0)
    else:
        rows, start, stop, mesh = block
        n = n_local // (stop - start) * rows
        axis = mesh_lib.data_axis(mesh)
        every = mesh_lib.all_gather(mesh, axis, counts[None])     # (D, E)
        prefix = every[: mesh.coords.get(axis, 0)].sum(0)
        counts = every.sum(0)
        prob_sum, _ = mesh_lib.sum_over_data(probs.sum(0))
    cap = max(1, int(capacity_factor * n / e))
    # arrival order by expert: the scan runs along the contiguous axis of
    # (E, N) (down the N rows of (N, E) it is one thread a column)
    arrived = torch.cumsum(onehot.t().contiguous(), dim=1)
    pos = arrived.gather(0, idx[None])[0] - 1 + prefix[idx]
    keep = pos < cap
    aux = e * torch.sum((counts.to(torch.float32) / n) * (prob_sum / n))
    return Routing(probs, idx, gate, pos, keep, cap, aux)


def _expert_ffn(buf, w1, b1, w2, b2):
    """The experts' FFN on their (E, Cap, C) float32 buffers."""
    h = torch.bmm(buf, w1.to(torch.float32)) + b1[:, None, :].to(torch.float32)
    h = F.gelu(h, approximate="tanh")
    return torch.bmm(h, w2.to(torch.float32)) + b2[:, None, :].to(torch.float32)


def switch_moe(x: torch.Tensor, wg: torch.Tensor, w1: torch.Tensor,
               b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
               capacity_factor: float = 1.25,
               experts: Optional[mesh_lib.RowShard] = None,
               mesh: Optional[mesh_lib.Mesh] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-1 MoE over flat tokens by index. x (N, C); wg (C, E); w1 (E', C,
    H), b1 (E', H), w2 (E', H, C), b2 (E', C) for the E' experts of
    `experts` on `mesh`'s expert axis (all E without them). Returns (out
    (N, C) in x's dtype, aux ()): dropped tokens' rows are 0."""
    n, c = x.shape
    r = route(x, wg, capacity_factor)
    x32, gate = x.to(torch.float32), r.gate
    split = experts is not None and mesh is not None and \
        mesh.axis_size(EXPERT_AXIS) > 1
    first, count = (experts.start, experts.size) if split else (0, w1.shape[0])
    if split:
        # the parts of these gradients each rank computes are partial
        x32 = mesh_lib.copy_to_axis(x32, mesh, EXPERT_AXIS)
        gate = mesh_lib.copy_to_axis(gate, mesh, EXPERT_AXIS)
    mine = r.keep & (r.idx >= first) & (r.idx < first + count)
    rows = torch.nonzero(mine)[:, 0]
    slots = ((r.idx - first) * r.cap + r.pos)[rows]
    buf = x32.new_zeros((count * r.cap, c)).index_copy(0, slots, x32[rows])
    y = _expert_ffn(buf.view(count, r.cap, c), w1, b1, w2, b2)
    picked = y.reshape(-1, c).index_select(0, slots) * gate[rows, None]
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
