"""GPipe-style pipeline parallelism over a `pp` mesh axis.

Counterpart of `elasticdl_tpu/parallel/pipeline.py`. `gpipe(stage_fn,
stage_params, x, num_microbatches=M)` computes

    for s in range(S): x = stage_fn(params[s], x)

Without a `pp` axis (no mesh, or a mesh of size 1 there) that fold is
what runs, over the S stacked stages, as the reference falls back to it.

With a `pp` axis of size S, stage s lives on pp rank s
(`stage_index`), and the batch is split contiguously into M microbatches,
as the reference's `x_full.reshape((M, mb) + ...)` splits it. Each rank
runs its stage on each microbatch in turn: stage 0 reads the stream,
every later stage receives its input from the stage before it, and every
stage but the last sends its output on, all by point-to-point messages
inside autograd Functions, so the backward sends each gradient back
along the same link. The last stage's outputs reach every pp rank
(`_FromLast`, the reference's masked `psum`), whose backward hands the
loss's gradient to the last stage once and gives the other ranks' sends
their turn. The input's gradient, which only stage 0 computes, is summed
over the axis (`copy_to_axis`), so every pp rank holds the whole
gradient of what feeds the pipeline.

Messages pair in one fixed order on every rank: in the forward,
microbatch by microbatch; in the backward, microbatch M-1 first, since
autograd runs the most recently created ready node first and each
microbatch's nodes were created after the previous one's. Each rank
drives one device, so a stage's microbatches run one after another; the
schedule's overlap across ranks is GPipe's, its bubble (S-1)/(M+S-1) of
each rank's time.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from elasticdl_tpu_torch.common.constants import MeshAxis
from elasticdl_tpu_torch.parallel import mesh as mesh_lib

PIPE_AXIS = MeshAxis.PIPE


def stage_index(mesh: Optional[mesh_lib.Mesh], axis: str = PIPE_AXIS) -> int:
    """This rank's stage on `axis` (0 without it): the counterpart of the
    reference's `stage_partition_specs`, which put stage s on pp shard
    s."""
    return 0 if mesh is None else mesh.coords.get(axis, 0)


def _stage(params: Dict[str, torch.Tensor], s: int) -> Dict[str, torch.Tensor]:
    return {k: v[s] for k, v in params.items()}


class _Send(torch.autograd.Function):
    """Send the activation to `dst`; the backward receives its gradient
    from there. The output is a scalar token that `_FromLast` consumes, so
    the backward reaches this node."""

    @staticmethod
    def forward(ctx, out, dst):
        ctx.dst, ctx.like = dst, (out.shape, out.dtype, out.device)
        dist.send(out.detach().contiguous(), dst)
        return out.new_zeros(())

    @staticmethod
    def backward(ctx, grad):
        del grad
        shape, dtype, device = ctx.like
        g = torch.empty(shape, dtype=dtype, device=device)
        dist.recv(g, ctx.dst)
        return g, None


class _Recv(torch.autograd.Function):
    """Receive an activation from `src`; the backward sends its gradient
    there. `anchor`, a scalar leaf that requires grad, puts the node in
    the graph."""

    @staticmethod
    def forward(ctx, anchor, like, src):
        ctx.src = src
        act = torch.empty_like(like)
        dist.recv(act, src)
        return act

    @staticmethod
    def backward(ctx, grad):
        dist.send(grad.contiguous(), ctx.src)
        return None, None, None


class _FromLast(torch.autograd.Function):
    """The last stage's output on every rank of the axis (a broadcast).
    Backward: the last stage takes the gradient as it is, once; the other
    ranks return zeros to the input they fed the pipeline (`x`) and to
    their send tokens, so their `copy_to_axis` and `_Send` nodes run."""

    @staticmethod
    def forward(ctx, out, x, mesh, axis, last, *tokens):
        ctx.last = mesh.coords[axis] == last
        ctx.is_first = mesh.coords[axis] == 0
        ctx.tokens = len(tokens)
        out = out.contiguous().clone()
        dist.broadcast(out, mesh.rank_at(**{axis: last}),
                       group=mesh.group(axis))
        return out

    @staticmethod
    def backward(ctx, grad):
        tokens = [grad.new_zeros(()) for _ in range(ctx.tokens)]
        return (grad if ctx.last else None,
                None if ctx.is_first else torch.zeros_like(grad),
                None, None, None, *tokens)


def gpipe(stage_fn: Callable[[Dict[str, torch.Tensor], torch.Tensor],
                             torch.Tensor],
          stage_params: Dict[str, torch.Tensor], x: torch.Tensor, *,
          num_microbatches: int, axis: str = PIPE_AXIS,
          mesh: Optional[mesh_lib.Mesh] = None) -> torch.Tensor:
    """Fold `x` through S stages (module docstring).

    stage_fn: (one stage's params, (mb, ...) activation) -> an activation
      of the same shape.
    stage_params: name -> a tensor with a leading stage dim. Without the
      axis: all S stages. With a `pp` axis of size S: all S stages, of
      which this rank takes its own, or this rank's stage alone (leading
      dim 1: a sharded `PipelinedBlocks`); any other count raises.
    x: (B, ...), B divisible by num_microbatches, the same on every rank
      of the axis.
    Collective over the axis: every rank of it calls it alike."""
    n_stages = 1 if mesh is None else mesh.axis_size(axis)
    if n_stages == 1:
        s_total = next(iter(stage_params.values())).shape[0]
        for s in range(s_total):
            x = stage_fn(_stage(stage_params, s), x)
        return x
    s_stacked = next(iter(stage_params.values())).shape[0]
    if s_stacked not in (1, n_stages):
        raise ValueError(
            f"stage_params stack {s_stacked} stages but mesh axis {axis!r} "
            f"has {n_stages} shards — they must match")
    batch = x.shape[0]
    if batch % num_microbatches:
        raise ValueError(f"batch {batch} not divisible by num_microbatches "
                         f"{num_microbatches}")
    me, last = stage_index(mesh, axis), n_stages - 1
    params = _stage(stage_params, 0 if s_stacked == 1 else me)
    x = mesh_lib.copy_to_axis(x, mesh, axis)
    micro = x.split(batch // num_microbatches)
    anchor = torch.zeros((), device=x.device, requires_grad=True)
    outs, tokens = [], []
    for m in range(num_microbatches):
        inp = (micro[m] if me == 0 else _Recv.apply(
            anchor, micro[m], mesh.rank_at(**{axis: me - 1})))
        out = stage_fn(params, inp)
        if me < last:
            tokens.append(_Send.apply(out, mesh.rank_at(**{axis: me + 1})))
        else:
            outs.append(out)
    out = torch.cat(outs) if outs else torch.empty_like(x)
    return _FromLast.apply(out, x, mesh, axis, last, *tokens)
