"""The training engine: train, eval and predict steps for one model on one
device.

Counterpart of `elasticdl_tpu/training/trainer.py`. The reference jits
forward, loss, backward and the optax update into one XLA program and
donates the state; here the same step runs eagerly, and the parameters
and optimizer slots update in place where the reference donates. The
embedding backward goes through the hand-written placement kernel (see
`ops/embedding.py`).

Batches arrive as `{"features", "labels", "mask"}` of numpy arrays (or
tensors) and move to the trainer's device — the counterpart of the
reference's `shard_batch`. `stack_batches` stacks K of them for
`train_many`, `eval_many` and `predict_many`, the counterpart of
`shard_batch_stack`; the reference's `lax.scan` over the group is a
Python loop here.

The HBM knobs are the reference's: `grad_accum` splits a train step's
batch into strided micro-batches with one micro-batch's activations live
at a time, and `remat` / `remat_policy` wrap the training forward in
`torch.utils.checkpoint` (see `resolve_remat_policy`).

Under a mesh (`parallel/mesh.py`) of more than one rank, the step is
data-parallel, which the reference gets from GSPMD: every rank is handed
the whole global batch and takes its block along the data axis; its
masked loss SUM is divided by the global batch's mask count (every rank
holds the whole mask, so the count needs no collective); the embedding
tables hold the rank's row range (`Embedding.shard`), whose gradient the
manual lookup makes whole; every other parameter's gradient and the loss
are summed over the data axis in one flat bucket; and the optimizer runs
locally, so the replicas stay bit-identical. The mesh's other axes are
the model's: layers with a `shard(mesh)` keep their part of a split
parameter (the MoE's experts over `expert`, the pipeline's stages over
`pp`, Megatron's splits over `model`), and their autograd Functions do
the sums over those axes that the reference's GSPMD program does, so a
parameter replicated over them ends every step equal on each rank. A
`seq` axis cuts the sequence as well (sequence parallelism): the leaves
whose batch partition names it on their second dimension (the LM's
tokens and labels) give each rank its columns, the attention runs ring
or Ulysses over the axis (`ops/attention.py`), a rank's loss sum is its
blocks' per-example means over 1/S of the tokens, divided by the axis's
size S, and every parameter's gradient is summed over data and seq
(a leaf split over `model` or `expert` too: its gradient on a rank comes
from that rank's (data, seq) block of the tokens). A `seq` axis beside
`pp` is refused: the reference's own program aborts on such a mesh.
Dropout draws the global batch's mask and keeps the rank's rows (and
columns), and BatchNorm's
statistics are the global batch's (its per-rank sums all-reduced, as
the reference's GSPMD step computes them), so a step does not depend on
the world's size and the running averages stay the same on every rank.
Eval and predict all-gather the outputs along the sequence over seq, then
over data, so every rank updates the metric states with the whole batch.

Model state beside the parameters (BatchNorm's running averages, the
MoE layers' last aux loss: the reference's `extra_vars`) lives in the
model's buffers, which `TrainState.buffers` names: each training forward
moves them once (`api.layers.update_batch_stats`), micro-batch by
micro-batch under accumulation, never again in a remat recompute.

The spec's `aux_loss_weight` weighs the aux losses a training forward
leaves (`api.layers.aux_losses`) inside the differentiated loss, as the
reference's `_aux_loss` does: weight * their sum on the one-step path;
under accumulation each micro-batch's aux scaled by its example count
before the divide-once (the reference's arithmetic, which is not the
full batch's aux); under a mesh the aux is the global batch's
(`ops/moe.py`) and each rank of the (data, seq) blocks carries 1/(D S)
of it, since its gradient's sum over data and seq runs inside the MoE's
routing. A weight of 0 skips all of it.
"""

from __future__ import annotations

import copy
import functools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils import checkpoint as ckpt

from elasticdl_tpu_torch.api.layers import (
    aux_losses, drop_pending, update_batch_stats)
from elasticdl_tpu_torch.common.constants import MeshAxis
from elasticdl_tpu_torch.common import runtime
from elasticdl_tpu_torch.common.log_utils import default_logger
from elasticdl_tpu_torch.data.prefetch import tree_map
from elasticdl_tpu_torch.parallel import mesh as mesh_lib
from elasticdl_tpu_torch.parallel import pipeline
from elasticdl_tpu_torch.training import compile_cache
from elasticdl_tpu_torch.training import lr_modulation
from elasticdl_tpu_torch.training import metrics as metrics_lib
from elasticdl_tpu_torch.training import step_cost
from elasticdl_tpu_torch.training.model_spec import ModelSpec

logger = default_logger(__name__)


@dataclass
class TrainState:
    """The training state. `params` are the model's own parameter tensors
    (by name), which the optimizer updates in place; `optimizer` holds the
    slots (Adam's moments); `generator` draws the step's randomness
    (dropout). `buffers` are the model's state beside its parameters (by
    name; BatchNorm's running averages), the counterpart of the
    reference's `extra_vars`: each training forward moves them once, and
    eval and predict read them. `step` is the global step counter and
    doubles as the model version reported to the master."""

    step: int
    params: Dict[str, torch.nn.Parameter]
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    buffers: Dict[str, torch.Tensor] = field(default_factory=dict)
    # under a mesh: the mesh, and the range each split parameter holds
    # (`RowShard.axis` None: a table sharded over every axis)
    mesh: Optional[mesh_lib.Mesh] = None
    row_shards: Dict[str, mesh_lib.RowShard] = field(default_factory=dict)

    @property
    def model_version(self) -> int:
        return int(self.step)


def _split_batch(batch: Dict[str, Any]):
    features = batch["features"]
    labels = batch.get("labels")
    mask = batch.get("mask")
    return features, labels, mask


def _masked_scalar_loss(loss_fn, labels, outputs, mask) -> torch.Tensor:
    """Apply the user loss; accept per-example vectors (masked mean) or
    scalars (used as-is)."""
    value = loss_fn(labels, outputs)
    if value.dim() == 0:
        return value
    value = value.reshape(-1).to(torch.float32)
    if mask is None:
        return torch.mean(value)
    m = mask.to(torch.float32).reshape(-1)
    return torch.sum(value * m) / torch.clamp_min(torch.sum(m), 1.0)


_warned_scalar_accum = False


def _warn_scalar_loss_with_accum() -> None:
    """A user loss returning a pre-reduced scalar under grad_accum weighs
    micro-batches equally, which differs from the full-batch masked mean
    when padding is uneven across micro-batches. Every zoo loss is
    per-example, so this never fires in-tree; warn once so that a user's
    scalar loss over masked data is not silently different."""
    global _warned_scalar_accum
    if not _warned_scalar_accum:
        _warned_scalar_accum = True
        logger.warning(
            "grad_accum_steps > 1 with a loss that returns a pre-reduced "
            "scalar: micro-batches are weighed equally, which differs from "
            "the unaccumulated step when padding/mask density varies across "
            "micro-batches. Return a per-example loss vector for exact "
            "full-batch-equivalent gradients."
        )


def _micro_batches(tree, accum: int) -> List[Any]:
    """`accum` strided micro-batches of a batch pytree: row j*K+k goes to
    micro-batch k, as the reference's `reshape(b // K, K, ...)
    .swapaxes(0, 1)` splits it. None leaves stay None."""
    def split(x, k):
        if x is None:
            return None
        if isinstance(x, dict):
            return {n: split(v, k) for n, v in x.items()}
        b = x.shape[0]
        if b % accum:
            raise ValueError(
                f"grad_accum={accum} must divide the batch size {b}")
        return x[k::accum]

    return [split(tree, k) for k in range(accum)]


# The ops whose outputs each named policy saves; everything else the
# backward recomputes. `dots` keeps every matmul output, `dots_no_batch`
# only the unbatched ones, `nothing` none. The flash forward is the op
# `edl::flash_fwd`, which no policy saves, so K2 (K2') runs again in the
# backward under every policy, as the reference's Pallas custom call does
# under `dots_saveable`.
_SAVED_OPS = {
    "dots": ("mm", "addmm", "bmm", "baddbmm"),
    "dots_no_batch": ("mm", "addmm"),
    "nothing": (),
}


def resolve_remat_policy(name: str) -> Optional[Callable]:
    """Map a config-level policy name to the `context_fn` of
    `torch.utils.checkpoint.checkpoint`: a selective-checkpoint policy
    for `dots` and `dots_no_batch`, None (recompute everything) for
    `nothing` and for "" (full remat). Raises ValueError for any other
    name."""
    if not name:
        return None
    if name not in _SAVED_OPS:
        raise ValueError(
            f"unknown remat policy {name!r}; choose from "
            f"{sorted(_SAVED_OPS)} or '' for full remat"
        )
    if not _SAVED_OPS[name]:
        return None
    saved = frozenset(getattr(torch.ops.aten, op).default
                      for op in _SAVED_OPS[name])

    def policy(ctx, op, *args, **kwargs):
        del ctx, args, kwargs
        return (ckpt.CheckpointPolicy.MUST_SAVE if op in saved
                else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(ckpt.create_selective_checkpoint_contexts,
                             policy)


def _stack_tree(items: List[Any]) -> Any:
    """Stack the same-structured pytrees `items` leaf by leaf along a new
    leading axis (numpy arrays and tensors become tensors)."""
    first = items[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: _stack_tree([it[k] for it in items]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack_tree([it[i] for it in items])
                           for i in range(len(first)))
    return torch.stack([x if isinstance(x, torch.Tensor)
                        else torch.from_numpy(np.ascontiguousarray(x))
                        for x in items])


def stack_batches(batches: List[Dict[str, Any]],
                  device: runtime.DeviceLike = None) -> Dict[str, Any]:
    """K batches as one batch pytree with a leading step axis, leaves
    (K, B, ...), on `device` (None: the card; "cpu" to stay on the host)
    in one copy a leaf: the counterpart of the reference's
    `mesh.shard_batch_stack`, for `train_many`, `eval_many` and
    `predict_many`."""
    dev = runtime.resolve_device(device)
    return tree_map(lambda t: None if t is None else t.to(dev),
                    _stack_tree(list(batches)))


def _unstack(tree, i: int):
    return tree_map(lambda t: None if t is None else t[i], tree)


def _group_size(stacked: Dict[str, Any]) -> int:
    leaf = stacked["features"]
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return int(leaf.shape[0])


class _StateCopy:
    """What a train step changes in a `TrainState`, copied, so that
    `restore` puts the state back bit for bit: the parameters and their
    gradients, the buffers, the optimizer's slots and hyperparameters,
    the step and the generator's state."""

    @torch.no_grad()
    def __init__(self, state: TrainState):
        self.params = {n: p.detach().clone() for n, p in state.params.items()}
        self.grads = {n: p.grad for n, p in state.params.items()}
        self.buffers = {n: b.clone() for n, b in state.buffers.items()}
        opt = state.optimizer
        self.slots = {p: copy.deepcopy(s) for p, s in opt.state.items()}
        self.groups = [{k: copy.deepcopy(v) for k, v in g.items()
                        if k != "params"} for g in opt.param_groups]
        self.step = state.step
        self.generator = state.generator.get_state()

    @torch.no_grad()
    def restore(self, state: TrainState) -> None:
        for n, p in state.params.items():
            p.copy_(self.params[n])
            p.grad = self.grads[n]
        for n, b in state.buffers.items():
            b.copy_(self.buffers[n])
        opt = state.optimizer
        for p in [p for p in opt.state if p not in self.slots]:
            del opt.state[p]
        for p, slots in self.slots.items():
            opt.state[p].clear()
            opt.state[p].update(slots)
        for group, saved in zip(opt.param_groups, self.groups):
            group.update(saved)
        state.step = self.step
        state.generator.set_state(self.generator)


def _check_mesh(mesh: mesh_lib.Mesh, partition) -> None:
    """Refuse what the port does not run under a mesh: a batch partition
    that does not lead with the data axis or that cuts a later dimension
    over anything but `seq` on the second; a `seq` axis beside a `pp`
    axis (`parallel.pipeline.SEQ_BESIDE_PP` says why); and a `seq` axis
    without a partition that cuts the features over it."""
    if mesh.axis_size(MeshAxis.SEQ) > 1:
        if mesh.axis_size(MeshAxis.PIPE) > 1:
            raise NotImplementedError(pipeline.SEQ_BESIDE_PP)
        if not mesh_lib.cuts_seq((partition or {}).get("features")):
            raise ValueError(
                f"a mesh with a {MeshAxis.SEQ!r} axis needs a batch "
                "partition that cuts the features' second dimension over "
                "it (the model's batch_partition())")
    for key, axes in (partition or {}).items():
        if axes and axes[0] not in (None, mesh_lib.data_axis(mesh)):
            raise ValueError(f"batch partition {key!r}: {axes} does not "
                             "lead with the data axis")
        inner = [a for a in (axes or ())[1:] if a in mesh.axis_names]
        if inner and not (inner == [MeshAxis.SEQ]
                          and mesh_lib.cuts_seq(axes)):
            raise NotImplementedError(
                f"batch partition {key!r} shards over {inner}: the port "
                f"cuts only the second dimension, over {MeshAxis.SEQ!r}")


class Trainer:
    """Runs the train/eval/predict steps of one ModelSpec on one device.

    device: None means the GPU; with no GPU present that raises rather
    than running on the CPU. Pass device="cpu" to run on the CPU.
    grad_accum: micro-batches a train step's batch is split into (>= 1).
    remat, remat_policy: recompute the training forward in the backward;
    a named policy implies remat (see `resolve_remat_policy`).
    mesh: a `parallel.mesh.Mesh` of this process's world; with more than
    one rank the steps are data-parallel (module docstring). Collective:
    every rank of the mesh runs the same steps on the same batches.
    """

    def __init__(self, spec: ModelSpec, device: runtime.DeviceLike = None,
                 seed: int = 0, grad_accum: int = 1, remat: bool = False,
                 remat_policy: str = "",
                 mesh: Optional[mesh_lib.Mesh] = None):
        # the knobs first: a bad name or count fails at construction, not
        # at the first train step of a running job
        self.remat = remat or bool(remat_policy)
        self._remat_context = (resolve_remat_policy(remat_policy)
                               or ckpt.noop_context_fn)
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        self.grad_accum = int(grad_accum)
        self.spec = spec
        self.device = runtime.resolve_device(device)
        runtime.configure_torch_runtime()
        self.seed = seed
        self.model = spec.model
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        if self.mesh is not None:
            _check_mesh(self.mesh, spec.batch_partition)
            for module in self.model.modules():
                if hasattr(module, "shard"):
                    module.shard(self.mesh)
        self.metrics: Dict[str, metrics_lib.Metric] = (
            dict(spec.eval_metrics_fn()) if spec.eval_metrics_fn else {}
        )
        # `train_step_cost`'s results by the (state, batch) signature
        self._cost_cache: Dict[Tuple, Dict[str, float]] = {}

    # ------------------------------------------------------------------ #
    # Batches

    def _to_device(self, x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: self._to_device(v) for k, v in x.items()}
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _device_batch(self, batch: Dict[str, Any]):
        return tuple(self._to_device(x) for x in _split_batch(batch))

    # ------------------------------------------------------------------ #
    # State creation

    def init_state(self, example_batch: Dict[str, Any]) -> TrainState:
        """Move the model to the device and draw its parameters there from
        a generator seeded with `seed`, then build the optimizer over them.

        A torch module knows its parameter shapes from its constructor, so
        `example_batch` (which flax needs to infer them) only keeps the
        reference's signature."""
        del example_batch
        model = self.model.to(self.device)
        generator = torch.Generator(device=self.device)
        generator.manual_seed(self.seed)
        if hasattr(model, "reset_parameters"):
            model.reset_parameters(generator)
        params = dict(model.named_parameters())
        optimizer = self.spec.optimizer(list(params.values()))
        n = sum(p.numel() for p in params.values())
        logger.info("Initialized model %s: %.3fM params on %s",
                    self.spec.module_name, n / 1e6, self.device)
        return TrainState(
            step=0, params=params, optimizer=optimizer, generator=generator,
            buffers=dict(model.named_buffers()), mesh=self.mesh,
            row_shards={f"{name}.{leaf}": rows
                        for name, m in model.named_modules()
                        if hasattr(m, "shards")
                        for leaf, rows in m.shards().items()})

    # ------------------------------------------------------------------ #
    # Steps

    def _columns(self, features) -> Optional[Tuple[int, int, int]]:
        """(global sequence length, start, stop) of this rank's columns of
        `features` on a mesh with a `seq` axis, else None."""
        if self.mesh.axis_size(MeshAxis.SEQ) == 1:
            return None
        while isinstance(features, dict):
            features = next(iter(features.values()))
        length = int(features.shape[1])
        return (length, *mesh_lib.seq_block(self.mesh, length))

    def _block(self, features, labels=None, mask=None):
        """Under a mesh: (global rows, start, stop, mesh, columns) of this
        rank's block, for `batch_block_of`, and its part of features,
        labels and mask (`parallel.mesh.shard_batch` by the model's
        partition)."""
        b = _group_size({"features": features})
        block = (b, *mesh_lib.batch_block(self.mesh, b), self.mesh,
                 self._columns(features))
        part = mesh_lib.shard_batch(
            self.mesh, {"features": features, "labels": labels,
                        "mask": mask}, self.spec.batch_partition)
        return block, part["features"], part["labels"], part["mask"]

    def _forward(self, state: TrainState, features, block=None):
        """The training forward: (outputs, the weighted aux loss or None
        with a weight of 0 or no aux); under remat, inside a non-reentrant
        `torch.utils.checkpoint` with the policy's context. `block` is
        (global rows, start, stop, mesh, columns) of a rank's block under
        a mesh (`_block`), for the randomness the model draws per example,
        the global batch's BatchNorm statistics and the columns of a
        `seq` axis. The buffers move once, from this
        pass's statistics (`api.layers.update_batch_stats`), never from a
        remat recompute in the backward.

        `checkpoint` restores the global RNG state for the recompute, not
        a generator passed in, and the models draw dropout from
        `state.generator`: so the checkpointed function first sets the
        generator to its state at the forward's entry, and the recompute
        draws the forward's masks again (the reference's dropout draws
        from `fold_in(rng, step)` and recomputes the same masks)."""
        gen = state.generator
        weight = self.spec.aux_loss_weight

        def model(feats):
            if block is None:
                outputs = self.model(feats, training=True, generator=gen)
            else:
                with mesh_lib.batch_block_of(*block):
                    outputs = self.model(feats, training=True, generator=gen)
            aux = aux_losses(self.model) if weight else []
            return outputs, (weight * sum(aux) if aux else None)

        if not self.remat:
            outputs = model(features)
        else:
            entry = gen.get_state()

            def forward(feats):
                gen.set_state(entry)
                return model(feats)

            outputs = ckpt.checkpoint(forward, features, use_reentrant=False,
                                      context_fn=self._remat_context)
        update_batch_stats(self.model)
        return outputs

    def _backward(self, state: TrainState, value: torch.Tensor) -> None:
        """`value.backward()`. Under remat the recompute rewinds the
        generator and may stop early, so it is put back where the forward
        left it: the next step draws as it would without remat."""
        if not self.remat:
            value.backward()
            return
        after = state.generator.get_state()
        value.backward()
        state.generator.set_state(after)
        drop_pending(self.model)

    def _accumulated_backward(self, state: TrainState, features, labels,
                              mask) -> torch.Tensor:
        """Gradient accumulation: forward and backward over `grad_accum`
        strided micro-batches, one micro-batch's activations live at a
        time. Per-example losses accumulate the masked loss SUM and the
        count, and the summed gradients are divided by the count once at
        the end, so the result is the full batch's even when the padding
        falls in one micro-batch. A pre-reduced scalar loss weighs the
        micro-batches equally (and warns once). Returns the loss.

        Under a mesh every step takes this path (grad_accum 1 is one
        micro-batch): each global micro-batch's mask count, then the
        forward and backward of this rank's block of it (its rows, and
        on a `seq` axis its columns, each example's loss the mean of its
        S blocks' means), so the sums over data and seq
        (`_sum_over_data`) give the global step's."""
        k = self.grad_accum
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        count = torch.zeros((), dtype=torch.float32, device=self.device)
        data = seq = 1
        if self.mesh is not None:
            data = self.mesh.axis_size(mesh_lib.data_axis(self.mesh))
            seq = self.mesh.axis_size(MeshAxis.SEQ)
        for f, l, m in zip(*(_micro_batches(x, k)
                             for x in (features, labels, mask))):
            block = None
            if self.mesh is not None:
                # the global micro-batch's count, then this rank's block
                c_global = (torch.sum(m.to(torch.float32)) if m is not None
                            else torch.tensor(float(_group_size(
                                {"features": f})), device=self.device))
                block, f, l, m = self._block(f, l, m)
            outputs, aux = self._forward(state, f, block)
            value = self.spec.loss(l, outputs)
            # each rank of the (data, seq) blocks carries 1/(D S) of a
            # global aux
            share = 1.0 / (data * seq)
            if value.dim() == 0:
                _warn_scalar_loss_with_accum()
                # the blocks weigh equally, as the micro-batches do
                s, c = value.to(torch.float32) / (data * seq), 1.0
                if aux is not None:
                    s = s + aux * share
            else:
                v = value.reshape(-1).to(torch.float32)
                mm = (m.to(torch.float32).reshape(-1) if m is not None
                      else torch.ones_like(v))
                # an example's loss: the mean of its S column blocks'
                s, c = torch.sum(v * mm) / seq, torch.sum(mm)
                if self.mesh is not None:
                    c = c_global
                if aux is not None:
                    # the reference's aux * count, before the divide-once
                    s = s + aux * c * share
            self._backward(state, s)
            loss_sum += s.detach()
            count += c
        denom = torch.clamp_min(count, 1.0)
        for p in state.params.values():
            if p.grad is not None:
                p.grad.div_(denom)
        return loss_sum / denom

    def compute_grads(
        self, state: TrainState, batch: Dict[str, Any]
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Forward, masked loss and backward of one batch in training
        mode, under the trainer's remat and accumulation. Returns (loss,
        {param name: gradient}); the gradients are also left in each
        parameter's `.grad` for the optimizer."""
        features, labels, mask = self._device_batch(batch)
        self.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        if self.grad_accum > 1 or self.mesh is not None:
            loss = self._accumulated_backward(state, features, labels, mask)
        else:
            outputs, aux = self._forward(state, features)
            loss = _masked_scalar_loss(self.spec.loss, labels, outputs, mask)
            if aux is not None:
                loss = loss + aux
            self._backward(state, loss)
        if self.mesh is not None:
            loss = self._sum_over_data(state, loss.detach())
        return loss.detach(), {n: p.grad for n, p in state.params.items()}

    def _sum_over_data(self, state: TrainState,
                       loss: torch.Tensor) -> torch.Tensor:
        """Sum the parameters' gradients and the loss over the data axis,
        then over `seq` (every parameter is replicated over it), in one
        flat bucket (library collectives). A sharded table's gradient is
        already whole. Returns the summed loss."""
        tables = {n for n, rows in state.row_shards.items()
                  if rows.axis is None}
        grads = [p.grad for n, p in state.params.items()
                 if n not in tables and p.grad is not None]
        # float32 whatever the parameters' order: the float32 loss makes
        # cat promote bfloat16 gradients
        bucket = torch.cat([g.reshape(-1) for g in grads]
                           + [loss.reshape(1).float()])
        for axis in (mesh_lib.data_axis(self.mesh), MeshAxis.SEQ):
            mesh_lib.all_reduce(self.mesh, axis, bucket)
        offset = 0
        for g in grads:
            g.copy_(bucket[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
        return bucket[offset]

    def train_step(self, state: TrainState, batch: Dict[str, Any]):
        """One optimizer step. Updates `state` in place (the reference
        donates it) and returns (state, {"loss": 0-d float32 tensor on the
        device})."""
        loss, _ = self.compute_grads(state, batch)
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss.to(torch.float32)}

    def train_many(self, state: TrainState, stacked_batch):
        """K train steps over a stacked batch (leaves (K, B, ...), from
        `stack_batches`): the counterpart of the reference's `lax.scan` of
        the step, as a Python loop. A group not yet on the device goes
        there in one copy a leaf, and each step's loss stays there:
        returns (state, {"loss": (K,) float32 tensor on the device}), read
        back once a group."""
        stacked = self._to_device(stacked_batch)
        losses = []
        for i in range(_group_size(stacked)):
            state, logs = self.train_step(state, _unstack(stacked, i))
            losses.append(logs["loss"])
        return state, {"loss": torch.stack(losses)}

    def train_step_cost(self, state: TrainState,
                        batch: Dict[str, Any]) -> Dict[str, float]:
        """{'flops', 'bytes accessed'} of ONE train step (`train_step`,
        the body `train_many` runs K times) on `batch`, under the
        trainer's knobs: the counterpart of the reference's cost analysis
        of its lowered step. It runs that step once under
        `training.step_cost.StepCost` and then puts `state` back as it
        was, bit for bit: the parameters, their gradients, the buffers,
        the optimizer's slots and hyperparameters, the step and the
        generator. So it costs one step's time (on the card its kernels
        launch and count in their `launches`) and a second copy of the
        parameters and slots while it runs. Memoized by the (state,
        batch) shapes and dtypes, as the reference's `_cost_cache` is.
        Under a mesh it runs the step's collectives, so every rank calls
        it, and counts this rank's part.

        'flops' counts the products (matmuls, convolutions, attention) and
        no elementwise op: the MFU numerator. The hand-written kernels
        count by formula at their dispatcher ops, so it is the same on
        the CPU as on the card. 'bytes accessed' counts each op's
        operands and results once, before fusion, and so upper-bounds
        the device memory traffic. See `training/step_cost.py`."""
        features, labels, mask = self._device_batch(batch)
        key = compile_cache.aval_signature(
            (state.params, state.buffers, features, labels, mask))
        if key not in self._cost_cache:
            saved = _StateCopy(state)
            try:
                with step_cost.StepCost() as cost:
                    self.train_step(state, {"features": features,
                                            "labels": labels, "mask": mask})
            finally:
                saved.restore(state)
            self._cost_cache[key] = {"flops": float(cost.flops),
                                     "bytes accessed": float(cost.bytes)}
        return dict(self._cost_cache[key])

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch, metric_states):
        """Update the streaming metric states (numpy float32 arrays, as
        the master merges them) and the `_loss` [sum, count] pair."""
        features, labels, mask = self._device_batch(batch)
        self.model.eval()
        outputs = self._eval_outputs(features)
        new_states = dict(metric_states)
        for name, metric in self.metrics.items():
            new_states[name] = metric.update(
                metric_states[name], labels, outputs, mask)
        loss_value = _masked_scalar_loss(self.spec.loss, labels, outputs, mask)
        count = (torch.sum(mask.to(torch.float32)) if mask is not None
                 else torch.tensor(float(labels.reshape(-1).shape[0]),
                                   device=self.device))
        new_states["_loss"] = metric_states["_loss"] + torch.stack(
            [loss_value * count, count]).to("cpu", torch.float32).numpy()
        return new_states

    def eval_many(self, state: TrainState, stacked_batch, metric_states):
        """K eval steps over a stacked batch, the metric states threaded
        through them (host numpy, as `eval_step` keeps them): equal to K
        `eval_step` calls."""
        stacked = self._to_device(stacked_batch)
        for i in range(_group_size(stacked)):
            metric_states = self.eval_step(state, _unstack(stacked, i),
                                           metric_states)
        return metric_states

    def _eval_outputs(self, features):
        """The model's outputs for the whole batch, in eval mode: under a
        mesh, this rank's block's, all-gathered along the sequence over
        `seq` and then over data."""
        if self.mesh is None:
            return self.model(features, training=False)
        block, part, _, _ = self._block(features)
        with mesh_lib.batch_block_of(*block):
            out = self.model(part, training=False)
        if block[4] is not None:
            out = mesh_lib.all_gather(self.mesh, MeshAxis.SEQ, out, dim=1)
        return mesh_lib.all_gather(self.mesh, mesh_lib.data_axis(self.mesh),
                                   out)

    @torch.no_grad()
    def predict_step(self, state: TrainState, batch) -> torch.Tensor:
        features, _, _ = self._device_batch(batch)
        self.model.eval()
        return self._eval_outputs(features)

    def predict_many(self, state: TrainState, stacked_batch):
        """K predict steps over a stacked batch; the outputs come back
        stacked, leaves (K, B, ...)."""
        stacked = self._to_device(stacked_batch)
        return _stack_tree([self.predict_step(state, _unstack(stacked, i))
                            for i in range(_group_size(stacked))])

    # ------------------------------------------------------------------ #
    # Control

    def set_learning_rate(self, state: TrainState, lr: float) -> TrainState:
        """Runtime LR change; the optimizer's param groups carry it."""
        lr_modulation.set_learning_rate(state.optimizer, lr)
        return state

    def new_metric_states(self) -> Dict[str, np.ndarray]:
        states = metrics_lib.init_states(self.metrics)
        states["_loss"] = np.zeros((2,), np.float32)
        return states

    def metric_results(self, metric_states) -> Dict[str, float]:
        states = {k: np.asarray(v) for k, v in metric_states.items()}
        out = metrics_lib.results(
            self.metrics, {k: v for k, v in states.items() if k != "_loss"})
        loss_state: Optional[np.ndarray] = states.get("_loss")
        if loss_state is not None and loss_state[1] > 0:
            out["loss"] = float(loss_state[0] / loss_state[1])
        return out
