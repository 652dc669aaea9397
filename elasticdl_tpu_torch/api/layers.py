"""User-facing layers: `Embedding`, `TierEmbedding` (with `tier_table_spec`)
for tables served from the embedding tier, the Switch-MoE FFN `MoE`, and
the `Dense` (with its tensor-parallel `TPDense`), `LayerNorm`, `Embed`,
`Conv` and `BatchNorm` layers (and `max_pool`) the zoo models use in
place of flax's.

Counterpart of `elasticdl_tpu/api/layers.py`. Parameters are float32, created
empty; `reset_parameters(generator)` draws them from the same
distributions as the reference's flax initializers, from an explicit
`torch.Generator` (`reset_tree` does so for every layer of a model).

A layer that a mesh can split has `shard(mesh)`, which the trainer calls
under a mesh of more than one rank, and `shards()`, the `parallel.mesh.
RowShard` of each of its split parameters by name, which the trainer
collects into `TrainState.row_shards`. Its `reset_parameters` draws the
whole parameter and keeps the rank's part, so a state does not depend on
the world's size.

Images are NCHW here where flax's are NHWC: `Conv`'s weight is OIHW (flax's
kernel is HWIO, and `convert.py` permutes it), and a model that flattens a
feature map permutes it to NHWC first, so the flattened order is flax's.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn
from torch.nn import functional as F

from elasticdl_tpu_torch.common.constants import MeshAxis
from elasticdl_tpu_torch.ops import embedding as emb_ops
from elasticdl_tpu_torch.parallel import mesh as mesh_lib

# flax's lecun_normal draws a normal truncated to [-2, 2] standard
# deviations and divides the scale by that truncation's std, so the
# variance stays 1/fan_in
_TRUNC_STD = 0.87962566103423978


class Embedding(nn.Module):
    """Embedding table with an optional bag combiner.

    input_dim: vocabulary size; the table has `padded_vocab(input_dim,
      vocab_align)` rows, as in the reference (the padded row count is
      part of the checkpoint geometry).
    output_dim: embedding dimension.
    combiner: None -> (..., L, D); 'sum'|'mean'|'sqrtn' -> (..., D) over
      the last id axis, with negative ids treated as padding slots.
    mode: 'manual' or 'auto'; on one device both run the auto lookup.
    Initializer: U[0, 0.05) — flax's `uniform(scale=0.05)` is one-sided.

    `shard(mesh)` puts the layer under a mesh of more than one rank: the
    table parameter then holds this rank's row range, `row_shard` (a
    `parallel.mesh.RowShard`), the counterpart of the reference's
    partitioning metadata. The trainer collects the layers' ranges into
    `TrainState.row_shards`, which checkpoints and export read. The
    lookup then runs the manual schedule.
    """

    def __init__(self, input_dim: int, output_dim: int,
                 combiner: Optional[str] = None, mode: str = "manual",
                 vocab_align: Optional[int] = None):
        super().__init__()
        self.input_dim = int(input_dim)
        self.output_dim = int(output_dim)
        self.combiner = combiner
        self.mode = mode
        self.num_rows = emb_ops.padded_vocab(self.input_dim, vocab_align)
        self.table = nn.Parameter(torch.empty((self.num_rows, self.output_dim)))
        self.mesh: Optional[mesh_lib.Mesh] = None
        self.row_shard: Optional[mesh_lib.RowShard] = None

    def shard(self, mesh: mesh_lib.Mesh) -> None:
        """Hold only this rank's rows of the table from here on (a mesh of
        one rank keeps the whole table)."""
        if mesh.size == 1:
            return
        self.mesh = mesh
        self.row_shard = mesh_lib.table_rows(mesh, self.num_rows)
        self.table = nn.Parameter(torch.empty(
            (self.row_shard.size, self.output_dim), device=self.table.device))

    def shards(self):
        return {} if self.row_shard is None else {"table": self.row_shard}

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Draw the whole table from `generator` and keep this rank's
        rows, so a state does not depend on the world's size."""
        with torch.no_grad():
            rows = self.row_shard
            if rows is None:
                nn.init.uniform_(self.table, 0.0, 0.05, generator=generator)
                return
            full = torch.empty((self.num_rows, self.output_dim),
                               device=self.table.device)
            nn.init.uniform_(full, 0.0, 0.05, generator=generator)
            self.table.copy_(full[rows.start:rows.stop])

    def forward(self, ids: torch.Tensor,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        ids = ids.to(torch.int32)
        vectors = emb_ops.embedding_lookup(
            self.table, ids, mode=self.mode, mesh=self.mesh,
            rows=self.row_shard)
        return emb_ops.combine(vectors, self.combiner, ids, weights)


class TierEmbedding(nn.Module):
    """Embedding served from the elastic sharded tier
    (`elasticdl_tpu_torch/embedding/`) instead of a table parameter.

    The tier's pull happens outside the step: the worker's
    `EmbeddingTierSession` dedupes the batch's ids, pulls one batched call
    per owning shard, and hands the rows in as leaf tensors. This layer
    applies the same combiner and padding semantics as `Embedding`. With
    `inverse` (the deduped shape of `EmbeddingTierClient.pull_unique`),
    `vectors` holds one row per unique id and `inverse` maps batch slots
    onto them: the expansion gather runs through `ops.embedding.
    gather_rows`, so its backward is K1, a fixed-order sum of each unique
    row's duplicate slots with no atomics, and reruns give the same bits.
    The gradient w.r.t. `vectors` is the per-row gradient the session
    pushes back.
    """

    def __init__(self, output_dim: int, combiner: Optional[str] = None):
        super().__init__()
        self.output_dim = int(output_dim)
        self.combiner = combiner

    def forward(self, vectors: torch.Tensor, ids: torch.Tensor,
                weights: Optional[torch.Tensor] = None,
                inverse: Optional[torch.Tensor] = None) -> torch.Tensor:
        ids = ids.to(torch.int32)
        if inverse is not None:
            vectors = emb_ops.gather_rows(vectors, inverse.to(torch.int32))
        return emb_ops.combine(vectors, self.combiner, ids, weights)


def tier_table_spec(name: str, input_dim: int, output_dim: int,
                    seed: int = 0, init_scale: float = 0.05):
    """The tier TableSpec matching an `Embedding(input_dim, output_dim)`
    layer's geometry: rows padded by the same rule as the table parameter
    (`ops.embedding.padded_vocab`)."""
    from elasticdl_tpu_torch.embedding.sharding import TableSpec

    return TableSpec(
        name=name,
        vocab=emb_ops.padded_vocab(input_dim),
        dim=output_dim,
        seed=seed,
        init_scale=init_scale,
    )


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout over a batch-major `x`: keep where U[0, 1) >=
    `rate`, scaled by 1 / (1 - rate). The draw is the global batch's
    under a mesh (`parallel.mesh.batch_rand`)."""
    keep = mesh_lib.batch_rand(x.shape, generator, x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0)


class Dense(nn.Module):
    """`flax.linen.Dense` with torch's (out, in) weight layout.

    dtype: the compute dtype. As in flax, inputs, weight and bias are cast
    to it before the product, the product is rounded to it, and the bias
    is added in it — explicit casts rather than autocast, so rounding
    happens where it does in the reference. None keeps the inputs' dtype
    promoted with the params'.
    Initializers: truncated lecun_normal weight, zero bias (flax's
    defaults).
    """

    def __init__(self, in_features: int, features: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.in_features = int(in_features)
        self.features = int(features)
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty((self.features, self.in_features)))
        self.bias = nn.Parameter(torch.empty((self.features,)))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            _lecun_normal_(self.weight, self.in_features, generator)
            self.bias.zero_()

    def _product(self, x: torch.Tensor):
        dtype = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        return torch.nn.functional.linear(x.to(dtype),
                                          self.weight.to(dtype)), dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, dtype = self._product(x)
        return y + self.bias.to(dtype)


def _lecun_normal_(weight: torch.Tensor, fan_in: int,
                   generator: Optional[torch.Generator]) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


def _keep_part(param: torch.Tensor, full: torch.Tensor,
               rows: Optional[mesh_lib.RowShard]) -> None:
    """Copy this rank's part of the whole `full` into `param`."""
    if rows is not None:
        full = full.narrow(rows.dim, rows.start, rows.size)
    param.copy_(full)


class TPDense(Dense):
    """`Dense` with Megatron's tensor parallelism over mesh axis `axis`
    (the reference's `_tp_dense`): without the axis (no mesh, or a mesh
    that lacks it) it is `Dense`, parameter for parameter and bit for bit.

    split="col": the rank holds a slice of the output features (weight
    rows, bias); its input enters through `copy_to_axis`, and with
    `gather` the outputs are gathered over the axis (the LM's head before
    the loss). split="row": the rank holds a slice of the input features
    (weight columns) and takes the matching slice of its input; the
    partial products are summed over the axis (`reduce_from_axis`) and
    the replicated bias is added once, after the sum."""

    def __init__(self, in_features: int, features: int,
                 dtype: Optional[torch.dtype] = None, axis: str = "model",
                 split: str = "col", gather: bool = False):
        if split not in ("col", "row"):
            raise ValueError(f"split must be 'col' or 'row', got {split!r}")
        super().__init__(in_features, features, dtype=dtype)
        self.axis, self.split, self.gather = axis, split, bool(gather)
        self.mesh: Optional[mesh_lib.Mesh] = None
        self.parts: Dict[str, mesh_lib.RowShard] = {}

    def shard(self, mesh: mesh_lib.Mesh) -> None:
        if mesh.axis_size(self.axis) == 1:
            return
        self.mesh = mesh
        if self.split == "col":
            rows = mesh_lib.axis_rows(mesh, self.axis, self.features, 0)
            self.parts = {"weight": rows, "bias": rows}
        else:
            self.parts = {"weight": mesh_lib.axis_rows(
                mesh, self.axis, self.in_features, 1)}
        for name, rows in self.parts.items():
            old = getattr(self, name)
            shape = list(old.shape)
            shape[rows.dim] = rows.size
            setattr(self, name, nn.Parameter(
                torch.empty(shape, device=old.device)))

    def shards(self):
        return dict(self.parts)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            weight = torch.empty((self.features, self.in_features),
                                 device=self.weight.device)
            _lecun_normal_(weight, self.in_features, generator)
            _keep_part(self.weight, weight, self.parts.get("weight"))
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mesh is None:
            return super().forward(x)
        if self.split == "row":
            y, dtype = self._product(x)
            y = mesh_lib.reduce_from_axis(y, self.mesh, self.axis)
            return y + self.bias.to(dtype)
        y = super().forward(mesh_lib.copy_to_axis(x, self.mesh, self.axis))
        if self.gather:
            y = mesh_lib.gather_from_axis(y, self.mesh, self.axis, -1)
        return y


class LayerNorm(nn.Module):
    """`flax.linen.LayerNorm` over the last axis: epsilon 1e-6, float32
    `scale` (ones) and `bias` (zeros).

    As in flax, the statistics are float32 and use the fast variance,
    E[x^2] - E[x]^2 clamped at 0; y = (x - mean) * (rsqrt(var + eps) *
    scale) + bias is computed in float32 and cast to `dtype` once, at the
    end. dtype None keeps the input's dtype promoted with float32."""

    def __init__(self, features: int, dtype: Optional[torch.dtype] = None,
                 epsilon: float = 1e-6):
        super().__init__()
        self.features = int(features)
        self.dtype = dtype
        self.epsilon = float(epsilon)
        self.scale = nn.Parameter(torch.empty((self.features,)))
        self.bias = nn.Parameter(torch.empty((self.features,)))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        del generator
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.float32)
        mean = x32.mean(dim=-1, keepdim=True)
        var = torch.clamp_min(
            (x32 * x32).mean(dim=-1, keepdim=True) - mean * mean, 0.0)
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        y = (x32 - mean) * mul + self.bias
        return y.to(self.dtype or torch.promote_types(x.dtype, torch.float32))


class Embed(nn.Module):
    """`flax.linen.Embed`: a float32 (num_embeddings, features) table
    `embedding` drawn from N(0, 1/features) (flax's
    variance_scaling(1.0, 'fan_in', 'normal', out_axis=0)); the lookup is
    `F.embedding`, so its gradient is a plain dense scatter, not kernel
    K1."""

    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.num_embeddings = int(num_embeddings)
        self.features = int(features)
        self.embedding = nn.Parameter(
            torch.empty((self.num_embeddings, self.features)))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            nn.init.normal_(self.embedding, 0.0,
                            math.sqrt(1.0 / self.features),
                            generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.embedding(ids, self.embedding)


def reset_tree(model: nn.Module,
               generator: Optional[torch.Generator] = None) -> None:
    """Draw every parameter (and reset every buffer) of `model`'s layers:
    `reset_parameters(generator)` of each submodule that has one, in
    registration order."""
    for module in model.modules():
        if module is not model and hasattr(module, "reset_parameters"):
            module.reset_parameters(generator)


Padding = Union[str, Sequence[Tuple[int, int]]]


def _same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial axis: the output has
    ceil(size / stride) positions and the pad, low half first, is split
    (total // 2, total - total // 2), so a stride-2 3x3 conv over an even
    side pads (0, 1) where torch's padding=1 would pad (1, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """`flax.linen.Conv` over NCHW inputs, 2-D: `weight` (out, in, kh, kw),
    optional `bias`; padding "SAME" (flax's default, XLA's rule: see
    `_same_pads`), "VALID" or explicit ((lo, hi), (lo, hi)).

    dtype: the compute dtype. As in flax, input, weight and bias are cast
    to it, the convolution's output is rounded to it and the bias added in
    it. Initializers: truncated lecun_normal over fan_in = in x kh x kw,
    zero bias (flax's defaults)."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Tuple[int, int], strides: Tuple[int, int] = (1, 1),
                 padding: Padding = "SAME", use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.in_features = int(in_features)
        self.features = int(features)
        self.kernel_size = tuple(int(k) for k in kernel_size)
        self.strides = tuple(int(s) for s in strides)
        self.padding = padding
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty((self.features, self.in_features) + self.kernel_size))
        self.bias = (nn.Parameter(torch.empty((self.features,)))
                     if use_bias else None)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        fan_in = self.in_features * self.kernel_size[0] * self.kernel_size[1]
        std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, 0.0, std, -2.0 * std,
                                  2.0 * std, generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def _pads(self, x: torch.Tensor):
        if self.padding == "VALID":
            return (0, 0), (0, 0)
        if self.padding == "SAME":
            return tuple(_same_pads(x.shape[2 + i], self.kernel_size[i],
                                    self.strides[i]) for i in range(2))
        return tuple(tuple(int(p) for p in pair) for pair in self.padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        x = x.to(dtype)
        (top, bottom), (left, right) = self._pads(x)
        if top == bottom and left == right:
            padding = (top, left)
        else:
            x = F.pad(x, (left, right, top, bottom))
            padding = (0, 0)
        y = F.conv2d(x, self.weight.to(dtype), stride=self.strides,
                     padding=padding)
        if self.bias is not None:
            y = y + self.bias.to(dtype).reshape(1, -1, 1, 1)
        return y


def max_pool(x: torch.Tensor, window: Tuple[int, int],
             strides: Tuple[int, int], padding=((0, 0), (0, 0))):
    """`flax.linen.max_pool` over NCHW: padding VALID by default, or
    symmetric explicit pads, which read as -inf (flax's init value)."""
    (top, bottom), (left, right) = padding
    if top != bottom or left != right:
        raise ValueError(f"max_pool takes symmetric pads, got {padding}")
    return F.max_pool2d(x, window, strides, padding=(top, left))


class BatchNorm(nn.Module):
    """`flax.linen.BatchNorm` over the channel axis (1) of NCHW or (N, C)
    inputs, with flax's arithmetic rather than `F.batch_norm`'s:

    - training: the batch's mean and variance in float32, the variance
      the fast biased one, E[x^2] - E[x]^2 clamped at 0; under a mesh
      (inside the trainer's `parallel.mesh.batch_block_of`) over the
      global batch, the per-rank sums all-reduced over data
      (`parallel.mesh.sum_over_data`), as the reference's GSPMD step
      computes them. Eval: the running averages.
    - y = (x - mean) * (rsqrt(var + epsilon) * scale) + bias in float32,
      cast to `dtype` once at the end (None: the input's dtype promoted
      with float32).
    - The running averages (`mean`, zeros, and `var`, ones: float32
      buffers) move as ra = momentum * ra + (1 - momentum) * batch, with
      the biased variance, but not inside `forward`: a training forward
      leaves the batch's statistics in `pending`, and
      `update_batch_stats(model)` applies them. The trainer calls it once
      after each training forward, so a remat recompute (which runs the
      forward again in the backward) or a caller's extra forward moves
      nothing, as the reference's functional `new_vars` come from the
      primal pass only.

    Parameters `scale` (ones; zeros with `zero_scale`, the last BN of a
    residual block) and `bias` (zeros), float32.
    """

    def __init__(self, features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, dtype: Optional[torch.dtype] = None,
                 zero_scale: bool = False):
        super().__init__()
        self.features = int(features)
        self.momentum = float(momentum)
        self.epsilon = float(epsilon)
        self.dtype = dtype
        self.zero_scale = bool(zero_scale)
        self.scale = nn.Parameter(torch.empty((self.features,)))
        self.bias = nn.Parameter(torch.empty((self.features,)))
        self.register_buffer("mean", torch.zeros((self.features,)))
        self.register_buffer("var", torch.ones((self.features,)))
        self.pending: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        del generator
        with torch.no_grad():
            self.scale.fill_(0.0 if self.zero_scale else 1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)
        self.pending = None

    def _batch_stats(self, x32: torch.Tensor):
        dims = [0] + list(range(2, x32.dim()))
        if mesh_lib.in_data_parallel_block():
            sums = torch.stack([x32.sum(dims), (x32 * x32).sum(dims)])
            sums, rows = mesh_lib.sum_over_data(sums)
            count = rows * (x32.numel() // (x32.shape[0] * x32.shape[1]))
            mu, mu2 = sums[0] / count, sums[1] / count
        else:
            mu, mu2 = x32.mean(dims), (x32 * x32).mean(dims)
        return mu, torch.clamp_min(mu2 - mu * mu, 0.0)

    def forward(self, x: torch.Tensor, training: bool) -> torch.Tensor:
        x32 = x.to(torch.float32)
        if training:
            mean, var = self._batch_stats(x32)
            self.pending = (mean.detach(), var.detach())
        else:
            mean, var = self.mean, self.var
        shape = (1, -1) + (1,) * (x.dim() - 2)
        y = x32 - mean.reshape(shape)
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        y = y * mul.reshape(shape) + self.bias.reshape(shape)
        return y.to(self.dtype or torch.promote_types(x.dtype, torch.float32))


class MoE(nn.Module):
    """Switch-style top-1 Mixture-of-Experts FFN (`ops.moe.switch_moe`),
    the reference's `api.layers.MoE`.

    Parameters, float32: `router` (C, E) and the stacked experts `w1`
    (E, C, H), `b1` (E, H), `w2` (E, H, C), `b2` (E, C); the router and
    the expert kernels start from normal(0.02), the biases from zero.
    `shard(mesh)` keeps this rank's experts on the mesh's `expert` axis
    (`ops.moe.expert_range`); without one the experts are replicated.

    The output is residual (x + the expert mix; dropped tokens pass
    through) unless `residual=False`. A training forward leaves the
    Switch load-balancing aux loss, live, in `pending`: the trainer adds
    its weighted sum into the differentiated loss (`aux_losses`), and
    `update_batch_stats` moves it into the `moe_aux` buffer once, with
    overwrite semantics (the reference sows it into its `losses`
    collection), never from a remat recompute."""

    def __init__(self, features: int, num_experts: int, hidden_dim: int,
                 capacity_factor: float = 1.25, residual: bool = True):
        super().__init__()
        self.features = int(features)
        self.num_experts = int(num_experts)
        self.hidden_dim = int(hidden_dim)
        self.capacity_factor = float(capacity_factor)
        self.residual = bool(residual)
        c, e, h = self.features, self.num_experts, self.hidden_dim
        self.router = nn.Parameter(torch.empty((c, e)))
        self._expert_shapes = {"w1": (e, c, h), "b1": (e, h),
                               "w2": (e, h, c), "b2": (e, c)}
        for name, shape in self._expert_shapes.items():
            setattr(self, name, nn.Parameter(torch.empty(shape)))
        self.register_buffer("moe_aux", torch.zeros(()))
        self.mesh: Optional[mesh_lib.Mesh] = None
        self.experts: Optional[mesh_lib.RowShard] = None
        self.pending: Optional[torch.Tensor] = None

    def shard(self, mesh: mesh_lib.Mesh) -> None:
        from elasticdl_tpu_torch.ops import moe as moe_ops

        if mesh.axis_size(MeshAxis.SEQ) > 1:
            raise NotImplementedError(
                "the MoE routes the data axis's tokens; a "
                f"{MeshAxis.SEQ!r} mesh axis beside it is ROADMAP item 35")
        if mesh.axis_size(moe_ops.EXPERT_AXIS) == 1:
            return
        self.mesh = mesh
        self.experts = moe_ops.expert_range(mesh, self.num_experts)
        for name, shape in self._expert_shapes.items():
            setattr(self, name, nn.Parameter(torch.empty(
                (self.experts.size,) + shape[1:],
                device=self.router.device)))

    def shards(self):
        if self.experts is None:
            return {}
        return {name: self.experts for name in self._expert_shapes}

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        dev = self.router.device
        with torch.no_grad():
            nn.init.normal_(self.router, 0.0, 0.02, generator=generator)
            for name, shape in self._expert_shapes.items():
                full = torch.zeros(shape, device=dev)
                if name.startswith("w"):
                    nn.init.normal_(full, 0.0, 0.02, generator=generator)
                _keep_part(getattr(self, name), full, self.experts)
            self.moe_aux.zero_()
        self.pending = None

    def forward(self, x: torch.Tensor, training: bool = False) -> torch.Tensor:
        from elasticdl_tpu_torch.ops import moe as moe_ops

        flat = x.reshape(-1, x.shape[-1])
        out, aux = moe_ops.switch_moe(
            flat, self.router, self.w1, self.b1, self.w2, self.b2,
            self.capacity_factor, experts=self.experts, mesh=self.mesh)
        if training:
            self.pending = aux
        out = out.reshape(x.shape)
        return x + out if self.residual else out


def aux_losses(model: nn.Module) -> List[torch.Tensor]:
    """The live aux losses the last training forward left (each MoE's
    `pending`)."""
    return [m.pending for m in model.modules()
            if isinstance(m, MoE) and m.pending is not None]


def drop_pending(model: nn.Module) -> None:
    """Forget what a forward left pending (a remat recompute's)."""
    for m in model.modules():
        if isinstance(m, (BatchNorm, MoE)):
            m.pending = None


@torch.no_grad()
def update_batch_stats(model: nn.Module) -> None:
    """Apply each BatchNorm's `pending` batch statistics to its running
    averages (flax's update, in float32), move each MoE's pending aux
    loss into its `moe_aux` buffer, and clear them."""
    for m in model.modules():
        if isinstance(m, BatchNorm) and m.pending is not None:
            mean, var = m.pending
            m.pending = None
            m.mean.copy_(m.momentum * m.mean + (1 - m.momentum) * mean)
            m.var.copy_(m.momentum * m.var + (1 - m.momentum) * var)
        elif isinstance(m, MoE) and m.pending is not None:
            m.moe_aux.copy_(m.pending.detach())
            m.pending = None
