"""Decoder-only transformer LM — the port's twin of
`model_zoo/transformer/transformer_lm.py`.

Each block's attention goes through `ops.attention.
sequence_parallel_attention`, which without a `seq` axis is
`full_attention`: on the card, for bfloat16 at head dim 16, 32, 64 or
128, the Hopper kernels of `csrc/flash_attention_sm90.cu` (K2' forward,
K3' and K4' backward after one delta pass), for float32 at the same
head dims their 3xTF32 twins there (K2-tf32, K3-tf32 and K4-tf32, after
a float32 delta pass), and for every other input K2, K3 and K4 of
`csrc/flash_attention.cu` (`ops/flash_attention.route` decides).
The zoo's default configuration (bf16, dim 128, 8 heads) has D 16. The q/k/v/proj/MLP products and the lm_head
are plain matmuls, as in the reference.

Rounding follows flax's: the positional add is float32 and the sum is cast
to `compute_dtype`; LayerNorm computes in float32 and casts once; Dense
rounds its product to `compute_dtype` (see `api.layers`); `lm_head` is
float32, so the logits are float32.

The reference's parallel options:

- `moe_experts` > 0 replaces each block's MLP with a Switch-MoE FFN
  (`api.layers.MoE`, named `moe`; its experts split over the mesh's
  `expert` axis when it has one); the module's `aux_loss_weight` weighs
  its load-balancing loss in training.
- `tp_axis` (typically "model"): Megatron's tensor parallelism over that
  mesh axis (`api.layers.TPDense`): q, k, v and mlp_in split by columns,
  so attention runs head-parallel, proj and mlp_out by rows, and the
  lm_head by columns over the vocab with its logits gathered. Without
  the axis every layer is a plain Dense.
- `pp_axis` (typically "pp"): the blocks become `PipelinedBlocks`, a
  GPipe pipeline over that axis (`parallel/pipeline.gpipe`), whose
  stacked stages fold in turn when the mesh lacks the axis.

On a mesh with a `seq` axis each rank holds its columns of the tokens
(`batch_partition`): the blocks' attention runs `seq_parallel`'s
schedule over the axis (ring or Ulysses, `ops/attention.py`) and the
positions are the rank's columns of `pos_embed`. Beside `tp_axis` the
schedule runs over the rank's heads (its `seq` group is the one at its
`model` coordinate), and beside the MoE the routing counts every (data,
seq) block's tokens (`ops/moe.py`). The pipelined blocks' stages, whose
attention is unsharded, run each rank's rows against the gathered
sequence (`ops.attention.gathered_attention`) where the mesh has no
`pp` axis; beside a `pp` axis a `seq` axis is refused
(`parallel.pipeline.SEQ_BESIDE_PP`).

Parameter names follow the flax module's (`tok_embed.embedding`,
`pos_embed`, `block_{i}.{q,k,v,proj,mlp_in,mlp_out}`,
`block_{i}.moe.{router,w1,b1,w2,b2}`, `block_{i}.LayerNorm_{0,1}`,
`pipeline.{ln1_scale,...,b2}`, `LayerNorm_0`, `lm_head`), so
`convert.py` maps one onto the other by name.
"""

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.api.layers import (
    MoE, Dense, Embed, LayerNorm, TPDense, dropout)
from elasticdl_tpu_torch.common.constants import MeshAxis
from elasticdl_tpu_torch.ops.attention import (
    gathered_attention, sequence_parallel_attention)
from elasticdl_tpu_torch.parallel import mesh as mesh_lib
from elasticdl_tpu_torch.parallel import pipeline
from elasticdl_tpu_torch.training import lr_modulation
from elasticdl_tpu_torch.training import metrics as metrics_lib


def _tp_dense(in_features, features, dtype, tp_axis, split, gather=False):
    """Dense with Megatron's split over `tp_axis` ("" = plain Dense)."""
    if not tp_axis:
        return Dense(in_features, features, dtype=dtype)
    return TPDense(in_features, features, dtype=dtype, axis=tp_axis,
                   split=split, gather=gather)


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, compute_dtype: torch.dtype,
                 seq_parallel: str, dropout: float, tp_axis: str = "",
                 moe_experts: int = 0):
        super().__init__()
        self.dim, self.heads = int(dim), int(heads)
        self.seq_parallel = seq_parallel
        self.dropout = float(dropout)
        self.LayerNorm_0 = LayerNorm(dim, dtype=compute_dtype)
        # separate q/k/v projections, as in the reference: their column
        # splits land on head boundaries
        for name in ("q", "k", "v"):
            setattr(self, name, _tp_dense(dim, dim, compute_dtype, tp_axis,
                                          "col"))
        self.proj = _tp_dense(dim, dim, compute_dtype, tp_axis, "row")
        self.LayerNorm_1 = LayerNorm(dim, dtype=compute_dtype)
        if moe_experts:
            self.moe = MoE(dim, moe_experts, 4 * dim, residual=False)
        else:
            self.mlp_in = _tp_dense(dim, 4 * dim, compute_dtype, tp_axis,
                                    "col")
            self.mlp_out = _tp_dense(4 * dim, dim, compute_dtype, tp_axis,
                                     "row")

    def forward(self, x, training: bool,
                generator: Optional[torch.Generator] = None):
        B, T, C = x.shape
        h = self.LayerNorm_0(x)
        q, k, v = self.q(h), self.k(h), self.v(h)
        # under tensor parallelism each rank holds heads / tp of them
        shape = (B, T, q.shape[-1] // (C // self.heads), C // self.heads)
        attn = sequence_parallel_attention(
            q.reshape(shape), k.reshape(shape), v.reshape(shape),
            causal=True, mode=self.seq_parallel, heads=self.heads)
        h = self.proj(attn.reshape(B, T, q.shape[-1]))
        if training and self.dropout > 0:
            # the mask comes from `generator`; under remat the trainer
            # rewinds it before the recompute, which so draws the same
            # mask (`training/trainer.py` `Trainer._forward`)
            h = dropout(h, self.dropout, generator)
        x = x + h
        h = self.LayerNorm_1(x)
        if hasattr(self, "moe"):
            return x + self.moe(h, training)
        h = F.gelu(self.mlp_in(h), approximate="tanh")
        return x + self.mlp_out(h)


def _stage_ln(a: torch.Tensor, scale: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
    """The pipeline's hand-rolled LayerNorm: float32, population
    variance, epsilon 1e-6, cast back once."""
    a32 = a.to(torch.float32)
    mu = a32.mean(dim=-1, keepdim=True)
    var = ((a32 - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((a32 - mu) * torch.rsqrt(var + 1e-6) * scale + bias).to(a.dtype)


class PipelinedBlocks(nn.Module):
    """`num_layers` transformer blocks run as a GPipe pipeline over the
    `pp` mesh axis (the reference's `PipelinedBlocks`): float32
    per-layer parameters stacked with a leading layer dim (`ln1_scale`,
    `ln1_bias`, `wq`, `wk`, `wv`, `wo`, `ln2_scale`, `ln2_bias`, `w1`,
    `b1`, `w2`, `b2`; kernels (in, out) as flax's), and a hand-rolled
    block as the stage. `shard(mesh)` keeps this rank's layer on a mesh
    with the axis, which must have `num_layers` ranks along it; without
    it the stacked layers fold in turn. No dropout (the stages are
    deterministic). Its attention is `full_attention` (on the card
    K2'/K3'/K4'); on a `seq` axis, which only a mesh without the `pp`
    axis may have, each rank's rows against the gathered sequence
    (`gathered_attention`)."""

    _SHAPES = (("ln1_scale", 1), ("ln1_bias", 1), ("wq", 2), ("wk", 2),
               ("wv", 2), ("wo", 2), ("ln2_scale", 1), ("ln2_bias", 1),
               ("w1", 2), ("b1", 1), ("w2", 2), ("b2", 1))

    def __init__(self, num_layers: int, dim: int, heads: int,
                 compute_dtype: torch.dtype, pp_axis: str = MeshAxis.PIPE,
                 num_microbatches: int = 4):
        super().__init__()
        self.num_layers, self.dim, self.heads = (int(num_layers), int(dim),
                                                 int(heads))
        self.compute_dtype = compute_dtype
        self.pp_axis = pp_axis
        self.num_microbatches = int(num_microbatches)
        for name, shape in self._shapes().items():
            setattr(self, name, nn.Parameter(torch.empty(shape)))
        self.mesh: Optional[mesh_lib.Mesh] = None
        self.stages: Optional[mesh_lib.RowShard] = None

    def _shapes(self) -> Dict[str, Tuple[int, ...]]:
        s, c = self.num_layers, self.dim
        inner = {"w1": (c, 4 * c), "b1": (4 * c,), "w2": (4 * c, c)}
        return {name: (s,) + inner.get(name, (c, c) if nd == 2 else (c,))
                for name, nd in self._SHAPES}

    def shard(self, mesh: mesh_lib.Mesh) -> None:
        n = mesh.axis_size(self.pp_axis)
        if n > 1 and mesh.axis_size(MeshAxis.SEQ) > 1:
            raise NotImplementedError(pipeline.SEQ_BESIDE_PP)
        if n == 1:
            return
        if n != self.num_layers:
            raise ValueError(
                f"PipelinedBlocks stack {self.num_layers} stages but mesh "
                f"axis {self.pp_axis!r} has {n} shards — they must match")
        self.mesh = mesh
        self.stages = mesh_lib.axis_rows(mesh, self.pp_axis, n)
        for name, shape in self._shapes().items():
            setattr(self, name, nn.Parameter(torch.empty(
                (1,) + shape[1:], device=self.wq.device)))

    def shards(self):
        if self.stages is None:
            return {}
        return {name: self.stages for name in self._shapes()}

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            for name, shape in self._shapes().items():
                full = torch.empty(shape, device=self.wq.device)
                if name.startswith("w"):
                    nn.init.normal_(full, 0.0, 0.02, generator=generator)
                else:
                    full.fill_(1.0 if name.endswith("scale") else 0.0)
                param = getattr(self, name)
                if self.stages is not None:
                    full = full.narrow(0, self.stages.start, 1)
                param.copy_(full)

    def _stage(self, sp: Dict[str, torch.Tensor],
               a: torch.Tensor) -> torch.Tensor:
        B, T, C = a.shape
        dt = self.compute_dtype
        h = _stage_ln(a, sp["ln1_scale"], sp["ln1_bias"])
        shape = (B, T, self.heads, C // self.heads)
        attn = gathered_attention((h @ sp["wq"].to(dt)).reshape(shape),
                                  (h @ sp["wk"].to(dt)).reshape(shape),
                                  (h @ sp["wv"].to(dt)).reshape(shape),
                                  causal=True)
        a = a + attn.reshape(B, T, C) @ sp["wo"].to(dt)
        h = _stage_ln(a, sp["ln2_scale"], sp["ln2_bias"])
        h = F.gelu(h @ sp["w1"].to(dt) + sp["b1"].to(dt), approximate="tanh")
        return a + h @ sp["w2"].to(dt) + sp["b2"].to(dt)

    def forward(self, x, training: bool = False,
                generator: Optional[torch.Generator] = None):
        del training, generator      # no dropout inside the pipeline
        params = {name: getattr(self, name) for name in self._shapes()}
        return pipeline.gpipe(self._stage, params, x,
                              num_microbatches=self.num_microbatches,
                              axis=self.pp_axis, mesh=self.mesh)


class TransformerLM(nn.Module):
    def __init__(self, vocab: int, num_layers: int, dim: int, heads: int,
                 max_len: int, compute_dtype: torch.dtype,
                 seq_parallel: str = "ring", dropout: float = 0.0,
                 tp_axis: str = "", pp_axis: str = "",
                 pp_microbatches: int = 4, moe_experts: int = 0):
        super().__init__()
        # the reference's own consistency checks
        if pp_axis and tp_axis:
            raise ValueError("pp_axis and tp_axis are mutually exclusive")
        if moe_experts and (tp_axis or pp_axis):
            raise ValueError(
                "moe_experts is mutually exclusive with tp_axis/pp_axis")
        if pp_axis and dropout > 0:
            raise ValueError(
                "pp_axis does not support dropout (pipeline stages are "
                "deterministic); set dropout=0")
        if pp_axis and seq_parallel not in ("", "none"):
            raise ValueError(
                "pp_axis runs attention unsharded inside each stage; set "
                "seq_parallel='none' (ring/Ulysses do not compose with "
                "the pipeline)")
        self.vocab, self.num_layers = int(vocab), int(num_layers)
        self.dim, self.heads, self.max_len = int(dim), int(heads), int(max_len)
        self.compute_dtype = compute_dtype
        self.tok_embed = Embed(vocab, dim)
        self.pos_embed = nn.Parameter(torch.empty((self.max_len, self.dim)))
        if pp_axis:
            self.pipeline = PipelinedBlocks(
                num_layers, dim, heads, compute_dtype, pp_axis=pp_axis,
                num_microbatches=pp_microbatches)
        else:
            for i in range(self.num_layers):
                setattr(self, f"block_{i}", Block(
                    dim, heads, compute_dtype, seq_parallel, dropout,
                    tp_axis=tp_axis, moe_experts=moe_experts))
        self.LayerNorm_0 = LayerNorm(dim, dtype=compute_dtype)
        self.lm_head = _tp_dense(dim, vocab, torch.float32, tp_axis, "col",
                                 gather=True)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Draw every parameter from flax's default distributions."""
        with torch.no_grad():
            nn.init.normal_(self.pos_embed, 0.0, 0.02, generator=generator)
        for module in self.modules():
            if module is not self and hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)

    def forward(self, tokens: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        T = tokens.shape[1]
        # on a seq axis, this rank's columns of the sequence
        cols = mesh_lib.seq_columns()
        start = 0 if cols is None else cols[1]
        x = self.tok_embed(tokens) + self.pos_embed[start:start + T][None]
        x = x.to(self.compute_dtype)
        if hasattr(self, "pipeline"):
            x = self.pipeline(x, training)
        else:
            for i in range(self.num_layers):
                x = getattr(self, f"block_{i}")(x, training, generator)
        return self.lm_head(self.LayerNorm_0(x))          # (B, T, vocab) f32


def custom_model(**kwargs) -> TransformerLM:
    dtype = kwargs.get("compute_dtype", "bfloat16")
    return TransformerLM(
        vocab=int(kwargs.get("vocab", 256)),
        num_layers=int(kwargs.get("num_layers", 2)),
        dim=int(kwargs.get("dim", 128)),
        heads=int(kwargs.get("heads", 8)),
        max_len=int(kwargs.get("max_len", 2048)),
        compute_dtype=(dtype if isinstance(dtype, torch.dtype)
                       else getattr(torch, str(dtype))),
        seq_parallel=str(kwargs.get("seq_parallel", "ring")),
        dropout=float(kwargs.get("dropout", 0.0)),
        tp_axis=str(kwargs.get("tp_axis", "")),
        pp_axis=str(kwargs.get("pp_axis", "")),
        pp_microbatches=int(kwargs.get("pp_microbatches", 4)),
        moe_experts=int(kwargs.get("moe_experts", 0)),
    )


# ModelSpec picks this up: the weight of the MoE blocks' load-balancing
# loss in training (nothing to weigh without moe_experts)
aux_loss_weight = 0.01


def batch_partition():
    """Tokens over (data, seq), the mask over data: the reference's
    partition, as axis names a dimension. An axis the mesh lacks does not
    cut."""
    return {"features": (MeshAxis.DATA, MeshAxis.SEQ),
            "labels": (MeshAxis.DATA, MeshAxis.SEQ),
            "mask": (MeshAxis.DATA,)}


def loss(labels, outputs):
    """Per-example mean next-token cross entropy: (B, T, V) + (B, T) ->
    (B,)."""
    # over (B*T, V) rows: a (B, V, T) view would take PyTorch's strided
    # "spatial" softmax, ~14 ms a step at the benchmark shape on an H100
    ce = F.cross_entropy(outputs.reshape(-1, outputs.shape[-1]),
                         labels.reshape(-1).to(torch.int64), reduction="none")
    return ce.reshape(labels.shape).mean(dim=-1)


def optimizer(**kwargs):
    # optax.adamw's defaults (b1 0.9, b2 0.999, eps 1e-8), with the decay
    # on every parameter as optax's unmasked adamw applies it
    return lr_modulation.modulated(
        torch.optim.AdamW,
        learning_rate=float(kwargs.get("learning_rate", 3e-4)),
        betas=(0.9, 0.999), eps=1e-8,
        weight_decay=float(kwargs.get("weight_decay", 0.01)))


class TokenAccuracy(metrics_lib.Metric):
    """Next-token argmax accuracy; expands the per-example mask per
    token."""

    name = "token_accuracy"

    def init_state(self) -> np.ndarray:
        return np.zeros((2,), np.float32)

    def update(self, state, labels, outputs, mask=None):
        correct = (torch.argmax(outputs, dim=-1) == labels).to(torch.float32)
        if mask is not None:
            m = mask.to(device=correct.device, dtype=torch.float32)
            correct = correct * m[:, None]
            count = torch.sum(m) * labels.shape[1]
        else:
            count = torch.tensor(float(correct.numel()), device=correct.device)
        delta = torch.stack([torch.sum(correct), count])
        return np.asarray(state, np.float32) + delta.to(
            "cpu", torch.float32).numpy()

    def result(self, state) -> float:
        return float(state[0] / max(float(state[1]), 1.0))


def eval_metrics_fn():
    return {"token_accuracy": TokenAccuracy()}


def dataset_fn(mode, metadata):
    """Parse one synthetic-lm record: uint16 tokens (T+1,) ->
    features=(T,) int32, labels=(T,) int32 shifted by one."""
    del mode, metadata

    def parse(record: bytes):
        toks = np.frombuffer(record, np.uint16).astype(np.int32)
        return toks[:-1], toks[1:]

    return parse
