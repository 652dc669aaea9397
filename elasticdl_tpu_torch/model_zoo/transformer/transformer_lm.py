"""Decoder-only transformer LM — the port's twin of
`model_zoo/transformer/transformer_lm.py`, on one device.

Each block's attention goes through `ops.attention.
sequence_parallel_attention`, which on one device is `full_attention`: the
flash kernels K2 (forward), K3 and K4 (backward) of
`csrc/flash_attention.cu` on the card. The q/k/v/proj/MLP products and the
lm_head are plain matmuls, as in the reference.

Rounding follows flax's: the positional add is float32 and the sum is cast
to `compute_dtype`; LayerNorm computes in float32 and casts once; Dense
rounds its product to `compute_dtype` (see `api.layers`); `lm_head` is
float32, so the logits are float32.

Tensor and pipeline parallelism and the Switch-MoE FFN (`tp_axis`,
`pp_axis`, `moe_experts`) need the port's mesh and MoE layers (ROADMAP
items 17 and 23); a non-default value raises NotImplementedError.

Parameter names follow the flax module's (`tok_embed.embedding`,
`pos_embed`, `block_{i}.{q,k,v,proj,mlp_in,mlp_out}`,
`block_{i}.LayerNorm_{0,1}`, `LayerNorm_0`, `lm_head`), so `convert.py`
maps one onto the other by name.
"""

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.api.layers import Dense, Embed, LayerNorm, dropout
from elasticdl_tpu_torch.ops.attention import sequence_parallel_attention
from elasticdl_tpu_torch.training import lr_modulation
from elasticdl_tpu_torch.training import metrics as metrics_lib


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, compute_dtype: torch.dtype,
                 seq_parallel: str, dropout: float):
        super().__init__()
        self.dim, self.heads = int(dim), int(heads)
        self.seq_parallel = seq_parallel
        self.dropout = float(dropout)
        self.LayerNorm_0 = LayerNorm(dim, dtype=compute_dtype)
        # separate q/k/v projections, as in the reference
        for name in ("q", "k", "v", "proj"):
            setattr(self, name, Dense(dim, dim, dtype=compute_dtype))
        self.LayerNorm_1 = LayerNorm(dim, dtype=compute_dtype)
        self.mlp_in = Dense(dim, 4 * dim, dtype=compute_dtype)
        self.mlp_out = Dense(4 * dim, dim, dtype=compute_dtype)

    def forward(self, x, training: bool,
                generator: Optional[torch.Generator] = None):
        B, T, C = x.shape
        h = self.LayerNorm_0(x)
        shape = (B, T, self.heads, C // self.heads)
        attn = sequence_parallel_attention(
            self.q(h).reshape(shape), self.k(h).reshape(shape),
            self.v(h).reshape(shape), causal=True, mode=self.seq_parallel)
        h = self.proj(attn.reshape(B, T, C))
        if training and self.dropout > 0:
            # the mask comes from `generator`; under remat the trainer
            # rewinds it before the recompute, which so draws the same
            # mask (`training/trainer.py` `Trainer._forward`)
            h = dropout(h, self.dropout, generator)
        x = x + h
        h = F.gelu(self.mlp_in(self.LayerNorm_1(x)), approximate="tanh")
        return x + self.mlp_out(h)


class TransformerLM(nn.Module):
    def __init__(self, vocab: int, num_layers: int, dim: int, heads: int,
                 max_len: int, compute_dtype: torch.dtype,
                 seq_parallel: str = "ring", dropout: float = 0.0,
                 tp_axis: str = "", pp_axis: str = "",
                 pp_microbatches: int = 4, moe_experts: int = 0):
        super().__init__()
        # the reference's own consistency checks first, then what the port
        # does not have yet
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
        if tp_axis or pp_axis or moe_experts:
            raise NotImplementedError(
                f"tp_axis={tp_axis!r}, pp_axis={pp_axis!r}, "
                f"moe_experts={moe_experts} need the port's mesh, pipeline "
                "and MoE layers (ROADMAP items 17 and 23)")
        del pp_microbatches     # used only with pp_axis
        self.vocab, self.num_layers = int(vocab), int(num_layers)
        self.dim, self.heads, self.max_len = int(dim), int(heads), int(max_len)
        self.compute_dtype = compute_dtype
        self.tok_embed = Embed(vocab, dim)
        self.pos_embed = nn.Parameter(torch.empty((self.max_len, self.dim)))
        for i in range(self.num_layers):
            setattr(self, f"block_{i}", Block(dim, heads, compute_dtype,
                                              seq_parallel, dropout))
        self.LayerNorm_0 = LayerNorm(dim, dtype=compute_dtype)
        self.lm_head = Dense(dim, vocab, dtype=torch.float32)

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
        x = self.tok_embed(tokens) + self.pos_embed[:T][None]
        x = x.to(self.compute_dtype)
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
