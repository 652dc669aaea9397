"""xDeepFM — the port's twin of `model_zoo/deepfm/xdeepfm.py`.

DeepFM's inputs, spec, table and DNN tower plus a Compressed Interaction
Network (CIN): each CIN layer is one 3-operand einsum
"ohf,bhd,bfd->bod" over the layer's weight (h, Hk, F), the previous
layer's planes (B, Hk, D) and the field embeddings (B, F, D), in
`compute_dtype`; each layer's planes summed over D feed a float32 Dense.
The table is DeepFM's `Embedding` (same id space and geometry), so its
backward is kernel K1. Loss, parsers and metrics are DeepFM's, as the
reference imports them.

Parameter names follow the flax module's (`embedding.table`,
`dense_linear`, `CIN_0.w{i}`, `cin_out`, `dnn_{i}`, `dnn_out`, `bias`),
so `convert.py` maps one onto the other by name.
"""

import math
from typing import Optional, Sequence

import torch
from torch import nn

from elasticdl_tpu_torch.api.layers import Dense, Embedding, reset_tree
from elasticdl_tpu_torch.model_zoo.deepfm.deepfm import (  # noqa: F401
    NUM_CAT,
    NUM_DENSE,
    dataset_fn,
    eval_metrics_fn,
    feature_spec,
    loss,
)
from elasticdl_tpu_torch.training import lr_modulation


class CIN(nn.Module):
    """Parameters `w{i}` (h_i, H_{i-1} x F) float32, glorot-uniform (flax's
    `glorot_uniform` on that 2-D shape), H_{-1} = F."""

    def __init__(self, num_fields: int, layer_sizes: Sequence[int],
                 compute_dtype: torch.dtype):
        super().__init__()
        self.num_fields = int(num_fields)
        self.layer_sizes = tuple(int(h) for h in layer_sizes)
        self.compute_dtype = compute_dtype
        hk = self.num_fields
        for i, h in enumerate(self.layer_sizes):
            setattr(self, f"w{i}", nn.Parameter(
                torch.empty((h, hk * self.num_fields))))
            hk = h

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            for i in range(len(self.layer_sizes)):
                w = getattr(self, f"w{i}")
                limit = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
                nn.init.uniform_(w, -limit, limit, generator=generator)

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        x0 = x0.to(self.compute_dtype)                           # (B, F, D)
        xk, outs = x0, []
        for i, h in enumerate(self.layer_sizes):
            w = getattr(self, f"w{i}").to(self.compute_dtype)
            wr = w.reshape(h, xk.shape[1], self.num_fields)
            # the outer product first, then the contraction: the order
            # opt_einsum picks for "ohf,bhd,bfd->bod" at the zoo's widths,
            # written out so that it depends neither on the batch (which
            # a traced export keeps symbolic) nor on opt_einsum
            outer = torch.einsum("bhd,bfd->bhfd", xk, x0)
            xk = torch.einsum("ohf,bhfd->bod", wr, outer)        # (B, h, D)
            outs.append(torch.sum(xk, dim=-1))                   # (B, h)
        return torch.cat(outs, dim=-1)


class XDeepFM(nn.Module):
    def __init__(self, field_vocab: int = 100_000, embedding_dim: int = 16,
                 hidden: Sequence[int] = (400, 400),
                 cin_sizes: Sequence[int] = (128, 128),
                 compute_dtype: torch.dtype = torch.bfloat16,
                 embedding_mode: str = "manual"):
        super().__init__()
        self.field_vocab = int(field_vocab)
        self.embedding_dim = int(embedding_dim)
        self.hidden = tuple(int(h) for h in hidden)
        self.compute_dtype = compute_dtype
        self.spec = feature_spec(self.field_vocab)
        self.embedding = Embedding(self.spec.total_vocab,
                                   self.embedding_dim + 1, mode=embedding_mode)
        self.dense_linear = Dense(NUM_DENSE, 1, dtype=torch.float32)
        self.CIN_0 = CIN(NUM_CAT, cin_sizes, compute_dtype)
        self.cin_out = Dense(sum(self.CIN_0.layer_sizes), 1,
                             dtype=torch.float32)
        width = NUM_CAT * self.embedding_dim + NUM_DENSE
        for i, h in enumerate(self.hidden):
            setattr(self, f"dnn_{i}", Dense(width, h, dtype=compute_dtype))
            width = h
        self.dnn_out = Dense(width, 1, dtype=torch.float32)
        self.bias = nn.Parameter(torch.empty((1,), dtype=torch.float32))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_tree(self, generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, feats, training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        del training, generator
        t = self.spec.device_transform(
            {"dense": feats["dense"], "cat": feats["cat"]})
        dense, ids = t["dense"], t["cat"]
        emb_all = self.embedding(ids)                            # (B, 26, D+1)
        emb, lin = emb_all[..., :-1], emb_all[..., -1]
        first = torch.sum(lin, dim=1) + self.dense_linear(dense).reshape(-1)
        cin_logit = self.cin_out(
            self.CIN_0(emb).to(torch.float32)).reshape(-1)
        x = torch.cat([emb.reshape(emb.shape[0], -1), dense],
                      dim=-1).to(self.compute_dtype)
        for i in range(len(self.hidden)):
            x = torch.relu(getattr(self, f"dnn_{i}")(x))
        dnn_logit = self.dnn_out(x).reshape(-1)
        return first + cin_logit + dnn_logit + self.bias[0]


def custom_model(**kwargs):
    dtype = kwargs.get("compute_dtype", "bfloat16")
    return XDeepFM(
        field_vocab=int(kwargs.get("field_vocab", 100_000)),
        embedding_dim=int(kwargs.get("embedding_dim", 16)),
        hidden=tuple(
            int(h) for h in str(kwargs.get("hidden", "400,400")).split(",")),
        cin_sizes=tuple(
            int(h) for h in str(kwargs.get("cin_sizes", "128,128")).split(",")),
        compute_dtype=(dtype if isinstance(dtype, torch.dtype)
                       else getattr(torch, str(dtype))),
        embedding_mode=str(kwargs.get("embedding_mode", "manual")),
    )


def optimizer(**kwargs):
    # Adam with optax's defaults, dense over the whole table
    return lr_modulation.modulated(
        torch.optim.Adam,
        learning_rate=float(kwargs.get("learning_rate", 1e-3)),
        betas=(0.9, 0.999), eps=1e-8)
