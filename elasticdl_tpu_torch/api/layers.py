"""User-facing layers: `Embedding`, and the `Dense` layer the zoo models
use in place of `flax.linen.Dense`.

Counterpart of `elasticdl_tpu/api/layers.py`. Parameters are float32, created
empty; `reset_parameters(generator)` draws them from the same
distributions as the reference's flax initializers, from an explicit
`torch.Generator`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from elasticdl_tpu_torch.ops import embedding as emb_ops

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
    """

    def __init__(self, input_dim: int, output_dim: int,
                 combiner: Optional[str] = None, mode: str = "manual",
                 vocab_align: Optional[int] = None):
        super().__init__()
        self.input_dim = int(input_dim)
        self.output_dim = int(output_dim)
        self.combiner = combiner
        self.mode = mode
        rows = emb_ops.padded_vocab(self.input_dim, vocab_align)
        self.table = nn.Parameter(torch.empty((rows, self.output_dim)))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            nn.init.uniform_(self.table, 0.0, 0.05, generator=generator)

    def forward(self, ids: torch.Tensor,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        ids = ids.to(torch.int32)
        vectors = emb_ops.embedding_lookup(self.table, ids, mode=self.mode)
        return emb_ops.combine(vectors, self.combiner, ids, weights)


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
        std = math.sqrt(1.0 / self.in_features) / _TRUNC_STD
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, 0.0, std, -2.0 * std,
                                  2.0 * std, generator=generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        y = torch.nn.functional.linear(x.to(dtype), self.weight.to(dtype))
        return y + self.bias.to(dtype)
