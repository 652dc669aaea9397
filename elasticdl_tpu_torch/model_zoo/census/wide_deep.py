"""Census-income Wide & Deep — the port's twin of
`model_zoo/census/wide_deep.py`.

The features are declared as a `FeatureSpec` (`SPEC`, the reference's
word for word): the string columns hash on the host (crc32) in the
per-record CSV parser, the numerics standardize and the age column
bucketizes there too, so the model receives
  "dense": (B, 5) float32 standardized numerics
  "cat":   (B, 9) int32 ids in one shared id space of TOTAL_VOCAB rows.

Wide = one linear weight per id, deep = D-dim embeddings + MLP, both from
ONE `Embedding` table of D + 1 columns whose last column is the wide
weight, so one gather and one backward placement (kernel K1) serve both.
The MLP computes in `compute_dtype` (`api.layers.Dense`); `deep_out` and
the logit are float32. Labels: (B,) {0, 1}. Output: (B,) logits.

Parameter names follow the flax module's (`deep.table`, `deep_{i}`,
`deep_out`, `bias`), so `convert.py` maps one onto the other by name.
"""

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.api import feature_spec as fs
from elasticdl_tpu_torch.api.layers import Dense, Embedding, reset_tree
from elasticdl_tpu_torch.training import lr_modulation
from elasticdl_tpu_torch.training import metrics as metrics_lib

AGE_BOUNDARIES = (18, 25, 30, 35, 40, 45, 50, 55, 60, 65)

# The tabular schema as data: fixed means and stds of the UCI adult
# training split, the reference zoo's hash sizes. The categorical
# declaration order fixes the shared id space's offsets (and so the
# table's layout in checkpoints).
SPEC = fs.FeatureSpec([
    fs.numeric("age", standardize=(38.6, 13.6)),
    fs.numeric("education_num", standardize=(10.1, 2.6)),
    fs.numeric("capital_gain", standardize=(1078.0, 7385.0)),
    fs.numeric("capital_loss", standardize=(87.3, 403.0)),
    fs.numeric("hours_per_week", standardize=(40.4, 12.3)),
    fs.hashed("workclass", 64, strings=True),
    fs.hashed("education", 64, strings=True),
    fs.hashed("marital_status", 32, strings=True),
    fs.hashed("occupation", 128, strings=True),
    fs.hashed("relationship", 32, strings=True),
    fs.hashed("race", 16, strings=True),
    fs.hashed("sex", 8, strings=True),
    fs.hashed("native_country", 128, strings=True),
    fs.bucketized("age_bucket", AGE_BOUNDARIES, source="age"),
])
TOTAL_VOCAB = SPEC.total_vocab


class WideDeep(nn.Module):
    def __init__(self, embedding_dim: int = 8,
                 hidden: Sequence[int] = (128, 64),
                 compute_dtype: torch.dtype = torch.bfloat16,
                 embedding_mode: str = "manual"):
        super().__init__()
        self.embedding_dim = int(embedding_dim)
        self.hidden = tuple(int(h) for h in hidden)
        self.compute_dtype = compute_dtype
        self.deep = Embedding(TOTAL_VOCAB, self.embedding_dim + 1,
                              mode=embedding_mode)
        width = SPEC.cat_dim * self.embedding_dim + SPEC.dense_dim
        for i, h in enumerate(self.hidden):
            setattr(self, f"deep_{i}", Dense(width, h, dtype=compute_dtype))
            width = h
        self.deep_out = Dense(width, 1, dtype=torch.float32)
        self.bias = nn.Parameter(torch.empty((1,), dtype=torch.float32))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_tree(self, generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, feats, training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        del training, generator
        ids, dense = feats["cat"], feats["dense"].to(torch.float32)
        emb_all = self.deep(ids)                                 # (B, C, D+1)
        emb, wide = emb_all[..., :-1], emb_all[..., -1]
        wide_logit = torch.sum(wide, dim=1)
        x = torch.cat([emb.reshape(emb.shape[0], -1), dense],
                      dim=-1).to(self.compute_dtype)
        for i in range(len(self.hidden)):
            x = torch.relu(getattr(self, f"deep_{i}")(x))
        deep_logit = self.deep_out(x).reshape(-1)
        return wide_logit + deep_logit + self.bias[0]


def custom_model(**kwargs):
    dtype = kwargs.get("compute_dtype", "bfloat16")
    return WideDeep(
        embedding_dim=int(kwargs.get("embedding_dim", 8)),
        hidden=tuple(
            int(h) for h in str(kwargs.get("hidden", "128,64")).split(",")),
        compute_dtype=(dtype if isinstance(dtype, torch.dtype)
                       else getattr(torch, str(dtype))),
        embedding_mode=str(kwargs.get("embedding_mode", "manual")),
    )


def loss(labels, outputs):
    """Per-example sigmoid cross-entropy on logits."""
    return torch.nn.functional.binary_cross_entropy_with_logits(
        outputs, labels.to(torch.float32).reshape(-1), reduction="none")


def optimizer(**kwargs):
    # Adam with optax's defaults, dense over the whole table
    return lr_modulation.modulated(
        torch.optim.Adam,
        learning_rate=float(kwargs.get("learning_rate", 1e-3)),
        betas=(0.9, 0.999), eps=1e-8)


# CSV column order of the UCI adult dataset.
_CSV_COLUMNS = (
    "age", "workclass", "fnlwgt", "education", "education_num",
    "marital_status", "occupation", "relationship", "race", "sex",
    "capital_gain", "capital_loss", "hours_per_week", "native_country", "label",
)


def dataset_fn(mode, metadata):
    """Parse one adult-census CSV line into the model's features, with
    the parser `SPEC.csv_parser` compiles from the spec's host and numpy
    halves."""
    return SPEC.csv_parser(
        _CSV_COLUMNS,
        label_fn=lambda row: np.int32(1 if ">50K" in row.get("label", "") else 0),
    )


def eval_metrics_fn():
    return {"auc": metrics_lib.AUC(), "accuracy": metrics_lib.Accuracy()}
