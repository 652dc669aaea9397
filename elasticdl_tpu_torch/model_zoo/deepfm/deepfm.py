"""DeepFM on Criteo-style data — the port's twin of
`model_zoo/deepfm/deepfm.py`.

One embedding table shared by the 26 categorical fields (ids offset per
field) carries the D-dim FM/DNN vectors and, as column D, the per-id
first-order weight. FM first and second order run in float32; the DNN
tower runs in `compute_dtype` with flax's rounding points (see
`api.layers.Dense`); `dense_linear`, `dnn_out` and the logit are float32.

Input features:
  "dense": (B, 13) float32 raw counts (log1p applied in the forward)
  "cat":   (B, 26) int32 raw categorical values (hashed in the forward
           into per-field buckets)
Labels: (B,) {0,1} click. Output: (B,) logits.

Parameter names follow the flax module's (`fm_embedding.table`,
`dense_linear`, `dnn_{i}`, `dnn_out`, `bias`), so `convert.py` maps one
onto the other by name.
"""

import functools
from typing import Optional, Sequence

import torch
from torch import nn

from elasticdl_tpu_torch.api import feature_spec as fs
from elasticdl_tpu_torch.api.layers import Dense, Embedding, dropout
from elasticdl_tpu_torch.training import lr_modulation
from elasticdl_tpu_torch.training import metrics as metrics_lib

NUM_DENSE = 13
NUM_CAT = 26


@functools.lru_cache(maxsize=None)
def feature_spec(field_vocab: int) -> fs.FeatureSpec:
    """The Criteo schema: 13 log-squashed integer counts + 26 hashed
    categorical fields sharing one offset id space of NUM_CAT * field_vocab
    rows."""
    return fs.FeatureSpec(
        [fs.numeric(f"i{j}", log1p=True, source=("dense", j))
         for j in range(NUM_DENSE)]
        + [fs.hashed(f"c{j}", field_vocab, source=("cat", j))
           for j in range(NUM_CAT)]
    )


class DeepFM(nn.Module):
    def __init__(self, field_vocab: int = 100_000, embedding_dim: int = 16,
                 hidden: Sequence[int] = (400, 400), dropout: float = 0.0,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 embedding_mode: str = "manual"):
        super().__init__()
        self.field_vocab = int(field_vocab)
        self.embedding_dim = int(embedding_dim)
        self.hidden = tuple(int(h) for h in hidden)
        self.dropout = float(dropout)
        self.compute_dtype = compute_dtype
        self.spec = feature_spec(self.field_vocab)
        self.fm_embedding = Embedding(
            self.spec.total_vocab, self.embedding_dim + 1,
            mode=embedding_mode)
        self.dense_linear = Dense(NUM_DENSE, 1, dtype=torch.float32)
        width = NUM_CAT * self.embedding_dim + NUM_DENSE
        for i, h in enumerate(self.hidden):
            setattr(self, f"dnn_{i}", Dense(width, h, dtype=compute_dtype))
            width = h
        self.dnn_out = Dense(width, 1, dtype=torch.float32)
        self.bias = nn.Parameter(torch.empty((1,), dtype=torch.float32))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Draw every parameter from flax's default distributions."""
        self.fm_embedding.reset_parameters(generator)
        self.dense_linear.reset_parameters(generator)
        for i in range(len(self.hidden)):
            getattr(self, f"dnn_{i}").reset_parameters(generator)
        self.dnn_out.reset_parameters(generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, feats, training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        t = self.spec.device_transform(
            {"dense": feats["dense"], "cat": feats["cat"]})
        dense, ids = t["dense"], t["cat"]                       # (B,13) (B,26)

        emb_all = self.fm_embedding(ids)                        # (B, 26, D+1)
        emb, lin = emb_all[..., :-1], emb_all[..., -1]

        # FM second order: 0.5 * ((sum_f v_f)^2 - sum_f v_f^2), summed over D
        sum_v = torch.sum(emb, dim=1)
        fm2 = 0.5 * torch.sum(
            sum_v * sum_v - torch.sum(emb * emb, dim=1), dim=-1)

        first_order = torch.sum(lin, dim=1) + self.dense_linear(dense).reshape(-1)

        x = torch.cat(
            [emb.reshape(emb.shape[0], -1), dense], dim=-1
        ).to(self.compute_dtype)
        for i in range(len(self.hidden)):
            x = torch.relu(getattr(self, f"dnn_{i}")(x))
            if training and self.dropout > 0:
                # drawn from `generator`, which the trainer rewinds for a
                # remat recompute (`Trainer._forward`), for the global
                # batch under a mesh
                x = dropout(x, self.dropout, generator)
        dnn_out = self.dnn_out(x).reshape(-1)

        return first_order + fm2.to(torch.float32) + dnn_out + self.bias[0]


def custom_model(**kwargs):
    dtype = kwargs.get("compute_dtype", "bfloat16")
    return DeepFM(
        field_vocab=int(kwargs.get("field_vocab", 100_000)),
        embedding_dim=int(kwargs.get("embedding_dim", 16)),
        hidden=tuple(
            int(h) for h in str(kwargs.get("hidden", "400,400")).split(",")
        ),
        dropout=float(kwargs.get("dropout", 0.0)),
        compute_dtype=(dtype if isinstance(dtype, torch.dtype)
                       else getattr(torch, str(dtype))),
        embedding_mode=str(kwargs.get("embedding_mode", "manual")),
    )


def loss(labels, outputs):
    """Per-example sigmoid cross-entropy on logits (optax's
    `sigmoid_binary_cross_entropy`)."""
    return torch.nn.functional.binary_cross_entropy_with_logits(
        outputs, labels.to(torch.float32).reshape(-1), reduction="none")


def optimizer(**kwargs):
    # Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8); gradients
    # are dense over the whole table, so every row's slots update each
    # step, as in the reference
    return lr_modulation.modulated(
        torch.optim.Adam,
        learning_rate=float(kwargs.get("learning_rate", 1e-3)),
        betas=(0.9, 0.999), eps=1e-8)


def dataset_fn(mode, metadata):
    """Batch-parse Criteo records with the port's parsers
    (`data/parsing.py`, the reference's batch-parser contract): fixed-width
    binary `.cbin` shards when the reader's metadata says so, else TSV
    (label, 13 ints, 26 hex categoricals) through the native C++ parser."""
    from elasticdl_tpu_torch.data import parsing

    if metadata and "record_bytes" in metadata:
        expect = parsing.criteo_bin_record_bytes(NUM_DENSE, NUM_CAT)
        if metadata["record_bytes"] != expect:
            raise ValueError(
                f"binary reader record_bytes={metadata['record_bytes']} does "
                f"not match the Criteo layout ({expect})"
            )
        return parsing.criteo_bin_batch_parser(NUM_DENSE, NUM_CAT)
    return parsing.criteo_batch_parser(num_dense=NUM_DENSE, num_cat=NUM_CAT)


def prediction_outputs_processor():
    """Prediction-job hook: streams each minibatch's outputs to
    EDL_PREDICT_OUT (default ./predictions) as per-worker .npy files."""
    import os

    from elasticdl_tpu_torch.worker.prediction_outputs_processor import (
        NpyPredictionOutputsProcessor,
    )

    return NpyPredictionOutputsProcessor(
        os.environ.get("EDL_PREDICT_OUT", "predictions")
    )


def eval_metrics_fn():
    return {"auc": metrics_lib.AUC(), "accuracy": metrics_lib.Accuracy()}
