"""Prediction-output hooks for prediction jobs.

Counterpart of `elasticdl_tpu/worker/prediction_outputs_processor.py`:
`BasePredictionOutputsProcessor.process(predictions, worker_id)` is
invoked by the worker with each minibatch of prediction outputs, as host
numpy with the padding rows removed. Users subclass it in their model-zoo
module and expose it via a module-level `prediction_outputs_processor()`
factory (see ModelSpec.from_config). Outputs may be a tensor or any
nesting of dicts, lists and tuples of tensors whose leaves share the
batch's leading dim.
"""

from __future__ import annotations

import os
from typing import Any, List

import numpy as np
import torch

from elasticdl_tpu_torch.data.prefetch import tree_map


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.to(torch.float32)
        return leaf.numpy()
    return np.asarray(leaf)


def mask_predictions(outputs: Any, valid: np.ndarray) -> Any:
    """Drop padding rows from prediction outputs of any nesting.

    `predict_step` returns whatever the model's forward returns — a
    tensor, a dict, a tuple. Every leaf comes back as host numpy with only
    the `valid` rows; a plain tensor comes back a plain array.
    """
    return tree_map(lambda leaf: _host(leaf)[valid], outputs)


def iter_stacked(outputs: Any, k: int):
    """Yield the k per-batch outputs of a stacked result (leaves have a
    leading group dim of k), as host numpy."""
    leaves = tree_map(_host, outputs)
    for i in range(k):
        yield tree_map(lambda leaf: leaf[i], leaves)


class BasePredictionOutputsProcessor:
    """Subclass and override `process`. The default is a no-op."""

    def process(self, predictions: Any, worker_id: int) -> None:
        """Called once per prediction minibatch with host-numpy outputs
        (padding rows already removed)."""

    def close(self) -> None:
        """Called once when the worker finishes its prediction tasks."""


class InMemoryPredictionOutputsProcessor(BasePredictionOutputsProcessor):
    """Accumulates all outputs in memory — tests and small jobs."""

    def __init__(self) -> None:
        self.outputs: List[np.ndarray] = []

    def process(self, predictions: Any, worker_id: int) -> None:
        self.outputs.append(np.asarray(predictions))

    def result(self) -> np.ndarray:
        return (
            np.concatenate(self.outputs, axis=0)
            if self.outputs
            else np.empty((0,), np.float32)
        )


class NpyPredictionOutputsProcessor(BasePredictionOutputsProcessor):
    """Streams outputs to `<out_dir>/predictions_worker<id>_p<pid>_<n>.npy`,
    one file per minibatch — per-worker files never contend (the reference's
    processors wrote per-worker ODPS partitions for the same reason). The pid
    component keeps a relaunched worker (same worker_id, fresh counter) from
    overwriting files its previous incarnation already wrote."""

    def __init__(self, out_dir: str) -> None:
        self.out_dir = os.path.abspath(out_dir)
        self._n = 0
        self._made_dir = False  # deferred: ModelSpec constructs processors
        # for every job type, and a training job must not mkdir as a side
        # effect (or crash in a read-only cwd)

    def process(self, predictions: Any, worker_id: int) -> None:
        if not self._made_dir:
            os.makedirs(self.out_dir, exist_ok=True)
            self._made_dir = True
        path = os.path.join(
            self.out_dir,
            f"predictions_worker{worker_id}_p{os.getpid()}_{self._n:06d}.npy",
        )
        np.save(path, np.asarray(predictions))
        self._n += 1
