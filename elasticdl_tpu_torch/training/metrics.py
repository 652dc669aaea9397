"""Streaming evaluation metrics.

Counterpart of `elasticdl_tpu/training/metrics.py`. Each metric is an
(init, update, result) triple over a small float32 state array. The
update's arithmetic runs in torch on the outputs' device; the state
itself stays a numpy float32 array of exactly the reference's shape and
layout, because the master merges raw metric states from any worker by
plain addition.

`mask` is a (N,) 0/1 weight vector marking real vs padded rows.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch


def _as_mask(mask: Optional[torch.Tensor], n: int,
             device: torch.device) -> torch.Tensor:
    if mask is None:
        return torch.ones((n,), dtype=torch.float32, device=device)
    return mask.to(device=device, dtype=torch.float32).reshape(-1)


def _add(state: np.ndarray, delta: torch.Tensor) -> np.ndarray:
    return np.asarray(state, np.float32) + delta.detach().to(
        "cpu", torch.float32).numpy()


class Metric:
    """Base streaming metric. State is a flat float32 vector, additive
    across batches and across workers."""

    name = "metric"

    def init_state(self) -> np.ndarray:
        raise NotImplementedError

    def update(self, state: np.ndarray, labels: torch.Tensor,
               outputs: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> np.ndarray:
        """Return state + this batch's contribution."""
        raise NotImplementedError

    def result(self, state: np.ndarray) -> float:
        raise NotImplementedError


class Mean(Metric):
    """Weighted mean of a per-example value function (default: the
    output)."""

    name = "mean"

    def __init__(self, fn: Optional[Callable] = None):
        self._fn = fn

    def init_state(self) -> np.ndarray:
        return np.zeros((2,), np.float32)  # [sum, count]

    def update(self, state, labels, outputs, mask=None):
        v = self._fn(labels, outputs) if self._fn else outputs
        v = v.to(torch.float32).reshape(-1)
        m = _as_mask(mask, v.shape[0], v.device)
        return _add(state, torch.stack([torch.sum(v * m), torch.sum(m)]))

    def result(self, state) -> float:
        return float(state[0] / max(float(state[1]), 1.0))


class Accuracy(Metric):
    """Classification accuracy. Outputs: logits (N, C), or binary scores
    (N,) thresholded at 0.0 (`from_logits`, default) or 0.5."""

    name = "accuracy"

    def __init__(self, from_logits: bool = True):
        self.from_logits = from_logits

    def init_state(self) -> np.ndarray:
        return np.zeros((2,), np.float32)  # [correct, count]

    def update(self, state, labels, outputs, mask=None):
        labels = labels.reshape(-1)
        if outputs.dim() > 1 and outputs.shape[-1] > 1:
            pred = torch.argmax(outputs, dim=-1).reshape(-1)
        else:
            threshold = 0.0 if self.from_logits else 0.5
            pred = (outputs.reshape(-1) > threshold).to(labels.dtype)
        m = _as_mask(mask, labels.shape[0], labels.device)
        correct = torch.sum((pred == labels).to(torch.float32) * m)
        return _add(state, torch.stack([correct, torch.sum(m)]))

    def result(self, state) -> float:
        return float(state[0] / max(float(state[1]), 1.0))


class AUC(Metric):
    """Streaming binary AUC via fixed-threshold confusion-matrix bins.
    State: (4 * num_thresholds,) = [tp | fp | tn | fn], additive across
    workers; the ROC is integrated by trapezoid at result time."""

    name = "auc"

    def __init__(self, num_thresholds: int = 200, from_logits: bool = True):
        self.num_thresholds = num_thresholds
        self.from_logits = from_logits

    def init_state(self) -> np.ndarray:
        return np.zeros((4 * self.num_thresholds,), np.float32)

    def update(self, state, labels, outputs, mask=None):
        scores = outputs.to(torch.float32).reshape(-1)
        if self.from_logits:
            scores = 1.0 / (1.0 + torch.exp(-scores))
        labels = labels.to(torch.float32).reshape(-1)
        m = _as_mask(mask, labels.shape[0], labels.device)
        t = torch.linspace(0.0, 1.0, self.num_thresholds,
                           dtype=torch.float32, device=scores.device)
        pred_pos = (scores[None, :] >= t[:, None]).to(torch.float32)  # (T, N)
        lab_pos = (labels[None, :] > 0.5).to(torch.float32)           # (1, N)
        w = m[None, :]
        tp = torch.sum(pred_pos * lab_pos * w, dim=1)
        fp = torch.sum(pred_pos * (1 - lab_pos) * w, dim=1)
        fn = torch.sum((1 - pred_pos) * lab_pos * w, dim=1)
        tn = torch.sum((1 - pred_pos) * (1 - lab_pos) * w, dim=1)
        return _add(state, torch.cat([tp, fp, tn, fn]))

    def result(self, state) -> float:
        s = np.asarray(state, np.float64).reshape(4, self.num_thresholds)
        tp, fp, tn, fn = s
        tpr = tp / np.maximum(tp + fn, 1e-9)
        fpr = fp / np.maximum(fp + tn, 1e-9)
        # thresholds ascend => fpr/tpr descend; integrate |trapezoid|
        trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy<2
        return float(abs(trapezoid(tpr, fpr)))


class PrecisionRecall(Metric):
    """Streaming binary precision, recall or F1 at one decision threshold.
    State: [tp, fp, fn], additive across batches and workers; `kind`
    ('precision', 'recall' or 'f1', the default) picks what `result`
    returns, so one class serves all three under different names."""

    def __init__(self, kind: str = "f1", threshold: float = 0.5,
                 from_logits: bool = True):
        if kind not in ("precision", "recall", "f1"):
            raise ValueError(f"unknown kind {kind!r}")
        self.kind = kind
        self.name = kind
        self.threshold = threshold
        self.from_logits = from_logits

    def init_state(self) -> np.ndarray:
        return np.zeros((3,), np.float32)  # [tp, fp, fn]

    def update(self, state, labels, outputs, mask=None):
        scores = outputs.to(torch.float32).reshape(-1)
        if self.from_logits:
            scores = 1.0 / (1.0 + torch.exp(-scores))
        labels = labels.to(torch.float32).reshape(-1)
        m = _as_mask(mask, labels.shape[0], labels.device)
        pred = (scores >= self.threshold).to(torch.float32)
        lab = (labels > 0.5).to(torch.float32)
        tp = torch.sum(pred * lab * m)
        fp = torch.sum(pred * (1 - lab) * m)
        fn = torch.sum((1 - pred) * lab * m)
        return _add(state, torch.stack([tp, fp, fn]))

    def result(self, state) -> float:
        tp, fp, fn = (float(x) for x in np.asarray(state, np.float64))
        precision = tp / max(tp + fp, 1e-9)
        recall = tp / max(tp + fn, 1e-9)
        if self.kind == "precision":
            return precision
        if self.kind == "recall":
            return recall
        return 2 * precision * recall / max(precision + recall, 1e-9)


def init_states(metrics: Dict[str, Metric]) -> Dict[str, np.ndarray]:
    return {k: m.init_state() for k, m in metrics.items()}


def results(metrics: Dict[str, Metric],
            states: Dict[str, Any]) -> Dict[str, float]:
    return {k: metrics[k].result(np.asarray(states[k])) for k in metrics}
