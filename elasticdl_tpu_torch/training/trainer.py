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
reference's `shard_batch`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from elasticdl_tpu_torch.common import runtime
from elasticdl_tpu_torch.common.log_utils import default_logger
from elasticdl_tpu_torch.training import lr_modulation
from elasticdl_tpu_torch.training import metrics as metrics_lib
from elasticdl_tpu_torch.training.model_spec import ModelSpec

logger = default_logger(__name__)


@dataclass
class TrainState:
    """The training state. `params` are the model's own parameter tensors
    (by name), which the optimizer updates in place; `optimizer` holds the
    slots (Adam's moments); `generator` draws the step's randomness
    (dropout). `step` is the global step counter and doubles as the model
    version reported to the master."""

    step: int
    params: Dict[str, torch.nn.Parameter]
    optimizer: torch.optim.Optimizer
    generator: torch.Generator

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


class Trainer:
    """Runs the train/eval/predict steps of one ModelSpec on one device.

    device: None means the GPU; with no GPU present that raises rather
    than running on the CPU. Pass device="cpu" to run on the CPU.
    """

    def __init__(self, spec: ModelSpec, device: runtime.DeviceLike = None,
                 seed: int = 0):
        self.spec = spec
        self.device = runtime.resolve_device(device)
        runtime.configure_torch_runtime()
        self.seed = seed
        self.model = spec.model
        self.metrics: Dict[str, metrics_lib.Metric] = (
            dict(spec.eval_metrics_fn()) if spec.eval_metrics_fn else {}
        )

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
        return TrainState(step=0, params=params, optimizer=optimizer,
                          generator=generator)

    # ------------------------------------------------------------------ #
    # Steps

    def compute_grads(
        self, state: TrainState, batch: Dict[str, Any]
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Forward, masked loss and backward of one batch in training
        mode. Returns (loss, {param name: gradient}); the gradients are
        also left in each parameter's `.grad` for the optimizer."""
        features, labels, mask = self._device_batch(batch)
        self.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        outputs = self.model(features, training=True,
                             generator=state.generator)
        loss = _masked_scalar_loss(self.spec.loss, labels, outputs, mask)
        loss.backward()
        return loss.detach(), {n: p.grad for n, p in state.params.items()}

    def train_step(self, state: TrainState, batch: Dict[str, Any]):
        """One optimizer step. Updates `state` in place (the reference
        donates it) and returns (state, {"loss": 0-d float32 tensor on the
        device})."""
        loss, _ = self.compute_grads(state, batch)
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss.to(torch.float32)}

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch, metric_states):
        """Update the streaming metric states (numpy float32 arrays, as
        the master merges them) and the `_loss` [sum, count] pair."""
        features, labels, mask = self._device_batch(batch)
        self.model.eval()
        outputs = self.model(features, training=False)
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

    @torch.no_grad()
    def predict_step(self, state: TrainState, batch) -> torch.Tensor:
        features, _, _ = self._device_batch(batch)
        self.model.eval()
        return self.model(features, training=False)

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
