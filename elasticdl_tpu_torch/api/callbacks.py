"""Master-side training callbacks: the model zoo's `callbacks()` contract.

Reference parity: the reference's zoo modules could export `callbacks()`
(Keras callbacks run around training) and its evaluation service had
early-stop hooks (SURVEY §2.1 evaluation service, §2.5 model zoo contract).
Rebuilt master-side: callbacks observe job-level events — completed eval
jobs, epoch ends, job end — and act through a `JobContext` capability object
(stop training, request a checkpoint). They run in the MASTER process, which
is the only place job-global signals exist (workers only see their own
tasks); this also means they need no model state and survive worker churn.

Contract: `callbacks()` in the zoo module returns a list of objects with any
subset of `on_eval_result(model_version, results)`, `on_epoch_end(epoch)`,
`on_job_end()`. Subclassing `Callback` is optional — the master wires by
duck-typing — but gives `self.ctx` for free.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

from elasticdl_tpu_torch.common.log_utils import default_logger

logger = default_logger(__name__)


class JobContext:
    """What a callback may do to the running job (capability object handed
    to callbacks by the master; see master/main.py wiring)."""

    def __init__(self, dispatcher, servicer=None, evaluation=None):
        self._dispatcher = dispatcher
        self._servicer = servicer
        self._evaluation = evaluation

    def stop_training(self, reason: str = "") -> None:
        """Stop leasing new training tasks; in-flight tasks drain, then the
        job moves to its normal end (final eval/SAVE_MODEL still run)."""
        logger.info("callback requested training stop: %s", reason or "(no reason)")
        self._dispatcher.request_stop_training(reason)

    def request_checkpoint(self, worker_id: int = 0) -> None:
        """Ask a worker (default: the checkpoint-writing worker 0) to save at
        its next task boundary, via the heartbeat should_checkpoint bit."""
        if self._servicer is not None:
            self._servicer.request_checkpoint(worker_id)

    def latest_eval_results(self) -> Dict[str, float]:
        if self._evaluation is None:
            return {}
        return self._evaluation.latest_results()

    def set_learning_rate(self, lr: float) -> None:
        """Push a job-wide LR override to every worker via the heartbeat
        stream; workers apply it at their next task boundary (needs the zoo
        optimizer built through lr_modulation.modulated). Overrides any
        worker-local elastic LR scaling."""
        logger.info("callback set learning rate to %g", lr)
        if self._servicer is not None:
            self._servicer.set_learning_rate(lr)


class Callback:
    """Optional base class; the master calls set_context before any hook."""

    ctx: Optional[JobContext] = None

    def set_context(self, ctx: JobContext) -> None:
        self.ctx = ctx

    def on_eval_result(self, model_version: int, results: Dict[str, float]) -> None:
        pass

    def on_epoch_end(self, epoch: int) -> None:
        pass

    def on_job_end(self) -> None:
        pass


class EarlyStopping(Callback):
    """Stop training when a monitored eval metric stops improving.

    Reference parity: the early-stop hook SURVEY §2.1 lists on the evaluation
    service. `patience` counts completed eval jobs without an improvement of
    at least `min_delta`; on expiry the callback stops task leasing through
    JobContext (and optionally requests a final checkpoint first).
    """

    def __init__(
        self,
        monitor: str = "loss",
        mode: str = "auto",
        patience: int = 3,
        min_delta: float = 0.0,
        checkpoint_on_stop: bool = True,
    ):
        if mode not in ("auto", "min", "max"):
            raise ValueError(f"mode must be auto|min|max, got {mode!r}")
        self.monitor = monitor
        if mode == "auto":
            # losses/errors shrink; everything else (auc, accuracy, …) grows
            mode = "min" if ("loss" in monitor or "error" in monitor) else "max"
        self.mode = mode
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.checkpoint_on_stop = checkpoint_on_stop
        self.best: float = math.inf if mode == "min" else -math.inf
        self.wait = 0
        self.stopped = False

    def _improved(self, value: float) -> bool:
        if self.mode == "min":
            return value < self.best - self.min_delta
        return value > self.best + self.min_delta

    def on_eval_result(self, model_version: int, results: Dict[str, float]) -> None:
        if self.stopped:
            return
        value = results.get(self.monitor)
        if value is None:
            logger.warning(
                "EarlyStopping monitors %r but eval results have %s",
                self.monitor, sorted(results),
            )
            return
        if self._improved(value):
            self.best = value
            self.wait = 0
            return
        self.wait += 1
        if self.wait >= self.patience:
            self.stopped = True
            reason = (
                f"{self.monitor} did not improve past {self.best:.6g} for "
                f"{self.wait} eval jobs (last {value:.6g} at v{model_version})"
            )
            if self.ctx is not None:
                if self.checkpoint_on_stop:
                    self.ctx.request_checkpoint()
                self.ctx.stop_training(reason)
            else:
                logger.warning("EarlyStopping fired without context: %s", reason)


class ReduceLROnPlateau(Callback):
    """Halve (by `factor`) the job-wide learning rate when a monitored eval
    metric plateaus — the Keras callback the reference's zoo modules could
    return, rebuilt on the master's eval stream + heartbeat LR push.

    Requires the zoo optimizer to be built via `lr_modulation.modulated`
    (injected hyperparams), like elastic LR scaling does; `initial_lr` seeds
    the schedule since the master never sees the optimizer state.
    """

    def __init__(
        self,
        initial_lr: float,
        monitor: str = "loss",
        mode: str = "auto",
        factor: float = 0.5,
        patience: int = 2,
        min_delta: float = 0.0,
        min_lr: float = 0.0,
    ):
        if not (0.0 < factor < 1.0):
            raise ValueError(f"factor must be in (0, 1), got {factor}")
        if mode not in ("auto", "min", "max"):
            raise ValueError(f"mode must be auto|min|max, got {mode!r}")
        if mode == "auto":
            mode = "min" if ("loss" in monitor or "error" in monitor) else "max"
        self.monitor = monitor
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.min_lr = min_lr
        self.lr = float(initial_lr)
        self.best: float = math.inf if mode == "min" else -math.inf
        self.wait = 0

    def _improved(self, value: float) -> bool:
        if self.mode == "min":
            return value < self.best - self.min_delta
        return value > self.best + self.min_delta

    def on_eval_result(self, model_version: int, results: Dict[str, float]) -> None:
        value = results.get(self.monitor)
        if value is None:
            logger.warning(
                "ReduceLROnPlateau monitors %r but eval results have %s",
                self.monitor, sorted(results),
            )
            return
        if self._improved(value):
            self.best = value
            self.wait = 0
            return
        self.wait += 1
        if self.wait >= self.patience and self.lr > self.min_lr:
            self.lr = max(self.min_lr, self.lr * self.factor)
            self.wait = 0
            logger.info(
                "ReduceLROnPlateau: %s plateaued at %.6g (best %.6g); "
                "lr -> %g", self.monitor, value, self.best, self.lr,
            )
            if self.ctx is not None:
                self.ctx.set_learning_rate(self.lr)
