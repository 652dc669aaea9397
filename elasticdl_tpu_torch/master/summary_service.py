"""Training summaries: JSONL event log + optional TensorBoard files.

Reference parity: elasticdl/python/master/tensorboard_service.py — the master
optionally wrote TF summaries of training loss and evaluation metrics. Here
the master always writes a machine-readable `events.jsonl` (one JSON object
per line: {"step", "wall_time", <scalars>}) under <summary_dir>/<role>/ and,
when TensorFlow is importable, mirrors the scalars into TensorBoard event
files so `tensorboard --logdir` works exactly as it did for the reference.

Control-plane metrics ride the same stream: `maybe_snapshot_registry`
periodically writes the observability registry's snapshot into a
`control/` scalar stream, so events.jsonl/TensorBoard carry compile-cache
hit rates, RPC retries, and lease churn alongside loss.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Optional

from elasticdl_tpu_torch.common.log_utils import default_logger
from elasticdl_tpu_torch.observability.registry import (
    MetricsRegistry,
    default_registry,
)

logger = default_logger(__name__)


class SummaryWriter:
    """One scalar stream (e.g. 'train' or 'eval')."""

    def __init__(self, directory: str):
        os.makedirs(directory, exist_ok=True)
        # guarded_by: _lock
        self._jsonl = open(os.path.join(directory, "events.jsonl"), "a")
        self._lock = threading.Lock()
        self._tf_writer = None               # guarded_by: _lock
        # resolve the module ONCE: the old code re-imported tensorflow
        # inside the lock on every scalars() call — sys.modules makes that
        # a dict hit, but it still serialized an import-lock acquisition
        # into every report under this writer's lock
        self._tf = None
        try:
            import tensorflow as tf

            self._tf = tf
            self._tf_writer = tf.summary.create_file_writer(directory)
        except Exception:
            # TF-less deployments still get the JSONL stream
            self._tf = None
            self._tf_writer = None

    def scalars(self, step: int, values: Dict[str, float]) -> None:
        rec = {"step": int(step), "wall_time": time.time()}
        rec.update({k: float(v) for k, v in values.items()})
        with self._lock:
            if self._jsonl.closed:
                return
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()
            if self._tf_writer is not None:
                tf = self._tf
                with self._tf_writer.as_default():
                    for name, value in values.items():
                        tf.summary.scalar(name, float(value), step=int(step))
                self._tf_writer.flush()

    def close(self) -> None:
        with self._lock:
            if not self._jsonl.closed:
                # fsync before close: a worker killed right after close()
                # returns must still find every line on disk — the chaos
                # tests race exactly this window
                try:
                    self._jsonl.flush()
                    # teardown of a leaf writer lock (never held by
                    # control-plane mutators): edl-lint: disable=EDL403,EDL103
                    os.fsync(self._jsonl.fileno())
                except (OSError, ValueError):
                    logger.exception("events.jsonl fsync failed")
                self._jsonl.close()
            if self._tf_writer is not None:
                self._tf_writer.close()


class SummaryService:
    """Master-side aggregation point: training loss per task report, eval
    metrics per finished eval job, periodic control-plane registry
    snapshots."""

    def __init__(self, summary_dir: str,
                 registry: Optional[MetricsRegistry] = None,
                 snapshot_interval_s: float = 10.0):
        self._dir = os.path.abspath(summary_dir)
        self._train = SummaryWriter(os.path.join(self._dir, "train"))
        # lazily created on the first eval result, which arrives on a gRPC
        # handler thread — two eval jobs can finalize concurrently, so the
        # check-then-create must be locked (edl-lint EDL101 find: the old
        # unlocked version could build two writers and leak one)
        self._eval_lock = threading.Lock()
        self._eval: Optional[SummaryWriter] = None   # guarded_by: _eval_lock
        # control-plane registry snapshot stream (lazy, like eval)
        self._registry = registry or default_registry()
        self._snapshot_interval_s = snapshot_interval_s
        self._control_lock = threading.Lock()
        self._control: Optional[SummaryWriter] = None  # guarded_by: _control_lock
        self._last_snapshot = 0.0                      # guarded_by: _control_lock

    def on_task_report(self, model_version: int, loss_sum: float, loss_count: int,
                       step_time_sum: float = 0.0, step_count: int = 0) -> None:
        if loss_count > 0:
            scalars = {"loss": loss_sum / loss_count}
            if step_count > 0:
                # per-step wall time (ms), as measured around the worker's
                # blocking train step — SURVEY §5's "do better than the
                # reference here cheaply" observability item
                scalars["step_time_ms"] = 1e3 * step_time_sum / step_count
            self._train.scalars(model_version, scalars)

    def on_eval_results(self, model_version: int, results: Dict[str, float]) -> None:
        with self._eval_lock:
            if self._eval is None:
                self._eval = SummaryWriter(os.path.join(self._dir, "eval"))
            writer = self._eval
        writer.scalars(model_version, results)

    # ------------------------------------------------------------------ #
    # control-plane registry stream

    def snapshot_registry(self, step: int) -> None:
        """Write the registry snapshot into the `control/` scalar stream
        now (numeric series only; label braces survive as scalar names)."""
        with self._control_lock:
            if self._control is None:
                self._control = SummaryWriter(
                    os.path.join(self._dir, "control"))
            writer = self._control
            self._last_snapshot = time.monotonic()
        snap = {
            k: v for k, v in self._registry.snapshot().items()
            if isinstance(v, (int, float))
        }
        if snap:
            writer.scalars(step, snap)

    def maybe_snapshot_registry(self, step: int) -> None:
        """Rate-limited snapshot — the master's wait loop calls this every
        poll; writes land every `snapshot_interval_s`. Never raises."""
        with self._control_lock:
            due = (
                time.monotonic() - self._last_snapshot
                >= self._snapshot_interval_s
            )
        if not due:
            return
        try:
            self.snapshot_registry(step)
        except Exception:
            logger.exception("registry snapshot failed")

    def close(self) -> None:
        # EDL103 find: writer.close() fsyncs — take the reference under
        # the service lock, do the blocking close outside it, so a slow
        # disk can't convoy a concurrent eval finalizing on a handler
        # thread behind _eval_lock
        self._train.close()
        with self._eval_lock:
            ev = self._eval
        if ev is not None:
            ev.close()
        with self._control_lock:
            ctl = self._control
        if ctl is not None:
            ctl.close()
