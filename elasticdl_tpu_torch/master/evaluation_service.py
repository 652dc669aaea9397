"""Evaluation scheduling and cross-worker metric aggregation.

Reference parity: elasticdl/python/master/evaluation_service.py — the master
triggers an evaluation job every `evaluation_steps` completed training tasks
(or at epoch end), workers run the eval tasks, and the master aggregates
their reports into job metrics. The reference shipped raw model outputs +
labels to the master; here workers send fixed-size *additive metric states*
(see training/metrics.py) so aggregation is a vector sum and the wire cost is
O(metrics), not O(dataset).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

import numpy as np

from elasticdl_tpu_torch.common.log_utils import default_logger
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher

logger = default_logger(__name__)


class _EvalJob:
    def __init__(self, job_id: int, num_tasks: int, model_version: int):
        self.job_id = job_id
        self.num_tasks = num_tasks
        self.reported_task_ids: set = set()
        self.model_version = model_version
        self.states: Dict[str, np.ndarray] = {}

    @property
    def complete(self) -> bool:
        return len(self.reported_task_ids) >= self.num_tasks


class EvaluationService:
    def __init__(
        self,
        dispatcher: TaskDispatcher,
        metrics: Optional[Dict[str, object]] = None,  # name -> Metric
        evaluation_steps: int = 0,
        start_delay_steps: int = 0,
    ):
        self._lock = threading.Lock()
        self._dispatcher = dispatcher
        self._metrics = metrics or {}
        self._evaluation_steps = evaluation_steps
        self._start_delay = start_delay_steps
        self._next_job_id = 0                        # guarded_by: _lock
        self._jobs: Dict[int, _EvalJob] = {}         # guarded_by: _lock
        self._last_trigger_version = 0               # guarded_by: _lock
        self._latest_model_version = 0               # guarded_by: _lock
        self._latest_results: Dict[str, float] = {}  # guarded_by: _lock
        # registration-before-start contract; fired outside the lock
        self._result_callbacks: List[Callable[[int, Dict[str, float]], None]] = []
        dispatcher.add_epoch_end_callback(self._on_epoch_end)
        dispatcher.add_task_failed_callback(self._on_task_failed)

    def add_result_callback(
        self, cb: Callable[[int, Dict[str, float]], None]
    ) -> None:
        """cb(model_version, results) on each completed eval job — the hook
        early-stopping / best-checkpoint callbacks attach to."""
        self._result_callbacks.append(cb)

    # ------------------------------------------------------------------ #

    def maybe_trigger(self, model_version: Optional[int] = None) -> Optional[int]:
        """Called after each finished training task; starts an eval job every
        `evaluation_steps` MODEL-VERSION steps (minibatches — the reference's
        unit for --evaluation_steps; workers report their model_version with
        each task result, so the servicer passes it here). Falls back to the
        completed-task counter when no version is supplied (tests, legacy
        callers). The threshold check claims `_last_trigger_version` under
        the lock so concurrent report handlers can't double-trigger."""
        version = (
            model_version
            if model_version is not None
            else self._dispatcher.completed_versions
        )
        with self._lock:
            # tracked even when interval evals are off: epoch-end evals use
            # it so their scalars land on the same model_version axis as the
            # train-loss stream
            self._latest_model_version = max(self._latest_model_version, version)
        if not self._evaluation_steps:
            return None
        with self._lock:
            if version < self._start_delay:
                return None
            if version < self._last_trigger_version:
                # the step counter went BACKWARDS: a worker relaunched
                # without a checkpoint to restore (fresh model_version).
                # Re-base the threshold or evals would silently stop for
                # last_trigger_version - version further steps.
                logger.warning(
                    "model_version regressed %d -> %d (worker relaunch "
                    "without restore); re-basing eval trigger",
                    self._last_trigger_version, version,
                )
                self._last_trigger_version = version
                return None
            if version - self._last_trigger_version < self._evaluation_steps:
                return None
            self._last_trigger_version = version
        return self.trigger(version)

    def _on_epoch_end(self, epoch: int) -> None:
        with self._lock:
            version = max(
                self._latest_model_version, self._dispatcher.completed_versions
            )
        self.trigger(version)

    def trigger(self, model_version: int) -> Optional[int]:
        # register the job BEFORE its tasks hit the queue — a fast worker can
        # lease + report one before create_evaluation_tasks returns
        n = self._dispatcher.num_evaluation_tasks()
        if n == 0:
            return None
        with self._lock:
            job_id = self._next_job_id
            self._next_job_id += 1
            self._last_trigger_version = model_version
            self._jobs[job_id] = _EvalJob(job_id, n, model_version)
        self._dispatcher.create_evaluation_tasks(job_id)
        logger.info("triggered eval job %d at version %d", job_id, model_version)
        return job_id

    def report_metrics(
        self, eval_job_id: int, task_id: int, states: Dict[str, np.ndarray]
    ) -> None:
        """Merge one eval *task*'s metric states (additive). Duplicate
        reports of a task (lease expiry + re-execution) are dropped."""
        done: Optional[_EvalJob] = None
        with self._lock:
            job = self._jobs.get(eval_job_id)
            if job is None:
                logger.warning("metrics for unknown eval job %d", eval_job_id)
                return
            if task_id in job.reported_task_ids:
                logger.info(
                    "duplicate metrics for eval job %d task %d ignored",
                    eval_job_id, task_id,
                )
                return
            job.reported_task_ids.add(task_id)
            for name, state in states.items():
                if name in job.states:
                    job.states[name] = job.states[name] + np.asarray(state)
                else:
                    job.states[name] = np.asarray(state).copy()
            if job.complete:
                done = self._jobs.pop(eval_job_id)
        if done is not None:
            self._finalize(done)

    def _on_task_failed(self, task) -> None:
        """A permanently failed eval task can never report — shrink the
        job's expectation so it still finalizes."""
        from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb

        if task.type != pb.EVALUATION:
            return
        done: Optional[_EvalJob] = None
        with self._lock:
            job = self._jobs.get(task.eval_job_id)
            if job is None:
                return
            job.num_tasks -= 1
            logger.warning(
                "eval job %d lost task %d permanently; expecting %d tasks",
                job.job_id, task.task_id, job.num_tasks,
            )
            if job.complete:
                done = self._jobs.pop(job.job_id)
        if done is not None:
            self._finalize(done)

    def _finalize(self, job: _EvalJob) -> None:
        results: Dict[str, float] = {}
        for name, metric in self._metrics.items():
            if name in job.states:
                results[name] = float(metric.result(job.states[name]))
        loss_state = job.states.get("_loss")
        if loss_state is not None and loss_state[1] > 0:
            results["loss"] = float(loss_state[0] / loss_state[1])
        with self._lock:
            self._latest_results = results
        logger.info(
            "eval job %d done (model v%d): %s", job.job_id, job.model_version, results
        )
        for cb in self._result_callbacks:
            cb(job.model_version, results)

    def latest_results(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._latest_results)
