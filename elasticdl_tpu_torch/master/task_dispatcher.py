"""Dynamic data sharding: the task queue that makes training elastic.

Reference parity: elasticdl/python/master/task_dispatcher.py — the master
keeps a `todo` queue of data-span tasks and a `doing` map of leased tasks;
workers lease tasks, report completion explicitly, and a task is only ever
marked done on such a report. Worker death ⇒ its `doing` tasks go back to
`todo`, so elasticity is data-loss-free by construction. This design is
backend-agnostic and survives the TPU rebuild unchanged in spirit; it is
re-implemented here (not translated) with lease timeouts added — the
reference relied purely on pod-death events, which misses hung workers.
"""

from __future__ import annotations

import dataclasses
import itertools
import random
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from elasticdl_tpu_torch.common.log_utils import default_logger
from elasticdl_tpu_torch.master.journal import CommitGate
from elasticdl_tpu_torch.observability import tracing
from elasticdl_tpu_torch.observability.goodput import record_wasted
from elasticdl_tpu_torch.observability.registry import default_registry
from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb

logger = default_logger(__name__)

# lease-lifecycle telemetry. Counters are process-global (one dispatcher
# per master in production; concurrent test dispatchers share the series).
_reg = default_registry()
_TASKS_LEASED = _reg.counter(
    "edl_dispatcher_tasks_leased_total", "task leases handed to workers")
_TASKS_FINISHED = _reg.counter(
    "edl_dispatcher_tasks_finished_total", "training tasks retired")
_TASKS_REQUEUED = _reg.counter(
    "edl_dispatcher_tasks_requeued_total",
    "tasks requeued (failure retry, death recovery, preemption remainder)")
_TASKS_FAILED = _reg.counter(
    "edl_dispatcher_tasks_failed_total", "tasks failed permanently")
_LEASES_EXPIRED = _reg.counter(
    "edl_dispatcher_lease_expired_total", "leases reaped by timeout")
_STALE_REPORTS = _reg.counter(
    "edl_dispatcher_stale_reports_total", "stale/unknown task reports")
_QUEUE_TODO = _reg.gauge(
    "edl_dispatcher_todo_tasks", "queued tasks")
_QUEUE_DOING = _reg.gauge(
    "edl_dispatcher_doing_tasks", "leased (in-flight) tasks")
_LEASE_BATCH = _reg.histogram(
    "edl_dispatcher_lease_batch_tasks",
    "tasks leased per GetTask round-trip (batched leases)")


@dataclass
class TaskSpec:
    task_id: int
    type: int                    # pb.TaskType value
    shard_name: str
    start: int
    end: int
    epoch: int = 0
    eval_job_id: int = -1
    retries: int = 0

    def to_proto(self) -> pb.Task:
        return pb.Task(
            task_id=self.task_id,
            type=self.type,
            shard_name=self.shard_name,
            start=self.start,
            end=self.end,
            epoch=self.epoch,
            eval_job_id=max(self.eval_job_id, 0),
        )

    @property
    def num_records(self) -> int:
        return self.end - self.start


@dataclass
class _Lease:
    worker_id: int
    task: TaskSpec
    lease_time: float


Shard = Tuple[str, int, int]  # (shard_name, start, end)


class TaskDispatcher(CommitGate):
    """Thread-safe todo/doing task queue with epochs, retries and leases."""

    def __init__(
        self,
        training_shards: List[Shard],
        evaluation_shards: Optional[List[Shard]] = None,
        prediction_shards: Optional[List[Shard]] = None,
        records_per_task: int = 4096,
        num_epochs: int = 1,
        max_task_retries: int = 3,
        shuffle: bool = True,
        shuffle_seed: int = 0,
        task_timeout_s: float = 600.0,
        final_save_model: bool = False,
        journal=None,
        clock: Callable[[], float] = time.time,
    ):
        self._lock = threading.Lock()
        # Injectable time source: lease stamps and expiry reaping read
        # this, so the fleet simulator (fleetsim/) can drive lease
        # timeouts on a compressed virtual clock. Production: time.time.
        self._clock = clock
        # Crash durability (master/journal.py): every task lifecycle
        # transition below is committed to the journal INSIDE the _lock
        # critical section that applies it, so the on-disk order is the
        # mutation order and a restarted master replays to exactly this
        # state. None = volatile dispatcher (no checkpoint_dir).
        self._journal = journal
        self._training_shards = list(training_shards)
        self._evaluation_shards = list(evaluation_shards or [])
        self._prediction_shards = list(prediction_shards or [])
        self._records_per_task = max(1, records_per_task)
        self._num_epochs = num_epochs                # guarded_by: _lock
        self._max_task_retries = max_task_retries
        self._shuffle = shuffle
        self._rng = random.Random(shuffle_seed)      # guarded_by: _lock
        self._task_timeout_s = task_timeout_s

        # the last journal Commit enqueued by the current critical section
        # (group-commit ack-after-fsync; see _j/_take_commit_locked)
        self._pending_commit = None                  # guarded_by: _lock
        self._todo: deque[TaskSpec] = deque()        # guarded_by: _lock
        self._doing: Dict[int, _Lease] = {}          # guarded_by: _lock
        self._next_task_id = 1                       # guarded_by: _lock
        self._epoch = -1                             # guarded_by: _lock
        self._finished_training = 0                  # guarded_by: _lock
        self._failed_permanently = 0                 # guarded_by: _lock
        self._training_done = False                  # guarded_by: _lock
        self._stop_training = False                  # guarded_by: _lock
        self._epoch_end_fired = False                # guarded_by: _lock
        self._job_end_fired = False                  # guarded_by: _lock
        # callback lists: registration-before-start contract (wired while
        # the master is single-threaded), fired outside the lock on purpose
        self._epoch_end_callbacks: List[Callable[[int], None]] = []
        self._job_end_callbacks: List[Callable[[], None]] = []
        self._task_failed_callbacks: List[Callable[[TaskSpec], None]] = []
        # permanently failed tasks whose callbacks haven't fired yet
        # (collected under the lock, flushed outside it)
        self._pending_failed: List[TaskSpec] = []    # guarded_by: _lock
        # training version counter: bumps on every finished training task
        self._completed_versions = 0                 # guarded_by: _lock
        # goodput accounting (observability/goodput.py): completed
        # training records, and the wasted-work ledger — every entry is
        # journaled (`wasted_work`) inside the same critical section as
        # the transition that caused it, so a master restart replays the
        # bill intact
        self._records_completed = 0                  # guarded_by: _lock
        self._wasted_records = 0                     # guarded_by: _lock
        self._wasted_events = 0                      # guarded_by: _lock
        self._wasted_by_reason: Dict[str, Dict[str, int]] = {}  # guarded_by: _lock
        # the evidence buckets bill at most once per task (in-memory: a
        # master restart may re-bill one, which their at-least-once
        # semantics tolerate) — a client re-sending the same rejected
        # report must not grow the journal or the ratio per attempt
        self._fenced_billed: set = set()             # guarded_by: _lock
        self._stale_billed: set = set()              # guarded_by: _lock
        # final exclusive SAVE_MODEL task (reference: the master's save-model
        # task at job end, SURVEY §2.1): created once, after everything else
        # drains, before job-end fires
        self._final_save_model = final_save_model
        self._save_model_created = False             # guarded_by: _lock

        snap = journal.dispatcher_snapshot() if journal is not None else None
        if snap is not None:
            self._restore(snap)
        elif self._training_shards:
            self._start_next_epoch()
        else:
            # evaluation-only / prediction-only jobs: no training epochs.
            # Eval tasks are injected later by the EvaluationService trigger.
            self._training_done = True
            if self._prediction_shards:
                self._create_tasks(self._prediction_shards, pb.PREDICTION)
            elif not self._evaluation_shards:
                # nothing to do at all — the job is born finished
                self._job_end_fired = True

    def _restore(self, snap) -> None:  # holds: _lock (construction)
        """Rebuild queue state from a replayed journal (master recovery).
        Runs during __init__ (single-threaded). In-flight leases were
        already conservatively requeued by the replay; the shard/config
        arguments keep only their roles as defaults — the journal is the
        source of truth for everything it recorded."""
        self._todo = deque(TaskSpec(**t) for t in snap.todo)
        self._next_task_id = snap.next_task_id
        self._epoch = snap.epoch
        if snap.num_epochs is not None:
            self._num_epochs = min(self._num_epochs, snap.num_epochs)
        self._finished_training = snap.finished_training
        self._failed_permanently = snap.failed_permanently
        self._completed_versions = snap.completed_versions
        self._stop_training = snap.stop_training
        self._save_model_created = snap.save_model_created
        self._records_completed = snap.records_completed
        self._wasted_records = snap.wasted_records
        self._wasted_events = snap.wasted_events
        self._wasted_by_reason = {
            k: dict(v) for k, v in snap.wasted_by_reason.items()
        }
        # the conservative lease requeue is the crash's wasted-work bill:
        # every requeued TRAINING span re-trains whole. Journaled NOW by
        # the successor (the crashed master could not), one entry per
        # task, in the construction-time single-threaded window.
        for entry in snap.requeued:
            self._note_wasted_locked(
                "crash_requeue", int(entry.get("task_id", -1)),
                int(entry.get("records", 0)),
            )
        if self._training_shards:
            # epoch_end / training_done / job_end CALLBACKS are volatile
            # (they create eval jobs and run zoo hooks) and run OUTSIDE
            # the lock that journals the flag — a crash in between would
            # otherwise skip them forever. Restore the terminal flags as
            # NOT fired: poke() re-derives them from the replayed queues
            # and re-fires the callbacks at-least-once (replayed eval
            # tasks were dropped, so a re-fired epoch-end trigger
            # recreates its eval job fresh).
            self._epoch_end_fired = False
            self._job_end_fired = False
            self._training_done = False
        else:
            # evaluation-/prediction-only: mirror the non-restore init —
            # no training epochs; an interrupted eval job is re-triggered
            # by the service, so job-end must be re-derivable
            self._training_done = True
            self._epoch_end_fired = snap.epoch_end_fired
            self._job_end_fired = (
                snap.job_end_fired if not self._evaluation_shards else False
            )
        self._set_queue_gauges_locked()
        logger.warning(
            "dispatcher restored from control journal: epoch %d, %d todo "
            "(%d requeued from in-flight leases), %d finished, %d failed",
            self._epoch, len(self._todo), snap.requeued_leases,
            self._finished_training, self._failed_permanently,
        )

    # _j / _take_commit_locked / _await: the ack-after-fsync plumbing is
    # CommitGate (master/journal.py) — shared with Membership so the
    # durability protocol cannot drift between the two

    # ------------------------------------------------------------------ #
    # wasted-work ledger (observability/goodput.py)


    #: how deep the rejection paths look into todo when resolving a
    #: claimed task: requeued leases land at the FRONT (appendleft), so
    #: a bounded scan covers the real ghost-report case while keeping
    #: the hammerable rejection path O(1)-ish instead of O(todo) under
    #: the control-plane lock
    _REJECT_SCAN_BOUND = 64

    def _resolve_front_locked(self, task_id: int):  # holds: _lock
        """The claimed task's spec, from the live lease or the front of
        todo (bounded); None = unresolvable, rejected unbilled."""
        lease = self._doing.get(task_id)
        if lease is not None:
            return lease.task
        return next(
            (t for t in itertools.islice(
                self._todo, self._REJECT_SCAN_BOUND)
             if t.task_id == task_id),
            None,
        )

    def _note_wasted_locked(  # holds: _lock
        self, reason: str, task_id: int, records: int,
    ) -> None:
        """One wasted-work entry: counted, metric'd, and journaled inside
        the SAME critical section as the transition that caused it (disk
        order is mutation order, so replay reconstructs the bill
        exactly). `reason` values come from goodput.WASTED_REASONS — a
        bounded vocabulary, every call site a literal."""
        records = max(0, int(records))
        self._wasted_events += 1
        self._wasted_records += records
        ent = self._wasted_by_reason.setdefault(
            reason, {"events": 0, "records": 0})
        ent["events"] += 1
        ent["records"] += records
        record_wasted(reason, records)
        self._j(
            "wasted_work", reason=reason, task_id=task_id, records=records,
        )

    def wasted_work(self) -> Dict[str, Any]:
        """The wasted-work rollup FleetGoodput (and /goodput) reads:
        journal-durable totals, per-reason buckets, and the wasted ratio
        against completed training records."""
        with self._lock:
            wasted = self._wasted_records
            completed = self._records_completed
            return {
                "wasted_records": wasted,
                "wasted_events": self._wasted_events,
                "records_completed": completed,
                "wasted_ratio": round(
                    wasted / max(1, wasted + completed), 6),
                "by_reason": {
                    k: dict(v) for k, v in self._wasted_by_reason.items()
                },
            }

    def note_fenced_report(self, task_id: int, records: int) -> None:
        """A completed ReportTaskResult rejected by the generation fence
        (servicer, pre-mutation): the work behind it is discarded — the
        restarted master's replay already requeued the lease whole. The
        claimed records land in the `fenced_report` evidence bucket
        (overlapping the `crash_requeue` re-training bill on purpose:
        one bucket bills the re-run, the other proves finished work was
        thrown away).

        Same credibility gates as the stale_report bucket: the claim
        must resolve to a TRAINING task the dispatcher can still see, is
        clamped to its real span, bills at most ONCE per task, and is
        never awaited — a fence rejection is a cheap path a stale client
        can hammer, and an unvalidated claim would inflate the wasted
        ratio (the wasted_work_ratio alert's input) without bound."""
        with self._lock:
            spec = self._resolve_front_locked(task_id)
            claimed = max(0, int(records))
            if (
                spec is None or spec.type != pb.TRAINING
                or claimed <= 0 or task_id in self._fenced_billed
            ):
                return
            self._fenced_billed.add(task_id)
            self._note_wasted_locked(
                "fenced_report", task_id, min(claimed, spec.num_records)
            )
            # advisory evidence — flushed on the journal's cadence
            self._take_commit_locked()

    # ------------------------------------------------------------------ #
    # task creation

    def _split(self, shards: List[Shard]) -> List[Tuple[str, int, int]]:
        # pure over immutable config: safe with or without the lock
        spans = []
        for name, start, end in shards:
            s = start
            while s < end:
                e = min(s + self._records_per_task, end)
                spans.append((name, s, e))
                s = e
        return spans

    def _create_tasks(  # holds: _lock
        self, shards: List[Shard], task_type: int, eval_job_id: int = -1,
        front: bool = False,
        journal_prelude: Optional[List[Tuple[str, Dict[str, Any]]]] = None,
    ) -> int:
        spans = self._split(shards)
        if self._shuffle and task_type == pb.TRAINING:
            self._rng.shuffle(spans)
        tasks = []
        for name, s, e in spans:
            tasks.append(
                TaskSpec(
                    task_id=self._next_task_id,
                    type=task_type,
                    shard_name=name,
                    start=s,
                    end=e,
                    epoch=max(self._epoch, 0),
                    eval_job_id=eval_job_id,
                )
            )
            self._next_task_id += 1
        if front:
            self._todo.extendleft(reversed(tasks))
        else:
            self._todo.extend(tasks)
        if self._journal is not None and (tasks or journal_prelude):
            # one fsync for the whole batch (prelude included); front
            # batches are journaled in reversed order so sequential
            # front-insertion on replay reproduces this exact queue order
            ordered = reversed(tasks) if front else tasks
            records = list(journal_prelude or [])
            records.extend(
                ("task_create", {"task": dataclasses.asdict(t), "front": front})
                for t in ordered
            )
            self._pending_commit = self._journal.append_many(records)
        return len(tasks)

    def _start_next_epoch(self) -> None:  # holds: _lock
        self._epoch += 1
        self._epoch_end_fired = False
        # epoch_advance commits in the SAME fsync as its task batch: a
        # crash landing between a lone epoch_advance and the creations
        # would replay an epoch with an empty todo — the successor would
        # fire epoch_end over zero tasks and skip the epoch's data entirely
        n = self._create_tasks(
            self._training_shards, pb.TRAINING,
            journal_prelude=[("epoch_advance", {"epoch": self._epoch})],
        )
        logger.info("epoch %d: created %d training tasks", self._epoch, n)

    def num_evaluation_tasks(self) -> int:
        """How many tasks one eval job creates (pure function of shards)."""
        return len(self._split(self._evaluation_shards))

    def create_evaluation_tasks(self, eval_job_id: int) -> int:
        """Evaluation tasks jump the queue (reference behavior: eval tasks
        are prioritized so metrics reflect the current model version)."""
        with self._lock:
            n = self._create_tasks(
                self._evaluation_shards, pb.EVALUATION, eval_job_id, front=True
            )
            commit = self._take_commit_locked()
        self._await(commit)
        logger.info("eval job %d: created %d evaluation tasks", eval_job_id, n)
        return n

    # ------------------------------------------------------------------ #
    # leasing / reporting

    def get(self, worker_id: int) -> Optional[TaskSpec]:
        """One lease (the classic protocol): get_many with max_tasks=1."""
        tasks = self.get_many(worker_id, 1)
        return tasks[0] if tasks else None

    def get_many(self, worker_id: int, max_tasks: int = 1) -> List[TaskSpec]:
        """Lease up to ``max_tasks`` tasks in ONE pass under the lock and
        ONE journal commit (batched leases): the per-round-trip costs —
        lock acquisition, journal fsync (group-committed), RPC overhead —
        amortize across the batch. Lease-expiry/requeue/fencing semantics
        stay per task; an empty list means WAIT (or job done)."""
        max_tasks = max(1, max_tasks)
        callbacks: List[Callable] = []
        with self._lock:
            self._reap_expired_locked()
            if not self._todo:
                callbacks = self._maybe_advance_epoch_locked()
        # callbacks (epoch-end eval triggers, …) may enqueue new tasks and
        # must run outside the lock — they re-enter the dispatcher
        self._flush_callbacks(callbacks)
        with self._lock:
            if not self._todo:
                self._set_queue_gauges_locked()
                return []
            now = self._clock()
            tasks: List[TaskSpec] = []
            records = []
            while self._todo and len(tasks) < max_tasks:
                task = self._todo.popleft()
                self._doing[task.task_id] = _Lease(worker_id, task, now)
                records.append(
                    ("task_lease",
                     {"task_id": task.task_id, "worker_id": worker_id})
                )
                tasks.append(task)
            # journaled (enqueued) BEFORE the leases are observable; the
            # whole batch commits under one fsync, and a crash after this
            # point replays every lease and requeues it
            if self._journal is not None:
                self._pending_commit = self._journal.append_many(records)
            commit = self._take_commit_locked()
            self._set_queue_gauges_locked()
        # ack-after-fsync: the GetTask response IS the acknowledgment —
        # it must not leave before the lease records are durable
        self._await(commit)
        # lease-transition event OUTSIDE the lock (file I/O never runs
        # under the dispatcher lock)
        _TASKS_LEASED.inc(len(tasks))
        _LEASE_BATCH.observe(len(tasks))
        tracing.event(
            "task.lease", task_ids=[t.task_id for t in tasks],
            worker_id=worker_id, batch=len(tasks),
        )
        return tasks

    def _set_queue_gauges_locked(self) -> None:  # holds: _lock
        _QUEUE_TODO.set(len(self._todo))
        _QUEUE_DOING.set(len(self._doing))

    def _flush_callbacks(self, callbacks: List[Callable]) -> None:
        with self._lock:
            failed, self._pending_failed = self._pending_failed, []
        for task in failed:
            for cb in self._task_failed_callbacks:
                cb(task)
        for cb in callbacks:
            cb()

    def report(
        self,
        task_id: int,
        worker_id: int,
        success: bool,
        err: str = "",
        preempted: bool = False,
        records_processed: int = 0,
    ) -> bool:
        """Returns False for an unknown/stale lease (e.g. the task was
        already recovered from this worker and completed elsewhere)."""
        callbacks: List[Callable] = []
        stale = False
        held_by: Optional[int] = None
        with self._lock:
            lease = self._doing.get(task_id)
            stale = lease is None or lease.worker_id != worker_id
            if stale:
                _STALE_REPORTS.inc()
                held_by = lease.worker_id if lease is not None else None
                # Bill ONLY a credible discarded-work claim: a TRAINING
                # task the dispatcher can still see (held by a newer
                # lease, or requeued onto todo — the kill-worker ghost
                # report) whose reporter claims completed records. A
                # failed/empty stale report discards nothing, and a
                # report for a task id the dispatcher cannot resolve is
                # unvalidated remote input — rejected unbilled, or a
                # misbehaving client could inflate the wasted ratio (the
                # wasted_work_ratio alert's input) without bound.
                spec = self._resolve_front_locked(task_id)
                if (
                    spec is not None and spec.type == pb.TRAINING
                    and (success or records_processed > 0)
                    and task_id not in self._stale_billed
                ):
                    self._stale_billed.add(task_id)
                    claimed = records_processed or spec.num_records
                    self._note_wasted_locked(
                        "stale_report", task_id,
                        min(claimed, spec.num_records),
                    )
                # the entry is advisory EVIDENCE, flushed on the
                # journal's normal cadence — deliberately NOT awaited:
                # the rejection must stay a cheap, never-raising path (a
                # JournalCommitError here would read as delivery failure
                # and flip the worker's drain-checkpoint retention)
                self._take_commit_locked()
            else:
                del self._doing[task_id]
                task = lease.task
            if stale:
                pass   # rejection path finishes after the lock releases
            elif success:
                if task.type == pb.TRAINING:
                    self._finished_training += 1
                    self._completed_versions += 1
                    self._records_completed += task.num_records
                self._j(
                    "task_finish", task_id=task_id,
                    training=task.type == pb.TRAINING,
                    records=(
                        task.num_records if task.type == pb.TRAINING else 0
                    ),
                )
                _TASKS_FINISHED.inc()
            elif preempted:
                # Drain report: the first `records_processed` records were
                # applied (and are covered by the worker's preemption
                # checkpoint); requeue only the remainder, retry-free.
                done = max(0, min(records_processed, task.end - task.start))
                if task.start + done >= task.end:
                    if task.type == pb.TRAINING:
                        self._finished_training += 1
                        self._completed_versions += 1
                        self._records_completed += done
                    self._j(
                        "task_finish", task_id=task_id,
                        training=task.type == pb.TRAINING,
                        records=done if task.type == pb.TRAINING else 0,
                    )
                else:
                    task.start += done
                    # the drained remainder re-leases elsewhere: its
                    # batches were read (and possibly prefetched) once
                    # for nothing — the drain_requeue bucket; the `done`
                    # prefix COMPLETED (covered by the drain checkpoint)
                    self._requeue_locked(
                        task, "preemption remainder",
                        wasted_reason="drain_requeue",
                        completed=done,
                    )
                    logger.info(
                        "task %d preempted after %d records; requeued remainder "
                        "[%d, %d)", task_id, done, task.start, task.end,
                    )
            else:
                task.retries += 1
                if task.retries <= self._max_task_retries:
                    logger.info(
                        "task %d failed (%s); requeue retry %d",
                        task_id, err, task.retries,
                    )
                    self._requeue_locked(
                        task, "failure retry",
                        wasted_reason="failure_retry",
                    )
                else:
                    self._fail_permanently_locked(task, err)
            if not stale:
                callbacks = self._maybe_advance_epoch_locked()
                commit = self._take_commit_locked()
                self._set_queue_gauges_locked()
        if stale:
            if held_by is None:
                logger.warning(
                    "stale/unknown task report: task=%d worker=%d",
                    task_id, worker_id,
                )
            else:
                logger.warning(
                    "rejecting report for task %d from worker %d: lease "
                    "now held by worker %d", task_id, worker_id, held_by,
                )
            return False
        # ack-after-fsync: accepted=True is the acknowledgment the worker
        # keys destructive decisions off (drain-checkpoint retention) — it
        # must not leave before the finish/requeue record is durable
        self._await(commit)
        tracing.event(
            "task.report", task_id=task_id, worker_id=worker_id,
            success=bool(success), preempted=bool(preempted),
        )
        self._flush_callbacks(callbacks)
        return True

    def _requeue_locked(self, task: TaskSpec, why: str,
                        wasted_reason: Optional[str] = None,
                        completed: int = 0) -> None:
        """Put a task back on todo — unless it's a TRAINING task after
        request_stop_training, which would resurrect training the early stop
        already ended (the one-shot queue purge can't catch tasks that were
        in flight when the stop fired).

        `wasted_reason` bills the requeue to the wasted-work ledger
        (goodput.REQUEUE_REASONS; None = nothing wasted — e.g. a lease
        that never ran). `completed` journals drain-retired records so
        replay's records_completed matches the live counter."""
        # `completed` counts (and journals) for TRAINING only — replay
        # adds the journaled field unconditionally, so journaling it for
        # a non-training drain would make the replayed records_completed
        # diverge from the live counter
        completed = completed if task.type == pb.TRAINING else 0
        if completed > 0:
            self._records_completed += completed
        if self._stop_training and task.type == pb.TRAINING:
            logger.info(
                "dropping training task %d (%s) after stop request",
                task.task_id, why,
            )
            self._j(
                "task_drop", task_id=task.task_id, completed=completed,
            )
            return
        if wasted_reason is not None and task.type == pb.TRAINING:
            self._note_wasted_locked(
                wasted_reason, task.task_id, task.num_records)
        _TASKS_REQUEUED.inc()
        self._todo.appendleft(task)
        self._j(
            "task_requeue", task_id=task.task_id, start=task.start,
            retries=task.retries, completed=completed,
        )

    def _fail_permanently_locked(self, task: TaskSpec, err: str) -> None:
        self._failed_permanently += 1
        self._j("task_fail", task_id=task.task_id)
        _TASKS_FAILED.inc()
        self._pending_failed.append(task)
        logger.error(
            "task %d failed permanently after %d retries: %s",
            task.task_id, task.retries, err,
        )

    def recover_tasks(self, worker_id: int) -> int:
        """Requeue every task leased by a dead worker. THE elastic primitive
        (reference: task recovery on pod FAILED/DELETED events)."""
        with self._lock:
            stale = [t for t, l in self._doing.items() if l.worker_id == worker_id]
            for tid in stale:
                task = self._doing.pop(tid).task
                # the dead worker's span re-trains whole: the rescale
                # bill's wasted-records half (bench.py goodput asserts
                # the kill-worker scenario lands here)
                self._requeue_locked(
                    task, f"worker {worker_id} died",
                    wasted_reason="worker_died",
                )
            commit = self._take_commit_locked()
            self._set_queue_gauges_locked()
        self._await(commit)
        if stale:
            logger.info("recovered %d tasks from worker %d", len(stale), worker_id)
        return len(stale)

    def _reap_expired_locked(self) -> None:
        now = self._clock()
        expired = [
            tid
            for tid, lease in self._doing.items()
            if now - lease.lease_time > self._task_timeout_s
        ]
        for tid in expired:
            lease = self._doing.pop(tid)
            _LEASES_EXPIRED.inc()
            lease.task.retries += 1
            if lease.task.retries <= self._max_task_retries:
                logger.warning(
                    "task %d lease expired (worker %d); requeued",
                    tid, lease.worker_id,
                )
                self._requeue_locked(
                    lease.task, "lease expired",
                    wasted_reason="lease_expired",
                )
            else:
                self._fail_permanently_locked(lease.task, "lease expired")
        if expired:
            self._set_queue_gauges_locked()

    def _maybe_advance_epoch_locked(self) -> List[Callable]:
        """If the current epoch's training drained, fire epoch-end exactly
        once, then start the next epoch or finish training; fire job-end
        exactly once when everything (incl. eval/predict tasks) drains.

        Job-end is DEFERRED whenever other callbacks are pending: epoch-end
        callbacks typically enqueue the final eval job's tasks (outside the
        lock), and firing job-end in the same pass would let workers see
        job_done before those tasks exist."""
        callbacks: List[Callable] = []
        if self._training_shards and not self._training_done:
            training_left = any(
                t.type == pb.TRAINING for t in self._todo
            ) or any(l.task.type == pb.TRAINING for l in self._doing.values())
            if not training_left:
                if self._epoch >= 0 and not self._epoch_end_fired:
                    self._epoch_end_fired = True
                    self._j("epoch_end", epoch=self._epoch)
                    epoch = self._epoch
                    callbacks.extend(
                        lambda cb=cb: cb(epoch) for cb in self._epoch_end_callbacks
                    )
                if self._epoch + 1 < self._num_epochs:
                    self._start_next_epoch()
                else:
                    self._training_done = True
                    self._j("training_done")
        if callbacks:
            return callbacks
        if (
            self._training_done
            and not self._todo
            and not self._doing
            and not self._job_end_fired
        ):
            if (
                self._final_save_model
                and not self._save_model_created
                and self._finished_training > 0
            ):
                # everything else drained: one exclusive SAVE_MODEL task so a
                # durable end-of-job checkpoint exists no matter which worker
                # interval checkpointing last touched (its report re-enters
                # here and only then does job-end fire)
                self._save_model_created = True
                save_task = TaskSpec(
                    task_id=self._next_task_id,
                    type=pb.SAVE_MODEL,
                    shard_name="",
                    start=0,
                    end=0,
                    epoch=max(self._epoch, 0),
                )
                self._todo.append(save_task)
                self._next_task_id += 1
                self._j(
                    "task_create", task=dataclasses.asdict(save_task),
                    front=False,
                )
                logger.info("created final SAVE_MODEL task")
                return callbacks
            self._job_end_fired = True
            self._j("job_end")
            callbacks.extend(self._job_end_callbacks)
        return callbacks

    def request_stop_training(self, reason: str = "") -> None:
        """Early stopping: drop queued training tasks and schedule no more
        epochs; leased tasks drain normally, then the job ends through the
        usual epoch-end → final-eval → SAVE_MODEL → job-end sequence."""
        callbacks: List[Callable] = []
        with self._lock:
            self._stop_training = True   # _requeue_locked drops in-flight ones
            before = len(self._todo)
            self._todo = deque(t for t in self._todo if t.type != pb.TRAINING)
            dropped = before - len(self._todo)
            self._num_epochs = min(self._num_epochs, self._epoch + 1)
            self._j("stop_training", num_epochs=self._num_epochs)
            logger.info(
                "training stop requested (%s): dropped %d queued training "
                "tasks, no further epochs", reason or "no reason", dropped,
            )
            callbacks = self._maybe_advance_epoch_locked()
            commit = self._take_commit_locked()
        self._await(commit)
        self._flush_callbacks(callbacks)

    # ------------------------------------------------------------------ #
    # introspection / hooks

    def add_epoch_end_callback(self, cb: Callable[[int], None]) -> None:
        self._epoch_end_callbacks.append(cb)

    def add_job_end_callback(self, cb: Callable[[], None]) -> None:
        self._job_end_callbacks.append(cb)

    def add_task_failed_callback(self, cb: Callable[[TaskSpec], None]) -> None:
        """cb(task) fires when a task fails permanently (retries exhausted)."""
        self._task_failed_callbacks.append(cb)

    def poke(self) -> None:
        """Drive deferred state transitions (lease reaping, epoch/job end)
        without a worker RPC — the master's wait loop calls this so progress
        doesn't depend on workers polling."""
        with self._lock:
            self._reap_expired_locked()
            callbacks = self._maybe_advance_epoch_locked()
            commit = self._take_commit_locked()
        self._await(commit)
        self._flush_callbacks(callbacks)

    def finished(self) -> bool:
        """True only once job-end has actually fired — `_training_done` with
        empty queues is transiently observable while epoch-end callbacks are
        still enqueueing the final eval tasks, and must not look finished."""
        with self._lock:
            return self._job_end_fired

    @property
    def completed_versions(self) -> int:
        with self._lock:
            return self._completed_versions

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return {
                "todo": len(self._todo),
                "doing": len(self._doing),
                "finished_training": self._finished_training,
                "failed_permanently": self._failed_permanently,
                "epoch": self._epoch,
            }
