"""Elastic worker process manager (local-process instance manager).

Reference parity: elasticdl/python/master/k8s_instance_manager.py — create
worker instances, watch their lifecycle, relaunch failures up to
`relaunch_max`, and tell the membership/dispatcher when one dies. This is the
same state machine with subprocesses instead of pods (the k8s flavor renders
pod specs through client/k8s.py); the master's control plane is identical in
both, which is what makes the fault-injection tests honest — they kill real
worker processes, as the reference's integration tests killed real pods.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from elasticdl_tpu_torch.common import faults, membership_signal
from elasticdl_tpu_torch.common.config import JobConfig
from elasticdl_tpu_torch.common.net import free_port
from elasticdl_tpu_torch.common.constants import ExitCode, PodStatus, WorkerEnv
from elasticdl_tpu_torch.common.log_utils import default_logger
from elasticdl_tpu_torch.master.membership import Membership
from elasticdl_tpu_torch.observability import tracing
from elasticdl_tpu_torch.observability.registry import default_registry

logger = default_logger(__name__)

_reg = default_registry()
_REFORMS = _reg.counter(
    "edl_reform_total", "cohort re-formations", labels=("kind",))
_REFORM_S = _reg.histogram(
    "edl_reform_seconds", "respawn wall time of a re-formation")
_SPAWNS = _reg.counter(
    "edl_reform_worker_spawns_total", "worker processes spawned")
_COHORT_SIZE = _reg.gauge(
    "edl_reform_cohort_size", "current cohort process count")


def _reject_plain_training_scale_out(cfg: JobConfig) -> None:
    """Runtime twin of JobConfig.validate's multi-replica rule: growing a
    TRAINING job beyond one plain (non-cohort) worker would train divergent
    replicas with no gradient exchange — the config guard must not be
    bypassable through the scale-out API."""
    from elasticdl_tpu_torch.common.constants import JobType

    if cfg.job_type in (JobType.TRAINING_ONLY, JobType.TRAINING_WITH_EVALUATION):
        raise RuntimeError(
            "add_worker on a training job with plain workers would create "
            "independent model replicas (no gradient exchange); use the SPMD "
            "cohort (num_processes>1), whose add_worker re-forms the world"
        )


@dataclass
class _WorkerProc:
    worker_id: int
    proc: subprocess.Popen
    relaunches: int = 0
    status: str = PodStatus.RUNNING
    # cohort mode: this member is permanently gone (host lost, eviction) —
    # its death must trigger a downsized re-formation, not an in-place
    # relaunch that would just die again
    no_relaunch: bool = False
    # deliberately evicted by policy (master/autoscaler.py): its exit is
    # an expected retirement (status DELETED), never a failure that
    # counts toward all_failed() or burns a relaunch
    evicted: bool = False


class ProcessManager:
    """Spawns and babysits worker subprocesses."""

    def __init__(
        self,
        cfg: JobConfig,
        membership: Optional[Membership] = None,
        extra_env: Optional[Dict[str, str]] = None,
        log_dir: Optional[str] = None,
        job_finished_fn=None,
        checkpoint_request_fn=None,
        resize_checkpoint_timeout_s: float = 30.0,
        membership_signal_path: Optional[str] = None,
        journal=None,
    ):
        self.cfg = cfg
        self._membership = membership
        # Crash durability (master/journal.py): world-version bumps are
        # journaled so a restarted master's manager continues the version
        # sequence instead of rewinding it (workers compare versions to
        # decide whether a rescale announcement is news). None = volatile.
        self._journal = journal                      # guarded_by: _lock
        self._extra_env = dict(extra_env or {})
        self._log_dir = log_dir
        # when this returns True, worker exits are final — no relaunches
        self._job_finished_fn = job_finished_fn or (lambda: False)
        # Deliberate-resize quiesce: called before tearing a healthy cohort
        # down so workers checkpoint at the next task boundary (wired to
        # servicer.request_checkpoint by the launcher); the teardown then
        # waits up to resize_checkpoint_timeout_s for a NEW checkpoint to
        # land, bounding the work a planned resize throws away to one task.
        self._checkpoint_request_fn = checkpoint_request_fn
        self._resize_ckpt_timeout_s = resize_checkpoint_timeout_s
        self._probe_ckpt_mngr = None  # lazily built, reused across resizes
        self._procs: Dict[int, _WorkerProc] = {}     # guarded_by: _lock
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._watcher: Optional[threading.Thread] = None
        self._next_worker_id = 0                     # guarded_by: _lock
        self._cohort_relaunches = 0                  # guarded_by: _lock
        self._cohort_coordinator = ""                # guarded_by: _lock
        # dynamic world resizing state (cohort mode); a replayed journal
        # resumes the pre-crash world version so the next reform bumps
        # PAST it (never backwards past what workers already saw)
        self._cohort_size = self.cfg.num_processes   # guarded_by: _lock
        self._world_version = (                      # guarded_by: _lock
            journal.world_version if journal is not None else 0
        )
        self._pending_resize: Optional[int] = None   # guarded_by: _lock
        self._infra_retries = 0                      # guarded_by: _lock
        # world-formation failures (coordinator-port TOCTOU etc.) retry
        # without consuming the relaunch budget, bounded by this cap
        self.infra_retry_max = 10
        # timestamped re-formation records: (wall_clock_s, old_size, new_size)
        self.reformation_log: List[Tuple[float, int, int]] = []  # guarded_by: _lock
        # Pending-membership signal (rescale fast path): a planned resize is
        # ANNOUNCED through this file before the teardown lands, so workers'
        # speculative compilers precompile the next world size while the old
        # one still trains. Default location: the log dir (shared with the
        # workers on this manager's single host); "" disables.
        if membership_signal_path is None:
            base = log_dir or self.cfg.checkpoint_dir
            membership_signal_path = (
                os.path.join(base, "membership_signal.json") if base else ""
            )
        self._signal_path = membership_signal_path
        if self._signal_path and journal is not None and journal.recovered:
            # full master-process restart: the signal file at THIS path
            # (log_dir-based — Master.__init__'s own takeover clear only
            # knows checkpoint_dir, which differs whenever log_dir is set)
            # may still carry the dead predecessor's announced resize plan;
            # drop it before any worker's speculative compiler reads it
            membership_signal.clear_stale_on_takeover(
                self._signal_path, master_generation=journal.generation
            )
        # one trace id per announced/active resize: stamped into the signal
        # file (workers adopt it) and onto every reform.* span this manager
        # opens, so master + workers share a timeline per resize
        self._reform_trace_id: Optional[str] = None   # guarded_by: _lock
        # observer for measured re-formation durations (the autoscaler's
        # cost model subscribes — client/local.py wires it); best-effort,
        # called OUTSIDE the lock with (seconds, old_size, new_size)
        self._reform_observers: List = []

    @property
    def _cohort_mode(self) -> bool:
        return self.cfg.num_processes > 1

    @property
    def cohort_size(self) -> int:
        with self._lock:
            return self._cohort_size

    def pending_size(self) -> Optional[int]:
        """The announced (not yet applied) next cohort size, if any."""
        with self._lock:
            return self._pending_resize

    def _announce_locked(self) -> None:  # holds: _lock
        """(Re)write the pending-membership signal file from the current
        locked state. Best-effort — the announcement is an optimization
        for the workers' speculative compilers, never a failure source."""
        if not self._signal_path:
            return
        membership_signal.write_signal(
            self._signal_path,
            world_size=self._cohort_size,
            pending_size=self._pending_resize,
            world_version=self._world_version,
            trace_id=self._reform_trace_id,
            # which master wrote this plan: a successor master at takeover
            # clears announcements stamped by its dead predecessor
            master_generation=(
                self._journal.generation if self._journal is not None else 0
            ),
        )

    def rebind_master(
        self, membership, job_finished_fn, checkpoint_request_fn, journal=None
    ) -> None:
        """Adopt a RESTARTED in-process master (client/local.py's
        --master_restarts recovery path): swap the control-plane hooks to
        the successor's membership/dispatcher/servicer and its replayed
        journal. The worker processes themselves are untouched — they
        reconnect to the same address under the new generation; only this
        manager's references move. The announcement is re-stamped so the
        signal file carries the new master generation immediately."""
        with self._lock:
            self._membership = membership
            self._job_finished_fn = job_finished_fn or (lambda: False)
            self._checkpoint_request_fn = checkpoint_request_fn
            self._journal = journal
            self._announce_locked()
        logger.warning(
            "process manager rebound to restarted master (generation %d)",
            journal.generation if journal is not None else 0,
        )


    # ------------------------------------------------------------------ #

    def _spawn(self, worker_id: int, relaunches: int = 0,  # holds: _lock
               process_id: int = 0) -> _WorkerProc:
        # called with the lock held: the cohort env block reads
        # _cohort_coordinator/_cohort_size/_world_version
        env = dict(os.environ)
        env.update({str(k): str(v) for k, v in self.cfg.envs.items()})
        env.update(self._extra_env)
        env[WorkerEnv.WORKER_ID] = str(worker_id)
        env[WorkerEnv.MASTER_ADDR] = self.cfg.master_addr
        env[WorkerEnv.NUM_WORKERS] = str(self.cfg.num_workers)
        if self._cohort_mode:
            env["EDL_PROCESS_ID"] = str(process_id)
            env["EDL_COORDINATOR_ADDR"] = self._cohort_coordinator
            # dynamic resizing: the CURRENT world size/generation, which may
            # differ from the argv's immutable cfg.num_processes
            env["EDL_NUM_PROCESSES"] = str(self._cohort_size)
            env["EDL_WORLD_VERSION"] = str(self._world_version)
        if self._signal_path:
            # where workers read the pending-membership announcement
            env[membership_signal.ENV_VAR] = self._signal_path
        argv = self.cfg.to_argv()
        stdout = stderr = None
        if self._log_dir:
            os.makedirs(self._log_dir, exist_ok=True)
            name = (
                f"worker-{worker_id}-p{process_id}.log"
                if self._cohort_mode else f"worker-{worker_id}.log"
            )
            # spawn-under-lock is the cohort-atomicity invariant: the proc
            # table, cohort size, and coordinator port must not be observed
            # mid-reform, and spawn is the repair path, not the hot path:
            # edl-lint: disable=EDL103
            log = open(os.path.join(self._log_dir, name), "ab")
            stdout = stderr = log
        cmd = [sys.executable, "-m", "elasticdl_tpu_torch.worker.main", *argv]
        try:
            # chaos hook: delay/crash keep their documented semantics
            # (crash = os._exit of THIS process, honoring code=); drop is
            # remapped below
            faults.fire("proc.spawn")
        except faults.FaultInjected:
            # drop: spawn a doomed stand-in that exits 1 immediately (a pod
            # that never comes up), exercising death detection and the
            # relaunch budget rather than silently skipping the spawn
            cmd = [sys.executable, "-c", "raise SystemExit(1)"]
        # same cohort-atomicity justification as the log open above:
        # edl-lint: disable=EDL103
        proc = subprocess.Popen(
            cmd,
            env=env,
            stdout=stdout,
            stderr=stderr,
        )
        wp = _WorkerProc(worker_id=worker_id, proc=proc, relaunches=relaunches)
        _SPAWNS.inc()
        logger.info("spawned worker %d (pid %d)", worker_id, proc.pid)
        return wp

    def start_workers(self) -> None:
        with self._lock:
            # fresh job, fresh announcement: a stale pending_size left by a
            # crashed previous run (same log dir) must not send the new
            # workers' speculative compilers chasing a phantom resize
            self._announce_locked()
            if self._cohort_mode:
                self._spawn_cohort_locked()
            else:
                for _ in range(self.cfg.num_workers):
                    wid = self._next_worker_id
                    self._next_worker_id += 1
                    self._procs[wid] = self._spawn(wid)
        self._watcher = threading.Thread(target=self._watch_loop, daemon=True)
        self._watcher.start()

    def _spawn_cohort_locked(self, size: Optional[int] = None) -> None:
        """Spawn all cohort members (process id == slot id; the leader,
        process 0, registers with the master as worker 0). A fresh
        coordinator port per generation avoids TIME_WAIT rebind races;
        a bind lost to the TOCTOU window surfaces as ExitCode.WORLD_FORM_FAILED
        and is retried budget-free by the watch loop."""
        if size is not None:
            self._cohort_size = size
        self._cohort_coordinator = f"localhost:{free_port()}"
        for p in range(self._cohort_size):
            self._procs[p] = self._spawn(
                0, relaunches=self._cohort_relaunches, process_id=p
            )

    def add_worker(self) -> int:
        """Scale up by one worker (elastic scale-out).

        Cohort mode: a live jax.distributed world is fixed-size, so scale-out
        is a deliberate re-formation — the watch loop tears the cohort down
        at the next poll and respawns it one process larger (new coordinator,
        new world version, state restored from the latest checkpoint; global
        batch and LR are invariant — strong scaling). Returns the new target
        size.
        """
        if self._cohort_mode:
            with self._lock:
                target = (self._pending_resize or self._cohort_size) + 1
                self._pending_resize = target
                if self._reform_trace_id is None:
                    self._reform_trace_id = tracing.new_trace_id()
                tid = self._reform_trace_id
                self._announce_locked()
                logger.info("cohort scale-out requested: -> %d processes", target)
            tracing.event(
                "reform.announce", trace_id=tid, pending_size=target,
                direction="up",
            )
            return target
        _reject_plain_training_scale_out(self.cfg)
        with self._lock:
            wid = self._next_worker_id
            self._next_worker_id += 1
            self._procs[wid] = self._spawn(wid)
            return wid

    def remove_worker(self) -> int:
        """Scale down by one process (cohort mode): deliberate re-formation
        at N-1, same mechanics as add_worker."""
        if not self._cohort_mode:
            raise RuntimeError("remove_worker only applies to cohort mode")
        with self._lock:
            target = max(1, (self._pending_resize or self._cohort_size) - 1)
            self._pending_resize = target
            if self._reform_trace_id is None:
                self._reform_trace_id = tracing.new_trace_id()
            tid = self._reform_trace_id
            self._announce_locked()
            logger.info("cohort scale-in requested: -> %d processes", target)
        tracing.event(
            "reform.announce", trace_id=tid, pending_size=target,
            direction="down",
        )
        return target

    def add_reform_observer(self, cb) -> None:
        """cb(seconds, old_size, new_size) after every completed cohort
        re-formation — the autoscaler's cost model feeds its rescale-cost
        EWMA from this. Registration-before-start contract."""
        self._reform_observers.append(cb)

    def _notify_reform(self, seconds: float, old: int, new: int) -> None:
        for cb in self._reform_observers:
            try:
                cb(seconds, old, new)
            except Exception:
                logger.exception("reform observer %r failed (ignored)", cb)

    def evict_worker(self, worker_id: int) -> bool:
        """Policy eviction of a PLAIN worker (master/autoscaler.py; the
        cohort flavor is remove_worker's drain-first resize). Marks the
        slot never-relaunch and DELETED-on-exit — the worker itself
        drains through the heartbeat `evict` bit and exits EX_TEMPFAIL;
        this side only ensures the exit retires the slot instead of
        respawning it, and that a deliberate eviction never reads as a
        failure (all_failed must stay false). No signal is sent here:
        the drain handshake is the servicer's, and killing the process
        would throw away exactly the records the drain retires."""
        with self._lock:
            wp = self._procs.get(worker_id)
            if wp is None or wp.proc.poll() is not None:
                return False
            wp.no_relaunch = True
            wp.evicted = True
            wp.relaunches = self.cfg.relaunch_max + 1
        logger.warning(
            "worker %d marked evicted (policy): drains via the heartbeat "
            "evict bit, exit retires the slot", worker_id,
        )
        return True

    def kill_worker(
        self, worker_id: int, relaunch: bool = True, graceful: bool = False
    ) -> bool:
        """Kill one worker process (also the fault-injection hook).
        graceful=True sends SIGTERM — the k8s-preemption shape: the worker
        drains, checkpoints, and exits EX_TEMPFAIL; False is SIGKILL."""
        with self._lock:
            wp = self._procs.get(worker_id)
            if wp is None or wp.proc.poll() is not None:
                return False
            if not relaunch:
                wp.relaunches = self.cfg.relaunch_max + 1
                wp.no_relaunch = True
            if graceful:
                wp.proc.terminate()
            else:
                wp.proc.kill()
        return True

    # ------------------------------------------------------------------ #

    def _watch_loop(self, poll_s: float = 0.5) -> None:
        """The pod-event watch: detect exits, relaunch or retire."""
        if self._cohort_mode:
            self._watch_cohort_loop(poll_s)
            return
        while not self._stop.is_set():
            with self._lock:
                items = list(self._procs.items())
            for wid, wp in items:
                code = wp.proc.poll()
                if code is None or wp.status in (
                    PodStatus.SUCCEEDED, PodStatus.FAILED, PodStatus.DELETED,
                ):
                    continue
                if code == 0:
                    wp.status = PodStatus.SUCCEEDED
                    logger.info("worker %d exited cleanly", wid)
                    continue
                if self._job_finished_fn():
                    # teardown-phase exits are not failures to recover from
                    wp.status = PodStatus.SUCCEEDED
                    logger.info("worker %d exited (code %s) after job end", wid, code)
                    continue
                if wp.evicted:
                    # policy eviction completing: the worker drained
                    # (records retired under its drain checkpoint) and
                    # exited EX_TEMPFAIL. Retire the slot — DELETED, not
                    # FAILED: a deliberate shrink must never read as "all
                    # workers failed" and abort the job. mark_dead still
                    # runs so any lease the drain could not release
                    # requeues FRONT exactly like a death.
                    wp.status = PodStatus.DELETED
                    if self._membership is not None:
                        self._membership.mark_dead(
                            wid, reason="evicted by autoscale policy")
                    logger.warning(
                        "worker %d eviction complete (exit code %s); slot "
                        "retired", wid, code,
                    )
                    continue
                # failure/preemption path
                if self._membership is not None:
                    self._membership.mark_dead(wid, reason=f"exit code {code}")
                if wp.relaunches < self.cfg.relaunch_max:
                    logger.warning(
                        "worker %d died (code %s); relaunch %d/%d",
                        wid, code, wp.relaunches + 1, self.cfg.relaunch_max,
                    )
                    with self._lock:
                        if self._stop.is_set():
                            # stop() may already have snapshotted _procs for
                            # its kill loop: a relaunch now would leak
                            continue
                        self._procs[wid] = self._spawn(
                            wid, relaunches=wp.relaunches + 1
                        )
                else:
                    wp.status = PodStatus.FAILED
                    logger.error(
                        "worker %d died (code %s); relaunch budget exhausted",
                        wid, code,
                    )
            self._stop.wait(poll_s)

    def _teardown_cohort(self, items, reason: str) -> None:
        """Kill every member and reap; recover the leader's leased tasks via
        membership so the new generation re-leases at the task boundary."""
        if self._membership is not None:
            self._membership.mark_dead(0, reason=reason)
        for _, wp in items:
            if wp.proc.poll() is None:
                wp.proc.kill()
        for _, wp in items:
            try:
                wp.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass

    def _reform_cohort(self, new_size: int, old_size: int, reason: str) -> None:
        """Spawn the next cohort generation, possibly at a different size
        (dynamic world resizing — the rebuild of the reference's Horovod
        re-rendezvous at a new world size, SURVEY §2.1/§3.4). The new world
        restores from the latest checkpoint and keeps the global batch and
        LR unchanged (strong scaling — only per-device slice sizes move)."""
        # monotonic: this delta feeds the reform-duration histogram, and
        # an NTP step through a wall-clock delta would corrupt it (EDL406)
        t0 = time.monotonic()
        # the span wraps the lock (not the reverse) so its exit — a
        # trace.jsonl write — never runs under the control-plane lock
        with tracing.span(
            "reform.spawn", new_size=new_size, old_size=old_size,
        ) as spawn_span:
            with self._lock:
                if self._stop.is_set():
                    # stop() raced us between teardown and re-form: spawning
                    # a fresh generation now would outlive stop()'s kill loop
                    # (it only waits grace_s for the watcher) and leak
                    # workers that run forever — observed as orphan processes
                    # hours after a test's manager.stop()
                    spawn_span.set(outcome="skipped_manager_stopping")
                    logger.info("re-formation skipped: manager stopping")
                    return
                self._world_version += 1
                world_version = self._world_version
                # ENQUEUED inside the lock (disk order = mutation order,
                # like every journaled transition) but awaited OUTSIDE it:
                # in group-commit mode the wait is a bounded window the
                # manager lock must not serialize behind (PR 7 boundary).
                commit = (
                    self._journal.append(
                        "world_version", version=world_version
                    )
                    if self._journal is not None else None
                )
            if commit is not None:
                # ack-after-fsync: the version must be DURABLE before it
                # becomes observable (spawned worker envs, the membership-
                # signal announcement) — a crash here must never let
                # workers see a world version the successor's replay
                # lacks. A failed/poisoned commit raises: the reform
                # aborts un-announced, exactly like a master crash at
                # this instant (the in-memory bump was never observable).
                commit.wait()
            with self._lock:
                if self._stop.is_set():
                    spawn_span.set(outcome="skipped_manager_stopping")
                    logger.info("re-formation skipped: manager stopping")
                    return
                if self._world_version != world_version:
                    # a concurrent reform superseded us while we awaited
                    # durability; its spawn/announce carries the newer
                    # version — ours must not resurrect an older cohort
                    spawn_span.set(outcome="superseded")
                    logger.warning(
                        "re-formation superseded (world v%d -> v%d)",
                        world_version, self._world_version,
                    )
                    return
                self._procs.clear()
                if new_size != old_size:
                    # a deliberate resize opens a fresh in-place relaunch
                    # budget
                    self._cohort_relaunches = 0
                self._spawn_cohort_locked(new_size)
                self.reformation_log.append((t0, old_size, new_size))
                if self._pending_resize is None:
                    # this resize's timeline ends when its world is up; a
                    # QUEUED next resize keeps its own announced trace id
                    self._reform_trace_id = None
                # the resize landed: the announcement now carries the NEW
                # world (pending cleared unless another resize is already
                # queued)
                self._announce_locked()
                _COHORT_SIZE.set(self._cohort_size)
        tracing.set_world_version(world_version)
        _REFORMS.inc(kind="resize" if new_size != old_size else "relaunch")
        reform_s = time.monotonic() - t0
        _REFORM_S.observe(reform_s)
        # feed the autoscaler's cost model (outside the lock; best-effort)
        self._notify_reform(reform_s, old_size, new_size)
        if new_size != old_size:
            logger.warning(
                "cohort RESIZED %d -> %d processes (world v%d): %s",
                old_size, new_size, world_version, reason,
            )
        else:
            logger.warning(
                "cohort relaunched at %d processes (world v%d): %s",
                new_size, world_version, reason,
            )

    def _await_resize_checkpoint(self) -> None:
        """Request a checkpoint (via the wired master hook) and wait for a
        newer one to appear before a deliberate teardown. Best-effort: no
        hook, no checkpoint_dir, or a quiet worker (no new steps) just times
        out and the resize proceeds — same cost as before this existed."""
        if self._checkpoint_request_fn is None or not self.cfg.checkpoint_dir:
            return
        try:
            if self._probe_ckpt_mngr is None:
                # one orbax manager, reused for every resize (each instance
                # holds background threads/handles; per-resize construction
                # would leak them across a long elastic job)
                from elasticdl_tpu_torch.training.checkpoint import CheckpointManager

                self._probe_ckpt_mngr = CheckpointManager(self.cfg.checkpoint_dir)
            mngr = self._probe_ckpt_mngr
            before = mngr.latest_step(refresh=True)
        except Exception:
            logger.exception("resize checkpoint probe failed; skipping quiesce")
            return
        try:
            self._checkpoint_request_fn()
        except Exception:
            logger.exception("resize checkpoint request failed; skipping quiesce")
            return
        deadline = time.time() + self._resize_ckpt_timeout_s
        while time.time() < deadline and not self._stop.is_set():
            if self._job_finished_fn():
                return  # nothing left to protect; caller re-checks job end
            try:
                # refresh: the checkpoint is written by the WORKER processes
                latest = mngr.latest_step(refresh=True)
            except Exception:
                break
            if latest is not None and latest != before:
                logger.info(
                    "pre-resize checkpoint landed at step %s (was %s)",
                    latest, before,
                )
                return
            # local-disk poll by ONE watcher thread, not a fleet retrying a
            # shared service — no herd to jitter: edl-lint: disable=EDL304
            time.sleep(0.2)
        logger.warning(
            "pre-resize checkpoint did not land within %.0fs; resizing anyway",
            self._resize_ckpt_timeout_s,
        )

    def _watch_cohort_loop(self, poll_s: float) -> None:
        """Cohort semantics: the jax.distributed world is all-or-nothing —
        one dead member fails the others, so ANY failure tears the cohort
        down and re-forms it whole (the new world restores from the last
        checkpoint). Three re-formation flavors:

        - in-place relaunch (same size) for transient crashes, up to
          `relaunch_max` generations;
        - budget-free retry for world-formation failures (all failed exits
          are ExitCode.WORLD_FORM_FAILED — coordinator-port races), up to
          `infra_retry_max`;
        - RESIZE: on a member marked no-relaunch (permanently lost host), on
          an exhausted relaunch budget, or on an operator add/remove_worker
          request, the next generation runs at the NEW process count —
          training continues at N-1 instead of stalling, or picks up the new
          capacity at N+1. The job only fails when it cannot even run at
          size 1.

        Policy note (documented limitation): a permanently lost host is only
        KNOWN to be lost through the operator/test API
        (`kill_worker(relaunch=False)` sets no_relaunch). A real lost host is
        indistinguishable from a transient crash, so recovery first burns the
        in-place relaunch budget (each a full world boot, see
        reformation_log / BASELINE.md re-formation latency) before shrinking
        by one. Tune `relaunch_max` down when hosts are more likely to vanish
        than to crash transiently.
        """
        while not self._stop.is_set():
            with self._lock:
                items = list(self._procs.items())
                pending = self._pending_resize
                size_now = self._cohort_size
            codes = {pid: wp.proc.poll() for pid, wp in items}
            failed = [
                pid for pid, c in codes.items() if c is not None and c != 0
            ]
            if not failed:
                with self._lock:
                    # the retried generation has stayed up: the incident is
                    # over, so the next one gets a full budget-free retry
                    # budget (read+reset under the lock — the old unlocked
                    # read raced add/remove_worker; edl-lint EDL101 find)
                    last = (
                        self.reformation_log[-1][0]
                        if self.reformation_log else 0.0
                    )
                    if self._infra_retries and time.time() - last > 60:
                        self._infra_retries = 0
                        logger.info(
                            "world formation recovered; infra retry budget reset"
                        )
            if failed and not self._job_finished_fn():
                members = dict(items)
                lost = [pid for pid in failed if members[pid].no_relaunch]
                infra = all(
                    codes[pid] == ExitCode.WORLD_FORM_FAILED for pid in failed
                )
                # Decide the next generation's size and commit it to
                # _cohort_size under ONE lock hold: a concurrent
                # add/remove_worker landing during the (slow) teardown below
                # then compounds on the new target instead of the stale size.
                with self._lock:
                    size = self._cohort_size
                    if self._pending_resize == pending:
                        self._pending_resize = None
                    if pending is not None and pending != size:
                        target = pending
                        reason = (
                            f"resize requested while member(s) {failed} died"
                        )
                    elif infra and self._infra_retries < self.infra_retry_max:
                        self._infra_retries += 1
                        target = size
                        reason = (
                            f"world-formation failure (infra retry "
                            f"{self._infra_retries}/{self.infra_retry_max}, "
                            f"budget-free)"
                        )
                    elif (
                        not lost
                        and self._cohort_relaunches < self.cfg.relaunch_max
                    ):
                        self._cohort_relaunches += 1
                        target = size
                        reason = (
                            f"transient failure, generation "
                            f"{self._cohort_relaunches}/{self.cfg.relaunch_max}"
                        )
                    else:
                        # Permanently lost member(s) or exhausted budget:
                        # continue at the surviving count instead of failing.
                        # On budget exhaustion shrink by exactly 1 — a single
                        # crash can cascade every member to a nonzero exit
                        # (world collapse), so len(failed) overstates the loss.
                        target = size - (len(lost) if lost else 1)
                        reason = (
                            "lost member(s) " + str(lost or failed)
                            + ("" if lost else " with relaunch budget spent")
                        )
                    if target >= 1:
                        self._cohort_size = target
                    if not infra:
                        # a formed-then-failed world proves the coordinator
                        # path works: fresh infra budget for the next incident
                        self._infra_retries = 0
                with self._lock:
                    if self._reform_trace_id is None:
                        # crash-path reform: no announcement preceded it, so
                        # the timeline starts here
                        self._reform_trace_id = tracing.new_trace_id()
                    reform_tid = self._reform_trace_id
                with tracing.span(
                    "reform", trace_id=reform_tid, reason=reason,
                    old_size=size, new_size=target,
                ):
                    with tracing.span("reform.teardown"):
                        self._teardown_cohort(
                            items, reason=f"cohort member(s) {failed} died"
                        )
                    if target < 1:
                        logger.error(
                            "cohort cannot continue: no survivors to re-form"
                        )
                        for wp in members.values():
                            wp.status = PodStatus.FAILED
                        return
                    self._reform_cohort(target, size, reason)
            elif (
                pending is not None
                and pending != size_now   # snapshot: _cohort_size is locked
                and not self._job_finished_fn()
            ):
                # planned resize of a HEALTHY cohort: quiesce first — ask for
                # a checkpoint and wait for it, so only sub-task progress is
                # redone at the new size (a crash path can't do this; a
                # deliberate one shouldn't skip it)
                with self._lock:
                    reform_tid = (
                        self._reform_trace_id or tracing.new_trace_id()
                    )
                    self._reform_trace_id = reform_tid
                with tracing.span(
                    "reform", trace_id=reform_tid,
                    reason="operator resize request", new_size=pending,
                    old_size=size_now,
                ):
                    with tracing.span("reform.quiesce"):
                        self._await_resize_checkpoint()
                    if self._job_finished_fn():
                        # the job ran out from under the resize: nothing to
                        # do — and this resize's trace id dies with it (a
                        # later reform is a DIFFERENT incident and must
                        # open its own timeline)
                        with self._lock:
                            if self._pending_resize == pending:
                                self._pending_resize = None
                            self._reform_trace_id = None
                            self._announce_locked()
                        continue
                    with self._lock:
                        if self._pending_resize == pending:
                            self._pending_resize = None
                        old = self._cohort_size
                        self._cohort_size = pending
                    with tracing.span("reform.teardown"):
                        self._teardown_cohort(
                            items, reason=f"cohort resize to {pending}"
                        )
                    self._reform_cohort(pending, old, "operator resize request")
            elif all(c is not None for c in codes.values()) and codes:
                with self._lock:
                    for wp in self._procs.values():
                        wp.status = PodStatus.SUCCEEDED
                return
            self._stop.wait(poll_s)

    def request_flight_dump(
        self, worker_id: int, process_index: Optional[int] = None
    ) -> bool:
        """SIGUSR2 a worker's process(es): the flight recorder's explicit
        trigger — the straggler hook's OFFENDER snapshot rides this
        (client/local.py wires it; only the launcher knows pids). Plain
        mode: the proc registered under `worker_id`. Cohort mode: the
        member process at `process_index`, or the whole cohort when None
        (a cohort-level flag with no process attribution). Returns True
        when at least one live process was signalled."""
        with self._lock:
            if self._cohort_mode:
                keys = (
                    [process_index] if process_index is not None
                    else list(self._procs)
                )
            else:
                keys = [worker_id]
            procs = [
                self._procs[k].proc for k in keys if k in self._procs
            ]
        signalled = False
        for proc in procs:
            if proc.poll() is not None:
                continue
            try:
                proc.send_signal(signal.SIGUSR2)
                signalled = True
            except (OSError, ValueError):
                continue
        if signalled:
            logger.info(
                "flight dump requested from worker %d%s (SIGUSR2)",
                worker_id,
                f" process {process_index}" if process_index is not None
                else "",
            )
        return signalled

    # ------------------------------------------------------------------ #

    def stop(self, grace_s: float = 10.0) -> None:
        self._stop.set()
        if self._watcher:
            self._watcher.join(timeout=grace_s)
        if self._probe_ckpt_mngr is not None:
            try:
                self._probe_ckpt_mngr.close()
            except Exception:
                logger.exception("closing resize checkpoint probe failed")
            self._probe_ckpt_mngr = None
        with self._lock:
            procs = list(self._procs.values())
        deadline = time.time() + grace_s
        for wp in procs:
            if wp.proc.poll() is None:
                wp.proc.terminate()
        for wp in procs:
            timeout = max(0.1, deadline - time.time())
            try:
                wp.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                wp.proc.kill()
        # Flush-on-shutdown (closes the PR 7 known boundary): in group-
        # commit mode the newest world_version record may still be riding
        # the committer's bounded window when a clean stop lands — force
        # the open batch to disk NOW so an orderly teardown never loses
        # the version sequence the workers already observed. (The owning
        # Master's close() would drain too, but this manager must not
        # depend on who tears down first.)
        with self._lock:
            journal = self._journal
        if journal is not None:
            try:
                journal.flush()
            except Exception:
                logger.exception("journal flush at manager stop failed")

    def all_exited(self) -> bool:
        with self._lock:
            return all(wp.proc.poll() is not None for wp in self._procs.values())

    def all_failed(self) -> bool:
        """True when every worker that could still make progress is dead
        with its relaunch budget spent — the job cannot continue.
        DELETED (policy-evicted) and SUCCEEDED slots are deliberate
        retirements, not failures: they are EXCLUDED from the scan, or a
        single autoscale eviction would pin this False forever and a
        subsequently all-dead fleet could never abort the launcher's
        wait."""
        with self._lock:
            tracked = [
                wp for wp in self._procs.values()
                if wp.status not in (PodStatus.DELETED, PodStatus.SUCCEEDED)
            ]
            if not tracked:
                return False
            return all(
                wp.status == PodStatus.FAILED and wp.proc.poll() is not None
                for wp in tracked
            )

    def statuses(self) -> Dict[int, str]:
        with self._lock:
            out = {}
            for wid, wp in self._procs.items():
                code = wp.proc.poll()
                out[wid] = (
                    wp.status
                    if code is None
                    else (PodStatus.SUCCEEDED if code == 0 else wp.status)
                )
            return out
