"""The worker: lease tasks from the master, run the train step, report back.

Counterpart of `elasticdl_tpu/worker/worker.py`: `Worker.run()` loops
`get_task` → build the data stream → per-minibatch train step →
`report_task_result`, plus evaluation, prediction and SAVE_MODEL tasks,
heartbeats with the telemetry payload, interval and drain checkpoints,
and the final export. It speaks the reference's wire protocol (the
port's `proto/` is a copy), so it serves either master.

The worker runs on one device: the device comes from
`common/runtime.resolve_device` (the card unless the caller names
another; no card raises), and the prefetcher copies batches to it
(`data/prefetch.py`). Its mesh comes from `parallel.mesh.build_job_mesh`,
as the reference's does, and has one device: a `--mesh_shape` that names
more raises, pointing to `--num_processes` (the SPMD cohort,
`worker/cohort.py`, which subclasses this worker).

Grouped dispatch (`--steps_per_dispatch K > 1`) buffers K prefetched
device batches and runs them through `Trainer.train_many` (eval_many,
predict_many), with one loss readback a group. Gradient accumulation and
remat are the Trainer's knobs. `--profile_dir` records a window of worker
0's steps with `torch.profiler` as a Chrome trace.

With `--embedding_shards N` the worker joins the elastic embedding tier
(`embedding/tier.WorkerTierRuntime`, its store on the worker's device):
it owns the shards the master's map assigns it, serves them over the
gRPC data plane with `--embedding_transport grpc`, reports the tier's
stats on its heartbeat, drains its shards into the checkpoint directory
on a forced save, and re-fetches the map and installs moved shards at a
task boundary after a membership change.

The in-place rescale (`request_rescale`) raises `NotImplementedError`: a
port process drives one card, so the reference's single-process rescale
has no world to shrink; a cohort re-forms through the instance manager
(ROADMAP items 32 and 19, under "Differences of design").
"""

from __future__ import annotations

import os
import socket
import threading
import time
from collections import deque
from typing import Any, Dict, Optional

import numpy as np

from elasticdl_tpu_torch.common import faults, runtime
from elasticdl_tpu_torch.common.config import JobConfig
from elasticdl_tpu_torch.common.constants import WorkerEnv
from elasticdl_tpu_torch.common.log_utils import default_logger
from elasticdl_tpu_torch.data.reader import create_data_reader
from elasticdl_tpu_torch.observability import flight as flight_lib
from elasticdl_tpu_torch.observability import goodput as goodput_lib
from elasticdl_tpu_torch.observability import reqtrace as reqtrace_lib
from elasticdl_tpu_torch.observability import profile as profile_lib
from elasticdl_tpu_torch.observability import timeseries as timeseries_lib
from elasticdl_tpu_torch.observability import tracing
from elasticdl_tpu_torch.observability.health import (
    STATS_METADATA_KEY,
    WorkerStepStats,
    encode_stats,
)
from elasticdl_tpu_torch.observability.registry import default_registry
from elasticdl_tpu_torch.parallel import mesh as mesh_lib
from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb
from elasticdl_tpu_torch.proto.service import (
    RetryingMasterStub,
    is_stale_generation,
    jittered,
    make_channel,
    register_with_retry,
    reregister,
)
from elasticdl_tpu_torch.training.model_spec import ModelSpec
from elasticdl_tpu_torch.worker.task_data_service import TaskDataService

logger = default_logger(__name__)

_reg = default_registry()
_TRAIN_STEPS = _reg.counter(
    "edl_train_steps_total", "train steps run by this worker")
_TRAIN_RECORDS = _reg.counter(
    "edl_train_records_total", "non-padding records applied")
_TRAIN_THROUGHPUT = _reg.gauge(
    "edl_train_samples_per_sec",
    "per-task mean throughput (records / measured step wall time)")
_TRAIN_STEP_S = _reg.histogram(
    "edl_train_step_seconds", "per-step wall time (dispatch + compute)")
_RECONNECTS = _reg.counter(
    "edl_worker_reconnects_total",
    "reconnect handshakes after a master restart (re-register + re-lease)")


class Worker:
    # a shutdown or preemption ends a training task at a group boundary
    # (a cohort member must not: its peers run the task on)
    _drains_mid_task = True
    # the prefix of the line each training task logs (`_log_training`)
    _task_line = "task"

    def __init__(self, cfg: JobConfig, device: runtime.DeviceLike = None):
        self.cfg = cfg
        # resolved before anything connects: a worker with no card (and
        # no explicit request for another device) fails here, before it
        # registers with the master
        self.device = runtime.resolve_device(device)
        self._mesh = self._job_mesh()
        self._trainer = None
        self._state = None
        self._spec: Optional[ModelSpec] = None
        self._services: Dict[int, TaskDataService] = {}
        self._readers: Dict[int, Any] = {}
        self._stub: Optional[RetryingMasterStub] = None
        self.worker_id = -1
        self._membership_version = -1
        self._shutdown = threading.Event()
        self._heartbeat_thread: Optional[threading.Thread] = None
        self._ckpt_manager = None
        self._last_ckpt_step = 0
        self._preempted = False
        self._job_done = False
        self._mid_training_task = False
        self._base_lr = None          # injected LR at init (elastic scaling)
        self._pending_lr = None       # set by heartbeat thread, applied by run loop
        self._pushed_lr = 0.0         # last master-pushed LR override seen
        self._last_known_workers = 0  # latest alive count (register/heartbeat)
        self._global_step = 0         # train steps run by this worker
        # Plain-int mirror of state.model_version, maintained by the MAIN
        # thread; the heartbeat thread reads this, never the state.
        self._model_version = 0
        self._ckpt_requested = False  # heartbeat should_checkpoint bit
        self._last_master_ok = time.monotonic()  # last successful master RPC
        self._master_lost = False     # unreachable past the config timeout
        # heartbeat-piggybacked telemetry (observability/health.py)
        self._step_stats = WorkerStepStats()
        # Batched leases (--task_lease_batch): locally leased tasks still
        # to run, drained before the next GetTask poll; cleared on every
        # reconnect handshake.
        self._lease_queue: "deque[pb.Task]" = deque()
        self._profile_state = "idle"  # idle -> active -> done (torch.profiler)
        self._profiler = None
        self._profile_first_step = 0
        # Elastic sharded embedding tier (cfg.embedding_shards > 0): this
        # worker's owning store + pull/push client. Membership bumps set
        # the refresh flag (heartbeat thread); the run loop reacts at the
        # next task boundary — shard installs must not stall heartbeats.
        self._tier = None
        self._tier_refresh_pending = False
        self._data_server = None

    # ------------------------------------------------------------------ #
    # setup

    def _connect(self) -> None:
        addr = self.cfg.master_addr
        self._channel = make_channel(addr)
        # Hardened stub: per-call deadlines, idempotent-only retries with
        # backoff, circuit breaker; every successful RPC refreshes the
        # master-unreachable clock through on_success.
        self._stub = RetryingMasterStub(
            self._channel, on_success=self._note_master_ok,
            channel_factory=lambda: make_channel(addr),
        )
        # registered once, reused by every reconnect handshake
        self._name = f"{socket.gethostname()}:{os.getpid()}"
        # gRPC embedding data plane: the endpoint comes up BEFORE
        # registration so its address can ride the RegisterWorker request
        # into the owner address book; the store binds later, when the
        # tier runtime builds it (_init_embedding_tier)
        self._start_data_plane()
        preferred = int(os.environ.get(WorkerEnv.WORKER_ID, -1))
        resp = self._boot_register(self._name, preferred)
        self.worker_id = resp.worker_id
        self._membership_version = resp.membership_version
        self._last_known_workers = resp.num_workers
        tracing.configure_from_config(
            self.cfg, role=f"worker-{self.worker_id}"
        )
        flight_lib.configure_from_config(
            self.cfg, role=f"worker-{self.worker_id}"
        )
        flight_lib.install_crash_hooks()
        timeseries_lib.configure_from_config(
            self.cfg, role=f"worker-{self.worker_id}"
        )
        logger.info(
            "registered as worker %d (membership v%d, %d workers) on %s",
            self.worker_id, resp.membership_version, resp.num_workers,
            self.device,
        )

    def _boot_register(self, name: str, preferred: int):
        """Boot-time registration that rides out a master that is down or
        restarting (proto/service.py's register_with_retry)."""
        return register_with_retry(
            self._stub,
            name=name,
            preferred_id=preferred,
            window_s=self.cfg.master_unreachable_timeout_s,
            shutdown=self._shutdown,
            data_addr=self._data_addr,
        )

    def _start_data_plane(self) -> None:
        """Bind the per-worker EmbeddingData endpoint. A bind failure is
        fatal: `--embedding_transport grpc` means peers' shards live in
        other processes, so silently falling back to LocalTransport would
        leave every peer-owned pull/push raising OwnerUnavailableError
        forever — fail at boot, loudly, instead."""
        self._data_server = None
        if (self.cfg.embedding_shards <= 0
                or self.cfg.embedding_transport != "grpc"):
            return
        try:
            from elasticdl_tpu_torch.embedding.data_plane import (
                EmbeddingDataServer,
            )

            self._data_server = EmbeddingDataServer(
                shm=self.cfg.embedding_shm)
            self._data_server.start()
        except Exception as e:
            self._data_server = None
            raise RuntimeError(
                "embedding data-plane endpoint failed to start but "
                "--embedding_transport grpc requires it (peer-owned "
                f"shards are unreachable over LocalTransport): {e}"
            ) from e

    @property
    def _data_addr(self) -> str:
        srv = self._data_server
        return srv.address or "" if srv is not None else ""

    def _note_master_ok(self) -> None:
        self._last_master_ok = time.monotonic()

    def _master_unreachable(self) -> bool:
        """True (once; also flips _master_lost and _shutdown) when no
        master RPC has succeeded for master_unreachable_timeout_s: the
        worker then exits EX_TEMPFAIL instead of spinning on a dead
        address."""
        limit = self.cfg.master_unreachable_timeout_s
        if limit <= 0 or time.monotonic() - self._last_master_ok < limit:
            return False
        if not self._master_lost:
            self._master_lost = True
            logger.error(
                "no successful master RPC for %.0fs (limit %.0fs): master "
                "presumed gone, exiting EX_TEMPFAIL",
                time.monotonic() - self._last_master_ok, limit,
            )
            self._shutdown.set()
        return True

    def _reregister(self) -> None:
        """The reconnect handshake after a master restart: idempotent
        re-register under our EXISTING worker id, then apply the response."""
        resp = reregister(
            self._stub, name=self._name, worker_id=self.worker_id,
            data_addr=self._data_addr,
        )
        # the restarted master requeued every lease of the dead generation
        self._lease_queue.clear()
        self.worker_id = resp.worker_id
        self._membership_version = resp.membership_version
        self._last_known_workers = resp.num_workers or self._last_known_workers
        _RECONNECTS.inc()
        tracing.event(
            "worker.reconnect", worker_id=self.worker_id,
            membership_version=resp.membership_version,
        )
        logger.warning(
            "re-registered with restarted master as worker %d "
            "(membership v%d); resuming leases under the new generation",
            self.worker_id, resp.membership_version,
        )

    def _maybe_reconnect(self, e: BaseException) -> bool:
        """True when `e` was a stale-generation rejection AND the reconnect
        handshake ran — the caller retries its loop."""
        if self.worker_id < 0 or not is_stale_generation(e):
            return False
        try:
            self._reregister()
            return True
        except Exception as handshake_err:
            logger.warning(
                "re-register after master restart failed: %s", handshake_err
            )
            self._master_unreachable()
            return False

    def _job_mesh(self) -> Optional[mesh_lib.Mesh]:
        """The job's mesh: one device, raising for a --mesh_shape of more
        (there is no world to lay them out over)."""
        return mesh_lib.build_job_mesh(self.cfg)

    def _build_trainer(self) -> None:
        self._spec = ModelSpec.from_config(self.cfg)
        self._trainer = self._make_trainer()

    def _make_trainer(self):
        """The one trainer construction path, the cohort's too: the
        config-derived cache token lets a trainer rebuilt in this process
        at the same shape find its programs (`training/compile_cache.py`)."""
        from elasticdl_tpu_torch.training import compile_cache
        from elasticdl_tpu_torch.training.trainer import Trainer

        return Trainer(self._spec, device=self.device,
                       seed=self.cfg.shuffle_seed, remat=self.cfg.remat,
                       remat_policy=self.cfg.remat_policy,
                       grad_accum=self.cfg.grad_accum_steps, mesh=self._mesh,
                       cache_token=compile_cache.job_cache_token(self.cfg))

    def _data_service(self, task_type: int) -> TaskDataService:
        if task_type not in self._services:
            paths = {
                pb.TRAINING: self.cfg.training_data,
                pb.EVALUATION: self.cfg.validation_data or self.cfg.training_data,
                pb.PREDICTION: self.cfg.prediction_data,
            }
            reader = create_data_reader(
                paths[task_type], self.cfg.data_reader, **self.cfg.data_reader_params
            )
            mode = {
                pb.TRAINING: "training",
                pb.EVALUATION: "evaluation",
                pb.PREDICTION: "prediction",
            }[task_type]
            if self._spec.dataset_fn is None:
                raise ValueError("model module must define dataset_fn for data tasks")
            parse = self._spec.dataset_fn(mode, reader.metadata)
            # a batch splits evenly over the data axis (1 for a plain
            # worker)
            multiple = self._mesh.axis_size(mesh_lib.data_axis(self._mesh))
            self._readers[task_type] = reader
            self._services[task_type] = TaskDataService(
                reader, parse, self.cfg.minibatch_size,
                batch_multiple=multiple
            )
        return self._services[task_type]

    def _prefetched(self, batches):
        """Overlap the host->device copy with compute (data/prefetch.py).
        Depth/cast come from the config, overridable via
        EDL_PREFETCH_DEPTH / EDL_PREFETCH_CAST (env wins)."""
        from elasticdl_tpu_torch.data.prefetch import prefetch_to_device

        depth = (None if "EDL_PREFETCH_DEPTH" in os.environ
                 else self.cfg.prefetch_batches)
        cast = (None if "EDL_PREFETCH_CAST" in os.environ
                else self.cfg.wire_dtype)
        return prefetch_to_device(self.device, batches, depth, cast=cast)

    def _checkpoint_manager(self):
        if self._ckpt_manager is None and self.cfg.checkpoint_dir:
            from elasticdl_tpu_torch.training.checkpoint import CheckpointManager

            self._ckpt_manager = CheckpointManager(
                self.cfg.checkpoint_dir, keep=self.cfg.keep_checkpoint_max
            )
        return self._ckpt_manager

    def _ensure_state(self, example_batch: Dict[str, Any]) -> None:
        if self._state is not None:
            return
        self._state = self._trainer.init_state(example_batch)
        if self.cfg.scale_lr_with_workers and self._base_lr is None:
            from elasticdl_tpu_torch.training.lr_modulation import get_learning_rate

            # Read the CONFIGURED base LR from the freshly-initialized state,
            # before checkpoint restore — a restored optimizer may already
            # carry an elastically scaled LR, and re-basing on it would
            # compound the scaling across relaunches.
            self._base_lr = get_learning_rate(self._state.optimizer)
            if self._base_lr is None:
                logger.warning(
                    "scale_lr_with_workers needs an optimizer built via "
                    "lr_modulation.modulated(...); LR scaling disabled"
                )
        # Elastic recovery: a relaunched worker resumes from the latest
        # checkpoint instead of fresh params.
        mngr = self._checkpoint_manager()
        if mngr is not None and mngr.latest_step() is not None:
            restored = mngr.restore(self._state)
            if restored is not None:
                self._state = restored
                self._last_ckpt_step = self._state.model_version
                logger.info(
                    "resumed from checkpoint at step %d", self._last_ckpt_step
                )
                if (self.cfg.scale_lr_with_workers and self._base_lr
                        and not self._pushed_lr):
                    from elasticdl_tpu_torch.training.lr_modulation import linear_scale

                    # re-derive the LR from the CURRENT worker count seen at
                    # registration (unless a master LR push is active)
                    self._pending_lr = linear_scale(
                        self._base_lr,
                        self._last_known_workers or self.cfg.num_workers,
                        self.cfg.num_workers,
                    )
        self._model_version = self._state.model_version

    def _maybe_checkpoint(self, force: bool = False) -> None:
        """Step-interval checkpointing (--checkpoint_steps), plus forced
        saves on preemption — both taken only at task boundaries, and only
        by worker 0 (one writer per directory). force=True also drains an
        in-flight save, so a preemption exit never abandons one, and
        persists this worker's tier shards."""
        if force and self._tier is not None:
            # the tier half of a forced save: every worker persists ITS
            # resident shards (one owner per shard — no write races),
            # seq watermarks included, so a planned kill loses no acked
            # push
            try:
                self._tier.drain()
            except Exception:
                logger.exception("embedding tier drain failed")
        mngr = self._checkpoint_manager()
        if mngr is None or self._state is None or self.worker_id != 0:
            return
        if self._mid_training_task:
            # Never persist mid-task state: the task's lease is released
            # only on report, so a mid-task save + relaunch would re-apply
            # the task's records (double-counting).
            if force:
                mngr.wait()
            return
        step = self._state.model_version
        due = (
            self.cfg.checkpoint_steps > 0
            and step - self._last_ckpt_step >= self.cfg.checkpoint_steps
        )
        if (force and step > self._last_ckpt_step) or due:
            mngr.save(self._state)
            self._last_ckpt_step = step
        if force:
            mngr.wait()

    # ------------------------------------------------------------------ #
    # heartbeats

    def _stats_payload(self) -> Dict[str, Any]:
        """The heartbeat telemetry payload: recent step-time quantiles +
        records/s, plus the control-plane state the master's health layer
        reads (breaker, phase, prefetch lookahead, world generation)."""
        stats = self._step_stats.snapshot()
        phase = "train" if self._mid_training_task else "idle"
        try:
            depth = int(
                os.environ.get("EDL_PREFETCH_DEPTH", "")
                or self.cfg.prefetch_batches
            )
        except ValueError:
            depth = self.cfg.prefetch_batches
        stats.update(
            phase=phase,
            breaker_open=int(bool(self._stub and self._stub.breaker.is_open)),
            prefetch_depth=depth,
            world_version=tracing.get_tracer().world_version,
        )
        stats.update(profile_lib.get_profiler().snapshot())
        stats.update(goodput_lib.get_ledger().payload())
        stats.update(reqtrace_lib.get_recorder().payload())
        self._tier_stats(stats)
        return stats

    def _tier_stats(self, stats: Dict[str, Any]) -> None:
        """The embedding tier's ride-along (hot-id share, shard imbalance,
        recent pull/push p99): best-effort, a tier hiccup must never cost
        the heartbeat."""
        if self._tier is not None:
            try:
                stats.update(self._tier.client.tier_stats())
            except Exception:
                logger.debug("tier stats skipped", exc_info=True)

    def _heartbeat_loop(self) -> None:
        while not self._shutdown.is_set():
            timeseries_lib.get_store().maybe_sample()
            try:
                faults.fire("worker.heartbeat")
                # telemetry rides as OPTIONAL metadata; a payload-building
                # failure degrades this beat to liveness-only
                try:
                    md = ((STATS_METADATA_KEY,
                           encode_stats(self._stats_payload())),)
                except Exception:
                    md = None
                resp = self._stub.Heartbeat(
                    pb.HeartbeatRequest(
                        worker_id=self.worker_id,
                        model_version=self._model_version,
                    ),
                    timeout=10,
                    metadata=md,
                )
                if resp.shutdown:
                    logger.info("master requested shutdown")
                    # job_done distinguishes normal completion (export the
                    # final model) from aborts/evictions (don't)
                    if resp.job_done:
                        self._job_done = True
                    self._shutdown.set()
                    break
                if getattr(resp, "evict", False):
                    # graceful-eviction drain: identical to a SIGTERM
                    # preemption, driven off the _preempted flag
                    logger.warning(
                        "master evicted this worker (autoscale policy); "
                        "draining"
                    )
                    tracing.event(
                        "worker.evicted", worker_id=self.worker_id,
                    )
                    self.preempt()
                    break
                self._last_known_workers = resp.num_workers or self._last_known_workers
                if resp.should_checkpoint:
                    # honored by the run loop at the next task boundary
                    self._ckpt_requested = True
                if resp.membership_version != self._membership_version:
                    self._on_membership_change(
                        resp.membership_version, resp.num_workers
                    )
                if (
                    resp.learning_rate > 0
                    and resp.learning_rate != self._pushed_lr
                ):
                    # master-pushed LR override: applied at the next task
                    # boundary; the push is job-global and wins
                    self._pushed_lr = resp.learning_rate
                    self._pending_lr = resp.learning_rate
            except Exception as e:
                logger.warning("heartbeat failed: %s", e)
                if not self._maybe_reconnect(e):
                    self._master_unreachable()
            self._shutdown.wait(jittered(self.cfg.worker_heartbeat_s))

    def _on_membership_change(self, new_version: int, num_workers: int = 0) -> None:
        """The worker set changed: rescale the LR when
        scale_lr_with_workers (applied by the run loop at the next task
        boundary); an active master push wins."""
        logger.info(
            "membership v%d -> v%d", self._membership_version, new_version
        )
        self._membership_version = new_version
        if self._tier is not None:
            # shards may have been re-planned onto (or off) this worker;
            # the run loop executes the refresh at a task boundary
            self._tier_refresh_pending = True
        if (
            self.cfg.scale_lr_with_workers and self._base_lr and num_workers
            and not self._pushed_lr
        ):
            from elasticdl_tpu_torch.training.lr_modulation import linear_scale

            self._pending_lr = linear_scale(
                self._base_lr, num_workers, self.cfg.num_workers
            )

    def request_rescale(self, axis_sizes=None, devices=None) -> None:
        raise NotImplementedError(
            "the in-place rescale (live state handoff onto a new mesh) is "
            "not ported: a port process drives one card, so the "
            "reference's single-process rescale has no world to shrink; a "
            "cohort re-forms through the instance manager (ROADMAP items "
            "32 and 19, under 'Differences of design')")

    # ------------------------------------------------------------------ #
    # task execution

    def _maybe_profile(self) -> None:
        """Drive the profiler trace window: worker 0 records steps
        [profile_start_step, profile_start_step + profile_steps) with
        `torch.profiler` (host activity, and the card's kernels on a CUDA
        device) into profile_dir, skipping warm-up. One window per run; a
        start that fails logs and disables the window."""
        if not self.cfg.profile_dir or self.worker_id != 0:
            return
        if (
            self._profile_state == "idle"
            and self._global_step >= self.cfg.profile_start_step
        ):
            try:
                from torch.profiler import ProfilerActivity, profile

                activities = [ProfilerActivity.CPU]
                if self.device.type == "cuda":
                    activities.append(ProfilerActivity.CUDA)
                self._profiler = profile(activities=activities)
                self._profiler.start()
                self._profile_state = "active"
                self._profile_first_step = self._global_step
                logger.info(
                    "profiler trace started at step %d -> %s",
                    self._global_step, self.cfg.profile_dir,
                )
            except Exception:
                logger.exception("profiler start failed; disabled")
                self._profile_state = "done"
        elif (
            self._profile_state == "active"
            and self._global_step
            >= self.cfg.profile_start_step + self.cfg.profile_steps
        ):
            self._stop_profiler()

    def _stop_profiler(self) -> None:
        """Close an open trace window and write it as a Chrome trace,
        `worker-<id>.steps-<first>-<last>.pt.trace.json`."""
        if self._profile_state != "active":
            return
        try:
            self._profiler.stop()
            os.makedirs(self.cfg.profile_dir, exist_ok=True)
            path = os.path.join(
                self.cfg.profile_dir,
                f"worker-{self.worker_id}.steps-{self._profile_first_step}"
                f"-{self._global_step}.pt.trace.json")
            self._profiler.export_chrome_trace(path)
            logger.info("profiler trace stopped at step %d -> %s",
                        self._global_step, path)
        except Exception:
            logger.exception("profiler stop failed")
        self._profiler = None
        self._profile_state = "done"

    def _grouped_stream(self, stream, k, interrupted):
        """The scaffold of the training, eval and prediction task paths:
        yield lists of device batches, full k-groups and then one trailing
        partial. Every batch comes through the prefetcher (`_prefetched`:
        the wire cast, pinned staging and a copy on a side stream ahead
        of the step), so a group's copies ride behind the steps before
        it. On shutdown or preemption `interrupted` (a list) gets a True
        and the stream ends at the group boundary: the trailing partial
        is NOT yielded, so a drain report covers whole groups only (a
        cohort member runs every task to its end)."""
        buf = []
        for batch in self._prefetched(stream):
            if self._drains_mid_task and self._shutdown.is_set():
                interrupted.append(True)
                return
            self._ensure_state(batch)
            buf.append(batch)
            if len(buf) == k:
                yield buf
                buf = []
        if buf:
            yield buf

    def _stacked(self, buf):
        """A full group's device batches stacked into one batch of leaves
        (k, B, ...) (`trainer.stack_batches`, a copy on the card), timed
        as the step profiler's h2d phase."""
        from elasticdl_tpu_torch.training.trainer import stack_batches

        with profile_lib.get_profiler().phase("h2d"):
            return stack_batches(buf, self.device)

    def _log_training(self, task: pb.Task, stats: Dict[str, Any]) -> None:
        """One line a training task: its steps, records and time in
        steps, the step profiler's per-step data wait and h2d, and the
        embedding-gradient kernel's launches in this process so far (K1,
        `ops/placement.py`), and those the step programs' capture
        warm-ups made beside them (`training/step_graph.py`)."""
        from elasticdl_tpu_torch.ops import placement
        from elasticdl_tpu_torch.training import step_graph

        prof = profile_lib.get_profiler().snapshot(update_memory=False)
        logger.info(
            "%s %d: %d steps, %d records, %.6f s in steps, "
            "data_wait %.3f ms and h2d %.3f ms a step, %s launches %d "
            "(and %d in capture warm-ups)",
            self._task_line, task.task_id, int(stats["loss_count"]),
            int(stats["records_done"]), stats["step_time_sum"],
            prof.get("phase_data_wait_ms", 0.0),
            prof.get("phase_h2d_ms", 0.0), placement.KERNEL,
            placement.launches, step_graph.warmup_launches[placement.KERNEL])

    def _run_training_task(self, task: pb.Task) -> Dict[str, float]:
        """Run a training task in groups of k = --steps_per_dispatch
        batches. A full group of k > 1 goes through `Trainer.train_many`,
        its losses read back once; a single batch (k == 1) or a trailing
        partial group runs as train_steps. Exactly-once accounting: a
        group's records count as applied only after its readback, and
        preemption stops at a group boundary, so the drain report covers
        whole groups."""
        k = max(1, self.cfg.steps_per_dispatch)
        svc = self._data_service(pb.TRAINING)
        stats = {"loss_sum": 0.0, "loss_count": 0, "records_done": 0,
                 "step_time_sum": 0.0, "interrupted": False}
        self._mid_training_task = True
        interrupted: list = []
        # always-on step profiler: the prefetcher attributes data_wait/h2d;
        # this loop attributes compute and closes each group's record
        prof = profile_lib.get_profiler()

        for buf in self._grouped_stream(
            svc.batches(task.shard_name, task.start, task.end), k, interrupted
        ):
            self._maybe_profile()
            stacked = (self._stacked(buf) if len(buf) == k and k > 1
                       else None)
            t0 = time.perf_counter()
            # straggler-injection site, inside the timed region, one a group
            faults.fire(f"worker.train_step.{self.worker_id}")
            if stacked is not None:
                self._state, m = self._trainer.train_many(self._state, stacked)
                # one readback a group: it waits for the group's k steps,
                # so the group's time covers the device's compute, and
                # grouping amortizes it k-fold: edl-lint: disable=EDL201
                stats["loss_sum"] += float(m["loss"].sum())
            else:
                for b in buf:
                    self._state, logs = self._trainer.train_step(self._state, b)
                    # float() waits for the step, so the wall time covers
                    # the whole step (launches + device compute): the sync
                    # IS the measurement: edl-lint: disable=EDL201
                    stats["loss_sum"] += float(logs["loss"])
            group_s = time.perf_counter() - t0
            stats["step_time_sum"] += group_s
            _TRAIN_STEP_S.observe(group_s / len(buf))
            # one profile record a group, normalized per step in step_done
            prof.add("compute", group_s)
            prof.step_done(len(buf))
            stats["loss_count"] += len(buf)
            self._global_step += len(buf)
            self._model_version += len(buf)
            # the real (non-padding) records the group applied; the drain
            # report retires records mid-task, so they count per group:
            # edl-lint: disable=EDL201
            group_records = int(sum(b["mask"].sum() for b in buf))
            stats["records_done"] += group_records
            # one telemetry sample a group, normalized to per-step values
            self._step_stats.observe_step(
                group_s / len(buf), group_records / len(buf))
        stats["interrupted"] = bool(interrupted)
        return stats

    def _report_preempted_task(self, task: pb.Task, stats: Dict[str, float]) -> None:
        """Drain protocol for an interrupted training task (the
        reference's): save the mid-task state durably (worker 0 with a
        checkpoint_dir only; otherwise report 0 records so the whole task
        requeues), report the applied-record count, and delete the drain
        checkpoint if the master explicitly rejects the report."""
        mngr = self._checkpoint_manager()
        records_applied = int(stats["records_done"])
        records_done = records_applied
        drain_step = None
        if records_done > 0 and mngr is not None and self.worker_id == 0:
            try:
                drain_step = mngr.save(self._state, wait=True)
            except Exception:
                logger.exception("drain checkpoint failed; requeueing full task")
                drain_step = None
        if drain_step is None:
            records_done = 0
        delivered = False
        try:
            faults.fire("worker.report_task")
            resp = self._stub.ReportTaskResult(
                pb.ReportTaskResultRequest(
                    worker_id=self.worker_id,
                    task_id=task.task_id,
                    success=False,
                    preempted=True,
                    err_message="preempted",
                    records_processed=records_done,
                    loss_sum=stats["loss_sum"],
                    loss_count=int(stats["loss_count"]),
                    model_version=self._model_version,
                ),
                timeout=10,
            )
            accepted = resp.accepted
            delivered = True
        except Exception as e:
            logger.warning("preemption drain report failed to deliver: %s", e)
            accepted = False
            if is_stale_generation(e):
                # a definitive rejection: the restarted master requeued the
                # lease whole, so the drain checkpoint would double-apply
                delivered = True
                self._maybe_reconnect(e)
        if accepted:
            if drain_step is not None or records_applied == 0:
                self._mid_training_task = False
            if drain_step is not None:
                self._last_ckpt_step = drain_step
        elif drain_step is not None and delivered:
            # explicit rejection (stale lease): the full task re-runs, so
            # this checkpoint would double-apply — discard it
            mngr.delete(drain_step)

    def _run_evaluation_task(self, task: pb.Task) -> bool:
        """Returns True if interrupted by shutdown/preemption (no report)."""
        states = self._evaluate(task)
        if states is None:
            return True
        self._report_metrics(task, states)
        return False

    def _evaluate(self, task: pb.Task):
        """The task's metric states, or None if interrupted. Full k-groups
        run through `Trainer.eval_many`; the scaffold is
        `_grouped_stream`."""
        svc = self._data_service(pb.EVALUATION)
        states = self._trainer.new_metric_states()
        k = max(1, self.cfg.steps_per_dispatch)
        interrupted: list = []
        for buf in self._grouped_stream(
            svc.batches(task.shard_name, task.start, task.end), k, interrupted
        ):
            if len(buf) == k and k > 1:
                states = self._trainer.eval_many(
                    self._state, self._stacked(buf), states)
            else:
                for b in buf:
                    states = self._trainer.eval_step(self._state, b, states)
        return None if interrupted else states

    def _report_metrics(self, task: pb.Task, states) -> None:
        msg = pb.ReportEvaluationMetricsRequest(
            worker_id=self.worker_id,
            eval_job_id=task.eval_job_id,
            task_id=task.task_id,
        )
        for name, state in states.items():
            arr = np.asarray(state, np.float32)
            msg.states.append(pb.MetricState(name=name, data=arr.tobytes()))
        self._stub.ReportEvaluationMetrics(msg, timeout=30)

    def _outputs_processor(self):
        return self._spec.prediction_outputs_processor

    def _run_prediction_task(self, task: pb.Task) -> bool:
        """Returns True if interrupted by shutdown/preemption (no report).
        Full k-groups run through `Trainer.predict_many`, whose stacked
        outputs go to the processor batch by batch in order; the scaffold
        is `_grouped_stream`."""
        from elasticdl_tpu_torch.worker.prediction_outputs_processor import (
            iter_stacked,
            mask_predictions,
        )

        svc = self._data_service(pb.PREDICTION)
        processor = self._outputs_processor()
        k = max(1, self.cfg.steps_per_dispatch)
        interrupted: list = []

        def process(batch, outputs):
            if processor is None:
                return
            # D2H only when someone consumes the outputs
            valid = np.asarray(batch["mask"].cpu()) > 0
            processor.process(mask_predictions(outputs, valid),
                              self.worker_id)

        for buf in self._grouped_stream(
            svc.batches(task.shard_name, task.start, task.end), k, interrupted
        ):
            if len(buf) == k and k > 1:
                outs = self._trainer.predict_many(
                    self._state, self._stacked(buf))
                if processor is not None:
                    for b, out in zip(buf, iter_stacked(outs, len(buf))):
                        process(b, out)
            else:
                for b in buf:
                    process(b, self._trainer.predict_step(self._state, b))
        return bool(interrupted)

    # ------------------------------------------------------------------ #

    def _init_embedding_tier(self) -> None:
        """Join the elastic embedding tier (cfg.embedding_shards > 0):
        register this worker's owning store (on the worker's device),
        build the pull/push client off the master's shard map, install
        any shards the map (or a checkpoint) assigns here. Best-effort at
        boot, as in the reference: a worker that cannot join the tier
        still trains dense models."""
        if self.cfg.embedding_shards <= 0 or self._tier is not None:
            return
        try:
            from elasticdl_tpu_torch.embedding.tier import WorkerTierRuntime

            transport = bind_servicer = None
            if (self.cfg.embedding_transport == "grpc"
                    and self._data_server is not None):
                # the partition-tolerant data plane: peers' shards over
                # gRPC through the robustness layer; our own store
                # short-circuits in-process
                from elasticdl_tpu_torch.embedding.data_plane import (
                    GrpcTransport,
                    ResilientTransport,
                    default_policies,
                )

                budget_s = self.cfg.embedding_rpc_deadline_ms / 1e3
                queue_journal = ""
                if (self.cfg.embedding_push_queue > 0
                        and self.cfg.checkpoint_dir):
                    queue_journal = os.path.join(
                        self.cfg.checkpoint_dir,
                        f"emb-push-queue-{self.worker_id}.jsonl")
                transport = ResilientTransport(
                    GrpcTransport(default_timeout_s=budget_s,
                                  shm=self.cfg.embedding_shm),
                    policies=default_policies(budget_s),
                    staleness_bound=self.cfg.embedding_cache_staleness,
                    hedge=self.cfg.embedding_hedge_ms >= 0,
                    hedge_delay_ms=max(0, self.cfg.embedding_hedge_ms),
                    queue_journal=queue_journal,
                    queue_max=self.cfg.embedding_push_queue,
                )
                bind_servicer = self._data_server.servicer
            self._tier = WorkerTierRuntime(
                self._stub, self.worker_id,
                checkpoint_dir=self.cfg.checkpoint_dir,
                transport=transport,
                bind_servicer=bind_servicer,
                cache_rows=self.cfg.embedding_cache_rows,
                cache_staleness=self.cfg.embedding_cache_staleness,
                read_replicas=self.cfg.embedding_read_replicas > 0,
                pipeline_depth=self.cfg.embedding_pull_pipeline,
                device=self.device,
            )
            logger.info(
                "joined embedding tier: map v%d, %d shard(s) resident on %s",
                self._tier.client.view.version,
                len(self._tier.store.resident_shards()), self.device,
            )
        except Exception:
            logger.exception(
                "embedding tier init failed; tier disabled for this worker"
            )

    def _close_embedding_tier(self) -> None:
        """Teardown: take this worker's store out of its transport (the
        process-local one outlives an in-process worker) and stop the
        data-plane endpoint."""
        if self._tier is not None:
            try:
                self._tier.close()
            except Exception:
                logger.debug("embedding tier close failed", exc_info=True)
        if self._data_server is not None:
            try:
                self._data_server.stop()
            except Exception:
                logger.debug("data-plane endpoint stop failed",
                             exc_info=True)

    def _tier_task_boundary(self) -> None:
        """The tier's task-boundary work: after a membership change,
        refetch the map and install/confirm newly-owned shards; otherwise
        one replica delta-sync round (a no-op without replicas)."""
        if self._tier is None:
            return
        if self._tier_refresh_pending:
            self._tier_refresh_pending = False
            try:
                self._tier.on_world_change()
            except Exception:
                logger.exception("embedding tier refresh failed")
            return
        try:
            self._tier.sync_replicas()
        except Exception:
            logger.exception("embedding replica sync failed")

    def run(self) -> int:
        self._connect()
        self._init_embedding_tier()
        # /metrics + /healthz for this worker (best-effort, off the hot
        # path; a set EDL_METRICS_PORT overrides cfg.metrics_port)
        from elasticdl_tpu_torch.observability.http import start_server

        self._metrics_server = start_server(
            role=f"worker-{self.worker_id}", port=self.cfg.metrics_port
        )
        self._build_trainer()
        self._heartbeat_thread = threading.Thread(
            target=self._heartbeat_loop, daemon=True
        )
        self._heartbeat_thread.start()

        tasks_done = 0
        wait_backoff = 1.0
        while not self._shutdown.is_set():
            if self._lease_queue:
                task = self._lease_queue.popleft()
            else:
                try:
                    resp = self._stub.GetTask(
                        pb.GetTaskRequest(
                            worker_id=self.worker_id,
                            max_tasks=self.cfg.task_lease_batch,
                        ),
                        timeout=30,
                    )
                except Exception as e:
                    logger.warning("get_task failed: %s; retrying", e)
                    if self._maybe_reconnect(e):
                        continue
                    if self._master_unreachable():
                        break
                    with goodput_lib.get_ledger().phase("reconnect"):
                        time.sleep(jittered(2))
                    continue
                if resp.job_done:
                    logger.info("job done after %d tasks", tasks_done)
                    self._job_done = True
                    break
                leased = list(resp.tasks) or [resp.task]
                task = leased[0]
                self._lease_queue.extend(leased[1:])
                wait_backoff = resp.backoff_seconds or 1.0
            pending_lr, self._pending_lr = self._pending_lr, None
            if pending_lr is not None and self._state is not None:
                from elasticdl_tpu_torch.training.lr_modulation import (
                    apply_learning_rate,
                )

                self._state = apply_learning_rate(
                    self._trainer, self._state, pending_lr
                )
                logger.info("runtime LR set to %.6g", pending_lr)
            elif pending_lr is not None:
                self._pending_lr = pending_lr
            if self._ckpt_requested and not self._mid_training_task:
                # master-requested checkpoint, at a task boundary only
                self._ckpt_requested = False
                try:
                    self._maybe_checkpoint(force=True)
                except Exception:
                    logger.exception("master-requested checkpoint failed")
            self._tier_task_boundary()
            if task.type == pb.WAIT:
                with goodput_lib.get_ledger().phase("lease_wait"):
                    time.sleep(jittered(wait_backoff))
                continue

            report = pb.ReportTaskResultRequest(
                worker_id=self.worker_id, task_id=task.task_id, success=True
            )
            try:
                if task.type == pb.TRAINING:
                    stats = self._run_training_task(task)
                    self._log_training(task, stats)
                    _TRAIN_STEPS.inc(int(stats["loss_count"]))
                    _TRAIN_RECORDS.inc(int(stats["records_done"]))
                    if stats["step_time_sum"] > 0:
                        _TRAIN_THROUGHPUT.set(
                            stats["records_done"] / stats["step_time_sum"]
                        )
                    if stats["interrupted"]:
                        self._report_preempted_task(task, stats)
                        break
                    report.loss_sum = stats["loss_sum"]
                    report.loss_count = int(stats["loss_count"])
                    report.step_time_sum = stats["step_time_sum"]
                    report.step_count = int(stats["loss_count"])
                elif task.type == pb.EVALUATION:
                    if self._run_evaluation_task(task):
                        break
                elif task.type == pb.PREDICTION:
                    if self._run_prediction_task(task):
                        break
                elif task.type == pb.SAVE_MODEL:
                    self._save_checkpoint()
                report.records_processed = task.end - task.start
                if self._state is not None:
                    report.model_version = self._model_version
            except Exception as e:
                logger.exception("task %d failed", task.task_id)
                report.success = False
                report.err_message = str(e)[:512]
            try:
                faults.fire("worker.report_task")
                self._stub.ReportTaskResult(report, timeout=30)
                if task.type == pb.TRAINING and report.success:
                    # state and task queue agree here: safe checkpoint point
                    self._mid_training_task = False
                    self._maybe_checkpoint()
            except Exception as e:
                logger.warning("report failed for task %d: %s", task.task_id, e)
                if self._maybe_reconnect(e):
                    logger.warning(
                        "task %d report was fenced by the restarted master; "
                        "the requeued lease re-runs it", task.task_id,
                    )
            tasks_done += 1

        # A trace window still open at exit (short job or preemption) must
        # be written: an unstopped trace writes nothing.
        self._stop_profiler()

        # Preemption-triggered save: SIGTERM'd workers persist progress so
        # the relaunch resumes instead of retraining.
        if self._preempted:
            try:
                self._maybe_checkpoint(force=True)
            except Exception:
                logger.exception("preemption checkpoint failed")
            flight_lib.get_recorder().dump("preempt")

        # Export runs here, not in the GetTask branch: a worker may learn
        # the job finished from the heartbeat shutdown flag.
        if self._job_done and not self._preempted:
            self._export_final_model()

        processor = self._spec.prediction_outputs_processor if self._spec else None
        if processor is not None:
            try:
                processor.close()
            except Exception:
                logger.exception("prediction outputs processor close failed")

        # Orderly teardown: stop the heartbeat thread and close the channel
        # BEFORE interpreter exit — a grpc call in flight during shutdown
        # aborts the process from the C++ layer.
        self._shutdown.set()
        if self._ckpt_manager is not None:
            try:
                self._ckpt_manager.close()
            except Exception:
                logger.exception("checkpoint close failed")
        if getattr(self, "_metrics_server", None) is not None:
            try:
                self._metrics_server.stop()
            except Exception:
                logger.debug("metrics endpoint stop failed", exc_info=True)
        self._close_embedding_tier()
        tracing.get_tracer().close()
        if self._heartbeat_thread is not None:
            self._heartbeat_thread.join(timeout=2 * self.cfg.worker_heartbeat_s)
        try:
            self._channel.close()
        except Exception:
            logger.debug("grpc channel close failed at exit", exc_info=True)
        # A preempted worker exits EX_TEMPFAIL so the instance manager
        # relaunches it; a lost master too; a clean job-done exit is 0.
        return 75 if (self._preempted or self._master_lost) else 0

    def _export_final_model(self) -> None:
        """Job-end serving export: worker 0 writes `--output`. Failures
        are logged, not raised, as in the reference: the job's result is
        its checkpoints, and callers check the artifact themselves."""
        if not self.cfg.output or self.worker_id != 0 or self._state is None:
            return
        try:
            from elasticdl_tpu_torch.training.export import export_model

            export_model(
                self._state,
                self.cfg.output,
                model_def=self.cfg.model_def,
                model_params=self._spec.model_params,
                module_name=self._spec.module_name,
            )
        except Exception:
            logger.exception("final model export failed")

    def preempt(self) -> None:
        """SIGTERM hook: finish/abandon the current batch, checkpoint, exit."""
        logger.info("preemption signal received; draining")
        self._preempted = True
        self._shutdown.set()

    def _save_checkpoint(self) -> None:
        """Serve a SAVE_MODEL task: persist current state and wait for
        durability. With no live state, success only if a checkpoint is
        already on disk (it IS the current state); otherwise fail the task
        so the dispatcher retries it on a worker that has state."""
        mngr = self._checkpoint_manager()
        if mngr is None:
            raise RuntimeError(
                "SAVE_MODEL: no checkpoint_dir configured, nothing to save to"
            )
        if self._state is None:
            if mngr.latest_step(refresh=True) is None:
                raise RuntimeError(
                    "SAVE_MODEL: no live training state and no checkpoint on "
                    "disk to vouch for"
                )
            return
        mngr.save(self._state, wait=True)
        self._last_ckpt_step = self._state.model_version
