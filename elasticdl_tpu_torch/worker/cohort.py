"""Multi-process SPMD worker cohort: one logical worker over one
`torch.distributed` world.

Counterpart of `elasticdl_tpu/worker/cohort.py` (the reference's rebuild
of ElasticDL's elastic-AllReduce mode). N processes, one device each, form
one world (`parallel/elastic.py`) and one mesh over it
(`parallel/mesh.py`); every process runs the same steps on the same
global batches, each on its block of rows, with the dense gradients
summed over the data axis and the embedding tables sharded by row ranges
(`training/trainer.py`, `ops/embedding.py`).

Topology of control: process 0 (the leader) is the only one the master
sees — it leases tasks, reports results and heartbeats, carrying the
other processes' beats as member entries. Followers receive a small
broadcast control vector per task (op, shard, span, flags, the master's
LR push) and run the identical data and compute sequence. Every
collective (train step, eval, checkpoint save, export gather) is run by
ALL processes; every host-side decision rides the control broadcast, so
the cohort stays in lockstep by construction.

Elasticity is re-formation: a dead member fails the world, the process
manager kills the survivors and relaunches the cohort, and the new world
restores from the latest checkpoint and re-leases at the task boundary.

SIGTERM (planned preemption): a FOLLOWER exits at once (EX_TEMPFAIL) —
it cannot drain, because the leader would keep broadcasting control
vectors it no longer answers. The LEADER drains: it finishes the
in-flight task, then broadcasts OP_ABORT|FLAG_CHECKPOINT, every process
joins one final collective save, and all exit EX_TEMPFAIL, so the
relaunched cohort resumes at the pre-kill step.

The worker pieces are the plain worker's (`worker/worker.py`, which this
class extends): the pinned prefetcher, the grouped task loops and the
profiler window. With `--embedding_shards N` the cohort is one logical
worker of the embedding tier: the leader alone joins it, its store on
the leader's device, syncs replicas at the collective poll boundary and
drains its shards into the checkpoint directory on every teardown; the
next generation's leader restores them. Not ported, by design, and
raising for its option: the speculative compiler of the in-place rescale
(`--speculative_compile`; ROADMAP item 19, under "Differences of
design").
"""

from __future__ import annotations

import os
import signal
import socket
import sys
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from elasticdl_tpu_torch.common import runtime
from elasticdl_tpu_torch.common.config import JobConfig
from elasticdl_tpu_torch.common.constants import ExitCode
from elasticdl_tpu_torch.common.log_utils import default_logger
from elasticdl_tpu_torch.observability import flight as flight_lib
from elasticdl_tpu_torch.observability import goodput as goodput_lib
from elasticdl_tpu_torch.observability import profile as profile_lib
from elasticdl_tpu_torch.observability import reqtrace as reqtrace_lib
from elasticdl_tpu_torch.observability import timeseries as timeseries_lib
from elasticdl_tpu_torch.observability import tracing
from elasticdl_tpu_torch.observability.health import (
    STATS_METADATA_KEY,
    encode_stats,
)
from elasticdl_tpu_torch.parallel import mesh as mesh_lib
from elasticdl_tpu_torch.parallel.elastic import CohortContext, context_from_env
from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb
from elasticdl_tpu_torch.proto.service import (
    jittered,
    make_channel,
    register_with_retry,
    reregister,
    RetryingMasterStub,
)
from elasticdl_tpu_torch.worker.worker import Worker

logger = default_logger(__name__)

# control vector:
#   [op, task_id, task_type, shard_idx, start, end, flags, eval_job, lr_bits]
# lr_bits = float64 bit-pattern of the master-pushed LR override (0 = none);
# riding the broadcast keeps every process applying the same LR at the same
# task boundary (SPMD lockstep).
OP_NOOP, OP_TASK, OP_DONE, OP_ABORT = 0, 1, 2, 3
FLAG_CHECKPOINT = 1
CTRL_LEN = 9


def _lr_to_bits(lr: float) -> int:
    return 0 if not lr else int(np.float64(lr).view(np.int64))


def _bits_to_lr(bits: int) -> float:
    return 0.0 if not bits else float(np.int64(bits).view(np.float64))


def _ctrl(op: int, flags: int = 0) -> List[int]:
    out = [op] + [0] * (CTRL_LEN - 1)
    out[6] = flags
    return out


class CohortWorker(Worker):
    # every member runs every task to its end: the drain is the leader's,
    # at a task boundary
    _drains_mid_task = False
    _task_line = "cohort task"

    def __init__(self, cfg: JobConfig, ctx: Optional[CohortContext] = None,
                 device: runtime.DeviceLike = None):
        if cfg.speculative_compile:
            raise NotImplementedError(
                "--speculative_compile (neighbor-world compilation for the "
                "in-place rescale) is not ported: the port has no compiled "
                "program to warm until a step is captured as a CUDA graph "
                "(ROADMAP item 19, under 'Differences of design')")
        self.ctx = ctx or context_from_env(cfg)
        # the member's card, checked before the world forms
        super().__init__(cfg, device=runtime.cohort_device(
            self.ctx.process_id, device))
        self.ctx.device = self.device
        self._preempt = False         # leader: SIGTERM drain requested
        self._ctrl_pushed_lr = 0.0    # all: latest override from the ctrl vector
        self._applied_push_lr = 0.0   # all: last override applied to state
        self._shards: Dict[int, List[Any]] = {}
        # master-assigned ids of processes 1..N-1 (leader only); their
        # beats ride the leader's one Heartbeat as MemberBeat entries
        self._member_ids: List[int] = []
        # leader: latest follower stats rows by process index (written by
        # the task loop at the post-task exchange, read by the heartbeat
        # thread — whole-dict swaps only)
        self._member_stats: Dict[int, Dict[str, Any]] = {}
        self._phase = "boot"
        self._channel = None

    def _job_mesh(self):
        return None   # built over the world once it has formed

    def _outputs_processor(self):
        # the leader holds the gathered outputs and processes them
        return (self._spec.prediction_outputs_processor
                if self.ctx.is_leader else None)

    # ------------------------------------------------------------------ #
    # setup (identical on every process)

    def _shard_name(self, task_type: int, shard_idx: int) -> str:
        return self._shard_list(task_type)[shard_idx][0]

    def _shard_index(self, task_type: int, name: str) -> int:
        for i, (n, _, _) in enumerate(self._shard_list(task_type)):
            if n == name:
                return i
        raise KeyError(f"unknown shard {name!r}")

    def _shard_list(self, task_type: int) -> List[Any]:
        """shard index -> (name, start, end); identical everywhere (sorted)
        so a broadcast int addresses the same shard on every process."""
        if task_type not in self._shards:
            self._data_service(task_type)
            self._shards[task_type] = sorted(
                self._readers[task_type].create_shards())
        return self._shards[task_type]

    def _ensure_state(self, example_batch) -> None:
        if self._state is not None:
            return
        self._state = self._trainer.init_state(example_batch)
        mngr = self._checkpoint_manager()
        if mngr is not None and mngr.latest_step() is not None:
            restored = mngr.restore(self._state)
            if restored is not None:
                self._state = restored
                self._last_ckpt_step = self._state.model_version
                logger.info(
                    "cohort resumed from checkpoint at step %d",
                    self._last_ckpt_step,
                )
        self._model_version = self._state.model_version
        if self.ctx.num_processes != self.cfg.num_processes:
            # every generation consumes the same cfg.minibatch_size rows a
            # step (each process takes a block of one host batch), so the
            # linear LR-scaling rule of independent workers does not apply
            logger.info(
                "cohort world resized %d -> %d processes; global batch and "
                "LR unchanged (strong scaling)",
                self.cfg.num_processes, self.ctx.num_processes,
            )
        # a relaunched cohort restores a pre-push LR: apply the push now,
        # not after its first task
        self._maybe_apply_ctrl_lr()

    # ------------------------------------------------------------------ #
    # leader-only: master RPCs

    def _connect(self) -> None:
        addr = self.cfg.master_addr
        self._channel = make_channel(addr)
        self._stub = RetryingMasterStub(
            self._channel, on_success=self._note_master_ok,
            channel_factory=lambda: make_channel(addr),
        )
        # the leader is always worker 0, and its member processes join in
        # the same round trip; the name is reused by every reconnect
        self._name = f"cohort-{socket.gethostname()}:{os.getpid()}"
        resp = register_with_retry(
            self._stub,
            name=self._name,
            preferred_id=0,
            window_s=self.cfg.master_unreachable_timeout_s,
            shutdown=self._shutdown,
            what="cohort leader",
            member_names=self._member_names(),
        )
        self.worker_id = resp.worker_id
        self._member_ids = list(resp.member_ids)
        logger.info(
            "cohort leader registered as worker %d (%d processes, %d member "
            "entries) on %s", self.worker_id, self.ctx.num_processes,
            len(self._member_ids), self.device,
        )

    def _member_names(self) -> List[str]:
        """Stable per-process member identities (processes 1..N-1)."""
        return [
            f"{self._name}#p{i}" for i in range(1, self.ctx.num_processes)
        ]

    def _reregister(self) -> None:
        """Leader-only reconnect handshake after a master restart; the
        cohort keeps running throughout."""
        resp = reregister(
            self._stub, name=self._name, worker_id=self.worker_id,
            member_names=self._member_names(),
        )
        self._lease_queue.clear()
        self.worker_id = resp.worker_id
        self._member_ids = list(resp.member_ids)
        logger.warning(
            "cohort leader re-registered with restarted master as worker %d; "
            "resuming leases under the new generation", self.worker_id,
        )

    def _stats_payload(self) -> Dict[str, Any]:
        stats = self._step_stats.snapshot()
        stats.update(
            phase=self._phase,
            breaker_open=int(bool(self._stub and self._stub.breaker.is_open)),
            num_processes=self.ctx.num_processes,
            world_version=tracing.get_tracer().world_version,
        )
        stats.update(profile_lib.get_profiler().snapshot())
        stats.update(goodput_lib.get_ledger().payload())
        stats.update(reqtrace_lib.get_recorder().payload())
        self._tier_stats(stats)
        return stats

    def _member_beats(self) -> List[pb.MemberBeat]:
        """Per-member beats riding the leader's one heartbeat: a
        follower's own stats where the post-task exchange delivered a
        row, the leader's otherwise."""
        if not self._member_ids:
            return []
        base = self._step_stats.snapshot()
        member_stats = self._member_stats   # whole-dict snapshot
        beats = []
        for idx, mid in enumerate(self._member_ids, start=1):
            row = member_stats.get(idx)
            stats = dict(row if row is not None else base)
            stats["source"] = ("follower-local" if row is not None
                               else "leader-coalesced")
            stats.update(phase=self._phase, process_index=idx)
            beats.append(pb.MemberBeat(
                worker_id=mid, model_version=self._model_version,
                stats_json=encode_stats(stats)))
        return beats

    #: fields of the fixed-width int64 exchange row, in wire order (times
    #: in microseconds, rates in milli-units)
    _EXCHANGE_FIELDS = (
        "steps", "step_p50_us", "step_p90_us", "step_max_us",
        "records_per_s_milli", "phase_data_wait_us", "phase_h2d_us",
        "phase_compute_us",
    )

    def _exchange_row(self) -> List[int]:
        snap = self._step_stats.snapshot()
        prof = profile_lib.get_profiler().snapshot(update_memory=False)
        return [
            int(snap.get("steps", 0)),
            int(1e3 * snap.get("step_p50_ms", 0.0)),
            int(1e3 * snap.get("step_p90_ms", 0.0)),
            int(1e3 * snap.get("step_max_ms", 0.0)),
            int(1e3 * snap.get("records_per_s", 0.0)),
            int(1e3 * prof.get("phase_data_wait_ms", 0.0)),
            int(1e3 * prof.get("phase_h2d_ms", 0.0)),
            int(1e3 * prof.get("phase_compute_ms", 0.0)),
        ]

    @classmethod
    def _decode_exchange_row(cls, row) -> Dict[str, Any]:
        """Back to the heartbeat-payload schema (ms, records/s)."""
        vals = dict(zip(cls._EXCHANGE_FIELDS, (int(v) for v in row)))
        out: Dict[str, Any] = {"steps": vals["steps"]}
        if vals["steps"]:
            out.update(
                step_p50_ms=round(vals["step_p50_us"] / 1e3, 3),
                step_p90_ms=round(vals["step_p90_us"] / 1e3, 3),
                step_max_ms=round(vals["step_max_us"] / 1e3, 3),
                records_per_s=round(vals["records_per_s_milli"] / 1e3, 3),
            )
        for key in ("data_wait", "h2d", "compute"):
            if vals[f"phase_{key}_us"]:
                out[f"phase_{key}_ms"] = round(
                    vals[f"phase_{key}_us"] / 1e3, 3)
        return out

    def _exchange_member_stats(self) -> None:
        """COLLECTIVE, at the end of every training task: each process's
        stats row over the control group's allgather; the leader keeps
        the followers' rows for the next heartbeat's member beats."""
        if self.ctx.num_processes <= 1:
            return
        rows = self.ctx.allgather_ints(self._exchange_row())
        if self.ctx.is_leader:
            self._member_stats = {
                idx: self._decode_exchange_row(rows[idx])
                for idx in range(1, self.ctx.num_processes)}

    def _heartbeat_loop(self) -> None:
        while not self._shutdown.is_set():
            timeseries_lib.get_store().maybe_sample()
            try:
                # telemetry is optional: a payload failure degrades this
                # beat to liveness-only
                try:
                    md = ((STATS_METADATA_KEY,
                           encode_stats(self._stats_payload())),)
                except Exception:
                    md = None
                try:
                    members = self._member_beats()
                except Exception:
                    members = []
                resp = self._stub.Heartbeat(
                    pb.HeartbeatRequest(
                        worker_id=self.worker_id,
                        model_version=self._model_version,
                        members=members,
                    ),
                    timeout=10,
                    metadata=md,
                )
                if resp.shutdown:
                    if resp.job_done:
                        self._job_done = True
                    self._shutdown.set()
                    break
                if resp.should_checkpoint:
                    # the next control vector's FLAG_CHECKPOINT: a
                    # collective save at the task boundary
                    self._ckpt_requested = True
                if resp.learning_rate > 0:
                    # rides the next control vector (lr_bits)
                    self._pushed_lr = resp.learning_rate
            except Exception as e:
                logger.warning("cohort heartbeat failed: %s", e)
                if not self._maybe_reconnect(e):
                    self._master_unreachable()
            self._shutdown.wait(jittered(self.cfg.worker_heartbeat_s))

    def request_preempt(self) -> bool:
        """Leader SIGTERM hook (a flag, no I/O): the next control vector
        becomes OP_ABORT|FLAG_CHECKPOINT. False on followers, which exit
        at once instead."""
        if not self.ctx.is_leader:
            return False
        self._preempt = True
        return True

    def _lease_control(self) -> List[int]:
        """Leader: turn the next master response into a control vector."""
        if self._preempt and not self._shutdown.is_set():
            logger.info("leader preempted: draining cohort via collective "
                        "checkpoint")
            return _ctrl(OP_ABORT, FLAG_CHECKPOINT)
        if self._shutdown.is_set():
            # a lost master (the heartbeat crossed the limit mid-task):
            # one final collective save, which needs no master
            return _ctrl(OP_DONE if self._job_done else OP_ABORT,
                         FLAG_CHECKPOINT if self._master_lost else 0)
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
                logger.warning("cohort get_task failed: %s", e)
                if self._maybe_reconnect(e):
                    return _ctrl(OP_NOOP)
                if self._master_unreachable():
                    return _ctrl(OP_ABORT, FLAG_CHECKPOINT)
                return _ctrl(OP_NOOP)
            if resp.job_done:
                self._job_done = True
                return _ctrl(OP_DONE)
            leased = list(resp.tasks) or [resp.task]
            task = leased[0]
            self._lease_queue.extend(leased[1:])
        if task.type == pb.WAIT:
            return _ctrl(OP_NOOP)
        due = (
            self.cfg.checkpoint_steps > 0
            and self._state is not None
            and self._state.model_version - self._last_ckpt_step
            >= self.cfg.checkpoint_steps
        )
        if self._ckpt_requested:
            # cleared only when consumed: the servicer's bit is one-shot
            self._ckpt_requested = False
            due = True
        return [
            OP_TASK, task.task_id, task.type,
            (0 if task.type == pb.SAVE_MODEL
             else self._shard_index(task.type, task.shard_name)),
            task.start, task.end,
            FLAG_CHECKPOINT if due else 0,
            task.eval_job_id,
            _lr_to_bits(self._pushed_lr),
        ]

    # ------------------------------------------------------------------ #
    # collective task execution (every process)

    def _maybe_apply_ctrl_lr(self) -> None:
        """Apply the latest control-vector LR override once state exists;
        every process reaches the same call sites with the same value."""
        pushed_lr = self._ctrl_pushed_lr
        if (pushed_lr > 0 and pushed_lr != self._applied_push_lr
                and self._state is not None):
            from elasticdl_tpu_torch.training.lr_modulation import (
                apply_learning_rate,
            )

            self._state = apply_learning_rate(
                self._trainer, self._state, pushed_lr)
            self._applied_push_lr = pushed_lr
            logger.info("applied master-pushed LR %g", pushed_lr)

    def _report(self, request) -> None:
        """Leader: one result RPC; a fenced report re-registers."""
        try:
            self._stub.ReportTaskResult(request, timeout=30)
        except Exception as e:
            logger.warning("cohort report failed for task %d: %s",
                           request.task_id, e)
            self._maybe_reconnect(e)

    def _save_model(self, task_id: int) -> None:
        """The master's final save task: a collective checkpoint; with no
        live state, success only if a checkpoint is already on disk (every
        process branches alike: state and directory are symmetric)."""
        mngr = self._checkpoint_manager()
        ok, err = True, ""
        if mngr is None:
            ok, err = False, "no checkpoint_dir configured, nothing to save to"
        elif self._state is not None:
            mngr.save(self._state, wait=True)
            self._last_ckpt_step = self._state.model_version
        elif mngr.latest_step() is None:
            ok, err = False, "no live state and no checkpoint on disk"
        if self.ctx.is_leader:
            self._report(pb.ReportTaskResultRequest(
                worker_id=self.worker_id, task_id=task_id, success=ok,
                err_message=err, model_version=self._model_version))

    def _run_task(self, ctrl: List[int]) -> None:
        _, task_id, task_type, shard_idx, start, end, flags, eval_job, \
            lr_bits = ctrl
        self._ctrl_pushed_lr = _bits_to_lr(lr_bits)
        self._maybe_apply_ctrl_lr()
        if task_type == pb.SAVE_MODEL:
            self._save_model(task_id)
            return
        task = pb.Task(task_id=task_id, type=task_type,
                       shard_name=self._shard_name(task_type, shard_idx),
                       start=start, end=end, eval_job_id=eval_job)
        report = pb.ReportTaskResultRequest(
            worker_id=self.worker_id, task_id=task_id, success=True,
            records_processed=end - start)
        states = None
        self._phase = "train"
        try:
            if task_type == pb.TRAINING:
                stats = self._run_training_task(task)
                self._mid_training_task = False
                self._log_training(task, stats)
                report.loss_sum = stats["loss_sum"]
                report.loss_count = int(stats["loss_count"])
                report.step_time_sum = stats["step_time_sum"]
                report.step_count = int(stats["loss_count"])
                self._exchange_member_stats()
            elif task_type == pb.EVALUATION:
                states = self._evaluate(task)
            elif task_type == pb.PREDICTION:
                self._run_prediction_task(task)
        finally:
            self._phase = "idle"
        # followers have no heartbeat: this is their sampling cadence
        timeseries_lib.get_store().maybe_sample()
        if flags & FLAG_CHECKPOINT:
            mngr = self._checkpoint_manager()
            if mngr is not None and self._state is not None:
                mngr.save(self._state, wait=True)
                self._last_ckpt_step = self._state.model_version
        if not self.ctx.is_leader:
            return
        report.model_version = self._model_version
        self._report(report)
        if states is not None:
            try:
                self._report_metrics(task, states)
            except Exception as e:
                logger.warning("cohort metrics report failed for task %d: "
                               "%s", task_id, e)

    def _export_final_model(self) -> None:
        """Collective: every process joins the table gather; the leader
        writes the export."""
        if not self.cfg.output or self._state is None:
            return
        try:
            from elasticdl_tpu_torch.training.export import export_model

            export_model(
                self._state, self.cfg.output,
                model_def=self.cfg.model_def,
                model_params=self._spec.model_params,
                module_name=self._spec.module_name,
                write_files=self.ctx.is_leader,
            )
        except Exception:
            logger.exception("cohort final export failed")

    # ------------------------------------------------------------------ #

    def _install_sigterm_drain(self) -> None:
        """The preemption handler once the world has formed: the leader
        drains, a follower exits. No-op off the main thread."""
        def on_sigterm(*_):
            if not self.request_preempt():
                sys.exit(ExitCode.COHORT_EVICTED)

        try:
            signal.signal(signal.SIGTERM, on_sigterm)
        except ValueError:
            pass

    def _finish(self) -> None:
        """Post-loop teardown (run under the drain checkpoint's write when
        there is one)."""
        self._stop_profiler()
        processor = self._outputs_processor() if self._spec else None
        if processor is not None:
            try:
                processor.close()
            except Exception:
                logger.exception("prediction outputs processor close failed")
        self._shutdown.set()
        if self._channel is not None:
            try:
                self._channel.close()
            except Exception:
                logger.debug("grpc channel close failed at exit",
                             exc_info=True)

    def run(self) -> int:
        from elasticdl_tpu_torch.observability.http import start_server

        role = f"cohort-{self.ctx.process_id}"
        tracing.configure_from_config(
            self.cfg, role=role, world_version=self.ctx.world_version)
        flight_lib.configure_from_config(self.cfg, role=role)
        flight_lib.install_crash_hooks()
        timeseries_lib.configure_from_config(self.cfg, role=role)
        metrics_server = start_server(role=role, port=self.cfg.metrics_port)
        try:
            with tracing.span(
                "cohort.world_form", num_processes=self.ctx.num_processes,
                process_id=self.ctx.process_id,
            ), goodput_lib.get_ledger().phase("rescale", sub="settle"):
                self.ctx.initialize()
        except Exception:
            logger.exception(
                "world formation failed (coordinator %s, process %d/%d)",
                self.ctx.coordinator_addr, self.ctx.process_id,
                self.ctx.num_processes,
            )
            flight_lib.get_recorder().dump("world_form_failed")
            if metrics_server is not None:
                metrics_server.stop()
            return ExitCode.WORLD_FORM_FAILED
        self._install_sigterm_drain()
        heartbeat = None
        try:
            with tracing.span("cohort.build"):
                self._mesh = mesh_lib.build_job_mesh(self.cfg)
                self._build_trainer()
            if self.ctx.is_leader:
                self._connect()
                # leader-only tier membership: the cohort is ONE logical
                # worker, so the leader owns its shard set
                self._init_embedding_tier()
                heartbeat = threading.Thread(
                    target=self._heartbeat_loop, daemon=True)
                heartbeat.start()
            backoff = max(0.5, self.cfg.worker_heartbeat_s / 4)
            while True:
                leader_ctrl = (self._lease_control() if self.ctx.is_leader
                               else [0] * CTRL_LEN)
                ctrl = [int(x) for x in self.ctx.broadcast_ints(leader_ctrl)]
                op = ctrl[0]
                if self._tier is not None:
                    # replica delta sync at the collective poll boundary
                    # (leader-only: the tier is the leader's)
                    try:
                        self._tier.sync_replicas()
                    except Exception:
                        logger.exception("embedding replica sync failed")
                if op == OP_NOOP:
                    with goodput_lib.get_ledger().phase("lease_wait"):
                        time.sleep(jittered(backoff) if self.ctx.is_leader
                                   else backoff)
                    continue
                if op == OP_TASK:
                    self._run_task(ctrl)
                    continue
                if op == OP_DONE:
                    self._export_final_model()
                break
            if self._tier is not None:
                # the tier's shards drain on every teardown path (the next
                # generation's leader restores them bit-exactly,
                # watermarks included)
                try:
                    self._tier.drain()
                except Exception:
                    logger.exception("embedding tier drain failed")
            mngr = self._checkpoint_manager()
            if (op == OP_ABORT and ctrl[6] & FLAG_CHECKPOINT
                    and mngr is not None and self._state is not None):
                # one final collective save, its write overlapped with the
                # teardown and durable before the world goes down
                step = mngr.save_overlapped(self._state, self._finish)
                self._last_ckpt_step = step
                logger.info(
                    "preemption checkpoint saved at step %d (write "
                    "overlapped with teardown)", step)
            else:
                self._finish()
            if mngr is not None:
                mngr.close()
            # ABORT: evicted without job completion; EX_TEMPFAIL makes the
            # manager relaunch the cohort
            return 0 if op == OP_DONE else ExitCode.COHORT_EVICTED
        finally:
            self._shutdown.set()
            self._close_embedding_tier()
            if heartbeat is not None:
                heartbeat.join(timeout=2 * self.cfg.worker_heartbeat_s)
            if metrics_server is not None:
                metrics_server.stop()
            tracing.get_tracer().close()
            self.ctx.shutdown()


def run_cohort(cfg: JobConfig, device: runtime.DeviceLike = None) -> int:
    """Build a CohortWorker and run it. Before the world forms SIGTERM is
    a plain EX_TEMPFAIL exit (nothing to drain yet); `run()` installs the
    leader's drain once it has."""
    worker = CohortWorker(cfg, device=device)
    try:
        signal.signal(
            signal.SIGTERM, lambda *_: sys.exit(ExitCode.COHORT_EVICTED))
    except ValueError:
        pass  # not the main thread (a cohort driven in-process)
    return worker.run()
