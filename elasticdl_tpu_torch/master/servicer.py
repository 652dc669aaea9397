"""Master gRPC servicer: the single control-plane endpoint workers talk to.

Reference parity: elasticdl/python/master/servicer.py (MasterServicer —
get_task / report_task_result / report_evaluation_metrics / report_version).
Membership RPCs replace what the reference delegated to k8s pod events plus
the Horovod rendezvous: RegisterWorker + Heartbeat carry the
membership_version that drives elastic mesh re-formation.
"""

from __future__ import annotations

import threading
from typing import Optional

import grpc
import numpy as np

from elasticdl_tpu_torch.common.log_utils import default_logger
from elasticdl_tpu_torch.master.evaluation_service import EvaluationService
from elasticdl_tpu_torch.master.membership import Membership
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.observability import health as health_lib
from elasticdl_tpu_torch.observability.registry import default_registry
from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb
from elasticdl_tpu_torch.proto.service import GENERATION_KEY, REREGISTER_KEY

logger = default_logger(__name__)

_reg = default_registry()
_STALE_GEN_REJECTS = _reg.counter(
    "edl_master_stale_generation_rejects_total",
    "RPCs fenced for claiming a pre-restart master generation",
    labels=("method",))
_REREGISTERS = _reg.counter(
    "edl_master_reregistrations_total",
    "idempotent worker re-registrations (reconnect handshakes)")


class MasterServicer:
    def __init__(
        self,
        dispatcher: TaskDispatcher,
        membership: Membership,
        evaluation_service: Optional[EvaluationService] = None,
        wait_backoff_s: float = 2.0,
        summary_service=None,
        generation: int = 0,
        embedding=None,
    ):
        self._dispatcher = dispatcher
        self._membership = membership
        self._evaluation = evaluation_service
        self._summary = summary_service
        self._wait_backoff_s = wait_backoff_s
        # embedding tier shard-map owner (embedding/sharding.ShardMapOwner;
        # None = tier off — the RPCs answer empty)
        self._embedding = embedding
        # Master generation (master/journal.py header; 0 = fencing off).
        # Workers claim the generation they registered under on every call;
        # a claim from before the last master restart is fenced below so a
        # pre-crash task report can never double-count against the replayed
        # queue state. Stamped onto trailing metadata by proto/service.py.
        self.generation = generation
        self._loss_lock = threading.Lock()
        self._loss_sum = 0.0                # guarded_by: _loss_lock
        self._loss_count = 0                # guarded_by: _loss_lock
        # control-plane flags: mutated by gRPC handler threads (Heartbeat)
        # AND master-side callers (request_checkpoint from the resize
        # quiesce) — the old lock-free set.add/discard raced (edl-lint
        # EDL101 find); worker ids that should checkpoint
        self._ctrl_lock = threading.Lock()
        self._checkpoint_requested = set()  # guarded_by: _ctrl_lock
        # worker ids evicted by the closed-loop autoscaler: STICKY (not
        # one-shot like the checkpoint bit) — a heartbeat response can be
        # dropped on the wire, and a lost one-shot eviction would leave
        # the straggler degrading the fleet forever. The worker's drain
        # is idempotent, so repeats are free; the set is pruned when the
        # worker leaves the membership.
        self._evict_requested = set()       # guarded_by: _ctrl_lock
        self._lr_override = 0.0             # 0 = no master-pushed LR
        self._shutdown = False

    # ------------------------------------------------------------------ #
    # generation fencing (the server half of the handshake)

    @staticmethod
    def _request_metadata(context) -> dict:
        """Invocation metadata as a dict; {} for contexts without it
        (direct in-process servicer calls in tests pass context=None)."""
        if context is None:
            return {}
        try:
            return {k: v for k, v in (context.invocation_metadata() or ())}
        except Exception:
            # metadata is the handshake channel, not the RPC payload; a
            # context that can't supply it is an unfenced caller:
            # edl-lint: disable=EDL303
            return {}

    def _fence_generation(self, method: str, context,
                          on_fence=None) -> None:
        """Abort with a retriable FAILED_PRECONDITION when the caller
        claims a master generation other than this master's. The claim is
        optional (no claim = unfenced legacy caller); the mismatch aborts
        BEFORE any state mutation, so nothing leased or reported under the
        dead master's generation ever reaches the replayed queues. Workers
        react by re-registering (a generation-free RegisterWorker with
        REREGISTER_KEY), not by dying — see proto/service.py
        is_stale_generation.

        `on_fence` runs just before the abort — the wasted-work ledger's
        hook (a fenced ReportTaskResult is finished work being
        discarded). Best-effort: a failing hook never unfences the
        call."""
        if not self.generation or context is None:
            return
        claimed = self._request_metadata(context).get(GENERATION_KEY)
        if claimed is None:
            return
        try:
            claimed = int(claimed)
        except (TypeError, ValueError):
            return
        if claimed != self.generation:
            _STALE_GEN_REJECTS.inc(method=method)
            logger.warning(
                "%s fenced: stale master generation %d (current %d)",
                method, claimed, self.generation,
            )
            if on_fence is not None:
                try:
                    on_fence()
                except Exception:
                    # accounting is advisory; the fence must still land:
                    # edl-lint: disable=EDL303
                    logger.exception("fence accounting hook failed")
            context.abort(
                grpc.StatusCode.FAILED_PRECONDITION,
                f"stale master generation {claimed} (current "
                f"{self.generation}); re-register to continue",
            )

    # ------------------------------------------------------------------ #
    # rpc handlers (name-matched by proto/service.py)

    def RegisterWorker(self, request, context):
        # a register CLAIMING a stale generation is fenced like any other
        # call — the reconnect handshake clears the claim first
        self._fence_generation("RegisterWorker", context)
        preferred = request.preferred_id_plus_one - 1
        data_addr = str(getattr(request, "data_plane_addr", "") or "")
        if (
            self._request_metadata(context).get(REREGISTER_KEY) == "1"
            and preferred >= 0
        ):
            # reconnect of an existing member (e.g. after a master
            # restart): idempotent — a live worker keeps its id and bumps
            # nothing, a reaped one is revived; never a duplicate join
            info = self._membership.reregister(
                preferred, request.worker_name, data_addr=data_addr)
            _REREGISTERS.inc()
        else:
            info = self._membership.register(
                request.worker_name, preferred, data_addr=data_addr)
        member_ids = []
        if request.member_names:
            # cohort-aggregated membership: the leader's member processes
            # join in the SAME round-trip (one lock pass, one journal
            # commit, no version bumps) — idempotent across re-registers
            members = self._membership.register_members(
                info.worker_id, list(request.member_names)
            )
            member_ids = [m.worker_id for m in members]
        return pb.RegisterWorkerResponse(
            worker_id=info.worker_id,
            membership_version=self._membership.version,
            num_workers=self._membership.alive_count(),
            member_ids=member_ids,
        )

    #: server-side ceiling on max_tasks: a misconfigured (or hostile)
    #: worker must not drain the whole queue into one lease batch — every
    #: leased task's timeout clock starts NOW, and a huge batch would
    #: expire its own tail
    MAX_LEASE_BATCH = 256

    def GetTask(self, request, context):
        self._fence_generation("GetTask", context)
        if self._dispatcher.finished():
            return pb.GetTaskResponse(job_done=True)
        # max_tasks == 0 is an old worker (proto3 default): classic
        # one-lease protocol. The response is released only after the
        # lease batch's journal commit fsyncs (ack-after-fsync inside
        # get_many) — nothing a worker ever runs can be lost by a crash.
        n = min(max(1, request.max_tasks), self.MAX_LEASE_BATCH)
        tasks = self._dispatcher.get_many(request.worker_id, n)
        if not tasks:
            return pb.GetTaskResponse(
                task=pb.Task(type=pb.WAIT),
                backoff_seconds=self._wait_backoff_s,
                job_done=self._dispatcher.finished(),
            )
        protos = [t.to_proto() for t in tasks]
        # `task` mirrors the first lease for old workers (which never set
        # max_tasks and never read `tasks`)
        return pb.GetTaskResponse(task=protos[0], tasks=protos)

    def ReportTaskResult(self, request, context):
        # a fenced report is COMPLETED work the fence discards (the
        # replayed lease re-runs it whole): bill the wasted-work ledger
        # before aborting — docs/observability.md "Goodput ledger"
        self._fence_generation(
            "ReportTaskResult", context,
            on_fence=lambda: self._dispatcher.note_fenced_report(
                request.task_id, request.records_processed,
            ),
        )
        accepted = self._dispatcher.report(
            request.task_id,
            request.worker_id,
            request.success,
            request.err_message,
            preempted=request.preempted,
            records_processed=request.records_processed,
        )
        if accepted and request.loss_count:
            # stale/duplicate reports must not skew the job's mean loss
            with self._loss_lock:
                self._loss_sum += request.loss_sum
                self._loss_count += request.loss_count
            if self._summary is not None:
                self._summary.on_task_report(
                    request.model_version, request.loss_sum, request.loss_count,
                    step_time_sum=request.step_time_sum,
                    step_count=request.step_count,
                )
        if accepted and request.success and self._evaluation is not None:
            # model_version is the worker's minibatch-step counter — the
            # reference's evaluation_steps unit (round-3 fix: this used to
            # count completed *tasks*, ~64x coarser at default task sizes)
            self._evaluation.maybe_trigger(request.model_version)
        return pb.ReportTaskResultResponse(accepted=accepted)

    def ReportEvaluationMetrics(self, request, context):
        self._fence_generation("ReportEvaluationMetrics", context)
        if self._evaluation is not None:
            states = {
                s.name: np.frombuffer(s.data, np.float32) for s in request.states
            }
            self._evaluation.report_metrics(
                request.eval_job_id, request.task_id, states
            )
        return pb.ReportEvaluationMetricsResponse()

    def Heartbeat(self, request, context):
        self._fence_generation("Heartbeat", context)
        # optional piggybacked worker telemetry (observability/health.py):
        # decode_stats never raises — an old worker (no payload), a newer
        # one (unknown schema), or garbage all degrade to liveness-only
        stats = health_lib.decode_stats(
            self._request_metadata(context).get(health_lib.STATS_METADATA_KEY)
        )
        # coalesced member beats (cohort leaders): decode_stats bounds
        # each payload the same way it bounds the metadata flavor — a
        # garbage member payload degrades THAT member to liveness-only
        members = [
            (m.worker_id, m.model_version,
             health_lib.decode_stats(m.stats_json))
            for m in request.members
        ]
        known = self._membership.heartbeat(
            request.worker_id, request.model_version, stats=stats,
            members=members or None,
        )
        with self._ctrl_lock:
            # one atomic test-and-clear: the flag is one-shot, and two
            # concurrent heartbeats from a relaunching worker must not both
            # consume (or both miss) the same request
            should_ckpt = request.worker_id in self._checkpoint_requested
            self._checkpoint_requested.discard(request.worker_id)
            evict = request.worker_id in self._evict_requested
        return pb.HeartbeatResponse(
            membership_version=self._membership.version,
            num_workers=self._membership.alive_count(),
            should_checkpoint=should_ckpt,
            shutdown=self._shutdown or not known,
            job_done=self._dispatcher.finished(),
            learning_rate=self._lr_override,
            evict=evict,
        )

    def set_learning_rate(self, lr: float) -> None:
        """Master-side LR override, delivered to every worker on its next
        heartbeat (job callbacks — ReduceLROnPlateau — call this)."""
        self._lr_override = float(lr)

    def GetEmbeddingShardMap(self, request, context):
        """The tier's control-plane read: the current (journal-durable)
        shard map. Bootstraps lazily on the first fetch once workers are
        alive — the map's owner set is the live logical-worker set."""
        self._fence_generation("GetEmbeddingShardMap", context)
        if self._embedding is None:
            return pb.GetEmbeddingShardMapResponse()
        view = self._embedding.view()
        if not view.owners:
            alive = [
                w.worker_id for w in self._membership.alive_workers()
                if w.led_by is None
            ]
            if not alive:
                # nobody to own shards yet: the caller backs off and
                # re-fetches (version 0 = no map)
                return pb.GetEmbeddingShardMapResponse()
            view = self._embedding.bootstrap(alive)
        resp = pb.GetEmbeddingShardMapResponse(
            version=view.version,
            num_shards=view.num_shards,
            shard_owners=list(view.owners),
            resharding=view.resharding,
        )
        # read replicas ride the same response as a flat -1-padded
        # stride of replica_count per shard (see the .proto note)
        rc = max((len(view.replicas_of(s))
                  for s in range(view.num_shards)), default=0)
        if rc:
            resp.replica_count = rc
            flat = []
            for s in range(view.num_shards):
                r = list(view.replicas_of(s))
                flat.extend(r + [-1] * (rc - len(r)))
            resp.shard_replicas.extend(flat)
        for t in view.tables:
            resp.tables.add(
                name=t.name, vocab=t.vocab, dim=t.dim, seed=t.seed,
                init_scale=t.init_scale,
            )
        # the layout controller's ultra-hot set (ISSUE 20) rides the
        # same response; workers pin these rows and keep them fresh
        # through the delta-sync lane
        if view.hot_ids:
            resp.hot_ids.extend(view.hot_ids)
        # owner address book (ISSUE 15): every alive worker's embedding
        # data-plane endpoint rides the map response — GrpcTransport
        # clients adopt it on every refresh, so a relaunched owner's new
        # address propagates on the same cadence as ownership itself
        for wid, addr in self._membership.data_addresses():
            resp.addr_worker_ids.append(wid)
            resp.addrs.append(addr)
        return resp

    def ReportEmbeddingReshard(self, request, context):
        """A recipient confirms installed shard migrations; the plan
        commits (one journal record, acked after fsync inside
        confirm_moves) when every planned move is confirmed."""
        self._fence_generation("ReportEmbeddingReshard", context)
        if self._embedding is None:
            return pb.ReportEmbeddingReshardResponse(accepted=False)
        accepted = self._embedding.confirm_moves(
            request.version, list(request.shard_ids)
        )
        return pb.ReportEmbeddingReshardResponse(accepted=accepted)

    def GetJobStatus(self, request, context):
        counts = self._dispatcher.counts()
        resp = pb.JobStatusResponse(
            job_done=self._dispatcher.finished(),
            finished_training_tasks=counts["finished_training"],
            pending_tasks=counts["todo"],
            doing_tasks=counts["doing"],
            epoch=counts["epoch"],
            membership_version=self._membership.version,
        )
        if self._evaluation is not None:
            for k, v in self._evaluation.latest_results().items():
                resp.eval_metrics[k] = v
        return resp

    # ------------------------------------------------------------------ #

    def request_checkpoint(self, worker_id: int) -> None:
        with self._ctrl_lock:
            self._checkpoint_requested.add(worker_id)

    def request_evict(self, worker_id: int) -> None:
        """The wire half of the graceful-eviction drain handshake
        (master/autoscaler.py): the worker's next heartbeat response
        carries evict=True and it drains through its preempt path —
        checkpoint + preempted report, so in-flight records retire
        instead of re-training — then exits EX_TEMPFAIL."""
        with self._ctrl_lock:
            self._evict_requested.add(worker_id)
        logger.warning(
            "eviction requested for worker %d (drain handshake armed)",
            worker_id,
        )

    def evict_pending(self, worker_id: int) -> bool:
        with self._ctrl_lock:
            return worker_id in self._evict_requested

    def clear_evict(self, worker_id: int) -> None:
        """Prune a completed eviction (the worker left the membership)."""
        with self._ctrl_lock:
            self._evict_requested.discard(worker_id)

    def request_shutdown(self) -> None:
        self._shutdown = True

    def mean_training_loss(self) -> Optional[float]:
        with self._loss_lock:
            if not self._loss_count:
                return None
            return self._loss_sum / self._loss_count
