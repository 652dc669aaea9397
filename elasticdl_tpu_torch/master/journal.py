"""Durable control-plane journal: the master's crash-recovery WAL.

The master is the last single point of failure in the stack — the
dispatcher's todo/doing queues, the membership registry, and the process
manager's world version live only in memory, so a master crash used to
lose exactly-once task accounting and strand every worker even though
their model state and compile caches survived. This module makes the
control plane durable the same way the data plane already is (orbax
checkpoints): an append-only, fsync-on-commit journal of state
*transitions*, replayed on the next master boot.

Layout (under ``<checkpoint_dir>/control/``):

    journal.jsonl       one JSON record per line:
        line 1          {"t": "header", "v": 1, "generation": G}
        line 2 (opt)    {"t": "snapshot", ...}   compacted prior state
        line 3..        incremental transition records

Records (appended by TaskDispatcher / Membership / ProcessManager inside
their own ``_lock`` critical sections, so the journal order IS the
mutation order):

    task_create / task_lease / task_finish / task_requeue / task_drop /
    task_fail / epoch_advance / epoch_end / training_done / job_end /
    stop_training                      — dispatcher task lifecycle
    member_join / member_death         — membership transitions
    world_version                      — cohort world-version bumps
    autoscale                          — every closed-loop rescale decision
                                         (master/autoscaler.py), APPLIED and
                                         SUPPRESSED alike; applied actions
                                         replay into AutoscaleState so a
                                         restarted master inherits cooldown
                                         and budget instead of re-firing
    emb_table / emb_shard_map /
    emb_reshard_begin / emb_reshard_commit
                                       — embedding tier shard-map
                                         transitions (embedding/sharding.py;
                                         a begin without its commit rolls
                                         back at replay — see
                                         EmbeddingState.reshard_interrupted)
    emb_replica_map / emb_hot_ids      — single-phase layout transitions
                                         (per-shard replica fan-out and the
                                         ultra-hot id set; pull-only effects,
                                         so no begin/commit fence)
    layout                             — every layout-controller decision
                                         (master/layout_controller.py),
                                         APPLIED and SUPPRESSED alike;
                                         applied actions replay into
                                         LayoutState so a restarted master
                                         inherits cooldowns and never
                                         double-fires a layout change

Durability contract: a transition the master *acted on* (a lease granted,
a report accepted) is on disk before the effect is observable — a crash
can lose at most a transition that no one was told about yet. HOW that is
achieved depends on the commit mode:

- **per-commit** (``group_commit_ms == 0``, the PR 5 behavior): ``append``
  writes + flushes + fsyncs before returning, inside the journal lock.
- **group-commit** (``group_commit_ms > 0``): mutators only ENQUEUE their
  records onto an ordered in-memory commit queue (still inside their own
  owning lock, so queue order — and therefore disk order — IS mutation
  order), and a committer thread flushes the whole queue under ONE
  write + fsync within the bounded window. ``append``/``append_many``
  return a :class:`Commit` handle; the caller releases its owning lock
  and then ``wait()``s on the handle *before* acknowledging anything to a
  worker (ack-after-fsync). Nothing acknowledged can be lost; what a
  crash CAN lose is a queued-but-unflushed suffix no one was told about —
  exactly per-commit mode's lost-response window, so crash-replay
  accounting is identical across both modes. A whole flushed group rides
  ONE ``batch`` journal line: a torn group write drops the group whole at
  replay, never a parseable prefix of a multi-record commit.

Recovery contract: opening an existing journal replays it to the final
state, **bumps the master generation**, and atomically rotates the file
(tmp + ``os.replace``) to a fresh header + compacted snapshot. In-flight
leases are conservatively requeued at the FRONT of todo (the crashed
master cannot know whether the worker finished; the report, if it ever
arrives, carries a pre-crash generation and is fenced — proto/service.py).
A torn tail line (crash mid-append) is dropped, not fatal.

What is and isn't replayed: task accounting, membership, epoch/job flags,
and the world version are; evaluation-service aggregation state, mean-loss
accumulators and summary streams are NOT (they are derived/advisory —
an eval job interrupted by a master crash re-reports or re-runs).
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from elasticdl_tpu_torch.common.log_utils import default_logger
from elasticdl_tpu_torch.observability.registry import default_registry

logger = default_logger(__name__)

JOURNAL_VERSION = 1
JOURNAL_DIRNAME = "control"
JOURNAL_FILENAME = "journal.jsonl"

_reg = default_registry()
_APPENDS = _reg.counter(
    "edl_journal_appends_total", "control-plane journal records committed")
_REPLAYED = _reg.counter(
    "edl_journal_replayed_records_total",
    "journal records replayed at master boot")
_ROTATIONS = _reg.counter(
    "edl_journal_rotations_total",
    "atomic journal rotations (every recovery compacts)")
_DROPPED = _reg.counter(
    "edl_journal_dropped_lines_total",
    "unparseable journal lines skipped during replay (torn tail)")
_RECOVERIES = _reg.counter(
    "edl_master_recoveries_total", "master boots that replayed a journal")
_GENERATION = _reg.gauge(
    "edl_master_generation", "current master generation")
_GROUP_FLUSHES = _reg.counter(
    "edl_journal_group_commit_flushes_total",
    "group-commit flushes (one write+fsync each)")
_GROUP_RECORDS = _reg.counter(
    "edl_journal_group_commit_records_total",
    "records committed through the group-commit queue")
_GROUP_BATCH = _reg.histogram(
    "edl_journal_group_commit_batch_records",
    "records per group-commit flush")
_COMMIT_LATENCY = _reg.histogram(
    "edl_journal_commit_latency_seconds",
    "enqueue-to-durable latency per commit (both modes)")
_QUEUE_DEPTH = _reg.gauge(
    "edl_journal_commit_queue_depth",
    "records sitting in the open group-commit batch (saturation signal: "
    "a depth that grows across windows means offered commit rate exceeds "
    "flush throughput)")
_BACKPRESSURE = _reg.counter(
    "edl_journal_backpressure_warnings_total",
    "group-commit windows whose queue depth crossed the backpressure "
    "warning threshold")


@dataclass
class DispatcherState:
    """Replayed dispatcher state (what TaskDispatcher restores from)."""

    todo: List[Dict[str, Any]] = field(default_factory=list)
    next_task_id: int = 1
    epoch: int = -1
    num_epochs: Optional[int] = None
    finished_training: int = 0
    failed_permanently: int = 0
    completed_versions: int = 0
    epoch_end_fired: bool = False
    job_end_fired: bool = False
    stop_training: bool = False
    training_done: bool = False
    save_model_created: bool = False
    requeued_leases: int = 0
    # goodput accounting (observability/goodput.py): completed training
    # records (task_finish carries `records` since ISSUE 12; absent in
    # older journals -> 0) and the wasted-work ledger totals replayed
    # from `wasted_work` records — the bill survives a master restart.
    records_completed: int = 0
    wasted_records: int = 0
    wasted_events: int = 0
    wasted_by_reason: Dict[str, Dict[str, int]] = field(default_factory=dict)
    # the CURRENT replay's conservatively-requeued in-flight leases
    # ({task_id, records} per TRAINING lease): the successor journals
    # these as `crash_requeue` wasted-work entries at restore. Always
    # overwritten by the replay's end block (a snapshot-carried list from
    # a prior generation must not re-journal).
    requeued: List[Dict[str, Any]] = field(default_factory=list)


@dataclass
class MembershipState:
    """Replayed membership registry (liveness clocks restart at takeover)."""

    workers: List[Dict[str, Any]] = field(default_factory=list)
    next_id: int = 0
    version: int = 0


@dataclass
class EmbeddingState:
    """Replayed embedding-tier shard map (ShardMapOwner restores from
    this — embedding/sharding.py). The invariant the replay enforces:
    `owners`/`version` are always the last COMMITTED map. A master
    killed between `emb_reshard_begin` and `emb_reshard_commit` replays
    with the pre-move assignment and `reshard_interrupted=True` — the
    successor re-plans against live membership, and clients
    conservatively requeue in-flight pushes (the stores' per-client
    sequence watermarks dedupe any that actually landed, so exactly-once
    holds across the rollback)."""

    version: int = 0
    num_shards: int = 0
    owners: List[int] = field(default_factory=list)
    # shard id -> read-replica worker ids (ISSUE 13): committed beside
    # the primaries in the same records, replayed with the same
    # begin-without-commit rollback semantics
    replicas: List[List[int]] = field(default_factory=list)
    # per-shard replica TARGETS set by the layout controller (empty =
    # uniform config default) — distinct from `replicas`, which is the
    # current assignment; targets persist across later reshardings
    replica_counts: List[int] = field(default_factory=list)
    # the worker-replicated ultra-hot id set (ISSUE 20)
    hot_ids: List[int] = field(default_factory=list)
    tables: List[Dict[str, Any]] = field(default_factory=list)
    reshard_interrupted: bool = False


@dataclass
class AutoscaleState:
    """Replayed closed-loop autoscaler state (master/autoscaler.py
    restores from this). The invariant: `last_action_ts` (wall clock —
    the only clock that survives a process restart) and
    `actions_applied` reflect every APPLIED action ever journaled, so a
    successor master inherits the cooldown window and the spent action
    budget instead of immediately re-firing on the same signal its
    predecessor just acted on. Suppressed decisions replay into
    `records` only — they are forensic, not state."""

    actions_applied: int = 0
    last_action_ts: float = 0.0
    by_kind: Dict[str, int] = field(default_factory=dict)
    records: int = 0


@dataclass
class LayoutState:
    """Replayed layout-controller state (master/layout_controller.py
    restores from this) — same invariant as AutoscaleState, but with
    per-KIND cooldown clocks: a replica fan-out five minutes ago must
    not cool down a pending split, and vice versa. `last_action_ts` is
    the overall max (budget accounting); `last_ts_by_kind` is what the
    cooldown gate actually reads."""

    actions_applied: int = 0
    last_action_ts: float = 0.0
    by_kind: Dict[str, int] = field(default_factory=dict)
    last_ts_by_kind: Dict[str, float] = field(default_factory=dict)
    records: int = 0


@dataclass
class ReplayResult:
    prior_generation: int = 0
    records: int = 0
    dropped_lines: int = 0
    dispatcher: Optional[DispatcherState] = None
    membership: Optional[MembershipState] = None
    world_version: int = 0
    embedding: Optional[EmbeddingState] = None
    autoscale: Optional[AutoscaleState] = None
    layout: Optional[LayoutState] = None


def _replay_dispatcher(
    state: DispatcherState, doing: Dict[int, Dict[str, Any]],
    rtype: str, rec: Dict[str, Any],
) -> None:
    """Apply one dispatcher transition record to the replay state."""

    def take_todo(task_id: int) -> Optional[Dict[str, Any]]:
        for i, t in enumerate(state.todo):
            if t["task_id"] == task_id:
                return state.todo.pop(i)
        return None

    if rtype == "task_create":
        task = dict(rec["task"])
        if rec.get("front"):
            state.todo.insert(0, task)
        else:
            state.todo.append(task)
        state.next_task_id = max(state.next_task_id, task["task_id"] + 1)
        if task.get("type") == _SAVE_MODEL_TYPE:
            state.save_model_created = True
    elif rtype == "task_lease":
        task = take_todo(rec["task_id"])
        if task is not None:
            doing[rec["task_id"]] = task
    elif rtype == "task_finish":
        doing.pop(rec["task_id"], None) or take_todo(rec["task_id"])
        if rec.get("training"):
            state.finished_training += 1
            state.completed_versions += 1
            state.records_completed += int(rec.get("records", 0) or 0)
    elif rtype == "wasted_work":
        records = int(rec.get("records", 0) or 0)
        state.wasted_events += 1
        state.wasted_records += records
        ent = state.wasted_by_reason.setdefault(
            str(rec.get("reason", "?")), {"events": 0, "records": 0})
        ent["events"] += 1
        ent["records"] += records
    elif rtype == "task_requeue":
        task = doing.pop(rec["task_id"], None) or take_todo(rec["task_id"])
        if task is not None:
            task["start"] = rec.get("start", task["start"])
            task["retries"] = rec.get("retries", task.get("retries", 0))
            state.todo.insert(0, task)
        # a drain requeue retires its `completed` prefix (covered by the
        # worker's drain checkpoint) — replay parity for the live
        # records_completed counter
        state.records_completed += int(rec.get("completed", 0) or 0)
    elif rtype == "task_drop":
        doing.pop(rec["task_id"], None) or take_todo(rec["task_id"])
        state.records_completed += int(rec.get("completed", 0) or 0)
    elif rtype == "task_fail":
        doing.pop(rec["task_id"], None) or take_todo(rec["task_id"])
        state.failed_permanently += 1
    elif rtype == "epoch_advance":
        state.epoch = rec["epoch"]
        state.epoch_end_fired = False
    elif rtype == "epoch_end":
        if rec.get("epoch", state.epoch) == state.epoch:
            state.epoch_end_fired = True
    elif rtype == "training_done":
        state.training_done = True
    elif rtype == "job_end":
        state.job_end_fired = True
    elif rtype == "stop_training":
        state.stop_training = True
        state.num_epochs = rec.get("num_epochs", state.num_epochs)
        state.todo = [t for t in state.todo if t.get("type") != _TRAINING_TYPE]


# pb.TRAINING / pb.EVALUATION / pb.SAVE_MODEL without importing protobuf
# here (the journal must stay importable in protobuf-free tooling
# contexts); a test pins these to the generated enum values.
_TRAINING_TYPE = 0
_EVALUATION_TYPE = 1
_SAVE_MODEL_TYPE = 3

_DISPATCHER_RECORDS = frozenset({
    "task_create", "task_lease", "task_finish", "task_requeue", "task_drop",
    "task_fail", "epoch_advance", "epoch_end", "training_done", "job_end",
    "stop_training", "wasted_work",
})


def replay_lines(lines: List[str]) -> ReplayResult:
    """Replay journal lines to a final state (tolerant of a torn tail)."""
    result = ReplayResult()
    dispatcher: Optional[DispatcherState] = None
    membership: Optional[MembershipState] = None
    embedding: Optional[EmbeddingState] = None
    autoscale: Optional[AutoscaleState] = None
    layout: Optional[LayoutState] = None
    # an emb_reshard_begin whose commit has not replayed yet:
    # {"version": v, "owners": [...]} — promoted to the committed map by
    # emb_reshard_commit, rolled back (reshard_interrupted) at the end
    pending_reshard: Optional[Dict[str, Any]] = None
    doing: Dict[int, Dict[str, Any]] = {}
    lease_order: List[int] = []

    def emb() -> EmbeddingState:
        nonlocal embedding
        if embedding is None:
            embedding = EmbeddingState()
        return embedding

    def apply(rec: Dict[str, Any]) -> None:
        nonlocal dispatcher, membership, embedding, pending_reshard
        nonlocal autoscale, layout
        rtype = rec["t"]
        result.records += 1
        if rtype == "header":
            result.prior_generation = int(rec.get("generation", 0))
        elif rtype == "snapshot":
            if rec.get("dispatcher") is not None:
                dispatcher = DispatcherState(**rec["dispatcher"])
            if rec.get("membership") is not None:
                membership = MembershipState(**rec["membership"])
            if rec.get("embedding") is not None:
                embedding = EmbeddingState(**rec["embedding"])
            if rec.get("autoscale") is not None:
                autoscale = AutoscaleState(**rec["autoscale"])
            if rec.get("layout") is not None:
                layout = LayoutState(**rec["layout"])
            result.world_version = int(rec.get("world_version", 0))
        elif rtype in _DISPATCHER_RECORDS:
            if dispatcher is None:
                dispatcher = DispatcherState()
            if rtype == "task_lease":
                lease_order.append(rec.get("task_id"))
            _replay_dispatcher(dispatcher, doing, rtype, rec)
        elif rtype == "member_join":
            if membership is None:
                membership = MembershipState()
            wid = int(rec["worker_id"])
            for w in membership.workers:
                if w["worker_id"] == wid:
                    membership.workers.remove(w)
                    break
            membership.workers.append(
                {"worker_id": wid, "name": rec.get("name", ""), "alive": True,
                 "led_by": rec.get("led_by"),
                 # embedding data-plane endpoint (ISSUE 15): replays so a
                 # successor master serves the same owner address book
                 "data_addr": rec.get("data_addr") or ""}
            )
            membership.next_id = max(membership.next_id, wid + 1)
            membership.version = max(membership.version, int(rec.get("version", 0)))
        elif rtype == "member_death":
            if membership is None:
                membership = MembershipState()
            for w in membership.workers:
                if w["worker_id"] == int(rec["worker_id"]):
                    w["alive"] = False
            membership.version = max(membership.version, int(rec.get("version", 0)))
        elif rtype == "world_version":
            result.world_version = max(result.world_version, int(rec["version"]))
        elif rtype == "autoscale":
            if autoscale is None:
                autoscale = AutoscaleState()
            autoscale.records += 1
            if rec.get("decision") == "applied":
                autoscale.actions_applied += 1
                autoscale.last_action_ts = max(
                    autoscale.last_action_ts, float(rec.get("ts") or 0.0)
                )
                kind = str(rec.get("kind", "?"))
                autoscale.by_kind[kind] = autoscale.by_kind.get(kind, 0) + 1
        elif rtype == "layout":
            if layout is None:
                layout = LayoutState()
            layout.records += 1
            if rec.get("decision") == "applied":
                layout.actions_applied += 1
                ts = float(rec.get("ts") or 0.0)
                layout.last_action_ts = max(layout.last_action_ts, ts)
                kind = str(rec.get("kind", "?"))
                layout.by_kind[kind] = layout.by_kind.get(kind, 0) + 1
                layout.last_ts_by_kind[kind] = max(
                    layout.last_ts_by_kind.get(kind, 0.0), ts)
        elif rtype == "emb_table":
            e = emb()
            if not any(t["name"] == rec["name"] for t in e.tables):
                e.tables.append({
                    k: rec[k] for k in
                    ("name", "vocab", "dim", "seed", "init_scale")
                    if k in rec
                })
        elif rtype == "emb_shard_map":
            e = emb()
            e.version = int(rec["version"])
            e.num_shards = int(rec["num_shards"])
            e.owners = [int(o) for o in rec["owners"]]
            e.replicas = [[int(o) for o in r]
                          for r in rec.get("replicas", [])]
            e.reshard_interrupted = False
            pending_reshard = None
        elif rtype == "emb_replica_map":
            e = emb()
            e.version = int(rec["version"])
            e.replicas = [[int(o) for o in r]
                          for r in rec.get("replicas", [])]
            e.replica_counts = [int(c)
                                for c in rec.get("replica_counts", [])]
        elif rtype == "emb_hot_ids":
            e = emb()
            e.version = int(rec["version"])
            e.hot_ids = [int(i) for i in rec.get("hot_ids", [])]
        elif rtype == "emb_reshard_begin":
            pending_reshard = {
                "version": int(rec["version"]),
                # splits/merges ride the same begin→commit fence and
                # change the shard COUNT; a plain reshard journals the
                # unchanged count (older journals omit the field)
                "num_shards": int(rec.get("num_shards", 0)),
                "owners": [int(o) for o in rec["owners"]],
                "replicas": [[int(o) for o in r]
                             for r in rec.get("replicas", [])],
            }
        elif rtype == "emb_reshard_commit":
            e = emb()
            if (pending_reshard is not None
                    and pending_reshard["version"] == int(rec["version"])):
                e.version = pending_reshard["version"]
                if pending_reshard["num_shards"]:
                    if pending_reshard["num_shards"] != e.num_shards:
                        # a committed split/merge drops replica targets
                        # and the hot set's SHARD routing is unaffected
                        # (hot ids are global); targets re-derive from
                        # the controller's next pass
                        e.replica_counts = []
                    e.num_shards = pending_reshard["num_shards"]
                e.owners = pending_reshard["owners"]
                e.replicas = pending_reshard["replicas"]
                e.reshard_interrupted = False
                pending_reshard = None
            else:
                logger.warning(
                    "emb_reshard_commit v%s without a matching begin; "
                    "ignored", rec.get("version"),
                )
        else:
            logger.warning("unknown journal record type %r ignored", rtype)

    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
            if rec.get("t") == "batch":
                # a multi-record commit rides ONE line (append_many): it is
                # applied whole here or dropped whole below — validate
                # before applying so a corrupt batch can't half-apply
                subrecs = rec["records"]
                if not isinstance(subrecs, list) or not all(
                    isinstance(s, dict) and "t" in s for s in subrecs
                ):
                    raise ValueError("malformed batch record")
            else:
                rec["t"]                   # KeyError -> dropped below
                subrecs = [rec]
        except (ValueError, KeyError, TypeError):
            # torn tail (crash mid-append) is expected; a garbled line in
            # the middle is not, but dropping it beats refusing to recover
            result.dropped_lines += 1
            _DROPPED.inc()
            if i < len(lines) - 1:
                logger.warning(
                    "journal line %d unparseable (not the tail); skipped", i + 1
                )
            continue
        for sub in subrecs:
            apply(sub)
    if dispatcher is not None:
        # conservative lease recovery: the crashed master cannot know
        # whether leased work finished — requeue every in-flight lease at
        # the FRONT (oldest first), exactly once; pre-crash reports are
        # generation-fenced so nothing is double-counted. dict.fromkeys
        # dedupes a task that was leased, requeued, and re-leased before
        # the crash (lease_order carries it twice but it must come back
        # exactly once, or its records train twice after recovery).
        requeued = [doing[t] for t in dict.fromkeys(lease_order) if t in doing]
        if dispatcher.stop_training:
            # the live dispatcher drops in-flight TRAINING work after an
            # early stop (its requeue path journals task_drop); replay must
            # not resurrect a training lease the stop already condemned
            requeued = [t for t in requeued if t.get("type") != _TRAINING_TYPE]
        # EVALUATION tasks do NOT survive a crash: EvaluationService state
        # (job ids, metric aggregation) is volatile by contract, so a
        # replayed eval task would report into a dead eval job id — or
        # worse, into a post-recovery job that REUSED the id, corrupting
        # its metrics. The successor re-triggers evaluation fresh instead
        # (the dispatcher restore re-fires the epoch-end callbacks).
        requeued = [t for t in requeued if t.get("type") != _EVALUATION_TYPE]
        dispatcher.todo = [
            t for t in dispatcher.todo if t.get("type") != _EVALUATION_TYPE
        ]
        dispatcher.todo = requeued + dispatcher.todo
        dispatcher.requeued_leases = len(requeued)
        # the wasted-work view of the conservative requeue: every
        # requeued TRAINING lease's span re-trains whole. The successor
        # dispatcher journals these as `crash_requeue` entries at restore
        # (this list is replay-LOCAL — always overwritten here, so a
        # snapshot-carried copy from a prior generation never
        # re-journals).
        dispatcher.requeued = [
            {"task_id": t.get("task_id", -1),
             "records": max(0, int(t.get("end", 0)) - int(t.get("start", 0)))}
            for t in requeued if t.get("type") == _TRAINING_TYPE
        ]
    if pending_reshard is not None:
        # master died mid-resharding: the moves may be partially executed
        # but were never committed — roll back to the committed map (the
        # donors still hold every uncommitted shard by protocol) and flag
        # the interruption so the successor re-plans and clients requeue
        # in-flight pushes (store seq fencing dedupes re-sends)
        e = emb()
        e.reshard_interrupted = True
        logger.warning(
            "journal replay: resharding v%d was begun but never committed; "
            "rolled back to shard map v%d", pending_reshard["version"],
            e.version,
        )
    result.dispatcher = dispatcher
    result.membership = membership
    result.embedding = embedding
    result.autoscale = autoscale
    result.layout = layout
    return result


def _render(recs: List[Dict[str, Any]]) -> str:
    """Serialize one commit (or one group flush) as ONE journal line —
    multi-record payloads ride a ``batch`` wrapper so a torn write drops
    them whole at replay, never as a parseable prefix."""
    if len(recs) == 1:
        return json.dumps(recs[0]) + "\n"
    return json.dumps({"t": "batch", "records": recs}) + "\n"


class JournalCommitError(RuntimeError):
    """A group commit could not be made durable (flush failed or timed
    out). Callers must NOT acknowledge the transition they enqueued."""


# shared pre-completed event for per-commit / no-journal commits — wait()
# on these returns immediately
_DONE_EVENT = threading.Event()
_DONE_EVENT.set()


class Commit:
    """Durability handle for one journal commit.

    ``wait()`` blocks until the commit's records are flushed + fsynced
    (a no-op in per-commit mode, where ``append`` already did the fsync).
    The ack-after-fsync contract: release your owning lock, ``wait()``,
    THEN send the RPC response that acknowledges the transition."""

    __slots__ = ("_event", "_batch")

    def __init__(self, event: threading.Event = _DONE_EVENT, batch=None):
        self._event = event
        self._batch = batch

    def wait(self, timeout_s: float = 30.0) -> None:
        if not self._event.wait(timeout_s):
            raise JournalCommitError(
                f"journal group commit not durable after {timeout_s:.0f}s "
                "(committer wedged or disk stalled)"
            )
        err = getattr(self._batch, "error", None)
        if err is not None:
            raise JournalCommitError(f"journal group commit failed: {err!r}")


class CommitGate:
    """Mixin: the ack-after-fsync plumbing shared by journal-owning
    control-plane components (TaskDispatcher, Membership).

    The owning class declares ``self._journal`` (or None) and
    ``self._pending_commit = None  # guarded_by: _lock`` in its own
    ``__init__``. The protocol: mutators call :meth:`_j` (or assign
    ``self._pending_commit`` from ``append_many`` directly) INSIDE their
    ``_lock`` critical section, take the parked commit with
    :meth:`_take_commit_locked` in the SAME lock hold, and
    :meth:`_await` it after release — before sending any RPC response
    that acknowledges the journaled transition. In per-commit mode the
    wait is a no-op (append already fsynced)."""

    _journal = None
    _pending_commit = None

    def _j(self, rtype: str, **fields: Any) -> None:  # holds: _lock
        """Enqueue one journal record (no-op without a journal); the
        Commit parks on ``_pending_commit`` for the take-and-await."""
        if self._journal is not None:
            self._pending_commit = self._journal.append(rtype, **fields)

    def _take_commit_locked(self):  # holds: _lock
        """The last commit this critical section enqueued (None if none).
        Flush order is enqueue order, so waiting on the LAST commit also
        covers every earlier record of the same critical section (a lost
        earlier window poisons the journal, failing later waits too)."""
        commit, self._pending_commit = self._pending_commit, None
        return commit

    @staticmethod
    def _await(commit: Optional[Commit]) -> None:
        """Ack-after-fsync barrier: block (outside the lock) until the
        critical section's journal records are durable. A commit that
        cannot be made durable raises — the caller's RPC fails instead of
        acknowledging a transition the disk never saw."""
        if commit is not None:
            commit.wait()


class _OpenBatch:
    """The commit queue between two flushes: records land here in mutation
    order (enqueued under the mutator's owning lock), the committer swaps
    the whole batch out and flushes it under one fsync."""

    __slots__ = ("records", "enqueued_at", "opened_at", "event", "error")

    def __init__(self):
        self.records: List[Dict[str, Any]] = []
        self.enqueued_at: List[float] = []   # perf_counter per commit
        self.opened_at = 0.0                 # monotonic, first enqueue
        self.event = threading.Event()
        self.error: Optional[BaseException] = None


class ControlPlaneJournal:
    """Append-only WAL with atomic rotation and a persisted generation.

    Thread-safe; appends are called from inside the dispatcher's and
    membership's ``_lock`` critical sections (lock order: owner lock ->
    journal ``_lock``/``_qcv``; the journal never calls back out, so no
    cycle). With ``group_commit_ms > 0`` appends only enqueue (no I/O
    under the owning lock) and a committer thread owns the write+fsync —
    callers wait on the returned :class:`Commit` AFTER releasing their
    lock, before acknowledging the transition.
    """

    def __init__(self, checkpoint_dir: str, fsync: bool = True,
                 group_commit_ms: float = 0.0):
        self.dir = os.path.join(checkpoint_dir, JOURNAL_DIRNAME)
        self.path = os.path.join(self.dir, JOURNAL_FILENAME)
        self._fsync = fsync
        self._window_s = max(0.0, group_commit_ms) / 1000.0
        if self._window_s > 10.0:
            # config.validate rejects this at submit time; direct
            # constructions (tests, bench) get the clamp so a window can
            # never approach Commit.wait's 30s wedge deadline
            logger.warning(
                "journal group-commit window clamped %.0fms -> 10000ms",
                self._window_s * 1000,
            )
            self._window_s = 10.0
        self._lock = threading.Lock()
        self._fh = None                      # guarded_by: _lock
        # group-commit queue state: _qcv (a Condition) guards the open
        # batch; NEVER held during I/O, so enqueuers — who hold their own
        # control-plane lock — never block behind an fsync
        self._qcv = threading.Condition(threading.Lock())
        self._queue = _OpenBatch()           # guarded_by: _qcv
        self._closing = False                # guarded_by: _qcv
        # flush(): ask the committer to cut its window NOW (the file
        # handle stays single-writer; a foreign-thread write could land a
        # NEWER batch before an older already-swapped one, inverting the
        # disk-order == mutation-order replay invariant)
        self._flush_now = False              # guarded_by: _qcv
        # First flush failure poisons the journal: a failed write can
        # leave a PARTIAL line, and appending past it would fuse the next
        # flush into one unparseable line — silently dropping acknowledged
        # records at replay. Worse, a later window's successful fsync
        # would let its waiters ack while an EARLIER window's records are
        # not on disk (flush order == ack-validity order only while every
        # flush succeeds). Once poisoned, every queued and future commit
        # fails its wait() — no ack ever leaves for an undurable record.
        self._poisoned: Optional[BaseException] = None   # guarded_by: _qcv
        # saturation observability: deepest open batch seen (records), and
        # a once-per-window backpressure-warning edge trigger
        self._queue_high_water = 0           # guarded_by: _qcv
        self._bp_warned = False              # guarded_by: _qcv
        self._committer: Optional[threading.Thread] = None
        self.generation = 1
        self.recovered = False
        self.replay: Optional[ReplayResult] = None
        self._open()
        if self._window_s > 0:
            self._committer = threading.Thread(
                target=self._committer_loop,
                name="journal-committer",
                daemon=True,
            )
            self._committer.start()

    #: open-batch depth past which the journal logs a backpressure
    #: warning (once per window): the queue is unbounded by design — the
    #: committer always drains it — but a window this deep means the
    #: offered commit rate is outrunning flush throughput and commit
    #: latency is about to climb toward Commit.wait's deadline
    COMMIT_QUEUE_WARN_DEPTH = 4096

    @property
    def group_commit(self) -> bool:
        return self._window_s > 0

    @property
    def commit_queue_high_water(self) -> int:
        """Deepest open group-commit batch observed (records) — the soak
        harness's journal-saturation cliff metric."""
        with self._qcv:
            return self._queue_high_water

    # -------------------------------------------------------------- #
    # open / rotate / replay

    def _open(self) -> None:  # holds: _lock (construction)
        os.makedirs(self.dir, exist_ok=True)
        if os.path.exists(self.path):
            # boot-time replay read: single-threaded (no mutator exists
            # yet), the lock is held only for construction-ordering
            # reasons: edl-lint: disable=EDL103
            with open(self.path, encoding="utf-8") as f:
                lines = f.readlines()
            self.replay = replay_lines(lines)
            _REPLAYED.inc(self.replay.records)
            self.generation = self.replay.prior_generation + 1
            self.recovered = True
            _RECOVERIES.inc()
            logger.warning(
                "control journal replayed: %d records (%d dropped), prior "
                "generation %d -> %d, %d in-flight lease(s) requeued",
                self.replay.records, self.replay.dropped_lines,
                self.replay.prior_generation, self.generation,
                (self.replay.dispatcher.requeued_leases
                 if self.replay.dispatcher else 0),
            )
        self._rotate_locked()
        # boot-time append-handle open, same single-threaded window:
        # edl-lint: disable=EDL103
        self._fh = open(self.path, "a", encoding="utf-8")
        _GENERATION.set(self.generation)

    def _fsync_dir(self) -> None:
        """Make the directory entry durable: file-level fsync alone does
        not persist a newly created or os.replace'd NAME on POSIX — a host
        crash could drop the whole journal despite every append having
        been fsynced, and the successor would rebuild from scratch."""
        try:
            fd = os.open(self.dir, os.O_RDONLY)
        except OSError:
            return
        try:
            # directory-entry durability is part of the journal's leaf I/O
            # contract — only journal.file is ever held here:
            # edl-lint: disable=EDL103
            os.fsync(fd)
        except OSError:
            pass
        finally:
            os.close(fd)

    def _rotate_locked(self) -> None:
        """Atomically (re)write the journal as header + compacted snapshot.
        Runs before the append handle opens (single-threaded boot)."""
        tmp = self.path + ".tmp"
        # boot-time rotation write — see the fsync note below:
        # edl-lint: disable=EDL103
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(json.dumps(
                {"t": "header", "v": JOURNAL_VERSION,
                 "generation": self.generation}
            ) + "\n")
            if self.replay is not None and (
                self.replay.dispatcher is not None
                or self.replay.membership is not None
                or self.replay.embedding is not None
                or self.replay.autoscale is not None
                or self.replay.layout is not None
                or self.replay.world_version
            ):
                f.write(json.dumps({
                    "t": "snapshot",
                    "dispatcher": (
                        asdict(self.replay.dispatcher)
                        if self.replay.dispatcher is not None else None
                    ),
                    "membership": (
                        asdict(self.replay.membership)
                        if self.replay.membership is not None else None
                    ),
                    "embedding": (
                        asdict(self.replay.embedding)
                        if self.replay.embedding is not None else None
                    ),
                    "autoscale": (
                        asdict(self.replay.autoscale)
                        if self.replay.autoscale is not None else None
                    ),
                    "layout": (
                        asdict(self.replay.layout)
                        if self.replay.layout is not None else None
                    ),
                    "world_version": self.replay.world_version,
                }) + "\n")
            f.flush()
            # boot-time rotation: single-threaded (the append handle is
            # not open yet), so no mutator can queue behind this fsync:
            # edl-lint: disable=EDL403,EDL103
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        self._fsync_dir()
        _ROTATIONS.inc()

    # -------------------------------------------------------------- #
    # replayed-state accessors (None = nothing to restore)

    def dispatcher_snapshot(self) -> Optional[DispatcherState]:
        if self.replay is None:
            return None
        return self.replay.dispatcher

    def membership_snapshot(self) -> Optional[MembershipState]:
        if self.replay is None:
            return None
        return self.replay.membership

    def embedding_snapshot(self) -> Optional[EmbeddingState]:
        if self.replay is None:
            return None
        return self.replay.embedding

    def autoscale_snapshot(self) -> Optional[AutoscaleState]:
        if self.replay is None:
            return None
        return self.replay.autoscale

    def layout_snapshot(self) -> Optional[LayoutState]:
        if self.replay is None:
            return None
        return self.replay.layout

    @property
    def world_version(self) -> int:
        return self.replay.world_version if self.replay is not None else 0

    # -------------------------------------------------------------- #
    # append path

    def append(self, rtype: str, **fields: Any) -> Commit:
        """Commit one transition record; see :meth:`append_many`."""
        return self.append_many([(rtype, fields)])

    def append_many(self, records: List[Tuple[str, Dict[str, Any]]]) -> Commit:
        """Commit a batch of records under ONE fsync (bulk task creation,
        batched lease grants).

        A multi-record batch is serialized as ONE ``batch`` line: a large
        batch can span several write(2) syscalls, and a crash between them
        must not persist a parseable prefix (an ``epoch_advance`` with only
        some of its ``task_create`` lines would replay a partial epoch).
        One line is either whole at replay or a torn tail dropped whole —
        the batch commits all-or-nothing.

        Per-commit mode: the records are durable when this returns (the
        returned Commit is pre-completed). Group-commit mode: the records
        are ENQUEUED in call order; ``wait()`` the returned Commit (after
        releasing your owning lock) before acknowledging the transition."""
        if not records:
            return Commit()
        recs = [{"t": rtype, **fields} for rtype, fields in records]
        if self._window_s > 0:
            return self._enqueue(recs)
        data = _render(recs)
        t0 = time.perf_counter()
        with self._lock:
            if self._fh is None:
                # post-close append (a component outliving its master after
                # crash_stop): dropping is correct — a NEW master owns the
                # file now, and interleaving two writers would corrupt it
                logger.warning(
                    "journal append after close dropped (%d record(s))",
                    len(records),
                )
                return Commit()
            self._fh.write(data)
            self._fh.flush()
            if self._fsync:
                # the one sanctioned per-commit fsync site: the journal
                # lock is a leaf I/O lock, not a control-plane lock — the
                # group-commit committer is the scalable path
                os.fsync(self._fh.fileno())  # edl-lint: disable=EDL403,EDL103
        _APPENDS.inc(len(records))
        _COMMIT_LATENCY.observe(time.perf_counter() - t0)
        return Commit()

    # -------------------------------------------------------------- #
    # group-commit pipeline

    def _enqueue(self, recs: List[Dict[str, Any]]) -> Commit:
        """Queue one commit's records onto the open batch (called under the
        mutator's owning lock — cheap: list appends, no I/O). Queue order
        is mutation order, and the committer flushes in queue order, so
        disk order stays mutation order exactly as in per-commit mode."""
        with self._qcv:
            if self._poisoned is not None:
                return self._failed_commit(self._poisoned)
            if self._closing:
                logger.warning(
                    "journal append after close dropped (%d record(s))",
                    len(recs),
                )
                return Commit()
            batch = self._queue
            if not batch.records:
                batch.opened_at = time.monotonic()
            batch.records.extend(recs)
            batch.enqueued_at.append(time.perf_counter())
            depth = len(batch.records)
            _QUEUE_DEPTH.set(depth)
            if depth > self._queue_high_water:
                self._queue_high_water = depth
            if depth > self.COMMIT_QUEUE_WARN_DEPTH and not self._bp_warned:
                # edge-triggered per window (the committer resets the
                # flag on swap): one warning per saturated window, not
                # one per commit
                self._bp_warned = True
                _BACKPRESSURE.inc()
                logger.warning(
                    "journal group-commit BACKPRESSURE: %d records queued "
                    "in the open window (warn threshold %d) — offered "
                    "commit rate exceeds flush throughput",
                    depth, self.COMMIT_QUEUE_WARN_DEPTH,
                )
            self._qcv.notify_all()
            return Commit(batch.event, batch)

    def _committer_loop(self) -> None:
        """The single committer: waits for the open batch to fill its
        bounded window (``--journal_group_commit_ms``), swaps it out, and
        flushes it under one write+fsync. Only this thread (and close())
        touches the file handle in group-commit mode."""
        while True:
            with self._qcv:
                while not self._queue.records and not self._closing:
                    self._qcv.wait()
                if self._closing:
                    # close() drains or aborts the remaining queue itself
                    return
                deadline = self._queue.opened_at + self._window_s
                while not self._closing and not self._flush_now:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._qcv.wait(remaining)
                batch, self._queue = self._queue, _OpenBatch()
                self._flush_now = False
                self._bp_warned = False
                _QUEUE_DEPTH.set(0)
            if batch.records:
                # a close() racing the window wait can hand us a freshly
                # swapped EMPTY batch — flushing it would write a spurious
                # empty batch line and count a zero-record flush
                self._flush_batch(batch)
            else:
                batch.event.set()

    @staticmethod
    def _failed_commit(err: BaseException) -> Commit:
        batch = _OpenBatch()
        batch.error = err
        batch.event.set()
        return Commit(batch.event, batch)

    def _flush_batch(self, batch: _OpenBatch) -> None:
        """One write + flush + fsync for everything queued since the last
        flush, serialized as ONE line (all-or-nothing at replay), then
        release every commit waiting on it. Never raises: a flush failure
        parks the error on the batch, POISONS the journal (the failed
        write may have torn the tail — writing past it would fuse lines
        and drop acknowledged records at replay; and a later successful
        flush must not release acks ordered after a lost window), and
        every ``wait()`` re-raises — no gated ack ever goes out."""
        with self._qcv:
            poisoned = self._poisoned
        if poisoned is not None:
            batch.error = poisoned
            batch.event.set()
            return
        t_flush = time.perf_counter()
        try:
            data = _render(batch.records)
            with self._lock:
                if self._fh is None:
                    raise JournalCommitError("journal closed under committer")
                self._fh.write(data)
                self._fh.flush()
                if self._fsync:
                    # the group-commit fsync: ONE syscall for the whole
                    # window's commits, on the committer thread — never
                    # under a control-plane lock (the EDL403 idiom)
                    os.fsync(self._fh.fileno())  # edl-lint: disable=EDL403,EDL103
        except BaseException as e:
            batch.error = e
            with self._qcv:
                self._poisoned = e
                self._qcv.notify_all()
            logger.exception(
                "journal group-commit flush FAILED (%d record(s)); their "
                "acks will not be released and the journal is POISONED — "
                "every further commit fails until a new master takes over",
                len(batch.records),
            )
        finally:
            batch.event.set()
        if batch.error is None:
            _APPENDS.inc(len(batch.records))
            _GROUP_FLUSHES.inc()
            _GROUP_RECORDS.inc(len(batch.records))
            _GROUP_BATCH.observe(len(batch.records))
            now = time.perf_counter()
            for t0 in batch.enqueued_at:
                _COMMIT_LATENCY.observe(now - t0)
            if now - t_flush > 1.0:
                logger.warning(
                    "slow journal group-commit flush: %.2fs for %d records",
                    now - t_flush, len(batch.records),
                )

    def _stop_committer(self, drain: bool) -> None:
        """Wind the committer down. ``drain=True`` (orderly close) flushes
        whatever is still queued; ``drain=False`` (simulated crash) drops
        it — exactly what SIGKILL would lose: queued records whose acks
        were never released — and fails any waiters."""
        with self._qcv:
            self._closing = True
            batch, self._queue = self._queue, _OpenBatch()
            _QUEUE_DEPTH.set(0)
            self._qcv.notify_all()
        if self._committer is not None:
            self._committer.join(timeout=10.0)
            self._committer = None
        if not batch.records:
            return
        if drain:
            self._flush_batch(batch)
        else:
            batch.error = JournalCommitError(
                "journal crashed with the commit queued but not flushed"
            )
            batch.event.set()
            logger.warning(
                "journal crash-close dropped %d queued record(s) "
                "(unacknowledged by construction)", len(batch.records),
            )

    def flush(self, timeout_s: float = 30.0) -> None:
        """Make the OPEN group-commit batch durable now, without closing
        (no-op in per-commit mode, where appends are already durable, and
        on an empty queue). The clean-shutdown hook for owners whose last
        record may still be riding the committer's window — e.g. the
        ProcessManager's newest ``world_version`` record at a clean stop.

        The flush itself runs on the COMMITTER thread (this method only
        signals it to cut the window early and waits for the batch's
        event): a foreign-thread write could land a newer batch before an
        older already-swapped one and invert the disk-order == mutation-
        order replay invariant. Failures park on the batch exactly as a
        committer flush failure would (waiters raise; the journal
        poisons); a wedged committer bounds this wait at `timeout_s`."""
        if self._window_s <= 0:
            return
        with self._qcv:
            if self._closing or not self._queue.records:
                # nothing queued — or the committer already swapped the
                # batch out and is flushing it as we speak
                return
            batch = self._queue
            self._flush_now = True
            self._qcv.notify_all()
        batch.event.wait(timeout_s)

    def close(self) -> None:
        """Orderly close: drain the commit queue, then fsync + close."""
        self._close(drain=True)

    def abort(self) -> None:
        """Simulated-crash close (Master.crash): queued-but-unflushed
        commits are DROPPED, as SIGKILL would — nothing they gated was
        acknowledged, so the successor's replay accounting is identical
        to a real kill."""
        self._close(drain=False)

    def _close(self, drain: bool) -> None:
        if self._window_s > 0:
            self._stop_committer(drain)
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.flush()
                    if self._fsync:
                        # teardown: the committer is already stopped and
                        # mutators' post-close appends drop — nothing can
                        # queue behind this final fsync:
                        # edl-lint: disable=EDL403,EDL103
                        os.fsync(self._fh.fileno())
                finally:
                    self._fh.close()
                    self._fh = None

    def discard(self) -> None:
        """Clean-completion teardown: close the journal and retire it to
        ``journal.jsonl.completed``. Only for a job that actually finished —
        a live journal whose replay says training_done/job_end would make a
        later re-submission with the same checkpoint_dir come up
        born-finished and silently no-op. The rename (not a delete) keeps
        the final generation + accounting on disk for forensics. Crash and
        abort paths never call this; they keep the journal live so the
        successor recovers from it."""
        self.close()
        try:
            os.replace(self.path, self.path + ".completed")
            self._fsync_dir()
        except OSError:
            # the journal survived with job_end on it: the next submission
            # reusing this checkpoint_dir will replay it and no-op — that
            # MUST be diagnosable from the logs
            logger.exception(
                "journal retirement failed; a re-submission against %s will "
                "replay a finished job", self.path,
            )
