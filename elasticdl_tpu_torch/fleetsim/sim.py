"""The fleet simulator core: thousands of scripted workers vs the REAL
master control plane, on a compressed virtual clock.

Everything master-side is production code, not a mock: the journal
(with its real group-commit window and real fsyncs), Membership,
TaskDispatcher, ClusterHealth, FleetGoodput, the TimeSeriesStore, the
AlertEngine, and the Autoscaler behind a simulator-backed scale target.
Only the WIRE is simulated — workers call `MasterServicer` methods
directly through a `SimContext` that carries the same invocation
metadata (generation claim, re-register flag, stats payload) a gRPC
hop would, and `abort()` raises `SimRpcError` the way grpc raises
RpcError, so the generation fence / re-register handshake is exercised
verbatim.

Time model (the load-bearing trick):

- **Virtual time** orders the fleet: a single-threaded discrete-event
  scheduler pops (virtual_offset, seq, callback) off a heap and jumps
  the clock between events, so a 10-minute soak with 1000 workers runs
  in seconds of wall. Every master component gets the virtual clock
  injected (``clock=vclock.now``), so lease timeouts, heartbeat reaping,
  alert windows and autoscale cooldowns all happen at fleet-realistic
  VIRTUAL rates.
- **Real time** measures the master: journal flush latency, poll-phase
  wall (master/poll_phases.py), lock passes — the costs the soak exists
  to find — are measured with perf_counter, untouched by compression.

Determinism: one seed drives every RNG (the fleet RNG and one
`random.Random` per worker), scheduling ties break on insertion order,
and the event log records only virtual offsets — the same scenario +
seed yields an identical event log and identical journal accounting on
every run (pinned by tests/test_fleetsim.py). NEVER call `time.sleep`
in this package: sleeping real time inside simulated time is always a
bug (edl-lint EDL502).
"""

from __future__ import annotations

import hashlib
import heapq
import json
import math
import os
import random
import shutil
import time
from contextlib import redirect_stdout
from typing import Any, Callable, Dict, List, Optional

import grpc

from elasticdl_tpu_torch.common.log_utils import default_logger as logger
from elasticdl_tpu_torch.fleetsim.scenario import Scenario
from elasticdl_tpu_torch.master.poll_phases import poll_phase
from elasticdl_tpu_torch.observability import health as health_lib
from elasticdl_tpu_torch.observability import tracing
from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb
from elasticdl_tpu_torch.proto.service import GENERATION_KEY, REREGISTER_KEY

#: virtual seconds a grow action takes to materialize a bootable worker
#: (instance provision + container pull, compressed)
PROVISION_DELAY_S = 5.0

#: goodput ledger categories a sim worker reports (cumulative seconds;
#: mirrors observability/goodput.py GoodputLedger.CATEGORIES)
GP_KEYS = (
    "gp_wall_s", "gp_train_compute_s", "gp_data_wait_s", "gp_h2d_s",
    "gp_emb_pull_blocked_s", "gp_rescale_s", "gp_lease_wait_s",
    "gp_reconnect_s", "gp_overhead_s",
)


class SimRpcError(Exception):
    """The sim's stand-in for grpc.RpcError: raised by SimContext.abort
    and by calls against a down master."""

    def __init__(self, code, details: str = ""):
        super().__init__(f"{code}: {details}")
        self.status_code = code
        self.details = details

    @property
    def unavailable(self) -> bool:
        return self.status_code == grpc.StatusCode.UNAVAILABLE

    @property
    def stale_generation(self) -> bool:
        return self.status_code == grpc.StatusCode.FAILED_PRECONDITION


class SimContext:
    """A servicer-side context faithful to the slice of grpc.ServicerContext
    the master actually uses: invocation metadata in, abort out."""

    __slots__ = ("_metadata",)

    def __init__(self, metadata=()):
        self._metadata = tuple(metadata)

    def invocation_metadata(self):
        return self._metadata

    def abort(self, code, details: str = "") -> None:
        raise SimRpcError(code, details)

    def set_trailing_metadata(self, md) -> None:  # parity no-op
        pass


class VirtualClock:
    """Wall-anchored virtual time: now() = real epoch at run start +
    virtual offset. Anchoring at a real epoch keeps journaled timestamps
    plausible (the incident CLI renders them); all DECISIONS downstream
    depend only on deltas, which are pure virtual and deterministic."""

    def __init__(self):
        self.base = time.time()
        self.offset = 0.0

    def now(self) -> float:
        return self.base + self.offset


class Scheduler:
    """Deterministic discrete-event loop: (offset, seq, fn) min-heap;
    ties break on insertion order."""

    def __init__(self, clock: VirtualClock):
        self._clock = clock
        self._heap: List[tuple] = []
        self._seq = 0

    def at(self, offset: float, fn: Callable[[], None]) -> None:
        # the past is not schedulable: clamp to "now" (a callback that
        # computes a tiny negative delay must not rewind the clock)
        heapq.heappush(
            self._heap, (max(offset, self._clock.offset), self._seq, fn))
        self._seq += 1

    def after(self, delay: float, fn: Callable[[], None]) -> None:
        self.at(self._clock.offset + max(0.0, delay), fn)

    def run(self, until: float,
            stop_fn: Optional[Callable[[], bool]] = None) -> None:
        while self._heap:
            offset, _seq, fn = heapq.heappop(self._heap)
            if offset > until:
                break
            self._clock.offset = offset
            fn()
            if stop_fn is not None and stop_fn():
                break


class EventLog:
    """The run's deterministic record: virtual offsets only, never real
    wall — same seed, same bytes (the determinism test hashes this)."""

    def __init__(self):
        self.entries: List[Dict[str, Any]] = []

    def log(self, clock: VirtualClock, kind: str, **fields) -> None:
        entry = {"at_s": round(clock.offset, 3), "event": kind}
        entry.update(fields)
        self.entries.append(entry)

    def digest(self) -> str:
        blob = json.dumps(self.entries, sort_keys=True,
                          separators=(",", ":")).encode()
        return hashlib.sha256(blob).hexdigest()


# --------------------------------------------------------------------- #
# the scripted worker


class SimWorker:
    """One scripted worker lifecycle against the real master: register →
    heartbeat (honest stats payload) → lease batches → report → die /
    rejoin, with the production reconnect handshake (UNAVAILABLE backoff,
    generation fence → re-register) on every path."""

    def __init__(self, fleet: "FleetSim", sim_id: int):
        self.fleet = fleet
        self.sim_id = sim_id
        self.rack = sim_id % fleet.scenario.racks
        self.name = f"sim-{sim_id}"
        sc = fleet.scenario
        self.rng = random.Random(((sc.seed + 1) << 20) ^ sim_id)
        self.alive = False
        self.evicted = False          # terminal: never rejoins
        self.registered = False
        self.incarnation = 0          # bumps cancel scheduled callbacks
        self.worker_id = -1
        self.generation = 0           # master generation claimed on calls
        self.steps = 0
        self.straggle_factor = 1.0
        self.straggle_until = 0.0     # virtual offset
        self.data_wait_frac = sc.data_wait_frac
        self.emb: Dict[str, float] = {}   # popularity_flip payload fields
        self.gp = {k: 0.0 for k in GP_KEYS}
        self._ledger_mark = 0.0       # virtual offset of last ledger cut
        self._pend_reconnect = 0.0    # virtual s since last cut
        self._pend_lease_wait = 0.0
        self._backoff = 0.0
        self.held: List[Any] = []     # leased task protos awaiting report

    # -- lifecycle ----------------------------------------------------- #

    def boot(self, delay: float) -> None:
        self.incarnation += 1
        self.alive = True
        self.registered = False
        self.held.clear()
        self._backoff = 0.0
        self._ledger_mark = self.fleet.vclock.offset + delay
        inc = self.incarnation
        self.fleet.sched.after(delay, lambda: self._register(inc))

    def die(self) -> None:
        """Abrupt death: stops beating mid-lease; nothing is reported.
        The master finds out the hard way (heartbeat reap → task
        recovery), exactly like a real SIGKILL'd worker."""
        if not self.alive:
            return
        self.incarnation += 1
        self.alive = False
        self.registered = False
        self.held.clear()

    def rejoin(self, delay: float) -> None:
        if self.alive or self.evicted:
            return
        self.boot(delay)

    def _stale(self, inc: int) -> bool:
        return inc != self.incarnation or not self.alive

    def _next_backoff(self) -> float:
        base = 1.0 if self._backoff <= 0 else min(10.0, self._backoff * 2)
        self._backoff = base
        return base * (0.75 + 0.5 * self.rng.random())

    def _refence(self) -> None:
        """A FAILED_PRECONDITION (stale master generation) on any call:
        drop leases (the replayed master already requeued them), cancel
        every scheduled callback for this life, and re-enter through the
        re-register handshake."""
        self.incarnation += 1
        self.registered = False
        self.held.clear()
        self._backoff = 0.0
        inc = self.incarnation
        self.fleet.stat["fences_seen"] += 1
        self.fleet.sched.after(
            0.05 + 0.2 * self.rng.random(), lambda: self._register(inc))

    # -- register ------------------------------------------------------ #

    def _register(self, inc: int) -> None:
        if self._stale(inc):
            return
        fleet = self.fleet
        sc = fleet.scenario
        reconnect = self.worker_id >= 0
        md = ((REREGISTER_KEY, "1"),) if reconnect else ()
        req = pb.RegisterWorkerRequest(
            worker_name=self.name,
            preferred_id_plus_one=(self.worker_id + 1) if reconnect else 0,
            member_names=[
                f"{self.name}#p{j + 1}" for j in range(sc.cohort_members)
            ],
        )
        try:
            resp = fleet.rpc("RegisterWorker", req, md)
        except SimRpcError as e:
            if e.stale_generation:
                # register itself never claims a generation; structurally
                # unreachable, but a worker must not crash on any abort
                self._refence()
                return
            delay = self._next_backoff()
            self._pend_reconnect += delay
            fleet.sched.after(delay, lambda: self._register(inc))
            return
        self._backoff = 0.0
        first = self.worker_id < 0
        self.worker_id = resp.worker_id
        self.generation = fleet.generation
        self.registered = True
        fleet.stat["registrations" if first else "reregistrations"] += 1
        if first:
            fleet.events.log(fleet.vclock, "worker_up",
                             sim_id=self.sim_id, worker_id=self.worker_id,
                             rack=self.rack)
        jitter = self.rng.random()
        fleet.sched.after(sc.heartbeat_s * (0.5 + 0.5 * jitter),
                          lambda: self._heartbeat(inc))
        fleet.sched.after(0.01 + 0.05 * jitter, lambda: self._lease(inc))

    # -- heartbeat + stats payload ------------------------------------- #

    def _payload(self) -> Dict[str, Any]:
        sc = self.fleet.scenario
        factor = self.straggle_factor
        step_ms = sc.step_ms * factor
        dw = self.data_wait_frac
        payload: Dict[str, Any] = {
            "steps": self.steps,
            "step_p50_ms": round(step_ms, 3),
            "step_p90_ms": round(step_ms * 1.2, 3),
            "step_max_ms": round(step_ms * 1.7, 3),
            "records_per_s": round(sc.records_per_s / factor, 2),
            "phase": "train",
            "phase_data_wait_ms": round(step_ms * dw, 3),
            "phase_compute_ms": round(step_ms * (1.0 - dw), 3),
        }
        for k, v in self.gp.items():
            payload[k] = round(v, 3)
        payload.update(self.emb)
        if self.emb and self.fleet.layout_ctl is not None:
            # layout runs: the flipped workers' embedding telemetry is
            # recomputed against the CURRENT shard map every beat, so
            # the controller's own actions show up in the next sample
            payload.update(self.fleet.layout_emb_stats())
        return payload

    def _cut_ledger(self) -> None:
        """Attribute virtual wall since the last cut across the goodput
        categories: total-attribution invariant (categories sum to
        wall), like the real GoodputLedger."""
        now = self.fleet.vclock.offset
        delta = max(0.0, now - self._ledger_mark)
        self._ledger_mark = now
        reconnect = min(self._pend_reconnect, delta)
        lease_wait = min(self._pend_lease_wait, delta - reconnect)
        self._pend_reconnect = self._pend_lease_wait = 0.0
        rest = delta - reconnect - lease_wait
        overhead = rest * 0.02
        data_wait = (rest - overhead) * self.data_wait_frac
        compute = rest - overhead - data_wait
        self.gp["gp_wall_s"] += delta
        self.gp["gp_reconnect_s"] += reconnect
        self.gp["gp_lease_wait_s"] += lease_wait
        self.gp["gp_overhead_s"] += overhead
        self.gp["gp_data_wait_s"] += data_wait
        self.gp["gp_train_compute_s"] += compute
        step_s = (self.fleet.scenario.step_ms / 1e3) * self.straggle_factor
        if step_s > 0:
            self.steps += int(compute / step_s)

    def _heartbeat(self, inc: int) -> None:
        if self._stale(inc):
            return
        fleet = self.fleet
        sc = fleet.scenario
        if self.straggle_factor != 1.0 \
                and fleet.vclock.offset >= self.straggle_until:
            self.straggle_factor = 1.0
        self._cut_ledger()
        payload = self._payload()
        md = [
            (GENERATION_KEY, str(self.generation)),
            (health_lib.STATS_METADATA_KEY, health_lib.encode_stats(payload)),
        ]
        members = [
            pb.MemberBeat(
                worker_id=mid, model_version=self.steps,
                stats_json=health_lib.encode_stats(payload),
            )
            for mid in fleet.cohort_member_ids(self.worker_id)
        ]
        req = pb.HeartbeatRequest(
            worker_id=self.worker_id, model_version=self.steps,
            members=members,
        )
        try:
            resp = fleet.rpc("Heartbeat", req, md)
        except SimRpcError as e:
            if e.stale_generation:
                self._refence()
                return
            delay = self._next_backoff()
            self._pend_reconnect += delay
            fleet.sched.after(delay, lambda: self._heartbeat(inc))
            return
        self._backoff = 0.0
        fleet.stat["heartbeats"] += 1
        if resp.evict:
            self._drain_evicted(inc)
            return
        if resp.job_done:
            self.die()
            return
        if resp.shutdown:
            # the master no longer knows us (reaped while partitioned,
            # same generation): an elastic worker re-enters through the
            # re-register handshake instead of exiting
            self._refence()
            return
        fleet.sched.after(sc.heartbeat_s * (0.9 + 0.2 * self.rng.random()),
                          lambda: self._heartbeat(inc))

    def _drain_evicted(self, inc: int) -> None:
        """The autoscaler's drain handshake: report outstanding leases
        preempted (requeued without a retry penalty), then leave for
        good."""
        fleet = self.fleet
        for task in list(self.held):
            req = pb.ReportTaskResultRequest(
                worker_id=self.worker_id, task_id=task.task_id,
                success=False, err_message="evicted", preempted=True,
                model_version=self.steps,
            )
            try:
                fleet.rpc("ReportTaskResult", req,
                          [(GENERATION_KEY, str(self.generation))])
            except SimRpcError:
                break   # requeue happens master-side either way
        self.held.clear()
        self.die()
        self.evicted = True
        fleet.stat["evictions_drained"] += 1
        fleet.events.log(fleet.vclock, "worker_evicted",
                         sim_id=self.sim_id, worker_id=self.worker_id)

    # -- lease / report ------------------------------------------------ #

    def _lease(self, inc: int) -> None:
        if self._stale(inc) or not self.registered:
            return
        fleet = self.fleet
        sc = fleet.scenario
        req = pb.GetTaskRequest(
            worker_id=self.worker_id, max_tasks=sc.lease_batch)
        try:
            resp = fleet.rpc("GetTask", req,
                             [(GENERATION_KEY, str(self.generation))])
        except SimRpcError as e:
            if e.stale_generation:
                self._refence()
                return
            delay = self._next_backoff()
            self._pend_reconnect += delay
            fleet.sched.after(delay, lambda: self._lease(inc))
            return
        self._backoff = 0.0
        if resp.job_done:
            return   # keep beating; the heartbeat's job_done retires us
        tasks = list(resp.tasks) or [resp.task]
        if tasks[0].type == pb.WAIT:
            delay = max(0.05, resp.backoff_seconds) \
                * (0.9 + 0.2 * self.rng.random())
            self._pend_lease_wait += delay
            fleet.sched.after(delay, lambda: self._lease(inc))
            return
        fleet.stat["lease_batches"] += 1
        fleet.stat["leases_acked"] += len(tasks)
        self.held.extend(tasks)
        # work the batch sequentially at the scripted retire rate, then
        # lease again
        offset = 0.0
        rate = sc.records_per_s / self.straggle_factor
        for task in tasks:
            offset += max(task.end - task.start, 1) / rate
            self.fleet.sched.after(
                offset, lambda t=task: self._report(t, inc))
        fleet.sched.after(offset + 0.001, lambda: self._lease(inc))

    def _report(self, task, inc: int) -> None:
        if self._stale(inc):
            return
        fleet = self.fleet
        records = max(task.end - task.start, 1)
        req = pb.ReportTaskResultRequest(
            worker_id=self.worker_id, task_id=task.task_id, success=True,
            records_processed=records, model_version=self.steps,
            loss_sum=1.0, loss_count=1,
        )
        try:
            resp = fleet.rpc("ReportTaskResult", req,
                             [(GENERATION_KEY, str(self.generation))])
        except SimRpcError as e:
            if e.stale_generation:
                # completed work discarded by the fence (billed wasted
                # master-side via note_fenced_report); re-register and
                # re-lease — the replayed queue holds the requeued task
                self._refence()
                return
            delay = self._next_backoff()
            self._pend_reconnect += delay
            fleet.sched.after(delay, lambda: self._report(task, inc))
            return
        self._backoff = 0.0
        self.held = [t for t in self.held if t.task_id != task.task_id]
        if resp.accepted:
            fleet.stat["reports_acked"] += 1
            if task.type == pb.TRAINING:
                fleet.acked_training.add(task.task_id)
        else:
            fleet.stat["reports_rejected"] += 1


# --------------------------------------------------------------------- #
# the simulator-backed scale target


class SimScaleTarget:
    """The autoscaler's action surface, backed by the simulated fleet:
    grow provisions a brand-new scripted worker, shrink/evict route
    through the servicer's drain handshake (evict flag on the next
    heartbeat) — the same wire protocol production uses."""

    def __init__(self, fleet: "FleetSim"):
        self._fleet = fleet

    def world_size(self) -> int:
        return self._fleet.membership.alive_count()

    def supports(self, kind: str) -> bool:
        return True

    def grow(self) -> bool:
        self._fleet.spawn_worker()
        return True

    def shrink(self) -> bool:
        alive = [
            w.worker_id for w in self._fleet.membership.alive_workers()
            if w.led_by is None
        ]
        if not alive:
            return False
        return self.evict(max(alive))

    def evict(self, worker_id: int, worker_name: str = "") -> bool:
        self._fleet.servicer.request_evict(worker_id)
        self._fleet.events.log(
            self._fleet.vclock, "scale_evict_requested",
            worker_id=worker_id)
        return True


# --------------------------------------------------------------------- #
# the fleet simulator


class FleetSim:
    """One scenario run: build the real master, script the fleet,
    interpret the event schedule, and emit cliff metrics + incident
    artifacts. Single-threaded by design (determinism)."""

    def __init__(self, scenario: Scenario, workdir: str,
                 artifacts_dir: Optional[str] = None):
        self.scenario = scenario
        self.workdir = workdir
        self.artifacts_dir = artifacts_dir
        self.vclock = VirtualClock()
        self.sched = Scheduler(self.vclock)
        self.events = EventLog()
        self.rng = random.Random(scenario.seed)
        self.workers: List[SimWorker] = []
        self.master_down = False
        self.master_restarts = 0
        self.acked_training: set = set()
        self._members_of: Dict[int, List[int]] = {}
        self._eval_job_id = 0
        self._poll_active = False
        self._alert_onsets: List[Dict] = []
        self._as_totals = {"reversals": 0, "actions": {}, "suppressed": {}}
        self._ly_totals: Dict[str, Any] = {"actions": {}, "records": 0}
        self._flip: Optional[Dict[str, Any]] = None
        self._flip_count = 0
        self._phase_wall: Dict[str, List[float]] = {}
        self.stat = {
            k: 0 for k in (
                "registrations", "reregistrations", "heartbeats",
                "lease_batches", "leases_acked", "reports_acked",
                "reports_rejected", "fences_seen", "evictions_drained",
                "polls", "injected_tasks",
            )
        }
        # runtime lock-order recording across the whole run (restarts
        # union into one graph — the recorder is name-keyed, not
        # instance-keyed): any inversion the scenario drives the real
        # control plane into raises AT THE ACQUIRE, with both sites
        from elasticdl_tpu_torch.analysis.lockorder import LockOrderRecorder

        self.lock_recorder = LockOrderRecorder(raise_on_cycle=True)
        # master-side handles, (re)bound by _build_master
        self.journal = None
        self.dispatcher = None
        self.membership = None
        self.servicer = None
        self.health = None
        self.goodput = None
        self.timeseries = None
        self.alerts = None
        self.autoscaler = None
        # embedding layout loop (ISSUE 20): the owner map + controller
        # rebuild on master restart (journal-restored); the stores stand
        # in for worker-side shard state and survive restarts like the
        # workers do
        self.emb_owner = None
        self.layout_ctl = None
        self.emb_stores: Dict[int, Any] = {}
        self.generation = 0

    # -- master build / kill / restart --------------------------------- #

    def _scaled_rules(self):
        import dataclasses

        from elasticdl_tpu_torch.observability import alerts as alerts_lib

        scale = self.scenario.alert_window_scale
        rules = []
        for r in alerts_lib.default_rules():
            rules.append(dataclasses.replace(
                r,
                window_s=max(1.0, r.window_s * scale),
                long_window_s=(max(2.0, r.long_window_s * scale)
                               if r.long_window_s else 0.0),
                for_s=r.for_s * scale,
            ))
        return rules

    def _build_master(self) -> None:
        from elasticdl_tpu_torch.master import autoscaler as autoscaler_lib
        from elasticdl_tpu_torch.master.journal import ControlPlaneJournal
        from elasticdl_tpu_torch.master.membership import Membership
        from elasticdl_tpu_torch.master.servicer import MasterServicer
        from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
        from elasticdl_tpu_torch.observability.alerts import AlertEngine
        from elasticdl_tpu_torch.observability.goodput import FleetGoodput
        from elasticdl_tpu_torch.observability.health import ClusterHealth
        from elasticdl_tpu_torch.observability.timeseries import TimeSeriesStore

        sc = self.scenario
        if self.autoscaler is not None:
            self._harvest_autoscaler()
        if self.layout_ctl is not None:
            self._harvest_layout()
        self.journal = ControlPlaneJournal(
            self.workdir, group_commit_ms=sc.group_commit_ms)
        eval_shards = (
            [("sim-eval", 0, min(sc.eval_task_records, sc.records_per_task))]
            if sc.eval_task_records > 0 else None
        )
        self.dispatcher = TaskDispatcher(
            training_shards=[("sim-train", 0,
                              sc.shards * sc.records_per_task)],
            evaluation_shards=eval_shards,
            records_per_task=sc.records_per_task,
            num_epochs=sc.epochs,
            shuffle=False,
            task_timeout_s=sc.task_timeout_s,
            journal=self.journal,
            clock=self.vclock.now,
        )
        self.membership = Membership(
            heartbeat_timeout_s=sc.heartbeat_timeout_s,
            journal=self.journal,
            clock=self.vclock.now,
        )
        self.membership.add_death_callback(self.dispatcher.recover_tasks)
        self.servicer = MasterServicer(
            self.dispatcher, self.membership, None,
            wait_backoff_s=sc.wait_backoff_s,
            generation=self.journal.generation,
        )
        self.generation = self.journal.generation
        self.health = ClusterHealth(
            self.membership, min_workers=3,
            stale_after_s=3.0 * sc.heartbeat_s,
        )
        self.goodput = FleetGoodput(self.membership, self.dispatcher)
        self.timeseries = TimeSeriesStore(interval_s=sc.poll_s)
        self.alerts = AlertEngine(
            self.timeseries, rules=self._scaled_rules(),
            json_path=(os.path.join(self.artifacts_dir, "alerts.json")
                       if self.artifacts_dir else None),
            flight_dump=lambda reason: None,
        )
        self.alerts.add_hook(self._on_alert_onset)
        self.autoscaler = None
        if sc.autoscale:
            a = dict(sc.autoscale)
            self.autoscaler = autoscaler_lib.Autoscaler(
                journal=self.journal,
                cost_model=autoscaler_lib.CostModel(
                    rescale_cost_s=a.get("rescale_cost_s", 5.0),
                    horizon_s=a.get("horizon_s", 300.0),
                ),
                min_world=int(a.get("min_workers", 1)),
                max_world=int(a.get("max_workers", 0)),
                cooldown_s=a.get("cooldown_s", 30.0),
                hold_s=a.get("hold_s", 10.0),
                action_budget=int(a.get("actions_max", 8)),
                damping=a.get("damping", 0.0),
                reversal_hold_s=a.get("reversal_hold_s", 0.0),
                clock=self.vclock.now,
            )
            self.autoscaler.subscribe(health=self.health, alerts=self.alerts)
            self.autoscaler.bind_target(SimScaleTarget(self))
        self.emb_owner = None
        self.layout_ctl = None
        if sc.layout:
            self._build_layout(dict(sc.layout))
        from elasticdl_tpu_torch.analysis.lockorder import instrument_master

        instrument_master(
            self.lock_recorder,
            membership=self.membership,
            dispatcher=self.dispatcher,
            servicer=self.servicer,
            journal=self.journal,
            autoscaler=self.autoscaler,
        )

    def _harvest_autoscaler(self) -> None:
        """Accumulate a dying autoscaler instance's per-run counters (a
        master restart rebuilds the instance; the run's totals must
        survive it). Reversals are in-memory-only → summed; by_kind is
        journal-durable (replayed into the successor) → overwritten."""
        snap = self.autoscaler.snapshot()
        self._as_totals["reversals"] += int(snap.get("reversals", 0))
        if snap.get("by_kind"):
            self._as_totals["actions"] = {
                k: int(v) for k, v in snap["by_kind"].items()
            }

    def _build_layout(self, ly: Dict[str, Any]) -> None:
        """The REAL layout stack on the virtual clock: a journaled
        ShardMapOwner, in-process stores standing in for the workers'
        shard state, and the layout controller subscribed to the same
        alert engine the flips drive. A master restart rebuilds owner
        and controller FROM THE JOURNAL (the takeover path under test);
        the stores persist like workers do."""
        from elasticdl_tpu_torch.embedding.sharding import ShardMapOwner, TableSpec
        from elasticdl_tpu_torch.embedding.store import EmbeddingShardStore
        from elasticdl_tpu_torch.master import layout_controller as layout_lib

        n0 = int(ly.get("num_shards", 8))
        hosts = list(range(min(4, self.scenario.workers)))
        self.emb_owner = ShardMapOwner(n0, journal=self.journal)
        self.emb_owner.register_table(
            TableSpec("emb", vocab=max(256, 4 * n0), dim=8))
        restored = self.journal.embedding_snapshot()
        if restored is not None and restored.version > 0:
            self.emb_owner.restore_from_replay(restored)
        else:
            self.emb_owner.bootstrap(hosts)
        if not self.emb_stores:
            self.emb_stores = {h: EmbeddingShardStore(h) for h in hosts}
            for st in self.emb_stores.values():
                st.attach(self.emb_owner.view(), "")
        self.layout_ctl = layout_lib.LayoutController(
            journal=self.journal,
            cost_model=layout_lib.LayoutCostModel(
                migrate_cost_s=float(ly.get("migrate_cost_s", 0.05)),
                horizon_s=float(ly.get("horizon_s", 120.0)),
            ),
            max_shards=int(ly.get("max_shards", 4 * n0)),
            min_shards=int(ly.get("min_shards", 1)),
            max_replicas=int(ly.get("max_replicas", 2)),
            hot_k=int(ly.get("hot_k", 16)),
            cooldown_s=float(ly.get("cooldown_s", 20.0)),
            hold_s=float(ly.get("hold_s", 5.0)),
            action_budget=int(ly.get("actions_max", 16)),
            clock=self.vclock.now,
        )
        self.layout_ctl.subscribe(alerts=self.alerts)
        self.layout_ctl.bind_target(layout_lib.StoreLayoutTarget(
            self.emb_owner, self.emb_stores))

    def _harvest_layout(self) -> None:
        """Layout decision totals across master restarts. Both counters
        are journal-durable (replayed into the successor), so the
        latest instance's snapshot IS the running total."""
        snap = self.layout_ctl.snapshot()
        if snap.get("by_kind"):
            self._ly_totals["actions"] = {
                k: int(v) for k, v in snap["by_kind"].items()
            }
        self._ly_totals["records"] = max(
            int(self._ly_totals["records"]),
            int(snap.get("decision_records", 0)))

    def layout_emb_stats(self) -> Dict[str, Any]:
        """The flipped fleet's embedding telemetry, CLOSED-LOOP: load
        concentrates on the flip's hot shard, and the modelled
        imbalance / pull p99 / cache hit rate recover as the layout
        controller's own actions (fan-out, split, hot promotion) land
        on the live shard map — so the alert rules that armed the
        controller also clear because of it."""
        if self.emb_owner is None or self._flip is None:
            return {}
        f = self._flip
        v = self.emb_owner.view()
        n = v.num_shards
        hs = float(f["hot_share"])
        hot = int(f.get("hot_shard", 0)) % n
        # relief already won: each replica of the hot shard absorbs an
        # equal cut of its reads; a split spreads the hot id set over
        # the children
        fan = 1 + len(v.replicas_of(hot))
        spread = max(1.0, float(n) / float(f["base_shards"]))
        head = [int(f["ids_base"]) + i for i in range(8)]
        # promoted: the ultra-hot head is worker-replicated — most of
        # its reads never reach the owner shard again
        promoted = set(head) <= {int(i) for i in v.hot_ids}
        eff_hot = hs / (fan * spread)
        if promoted:
            eff_hot *= 0.3
        cold = (1.0 - hs) / n
        shares = [cold + (hs - eff_hot) / n for _ in range(n)]
        shares[hot] = cold + eff_hot + (hs - eff_hot) / n
        total = sum(shares) or 1.0
        imb = max(shares) * n / total
        raw_imb = (hs + cold) * n  # the no-relief skew, for scaling p99
        p99 = max(25.0, float(f["pull_p99_ms"]) * imb / max(raw_imb, 1e-9))
        hit = max(0.05, 1.0 - hs)
        if promoted:
            hit = min(0.95, hit + 0.6)
        stats: Dict[str, Any] = {
            "emb_hot_id_share": round(hs, 3),
            "emb_pull_p99_ms": round(p99, 1),
            "emb_cache_hit_rate": round(hit, 3),
            "emb_shard_imbalance": round(imb, 3),
        }
        loads = ",".join(
            str(int(round(100.0 * s / total))) for s in shares)
        if len(loads) <= 64:
            stats["emb_shard_loads"] = loads
        ids = ""
        for i in head:
            nxt = f"{ids},{i}" if ids else str(i)
            if len(nxt) > 64:
                break
            ids = nxt
        if ids:
            stats["emb_hot_ids"] = ids
        return stats

    def _on_alert_onset(self, info: Dict) -> None:
        self._alert_onsets.append({
            "at_s": round(self.vclock.offset, 3),
            "rule": str(info.get("rule")),
            "severity": str(info.get("severity", "")),
        })

    def kill_master(self, down_s: float) -> None:
        """SIGKILL-equivalent: the journal's queued unacked commits are
        dropped (abort), every in-flight protocol future answers
        UNAVAILABLE, and recovery is a REAL journal replay."""
        if self.master_down:
            return
        self.events.log(self.vclock, "master_killed", down_s=down_s)
        self.master_down = True
        self.journal.abort()
        self.sched.after(down_s, self._restart_master)

    def _restart_master(self) -> None:
        self.master_restarts += 1
        self._build_master()
        self.master_down = False
        if not self._poll_active:
            # the poll chain retires itself once the job looks done; the
            # restored dispatcher deliberately forgets terminal flags
            # (poke() re-derives them and re-fires callbacks), so the
            # successor needs its own chain or job-end never re-fires
            self._poll_active = True
            self.sched.after(self.scenario.poll_s, self._poll)
        self.events.log(self.vclock, "master_restarted",
                        generation=self.generation,
                        requeued=(self.journal.replay.dispatcher.requeued_leases
                                  if self.journal.replay
                                  and self.journal.replay.dispatcher else 0))

    # -- the wire ------------------------------------------------------ #

    def rpc(self, method: str, request, metadata=()):
        """One worker→master call over the simulated wire."""
        if self.master_down or self.servicer is None:
            raise SimRpcError(grpc.StatusCode.UNAVAILABLE, "master down")
        return getattr(self.servicer, method)(
            request, SimContext(metadata))

    def cohort_member_ids(self, leader_id: int) -> List[int]:
        if self.scenario.cohort_members <= 0:
            return []
        ids = self._members_of.get(leader_id)
        if ids is None:
            ids = sorted(
                w.worker_id
                for w in self.membership.alive_workers()
                if w.led_by == leader_id
            )
            self._members_of[leader_id] = ids
        return ids

    def spawn_worker(self) -> SimWorker:
        w = SimWorker(self, len(self.workers))
        self.workers.append(w)
        w.boot(PROVISION_DELAY_S + self.rng.random())
        self.events.log(self.vclock, "scale_grow_provisioned",
                        sim_id=w.sim_id)
        return w

    # -- the master poll loop ------------------------------------------ #

    def _poll(self) -> None:
        sc = self.scenario
        if not self.master_down:
            self.stat["polls"] += 1
            now = self.vclock.now()
            self._members_of.clear()
            self._timed_phase("membership", self.membership.reap)
            self._timed_phase("dispatcher", self.dispatcher.poke)
            self._timed_phase("health", lambda: self.health.update(now=now))
            self._timed_phase("goodput", lambda: self.goodput.update(now=now))
            self._timed_phase(
                "timeseries",
                lambda: self.timeseries.maybe_sample(
                    now=now, extra_fn=self._fleet_series))
            self._timed_phase("alerts", lambda: self.alerts.evaluate(now=now))
            if self.autoscaler is not None:
                self._timed_phase(
                    "autoscaler", lambda: self.autoscaler.evaluate(now=now))
            if self.layout_ctl is not None:
                self._timed_phase(
                    "layout",
                    lambda: self.layout_ctl.evaluate(
                        now=now,
                        workers=self.membership.health_snapshot()))
        if self.vclock.offset + sc.poll_s <= self.scenario.duration_s \
                and not self.dispatcher.finished():
            self.sched.after(sc.poll_s, self._poll)
        else:
            self._poll_active = False

    def _timed_phase(self, phase: str, fn: Callable[[], Any]) -> None:
        t0 = time.perf_counter()
        with poll_phase(phase):
            fn()
        self._phase_wall.setdefault(phase, []).append(
            time.perf_counter() - t0)

    def _fleet_series(self) -> Dict[str, float]:
        from elasticdl_tpu_torch.observability.timeseries import fleet_series

        now = self.vclock.now()
        counts = self.dispatcher.counts()
        snap = self.health.snapshot(now=now)
        series = fleet_series(
            self.membership.health_snapshot(),
            straggler_count=snap.get("straggler_count", 0),
            todo_tasks=counts.get("todo", 0),
            alive_workers=self.membership.alive_count(),
            stale_after_s=3.0 * self.scenario.heartbeat_s,
            now=now,
        )
        series.update(self.goodput.series())
        return series

    # -- scenario event interpreters ----------------------------------- #

    def _schedule_events(self) -> None:
        for ev in self.scenario.events:
            action = ev["action"]
            if action == "stagger_joins":
                continue   # consumed by _boot_fleet
            self.sched.at(
                float(ev["at_s"]), lambda e=dict(ev): self._run_event(e))

    def _run_event(self, ev: Dict[str, Any]) -> None:
        action = ev["action"]
        self.events.log(self.vclock, "scenario_event", **ev)
        getattr(self, f"_ev_{action}")(ev)

    def _alive(self) -> List[SimWorker]:
        return [w for w in self.workers if w.alive]

    def _dead(self) -> List[SimWorker]:
        return [w for w in self.workers if not w.alive and not w.evicted]

    def _ev_kill_rack(self, ev) -> None:
        for w in self._alive():
            if w.rack == int(ev["rack"]):
                w.die()

    def _ev_rejoin_rack(self, ev) -> None:
        for w in self._dead():
            if w.rack == int(ev["rack"]):
                w.rejoin(self.rng.random() * 2.0)

    def _ev_kill_workers(self, ev) -> None:
        alive = self._alive()
        for w in self.rng.sample(alive, min(int(ev["count"]), len(alive))):
            w.die()

    def _ev_rejoin_workers(self, ev) -> None:
        dead = self._dead()
        for w in self.rng.sample(dead, min(int(ev["count"]), len(dead))):
            w.rejoin(self.rng.random() * 2.0)

    def _ev_rolling_restart(self, ev) -> None:
        batch = max(1, int(ev["batch"]))
        interval, down = float(ev["interval_s"]), float(ev["down_s"])
        fleet = [w for w in self.workers if not w.evicted]
        for k in range(0, len(fleet), batch):
            group = fleet[k:k + batch]
            delay = (k // batch) * interval

            def restart(group=group):
                for w in group:
                    w.die()
                    self.sched.after(down, lambda w=w: w.rejoin(0.0))

            self.sched.after(delay, restart)

    def _ev_straggle(self, ev) -> None:
        alive = self._alive()
        for w in self.rng.sample(alive, min(int(ev["count"]), len(alive))):
            w.straggle_factor = max(1.0, float(ev["factor"]))
            w.straggle_until = self.vclock.offset + float(ev["for_s"])

    def _ev_set_data_wait(self, ev) -> None:
        frac = min(0.95, max(0.0, float(ev["frac"])))
        targets = self._alive()
        if "count" in ev:
            targets = self.rng.sample(
                targets, min(int(ev["count"]), len(targets)))
        for w in targets:
            w.data_wait_frac = frac

    def _ev_popularity_flip(self, ev) -> None:
        targets = self._alive()
        if "count" in ev:
            targets = self.rng.sample(
                targets, min(int(ev["count"]), len(targets)))
        for w in targets:
            w.emb = {
                "emb_hot_id_share": float(ev["hot_share"]),
                "emb_pull_p99_ms": float(ev["pull_p99_ms"]),
                "emb_cache_hit_rate": max(
                    0.05, 1.0 - float(ev["hot_share"])),
            }
        if self.emb_owner is not None:
            # a NEW hot set every flip: fresh sketch head ids, load
            # re-concentrated on the flip's hot shard — whatever relief
            # the controller won for the LAST head is now mis-aimed,
            # which is exactly the adapt-or-page scenario under test
            self._flip_count += 1
            self._flip = {
                "hot_share": float(ev["hot_share"]),
                "pull_p99_ms": float(ev["pull_p99_ms"]),
                "hot_shard": int(ev.get("hot_shard", 0)),
                "ids_base": 1000 * self._flip_count,
                "base_shards": self.emb_owner.view().num_shards,
            }

    def _ev_inject_tasks(self, ev) -> None:
        if self.master_down:
            return
        n = 0
        for _ in range(int(ev["count"])):
            self._eval_job_id += 1
            n += self.dispatcher.create_evaluation_tasks(self._eval_job_id)
        self.stat["injected_tasks"] += n

    def _ev_kill_master(self, ev) -> None:
        self.kill_master(float(ev["down_s"]))

    # -- run ----------------------------------------------------------- #

    def _boot_fleet(self) -> None:
        sc = self.scenario
        stagger = next(
            (ev for ev in sc.events if ev["action"] == "stagger_joins"),
            None,
        )
        for i in range(sc.workers):
            w = SimWorker(self, i)
            self.workers.append(w)
            if stagger is not None:
                delay = float(stagger["at_s"]) \
                    + self.rng.random() * float(stagger["over_s"])
            else:
                delay = self.rng.random() * 0.25
            w.boot(delay)
        if stagger is not None:
            self.events.log(self.vclock, "scenario_event", **stagger)

    def run(self) -> Dict[str, Any]:
        sc = self.scenario
        trace_path = None
        if self.artifacts_dir:
            os.makedirs(self.artifacts_dir, exist_ok=True)
            trace_path = os.path.join(self.artifacts_dir, "trace.jsonl")
        # the whole run inside a scoped tracer capture: a fleet soak pushes
        # thousands of spans through the real master stack, and leaking
        # them into the process tracer leaves its bounded ring full (and
        # the sim's role on every later log line) for whoever runs next
        # in this process — e.g. the rest of a test suite
        with tracing.get_tracer().scoped(path=trace_path, role="sim-master",
                                         world_version=0):
            self._build_master()
            self._boot_fleet()
            self._schedule_events()
            self._poll_active = True
            self.sched.after(sc.poll_s, self._poll)
            wall0 = time.perf_counter()
            self.sched.run(until=sc.duration_s)
            wall = time.perf_counter() - wall0
            result = self._finish(wall)
            if self.artifacts_dir:
                self._emit_artifacts(result)
        return result

    # -- cliff metrics + verification ---------------------------------- #

    def _finish(self, wall: float) -> Dict[str, Any]:
        sc = self.scenario
        counts = self.dispatcher.counts()
        wasted = self.dispatcher.wasted_work()
        finished = self.dispatcher.finished()
        if self.autoscaler is not None:
            self._harvest_autoscaler()
        if self.layout_ctl is not None:
            self._harvest_layout()

        # journal saturation: a post-run direct probe measures
        # enqueue-to-durable latency in this group-commit mode, plus the
        # run's own high-water (offered commit rate vs flush throughput)
        probe: List[float] = []
        if not self.master_down:
            for _ in range(50):
                t0 = time.perf_counter()
                self.journal.append("world_version", version=0).wait()
                probe.append(time.perf_counter() - t0)
        probe.sort()

        replay = self._check_replay()
        # every scenario doubles as a lock-order soak: the recorder
        # already raised at any inverting acquire; this sweep catches
        # cycles whose edges came from DIFFERENT threads' stacks, and
        # the observed edges land in the result for the static-graph
        # superset cross-check (test_lock_order.py)
        self.lock_recorder.assert_no_cycles()
        lock_edges = sorted(self.lock_recorder.edges())
        phases = {}
        for phase, walls in sorted(self._phase_wall.items()):
            s = sorted(walls)
            phases[phase] = {
                "count": len(s),
                "p50_ms": round(1e3 * s[len(s) // 2], 4),
                "p99_ms": round(
                    1e3 * s[min(len(s) - 1, math.ceil(len(s) * 0.99) - 1)],
                    4),
                "total_ms": round(1e3 * sum(s), 2),
            }

        acked = len(self.acked_training)
        lost_acked = max(
            0, acked - int(replay["replayed"]["finished_training"]))
        result = {
            "scenario": sc.name,
            "seed": sc.seed,
            "workers_configured": sc.workers,
            "workers_total": len(self.workers),
            "workers_final_alive": self.membership.alive_count(),
            "virtual_duration_s": sc.duration_s,
            "wall_s": round(wall, 3),
            "time_compression": round(sc.duration_s / max(wall, 1e-9), 1),
            "job_finished": finished,
            "master_restarts": self.master_restarts,
            "tasks": dict(counts, **{
                "records_completed": wasted["records_completed"],
                "wasted_records": wasted["wasted_records"],
            }),
            "stat": dict(self.stat),
            "leases_per_s": round(
                self.stat["leases_acked"] / max(wall, 1e-9), 1),
            "journal": {
                "group_commit_ms": sc.group_commit_ms,
                "flush_probe_p50_ms": round(
                    1e3 * probe[len(probe) // 2], 3) if probe else None,
                "flush_probe_p99_ms": round(
                    1e3 * probe[min(len(probe) - 1,
                                    math.ceil(len(probe) * 0.99) - 1)],
                    3) if probe else None,
                "commit_queue_high_water":
                    self.journal.commit_queue_high_water,
            },
            "poll_phases": phases,
            "alerts": {
                "onsets": len(self._alert_onsets),
                "by_rule": self._count_by(
                    self._alert_onsets, "rule"),
            },
            "autoscale": {
                "enabled": self.autoscaler is not None,
                "reversals": self._as_totals["reversals"],
                "actions_by_kind": dict(self._as_totals["actions"]),
            },
            "layout": {
                "enabled": self.layout_ctl is not None,
                "actions_by_kind": dict(self._ly_totals["actions"]),
                "decision_records": int(self._ly_totals["records"]),
                "final_num_shards": (
                    self.emb_owner.view().num_shards
                    if self.emb_owner is not None else 0),
                "final_imbalance": (
                    self.layout_emb_stats().get("emb_shard_imbalance")
                    if self._flip is not None else None),
            },
            "lock_order": {
                "edges": [[a, b] for a, b in lock_edges],
                "violations": len(self.lock_recorder.violations()),
            },
            "replay": replay,
            "acked_training_reports": acked,
            "lost_acked_leases": lost_acked,
            "event_log_entries": len(self.events.entries),
            "event_log_digest": self.events.digest(),
        }
        return result

    @staticmethod
    def _count_by(entries: List[Dict], key: str) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in entries:
            out[e[key]] = out.get(e[key], 0) + 1
        return out

    def _check_replay(self) -> Dict[str, Any]:
        """Journal replay identity: re-reading the journal MUST rebuild
        exactly the live dispatcher's accounting — the soak's
        zero-lost-acked-leases proof."""
        from elasticdl_tpu_torch.master.journal import replay_lines

        self.journal.close()
        with open(self.journal.path, encoding="utf-8") as f:
            lines = f.readlines()
        rr = replay_lines(lines)
        counts = self.dispatcher.counts()
        wasted = self.dispatcher.wasted_work()
        live = {
            "finished_training": counts["finished_training"],
            "failed_permanently": counts["failed_permanently"],
            "records_completed": wasted["records_completed"],
            "wasted_records": wasted["wasted_records"],
        }
        d = rr.dispatcher
        replayed = {
            "finished_training": d.finished_training if d else 0,
            "failed_permanently": d.failed_permanently if d else 0,
            "records_completed": d.records_completed if d else 0,
            "wasted_records": d.wasted_records if d else 0,
        }
        layout_replay = None
        if self.layout_ctl is not None:
            # the layout proof: re-reading the journal rebuilds the FULL
            # decision history (applied + suppressed, per-kind counters)
            # the live controller carries — the takeover never forgets
            # or double-counts a decision
            ly_live = {
                "by_kind": {k: int(v) for k, v
                            in self._ly_totals["actions"].items()},
                "records": int(self._ly_totals["records"]),
            }
            lyr = rr.layout
            ly_replayed = {
                "by_kind": ({k: int(v) for k, v in lyr.by_kind.items()}
                            if lyr else {}),
                "records": lyr.records if lyr else 0,
            }
            layout_replay = {
                "identical": ly_live == ly_replayed,
                "live": ly_live,
                "replayed": ly_replayed,
            }
        return {
            "identical": live == replayed and (
                layout_replay is None or layout_replay["identical"]),
            "live": live,
            "replayed": replayed,
            **({"layout": layout_replay} if layout_replay else {}),
            "journal_records": rr.records,
            "dropped_lines": rr.dropped_lines,
        }

    # -- artifacts ----------------------------------------------------- #

    def _emit_artifacts(self, result: Dict[str, Any]) -> None:
        """The incident CLI's input set: journal copy, health snapshot,
        alerts state (already written by the engine), trace, the event
        log, and the result."""
        from elasticdl_tpu_torch.observability import tracing

        adir = self.artifacts_dir
        shutil.copyfile(
            self.journal.path, os.path.join(adir, "journal.jsonl"))
        now = self.vclock.now()

        def _dump(name: str, doc: Any, **kw: Any) -> None:
            path = os.path.join(adir, name)
            with open(path + ".tmp", "w", encoding="utf-8") as f:
                json.dump(doc, f, indent=2, **kw)
            os.replace(path + ".tmp", path)

        _dump("health.json", {
            "cluster": self.health.snapshot(now=now),
            "goodput": self.goodput.snapshot(),
            "alerts": self.alerts.snapshot(),
        }, sort_keys=True, default=repr)
        _dump("events.json", self.events.entries)
        tracing.get_tracer().close()
        _dump("result.json", result, sort_keys=True)
        result["incident_strict_rc"] = self._incident_check(adir)

    @staticmethod
    def _incident_check(adir: str) -> int:
        """`python -m elasticdl_tpu_torch.observability.incident <dir> --strict`
        over the run's artifacts; report text lands next to them."""
        from elasticdl_tpu_torch.observability import incident

        report = os.path.join(adir, "incident_report.txt")
        with open(report, "w", encoding="utf-8") as out, \
                redirect_stdout(out):
            return incident.main([adir, "--strict"])


def run_scenario(scenario: Scenario, workdir: str,
                 artifacts_dir: Optional[str] = None) -> Dict[str, Any]:
    """Convenience wrapper: one FleetSim run."""
    sim = FleetSim(scenario, workdir, artifacts_dir=artifacts_dir)
    try:
        return sim.run()
    finally:
        try:
            if sim.journal is not None:
                sim.journal.close()
        except Exception:
            logger.debug("journal close after run failed", exc_info=True)
