"""Worker membership registry — the failure detector + rendezvous version.

Reference parity: two components merged. The reference's instance manager
watches k8s pod events to detect worker death
(elasticdl/python/master/k8s_instance_manager.py), and its rendezvous server
bumps a world version so Horovod re-forms
(elasticdl/python/master/rendezvous_server.py). Here both jobs are served by
one registry: liveness from heartbeats (works with or without k8s; the pod
watcher feeds in too), and a monotonically increasing `membership_version`
workers watch to know when to re-form the `jax.distributed` mesh.

Heartbeats optionally carry a compact stats payload (gRPC metadata,
observability/health.py): the registry keeps a ROLLING per-worker health
record — last step-time quantiles, records/s, prefetch depth, breaker
state, rescale phase — which `ClusterHealth` scores for stragglers. The
records deliberately survive re-register and even death/revival (they are
history about a worker id, not liveness state), so a reconnect after a
master hiccup does not blind the straggler detector for a full window.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from elasticdl_tpu_torch.common.log_utils import default_logger
from elasticdl_tpu_torch.master.journal import CommitGate
from elasticdl_tpu_torch.observability import tracing
from elasticdl_tpu_torch.observability.registry import default_registry

logger = default_logger(__name__)

_reg = default_registry()
_MB_REGISTERED = _reg.counter(
    "edl_membership_registrations_total", "worker registrations")
_MB_DEATHS = _reg.counter(
    "edl_membership_deaths_total", "workers declared dead (any reason)")
_MB_REAPED = _reg.counter(
    "edl_membership_reaped_total",
    "workers declared dead by heartbeat-timeout reaping")
_MB_ALIVE = _reg.gauge(
    "edl_membership_alive_workers",
    "currently alive logical workers (cohort leaders + singletons)")
_MB_VERSION = _reg.gauge(
    "edl_membership_version", "current membership version")
_MB_MEMBERS = _reg.gauge(
    "edl_membership_cohort_members",
    "registered cohort member processes (telemetry entities; liveness "
    "rides their leader's beat)")
_MB_BEATS = _reg.counter(
    "edl_membership_heartbeats_total", "heartbeat RPCs applied")
_MB_COALESCED = _reg.counter(
    "edl_membership_coalesced_beats_total",
    "member beats carried inside a leader's single heartbeat")


@dataclass
class WorkerInfo:
    worker_id: int
    name: str
    last_heartbeat: float
    model_version: int = 0
    alive: bool = True
    # cohort membership: set = this entry is a member PROCESS of the
    # cohort led by that worker id. Members are telemetry entities — they
    # are skipped by reap scans (their liveness IS the leader's beat),
    # never bump the membership version, and die with their leader.
    led_by: Optional[int] = None
    # embedding data-plane endpoint this worker serves its owning shards
    # from (embedding/data_plane.py; "" = none). Journaled with the join
    # so a successor master replays the owner address book — the
    # shard-map response carries it to every tier client.
    data_addr: str = ""


class Membership(CommitGate):
    #: server-side ceiling on one cohort's member registrations — the
    #: membership twin of the servicer's MAX_LEASE_BATCH: a corrupted or
    #: hostile RegisterWorker must not allocate unbounded WorkerInfo
    #: entries, build an unbounded journal batch line, and hold the
    #: membership lock throughout, all from one RPC
    MAX_COHORT_MEMBERS = 4096

    def __init__(self, heartbeat_timeout_s: float = 30.0, journal=None,
                 clock: Callable[[], float] = time.time):
        self._lock = threading.Lock()
        # Injectable time source: the fleet simulator (fleetsim/) drives
        # membership on a compressed virtual clock; production uses
        # time.time. Every liveness stamp and reap decision reads this.
        self._clock = clock
        # Crash durability (master/journal.py): join/death transitions are
        # committed inside the _lock critical sections that apply them, so
        # a restarted master replays the registry instead of telling every
        # reconnecting worker to shut down as an unknown. None = volatile.
        self._journal = journal
        self._workers: Dict[int, WorkerInfo] = {}    # guarded_by: _lock
        # Alive-entry indexes: the reap scan, the per-poll fleet rollup,
        # and the address book must not pay O(all entries ever seen) once
        # the registry holds thousands of dead/member rows. Invariant:
        # _alive_leaders == {id: alive, led_by is None}, _alive_members ==
        # {id: alive, led_by set}, _cohort_members[leader] == every member
        # id ever registered under that leader (alive or dead — the
        # idempotent re-register key space).        # guarded_by: _lock
        self._alive_leaders: set = set()
        self._alive_members: set = set()
        self._cohort_members: Dict[int, set] = {}
        # last journal Commit of the current critical section (see _j)
        self._pending_commit = None                  # guarded_by: _lock
        # rolling per-worker heartbeat telemetry (health.py records);
        # NEVER reset by reregister/mark_dead — see module docstring
        self._health: Dict[int, Dict] = {}           # guarded_by: _lock
        self._next_id = 0                            # guarded_by: _lock
        self._version = 0                            # guarded_by: _lock
        self._timeout = heartbeat_timeout_s
        # registration-before-start contract (wired while the master is
        # single-threaded); mark_dead iterates OUTSIDE the lock on purpose —
        # callbacks re-enter the dispatcher
        self._death_callbacks: List[Callable[[int], None]] = []
        snap = journal.membership_snapshot() if journal is not None else None
        if snap is not None:
            self._restore(snap)

    def _restore(self, snap) -> None:  # holds: _lock (construction)
        """Rebuild the registry from a replayed journal (master recovery).
        Runs during __init__ (single-threaded). Liveness clocks restart at
        takeover: every restored-alive worker gets a fresh heartbeat stamp,
        so the reaper gives reconnecting workers a full timeout window
        before declaring anyone dead under the new generation."""
        now = self._clock()
        for w in snap.workers:
            wid = int(w["worker_id"])
            led_by = w.get("led_by")
            info = WorkerInfo(
                worker_id=wid,
                name=w.get("name", ""),
                last_heartbeat=now,
                alive=bool(w.get("alive", True)),
                led_by=int(led_by) if led_by is not None else None,
                data_addr=str(w.get("data_addr") or ""),
            )
            self._workers[wid] = info
            if info.led_by is not None:
                self._cohort_members.setdefault(info.led_by, set()).add(wid)
            self._index_locked(info)
        self._next_id = snap.next_id
        self._version = snap.version
        _MB_ALIVE.set(self._alive_count_locked())
        _MB_VERSION.set(self._version)
        logger.warning(
            "membership restored from control journal: v%d, %d worker(s) "
            "(%d alive)", self._version, len(self._workers),
            self._alive_count_locked(),
        )

    def _index_locked(self, info: WorkerInfo) -> None:
        """Re-sync the alive indexes with info.alive. Must run after every
        liveness flip or entry (re)insert, inside _lock."""
        leaders, members = self._alive_leaders, self._alive_members
        if info.led_by is None:
            members.discard(info.worker_id)
            (leaders.add if info.alive else leaders.discard)(info.worker_id)
        else:
            leaders.discard(info.worker_id)
            (members.add if info.alive else members.discard)(info.worker_id)

    # _j / _take_commit_locked / _await come from CommitGate
    # (master/journal.py) — the ack-after-fsync plumbing shared with the
    # dispatcher, e.g. the RegisterWorker response that tells a worker
    # its id must not leave before the join is on disk

    def add_death_callback(self, cb: Callable[[int], None]) -> None:
        """cb(worker_id) fires when a worker is declared dead — wire this to
        TaskDispatcher.recover_tasks."""
        self._death_callbacks.append(cb)

    def register(self, name: str, preferred_id: int = -1,
                 data_addr: str = "") -> WorkerInfo:
        with self._lock:
            wid = None
            if preferred_id >= 0:
                existing = self._workers.get(preferred_id)
                if existing is None or not existing.alive:
                    wid = preferred_id
            if wid is None:
                wid = self._next_id
            self._next_id = max(self._next_id, wid + 1)
            info = WorkerInfo(worker_id=wid, name=name,
                              last_heartbeat=self._clock(),
                              data_addr=data_addr or "")
            self._workers[wid] = info
            self._index_locked(info)
            self._version += 1
            version = self._version     # the version THIS join created
            self._j(
                "member_join", worker_id=wid, name=name, version=version,
                data_addr=info.data_addr,
            )
            _MB_REGISTERED.inc()
            _MB_ALIVE.set(self._alive_count_locked())
            _MB_VERSION.set(self._version)
            logger.info(
                "worker %d (%s) joined; membership v%d, %d alive",
                wid, name, self._version, self._alive_count_locked(),
            )
            commit = self._take_commit_locked()
        # ack-after-fsync: the response hands the worker an id it will
        # lease under — the join must be durable first
        self._await(commit)
        tracing.event(
            "membership.join", worker_id=info.worker_id, worker_name=name,
            version=version,
        )
        return info

    def register_members(
        self, leader_id: int, names: Sequence[str]
    ) -> List[WorkerInfo]:
        """Register a cohort leader's member processes in ONE pass under
        the lock and ONE journal commit (cohort-aggregated membership).

        Members are telemetry entities, not rendezvous participants: the
        cohort is still ONE logical worker, so member joins bump NO
        membership version (a bump would re-form the mesh) and reap scans
        skip them (their liveness is the leader's beat). Idempotent by
        (name, leader): a leader re-registering after a master restart
        gets the same member ids back, revived if the outage reaped the
        cohort."""
        if len(names) > self.MAX_COHORT_MEMBERS:
            raise ValueError(
                f"cohort of {len(names)} members exceeds the "
                f"{self.MAX_COHORT_MEMBERS}-member registration cap"
            )
        with self._lock:
            leader = self._workers.get(leader_id)
            if leader is None or leader.led_by is not None:
                raise KeyError(
                    f"worker {leader_id} is not a registered cohort leader"
                )
            cohort = self._cohort_members.setdefault(leader_id, set())
            by_name = {
                self._workers[mid].name: self._workers[mid]
                for mid in cohort
                if self._workers[mid].led_by == leader_id
            }
            infos: List[WorkerInfo] = []
            records: List[Tuple[str, Dict]] = []
            now = self._clock()
            for name in names:
                info = by_name.get(name)
                if info is None:
                    info = WorkerInfo(
                        worker_id=self._next_id, name=name,
                        last_heartbeat=now, led_by=leader_id,
                    )
                    self._next_id += 1
                    self._workers[info.worker_id] = info
                    cohort.add(info.worker_id)
                    self._index_locked(info)
                    records.append((
                        "member_join",
                        {"worker_id": info.worker_id, "name": name,
                         "version": self._version, "led_by": leader_id},
                    ))
                else:
                    info.last_heartbeat = now
                    if not info.alive:
                        info.alive = True
                        self._index_locked(info)
                        records.append((
                            "member_join",
                            {"worker_id": info.worker_id, "name": name,
                             "version": self._version, "led_by": leader_id},
                        ))
                infos.append(info)
            commit = (
                self._journal.append_many(records)
                if self._journal is not None and records else None
            )
            _MB_MEMBERS.set(self._member_count_locked())
        self._await(commit)
        if records:
            logger.info(
                "cohort leader %d registered %d member process(es) "
                "(%d new/revived; no version bump)",
                leader_id, len(names), len(records),
            )
        return infos

    def reregister(self, worker_id: int, name: str,
                   data_addr: str = "") -> WorkerInfo:
        """Idempotent re-register of a worker that was ALREADY a member —
        the reconnect handshake after a master restart. A live worker's
        entry is refreshed in place with NO version bump (the worker set
        did not change, so the cohort must not re-form); a worker that was
        reaped during the outage is revived (that IS a membership change —
        version bumps and the join is journaled). Unknown ids fall through
        to a fresh registration, so a journal-less master still converges.
        """
        with self._lock:
            info = self._workers.get(worker_id)
            if info is not None:
                info.name = name or info.name
                info.last_heartbeat = self._clock()
                revived = not info.alive
                addr_changed = bool(data_addr) and data_addr != info.data_addr
                if data_addr:
                    info.data_addr = data_addr
                if revived:
                    info.alive = True
                    self._index_locked(info)
                    self._version += 1
                    self._j(
                        "member_join", worker_id=worker_id, name=info.name,
                        version=self._version, data_addr=info.data_addr,
                    )
                    _MB_ALIVE.set(self._alive_count_locked())
                    _MB_VERSION.set(self._version)
                elif addr_changed:
                    # no version bump (the worker set did not change) but
                    # the address book did — journal the join record so a
                    # successor's replay routes to the NEW endpoint
                    self._j(
                        "member_join", worker_id=worker_id, name=info.name,
                        version=self._version, data_addr=info.data_addr,
                    )
                version = self._version
                logger.info(
                    "worker %d (%s) re-registered%s; membership v%d",
                    worker_id, name, " (revived)" if revived else "", version,
                )
            commit = self._take_commit_locked()
        if info is not None:
            self._await(commit)
        if info is None:
            return self.register(name, preferred_id=worker_id,
                                 data_addr=data_addr)
        tracing.event(
            "membership.reregister", worker_id=worker_id, worker_name=name,
            version=version,
        )
        return info

    def heartbeat(self, worker_id: int, model_version: int = 0,
                  stats: "Dict | None" = None,
                  members: "Sequence[Tuple[int, int, Dict | None]] | None"
                  = None) -> bool:
        """Liveness stamp + (optionally) a telemetry record update. `stats`
        is the decoded heartbeat payload (observability/health.py) or None
        for a liveness-only beat — old workers mid-rolling-restart send
        none and lose nothing but the straggler detector's view of them.

        `members` is a cohort leader's coalesced beat: (member_id,
        model_version, stats) per member process, applied under the SAME
        lock acquisition and timestamp — one RPC, one lock pass, N
        telemetry records. Beats for ids this leader does not lead are
        ignored (a stale leader must not refresh someone else's member)."""
        with self._lock:
            info = self._workers.get(worker_id)
            if info is None or not info.alive:
                return False
            now = self._clock()
            self._beat_locked(info, now, model_version, stats)
            coalesced = 0
            for mid, m_version, m_stats in members or ():
                member = self._workers.get(mid)
                if member is None or member.led_by != worker_id:
                    continue
                member.alive = True    # the leader's beat IS their liveness
                self._alive_members.add(mid)
                self._beat_locked(member, now, m_version, m_stats)
                coalesced += 1
        _MB_BEATS.inc()
        if coalesced:
            _MB_COALESCED.inc(coalesced)
        return True

    def _beat_locked(self, info: WorkerInfo, now: float,
                     model_version: int, stats: "Dict | None") -> None:
        info.last_heartbeat = now
        info.model_version = max(info.model_version, model_version)
        if stats:
            prev = self._health.get(info.worker_id)
            rec = dict(stats)
            rec.update(
                worker_id=info.worker_id,
                name=info.name,
                model_version=info.model_version,
                updated_at=now,
                updates=(prev.get("updates", 0) + 1) if prev else 1,
            )
            self._health[info.worker_id] = rec

    def mark_dead(self, worker_id: int, reason: str = "") -> bool:
        """Declare a worker dead. A cohort LEADER's death cascades to its
        member processes in the same critical section — members die with
        their leader under ONE version bump and ONE journal commit, so a
        thousand-process cohort going away costs the same as a singleton
        (O(cohorts), not O(workers))."""
        with self._lock:
            info = self._workers.get(worker_id)
            if info is None or not info.alive:
                return False
            info.alive = False
            self._index_locked(info)
            if info.led_by is None:
                self._version += 1      # a LOGICAL worker left the world
            version = self._version
            records = [
                ("member_death", {"worker_id": worker_id, "version": version})
            ]
            cascade = []
            if info.led_by is None:
                # alive-index intersection, not a full-registry walk: a
                # thousand-cohort fleet reaps one leader in O(its members)
                cascade = [
                    self._workers[mid] for mid in sorted(
                        self._cohort_members.get(worker_id, set())
                        & self._alive_members
                    )
                    if self._workers[mid].led_by == worker_id
                ]
                for member in cascade:
                    member.alive = False
                    self._index_locked(member)
                    records.append((
                        "member_death",
                        {"worker_id": member.worker_id, "version": version},
                    ))
            if self._journal is not None:
                self._pending_commit = self._journal.append_many(records)
            commit = self._take_commit_locked()
            _MB_DEATHS.inc(1 + len(cascade))
            _MB_ALIVE.set(self._alive_count_locked())
            _MB_MEMBERS.set(self._member_count_locked())
            _MB_VERSION.set(self._version)
            logger.warning(
                "worker %d declared dead (%s)%s; membership v%d, %d alive",
                worker_id, reason or "unknown",
                f" with {len(cascade)} cohort member(s)" if cascade else "",
                self._version, self._alive_count_locked(),
            )
        self._await(commit)
        tracing.event(
            "membership.death", worker_id=worker_id, reason=reason or "",
            version=version, cascade=len(cascade),
        )
        for cb in self._death_callbacks:
            cb(worker_id)
            for member in cascade:
                cb(member.worker_id)
        return True

    def reap(self) -> List[int]:
        """Declare workers dead whose heartbeats lapsed. Returns their ids.
        Cohort members are SKIPPED — their liveness is the leader's beat
        (they die with it via the mark_dead cascade) — and the scan walks
        the alive-leader INDEX, so the cost is O(alive cohorts +
        singletons): dead rows and member processes are never touched."""
        now = self._clock()
        with self._lock:
            lapsed = sorted(
                wid
                for wid in self._alive_leaders
                if now - self._workers[wid].last_heartbeat > self._timeout
            )
        for wid in lapsed:
            if self.mark_dead(wid, reason="heartbeat timeout"):
                _MB_REAPED.inc()
        return lapsed

    def _alive_count_locked(self) -> int:
        """Alive LOGICAL workers (cohort leaders + singletons): member
        processes are not rendezvous participants and must not inflate
        num_workers (LR scaling, wait-for-workers logic)."""
        return len(self._alive_leaders)

    def _member_count_locked(self) -> int:
        return len(self._alive_members)

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    def alive_count(self) -> int:
        with self._lock:
            return self._alive_count_locked()

    def alive_workers(self) -> List[WorkerInfo]:
        with self._lock:
            return [
                self._workers[wid]
                for wid in sorted(self._alive_leaders | self._alive_members)
            ]

    def data_addresses(self) -> List[Tuple[int, str]]:
        """The owner address book (ISSUE 15): (worker id, data-plane
        endpoint) for every alive logical worker that registered one —
        what the shard-map response carries so tier clients can route
        pull/push over gRPC to whichever process owns a shard."""
        with self._lock:
            return sorted(
                (wid, self._workers[wid].data_addr)
                for wid in self._alive_leaders
                if self._workers[wid].data_addr
            )

    def health_snapshot(self) -> List[Dict]:
        """Telemetry records (copies) of currently-ALIVE workers — the
        straggler scorer's input. Dead workers keep their records in the
        store (revival resumes the history) but are not scored. Walks the
        alive indexes, not the full registry, so the per-poll fleet
        rollup stays O(alive) when dead history dominates."""
        with self._lock:
            return [
                dict(self._health[wid])
                for wid in sorted(self._alive_leaders | self._alive_members)
                if wid in self._health
            ]
