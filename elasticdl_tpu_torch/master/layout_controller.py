"""Closed-loop embedding LAYOUT controller: skew signals drive the
tier's data layout instead of an operator.

The autoscaler (master/autoscaler.py, ISSUE 14) closed the observe→
decide loop for WORLD SIZE; this module closes it for the embedding
tier's layout — the second loop ROADMAP 4 calls for. A popularity flip
(the hourly reality of online-ads embedding traffic, 2501.10546) leaves
hot shards saturated and cold replicas wasting RAM even though every
sensor needed to react already streams through the fleet series: the
Space-Saving sketch's `hot_id_share` (PR 11), per-shard load shares,
`edl_fleet_emb_shard_imbalance`, and PR 13's cache-hit-collapse alert.
ElasWave (2510.00606) argues the reaction must be native to the
training system, not bolted on — same posture as the autoscaler, same
skeleton on purpose:

- **Signals** (subscription, never polling the sensors' internals):
  `AlertEngine.add_hook` delivers `embedding_shard_imbalance` (the
  split / replica fan-out signal), `embedding_cache_hit_collapse` and
  `embedding_pull_p99` (the hot-set-moved signals) ONSETS. Per-shard
  load shares and each worker's sketch head ride the heartbeat stats
  payload as compact strings (`emb_shard_loads` / `emb_hot_ids`,
  embedding/tier.tier_stats — decode_stats keeps strings, truncated at
  64 chars, so the exporters pre-budget). Hooks only RECORD — decisions
  happen in `evaluate()`, on the master's wait-poll cadence.

- **Actions**, through a pluggable target (`bind_target`), all via the
  ShardMapOwner's journaled mutation surface:
  * `replica_fanout` — per-shard replica counts re-derived from load
    shares: hot shards gain read replicas, cold shards drop to
    primary-only (single-phase `emb_replica_map` record — replicas are
    pull-only, so no exactly-once fence is needed);
  * `split` / `merge` — shard count doubles (or halves) through the
    existing two-phase `emb_reshard_begin→commit` fence; the stores
    re-key rows, seq watermarks, and delta logs locally
    (store.split_resident / merge_resident — the hard correctness
    case, pinned by tests/test_embedding_layout.py);
  * `hot_promote` / `hot_demote` — the aggregated sketch head becomes
    the worker-replicated ultra-hot set (`emb_hot_ids` record; clients
    pin the rows, the delta-sync lane keeps them fresh), demoted when
    the decayed sketch stops voting for it.

- **Robust by construction**, exactly like the autoscaler:
  * a COST MODEL in BLOCKED-READ-SECONDS gates every action: never
    touch the layout unless the projected read-stall relief over
    `horizon_s` exceeds the migration's projected stall (seeded from
    ``bench.py embedding_tier``'s measured reshard `recovery_s` via
    `--layout_migrate_cost_s`, EWMA-updated from real migrations);
  * PER-KIND cooldowns plus signal HOLD (hysteresis): a replica
    fan-out five minutes ago must not cool down a pending split, but
    the same kind never fires twice inside its own window;
  * shard-count bounds and a per-job ACTION BUDGET cap blast radius —
    at most ONE action per evaluate() pass;
  * every decision — including every SUPPRESSED one, with its reason —
    is a journaled ``layout`` record replayed at master takeover
    (journal.LayoutState), so a restarted master inherits cooldowns
    and never double-fires; applied decisions are durable BEFORE the
    action runs;
  * NO DATA means HOLD: a fleet whose workers stopped reporting shard
    loads gets no layout changes — absence of telemetry is never read
    as balance.

- **Observability**: `edl_layout_*` metrics, `layout.<kind>` trace
  spans, edge-triggered `layout.suppressed` events, a flight-ring
  record per action, and an incident-CLI section summarizing the
  decision history out of the journal.

Direct `ShardMapOwner` layout mutations outside this module and the
existing reshard entry points are flagged by edl-lint **EDL503**
(`layout-mutation-outside-policy`) — the mirror of EDL501: ad-hoc
layout paths must not bypass the cost gate, the cooldowns, or the
journaled decision history.

Stdlib-only and jax-free like the rest of the master's control plane.
See docs/elasticity.md ("Layout autoscaling").
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from elasticdl_tpu_torch.common.log_utils import default_logger
from elasticdl_tpu_torch.master.journal import LayoutState
from elasticdl_tpu_torch.observability import tracing
from elasticdl_tpu_torch.observability.registry import default_registry

logger = default_logger(__name__)

#: action kinds (bounded vocabulary; journal + metric label values)
KINDS = ("replica_fanout", "split", "merge", "hot_promote", "hot_demote")

#: suppression reasons (bounded vocabulary; journal + metric label
#: values — every suppressed decision carries exactly one of these)
SUPPRESS_REASONS = (
    "no_target", "unsupported", "resharding_in_flight", "no_data",
    "cooldown", "budget_exhausted", "at_max_shards", "at_min_shards",
    "not_co_owned", "cost_gate", "no_change", "action_failed",
)

#: the alert rules this engine subscribes to (observability/alerts.py
#: default rule set; a custom --alert_rules file keeps the loop alive
#: by keeping these names)
IMBALANCE_RULE = "embedding_shard_imbalance"
CACHE_RULE = "embedding_cache_hit_collapse"
PULL_RULE = "embedding_pull_p99"

#: heartbeat stats keys the controller aggregates (compact comma-joined
#: strings — embedding/tier.tier_stats budgets them under decode_stats'
#: 64-char string truncation so a cut never lands mid-number)
SHARD_LOADS_KEY = "emb_shard_loads"
HOT_IDS_KEY = "emb_hot_ids"

_reg = default_registry()
_LC_ACTIONS = _reg.counter(
    "edl_layout_actions_total",
    "closed-loop layout actions applied", labels=("kind",))
_LC_SUPPRESSED = _reg.counter(
    "edl_layout_suppressed_total",
    "layout decisions suppressed (edge-triggered per (kind, reason))",
    labels=("reason",))
_LC_BUDGET = _reg.gauge(
    "edl_layout_budget_remaining",
    "layout actions left in this job's budget")
_LC_COOLDOWN = _reg.gauge(
    "edl_layout_cooldown_active",
    "1 while any per-kind layout cooldown window is open")
_LC_PENDING = _reg.gauge(
    "edl_layout_pending_signals",
    "layout signals recorded by the hooks, not yet decided")
_LC_SHARDS = _reg.gauge(
    "edl_layout_num_shards", "current embedding shard count")
_LC_REPLICAS = _reg.gauge(
    "edl_layout_replica_total", "total read replicas across all shards")
_LC_HOT = _reg.gauge(
    "edl_layout_hot_ids", "size of the worker-replicated ultra-hot set")


class LayoutCostModel:
    """Projected-cost gate for layout decisions.

    The unit is BLOCKED-READ-SECONDS: a layout migration stalls the
    tier's read path roughly `migrate_cost_s` per shard it touches
    (fence + re-key + client refresh — exactly what ``bench.py
    embedding_tier`` measures as the reshard leg's `recovery_s`, which
    seeds the estimate via `--layout_migrate_cost_s`); an action's
    projected gain is the read stall it relieves per second, accrued
    over `horizon_s`. The estimate is updated online from observed
    migration durations with an EWMA, so a tier whose re-keys are warm
    gates cheaper than one paying cold installs. Thread-safe (the
    action path observes, the wait loop reads)."""

    def __init__(self, migrate_cost_s: float = 0.16,
                 horizon_s: float = 120.0, ewma: float = 0.5):
        self._lock = threading.Lock()
        self._cost_s = max(0.001, float(migrate_cost_s))  # guarded_by: _lock
        self._observed = 0                                # guarded_by: _lock
        self.horizon_s = max(1.0, float(horizon_s))
        self._ewma = min(1.0, max(0.0, float(ewma)))

    @property
    def migrate_cost_s(self) -> float:
        with self._lock:
            return self._cost_s

    @property
    def observed_migrations(self) -> int:
        with self._lock:
            return self._observed

    def observe_migration(self, seconds: float) -> None:
        """Feed one measured layout-migration duration (never raises)."""
        try:
            seconds = float(seconds)
        except (TypeError, ValueError):
            return
        if seconds <= 0:
            return
        with self._lock:
            self._observed += 1
            self._cost_s = (
                (1.0 - self._ewma) * self._cost_s + self._ewma * seconds
            )

    # ------------------------------------------------------------------ #
    # per-kind projections (blocked-read-seconds over the horizon)

    def project(self, kind: str, ctx: Dict) -> Dict[str, float]:
        """{'gain_s', 'cost_s'} for one candidate action. First-order on
        purpose — the gate's job is to refuse migrations whose stall
        bill exceeds what they can plausibly relieve, not to be a
        placement optimizer:

        - replica_fanout: each ADDED replica is one shard copy's worth
          of stall; the relief is the excess load the hot shards shed —
          gain = (imbalance - 1) * horizon, cost = cost * added;
        - split: every resident shard re-keys under the fence, but the
          hottest shard's load halves — gain = (imbalance - 1) *
          horizon, cost = cost * num_shards;
        - merge: a maintenance action — bounded fixed gain (fewer
          shards to fence, sync, and checkpoint), cost = cost * new_n;
        - hot_promote: one delta-lane push; the relief is the traffic
          share the pinned head stops sending to owners — gain =
          hot_share * horizon;
        - hot_demote: near-free (clients just unpin) with a small fixed
          gain (stale pins stop masking the live distribution).
        """
        cost_unit = self.migrate_cost_s
        h = self.horizon_s
        imb = max(0.0, float(ctx.get("imbalance") or 0.0))
        if kind == "replica_fanout":
            added = max(0, int(ctx.get("replicas_added") or 0))
            return {
                "gain_s": round(max(0.0, imb - 1.0) * h, 3),
                # dropping replicas is free; only installs stall reads
                "cost_s": round(cost_unit * max(1, added), 3),
            }
        if kind == "split":
            n = max(1, int(ctx.get("num_shards") or 1))
            return {
                "gain_s": round(max(0.0, imb - 1.0) * h, 3),
                "cost_s": round(cost_unit * n, 3),
            }
        if kind == "merge":
            n = max(1, int(ctx.get("num_shards") or 1))
            return {
                "gain_s": round(0.05 * h, 3),
                "cost_s": round(cost_unit * (n // 2), 3),
            }
        if kind == "hot_promote":
            share = min(1.0, max(0.0, float(ctx.get("hot_share") or 0.0)))
            return {
                "gain_s": round(share * h, 3),
                "cost_s": round(cost_unit, 3),
            }
        if kind == "hot_demote":
            return {
                "gain_s": round(0.02 * h, 3),
                "cost_s": round(cost_unit * 0.1, 3),
            }
        return {"gain_s": 0.0, "cost_s": float("inf")}


def parse_loads(raw: object, num_shards: int) -> Optional[List[float]]:
    """Parse one worker's `emb_shard_loads` payload string ("0.42,0.01,
    ...", per-shard load shares) — None for anything malformed or
    mismatched (a mixed-version worker degrades to no-data, never to a
    crash in the master's poll loop)."""
    if not isinstance(raw, str) or not raw:
        return None
    out: List[float] = []
    for tok in raw.split(","):
        try:
            out.append(max(0.0, float(tok)))
        except ValueError:
            return None
    if len(out) != num_shards:
        return None
    return out


def parse_hot_ids(raw: object) -> List[int]:
    """Parse one worker's `emb_hot_ids` payload string ("17,3,942", the
    sketch head, hottest first). Tolerant of a truncated tail token —
    the exporter pre-budgets under 64 chars, but a foreign build may
    not."""
    if not isinstance(raw, str) or not raw:
        return []
    out: List[int] = []
    for tok in raw.split(","):
        try:
            out.append(int(tok))
        except ValueError:
            break
    return out


class StoreLayoutTarget:
    """Action adapter over in-process stores (bench, tests, local runs):
    the owner map mutates first (journaled), then every store reconciles
    synchronously — install/drop replicas, re-key splits/merges and
    confirm them so the two-phase plan commits inside the call.

    `stores` maps worker id -> EmbeddingShardStore; `pool_fn` returns
    the live worker ids replicas may land on (defaults to the store
    keys)."""

    def __init__(self, owner, stores: Dict[int, object],
                 pool_fn: Optional[Callable[[], List[int]]] = None):
        self._owner = owner
        self._stores = stores
        self._pool_fn = pool_fn or (lambda: sorted(stores))

    def view(self):
        return self._owner.view()

    def pool(self) -> List[int]:
        return list(self._pool_fn())

    def supports(self, kind: str) -> bool:
        return kind in KINDS

    # -- actions ---------------------------------------------------- #

    def apply_replicas(self, counts: Sequence[int]) -> bool:
        view = self._owner.update_replicas(counts, self.pool())
        for wid, store in self._stores.items():
            assigned = {
                (t.name, s)
                for s in view.shards_replicated_on(wid)
                for t in view.tables
            }
            for key in list(store.resident_replicas()):
                if key not in assigned:
                    store.release_replica(*key)
            for table, s in sorted(assigned):
                if (table, s) in store.resident_replicas():
                    continue
                primary = self._stores.get(view.owner_of(s))
                if primary is None:
                    continue
                store.install_replica(
                    table, s, primary.extract_shard(table, s))
            store.set_delta_logging(any(
                view.replicas_of(s) for s in range(view.num_shards)))
            store.adopt_version(view.version)
        return True

    def apply_split(self) -> bool:
        view, moves = self._owner.begin_split()
        for wid, store in self._stores.items():
            if store.resident_shards():
                created = store.split_resident(view)
                self._owner.confirm_moves(view.version, created)
            else:
                store.adopt_version(view.version)
        return not self._owner.view().resharding

    def apply_merge(self) -> bool:
        view, moves = self._owner.begin_merge()
        for wid, store in self._stores.items():
            if store.resident_shards():
                created = store.merge_resident(view)
                self._owner.confirm_moves(view.version, created)
            else:
                store.adopt_version(view.version)
        return not self._owner.view().resharding

    def apply_hot_ids(self, ids: Sequence[int]) -> bool:
        view = self._owner.set_hot_ids(ids)
        for store in self._stores.values():
            store.adopt_version(view.version)
        return True


class OwnerLayoutTarget:
    """Action adapter for the distributed (gRPC) master: mutates the
    journaled owner map only; workers adopt the new layout at their
    next map refresh (`WorkerTierRuntime.on_world_change` / a stale-map
    retry). Splits and merges are UNSUPPORTED on this path — remote
    stores re-key at task boundaries, which the two-phase fence cannot
    bound yet — so the policy suppresses them as `unsupported` instead
    of journaling an applied decision that cannot complete (same
    contract as the autoscaler's grow-on-plain-training rule)."""

    def __init__(self, owner, membership=None):
        self._owner = owner
        self._membership = membership

    def view(self):
        return self._owner.view()

    def pool(self) -> List[int]:
        if self._membership is None:
            return []
        return [
            w.worker_id for w in self._membership.alive_workers()
            if w.led_by is None
        ]

    def supports(self, kind: str) -> bool:
        return kind in ("replica_fanout", "hot_promote", "hot_demote")

    def apply_replicas(self, counts: Sequence[int]) -> bool:
        pool = self.pool()
        if not pool:
            return False
        self._owner.update_replicas(counts, pool)
        return True

    def apply_split(self) -> bool:
        return False

    def apply_merge(self) -> bool:
        return False

    def apply_hot_ids(self, ids: Sequence[int]) -> bool:
        self._owner.set_hot_ids(ids)
        return True


class LayoutController:
    """The policy engine. One instance per master; `evaluate()` runs on
    the wait-poll cadence and never raises."""

    #: a shard is "hot" past this multiple of the mean load share —
    #: each further multiple earns one more read replica
    FANOUT_HOT_FACTOR = 2.0

    #: a split needs the imbalance alert's condition to persist AND the
    #: measured imbalance to clear this floor (replica fan-out is the
    #: cheaper first response; splitting re-keys everything)
    SPLIT_IMBALANCE = 3.0

    #: merge candidate when measured imbalance stays under this and the
    #: shard count sits above its bootstrap value
    MERGE_IMBALANCE = 1.25

    #: an id must be voted hot by this fraction of reporting workers to
    #: promote (a single worker's local skew is not fleet skew)
    PROMOTE_QUORUM = 0.5

    def __init__(
        self,
        *,
        journal=None,
        cost_model: Optional[LayoutCostModel] = None,
        max_shards: int = 0,         # 0 = never split past bootstrap
        min_shards: int = 1,
        max_replicas: int = 2,
        hot_k: int = 16,
        cooldown_s: float = 60.0,
        hold_s: float = 15.0,
        action_budget: int = 16,
        clock: Callable[[], float] = time.time,
    ):
        self._journal = journal
        self.cost = cost_model or LayoutCostModel()
        self.max_shards = max(0, int(max_shards))
        self.min_shards = max(1, int(min_shards))
        self.max_replicas = max(0, int(max_replicas))
        self.hot_k = max(0, int(hot_k))
        self.cooldown_s = max(0.0, float(cooldown_s))
        self.hold_s = max(0.0, float(hold_s))
        self.action_budget = max(0, int(action_budget))
        # wall clock ON PURPOSE (not monotonic): last_ts_by_kind is
        # journaled and must survive a master restart — a monotonic
        # stamp from a dead process is meaningless to its successor
        self._clock = clock
        self._lock = threading.Lock()
        # alert onsets recorded by the hook; decided by evaluate()
        self._signals: Dict[str, Dict] = {}           # guarded_by: _lock
        # decay candidates (merge / hot_demote) have no alert onset —
        # evaluate() tracks their own first_seen for the hold window
        self._decay_seen: Dict[str, float] = {}       # guarded_by: _lock
        # latest aggregated worker telemetry (evaluate() input)
        self._loads: Optional[List[float]] = None     # guarded_by: _lock
        self._hot_votes: Dict[int, int] = {}          # guarded_by: _lock
        self._reporters = 0                           # guarded_by: _lock
        # replayed (or fresh) durable state: per-kind cooldowns + the
        # spent budget survive master takeover via `layout` records
        snap = journal.layout_snapshot() if journal is not None else None
        self._state = snap if snap is not None else LayoutState()
        if snap is not None and (snap.actions_applied or snap.records):
            logger.warning(
                "layout controller state restored from control journal: "
                "%d action(s) applied (budget %d), last action ts %.0f — "
                "per-kind cooldowns inherited",
                snap.actions_applied, self.action_budget,
                snap.last_action_ts,
            )
        # edge-trigger state for suppressed-decision journaling: one
        # record per (kind, reason) TRANSITION, not one per poll
        self._last_suppressed: Dict[str, str] = {}    # guarded_by: _lock
        self._last_decision: Optional[Dict] = None    # guarded_by: _lock
        self._target = None
        self._alerts = None
        # the shard count the tier bootstrapped with: merge never folds
        # below it (learned from the first view we see)
        self._baseline_shards = 0
        _LC_BUDGET.set(max(0, self.action_budget - self._state.actions_applied))

    # ------------------------------------------------------------------ #
    # wiring

    def subscribe(self, alerts=None) -> "LayoutController":
        """Attach to the alert seam. Hooks only record — a decision
        needs the aggregated fleet picture evaluate() assembles."""
        if alerts is not None:
            self._alerts = alerts
            alerts.add_hook(self._on_alert)
        return self

    def bind_target(self, target) -> None:
        """Attach the action surface (StoreLayoutTarget /
        OwnerLayoutTarget / a test double). Until one is bound every
        decision suppresses with `no_target` — journaled, so a
        mis-wired deployment is visible in the record stream."""
        self._target = target

    # ------------------------------------------------------------------ #
    # signal intake (hook thread; record only, never act)

    def _on_alert(self, info: Dict) -> None:
        rule = str(info.get("rule", ""))
        if rule not in (IMBALANCE_RULE, CACHE_RULE, PULL_RULE):
            return
        with self._lock:
            sig = dict(info)
            sig["first_seen"] = self._clock()
            self._signals[rule] = sig
        logger.info("layout controller: %s signal recorded "
                    "(hold %.0fs before action)", rule, self.hold_s)

    def observe_workers(self, records: Sequence[Dict],
                        num_shards: int) -> None:
        """Aggregate the fleet's per-shard load shares and sketch heads
        out of the heartbeat stats records Membership already holds
        (master/main.py passes `membership.health_snapshot()` on the
        poll cadence; fleetsim and the bench feed scripted records).
        Never raises — a malformed payload is a non-reporter."""
        loads_acc: Optional[List[float]] = None
        n_load = 0
        votes: Dict[int, int] = {}
        n_hot = 0
        for rec in records:
            loads = parse_loads(rec.get(SHARD_LOADS_KEY), num_shards)
            if loads is not None:
                if loads_acc is None:
                    loads_acc = [0.0] * num_shards
                for s, v in enumerate(loads):
                    loads_acc[s] += v
                n_load += 1
            hot = parse_hot_ids(rec.get(HOT_IDS_KEY))
            if hot:
                n_hot += 1
                for i in hot:
                    votes[i] = votes.get(i, 0) + 1
        with self._lock:
            self._loads = (
                [v / n_load for v in loads_acc]
                if loads_acc is not None and n_load else None
            )
            self._hot_votes = votes
            self._reporters = max(n_load, n_hot)

    # ------------------------------------------------------------------ #
    # the decision pass

    def evaluate(self, now: Optional[float] = None,
                 workers: Optional[Sequence[Dict]] = None) -> Optional[Dict]:
        """One decision pass; returns the applied decision (or None).
        Never raises — the master's wait loop calls this
        unconditionally. `workers` (heartbeat stats records) refreshes
        the load/hot-set aggregate before deciding."""
        try:
            return self._evaluate(now, workers)
        except Exception:
            logger.exception("layout evaluation failed; holding")
            return None

    def _evaluate(self, now: Optional[float],
                  workers: Optional[Sequence[Dict]]) -> Optional[Dict]:
        now = self._clock() if now is None else now
        target = self._target
        view = target.view() if target is not None else None
        if view is not None:
            if self._baseline_shards == 0 and view.num_shards:
                self._baseline_shards = view.num_shards
            _LC_SHARDS.set(view.num_shards)
            _LC_REPLICAS.set(sum(
                len(view.replicas_of(s)) for s in range(view.num_shards)))
            _LC_HOT.set(len(view.hot_ids))
        if workers is not None and view is not None:
            self.observe_workers(workers, view.num_shards)
        with self._lock:
            signals = dict(self._signals)
            loads = list(self._loads) if self._loads is not None else None
            votes = dict(self._hot_votes)
            reporters = self._reporters
        # re-validate against the live alert engine: a signal whose
        # condition cleared is dropped, never acted on stale — and a
        # condition that PERSISTS past an applied action re-arms (alert
        # hooks fire on onset only; an action consumes its signal, so
        # without this a still-imbalanced tier would never get a second
        # action). The re-armed signal gets a fresh first_seen: the
        # hold window runs again before the follow-up.
        if self._alerts is not None:
            active = {a.get("rule"): a for a in self._alerts.active()}
            for rule in list(signals):
                if rule not in active:
                    with self._lock:
                        self._signals.pop(rule, None)
                    signals.pop(rule, None)
                    # a NEW incident later must journal its own
                    # suppressions (edge-trigger resets with the signal)
                    self._clear_suppress_edges()
            for rule in (IMBALANCE_RULE, CACHE_RULE, PULL_RULE):
                info = active.get(rule)
                if info is not None and rule not in signals:
                    sig = dict(info)
                    sig["first_seen"] = now
                    with self._lock:
                        self._signals[rule] = sig
                    signals[rule] = sig
        _LC_PENDING.set(len(signals))
        _LC_COOLDOWN.set(
            1 if any(self._in_cooldown(k, now) for k in KINDS) else 0)
        if view is None or not view.owners:
            return None
        pool_fn = getattr(target, "pool", None)
        pool_size = len(pool_fn()) if pool_fn is not None else 0
        candidates = self._candidates(view, signals, loads, votes,
                                      reporters, now, pool_size)
        for kind, sig, ctx in candidates:
            if now - float(sig.get("first_seen") or now) < self.hold_s:
                continue   # hysteresis hold: not yet a decision
            decision = self._decide(kind, sig, ctx, view, now)
            if decision is not None:
                return decision
        return None

    # -- candidate derivation --------------------------------------- #

    def _candidates(self, view, signals, loads, votes, reporters, now,
                    pool_size=0):
        """Order matters: the cheapest adequate response first.
        replica_fanout (copy a few shards) > hot_promote (one push) >
        split (re-key everything) > the decay actions (hot_demote,
        merge) which only surface when no pressure signal is active."""
        out = []
        imb_sig = signals.get(IMBALANCE_RULE)
        hot_sig = signals.get(CACHE_RULE) or signals.get(PULL_RULE)
        imbalance = self._imbalance(loads, view.num_shards)
        if imb_sig is not None and loads is not None:
            counts = self._desired_replica_counts(loads, view, pool_size)
            current = [len(view.replicas_of(s))
                       for s in range(view.num_shards)]
            if counts != current:
                out.append(("replica_fanout", imb_sig, {
                    "imbalance": imbalance,
                    "counts": counts,
                    "replicas_added": sum(
                        max(0, c - k) for c, k in zip(counts, current)),
                }))
        if (hot_sig is not None or imb_sig is not None) and votes:
            desired = self._desired_hot_ids(votes, reporters)
            if desired and tuple(desired) != tuple(view.hot_ids):
                sig = hot_sig or imb_sig
                out.append(("hot_promote", sig, {
                    "hot_share": float(sig.get("value") or 0.0)
                    if sig is hot_sig and sig.get("rule") != CACHE_RULE
                    else 0.5,
                    "hot_ids": desired,
                }))
        if (imb_sig is not None and loads is not None
                and imbalance >= self.SPLIT_IMBALANCE):
            out.append(("split", imb_sig, {
                "imbalance": imbalance,
                "num_shards": view.num_shards,
            }))
        if not signals:
            # decay actions: only in calm weather, with their own hold
            # clocks (there is no alert onset to date them from)
            if view.hot_ids and votes is not None:
                desired = self._desired_hot_ids(votes, reporters)
                stale = [i for i in view.hot_ids if i not in desired]
                if stale:
                    sig = self._decay_signal("hot_demote", now)
                    out.append(("hot_demote", sig, {
                        "hot_ids": desired,
                        "demoted": len(stale),
                    }))
                else:
                    self._clear_decay("hot_demote")
            else:
                self._clear_decay("hot_demote")
            if (loads is not None and self._baseline_shards
                    and view.num_shards > self._baseline_shards
                    and imbalance > 0.0
                    and imbalance <= self.MERGE_IMBALANCE):
                sig = self._decay_signal("merge", now)
                out.append(("merge", sig, {
                    "imbalance": imbalance,
                    "num_shards": view.num_shards,
                }))
            else:
                self._clear_decay("merge")
        else:
            self._clear_decay("hot_demote")
            self._clear_decay("merge")
        return out

    def _decay_signal(self, kind: str, now: float) -> Dict:
        with self._lock:
            first = self._decay_seen.setdefault(kind, now)
        return {"rule": f"decay:{kind}", "first_seen": first}

    def _clear_decay(self, kind: str) -> None:
        with self._lock:
            self._decay_seen.pop(kind, None)
            self._last_suppressed.pop(kind, None)

    def _clear_suppress_edges(self) -> None:
        with self._lock:
            self._last_suppressed.clear()

    @staticmethod
    def _imbalance(loads: Optional[List[float]], num_shards: int) -> float:
        """max/mean of the aggregated per-shard load shares — the same
        definition as the tier's `emb_shard_imbalance` export, computed
        over the FLEET aggregate instead of one worker's view. 0.0 = no
        data (never reads as balanced)."""
        if not loads or num_shards < 1:
            return 0.0
        total = sum(loads)
        if total <= 0:
            return 0.0
        mean = total / num_shards
        return max(loads) / mean if mean > 0 else 0.0

    def _desired_replica_counts(self, loads: List[float], view,
                                pool_size: int = 0) -> List[int]:
        """One replica per mean-load multiple past FANOUT_HOT_FACTOR,
        capped at max_replicas AND at what the pool can host (a shard's
        owner cannot also be its replica) — cold shards drop to
        primary-only. Without the pool cap a 2-worker fleet wanting 2
        replicas would chase an unreachable assignment forever."""
        n = view.num_shards
        total = sum(loads) or 1.0
        mean = total / n
        cap = self.max_replicas
        if pool_size > 0:
            cap = min(cap, pool_size - 1)
        counts = []
        for s in range(n):
            share = loads[s] if s < len(loads) else 0.0
            if cap > 0 and mean > 0 and share >= self.FANOUT_HOT_FACTOR * mean:
                counts.append(max(0, min(cap, int(share / mean) - 1)))
            else:
                counts.append(0)
        return counts

    def _desired_hot_ids(self, votes: Dict[int, int],
                         reporters: int) -> List[int]:
        """Ids a quorum of reporting workers called hot, hottest first,
        top hot_k — fleet consensus, not one worker's local skew."""
        if not votes or reporters <= 0 or self.hot_k <= 0:
            return []
        need = max(1, int(self.PROMOTE_QUORUM * reporters))
        ranked = sorted(
            ((c, i) for i, c in votes.items() if c >= need),
            key=lambda t: (-t[0], t[1]),
        )
        return sorted(i for _, i in ranked[: self.hot_k])

    # -- gates -------------------------------------------------------- #

    def _in_cooldown(self, kind: str, now: float) -> bool:
        last = self._state.last_ts_by_kind.get(kind, 0.0)
        # wall-clock delta ON PURPOSE: last_ts_by_kind is journal-
        # replayed state from a possibly-dead process, the one clock
        # restarts share — edl-lint: disable=EDL406
        return bool(last > 0 and now - last < self.cooldown_s)

    def _decide(self, kind: str, signal: Dict, ctx: Dict, view,
                now: float) -> Optional[Dict]:
        """Run one candidate through the gates; apply or suppress.
        Returns the applied decision dict, or None when suppressed."""
        target = self._target
        if target is None:
            self._suppress(kind, signal, "no_target", now)
            return None
        supports = getattr(target, "supports", None)
        if supports is not None and not supports(kind):
            # structurally impossible on this deployment shape (e.g. a
            # split on the distributed owner-only target): suppress
            # BEFORE the budget/cooldown spend
            self._suppress(kind, signal, "unsupported", now)
            return None
        if view.resharding:
            # one two-phase plan at a time — overlapping plans would
            # break the exactly-once confirm accounting
            self._suppress(kind, signal, "resharding_in_flight", now)
            return None
        if kind == "split":
            if self.max_shards and view.num_shards * 2 > self.max_shards:
                self._suppress(kind, signal, "at_max_shards", now,
                               num_shards=view.num_shards)
                return None
            if not self.max_shards:
                self._suppress(kind, signal, "at_max_shards", now,
                               num_shards=view.num_shards)
                return None
        if kind == "merge":
            if (view.num_shards // 2 < self.min_shards
                    or view.num_shards // 2 < self._baseline_shards
                    or view.num_shards % 2 != 0):
                self._suppress(kind, signal, "at_min_shards", now,
                               num_shards=view.num_shards)
                return None
            half = view.num_shards // 2
            if any(view.owners[s] != view.owners[s + half]
                   for s in range(half)):
                # the local-interleave merge needs co-owned child pairs;
                # a reshard may later co-locate them — suppress, don't
                # pay a cross-host migration the cost model can't price
                self._suppress(kind, signal, "not_co_owned", now)
                return None
        if self._state.actions_applied >= self.action_budget:
            self._suppress(kind, signal, "budget_exhausted", now)
            return None
        if self._in_cooldown(kind, now):
            self._suppress(kind, signal, "cooldown", now)
            return None
        proj = self.cost.project(kind, ctx)
        if proj["gain_s"] <= proj["cost_s"]:
            self._suppress(kind, signal, "cost_gate", now, **proj)
            return None
        return self._apply(kind, signal, ctx, view, now, proj)

    # ------------------------------------------------------------------ #
    # outcomes

    def _signal_fields(self, kind: str, signal: Dict, ctx: Dict) -> Dict:
        out: Dict = {"kind": kind}
        rule = signal.get("rule", "")
        if str(rule).startswith("decay:"):
            out["reason"] = f"decay ({rule})"
        else:
            out["reason"] = (
                f"alert {rule} value {signal.get('value')} "
                f"{signal.get('op', '>')} threshold "
                f"{signal.get('threshold')}"
            )
        for k in ("imbalance", "replicas_added", "num_shards",
                  "hot_share", "demoted"):
            if k in ctx:
                out[k] = ctx[k]
        if "counts" in ctx:
            out["replica_counts"] = list(ctx["counts"])
        if "hot_ids" in ctx:
            out["hot_id_count"] = len(ctx["hot_ids"])
        return out

    def _journal_append(self, rec: Dict, await_commit: bool) -> None:
        if self._journal is None:
            return
        commit = self._journal.append("layout", **rec)
        if await_commit:
            # durable-before-action: the decision must survive a crash
            # landing mid-action, or the successor would re-fire it
            commit.wait()

    def _suppress(self, kind: str, signal: Dict, reason: str, now: float,
                  **extra) -> None:
        """Journal + count a suppressed decision — edge-triggered per
        (kind, reason): the record stream must say WHY the loop held,
        without one line per poll while it holds."""
        with self._lock:
            if self._last_suppressed.get(kind) == reason:
                return
            self._last_suppressed[kind] = reason
        info = self._signal_fields(kind, signal, extra)
        info.update(
            decision="suppressed", suppress_reason=reason,
            ts=round(now, 3),
        )
        # reason values come from the bounded SUPPRESS_REASONS
        # vocabulary at every call site: edl-lint: disable=EDL405
        _LC_SUPPRESSED.inc(reason=reason)
        with self._lock:
            self._state.records += 1
            self._last_decision = dict(info)
        try:
            self._journal_append(info, await_commit=False)
        except Exception:
            logger.exception("layout suppressed-decision journal failed")
        tracing.event("layout.suppressed", **{
            k: v for k, v in info.items()
            if k not in ("decision", "replica_counts")
        })
        logger.info(
            "layout %s suppressed (%s): %s",
            kind, reason, info.get("reason", ""),
        )

    def _apply(self, kind: str, signal: Dict, ctx: Dict, view, now: float,
               proj: Dict) -> Optional[Dict]:
        info = self._signal_fields(kind, signal, ctx)
        info.update(
            decision="applied", ts=round(now, 3),
            map_version=view.version, **proj,
        )
        with tracing.span(f"layout.{kind}", **{
            k: v for k, v in info.items()
            if k in ("imbalance", "num_shards", "replicas_added",
                     "hot_id_count", "gain_s", "cost_s", "map_version")
        }) as span:
            # journal FIRST, fsync-awaited: a crash between here and the
            # action replays the decision as taken (the per-kind
            # cooldown holds, no double-fire) — the same conservative
            # ordering as autoscale/world_version commits
            try:
                self._journal_append(info, await_commit=True)
            except Exception:
                logger.exception(
                    "layout decision could not be journaled; action "
                    "ABORTED (an unjournaled layout change would re-fire "
                    "after takeover)")
                span.set(outcome="journal_failed")
                return None
            with self._lock:
                self._state.actions_applied += 1
                self._state.last_action_ts = max(
                    self._state.last_action_ts, now)
                self._state.by_kind[kind] = (
                    self._state.by_kind.get(kind, 0) + 1)
                self._state.last_ts_by_kind[kind] = max(
                    self._state.last_ts_by_kind.get(kind, 0.0), now)
                self._state.records += 1
                self._last_decision = dict(info)
                self._last_suppressed.pop(kind, None)
                self._decay_seen.pop(kind, None)
                # the acted signal is consumed: a persisting condition
                # re-fires via the alert engine's next onset / the next
                # telemetry aggregation, and evaluate() re-validates
                rule = signal.get("rule")
                self._signals.pop(rule, None)
            ok = False
            t0 = time.perf_counter()
            try:
                if kind == "replica_fanout":
                    ok = bool(self._target.apply_replicas(ctx["counts"]))
                elif kind == "split":
                    ok = bool(self._target.apply_split())
                elif kind == "merge":
                    ok = bool(self._target.apply_merge())
                else:
                    ok = bool(self._target.apply_hot_ids(
                        ctx.get("hot_ids", [])))
            except Exception:
                logger.exception("layout %s action failed", kind)
            if ok and kind in ("replica_fanout", "split", "merge"):
                # feed the cost model the MEASURED migration duration —
                # the EWMA keeps the gate honest about this fleet's
                # actual re-key/install costs
                self.cost.observe_migration(time.perf_counter() - t0)
            span.set(outcome="ok" if ok else "action_failed")
        # kind values come from the bounded KINDS vocabulary:
        # edl-lint: disable=EDL405
        _LC_ACTIONS.inc(kind=kind)
        _LC_BUDGET.set(max(0, self.action_budget - self._state.actions_applied))
        _LC_COOLDOWN.set(1)
        if not ok:
            # the decision stands (the cooldown holds — hammering a
            # failing target would be its own flap mode); the failure
            # journals its own record for the postmortem, and the next
            # alert onset / telemetry pass re-derives the candidate
            self._suppress(kind, signal, "action_failed", now)
        try:
            from elasticdl_tpu_torch.observability import flight as flight_lib

            flight_lib.get_recorder().record(
                "layout", kind, **{
                    k: v for k, v in info.items()
                    if k not in ("decision", "kind", "replica_counts")
                },
            )
        except Exception:
            logger.exception("layout flight record failed")
        logger.warning(
            "LAYOUT %s applied: %s (projected relief %.1fs > stall "
            "%.1fs; budget %d/%d)",
            kind, info.get("reason", ""), proj["gain_s"], proj["cost_s"],
            self._state.actions_applied, self.action_budget,
        )
        return info

    # ------------------------------------------------------------------ #
    # introspection

    def snapshot(self) -> Dict:
        """Cheap state view (/healthz enrichment + bench artifacts)."""
        now = self._clock()
        with self._lock:
            actions_applied = self._state.actions_applied
            by_kind = dict(self._state.by_kind)
            last_ts_by_kind = dict(self._state.last_ts_by_kind)
            records = self._state.records
            last = dict(self._last_decision) if self._last_decision else None
            pending = len(self._signals)
            loads = list(self._loads) if self._loads is not None else None
        return {
            "enabled": self._target is not None,
            "actions_applied": actions_applied,
            "action_budget": self.action_budget,
            "budget_remaining": max(
                0, self.action_budget - actions_applied),
            "by_kind": by_kind,
            "cooldown_s": self.cooldown_s,
            "cooldowns_active": {
                k: bool(t > 0 and now - t < self.cooldown_s)
                for k, t in last_ts_by_kind.items()
            },
            "hold_s": self.hold_s,
            "max_shards": self.max_shards,
            "max_replicas": self.max_replicas,
            "hot_k": self.hot_k,
            "migrate_cost_s": round(self.cost.migrate_cost_s, 4),
            "horizon_s": self.cost.horizon_s,
            "pending_signals": pending,
            "fleet_imbalance": round(self._imbalance(
                loads, len(loads) if loads else 0), 4) if loads else None,
            "last_decision": last,
            "decision_records": records,
        }


def from_config(cfg, journal=None) -> Optional[LayoutController]:
    """Build the engine from a JobConfig (None when --layout_autoscale
    is off — the default: layout stays human-operated). The caller
    subscribes and binds the target."""
    if not getattr(cfg, "layout_autoscale", False):
        return None
    return LayoutController(
        journal=journal,
        cost_model=LayoutCostModel(
            migrate_cost_s=cfg.layout_migrate_cost_s,
            horizon_s=cfg.layout_horizon_s,
        ),
        max_shards=cfg.layout_max_shards,
        max_replicas=cfg.layout_max_replicas,
        hot_k=cfg.layout_hot_k,
        cooldown_s=cfg.layout_cooldown_s,
        hold_s=cfg.layout_hold_s,
        action_budget=cfg.layout_actions_max,
    )
