"""Closed-loop autoscaler: health signals drive rescale decisions.

Every sensor this needs already exists — the robust-z straggler scorer
(PR 6) with its pluggable hook, the per-step phase profiler saying WHY a
worker is slow (PR 8), the declarative alert engine whose `add_hook` was
explicitly left as "ROADMAP 3's autoscaler seam" (PR 11), and the
goodput ledger pricing every wasted second (PR 12) — yet every rescale
was still human-initiated, so a confirmed straggler degraded the whole
fleet until someone noticed. This module closes the observe→decide loop
(ROADMAP 3; elastic multi-tenant scheduling, 1909.11985, treats
utilization-driven world-size adjustment as the entire point of
elasticity; ElasWave, 2510.00606, argues the rescale decision must be
native to the training system, not bolted on by an operator):

- **Signals** (subscription, never polling the sensors' internals):
  `ClusterHealth.add_hook` delivers straggler ONSETS; `AlertEngine
  .add_hook` delivers `dispatcher_backlog_per_worker` (the grow signal)
  and `fleet_data_wait_dominant` (the shrink signal: an input-bound
  fleet gets nothing from more workers) onsets. Hooks only RECORD —
  decisions happen in `evaluate()`, on the master's existing wait-poll
  cadence, single-threaded like the rest of the control loop.

- **Actions**, through a pluggable target (`bind_target`): `evict` a
  confirmed straggler by shrinking past it — drain-first via the
  existing preempt path (the heartbeat `evict` bit for plain workers;
  the quiesce-checkpoint resize path for cohorts) so its in-flight
  records retire under a drain checkpoint instead of re-training —
  `grow` when backlog-per-worker sustains above threshold, `shrink`
  when the fleet phase profile says data_wait dominates.

- **Robust by construction**:
  * a COST MODEL gates every action: never rescale unless the projected
    goodput gain over `horizon_s` exceeds the projected rescale cost
    (seeded from ``bench.py rescale``'s own `time_to_recovery_s` via
    `--autoscale_rescale_cost_s`, then updated online from the process
    manager's observed re-formation durations);
  * a COOLDOWN window plus signal HOLD (hysteresis) prevents flapping:
    a signal must persist `hold_s` before it is acted on, and actions
    are at least `cooldown_s` apart;
  * min/max world bounds and a per-job ACTION BUDGET cap blast radius —
    at most ONE action per evaluate() pass, ever;
  * every decision — including every SUPPRESSED decision, with its
    reason — is journaled as an ``autoscale`` record and replayed at
    master takeover (journal.AutoscaleState), so a restarted master
    inherits cooldown/budget state instead of immediately re-firing;
    applied decisions are durable BEFORE the action runs (the same
    durable-before-announce ordering as world_version commits);
  * NO DATA means HOLD: when the fleet series go dark (all workers
    churning mid-poll) the rules carry alerts forward and this engine
    takes no action — absence of telemetry is never read as health.

- **Observability**: each action emits an `autoscale.<kind>` trace
  span, `edl_autoscale_*` metrics, and a flight-ring context record;
  suppressions are edge-triggered `autoscale.suppressed` events (one
  per (kind, reason) transition, not one per poll).

Direct `ProcessManager` resize/evict calls outside this module and the
client entry points are flagged by edl-lint **EDL501**
(`rescale-action-outside-policy`): ad-hoc code paths must not bypass
cooldown and journaling.

Stdlib-only and jax-free like the rest of the master's control plane.
See docs/elasticity.md ("Closed-loop autoscaling").
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

from elasticdl_tpu_torch.common.log_utils import default_logger
from elasticdl_tpu_torch.master.journal import AutoscaleState
from elasticdl_tpu_torch.observability import tracing
from elasticdl_tpu_torch.observability.registry import default_registry

logger = default_logger(__name__)

#: action kinds (bounded vocabulary; journal + metric label values)
KINDS = ("evict", "grow", "shrink")

#: suppression reasons (bounded vocabulary; journal + metric label
#: values — every suppressed decision carries exactly one of these)
SUPPRESS_REASONS = (
    "no_target", "unsupported", "cooldown", "budget_exhausted",
    "world_at_min", "world_at_max", "cost_gate", "conflicting_signals",
    "action_failed", "damped", "reversal_hold",
)

#: the two alert rules this engine subscribes to (observability/alerts.py
#: default rule set; a custom --alert_rules file keeps the loop alive by
#: keeping these names)
GROW_RULE = "dispatcher_backlog_per_worker"
SHRINK_RULE = "fleet_data_wait_dominant"

_reg = default_registry()
_AS_ACTIONS = _reg.counter(
    "edl_autoscale_actions_total",
    "closed-loop rescale actions applied", labels=("kind",))
_AS_SUPPRESSED = _reg.counter(
    "edl_autoscale_suppressed_total",
    "autoscale decisions suppressed (edge-triggered per (kind, reason))",
    labels=("reason",))
_AS_BUDGET = _reg.gauge(
    "edl_autoscale_budget_remaining",
    "rescale actions left in this job's autoscale budget")
_AS_COOLDOWN = _reg.gauge(
    "edl_autoscale_cooldown_active",
    "1 while the post-action cooldown window is open")
_AS_PENDING = _reg.gauge(
    "edl_autoscale_pending_signals",
    "signals recorded by the hooks, not yet decided")
_AS_REVERSALS = _reg.counter(
    "edl_autoscale_reversals_total",
    "applied grow->shrink or shrink->grow reversals within one cost "
    "horizon — the oscillation count a noisy signal produces")


class CostModel:
    """Projected-cost gate for rescale decisions.

    The unit is WORKER-SECONDS of goodput: a rescale costs every worker
    in the world roughly `rescale_cost_s` of non-training time (settle +
    handoff + compile — exactly what `bench.py rescale` measures as
    `time_to_recovery_s`, which seeds the initial estimate via
    `--autoscale_rescale_cost_s`); an action's projected gain is the
    goodput it recovers per second, accrued over `horizon_s`. The
    estimate is updated online from observed re-formation durations
    (ProcessManager's reform timer feeds `observe_recovery`) with an
    EWMA, so a fleet whose compiles are warm gates cheaper than one
    paying cold recompiles. Thread-safe (the reform watcher thread
    observes, the wait loop reads)."""

    def __init__(self, rescale_cost_s: float = 10.0,
                 horizon_s: float = 300.0, ewma: float = 0.5):
        self._lock = threading.Lock()
        self._cost_s = max(0.001, float(rescale_cost_s))  # guarded_by: _lock
        self._observed = 0                                # guarded_by: _lock
        self.horizon_s = max(1.0, float(horizon_s))
        self._ewma = min(1.0, max(0.0, float(ewma)))

    @property
    def rescale_cost_s(self) -> float:
        with self._lock:
            return self._cost_s

    @property
    def observed_recoveries(self) -> int:
        with self._lock:
            return self._observed

    def observe_recovery(self, seconds: float) -> None:
        """Feed one measured re-formation duration (never raises)."""
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
    # per-kind gain projections (worker-seconds over the horizon)

    def project(self, kind: str, world: int, signal: Dict) -> Dict[str, float]:
        """{'gain_s', 'cost_s'} for one candidate action. The models are
        deliberately first-order — the gate's job is to refuse rescales
        whose recovery bill exceeds what they can plausibly recover, not
        to be a scheduler:

        - evict: a synchronous fleet runs at the straggler's pace, so
          the whole world recovers `slowdown_frac` of its wall —
          gain = slowdown_frac * world * horizon;
        - grow: the sustained backlog guarantees the added worker a full
          horizon of work — gain = horizon;
        - shrink: an input-bound worker's wall was mostly data_wait —
          the freed chip-seconds are gain = data_wait_frac * horizon.

        Cost is always `rescale_cost_s` paid by every surviving worker.
        """
        cost_unit = self.rescale_cost_s
        world = max(1, int(world))
        if kind == "evict":
            p50 = float(signal.get("step_time_p50_s") or 0.0)
            med = float(signal.get("median_step_time_s") or 0.0)
            slowdown = max(0.0, (p50 - med) / p50) if p50 > 0 else 0.0
            return {
                "gain_s": round(slowdown * world * self.horizon_s, 3),
                "cost_s": round(cost_unit * world, 3),
            }
        if kind == "grow":
            return {
                "gain_s": round(self.horizon_s, 3),
                "cost_s": round(cost_unit * world, 3),
            }
        if kind == "shrink":
            frac = float(signal.get("value") or 0.0)
            return {
                "gain_s": round(min(1.0, max(0.0, frac)) * self.horizon_s, 3),
                "cost_s": round(cost_unit * max(1, world - 1), 3),
            }
        return {"gain_s": 0.0, "cost_s": float("inf")}


class ProcessManagerTarget:
    """Action adapter over the local ProcessManager (client/local.py
    wires it; only the launcher owns the manager).

    Eviction semantics by mode:

    - plain workers (evaluation/prediction fleets): the SERVICER sets the
      heartbeat `evict` bit, the worker drains through its existing
      preempt path (drain checkpoint + preempted report → the remainder
      requeues FRONT, retry-free, like a death) and exits EX_TEMPFAIL;
      the manager's `evict_worker` marks it never-relaunch so the exit
      retires the slot instead of respawning it.
    - cohorts: one member is one slot of an all-or-nothing SPMD world,
      so eviction IS a drain-first shrink — `remove_worker()` rides the
      planned-resize path (quiesce → checkpoint → teardown → re-form at
      N-1). In the local manager every slot respawns on this host, so
      which slot leaves is immaterial; a multi-host instance manager
      maps the eviction to the straggler's host instead.
    """

    def __init__(self, manager, servicer=None, membership=None):
        self._manager = manager
        self._servicer = servicer
        self._membership = membership

    def rebind(self, servicer=None, membership=None) -> None:
        """Adopt a restarted master's servicer/membership (the manager
        itself survives master restarts — client/local.py rebinds)."""
        if servicer is not None:
            self._servicer = servicer
        if membership is not None:
            self._membership = membership

    def world_size(self) -> int:
        if self._manager.cfg.num_processes > 1:
            return self._manager.pending_size() or self._manager.cohort_size
        if self._membership is not None:
            return self._membership.alive_count()
        return self._manager.cfg.num_workers

    def _plain_training(self) -> bool:
        from elasticdl_tpu_torch.common.constants import JobType

        cfg = self._manager.cfg
        return cfg.num_processes <= 1 and cfg.job_type in (
            JobType.TRAINING_ONLY, JobType.TRAINING_WITH_EVALUATION,
        )

    def supports(self, kind: str) -> bool:
        """Capability probe the policy consults BEFORE spending budget/
        cooldown: a structurally impossible action (growing a plain
        TRAINING fleet — independent replicas with no gradient exchange,
        the same rule ProcessManager.add_worker enforces) must suppress
        as `unsupported`, not journal an applied decision that always
        fails and burns the budget the fleet may later need for a
        legitimate eviction."""
        if kind == "grow":
            return not self._plain_training()
        return True

    def grow(self) -> bool:
        self._manager.add_worker()
        return True

    def shrink(self) -> bool:
        if self._manager.cfg.num_processes > 1:
            self._manager.remove_worker()
            return True
        # plain fleet (evaluation/prediction workers): shrink IS an
        # eviction of the most recently added capacity, through the same
        # drain handshake — remove_worker() is cohort-only by contract
        if self._membership is None:
            return False
        alive = [
            w.worker_id for w in self._membership.alive_workers()
            if w.led_by is None
        ]
        if not alive:
            return False
        return self.evict(max(alive))

    def evict(self, worker_id: int, worker_name: str = "") -> bool:
        if self._manager.cfg.num_processes > 1 or "#p" in worker_name:
            # cohort member: drain-first shrink (the resize quiesce IS
            # the drain — a checkpoint lands before teardown)
            self._manager.remove_worker()
            return True
        if self._servicer is not None:
            # the wire half of the drain handshake: the worker's next
            # heartbeat carries evict=True and it drains + exits
            self._servicer.request_evict(worker_id)
        return self._manager.evict_worker(worker_id)


class K8sInstanceTarget:
    """Action adapter over the master-owned K8sInstanceManager (the
    instance_manager='k8s' flavor — master/main.py wires it at start).
    Pod deletion already drives lease recovery identically to eviction;
    the heartbeat evict bit still runs first so the pod drains before
    the grace period kills it."""

    def __init__(self, manager, servicer=None, membership=None):
        self._manager = manager
        self._servicer = servicer
        self._membership = membership

    def world_size(self) -> int:
        if self._membership is not None:
            return self._membership.alive_count()
        return self._manager.cfg.num_workers

    def supports(self, kind: str) -> bool:
        """k8s pods are plain workers: growing a TRAINING fleet would
        train divergent replicas (K8sInstanceManager.add_worker enforces
        it) — suppress as `unsupported` instead of burning budget."""
        if kind == "grow":
            from elasticdl_tpu_torch.common.constants import JobType

            return self._manager.cfg.job_type not in (
                JobType.TRAINING_ONLY, JobType.TRAINING_WITH_EVALUATION,
            )
        return True

    def grow(self) -> bool:
        self._manager.add_worker()
        return True

    def shrink(self) -> bool:
        # no per-worker signal to pick from: shed the highest worker id
        # (the most recently added capacity)
        if self._membership is None:
            return False
        alive = [w.worker_id for w in self._membership.alive_workers()]
        if not alive:
            return False
        wid = max(alive)
        if self._servicer is not None:
            self._servicer.request_evict(wid)
        self._manager.remove_worker(wid)
        return True

    def evict(self, worker_id: int, worker_name: str = "") -> bool:
        if self._servicer is not None:
            self._servicer.request_evict(worker_id)
        self._manager.remove_worker(worker_id)
        return True


class Autoscaler:
    """The policy engine. One instance per master; `evaluate()` runs on
    the wait-poll cadence and never raises."""

    #: deadband as a fraction of the rule threshold: with damping on, a
    #: smoothed grow/shrink signal must clear its threshold by this
    #: margin before it is actionable — hovering AT the threshold (the
    #: noisy-signal thrash mode the fleet soak reproduces) stays held
    DAMPING_DEADBAND = 0.1

    def __init__(
        self,
        *,
        journal=None,
        cost_model: Optional[CostModel] = None,
        min_world: int = 1,
        max_world: int = 0,          # 0 = unbounded
        cooldown_s: float = 120.0,
        hold_s: float = 30.0,
        action_budget: int = 8,
        damping: float = 0.0,
        reversal_hold_s: float = 0.0,
        clock: Callable[[], float] = time.time,
    ):
        self._journal = journal
        self.cost = cost_model or CostModel()
        self.min_world = max(1, int(min_world))
        self.max_world = int(max_world)
        self.cooldown_s = max(0.0, float(cooldown_s))
        self.hold_s = max(0.0, float(hold_s))
        self.action_budget = max(0, int(action_budget))
        # signal damping (--autoscale_damping): EWMA smoothing factor in
        # [0, 1) — 0 disables. Grow/shrink decide on the SMOOTHED alert
        # value, and only when it clears the rule threshold by the
        # deadband margin, so one noisy sample cannot flip the loop.
        self.damping = min(0.999, max(0.0, float(damping)))
        # anti-thrash (--autoscale_reversal_hold_s): a grow→shrink or
        # shrink→grow candidate inside this window of the LAST applied
        # opposite action suppresses as `reversal_hold` — the fleet it
        # would resize is still paying for the previous resize
        self.reversal_hold_s = max(0.0, float(reversal_hold_s))
        # wall clock ON PURPOSE (not monotonic): last_action_ts is
        # journaled and must survive a master restart — a monotonic
        # stamp from a dead process is meaningless to its successor
        self._clock = clock
        self._lock = threading.Lock()
        # pending signals recorded by the hooks; decided by evaluate()
        self._stragglers: Dict[int, Dict] = {}        # guarded_by: _lock
        self._grow_signal: Optional[Dict] = None      # guarded_by: _lock
        self._shrink_signal: Optional[Dict] = None    # guarded_by: _lock
        # replayed (or fresh) durable state: cooldown + budget survive
        # master takeover via the journal's autoscale records
        snap = (
            journal.autoscale_snapshot() if journal is not None else None
        )
        self._state = snap if snap is not None else AutoscaleState()
        if snap is not None and (snap.actions_applied or snap.records):
            logger.warning(
                "autoscaler state restored from control journal: %d "
                "action(s) applied (budget %d), last action ts %.0f — "
                "cooldown inherited",
                snap.actions_applied, self.action_budget,
                snap.last_action_ts,
            )
        # edge-trigger state for suppressed-decision journaling: one
        # record per (kind, reason) TRANSITION, not one per poll
        self._last_suppressed: Dict[str, str] = {}    # guarded_by: _lock
        self._last_decision: Optional[Dict] = None    # guarded_by: _lock
        # EWMA of each rule's live alert value (damping > 0 only); decays
        # toward 0 while the alert is inactive         # guarded_by: _lock
        self._smoothed: Dict[str, float] = {}
        # last APPLIED grow/shrink: (kind, ts) — reversal detection.
        # In-memory only: a restarted master starts direction-blind,
        # which errs toward counting/suppressing less, never more.
        self._last_resize: Optional[tuple] = None     # guarded_by: _lock
        self._reversals = 0                           # guarded_by: _lock
        self._target = None
        self._health = None
        self._alerts = None
        _AS_BUDGET.set(max(0, self.action_budget - self._state.actions_applied))

    # ------------------------------------------------------------------ #
    # wiring

    def subscribe(self, health=None, alerts=None) -> "Autoscaler":
        """Attach to the two decision seams. Hooks only record — the
        scorer/engine must survive a policy bug, and a decision needs
        the full fleet picture evaluate() assembles anyway."""
        if health is not None:
            self._health = health
            health.add_hook(self._on_straggler)
        if alerts is not None:
            self._alerts = alerts
            alerts.add_hook(self._on_alert)
        return self

    def bind_target(self, target) -> None:
        """Attach the action surface (ProcessManagerTarget /
        K8sInstanceTarget / a test double). Until one is bound every
        decision suppresses with `no_target` — journaled, so a
        mis-wired deployment is visible in the record stream."""
        self._target = target

    # ------------------------------------------------------------------ #
    # signal intake (hook threads; record only, never act)

    def _on_straggler(self, info: Dict) -> None:
        wid = int(info.get("worker_id", -1))
        if wid < 0:
            return
        with self._lock:
            sig = dict(info)
            sig["first_seen"] = self._clock()
            self._stragglers[wid] = sig
        logger.info(
            "autoscaler: straggler signal recorded for worker %d "
            "(hold %.0fs before action)", wid, self.hold_s,
        )

    def _on_alert(self, info: Dict) -> None:
        rule = str(info.get("rule", ""))
        if rule not in (GROW_RULE, SHRINK_RULE):
            return
        with self._lock:
            sig = dict(info)
            sig["first_seen"] = self._clock()
            if rule == GROW_RULE:
                self._grow_signal = sig
            else:
                self._shrink_signal = sig
        logger.info("autoscaler: %s signal recorded (%s)", rule,
                    "grow" if rule == GROW_RULE else "shrink")

    # ------------------------------------------------------------------ #
    # the decision pass

    def evaluate(self, now: Optional[float] = None) -> Optional[Dict]:
        """One decision pass; returns the applied decision (or None).
        Never raises — the master's wait loop calls this
        unconditionally."""
        try:
            return self._evaluate(now)
        except Exception:
            logger.exception("autoscale evaluation failed; holding")
            return None

    def _evaluate(self, now: Optional[float] = None) -> Optional[Dict]:
        now = self._clock() if now is None else now
        with self._lock:
            stragglers = dict(self._stragglers)
            grow = self._grow_signal
            shrink = self._shrink_signal
        # re-validate against the live sensors: a signal whose condition
        # cleared (or whose sensor went dark — the carried-forward/no-data
        # contract) is dropped or held, never acted on stale
        if self._health is not None and stragglers:
            snap = self._health.snapshot()
            flagged = {
                int(i.get("worker_id", -1)) for i in snap.get("stragglers", ())
            }
            for wid in list(stragglers):
                if wid not in flagged:
                    with self._lock:
                        self._stragglers.pop(wid, None)
                        if not self._stragglers:
                            # a NEW straggler incident later must journal
                            # its own suppressions (edge-trigger resets
                            # with the signal)
                            self._last_suppressed.pop("evict", None)
                    stragglers.pop(wid, None)
                    logger.info(
                        "autoscaler: straggler signal for worker %d "
                        "cleared before action", wid,
                    )
        if self._alerts is not None:
            active_alerts = self._alerts.active()
            active = {a.get("rule") for a in active_alerts}
            if self.damping > 0:
                # EWMA over the LIVE alert value each poll (an inactive
                # alert contributes 0, so the smoothed series decays
                # instead of freezing at its last noisy spike)
                vals = {
                    str(a.get("rule")): float(a.get("value") or 0.0)
                    for a in active_alerts
                    if a.get("rule") in (GROW_RULE, SHRINK_RULE)
                }
                alpha = 1.0 - self.damping
                with self._lock:
                    for rule in (GROW_RULE, SHRINK_RULE):
                        v = vals.get(rule, 0.0)
                        # decay up from a 0 baseline on first sight, so
                        # damping also blunts signal ONSET — seeding with
                        # the first raw sample would let a single spike
                        # through undamped
                        prev = self._smoothed.get(rule, 0.0)
                        self._smoothed[rule] = (
                            alpha * v + (1.0 - alpha) * prev
                        )
            if grow is not None and GROW_RULE not in active:
                with self._lock:
                    self._grow_signal = None
                    self._last_suppressed.pop("grow", None)
                grow = None
            if shrink is not None and SHRINK_RULE not in active:
                with self._lock:
                    self._shrink_signal = None
                    self._last_suppressed.pop("shrink", None)
                shrink = None
        _AS_PENDING.set(
            len(stragglers) + (1 if grow else 0) + (1 if shrink else 0))
        _AS_COOLDOWN.set(1 if self._in_cooldown(now) else 0)
        if grow is not None and shrink is not None:
            # the fleet cannot be simultaneously short of workers and
            # input-bound; acting on either would flap — suppress both
            # and wait for one to clear
            self._suppress("grow", grow, "conflicting_signals", now)
            self._suppress("shrink", shrink, "conflicting_signals", now)
            grow = shrink = None
        # priority: evict (a confirmed straggler degrades everyone) >
        # grow > shrink; at most ONE action per pass (blast radius)
        candidates = []
        for wid, sig in sorted(stragglers.items()):
            candidates.append(("evict", sig))
        if grow is not None:
            candidates.append(("grow", grow))
        if shrink is not None:
            candidates.append(("shrink", shrink))
        for kind, sig in candidates:
            if now - float(sig.get("first_seen") or now) < self.hold_s:
                continue   # hysteresis hold: not yet a decision
            decision = self._decide(kind, sig, now)
            if decision is not None:
                return decision
        return None

    def _in_cooldown(self, now: float) -> bool:
        last = self._state.last_action_ts
        # wall-clock delta ON PURPOSE: last_action_ts is journal-replayed
        # state from a possibly-dead process, the one clock restarts
        # share — edl-lint: disable=EDL406
        return bool(last > 0 and now - last < self.cooldown_s)

    def _decide(self, kind: str, signal: Dict, now: float) -> Optional[Dict]:
        """Run one candidate through the gates; apply or suppress.
        Returns the applied decision dict, or None when suppressed."""
        target = self._target
        if target is None:
            self._suppress(kind, signal, "no_target", now)
            return None
        supports = getattr(target, "supports", None)
        if supports is not None and not supports(kind):
            # structurally impossible on this fleet shape (e.g. growing
            # a plain training job): suppress BEFORE the budget/cooldown
            # spend — an applied-then-always-failing decision would burn
            # the whole action budget against a sustained alert
            self._suppress(kind, signal, "unsupported", now)
            return None
        if self.damping > 0 and kind in ("grow", "shrink"):
            rule = GROW_RULE if kind == "grow" else SHRINK_RULE
            with self._lock:
                smoothed = self._smoothed.get(rule)
            threshold = float(signal.get("threshold") or 0.0)
            op = str(signal.get("op") or ">")
            margin = abs(threshold) * self.DAMPING_DEADBAND
            breached = smoothed is not None and (
                smoothed <= threshold - margin if op in ("<", "<=")
                else smoothed >= threshold + margin
            )
            if not breached:
                self._suppress(
                    kind, signal, "damped", now,
                    smoothed=round(smoothed or 0.0, 3),
                )
                return None
        if self.reversal_hold_s > 0 and kind in ("grow", "shrink"):
            with self._lock:
                last = self._last_resize
            if (last is not None and last[0] != kind
                    and now - last[1] < self.reversal_hold_s):
                self._suppress(
                    kind, signal, "reversal_hold", now,
                    prior_kind=last[0], prior_ts=round(last[1], 3),
                )
                return None
        world = max(1, int(target.world_size()))
        new_world = world + (1 if kind == "grow" else -1)
        if kind in ("evict", "shrink") and new_world < self.min_world:
            self._suppress(kind, signal, "world_at_min", now, world=world)
            return None
        if kind == "grow" and self.max_world and new_world > self.max_world:
            self._suppress(kind, signal, "world_at_max", now, world=world)
            return None
        if self._state.actions_applied >= self.action_budget:
            self._suppress(kind, signal, "budget_exhausted", now, world=world)
            return None
        if self._in_cooldown(now):
            self._suppress(kind, signal, "cooldown", now, world=world)
            return None
        proj = self.cost.project(kind, world, signal)
        if proj["gain_s"] <= proj["cost_s"]:
            self._suppress(
                kind, signal, "cost_gate", now, world=world, **proj)
            return None
        return self._apply(kind, signal, now, world, new_world, proj)

    # ------------------------------------------------------------------ #
    # outcomes

    def _signal_fields(self, kind: str, signal: Dict) -> Dict:
        out: Dict = {"kind": kind}
        if kind == "evict":
            out["worker_id"] = int(signal.get("worker_id", -1))
            out["worker_name"] = str(signal.get("worker_name", ""))
            out["reason"] = (
                f"straggler score {signal.get('score')} "
                f"(p50 {signal.get('step_time_p50_s')}s vs median "
                f"{signal.get('median_step_time_s')}s)"
            )
        else:
            out["reason"] = (
                f"alert {signal.get('rule')} value {signal.get('value')} "
                f"{signal.get('op', '>')} threshold "
                f"{signal.get('threshold')}"
            )
        return out

    def _journal_append(self, rec: Dict, await_commit: bool) -> None:
        if self._journal is None:
            return
        commit = self._journal.append("autoscale", **rec)
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
        info = self._signal_fields(kind, signal)
        info.update(
            decision="suppressed", suppress_reason=reason,
            ts=round(now, 3), **extra,
        )
        # reason values come from the bounded SUPPRESS_REASONS
        # vocabulary at every call site: edl-lint: disable=EDL405
        _AS_SUPPRESSED.inc(reason=reason)
        with self._lock:
            self._state.records += 1
            self._last_decision = dict(info)
        try:
            self._journal_append(info, await_commit=False)
        except Exception:
            logger.exception("autoscale suppressed-decision journal failed")
        tracing.event("autoscale.suppressed", **{
            k: v for k, v in info.items() if k != "decision"
        })
        logger.info(
            "autoscale %s suppressed (%s): %s",
            kind, reason, info.get("reason", ""),
        )

    def _apply(self, kind: str, signal: Dict, now: float, world: int,
               new_world: int, proj: Dict) -> Optional[Dict]:
        info = self._signal_fields(kind, signal)
        info.update(
            decision="applied", ts=round(now, 3), world=world,
            target_world=new_world, **proj,
        )
        with tracing.span(f"autoscale.{kind}", **{
            k: v for k, v in info.items()
            if k in ("worker_id", "world", "target_world", "gain_s", "cost_s")
        }) as span:
            # journal FIRST, fsync-awaited: a crash between here and the
            # action replays the decision as taken (cooldown holds, no
            # double-fire) — the conservative direction, mirroring the
            # world_version durable-before-announce ordering
            try:
                self._journal_append(info, await_commit=True)
            except Exception:
                logger.exception(
                    "autoscale decision could not be journaled; action "
                    "ABORTED (an unjournaled rescale would re-fire after "
                    "takeover)")
                span.set(outcome="journal_failed")
                return None
            reversal = False
            with self._lock:
                self._state.actions_applied += 1
                self._state.last_action_ts = max(
                    self._state.last_action_ts, now)
                self._state.by_kind[kind] = (
                    self._state.by_kind.get(kind, 0) + 1)
                self._state.records += 1
                self._last_decision = dict(info)
                self._last_suppressed.pop(kind, None)
                if kind in ("grow", "shrink"):
                    last = self._last_resize
                    if (last is not None and last[0] != kind
                            and now - last[1] <= self.cost.horizon_s):
                        reversal = True
                        self._reversals += 1
                    self._last_resize = (kind, now)
                if kind == "evict":
                    self._stragglers.pop(info.get("worker_id"), None)
                elif kind == "grow":
                    self._grow_signal = None
                else:
                    self._shrink_signal = None
            if reversal:
                _AS_REVERSALS.inc()
                span.set(reversal=True)
                logger.warning(
                    "autoscale REVERSAL: %s within one horizon of the "
                    "opposite action — the loop is oscillating "
                    "(consider --autoscale_damping / "
                    "--autoscale_reversal_hold_s)", kind,
                )
            ok = False
            try:
                if kind == "evict":
                    ok = bool(self._target.evict(
                        info.get("worker_id", -1),
                        info.get("worker_name", ""),
                    ))
                elif kind == "grow":
                    ok = bool(self._target.grow())
                else:
                    ok = bool(self._target.shrink())
            except Exception:
                logger.exception("autoscale %s action failed", kind)
            span.set(outcome="ok" if ok else "action_failed")
        # kind values come from the bounded KINDS vocabulary:
        # edl-lint: disable=EDL405
        _AS_ACTIONS.inc(kind=kind)
        _AS_BUDGET.set(max(0, self.action_budget - self._state.actions_applied))
        _AS_COOLDOWN.set(1)
        if not ok:
            # the decision stands (cooldown holds — hammering a failing
            # target would be its own flap mode); the failure is its own
            # journal record for the postmortem. The SIGNAL is re-armed:
            # hooks fire only at ONSET, and a continuously-flagged
            # straggler (or still-active alert) produces no new one — a
            # transient target failure must retry after the cooldown,
            # not strand the straggler for the rest of the job. The next
            # evaluate re-validates against the live sensor, so a signal
            # that cleared meanwhile still drops.
            with self._lock:
                if kind == "evict":
                    self._stragglers.setdefault(
                        int(info.get("worker_id", -1)), dict(signal))
                elif kind == "grow":
                    if self._grow_signal is None:
                        self._grow_signal = dict(signal)
                elif self._shrink_signal is None:
                    self._shrink_signal = dict(signal)
            self._suppress(kind, signal, "action_failed", now, world=world)
        # context to the flight ring: the black box must carry what the
        # fleet looked like at the moment the loop acted
        try:
            from elasticdl_tpu_torch.observability import flight as flight_lib

            flight_lib.get_recorder().record(
                "autoscale", kind, **{
                    k: v for k, v in info.items()
                    if k not in ("decision", "kind")
                },
            )
        except Exception:
            logger.exception("autoscale flight record failed")
        logger.warning(
            "AUTOSCALE %s applied: world %d -> %d (%s; projected gain "
            "%.1fs > cost %.1fs; budget %d/%d)",
            kind, world, new_world, info.get("reason", ""),
            proj["gain_s"], proj["cost_s"],
            self._state.actions_applied, self.action_budget,
        )
        return info

    # ------------------------------------------------------------------ #
    # introspection

    def snapshot(self) -> Dict:
        """Cheap state view (/healthz enrichment + bench artifacts)."""
        now = self._clock()
        with self._lock:
            # copy EVERYTHING mutable inside the lock: the wait loop's
            # _apply mutates by_kind/counters under it, and an HTTP
            # /healthz thread iterating a live dict would race
            actions_applied = self._state.actions_applied
            by_kind = dict(self._state.by_kind)
            records = self._state.records
            reversals = self._reversals
            smoothed = dict(self._smoothed)
            last = dict(self._last_decision) if self._last_decision else None
            pending = (
                len(self._stragglers)
                + (1 if self._grow_signal else 0)
                + (1 if self._shrink_signal else 0)
            )
        return {
            "enabled": self._target is not None,
            "actions_applied": actions_applied,
            "action_budget": self.action_budget,
            "budget_remaining": max(
                0, self.action_budget - actions_applied),
            "by_kind": by_kind,
            "cooldown_s": self.cooldown_s,
            "cooldown_active": self._in_cooldown(now),
            "hold_s": self.hold_s,
            "min_world": self.min_world,
            "max_world": self.max_world,
            "rescale_cost_s": round(self.cost.rescale_cost_s, 3),
            "horizon_s": self.cost.horizon_s,
            "pending_signals": pending,
            "last_decision": last,
            "decision_records": records,
            "damping": self.damping,
            "reversal_hold_s": self.reversal_hold_s,
            "reversals": reversals,
            "smoothed_signals": {
                k: round(v, 4) for k, v in smoothed.items()
            },
        }


def from_config(cfg, journal=None) -> Optional[Autoscaler]:
    """Build the engine from a JobConfig (None when --autoscale is off).
    The caller subscribes and binds the target."""
    if not getattr(cfg, "autoscale", False):
        return None
    return Autoscaler(
        journal=journal,
        cost_model=CostModel(
            rescale_cost_s=cfg.autoscale_rescale_cost_s,
            horizon_s=cfg.autoscale_horizon_s,
        ),
        min_world=cfg.autoscale_min_workers,
        max_world=cfg.autoscale_max_workers,
        cooldown_s=cfg.autoscale_cooldown_s,
        hold_s=cfg.autoscale_hold_s,
        action_budget=cfg.autoscale_actions_max,
        damping=getattr(cfg, "autoscale_damping", 0.0),
        reversal_hold_s=getattr(cfg, "autoscale_reversal_hold_s", 0.0),
    )
