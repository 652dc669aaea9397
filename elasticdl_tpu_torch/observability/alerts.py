"""Declarative alert rules over the time-series store.

The sensing stack can now say what happened (metrics), why (profiler),
and when (time series) — but every consequence is still a log line
someone has to be reading. This module closes the observe->decide gap
with a small, declarative rule engine the master evaluates on its
existing `ClusterHealth` poll:

- **`AlertRule`**: one named condition over ONE series in the store —
  `value` (latest sample), `avg`/`quantile` (window), `rate` (counter
  rate-of-change, reset-aware), or `burn_rate` (the SRE multi-window
  shape: the condition must hold over BOTH a short and a long window,
  so a transient spike doesn't page and a sustained burn does). `for_s`
  additionally requires the condition to hold continuously before the
  alert fires.
- **`AlertEngine`**: edge-triggered evaluation. One `cluster.alert`
  trace event + hook invocation at ONSET, one `cluster.alert_cleared`
  at recovery — never one per poll. An active alert whose series goes
  dark (no samples in the window: reporter died, fleet below quorum)
  is CARRIED FORWARD, not cleared — "we lost the ability to evaluate"
  must not read as "the problem went away" (the same contract as the
  straggler scorer's carried-forward flag). Page-severity onsets dump
  the process flight ring (riding PR 8's escalation machinery), so the
  black box is cut at the moment the condition tripped.
- **metrics**: `edl_alert_active{rule}` (1 while firing) and
  `edl_alert_transitions_total{rule}` (onsets + clears).
- **hooks**: `add_hook(cb)` — cb(alert_info) fires once per onset; this
  is the pluggable seam ROADMAP 3's autoscaler subscribes to, exactly
  like `ClusterHealth.add_hook` for stragglers. Hook exceptions are
  swallowed: evaluation must survive its consumers.
- **`/alerts`** (observability/http.py) serves `snapshot()`; with a
  json_path configured, every transition (and `write_json()`) lands an
  atomic `alerts.json` next to the job's other artifacts.

Shipped default rules (docs/observability.md "Alert rules") cover the
sensor set ROADMAP 3's autoscaler needs: straggler presence, dispatcher
backlog per worker, a data_wait-dominant fleet (more workers will not
help an input-bound job), embedding pull p99, and embedding shard load
imbalance. Rules can also be loaded from a JSON file (`--alert_rules`).

Stdlib-only, jax-free, and strictly best-effort: `evaluate()` never
raises.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from dataclasses import asdict, dataclass
from typing import Callable, Dict, List, Optional

from elasticdl_tpu_torch.common.log_utils import default_logger
from elasticdl_tpu_torch.observability import tracing
from elasticdl_tpu_torch.observability.registry import default_registry
from elasticdl_tpu_torch.observability.timeseries import TimeSeriesStore

logger = default_logger(__name__)

_reg = default_registry()
_AL_ACTIVE = _reg.gauge(
    "edl_alert_active", "1 while the rule's condition is firing",
    labels=("rule",))
_AL_TRANSITIONS = _reg.counter(
    "edl_alert_transitions_total",
    "alert state transitions (onsets + clears)", labels=("rule",))

#: evaluation modes an AlertRule may use
MODES = ("value", "avg", "quantile", "rate", "burn_rate")
SEVERITIES = ("warn", "page")

#: recent transitions kept for /alerts and alerts.json
HISTORY_KEEP = 128


@dataclass
class AlertRule:
    """One declarative condition over one time-series."""

    name: str
    series: str
    threshold: float
    op: str = ">"              # ">" or "<"
    mode: str = "value"        # see MODES
    window_s: float = 60.0
    long_window_s: float = 0.0  # burn_rate: the confirming long window
    quantile: float = 0.99     # quantile mode only
    for_s: float = 0.0         # condition must hold this long pre-onset
    severity: str = "warn"     # "warn" | "page" (page dumps the ring)
    description: str = ""

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(
                f"alert rule {self.name!r}: mode {self.mode!r} not in "
                f"{MODES}")
        if self.op not in (">", "<"):
            raise ValueError(
                f"alert rule {self.name!r}: op must be '>' or '<'")
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"alert rule {self.name!r}: severity {self.severity!r} "
                f"not in {SEVERITIES}")
        if self.mode == "burn_rate" and self.long_window_s <= self.window_s:
            raise ValueError(
                f"alert rule {self.name!r}: burn_rate needs "
                "long_window_s > window_s")

    # -------------------------------------------------------------- #

    def _measure(self, store: TimeSeriesStore, window_s: float,
                 now: float) -> Optional[float]:
        if self.mode == "value":
            return store.latest(self.series, now=now, max_age_s=window_s)
        if self.mode == "avg" or self.mode == "burn_rate":
            return store.avg(self.series, window_s, now=now)
        if self.mode == "quantile":
            return store.quantile(
                self.series, self.quantile, window_s, now=now)
        if self.mode == "rate":
            return store.rate(self.series, window_s, now=now)
        return None

    def _breaches(self, value: float) -> bool:
        return value > self.threshold if self.op == ">" \
            else value < self.threshold

    def evaluate(self, store: TimeSeriesStore,
                 now: float) -> "Optional[Dict]":
        """None = no data (the engine carries active alerts forward);
        else {"bad": bool, "value": measured} — for burn_rate, bad means
        BOTH windows breach and `value` is the short window's."""
        short = self._measure(store, self.window_s, now)
        if short is None:
            return None
        bad = self._breaches(short)
        out = {"bad": bad, "value": short}
        if self.mode == "burn_rate" and bad:
            long_v = self._measure(store, self.long_window_s, now)
            if long_v is None:
                return None
            out["long_value"] = long_v
            out["bad"] = self._breaches(long_v)
        return out


def default_rules() -> List[AlertRule]:
    """The shipped sensor set — every series here is produced by the
    master's fleet sampler (timeseries.fleet_series). Thresholds are
    deliberately conservative defaults; jobs tune via --alert_rules."""
    return [
        AlertRule(
            "straggler", series="edl_fleet_straggler_count",
            threshold=0.5, mode="value", window_s=60.0, severity="warn",
            description="ClusterHealth scored >=1 worker as a straggler",
        ),
        AlertRule(
            "dispatcher_backlog_per_worker",
            series="edl_fleet_backlog_per_worker",
            threshold=64.0, mode="avg", window_s=60.0, for_s=30.0,
            severity="warn",
            description="todo tasks per alive worker high and sustained "
                        "— the grow signal for ROADMAP 3's autoscaler",
        ),
        AlertRule(
            "fleet_data_wait_dominant",
            series="edl_fleet_data_wait_frac",
            threshold=0.5, mode="burn_rate", window_s=60.0,
            long_window_s=300.0, severity="warn",
            description="the fleet spends most of its step time blocked "
                        "on input — more workers will not help",
        ),
        AlertRule(
            "embedding_pull_p99",
            series="edl_fleet_emb_pull_p99_ms",
            threshold=250.0, mode="burn_rate", window_s=30.0,
            long_window_s=120.0, severity="page",
            description="embedding tier pull p99 sustained past budget "
                        "— pulls are on the step critical path",
        ),
        AlertRule(
            "embedding_shard_imbalance",
            series="edl_fleet_emb_shard_imbalance",
            threshold=3.0, mode="avg", window_s=30.0, for_s=10.0,
            severity="page",
            description="one embedding shard serves >3x the mean load — "
                        "the hot-row-cache / replica signal (ROADMAP 1)",
        ),
        # ISSUE 13 (embedding read path): the fleet series is the WORST
        # (minimum) reporter's recent-window hit rate, present only when
        # a cache is actually running — no cache, no data, no page. A
        # sustained collapse means the hot set migrated out from under
        # the cache (campaign launch, day/night id shift): re-seed from
        # the sketch / grow --embedding_cache_rows before owner RPC load
        # multiplies by 1/(1-hit_rate).
        AlertRule(
            "embedding_cache_hit_collapse",
            series="edl_fleet_emb_cache_hit_rate",
            threshold=0.2, op="<", mode="avg", window_s=60.0,
            for_s=30.0, severity="warn",
            description="hot-row cache hit rate collapsed on at least "
                        "one worker — hot-set migration; owner shards "
                        "are about to absorb the uncached read load",
        ),
        # ISSUE 12 (observability/goodput.py): the two rules that watch
        # the bill itself. Both series come from the master's
        # FleetGoodput rollup riding the fleet sampler.
        # both goodput rules watch the WINDOWED (per-rollup-delta)
        # series, not the lifetime-cumulative ones: after 10h at 0.9 a
        # 30-minute stall barely moves a cumulative fraction, and a long
        # boot compile would depress it past any for_s hold — the recent
        # series measure the last interval and reach the store ONLY via
        # FleetGoodput.series() (deliberately no registry gauge — see
        # observability/goodput.py's note above its gauge factories)
        AlertRule(
            "goodput_burn",
            series="edl_goodput_fleet_recent_fraction",
            threshold=0.5, op="<", mode="burn_rate", window_s=60.0,
            long_window_s=300.0, for_s=120.0, severity="warn",
            description="fleet goodput fraction (windowed) sustained "
                        "below half — most paid chip-seconds are not "
                        "training; read /goodput for the category "
                        "breakdown (for_s rides out boot compiles)",
        ),
        AlertRule(
            "wasted_work_ratio",
            series="edl_goodput_recent_wasted_ratio",
            threshold=0.05, mode="avg", window_s=120.0, for_s=30.0,
            severity="warn",
            description="over 5% of recently-processed training records "
                        "are being re-trained (requeues after "
                        "crash/expiry) — crash-replay or lease-timeout "
                        "churn",
        ),
        # ISSUE 19 (observability/reqtrace.py): the fleet's dominant
        # slow-request stage MOVED (e.g. wire -> budget_wait, the
        # partition signature). FleetAttribution emits a 1.0 pulse on
        # the sample where the worst reporter's dominant stage differs
        # from the previous rollup, 0.0 otherwise — a plain value rule
        # turns that into an edge-triggered alert that clears on the
        # next steady sample. The absolute p99 level already has
        # embedding_pull_p99; this rule fires on the SHAPE changing.
        AlertRule(
            "emb_attr_dominant_shift",
            series="edl_fleet_emb_attr_dom_shift",
            threshold=0.5, mode="value", window_s=60.0,
            severity="warn",
            description="the dominant per-stage attribution of slow "
                        "embedding reads shifted (see "
                        "edl_fleet_emb_attr_dom_stage and the incident "
                        "CLI's slow_calls waterfalls for where the p99 "
                        "moved)",
        ),
    ]


def rules_from_json(data) -> List[AlertRule]:
    """Parse a rules document: a JSON list of AlertRule field dicts.
    Unknown keys are rejected (a typo'd threshold key silently keeping a
    default is exactly the failure mode declarative rules exist to
    avoid)."""
    if not isinstance(data, list):
        raise ValueError("alert rules document must be a JSON list")
    allowed = set(AlertRule.__dataclass_fields__)
    rules = []
    for i, entry in enumerate(data):
        if not isinstance(entry, dict):
            raise ValueError(f"alert rule #{i} is not an object")
        unknown = set(entry) - allowed
        if unknown:
            raise ValueError(
                f"alert rule #{i} has unknown keys {sorted(unknown)}")
        rules.append(AlertRule(**entry))
    return rules


def rules_from_config(cfg) -> Optional[List[AlertRule]]:
    """--alert_rules resolution: "" = defaults, "off" = no rules (engine
    disabled), a path = defaults REPLACED by the file's rules. A bad
    file fails at boot — a silently-defaulted alert config is worse than
    a loud one."""
    raw = (getattr(cfg, "alert_rules", "") or "").strip()
    if not raw:
        return default_rules()
    if raw.lower() == "off":
        return []
    with open(raw, encoding="utf-8") as f:
        return rules_from_json(json.load(f))


class AlertEngine:
    """Edge-triggered evaluation of AlertRules against a store."""

    def __init__(self, store: TimeSeriesStore,
                 rules: Optional[List[AlertRule]] = None,
                 json_path: Optional[str] = None,
                 flight_dump: Optional[Callable[[str], None]] = None):
        self._store = store
        self.rules = list(rules) if rules is not None else default_rules()
        names = [r.name for r in self.rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate alert rule names in {names}")
        self.json_path = json_path or None
        self._hooks: List[Callable[[Dict], None]] = []
        self._lock = threading.Lock()
        self._active: Dict[str, Dict] = {}        # guarded_by: _lock
        self._pending_since: Dict[str, float] = {}  # guarded_by: _lock
        self._history: "deque[Dict]" = deque(maxlen=HISTORY_KEEP)  # guarded_by: _lock
        self._evaluations = 0                      # guarded_by: _lock
        # page-severity onset cuts the black box; injectable for tests
        if flight_dump is None:
            def flight_dump(reason: str) -> None:
                from elasticdl_tpu_torch.observability import flight as flight_lib

                flight_lib.get_recorder().dump(reason)
        self._flight_dump = flight_dump

    def add_hook(self, cb: Callable[[Dict], None]) -> None:
        """cb(alert_info) fires once per alert ONSET — the autoscaler
        seam (ROADMAP 3), mirroring ClusterHealth.add_hook."""
        self._hooks.append(cb)

    # ------------------------------------------------------------------ #

    def evaluate(self, now: Optional[float] = None) -> Dict:
        """One evaluation pass; returns the state snapshot. Never raises
        (the master's wait loop calls this unconditionally)."""
        try:
            return self._evaluate(now)
        except Exception:
            logger.exception("alert evaluation failed; keeping last state")
            return self.snapshot()

    def _evaluate(self, now: Optional[float] = None) -> Dict:
        now = time.time() if now is None else now
        onsets: List[Dict] = []
        cleared: List[Dict] = []
        with self._lock:
            self._evaluations += 1
            for rule in self.rules:
                result = rule.evaluate(self._store, now)
                active = self._active.get(rule.name)
                if result is None:
                    # no data: carry an active alert forward (clearing on
                    # blindness would close the incident spuriously and
                    # double-count the onset when data returns), drop any
                    # pending timer (we cannot know the condition held)
                    self._pending_since.pop(rule.name, None)
                    if active is not None:
                        active["carried_forward"] = True
                    continue
                if result["bad"]:
                    since = self._pending_since.setdefault(rule.name, now)
                    if active is not None:
                        active["value"] = result["value"]
                        active["carried_forward"] = False
                        continue
                    if now - since < rule.for_s:
                        continue   # pending, not yet held long enough
                    info = {
                        "rule": rule.name,
                        "severity": rule.severity,
                        "series": rule.series,
                        "mode": rule.mode,
                        "op": rule.op,
                        "threshold": rule.threshold,
                        "value": round(float(result["value"]), 6),
                        "since": round(since, 3),
                        "ts": round(now, 3),
                        "description": rule.description,
                        "carried_forward": False,
                    }
                    if "long_value" in result:
                        info["long_value"] = round(
                            float(result["long_value"]), 6)
                    self._active[rule.name] = info
                    onsets.append(dict(info))
                else:
                    self._pending_since.pop(rule.name, None)
                    if active is not None:
                        del self._active[rule.name]
                        cleared.append(dict(
                            active, cleared_ts=round(now, 3)))
            for info in onsets:
                self._history.append(dict(info, transition="firing"))
            for info in cleared:
                self._history.append(dict(info, transition="cleared"))

        # metrics + events + hooks OUTSIDE the lock (trace emission is
        # file I/O — EDL402's idiom)
        for info in onsets:
            # rule-name labels are bounded by the declared rule set (a
            # handful, validated unique at construction), not by data:
            # edl-lint: disable=EDL405
            _AL_ACTIVE.set(1, rule=info["rule"])
            # edl-lint: disable=EDL405
            _AL_TRANSITIONS.inc(rule=info["rule"])
            tracing.event(
                "cluster.alert", rule=info["rule"],
                severity=info["severity"], series=info["series"],
                value=info["value"], threshold=info["threshold"],
            )
            logger.warning(
                "ALERT %s [%s]: %s %s %s %s (value %.6g)",
                info["rule"], info["severity"], info["series"],
                info["mode"], info["op"], info["threshold"], info["value"],
            )
            if info["severity"] == "page":
                # the black box, cut at the moment the page tripped —
                # dump() never raises
                self._flight_dump(f"alert:{info['rule']}")
            for hook in self._hooks:
                try:
                    hook(dict(info))
                except Exception:
                    # swallowed (evaluation must survive its consumers)
                    # but never dark: counted + named (observability/
                    # hooks.py — shared with ClusterHealth's seam)
                    from elasticdl_tpu_torch.observability.hooks import (
                        observe_hook_failure,
                    )

                    observe_hook_failure("alert_engine", hook, logger)
        for info in cleared:
            # bounded by the declared rule set (see the onset loop):
            # edl-lint: disable=EDL405
            _AL_ACTIVE.set(0, rule=info["rule"])
            # edl-lint: disable=EDL405
            _AL_TRANSITIONS.inc(rule=info["rule"])
            tracing.event("cluster.alert_cleared", rule=info["rule"])
            logger.info("alert cleared: %s", info["rule"])
        if (onsets or cleared) and self.json_path:
            self.write_json()
        return self.snapshot()

    # ------------------------------------------------------------------ #

    def snapshot(self) -> Dict:
        """The /alerts payload: active alerts + recent transitions + the
        rule table (cheap; never recomputes)."""
        with self._lock:
            return {
                "ts": time.time(),
                "evaluations": self._evaluations,
                "active": sorted(
                    (dict(i) for i in self._active.values()),
                    key=lambda i: i["rule"]),
                "history": list(self._history),
                "rules": [asdict(r) for r in self.rules],
            }

    def active(self) -> List[Dict]:
        with self._lock:
            return sorted(
                (dict(i) for i in self._active.values()),
                key=lambda i: i["rule"])

    def write_json(self, path: Optional[str] = None) -> Optional[str]:
        """Persist the snapshot atomically (tmp + os.replace — EDL305) as
        alerts.json; never raises."""
        target = path or self.json_path
        if not target:
            return None
        try:
            os.makedirs(os.path.dirname(target) or ".", exist_ok=True)
            tmp = target + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(self.snapshot(), f, indent=1, sort_keys=True,
                          default=repr)
                f.write("\n")
            os.replace(tmp, target)
        except Exception:
            logger.exception("alerts.json write to %s failed", target)
            return None
        return target


# kept importable for tests asserting the field set stays declarative
RULE_FIELDS = tuple(AlertRule.__dataclass_fields__)
