"""Fleet goodput ledger: exhaustive wall-clock and wasted-work attribution.

The cluster can see (step profiler), chart (time series), and page
(alert engine) — but nothing totals the bill: *of all the chip-seconds
and records we paid for, what fraction was productive training?* This
module answers that, at three scopes:

- **`GoodputLedger`** (per process): attributes every wall-clock second
  of a worker's life — from ledger construction on — to exactly ONE of

      train_compute     the jitted step (dispatch + device compute)
      data_wait         blocked on the input pipeline
      h2d               host->device transfer / global-batch assembly
      emb_pull_blocked  embedding-tier pulls blocking the step
      rescale           resize work, with settle/handoff/compile
                        sub-buckets (cohort world formation included)
      lease_wait        idle — polling an empty task queue
      reconnect         master unreachable / generation-fence window
                        (boot-register retries, re-register handshakes)
      overhead          the residual, so the categories ALWAYS sum to
                        wall clock — the same total-attribution
                        invariant the trace analyzer's critical path
                        enforces (phase sum == wall by construction)

  The clock is `time.monotonic` (never `time.time`: an NTP step would
  corrupt the ledger — edl-lint EDL406 enforces this tree-wide). The
  hot-path cost is the step profiler's: the profiler tees its phase
  adds into the ledger (`observability/profile.py`), so no new timer
  runs per step; rescale/lease_wait/reconnect/emb_pull sites add a
  `phase()` context each at task/resize granularity.

- **wasted work** (master side, fed from the dispatcher + journal):
  records whose training must be repeated or whose completed training
  was discarded. Every entry is `(reason, task_id, records)`, journaled
  per task (`wasted_work` records in the control-plane journal) so a
  master restart replays the bill intact. Reasons:

      worker_died / lease_expired   the lease's span re-trains whole
      failure_retry                 ran once, result discarded, re-runs
      crash_requeue                 the successor's conservative replay
                                    requeue (journaled at takeover)
      fenced_report                 a completed report rejected by the
                                    generation fence — finished work
                                    discarded (claimed records)
      stale_report                  a report from a superseded lease
                                    holder — its work is discarded
      drain_requeue                 a preemption drain's remainder,
                                    requeued for another lease

  `fenced_report`/`stale_report` evidence work that WAS done and then
  thrown away; the requeue reasons bill the re-training. The two views
  can overlap on the same records (the fenced span is usually also the
  requeued span) — per-reason buckets keep the overlap inspectable.

- **`FleetGoodput`** (master): rolls per-worker ledger payloads (riding
  the existing heartbeat stats channel as `gp_*` keys) plus the
  dispatcher's wasted-work totals into the fleet picture — fleet
  goodput fraction, per-category fleet seconds, wasted-records total
  and ratio — exported as `edl_goodput_*` gauges, sampled into the
  time-series store (the input of the `goodput_burn` /
  `wasted_work_ratio` default alert rules), served at `GET /goodput`,
  and summarized by the incident CLI.

Stdlib-only, jax-free, strictly best-effort, like the rest of the
package. See docs/observability.md ("Goodput ledger").
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional

from elasticdl_tpu_torch.observability.registry import default_registry

#: the category vocabulary; `overhead` is derived (wall - attributed),
#: never added directly
CATEGORIES = (
    "train_compute", "data_wait", "h2d", "emb_pull_blocked",
    "rescale", "lease_wait", "reconnect", "overhead",
)

#: rescale sub-buckets (mirror the resize trace's phase vocabulary)
RESCALE_SUBS = ("settle", "handoff", "compile")

#: heartbeat-payload key prefix; the payload carries `gp_wall_s` plus
#: one `gp_<category>_s` per category with nonzero seconds (overhead
#: included, so the master can re-check the sum without re-deriving)
PAYLOAD_PREFIX = "gp_"

_PAYLOAD_KEYS = {
    "train_compute": "gp_train_compute_s",
    "data_wait": "gp_data_wait_s",
    "h2d": "gp_h2d_s",
    "emb_pull_blocked": "gp_emb_pull_blocked_s",
    "rescale": "gp_rescale_s",
    "lease_wait": "gp_lease_wait_s",
    "reconnect": "gp_reconnect_s",
    "overhead": "gp_overhead_s",
}

#: wasted-work reasons whose records are RE-TRAINED spans (the requeue
#: bill); fenced/stale reports evidence discarded completed work instead
REQUEUE_REASONS = (
    "worker_died", "lease_expired", "failure_retry", "crash_requeue",
    "drain_requeue",
)
REPORT_REASONS = ("fenced_report", "stale_report")
WASTED_REASONS = REQUEUE_REASONS + REPORT_REASONS

_reg = default_registry()
_GP_SECONDS = _reg.gauge(
    "edl_goodput_seconds",
    "cumulative wall-clock seconds this process attributes to each "
    "goodput category (categories sum to wall clock)",
    labels=("category",))
_GP_FRACTION = _reg.gauge(
    "edl_goodput_fraction",
    "this process's train_compute seconds / wall-clock seconds")
def _fleet_gauges():
    """The master-side rollup gauges, registered LAZILY (idempotent) at
    first real rollup instead of at import: an unlabelled registered-but-
    never-set gauge snapshots as 0, and a boot-time
    `edl_goodput_fleet_fraction = 0` would (a) fire the goodput_burn rule
    spuriously on every fresh master — 0 must read as "no data", not
    "zero goodput" — and (b) pollute every WORKER's /metrics with
    fleet-scoped zeros merely for importing this module."""
    return (
        _reg.gauge(
            "edl_goodput_fleet_seconds",
            "fleet-total worker seconds per goodput category (master "
            "rollup over heartbeat ledger payloads)",
            labels=("category",)),
        _reg.gauge(
            "edl_goodput_fleet_wall_seconds",
            "fleet-total worker wall-clock seconds with a goodput ledger"),
        _reg.gauge(
            "edl_goodput_fleet_fraction",
            "fleet goodput fraction: train_compute / wall across "
            "reporters"),
    )


def _wasted_gauges():
    """Lazy for the same reason as _fleet_gauges (master-only scope)."""
    return (
        _reg.gauge(
            "edl_goodput_wasted_records",
            "authoritative wasted-record total (journal-replayed; "
            "survives master restart)"),
        _reg.gauge(
            "edl_goodput_wasted_ratio",
            "wasted records / (completed + wasted) training records "
            "(lifetime-cumulative)"),
    )


# NOTE deliberately NO registry gauges for the windowed
# `edl_goodput_fleet_recent_fraction` / `edl_goodput_recent_wasted_ratio`
# series the burn rules watch: they reach the time-series store ONLY
# through FleetGoodput.series() (the sampler extra), so a rollup that
# SKIPS the sample (reporter churn, no fleet data yet) produces a true
# data gap. A gauge would defeat both protections at once — a
# registered-but-never-set gauge snapshots as 0 ("zero goodput" instead
# of "no data"), and a set-once gauge would repeat its stale pre-churn
# value into every later sample.


_WASTED_EVENTS_C = _reg.counter(
    "edl_goodput_wasted_events_total",
    "wasted-work ledger entries by reason (live; restart resets)",
    labels=("reason",))
_WASTED_RECORDS_C = _reg.counter(
    "edl_goodput_wasted_records_total",
    "wasted records by reason (live; restart resets — the gauge above "
    "is the replay-durable total)",
    labels=("reason",))


def record_wasted(reason: str, records: int) -> None:
    """Live metric side of one wasted-work entry (the dispatcher calls
    this next to journaling it). Reason values come from the bounded
    WASTED_REASONS vocabulary at every call site."""
    _WASTED_EVENTS_C.inc(reason=reason)
    if records > 0:
        _WASTED_RECORDS_C.inc(records, reason=reason)


class GoodputLedger:
    """Per-process wall-clock attribution with a total-sum invariant.

    Thread-safe: the train loop and prefetcher attribute phases (via the
    step profiler's tee), the heartbeat thread snapshots. The lock is a
    LEAF lock. The clock is monotonic — wall time here is *elapsed life
    since the ledger started*, immune to NTP steps (EDL406)."""

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._t0 = clock()
        self._acc: Dict[str, float] = {               # guarded_by: _lock
            c: 0.0 for c in CATEGORIES if c != "overhead"
        }
        self._rescale_sub: Dict[str, float] = {       # guarded_by: _lock
            s: 0.0 for s in RESCALE_SUBS
        }

    # ------------------------------------------------------------------ #
    # hot path

    def add(self, category: str, seconds: float,
            sub: Optional[str] = None) -> None:
        """Attribute `seconds` to `category` (unknown categories are
        dropped — the vocabulary is the payload schema, and a typo'd
        category must not silently grow it). `sub` refines `rescale`
        into its settle/handoff/compile sub-buckets."""
        if seconds <= 0 or category == "overhead":
            return
        with self._lock:
            if category not in self._acc:
                return
            self._acc[category] += seconds
            if category == "rescale" and sub in self._rescale_sub:
                self._rescale_sub[sub] += seconds

    @contextmanager
    def phase(self, category: str, sub: Optional[str] = None) -> Iterator[None]:
        t0 = self._clock()
        try:
            yield
        finally:
            self.add(category, self._clock() - t0, sub=sub)

    # ------------------------------------------------------------------ #

    def snapshot(self, now: Optional[float] = None,
                 update_metrics: bool = False) -> Dict:
        """The full attribution: every category (overhead = residual,
        clamped at 0), the rescale sub-buckets, wall clock, and the
        goodput fraction. `overattributed_s` surfaces any double-
        attribution (explicit categories summing past wall) instead of
        hiding it in a negative residual — the bench's 1% gate reads
        it."""
        now = self._clock() if now is None else now
        with self._lock:
            wall = max(0.0, now - self._t0)
            acc = dict(self._acc)
            subs = dict(self._rescale_sub)
        attributed = sum(acc.values())
        overhead = wall - attributed
        categories = {c: round(acc[c], 6) for c in acc}
        categories["overhead"] = round(max(0.0, overhead), 6)
        out = {
            "wall_s": round(wall, 6),
            "categories": categories,
            "rescale_phases": {s: round(v, 6) for s, v in subs.items()},
            "goodput_fraction": (
                round(acc["train_compute"] / wall, 6) if wall > 0 else 0.0
            ),
            "overattributed_s": round(max(0.0, -overhead), 6),
        }
        if update_metrics:
            for c, v in categories.items():
                # keys come from the module-constant CATEGORIES
                # vocabulary (add() drops anything else), so the label
                # set is bounded: edl-lint: disable=EDL405
                _GP_SECONDS.set(v, category=c)
            _GP_FRACTION.set(out["goodput_fraction"])
        return out

    def payload(self, now: Optional[float] = None) -> Dict[str, float]:
        """The compact heartbeat ride-along: `gp_wall_s` + one key per
        category with nonzero seconds (ms-precision rounding keeps the
        JSON small). Also refreshes this process's edl_goodput_* gauges
        — the heartbeat cadence is the snapshot cadence."""
        snap = self.snapshot(now=now, update_metrics=True)
        out: Dict[str, float] = {"gp_wall_s": round(snap["wall_s"], 3)}
        for category, key in _PAYLOAD_KEYS.items():
            v = snap["categories"].get(category, 0.0)
            if v > 0:
                out[key] = round(v, 3)
        return out

    def reset(self) -> None:
        with self._lock:
            self._t0 = self._clock()
            for c in self._acc:
                self._acc[c] = 0.0
            for s in self._rescale_sub:
                self._rescale_sub[s] = 0.0


# ---------------------------------------------------------------------- #
# fleet rollup (master side)


def aggregate_payloads(health_records: List[Dict],
                       stale_after_s: float = 30.0,
                       now: Optional[float] = None) -> Dict:
    """Sum the `gp_*` ledger payloads of workers with FRESH telemetry
    (staleness keyed on the record's wall-clock `updated_at`, same
    contract as the fleet series). Per-worker ledgers are cumulative, so
    the sums are fleet-cumulative seconds. Returns {} when no reporter
    carries a ledger — absence must read as "no data" to the rules, not
    as zero goodput."""
    now = time.time() if now is None else now
    totals = {c: 0.0 for c in CATEGORIES}
    wall = 0.0
    reporters = 0
    for rec in health_records:
        try:
            updated = float(rec.get("updated_at") or 0.0)
        except (TypeError, ValueError):
            continue
        if now - updated > stale_after_s:
            continue
        w = rec.get("gp_wall_s")
        if not isinstance(w, (int, float)) or isinstance(w, bool) or w <= 0:
            continue
        reporters += 1
        wall += float(w)
        for category, key in _PAYLOAD_KEYS.items():
            v = rec.get(key)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                totals[category] += float(v)
    if not reporters:
        return {}
    return {
        "reporters": reporters,
        "wall_s": round(wall, 3),
        "categories": {c: round(v, 3) for c, v in totals.items()},
        "goodput_fraction": (
            round(totals["train_compute"] / wall, 6) if wall > 0 else 0.0
        ),
    }


class FleetGoodput:
    """The master's goodput rollup: heartbeat ledger payloads (via
    Membership's health records) + the dispatcher's journal-durable
    wasted-work totals, recomputed every wait poll next to the cluster-
    health scorer. `snapshot()` is cheap and cached (served by /goodput,
    /healthz enrichment, and the incident CLI's health files);
    `series()` feeds the master's time-series sampler — the sensor the
    goodput_burn / wasted_work_ratio default rules read."""

    def __init__(self, membership, dispatcher=None):
        self._membership = membership
        self._dispatcher = dispatcher
        self._lock = threading.Lock()
        self._last: Dict = {"ts": 0.0}                # guarded_by: _lock
        # previous rollup's cumulative sums, for the windowed "recent"
        # series (update() has a single caller — the master's wait loop —
        # so these need no lock of their own)
        self._prev_fleet: Optional[Dict[str, float]] = None
        self._prev_wasted: Optional[Dict[str, int]] = None

    def update(self, now: Optional[float] = None) -> Dict:
        """Recompute the rollup; never raises (wait-loop contract)."""
        try:
            return self._update(now)
        except Exception:
            from elasticdl_tpu_torch.common.log_utils import default_logger

            default_logger(__name__).exception(
                "fleet goodput rollup failed; keeping last")
            return self.snapshot()

    def _update(self, now: Optional[float] = None) -> Dict:
        now = time.time() if now is None else now
        fleet = aggregate_payloads(
            self._membership.health_snapshot(), now=now)
        snap: Dict = {"ts": now, "fleet": fleet}
        if fleet:
            seconds_g, wall_g, fraction_g = _fleet_gauges()
            for c, v in fleet["categories"].items():
                # aggregate_payloads emits exactly the CATEGORIES
                # vocabulary — bounded: edl-lint: disable=EDL405
                seconds_g.set(v, category=c)
            wall_g.set(fleet["wall_s"])
            fraction_g.set(fleet["goodput_fraction"])
            # the windowed fraction: delta train / delta wall since the
            # previous rollup. Reporter churn (a restarted worker resets
            # its cumulative ledger; a dead one leaves the sum) shows up
            # as a negative delta — SKIP the sample then (absence reads
            # as no-data to the rules, which carry active alerts
            # forward) rather than emit garbage.
            prev, self._prev_fleet = self._prev_fleet, {
                "wall": fleet["wall_s"],
                "train": fleet["categories"]["train_compute"],
            }
            if prev is not None:
                dwall = fleet["wall_s"] - prev["wall"]
                dtrain = (
                    fleet["categories"]["train_compute"] - prev["train"]
                )
                if dwall > 1e-9 and dtrain >= 0:
                    fleet["recent_fraction"] = round(
                        min(1.0, dtrain / dwall), 6)
        if self._dispatcher is not None:
            wasted = self._dispatcher.wasted_work()
            snap["wasted"] = wasted
            records_g, ratio_g = _wasted_gauges()
            records_g.set(wasted["wasted_records"])
            ratio_g.set(wasted["wasted_ratio"])
            prev_w, self._prev_wasted = self._prev_wasted, {
                "wasted": wasted["wasted_records"],
                "completed": wasted["records_completed"],
            }
            if prev_w is not None:
                dw = wasted["wasted_records"] - prev_w["wasted"]
                dc = wasted["records_completed"] - prev_w["completed"]
                if dw >= 0 and dc >= 0:
                    # zero activity reads as an honest 0.0 ("no new
                    # waste"), so a stall with an active alert can clear
                    denom = dw + dc
                    wasted["recent_ratio"] = (
                        round(dw / denom, 6) if denom > 0 else 0.0)
        with self._lock:
            self._last = snap
        return snap

    def snapshot(self) -> Dict:
        with self._lock:
            return dict(self._last)

    def series(self) -> Dict[str, float]:
        """Flat series for the master's sampler extra: ONLY the windowed
        recent values, which deliberately have no registry gauge (see
        the module note above _FLEET gauges) — everything cumulative
        already rides the registry snapshot into the same sample, and
        emitting it twice here would be double bookkeeping. A skipped
        rollup emits nothing: absence IS the no-data signal the rules'
        carried-forward semantics key on."""
        snap = self.snapshot()
        out: Dict[str, float] = {}
        fleet = snap.get("fleet") or {}
        if "recent_fraction" in fleet:
            out["edl_goodput_fleet_recent_fraction"] = (
                fleet["recent_fraction"])
        wasted = snap.get("wasted") or {}
        if "recent_ratio" in wasted:
            out["edl_goodput_recent_wasted_ratio"] = (
                wasted["recent_ratio"])
        return out


# ---------------------------------------------------------------------- #
# process singleton (worker/cohort/tier/profiler feed the same ledger;
# the /goodput endpoint falls back to it when none is wired explicitly)

_LEDGER: Optional[GoodputLedger] = None
_LEDGER_LOCK = threading.Lock()


def get_ledger() -> GoodputLedger:
    global _LEDGER
    with _LEDGER_LOCK:
        if _LEDGER is None:
            _LEDGER = GoodputLedger()
        return _LEDGER


def reset_for_tests() -> None:
    global _LEDGER
    with _LEDGER_LOCK:
        _LEDGER = None
