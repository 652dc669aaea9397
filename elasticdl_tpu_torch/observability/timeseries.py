"""In-process metrics time series: a bounded ring of periodic registry
snapshots with counter-aware window queries.

Everything the registry (PR 4) exports is point-in-time: a scrape sees
the fleet NOW, and the moment before is gone. The autoscaler (ROADMAP 3)
and every alert condition worth declaring ("backlog per worker high for
30s", "data_wait-dominant for two windows") need *histories*. This
module gives each process one:

- **`TimeSeriesStore`**: a bounded deque of `(ts, {series: value})`
  samples taken from the registry's flat snapshot (the same names
  `/metrics` serves), plus any caller-provided *extra* series — the
  master feeds fleet aggregates computed from the heartbeat stats
  payloads it already receives (`fleet_series`, below). Sampling is
  rate-limited (`maybe_sample`, default every 5 s) so wiring it into a
  poll/heartbeat/step loop costs a clock read almost always.
- **counter awareness**: each series remembers its metric kind at sample
  time. `rate()` computes a per-second increase that survives counter
  RESETS (a process restart zeroes its counters; the increase since the
  reset is the post-reset value, Prometheus-style) — `delta()` is the
  same sum without the time division. `avg()`/`quantile()` read gauge
  series over a window.
- **rolling persistence**: with a history path configured, every sample
  appends one JSON line to `metrics_history.jsonl`; past
  `history_max_lines` the file is compacted to its newest half via the
  atomic tmp+`os.replace` discipline (EDL305) — the on-disk history is
  bounded like the in-memory ring. All file I/O happens OUTSIDE the
  store lock, and a write failure disables persistence loudly rather
  than costing the sampler again and again.
- **`GET /timeseries`** (observability/http.py) serves `to_payload()`:
  recent samples + per-series window stats, so a scraper (or the
  incident CLI's operator) can pull the history without ssh.

Stdlib-only and jax-free like the rest of the package; the store lock is
a LEAF lock (nothing inside it acquires anything else).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from elasticdl_tpu_torch.common.log_utils import default_logger
# the ONE median implementation (health.py owns it — its docstring warns
# that diverging copies let the scorer's threshold math and the exported
# fleet statistics disagree); health.py does not import this module, so
# the import is cycle-free
from elasticdl_tpu_torch.observability.health import median as _median
from elasticdl_tpu_torch.observability.registry import (
    MetricsRegistry,
    default_registry,
    quantile_sorted,
)

logger = default_logger(__name__)

#: default sampling cadence (seconds) — coarse enough that a per-step
#: maybe_sample() is a clock read, fine enough for minute-scale alerting
INTERVAL_DEFAULT_S = 5.0

#: default ring capacity (samples): 720 x 5 s = one hour of history
CAPACITY_DEFAULT = 720

#: default on-disk bound for metrics_history.jsonl before compaction
HISTORY_MAX_LINES = 4096

#: the canonical history filename (docs/observability.md "Time series")
HISTORY_BASENAME = "metrics_history.jsonl"


def _reset_aware_delta(pts: List[Tuple[float, float]]) -> float:
    """Counter increase over (ts, value) points, surviving RESETS: a
    sample lower than its predecessor means the counter restarted from
    zero, and the post-reset value IS the increase since (Prometheus
    rate() semantics). The one implementation delta() and the
    /timeseries payload share."""
    total = 0.0
    prev = pts[0][1]
    for _, v in pts[1:]:
        total += (v - prev) if v >= prev else v
        prev = v
    return total


def _snapshot_with_kinds(registry: MetricsRegistry):
    """(values, kinds) in ONE pass over the registry — kind is "counter"
    or "gauge" for rate awareness. Summary series decompose: `_count`/
    `_sum` behave like counters, quantile series like gauges. One pass
    because this runs on the sampling cadence and each metric snapshot
    has real cost (histogram reservoirs sort)."""
    values: Dict[str, float] = {}
    kinds: Dict[str, str] = {}
    for metric in registry.metrics():
        try:
            snap = metric.snapshot()
        except Exception:
            # one broken metric must not take sampling down:
            # edl-lint: disable=EDL303
            continue
        values.update(snap)
        if metric.kind == "counter":
            for name in snap:
                kinds[name] = "counter"
        elif metric.kind == "summary":
            for name in snap:
                base = name.split("{", 1)[0]
                kinds[name] = (
                    "counter"
                    if base.endswith("_count") or base.endswith("_sum")
                    else "gauge"
                )
        else:
            for name in snap:
                kinds[name] = "gauge"
    return values, kinds


class TimeSeriesStore:
    """Bounded ring of registry snapshots + window queries over it."""

    def __init__(self, capacity: int = CAPACITY_DEFAULT,
                 interval_s: float = INTERVAL_DEFAULT_S,
                 registry: Optional[MetricsRegistry] = None,
                 history_path: Optional[str] = None,
                 history_max_lines: int = HISTORY_MAX_LINES):
        self._registry = registry or default_registry()
        self.interval_s = max(0.0, float(interval_s))
        self._lock = threading.Lock()
        self._samples: "deque[Tuple[float, Dict[str, float]]]" = deque(
            maxlen=max(8, int(capacity)))                # guarded_by: _lock
        self._kinds: Dict[str, str] = {}                 # guarded_by: _lock
        self._last_sample_ts = 0.0                       # guarded_by: _lock
        self._sample_count = 0                           # guarded_by: _lock
        self.history_path = history_path or None
        self._history_max_lines = max(16, int(history_max_lines))
        self._history_lines = 0         # appended since the last compaction
        self._history_failed = False

    # ------------------------------------------------------------------ #
    # configuration

    def configure(self, history_path: Optional[str] = None,
                  interval_s: Optional[float] = None,
                  capacity: Optional[int] = None) -> "TimeSeriesStore":
        """(Re)point the store; None keeps the current value. "" for
        history_path means memory-only."""
        if history_path is not None:
            self.history_path = history_path or None
            self._history_failed = False
            self._history_lines = 0
        if interval_s is not None:
            self.interval_s = max(0.0, float(interval_s))
        if capacity is not None:
            with self._lock:
                self._samples = deque(
                    self._samples, maxlen=max(8, int(capacity)))
        return self

    # ------------------------------------------------------------------ #
    # sampling

    def maybe_sample(self, now: Optional[float] = None,
                     extra_fn: Optional[Callable[[], Dict[str, float]]]
                     = None) -> bool:
        """Take a sample iff the interval elapsed (the cheap call loops
        wire in — a lock + clock compare when not due). `extra_fn` is
        only invoked when a sample is actually taken (fleet aggregation
        has a real cost; don't pay it 5x/second for nothing)."""
        now = time.time() if now is None else now
        with self._lock:
            if now - self._last_sample_ts < self.interval_s:
                return False
        extra = None
        if extra_fn is not None:
            try:
                extra = extra_fn()
            except Exception:
                # the sampler is called from control loops whose contract
                # is "never raises" — a broken aggregator costs its
                # series, not the master: edl-lint: disable=EDL303
                logger.exception("time-series extra_fn failed; sampling "
                                 "registry only")
        self.sample(now=now, extra=extra)
        return True

    def sample(self, now: Optional[float] = None,
               extra: Optional[Dict[str, float]] = None) -> Dict[str, float]:
        """Unconditionally snapshot the registry (+ extra series) into the
        ring; returns the sampled values. Never raises."""
        now = time.time() if now is None else now
        try:
            values, kinds = _snapshot_with_kinds(self._registry)
        except Exception:
            # a broken metric callback must not take sampling down:
            # edl-lint: disable=EDL303
            values, kinds = {}, {}
        if extra:
            for k, v in extra.items():
                try:
                    values[k] = float(v)
                except (TypeError, ValueError):
                    continue
                # extra series follow the metric naming convention:
                # *_total reads as a counter, everything else as a gauge
                kinds.setdefault(
                    k, "counter" if k.endswith("_total") else "gauge")
        with self._lock:
            self._samples.append((now, values))
            self._kinds.update(kinds)
            self._last_sample_ts = now
            self._sample_count += 1
        self._persist(now, values)
        return values

    @property
    def sample_count(self) -> int:
        with self._lock:
            return self._sample_count

    # ------------------------------------------------------------------ #
    # window queries

    def window(self, series: str, window_s: float,
               now: Optional[float] = None) -> List[Tuple[float, float]]:
        """(ts, value) pairs for `series` within the last `window_s`
        seconds (ascending ts; samples where the series is absent are
        skipped — a series can appear mid-history)."""
        now = time.time() if now is None else now
        lo = now - max(0.0, float(window_s))
        with self._lock:
            return [
                (ts, vals[series])
                for ts, vals in self._samples
                if lo <= ts <= now and series in vals
            ]

    def latest(self, series: str,
               now: Optional[float] = None,
               max_age_s: Optional[float] = None) -> Optional[float]:
        """Most recent value of `series` (None = never sampled, or older
        than `max_age_s` when given)."""
        with self._lock:
            for ts, vals in reversed(self._samples):
                if series in vals:
                    if max_age_s is not None:
                        now_ = time.time() if now is None else now
                        if now_ - ts > max_age_s:
                            return None
                    return vals[series]
        return None

    def kind(self, series: str) -> str:
        with self._lock:
            return self._kinds.get(series, "gauge")

    def delta(self, series: str, window_s: float,
              now: Optional[float] = None) -> Optional[float]:
        """Counter increase over the window, RESET-aware: a sample lower
        than its predecessor means the counter restarted from zero, and
        the post-reset value IS the increase since (Prometheus rate()
        semantics). None = fewer than 2 samples in the window."""
        pts = self.window(series, window_s, now=now)
        if len(pts) < 2:
            return None
        return _reset_aware_delta(pts)

    def rate(self, series: str, window_s: float,
             now: Optional[float] = None) -> Optional[float]:
        """Per-second counter rate over the window (reset-aware); None =
        not enough samples or a zero-width window."""
        pts = self.window(series, window_s, now=now)
        if len(pts) < 2:
            return None
        span = pts[-1][0] - pts[0][0]
        if span <= 0:
            return None
        d = self.delta(series, window_s, now=now)
        return None if d is None else d / span

    def avg(self, series: str, window_s: float,
            now: Optional[float] = None) -> Optional[float]:
        pts = self.window(series, window_s, now=now)
        if not pts:
            return None
        return sum(v for _, v in pts) / len(pts)

    def quantile(self, series: str, q: float, window_s: float,
                 now: Optional[float] = None) -> Optional[float]:
        pts = self.window(series, window_s, now=now)
        if not pts:
            return None
        return quantile_sorted(sorted(v for _, v in pts), q)

    def series_names(self) -> List[str]:
        with self._lock:
            names = set()
            for _, vals in self._samples:
                names.update(vals)
            return sorted(names)

    # ------------------------------------------------------------------ #
    # /timeseries payload

    def to_payload(self, window_s: float = 300.0,
                   series: Optional[Iterable[str]] = None,
                   now: Optional[float] = None) -> Dict:
        """What GET /timeseries serves: recent samples (sparse — only
        requested/changed series) + per-series window stats. Cheap: one
        ring copy under the lock, arithmetic outside."""
        now = time.time() if now is None else now
        lo = now - max(0.0, float(window_s))
        with self._lock:
            samples = [(ts, dict(vals)) for ts, vals in self._samples
                       if ts >= lo]
            kinds = dict(self._kinds)
            count = self._sample_count
        wanted = set(series) if series else None
        names: set = set()
        for _, vals in samples:
            names.update(vals)
        if wanted is not None:
            names &= wanted
        stats: Dict[str, Dict] = {}
        for name in sorted(names):
            pts = [(ts, vals[name]) for ts, vals in samples
                   if name in vals]
            if not pts:
                continue
            vs = sorted(v for _, v in pts)
            entry: Dict = {
                "kind": kinds.get(name, "gauge"),
                "points": len(pts),
                "latest": pts[-1][1],
                "avg": sum(vs) / len(vs),
                "p99": quantile_sorted(vs, 0.99),
            }
            if entry["kind"] == "counter" and len(pts) >= 2:
                span = pts[-1][0] - pts[0][0]
                total = _reset_aware_delta(pts)
                entry["delta"] = total
                if span > 0:
                    entry["rate_per_s"] = total / span
            stats[name] = entry
        return {
            "ts": now,
            "window_s": float(window_s),
            "interval_s": self.interval_s,
            "sample_count": count,
            "samples_in_window": len(samples),
            "series": stats,
            "samples": [
                {"ts": ts,
                 "values": ({k: v for k, v in vals.items() if k in wanted}
                            if wanted is not None else vals)}
                for ts, vals in samples
            ],
        }

    # ------------------------------------------------------------------ #
    # rolling history file

    def _persist(self, ts: float, values: Dict[str, float]) -> None:
        """Append one history line; compact past the line bound. File I/O
        happens with NO store lock held and never raises — persistence is
        an observability convenience, not a correctness surface."""
        path = self.history_path
        if not path or self._history_failed:
            return
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            line = json.dumps(
                {"ts": round(ts, 3), "values": values}, sort_keys=True)
            with open(path, "a", encoding="utf-8") as f:
                f.write(line + "\n")
            self._history_lines += 1
            if self._history_lines >= self._history_max_lines:
                self._compact_history(path)
        except OSError:
            # disable loudly ONCE: a full/readonly disk must not cost the
            # sampler an exception per interval forever
            self._history_failed = True
            logger.exception(
                "metrics history persistence to %s failed; disabled", path)

    def _compact_history(self, path: str) -> None:
        """Rewrite the history to its newest half, atomically (tmp +
        os.replace — EDL305): the on-disk file stays bounded at ~1.5x
        history_max_lines worst case."""
        with open(path, encoding="utf-8") as f:
            lines = f.readlines()
        keep = lines[-(self._history_max_lines // 2):]
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.writelines(keep)
        os.replace(tmp, path)
        self._history_lines = 0

    def close(self) -> None:
        """Nothing buffered to flush (appends land per sample); kept for
        symmetric lifecycle wiring."""


# ---------------------------------------------------------------------- #
# fleet aggregation (master-side): heartbeat stats records -> series

#: profiler phase keys summed for the data_wait fraction
_PHASE_KEYS = ("phase_data_wait_ms", "phase_h2d_ms", "phase_compute_ms",
               "phase_handoff_ms")


def fleet_series(health_records: List[Dict],
                 straggler_count: int = 0,
                 todo_tasks: Optional[int] = None,
                 alive_workers: Optional[int] = None,
                 stale_after_s: float = 30.0,
                 now: Optional[float] = None) -> Dict[str, float]:
    """Fleet-level series computed from the per-worker heartbeat stats
    records `Membership` already accumulates — the master's `extra_fn`
    for `maybe_sample()`, and the sensor set the default alert rules
    (observability/alerts.py) read. Every series is a gauge named
    `edl_fleet_*`:

    - `edl_fleet_workers_reporting`       workers with fresh telemetry
    - `edl_fleet_step_p50_ms_median`      fleet median of step-time p50s
    - `edl_fleet_straggler_count`         pass-through from ClusterHealth
    - `edl_fleet_backlog_per_worker`      dispatcher todo / alive workers
    - `edl_fleet_data_wait_frac`          median fraction of step time
                                          spent blocked on input
    - `edl_fleet_emb_pull_p99_ms`         worst client OWNER-RPC pull p99
    - `edl_fleet_emb_read_p99_ms`         worst effective read p99
                                          (cache/pipeline included)
    - `edl_fleet_emb_hot_id_share`        worst hot-id traffic share
    - `edl_fleet_emb_shard_imbalance`     worst shard load imbalance
    - `edl_fleet_emb_cache_hit_rate`      WORST (lowest) recent hot-row
                                          cache hit rate — the hot-set
                                          migration / collapse sensor

    Embedding series appear only when at least one worker's payload
    carried them (the tier is optional). Absence of a series is visible
    to rules as "no data" — they carry active alerts forward rather than
    clearing on blindness.
    """
    now = time.time() if now is None else now

    def num(rec: Dict, key: str) -> Optional[float]:
        # heartbeat payloads admit STRING values too (decode_stats keeps
        # v[:64] from a mixed-version worker) — a non-numeric value must
        # read as absent, never raise out of the master's sampler
        v = rec.get(key)
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            return None
        return float(v)

    fresh = [
        r for r in health_records
        if now - (num(r, "updated_at") or 0.0) <= stale_after_s
    ]
    out: Dict[str, float] = {
        "edl_fleet_workers_reporting": float(len(fresh)),
        "edl_fleet_straggler_count": float(straggler_count),
    }
    p50s = [v for v in (num(r, "step_p50_ms") for r in fresh)
            if v is not None and v > 0.0]
    if p50s:
        out["edl_fleet_step_p50_ms_median"] = round(_median(p50s), 3)
    if todo_tasks is not None and int(alive_workers or 0) > 0:
        # backlog PER WORKER is undefined with zero alive workers (all
        # churning mid-poll): emitting todo/1 there would hand the
        # autoscaler's grow rule a fake spike exactly when the fleet is
        # least able to absorb an action — absence reads as no-data and
        # the rules (and the autoscaler) hold position instead
        out["edl_fleet_backlog_per_worker"] = round(
            float(todo_tasks) / int(alive_workers), 3)
    fracs = []
    for r in fresh:
        total = sum(num(r, k) or 0.0 for k in _PHASE_KEYS)
        if total > 0:
            fracs.append((num(r, "phase_data_wait_ms") or 0.0) / total)
    if fracs:
        out["edl_fleet_data_wait_frac"] = round(_median(fracs), 4)
    for key, series in (
        ("emb_pull_p99_ms", "edl_fleet_emb_pull_p99_ms"),
        ("emb_read_p99_ms", "edl_fleet_emb_read_p99_ms"),
        ("emb_hot_id_share", "edl_fleet_emb_hot_id_share"),
        ("emb_shard_imbalance", "edl_fleet_emb_shard_imbalance"),
    ):
        vals = [v for v in (num(r, key) for r in fresh) if v is not None]
        if vals:
            # the WORST reporter: alerting on the max is what catches one
            # melting owner in an otherwise-healthy fleet
            out[series] = round(max(vals), 4)
    hit_rates = [v for v in (num(r, "emb_cache_hit_rate") for r in fresh)
                 if v is not None]
    if hit_rates:
        # worst here is the MINIMUM: one worker whose hot set migrated
        # out from under its cache must not hide behind the fleet's
        # still-warm average (the embedding_cache_hit_collapse rule
        # reads this series). Absent when no worker runs a cache — the
        # rule sees "no data" and stays quiet, never a fake zero.
        out["edl_fleet_emb_cache_hit_rate"] = round(min(hit_rates), 4)
    for key, series in (
        # data-plane degradation shares (ISSUE 19): worst reporter, so
        # one worker riding the degraded ladder (or falling back from
        # its shm ring to gRPC fleet-wide) is visible even while the
        # fleet average looks clean
        ("emb_degraded_share", "edl_fleet_emb_degraded_share"),
        ("emb_shm_fallback_share", "edl_fleet_emb_shm_fallback_share"),
    ):
        vals = [v for v in (num(r, key) for r in fresh) if v is not None]
        if vals:
            out[series] = round(max(vals), 4)
    return out


# ---------------------------------------------------------------------- #
# process singleton (master/worker/cohort share one store per process;
# the http endpoint falls back to it when none is wired explicitly)

_STORE: Optional[TimeSeriesStore] = None
_STORE_LOCK = threading.Lock()


def get_store() -> TimeSeriesStore:
    global _STORE
    with _STORE_LOCK:
        if _STORE is None:
            _STORE = TimeSeriesStore()
        return _STORE


def history_path_for(cfg, role: str) -> Optional[str]:
    """Where a JobConfig implies metrics_history.jsonl should land:
    `<summary_dir|checkpoint_dir>/timeseries/<role>/metrics_history.jsonl`
    (None = memory-only)."""
    base = getattr(cfg, "summary_dir", "") or getattr(
        cfg, "checkpoint_dir", "")
    if not base:
        return None
    slug = (role or "proc").replace("/", "_").replace(" ", "_")
    return os.path.join(base, "timeseries", slug, HISTORY_BASENAME)


def configure_from_config(cfg, role: str) -> TimeSeriesStore:
    """Entrypoint helper (master/worker/cohort): point the process store
    at the job's history location and cadence."""
    store = get_store()
    store.configure(
        history_path=history_path_for(cfg, role) or "",
        interval_s=getattr(cfg, "timeseries_interval_s", None),
        capacity=getattr(cfg, "timeseries_samples", None),
    )
    return store


def reset_for_tests() -> None:
    global _STORE
    with _STORE_LOCK:
        _STORE = None
