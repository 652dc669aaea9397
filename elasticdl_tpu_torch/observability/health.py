"""Cluster health intelligence: heartbeat-piggybacked worker telemetry and
the master's robust straggler scorer.

PR 4 gave every process eyes (registry, spans, /metrics); nothing
*interpreted* that telemetry — stragglers were invisible until they missed
heartbeats entirely and got reaped. This module closes the loop:

- **Worker side** (`WorkerStepStats`, `encode_stats`): each worker keeps a
  bounded window of recent step times/records and piggybacks a compact
  JSON stats payload onto its existing Heartbeat RPC as gRPC metadata
  (`edl-worker-stats`). Metadata, not a proto field, because this image
  cannot regenerate message bindings (no protoc — the same constraint that
  shaped the membership signal file and the generation handshake), and
  metadata is exactly as optional as the payload must be: an old worker
  heartbeating a new master simply sends none and degrades to
  liveness-only; a new worker heartbeating an old master is ignored.
- **Master side** (`ClusterHealth` over `Membership`'s rolling per-worker
  health records): a median/MAD robust scorer over the fleet's step-time
  p50s. Median/MAD instead of mean/stddev because the statistic must not
  be dragged by the very outlier it is hunting — one 10x straggler shifts
  a mean-based z-score enough to hide itself. Scores feed cluster rollup
  gauges (`edl_cluster_*`, served by the master's /metrics), edge-triggered
  `cluster.straggler` trace events, and a pluggable hook — the seam the
  closed-loop autoscaler (master/autoscaler.py, ISSUE 14) subscribes to
  for drain-first straggler eviction; log-only when the autoscaler is
  off.

Everything here is stdlib-only and jax-free, like the rest of the
observability package, and strictly best-effort: a malformed payload, a
scorer hiccup, or a dead scrape endpoint must never touch liveness
handling or training. See docs/observability.md ("Cluster health").
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from elasticdl_tpu_torch.common.log_utils import default_logger
from elasticdl_tpu_torch.observability import tracing
from elasticdl_tpu_torch.observability.registry import (
    default_registry,
    quantile_sorted,
)

logger = default_logger(__name__)

#: gRPC metadata key the worker stats payload rides on (lowercase per
#: gRPC spec; absent = liveness-only heartbeat, the back-compat shape)
STATS_METADATA_KEY = "edl-worker-stats"

#: decode() rejects payloads past this — a corrupt/hostile value must cost
#: a bounded parse attempt, never master memory (key budget raised for
#: ISSUE 11's embedding skew ride-along — emb_* keys below — again for
#: ISSUE 12's goodput-ledger ride-along: up to 9 gp_* keys per worker,
#: observability/goodput.py payload schema, and again for ISSUE 19's
#: request-diary rollup: up to 7 rt_*/share keys per worker,
#: observability/reqtrace.py payload schema)
MAX_PAYLOAD_BYTES = 3584
MAX_PAYLOAD_KEYS = 56

#: step-profiler keys (observability/profile.py snapshot schema) plus the
#: embedding-tier skew keys (embedding/tier.tier_stats) carried from a
#: worker's health record into its straggler info — the WHY behind a
#: straggler flag ("blocked on input" / "melting under tier pulls")
_PROFILE_KEYS = (
    "phase_data_wait_ms", "phase_h2d_ms", "phase_compute_ms",
    "phase_handoff_ms", "mem_host_mb", "mem_dev_mb",
    "emb_pull_p99_ms", "emb_hot_id_share", "emb_shard_imbalance",
    # ISSUE 13 read path: effective (cache-included) read p99, recent
    # cache hit rate (the hot-set-migration sensor), pipeline lookahead
    "emb_read_p99_ms", "emb_cache_hit_rate", "emb_pipeline_depth",
    # ISSUE 19 tail attribution: the request-diary recorder's compact
    # rollup (observability/reqtrace.py payload schema) plus the
    # degraded/shm-fallback shares the fleet series aggregates
    "rt_slow", "rt_slow_wall_s", "rt_dom", "rt_dom_share",
    "rt_known_share", "emb_degraded_share", "emb_shm_fallback_share",
)

# cluster rollup gauges (master-side; docs/observability.md)
_reg = default_registry()
_CL_REPORTING = _reg.gauge(
    "edl_cluster_workers_reporting",
    "alive workers with fresh step telemetry this rollup")
_CL_SKEW = _reg.gauge(
    "edl_cluster_step_time_skew",
    "slowest/median step-time-p50 ratio (1.0 = uniform fleet)")
_CL_STRAGGLERS = _reg.gauge(
    "edl_cluster_straggler_count", "workers currently scored as stragglers")
_CL_SLOWEST = _reg.gauge(
    "edl_cluster_slowest_worker",
    "worker id with the highest step-time p50 (-1 = no data)")
_CL_FASTEST = _reg.gauge(
    "edl_cluster_fastest_worker",
    "worker id with the lowest step-time p50 (-1 = no data)")
_CL_MEDIAN = _reg.gauge(
    "edl_cluster_step_time_median_seconds",
    "fleet median of per-worker step-time p50s")
_CL_EVENTS = _reg.counter(
    "edl_cluster_straggler_events_total",
    "straggler onset detections (edge-triggered)")


# ---------------------------------------------------------------------- #
# payload codec (both sides import these; the schema lives here)


def encode_stats(stats: Dict) -> str:
    """Compact, ASCII-safe JSON for a gRPC metadata value."""
    return json.dumps(stats, separators=(",", ":"), sort_keys=True)


def decode_stats(raw: Optional[str]) -> Optional[Dict]:
    """Parse a heartbeat stats payload; None for anything that is not a
    well-formed, size-bounded JSON object. NEVER raises — a worker from a
    different build (mid-rolling-restart) sending tomorrow's schema, or
    garbage, degrades that heartbeat to liveness-only."""
    if not raw or not isinstance(raw, str) or len(raw) > MAX_PAYLOAD_BYTES:
        return None
    try:
        data = json.loads(raw)
    except ValueError:
        return None
    if not isinstance(data, dict) or len(data) > MAX_PAYLOAD_KEYS:
        return None
    out: Dict = {}
    for k, v in data.items():
        if not isinstance(k, str):
            return None
        # scalars only — the record is a flat metrics row, and bounding
        # the value shapes here bounds master memory per worker forever
        if isinstance(v, bool) or isinstance(v, (int, float)):
            out[k] = v
        elif isinstance(v, str):
            out[k] = v[:64]
        # anything else (nested containers, null) is dropped, not fatal
    return out


# ---------------------------------------------------------------------- #
# worker side


class WorkerStepStats:
    """Bounded window of recent step timings, summarized into the
    heartbeat payload. Thread-safe: the train loop observes, the heartbeat
    thread snapshots. The lock is a LEAF lock (nothing inside it acquires
    anything else), so observing from the hot loop cannot deadlock."""

    def __init__(self, window: int = 128):
        self._lock = threading.Lock()
        self._steps: "deque[float]" = deque(maxlen=window)   # guarded_by: _lock
        self._records: "deque[float]" = deque(maxlen=window)  # guarded_by: _lock

    def observe_step(self, seconds: float, records: float = 0.0) -> None:
        with self._lock:
            self._steps.append(float(seconds))
            self._records.append(float(records))

    def snapshot(self) -> Dict:
        """The timing half of the heartbeat payload (ms keep the JSON
        compact; the master converts back to seconds for scoring)."""
        with self._lock:
            steps = list(self._steps)
            records = list(self._records)
        if not steps:
            return {"steps": 0}
        s = sorted(steps)
        wall = sum(steps)
        return {
            "steps": len(steps),
            "step_p50_ms": round(1e3 * quantile_sorted(s, 0.5), 3),
            "step_p90_ms": round(1e3 * quantile_sorted(s, 0.9), 3),
            "step_max_ms": round(1e3 * s[-1], 3),
            "records_per_s": round(sum(records) / wall, 3) if wall > 0 else 0.0,
        }


# ---------------------------------------------------------------------- #
# master side


def median(values: List[float]) -> float:
    """Plain median (0.0 for empty) — the ONE center statistic the scorer
    and the rollup report share; diverging implementations would let the
    threshold math and the exported median_step_time_s disagree."""
    if not values:
        return 0.0
    s = sorted(values)
    mid = len(s) // 2
    return s[mid] if len(s) % 2 else 0.5 * (s[mid - 1] + s[mid])


def robust_scores(values: List[float], *, abs_floor_s: float = 1e-3,
                  rel_floor: float = 0.05) -> List[float]:
    """Robust z-scores via median/MAD. The scale gets two floors — an
    absolute one (sub-millisecond MADs on a quiet fleet would make micro-
    jitter look like a 100-sigma event) and one relative to the median
    (5%: a fleet whose steps agree to within measurement noise has MAD ~ 0,
    and dividing by it would flag everyone). 1.4826 makes MAD consistent
    with a Gaussian sigma, so the threshold reads in sigmas."""
    if not values:
        return []
    med = median(values)
    mad = median([abs(v - med) for v in values])
    scale = max(1.4826 * mad, rel_floor * med, abs_floor_s)
    return [(v - med) / scale for v in values]


class ClusterHealth:
    """Fleet-level interpretation of the per-worker health records
    `Membership` accumulates from heartbeat telemetry.

    `update()` (the master's wait-loop calls it every poll, next to
    `membership.reap()`) recomputes the rollup: which alive workers have
    FRESH telemetry, the fleet median/MAD of their step-time p50s, robust
    scores, and the straggler set — a worker is a straggler when its score
    clears `threshold` sigmas AND its p50 is at least `min_ratio` x the
    median (the ratio gate keeps a statistically-odd-but-harmless 2%
    deviation from paging anyone). Detection is edge-triggered: the
    `cluster.straggler` event and the hooks fire once at onset (and
    `cluster.straggler_cleared` at recovery), not every poll.

    Hooks are the elasticity-decision seam: the closed-loop autoscaler
    (master/autoscaler.py) records straggler onsets here and decides on
    the wait poll; the built-in hook just logs. A hook that raises is
    logged + counted (edl_hook_errors_total{source=cluster_health}) and
    dropped from the failing invocation — scoring must survive its
    consumers.
    """

    def __init__(
        self,
        membership,
        *,
        threshold: float = 3.0,
        min_ratio: float = 1.5,
        min_workers: int = 3,
        stale_after_s: float = 30.0,
        on_straggler: Optional[Callable[[Dict], None]] = None,
    ):
        self._membership = membership
        self.threshold = float(threshold)
        self.min_ratio = float(min_ratio)
        # the scoring quorum (--straggler_quorum; config validates >= 2
        # at boot, this floor backstops direct constructions): with 2
        # reporters the median IS one of them, but the min_ratio gate
        # still decides "who is slow" — a 2-worker fleet must be able to
        # flag its straggler; with 1 the question is undecidable
        self.min_workers = max(2, int(min_workers))
        self.stale_after_s = float(stale_after_s)
        self._hooks: List[Callable[[Dict], None]] = [self._log_action]
        if on_straggler is not None:
            self._hooks.append(on_straggler)
        self._lock = threading.Lock()
        self._straggling: Dict[int, Dict] = {}       # guarded_by: _lock
        self._last: Dict = {                          # guarded_by: _lock
            "ts": 0.0,
            "workers_reporting": 0,
            "straggler_count": 0,
            "stragglers": [],
        }

    def add_hook(self, cb: Callable[[Dict], None]) -> None:
        """cb(straggler_info) fires once per straggler ONSET."""
        self._hooks.append(cb)

    @staticmethod
    def _log_action(info: Dict) -> None:
        logger.warning(
            "STRAGGLER: worker %s step p50 %.1fms vs fleet median %.1fms "
            "(score %.1f); no action taken (log-only policy)",
            info.get("worker_id"), 1e3 * info.get("step_time_p50_s", 0.0),
            1e3 * info.get("median_step_time_s", 0.0), info.get("score", 0.0),
        )

    # ------------------------------------------------------------------ #

    def update(self, now: Optional[float] = None) -> Dict:
        """Recompute the rollup; returns the snapshot. Never raises (the
        master's wait loop calls this unconditionally)."""
        try:
            return self._update(now)
        except Exception:
            logger.exception("cluster health rollup failed; keeping last")
            return self.snapshot()

    def _update(self, now: Optional[float] = None) -> Dict:
        now = time.time() if now is None else now
        records = self._membership.health_snapshot()
        fresh = [
            r for r in records
            if now - float(r.get("updated_at") or 0.0) <= self.stale_after_s
            and float(r.get("step_p50_ms") or 0.0) > 0.0
        ]
        p50s = [float(r["step_p50_ms"]) / 1e3 for r in fresh]
        # scoring needs a quorum: with 2 reporters the median IS one of
        # them and "who is slow" is undecidable
        scorable = len(fresh) >= self.min_workers
        snap: Dict = {
            "ts": now,
            "workers_alive": len(records),
            "workers_reporting": len(fresh),
            "straggler_count": 0,
            "stragglers": [],
            "median_step_time_s": 0.0,
            "max_step_time_s": 0.0,
            "skew": 1.0,
            "slowest_worker": -1,
            "fastest_worker": -1,
        }
        stragglers: List[Dict] = []
        if p50s:
            med = median(p50s)
            snap["median_step_time_s"] = round(med, 6)
            snap["max_step_time_s"] = round(max(p50s), 6)
            if med > 0:
                snap["skew"] = round(max(p50s) / med, 4)
            slowest = max(fresh, key=lambda r: float(r["step_p50_ms"]))
            fastest = min(fresh, key=lambda r: float(r["step_p50_ms"]))
            snap["slowest_worker"] = int(slowest.get("worker_id", -1))
            snap["fastest_worker"] = int(fastest.get("worker_id", -1))
            if scorable:
                scores = robust_scores(p50s)
                # quorum-2 fleets: with exactly two reporters the
                # median/MAD score is structurally capped at ~0.67 sigma
                # (each value is equidistant from their midpoint), so the
                # sigma threshold alone could NEVER fire — the min_ratio
                # gate decides instead (p50 >= 1.5x the pair median means
                # >= 3x the peer). More reporters restore the full
                # two-gate rule.
                pair = len(fresh) == 2
                for r, x, score in zip(fresh, p50s, scores):
                    if (score >= self.threshold or pair) \
                            and x >= self.min_ratio * med:
                        info = {
                            "worker_id": int(r.get("worker_id", -1)),
                            "worker_name": str(r.get("name", "")),
                            "score": round(score, 2),
                            "step_time_p50_s": round(x, 6),
                            "median_step_time_s": round(med, 6),
                            "phase": str(r.get("phase", "")),
                        }
                        # the step profiler's per-phase breakdown + memory
                        # watermarks (observability/profile.py), when the
                        # worker's payload carried them: the difference
                        # between "worker 3 is slow" and "worker 3 is
                        # blocked on its input pipeline"
                        for key in _PROFILE_KEYS:
                            if key in r:
                                info[key] = r[key]
                        stragglers.append(info)

        # "Cleared" must mean SCORED HEALTHY (or left the fleet) — not
        # "we lost the ability to score". A flagged worker whose telemetry
        # went stale, or a fleet that dropped below quorum mid-incident,
        # carries the flag forward: emitting cleared there would close the
        # incident spuriously and double-count the onset (event + hooks)
        # when scoring resumes.
        alive_ids = {int(r.get("worker_id", -1)) for r in records}
        fresh_ids = {int(r.get("worker_id", -1)) for r in fresh}
        with self._lock:
            previous = dict(self._straggling)
            current = {info["worker_id"]: info for info in stragglers}
            for wid, info in previous.items():
                if wid not in current and wid in alive_ids and (
                    not scorable or wid not in fresh_ids
                ):
                    current[wid] = info      # still flagged, not re-scorable
            onset = [
                info for wid, info in current.items() if wid not in previous
            ]
            cleared = [
                info for wid, info in previous.items() if wid not in current
            ]
            self._straggling = current
            snap["scorable"] = scorable
            snap["straggler_count"] = len(current)
            snap["stragglers"] = sorted(
                current.values(), key=lambda i: i["worker_id"]
            )
            self._last = snap

        _CL_REPORTING.set(snap["workers_reporting"])
        _CL_SKEW.set(snap["skew"])
        _CL_STRAGGLERS.set(snap["straggler_count"])
        _CL_SLOWEST.set(snap["slowest_worker"])
        _CL_FASTEST.set(snap["fastest_worker"])
        _CL_MEDIAN.set(snap["median_step_time_s"])

        # events + hooks OUTSIDE the lock (trace emission is file I/O —
        # edl-lint EDL402 codifies exactly this)
        for info in onset:
            _CL_EVENTS.inc()
            tracing.event("cluster.straggler", **info)
            for hook in self._hooks:
                try:
                    hook(dict(info))
                except Exception:
                    # swallowed (scoring must survive its consumers) but
                    # never dark: counted + named (observability/hooks.py)
                    from elasticdl_tpu_torch.observability.hooks import (
                        observe_hook_failure,
                    )

                    observe_hook_failure("cluster_health", hook, logger)
        for info in cleared:
            tracing.event(
                "cluster.straggler_cleared", worker_id=info["worker_id"],
            )
            logger.info(
                "straggler cleared: worker %s scored back inside the fleet "
                "envelope (or left the fleet)", info["worker_id"],
            )
        return snap

    def snapshot(self, now: Optional[float] = None) -> Dict:
        """The last computed rollup (cheap; /healthz serves this — a
        scrape must never trigger a recompute, and scoring never depends
        on the scrape surface being alive). `snapshot_age_s` stamps how
        stale the cached rollup is AT SERVE TIME (-1 = never computed):
        a scraper reading a wedged master's /healthz must be able to
        tell a live rollup from one frozen at the wedge."""
        with self._lock:
            snap = dict(self._last)
        ts = float(snap.get("ts") or 0.0)
        now = time.time() if now is None else now
        snap["snapshot_age_s"] = (
            round(max(0.0, now - ts), 3) if ts > 0 else -1.0
        )
        return snap
