"""Per-request diaries for the embedding data plane, tail-sampled.

The tier can see aggregates (histograms, the goodput ledger, skew
telemetry) but nothing explains an *individual* slow call: when
`emb_read_p99_ms` spikes, the postmortem needs to know whether that
p99 burned its time in budget wait, the hedge race, a breaker verdict,
shm vs gRPC, server-side queueing, the store gather, or the codec.
This module answers that with **request diaries** under **tail-based
sampling**:

- every data-plane call opens a cheap in-memory stage ledger (a
  `Diary`): enter/exit deltas per stage, accumulated on the CALLER
  thread so stage seconds are non-overlapping by construction and sum
  to the call's wall clock (the goodput ledger's total-attribution
  invariant, applied per request — the residual lands in `other`);
- at finish, only diaries that ended **slow** (wall beyond a
  p99-derived per-op threshold), **errored**, or **degraded** are
  retained in a bounded ring; everything else is dropped at O(1) cost
  (a deque append + two counter bumps), which is what keeps the
  bench's `obs_overhead` ≤2% gate honest with diaries ON;
- retained diaries roll up three ways: a per-process
  `edl_emb_p99_attribution_seconds{stage}` decomposition (stages sum
  to the retained wall), a compact `rt_*` heartbeat payload the
  master's fleet series and the dominant-stage-shift alert read, and a
  `diaries` block in flight-recorder bundles that the incident CLI
  renders as `slow_calls` stage waterfalls.

Instrumentation sites call the module-level helpers — `stage()`,
`attribute()`, `event()` — which attribute into the calling thread's
ACTIVE diaries and no-op (one thread-local read) when there are none,
so the tier, the transports, and the server can be instrumented
without threading a diary handle through every signature. Diaries
NEST (the tier opens one per fused read, the transport one per owner
call, on the same thread): the thread-local is a stack and a stage
lands in every open diary, so each keeps its own sum-to-wall
invariant. Hedge worker threads have no active diary by design: their
wire time is the caller's `hedge` wait, and counting both would break
the attribution invariant.

Stdlib-only, jax-free, strictly best-effort, like the rest of the
package. See docs/observability.md ("Request diaries").
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque
from typing import Dict, Iterator, List, Optional

from elasticdl_tpu_torch.observability.registry import (
    default_registry, quantile_sorted)

#: the stage vocabulary — the diary payload schema. `attribute()` folds
#: unknown names into `other` (a typo'd stage must not grow the label
#: set), and `other` is also where the unattributed residual lands so a
#: diary's stages ALWAYS sum to its wall clock.
STAGES = (
    "dedupe",       # tier-side id unique/partition before the wire
    "budget_wait",  # retry backoff sleeps + deadline-budget acquire
    "breaker",      # breaker verdicts and breaker-blocked waits
    "wire",         # a gRPC (or sim-wire) attempt, caller-side
    "shm",          # a same-host shared-memory ring round-trip
    "hedge",        # waiting on the hedge race after the hedge fired
    "serve_queue",  # server-side: queueing before the store is touched
    "store",        # server-side: the store gather/apply itself
    "codec",        # proto encode/decode + row blob segmentation
    "other",        # the residual — wall minus everything attributed
)

FINISH_STATUSES = ("ok", "error", "degraded")

#: retained-ring default; small — only tails live here
RING_DEFAULT = 256

#: worst retained diaries exported per flight bundle
BUNDLE_SLOW_CALLS = 16

#: per-op wall-clock window the slow threshold derives from
WINDOW = 128

#: finishes per op between threshold recomputes (sorting the window on
#: every finish would cost ~µs on a path budgeted in single µs)
RECALC_EVERY = 32

#: minimum samples before the p99 threshold arms — until then only
#: error/degraded diaries retain (a cold process has no tail yet)
WARMUP = 32

#: threshold floor: guards the armed p99 against microsecond noise
FLOOR_S = float(os.environ.get("EDL_REQTRACE_FLOOR_US", "100")) * 1e-6

_reg = default_registry()
_DIARIES = _reg.counter(
    "edl_emb_reqtrace_diaries_total",
    "data-plane request diaries by outcome (tail-based sampling: "
    "retained_slow / retained_error / retained_degraded / dropped)",
    labels=("outcome",))
_ATTR = _reg.gauge(
    "edl_emb_p99_attribution_seconds",
    "cumulative per-stage seconds over this process's retained (tail) "
    "diaries — stages sum to edl_emb_reqtrace_slow_wall_seconds",
    labels=("stage",))
_SLOW_WALL = _reg.gauge(
    "edl_emb_reqtrace_slow_wall_seconds",
    "cumulative wall-clock seconds of retained diaries (the attribution "
    "gauge's invariant total)")
_THRESHOLD = _reg.gauge(
    "edl_emb_reqtrace_slow_threshold_seconds",
    "current p99-derived slow threshold per diary op",
    labels=("op",))

_TLS = threading.local()
_NULL_CTX = contextlib.nullcontext()


class Diary:
    """One call's stage ledger. Owned by the thread that started it;
    `events` may be appended from helper threads (list.append is
    atomic), stage attribution stays caller-thread-only."""

    __slots__ = ("op", "meta", "t0", "ts", "stages", "events",
                 "status", "detail", "wall_s")

    def __init__(self, op: str, clock, meta: Optional[Dict] = None):
        self.op = op
        self.meta = meta or {}
        self.t0 = clock()
        self.ts = time.time()   # wall-clock, for cross-bundle correlation
        self.stages: Dict[str, float] = {}
        self.events: List[Dict] = []
        self.status = "ok"
        self.detail = ""
        self.wall_s = 0.0

    def add(self, stage: str, seconds: float) -> None:
        if seconds <= 0:
            return
        if stage not in STAGES or stage == "other":
            stage = "other"
        self.stages[stage] = self.stages.get(stage, 0.0) + seconds

    def event(self, name: str, **fields) -> None:
        if len(self.events) < 64:    # bounded — diaries ride bundles
            self.events.append({"name": name, **fields})

    def to_dict(self) -> Dict:
        """The bundle/ring form. Stages are completed with the `other`
        residual here so sum(stages) == wall_s by construction."""
        stages = {s: round(v, 6) for s, v in self.stages.items()}
        attributed = sum(self.stages.values())
        stages["other"] = round(
            stages.get("other", 0.0) + max(0.0, self.wall_s - attributed),
            6)
        known = self.wall_s - stages["other"]
        return {
            "op": self.op,
            "ts": round(self.ts, 6),
            "wall_s": round(self.wall_s, 6),
            "status": self.status,
            "detail": self.detail,
            "stages": stages,
            "known_share": (round(max(0.0, known) / self.wall_s, 6)
                            if self.wall_s > 0 else 0.0),
            "events": list(self.events),
            "meta": dict(self.meta),
        }


# ---------------------------------------------------------------------- #
# caller-thread helpers — the instrumentation surface


def _stack() -> List[Diary]:
    s = getattr(_TLS, "stack", None)
    if s is None:
        s = _TLS.stack = []
    return s


def current() -> Optional[Diary]:
    s = getattr(_TLS, "stack", None)
    return s[-1] if s else None


def attribute(stage: str, seconds: float) -> None:
    """Attribute `seconds` to `stage` on every open diary of the
    calling thread; no-op (one thread-local read) when none are."""
    s = getattr(_TLS, "stack", None)
    if s:
        for d in s:
            d.add(stage, seconds)


def stage(name: str, clock=time.monotonic):
    """Context manager timing one stage on the thread's open diaries.
    Returns a shared null context when none are active — the disabled
    path allocates nothing."""
    s = getattr(_TLS, "stack", None)
    if not s:
        return _NULL_CTX
    return _StageCtx(tuple(s), name, clock)


class _StageCtx:
    __slots__ = ("_ds", "_name", "_clock", "_t0")

    def __init__(self, ds, name: str, clock):
        self._ds, self._name, self._clock = ds, name, clock

    def __enter__(self):
        self._t0 = self._clock()
        return self

    def __exit__(self, *exc):
        dt = self._clock() - self._t0
        for d in self._ds:
            d.add(self._name, dt)
        return False


def event(name: str, **fields) -> None:
    s = getattr(_TLS, "stack", None)
    if s:
        for d in s:
            d.event(name, **fields)


# ---------------------------------------------------------------------- #


class _OpWindow:
    """Per-op wall-clock window + cached p99-derived threshold."""

    __slots__ = ("walls", "count", "threshold_s", "next_recalc")

    def __init__(self):
        self.walls = deque(maxlen=WINDOW)
        self.count = 0
        self.threshold_s: Optional[float] = None   # None until armed
        self.next_recalc = WARMUP


class DiaryRecorder:
    """Process-wide diary sink: tail-based retention into a bounded
    ring, cumulative per-stage attribution, heartbeat payload, flight-
    bundle block. Thread-safe; the lock is a LEAF lock. The clock is
    monotonic (EDL406) — diary `ts` alone is wall-clock, for
    correlation."""

    def __init__(self, ring: int = RING_DEFAULT, clock=time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(1, int(ring)))  # guarded_by: _lock
        self._ops: Dict[str, _OpWindow] = {}                 # guarded_by: _lock
        self._attr: Dict[str, float] = {}                    # guarded_by: _lock
        self._slow_wall = 0.0                                # guarded_by: _lock
        self._finished = 0                                   # guarded_by: _lock
        self._by_status = {s: 0 for s in FINISH_STATUSES}    # guarded_by: _lock
        self._retained = 0                                   # guarded_by: _lock
        # previous payload() snapshot, for the windowed shares
        self._prev_payload: Optional[Dict[str, float]] = None  # guarded_by: _lock

    # ------------------------------------------------------------------ #
    # hot path

    def start(self, op: str, **meta) -> Diary:
        """Open a diary and push it onto the calling thread's stack.
        `op` values are call-site literals (pull / pull_multi / push /
        tier_pull / serve / …) — the label set stays bounded."""
        d = Diary(op, self._clock, meta or None)
        _stack().append(d)
        return d

    def finish(self, d: Optional[Diary], status: str = "ok",
               detail: str = "") -> bool:
        """Close the diary; True when it was retained. The drop path is
        O(1): a deque append, a cached-threshold compare, two counter
        bumps."""
        if d is None:
            return False
        s = getattr(_TLS, "stack", None)
        if s and d in s:
            s.remove(d)
        d.wall_s = max(0.0, self._clock() - d.t0)
        d.status = status if status in FINISH_STATUSES else "error"
        d.detail = detail[:512]
        recalc_op = None
        with self._lock:
            win = self._ops.get(d.op)
            if win is None:
                win = self._ops[d.op] = _OpWindow()
            win.walls.append(d.wall_s)
            win.count += 1
            if win.count >= win.next_recalc:
                win.threshold_s = max(
                    FLOOR_S, quantile_sorted(sorted(win.walls), 0.99))
                win.next_recalc = win.count + RECALC_EVERY
                recalc_op = (d.op, win.threshold_s)
            self._finished += 1
            self._by_status[d.status] += 1
            slow = (win.threshold_s is not None
                    and d.wall_s > win.threshold_s)
            retain = slow or d.status != "ok"
            if retain:
                rec = d.to_dict()
                self._ring.append(rec)
                self._retained += 1
                for s, v in rec["stages"].items():
                    self._attr[s] = self._attr.get(s, 0.0) + v
                self._slow_wall += rec["wall_s"]
        if recalc_op is not None:
            # outside the leaf lock: metric locks are leaves too, but
            # the ordering discipline stays trivial this way
            _THRESHOLD.set(recalc_op[1], op=recalc_op[0])
        if not retain:
            _DIARIES.inc(outcome="dropped")
            return False
        outcome = ("retained_" + d.status) if d.status != "ok" \
            else "retained_slow"
        _DIARIES.inc(outcome=outcome)
        with self._lock:
            attr = dict(self._attr)
            wall = self._slow_wall
        for s, v in attr.items():
            # keys come from Diary.to_dict over the bounded STAGES
            # vocabulary: edl-lint: disable=EDL405
            _ATTR.set(round(v, 6), stage=s)
        _SLOW_WALL.set(round(wall, 6))
        return True

    def abandon(self, d: Optional[Diary]) -> None:
        """Unbind without recording (a call that was never attempted)."""
        s = getattr(_TLS, "stack", None)
        if d is not None and s and d in s:
            s.remove(d)

    # ------------------------------------------------------------------ #
    # rollups

    def retained(self) -> List[Dict]:
        with self._lock:
            return list(self._ring)

    def threshold_s(self, op: str) -> Optional[float]:
        with self._lock:
            win = self._ops.get(op)
            return win.threshold_s if win else None

    def snapshot(self) -> Dict:
        """The full per-process attribution picture (tests + /debug)."""
        with self._lock:
            attr = {s: round(self._attr.get(s, 0.0), 6) for s in STAGES
                    if self._attr.get(s, 0.0) > 0}
            known = sum(v for s, v in attr.items() if s != "other")
            return {
                "finished": self._finished,
                "by_status": dict(self._by_status),
                "retained": self._retained,
                "ring_len": len(self._ring),
                "slow_wall_s": round(self._slow_wall, 6),
                "attribution": attr,
                "known_share": (round(known / self._slow_wall, 6)
                                if self._slow_wall > 0 else 0.0),
                "thresholds_s": {
                    op: round(w.threshold_s, 6)
                    for op, w in self._ops.items()
                    if w.threshold_s is not None
                },
            }

    def dominant_stage(self) -> Optional[str]:
        """The stage with the most cumulative retained seconds,
        preferring attributed stages over the `other` residual."""
        with self._lock:
            attr = dict(self._attr)
        if not attr:
            return None
        named = {s: v for s, v in attr.items() if s != "other"}
        pool = named or attr
        return max(sorted(pool), key=lambda s: pool[s])

    def payload(self) -> Dict[str, float]:
        """Compact heartbeat ride-along (bounded key count — the stats
        codec truncates past MAX_PAYLOAD_KEYS):

            rt_slow / rt_slow_wall_s   retained count + wall total
            rt_dom / rt_dom_share      dominant stage (STAGES index)
            rt_known_share             attributed (non-`other`) fraction
            emb_degraded_share         degraded finishes / finishes,
                                       windowed between payload calls
            emb_shm_fallback_share     shm fallbacks / shm attempts,
                                       windowed, from the shm counters
        """
        with self._lock:
            attr = dict(self._attr)
            wall = self._slow_wall
            retained = self._retained
            finished = self._finished
            degraded = self._by_status["degraded"]
        out: Dict[str, float] = {}
        if retained:
            out["rt_slow"] = float(retained)
            out["rt_slow_wall_s"] = round(wall, 3)
            named = {s: v for s, v in attr.items() if s != "other"}
            pool = named or attr
            dom = max(sorted(pool), key=lambda s: pool[s])
            out["rt_dom"] = float(STAGES.index(dom))
            if wall > 0:
                out["rt_dom_share"] = round(pool[dom] / wall, 4)
                out["rt_known_share"] = round(
                    sum(named.values()) / wall, 4)
        shm_calls, shm_fb = _shm_totals()
        cur = {
            "finished": float(finished), "degraded": float(degraded),
            "shm_calls": shm_calls, "shm_fb": shm_fb,
        }
        with self._lock:
            prev, self._prev_payload = self._prev_payload, cur
        if prev is not None:
            dfin = cur["finished"] - prev["finished"]
            ddeg = cur["degraded"] - prev["degraded"]
            if dfin > 0 and ddeg >= 0:
                out["emb_degraded_share"] = round(
                    min(1.0, ddeg / dfin), 4)
            dcalls = cur["shm_calls"] - prev["shm_calls"]
            dfb = cur["shm_fb"] - prev["shm_fb"]
            if dcalls + dfb > 0 and dfb >= 0 and dcalls >= 0:
                out["emb_shm_fallback_share"] = round(
                    min(1.0, dfb / (dcalls + dfb)), 4)
        return out

    def bundle_block(self) -> Optional[Dict]:
        """The flight-recorder `diaries` block: totals, the attribution
        decomposition, and the worst retained diaries (replay-identical
        to the ring's entries). None when nothing was ever recorded —
        absence must read as no-data, not as an empty tail."""
        with self._lock:
            if not self._finished:
                return None
            ring = list(self._ring)
            attr = {s: round(v, 6) for s, v in self._attr.items()}
            block = {
                "schema": 1,
                "finished": self._finished,
                "by_status": dict(self._by_status),
                "retained": self._retained,
                "dropped": self._finished - self._retained,
                "slow_wall_s": round(self._slow_wall, 6),
                "attribution": attr,
                "thresholds_s": {
                    op: round(w.threshold_s, 6)
                    for op, w in self._ops.items()
                    if w.threshold_s is not None
                },
            }
        worst = sorted(ring, key=lambda r: r["wall_s"], reverse=True)
        block["slow_calls"] = worst[:BUNDLE_SLOW_CALLS]
        return block


def _shm_totals():
    """(calls, fallbacks) totals from the shm counters, via the
    registry so this module never imports the embedding package."""
    calls = fb = 0.0
    m = _reg.get("edl_emb_shm_calls_total")
    if m is not None:
        try:
            calls = sum(m.snapshot().values())
        except Exception:
            # a broken metric must not break the heartbeat:
            # edl-lint: disable=EDL303
            calls = 0.0
    m = _reg.get("edl_emb_shm_fallbacks_total")
    if m is not None:
        try:
            fb = sum(m.snapshot().values())
        except Exception:
            # same contract: edl-lint: disable=EDL303
            fb = 0.0
    return calls, fb


# ---------------------------------------------------------------------- #
# fleet rollup (master side)


class FleetAttribution:
    """Stateful fleet view over heartbeat `rt_*` payloads: names the
    fleet-dominant slow stage and pulses `…_dom_shift` when it moves
    (wire -> budget_wait is the canonical partition signature) — the
    series the `emb_attr_dominant_shift` default alert rule watches.
    One instance lives on the master next to FleetGoodput; `series()`
    feeds the sampler extra. Absence of data emits nothing (no-data to
    the rules, never a zero)."""

    def __init__(self):
        self._prev_dom: Optional[int] = None

    def series(self, health_records: List[Dict],
               stale_after_s: float = 30.0,
               now: Optional[float] = None) -> Dict[str, float]:
        now = time.time() if now is None else now
        worst_wall = 0.0
        dom: Optional[int] = None
        known: Optional[float] = None
        for rec in health_records:
            try:
                updated = float(rec.get("updated_at") or 0.0)
            except (TypeError, ValueError):
                continue
            if now - updated > stale_after_s:
                continue
            wall = rec.get("rt_slow_wall_s")
            d = rec.get("rt_dom")
            if not isinstance(wall, (int, float)) or isinstance(wall, bool):
                continue
            if wall <= 0 or not isinstance(d, (int, float)):
                continue
            ks = rec.get("rt_known_share")
            if isinstance(ks, (int, float)) and not isinstance(ks, bool):
                known = ks if known is None else min(known, float(ks))
            # worst-reporter: the process with the largest retained slow
            # wall owns the fleet's tail story
            if wall >= worst_wall:
                worst_wall = float(wall)
                dom = int(d)
        if dom is None:
            return {}
        out = {"edl_fleet_emb_attr_dom_stage": float(dom)}
        shifted = self._prev_dom is not None and dom != self._prev_dom
        self._prev_dom = dom
        out["edl_fleet_emb_attr_dom_shift"] = 1.0 if shifted else 0.0
        if known is not None:
            out["edl_fleet_emb_attr_known_share"] = round(float(known), 4)
        return out


# ---------------------------------------------------------------------- #
# process singleton


_RECORDER: Optional[DiaryRecorder] = None
_RECORDER_LOCK = threading.Lock()


def get_recorder() -> DiaryRecorder:
    global _RECORDER
    with _RECORDER_LOCK:
        if _RECORDER is None:
            _RECORDER = DiaryRecorder()
        return _RECORDER


def reset_for_tests() -> None:
    global _RECORDER
    with _RECORDER_LOCK:
        _RECORDER = None
    _TLS.stack = []
