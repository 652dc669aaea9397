"""Incident flight recorder: a per-process black box for postmortems.

When a worker or master dies today, the evidence dies with it: spans are
sampled to per-process trace.jsonl files (best-effort, possibly torn),
health snapshots are point-in-time, and the last seconds before the death
are reconstructed by hand from N logs. This module gives every process a
bounded in-memory ring that records recent telemetry at FULL fidelity —
spans and events (subscribed from the tracer), structured log lines (a
logging handler), explicit records, and metric deltas — at near-zero
hot-path cost (a deque append under a leaf lock), and dumps it as one
atomic JSON bundle when something goes wrong.

Trigger matrix (docs/observability.md "Flight recorder"):

    unhandled exception    sys.excepthook wrapper -> reason "crash:<type>"
    fault-site crash       faults.add_crash_hook -> reason "fault:<site>"
                           (runs before the injector's os._exit)
    SIGUSR2                operator/offender trigger -> reason "sigusr2"
                           (the straggler hook's offender snapshot rides
                           this: ProcessManager.request_flight_dump)
    /debug/flight          ObservabilityServer endpoint -> reason "http"
                           (dump + the bundle served back)
    straggler onset        the master's ClusterHealth hook dumps the
                           MASTER's ring (reason "straggler:worker-N") and
                           the local launcher SIGUSR2s the offender
    explicit               FlightRecorder.dump(reason) — preemption drains,
                           chaos scenarios, tests
    atexit                 only with EDL_FLIGHT_DUMP_ON_EXIT=1 (a clean
                           exit is not an incident)

Bundle (`flight-<role>-<pid>.json`, written tmp + os.replace so a torn
bundle can only mean the writer itself died mid-incident):

    {"schema": 1, "kind": "flight", "role": ..., "pid": ..., "reason": ...,
     "ts": <wall s>, "world_version": ..., "dump_seq": N,
     "meta": {...configure()-time facts...},
     "records": [ring records, oldest first — tracer-schema spans/events,
                 {"kind": "log", ...} lines, explicit records],
     "metrics": {series: value},            # full registry snapshot
     "metrics_delta": {series: delta},      # vs the previous dump/mark
     "profile": {...step-profiler snapshot...},
     "goodput": {...goodput-ledger snapshot: per-category wall-clock
                 attribution at the moment the box was cut...}}

Everything here is stdlib-only, jax-free, and strictly best-effort: a
full ring, a failed dump, or a missing directory must never take the
process (or a concurrent /metrics scrape) down. The offline correlator
(`python -m elasticdl_tpu.observability.incident <dir>`) merges bundles
from every role into one timeline.
"""

from __future__ import annotations

import atexit
import json
import logging
import os
import signal
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from elasticdl_tpu_torch.common import faults
from elasticdl_tpu_torch.common.log_utils import default_logger
from elasticdl_tpu_torch.observability import tracing
from elasticdl_tpu_torch.observability.registry import (
    MetricsRegistry,
    default_registry,
)

logger = default_logger(__name__)

SCHEMA_VERSION = 1
BUNDLE_PREFIX = "flight-"

#: default ring capacity (records); env/config override
RING_DEFAULT = 4096
RING_ENV = "EDL_FLIGHT_RING"
#: env override for the bundle directory ("off" disables dumping)
DIR_ENV = "EDL_FLIGHT_DIR"
#: opt-in: also dump on clean interpreter exit
DUMP_ON_EXIT_ENV = "EDL_FLIGHT_DUMP_ON_EXIT"

_reg = default_registry()
_FL_RECORDS = _reg.counter(
    "edl_flight_records_total", "records appended to the flight ring")
_FL_DUMPS = _reg.counter(
    "edl_flight_dumps_total", "flight bundles dumped", labels=("reason",))
_FL_DUMP_FAILURES = _reg.counter(
    "edl_flight_dump_failures_total", "flight bundle writes that failed")


class FlightRecorder:
    """Bounded ring of recent telemetry + atomic bundle dumps.

    The ring lock is a LEAF lock (nothing inside it acquires anything
    else), so recording from the tracer's emit path, a log handler, or
    the train loop can never participate in a lock-order cycle. Dumps
    snapshot the ring under the lock and do ALL file I/O outside it, so
    a dump in progress never blocks recording or a /metrics scrape.
    """

    def __init__(self, ring: Optional[int] = None, role: str = "",
                 registry: Optional[MetricsRegistry] = None):
        size = ring if ring is not None else _ring_from_env()
        self._lock = threading.Lock()
        self._ring: "deque[dict]" = deque(maxlen=max(16, int(size)))  # guarded_by: _lock
        self._seq = 0                                 # guarded_by: _lock
        self.role = role
        self.dir: Optional[str] = None
        # optional filename disambiguator: several recorders for the SAME
        # role+pid (chaos scenarios run back-to-back in one pytest
        # process) must not clobber each other's bundles
        self.tag = ""
        self._meta: Dict[str, Any] = {}
        self._registry = registry or default_registry()
        self._baseline: Dict[str, float] = {}         # guarded_by: _lock
        self._dump_seq = 0                            # guarded_by: _lock
        self._dump_reasons: List[str] = []            # guarded_by: _lock
        self.last_dump_path: Optional[str] = None
        self._log_handler: Optional[logging.Handler] = None
        self._sink_attached = False

    # ------------------------------------------------------------------ #
    # configuration / subscriptions

    def configure(self, dir: Optional[str] = None, role: Optional[str] = None,
                  tag: Optional[str] = None, **meta: Any) -> "FlightRecorder":
        """(Re)point the recorder: bundle directory (None keeps, "" means
        memory-only — the ring still records, dumps are no-ops), role
        stamp, an optional filename `tag` (bundles become
        flight-<role>-<tag>-<pid>.json — scenario stems that must not
        overwrite each other), and any meta facts worth carrying into
        every bundle."""
        if role is not None:
            self.role = role
        if tag is not None:
            self.tag = tag
        if dir is not None:
            self.dir = dir or None
        if meta:
            self._meta.update(meta)
        return self

    def attach_tracing(self) -> "FlightRecorder":
        """Subscribe to the process tracer: every span/event record lands
        in the ring at full fidelity (the trace.jsonl file sink stays
        sampled/best-effort; the ring is the black box)."""
        if not self._sink_attached:
            tracing.get_tracer().add_sink(self._on_trace_record)
            self._sink_attached = True
        return self

    def detach_tracing(self) -> None:
        if self._sink_attached:
            tracing.get_tracer().remove_sink(self._on_trace_record)
            self._sink_attached = False

    def _on_trace_record(self, rec: dict) -> None:
        # called from Tracer._emit under the tracer lock: the ring append
        # below takes only the leaf ring lock — cheap and cycle-free
        self._append(dict(rec))

    def attach_logging(self, level: int = logging.INFO,
                       logger_name: str = "elasticdl_tpu_torch") -> "FlightRecorder":
        """Capture structured log lines (default: INFO and up from the
        project logger — a healthy run's registrations/restores/task flow
        are exactly the context a postmortem wants around the crash line;
        DEBUG stays out so a verbose run cannot wash the ring) into the
        ring. Idempotent."""
        if self._log_handler is not None:
            return self
        handler = _RingLogHandler(self)
        handler.setLevel(level)
        logging.getLogger(logger_name).addHandler(handler)
        self._log_handler = handler
        return self

    def detach_logging(self, logger_name: str = "elasticdl_tpu_torch") -> None:
        if self._log_handler is not None:
            logging.getLogger(logger_name).removeHandler(self._log_handler)
            self._log_handler = None

    # ------------------------------------------------------------------ #
    # recording

    def record(self, kind: str, name: str, **attrs: Any) -> None:
        """Append one explicit record (ts stamped here)."""
        rec = {"kind": kind, "name": name, "ts": time.time()}
        rec.update(attrs)
        rec.setdefault("role", self.role)
        self._append(rec)

    def _append(self, rec: dict) -> None:
        with self._lock:
            self._seq += 1
            rec.setdefault("seq", self._seq)
            self._ring.append(rec)
        _FL_RECORDS.inc()

    def snapshot(self) -> List[dict]:
        """Ring contents, oldest first (copies of the refs, cheap)."""
        with self._lock:
            return list(self._ring)

    def mark_metrics(self) -> None:
        """Reset the metric-delta baseline (dump() does this implicitly,
        so deltas read "since the last dump")."""
        snap = self._safe_metrics()
        with self._lock:
            self._baseline = snap

    def _safe_metrics(self) -> Dict[str, float]:
        try:
            return self._registry.snapshot()
        except Exception:
            # the bundle must still land without its metrics block:
            # edl-lint: disable=EDL303
            return {}

    # ------------------------------------------------------------------ #
    # dumping

    def bundle(self, reason: str) -> dict:
        """Assemble the bundle dict (no file I/O; /debug/flight serves
        this directly)."""
        metrics = self._safe_metrics()
        with self._lock:
            records = list(self._ring)
            baseline = dict(self._baseline)
            self._baseline = dict(metrics)
            self._dump_seq += 1
            dump_seq = self._dump_seq
            reasons = list(self._dump_reasons)
            self._dump_reasons.append(reason)
        delta = {
            k: round(v - baseline.get(k, 0.0), 9)
            for k, v in metrics.items()
            if v != baseline.get(k, 0.0)
        }
        out = {
            "schema": SCHEMA_VERSION,
            "kind": "flight",
            "role": self.role,
            "pid": os.getpid(),
            "reason": reason,
            "ts": time.time(),
            "world_version": tracing.get_tracer().world_version,
            "dump_seq": dump_seq,
            "prior_dump_reasons": reasons,
            "meta": dict(self._meta),
            "records": records,
            "metrics": metrics,
            "metrics_delta": delta,
        }
        try:
            from elasticdl_tpu_torch.observability import profile as profile_lib

            out["profile"] = profile_lib.get_profiler().snapshot()
        except Exception:
            # the profiler block is advisory; a bundle without it is still
            # a bundle: edl-lint: disable=EDL303
            pass
        try:
            from elasticdl_tpu_torch.observability import goodput as goodput_lib

            # the process's goodput attribution at the moment the box
            # was cut — the per-worker half of the incident's bill
            # (ISSUE 12; the fleet half rides health snapshots)
            out["goodput"] = goodput_lib.get_ledger().snapshot()
        except Exception:
            # advisory, same as the profiler block:
            # edl-lint: disable=EDL303
            pass
        try:
            from elasticdl_tpu_torch.observability import reqtrace

            # retained request diaries (ISSUE 19): the tail-sampled
            # slow/error/degraded calls the incident CLI renders as
            # `slow_calls` stage waterfalls. None when the data plane
            # never ran here — absence means no-data, not a clean tail.
            diaries = reqtrace.get_recorder().bundle_block()
            if diaries is not None:
                out["diaries"] = diaries
        except Exception:
            # advisory, same as the profiler block:
            # edl-lint: disable=EDL303
            pass
        return out

    def dump(self, reason: str, dir: Optional[str] = None,
             bundle: Optional[dict] = None) -> Optional[str]:
        """Write the bundle atomically as flight-<role>-<pid>.json under
        the configured (or given) directory; successive dumps overwrite —
        latest incident wins, prior reasons ride `prior_dump_reasons`.
        NEVER raises; returns the path, or None when disabled/failed.
        `bundle` lets a caller that already assembled one (/debug/flight)
        persist it without a second ring/metrics pass."""
        target_dir = dir or self.dir
        if bundle is None:
            bundle = self.bundle(reason)
        if not target_dir:
            return None
        def slug(s: str) -> str:
            return s.replace("/", "_").replace(" ", "_")

        stem = slug(self.role or "proc")
        if self.tag:
            stem += "-" + slug(self.tag)
        path = os.path.join(
            target_dir, f"{BUNDLE_PREFIX}{stem}-{os.getpid()}.json"
        )
        tmp = path + ".tmp"
        try:
            os.makedirs(target_dir, exist_ok=True)
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(bundle, f, default=repr)
                f.write("\n")
                f.flush()
                # a crash bundle exists precisely because the process is
                # dying: make it durable before the rename
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except Exception:
            _FL_DUMP_FAILURES.inc()
            logger.exception("flight bundle dump (%s) failed", reason)
            return None
        _FL_DUMPS.inc(reason=reason.split(":", 1)[0])
        self.last_dump_path = path
        logger.warning("flight bundle dumped (%s) -> %s", reason, path)
        return path


class _RingLogHandler(logging.Handler):
    """Log capture into the flight ring (formatted message + context)."""

    def __init__(self, recorder: FlightRecorder):
        super().__init__()
        self._recorder = recorder

    def emit(self, record: logging.LogRecord) -> None:
        try:
            self._recorder._append({
                "kind": "log",
                "name": record.name,
                "level": record.levelname,
                "msg": record.getMessage()[:512],
                "ts": record.created,
                "role": self._recorder.role,
            })
        except Exception:
            # log capture must never become a logging failure loop:
            # edl-lint: disable=EDL303
            pass


# ---------------------------------------------------------------------- #
# module-level singleton + trigger installation

_RECORDER: Optional[FlightRecorder] = None
_RECORDER_LOCK = threading.Lock()
_HOOKS_INSTALLED = False


def _ring_from_env() -> int:
    try:
        return int(os.environ.get(RING_ENV, "") or RING_DEFAULT)
    except ValueError:
        return RING_DEFAULT


def get_recorder() -> FlightRecorder:
    global _RECORDER
    with _RECORDER_LOCK:
        if _RECORDER is None:
            _RECORDER = FlightRecorder()
        return _RECORDER


def flight_dir_for(cfg) -> Optional[str]:
    """The bundle directory a JobConfig implies: cfg.flight_dir, else
    derived next to the job's other observability artifacts ("off"
    disables; EDL_FLIGHT_DIR overrides either way)."""
    env = os.environ.get(DIR_ENV)
    if env is not None and env.strip():
        return None if env.strip().lower() == "off" else env.strip()
    raw = getattr(cfg, "flight_dir", "") or ""
    if raw.lower() == "off":
        return None
    if raw:
        return raw
    base = getattr(cfg, "summary_dir", "") or getattr(
        cfg, "checkpoint_dir", ""
    )
    return os.path.join(base, "flight") if base else None


def configure_from_config(cfg, role: str) -> FlightRecorder:
    """Entrypoint helper (master/worker/cohort): point the process
    recorder at the job's flight dir, stamp the role, subscribe to the
    tracer and the project log stream."""
    rec = get_recorder()
    ring = getattr(cfg, "flight_ring", 0) or 0
    if ring and rec._ring.maxlen != ring:
        with rec._lock:
            rec._ring = deque(rec._ring, maxlen=max(16, int(ring)))
    rec.configure(dir=flight_dir_for(cfg) or "", role=role,
                  job_name=getattr(cfg, "job_name", ""))
    rec.attach_tracing()
    rec.attach_logging()
    return rec


def install_crash_hooks(recorder: Optional[FlightRecorder] = None) -> None:
    """Wire the crash-shaped triggers onto the process recorder:
    sys.excepthook (unhandled exception), the fault injector's pre-crash
    hook (`<site>:crash` schedules), SIGUSR2 (explicit/offender trigger),
    and the opt-in atexit dump. Idempotent per process."""
    global _HOOKS_INSTALLED
    rec = recorder or get_recorder()
    if _HOOKS_INSTALLED:
        return
    _HOOKS_INSTALLED = True

    prev_hook = sys.excepthook

    def _excepthook(etype, value, tb):
        try:
            rec.record("event", "flight.crash", error=repr(value)[:256])
            rec.dump(f"crash:{etype.__name__}")
        except Exception:
            # the original exception must still surface:
            # edl-lint: disable=EDL303
            pass
        prev_hook(etype, value, tb)

    sys.excepthook = _excepthook

    # a `crash` fault action os._exit's (skipping atexit); the injector
    # runs these hooks first so the black box survives the simulated kill
    faults.add_crash_hook(lambda site: rec.dump(f"fault:{site}"))

    # SIGUSR2 must NOT dump inline: the handler runs on the main thread
    # between bytecodes, and dump() acquires the tracer/ring/registry
    # locks + does file I/O — if the signal lands while the main thread
    # (the train loop) is inside Tracer._emit or a registry mutation, an
    # inline dump deadlocks the very worker the offender snapshot was
    # meant to diagnose. The handler only sets an Event; a dedicated
    # daemon thread (which holds none of those locks) does the dump.
    trigger = threading.Event()

    def _drain_sigusr2():
        while True:
            trigger.wait()
            trigger.clear()
            rec.dump("sigusr2")

    def _on_sigusr2(signum, frame):
        trigger.set()

    try:
        signal.signal(signal.SIGUSR2, _on_sigusr2)
    except (ValueError, AttributeError, OSError):
        # not the main thread (in-process test workers) or no SIGUSR2 on
        # this platform: the other triggers still stand
        pass
    else:
        threading.Thread(
            target=_drain_sigusr2, name="edl-flight-sigusr2", daemon=True
        ).start()

    if os.environ.get(DUMP_ON_EXIT_ENV, "").strip().lower() in (
        "1", "true", "yes"
    ):
        atexit.register(lambda: rec.dump("exit"))


def reset_for_tests() -> None:
    """Drop the singleton + hook latch (tests only; triggers installed on
    sys/signal are NOT unwound — they chain harmlessly)."""
    global _RECORDER, _HOOKS_INSTALLED
    with _RECORDER_LOCK:
        if _RECORDER is not None:
            _RECORDER.detach_tracing()
            _RECORDER.detach_logging()
        _RECORDER = None
    _HOOKS_INSTALLED = False
