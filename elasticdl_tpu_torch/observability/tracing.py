"""Span/trace layer for elastic lifecycle events.

One resize should read as ONE timeline: the master's announce/quiesce/
teardown/spawn phases and every worker's compile/handoff/requeue work,
joined by a shared trace id. The pieces:

- `span(name, **attrs)`: context manager; emits one JSONL record on exit
  with wall-clock start, duration, role, world version, trace/span/parent
  ids, and the given attributes. Spans nest through a `contextvars`
  context, so they follow the opening thread (gRPC handler threads get
  their context from `adopt`).
- `event(name, **attrs)`: a point-in-time record (task lease transitions,
  retry decisions, breaker flips) — same schema, no duration.
- propagation: `rpc_metadata()` returns the active (trace id, span id) as
  gRPC metadata pairs; the servicer side re-enters them via `adopt(...)`.
  For master->worker flows with no live RPC (a reform announcement), the
  trace id rides the membership signal file (`trace_id` field) and
  workers adopt it from there.

Records land in `trace.jsonl` (configured path) AND in a bounded
in-memory buffer (`get_tracer().records`) so tests and the bench can read
spans without filesystem coupling. With no configure() call everything
still works — records just stay in memory.

Schema (one JSON object per line):

    {"kind": "span"|"event", "name": ..., "trace_id": ..., "span_id": ...,
     "parent_id": ..., "role": ..., "world_version": ..., "ts": <wall s>,
     "dur_ms": <span only>, "error": <repr, spans that raised>, ...attrs}
"""

from __future__ import annotations

import contextvars
import json
import os
import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional, Tuple

#: gRPC metadata keys the trace context rides on (lowercase per gRPC spec)
TRACE_ID_KEY = "edl-trace-id"
SPAN_ID_KEY = "edl-span-id"

#: bounded in-memory record buffer (tests/bench read this)
BUFFER_RECORDS = 4096

_ctx: "contextvars.ContextVar[Optional[Tuple[str, str]]]" = (
    contextvars.ContextVar("edl_trace_ctx", default=None)
)


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def new_span_id() -> str:
    return uuid.uuid4().hex[:8]


class Span:
    """Handle yielded by `span(...)`: lets the body attach attributes."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "attrs")

    def __init__(self, name: str, trace_id: str, span_id: str,
                 parent_id: Optional[str], attrs: Dict):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.attrs = attrs

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)


class Tracer:
    """Process-local span recorder. Thread-safe; write failures disable the
    file sink (never the caller) — tracing is strictly best-effort."""

    def __init__(self):
        self._lock = threading.Lock()
        self._path: Optional[str] = None
        self._file = None
        self.role = ""
        self._world_version = 0
        self.records: "deque[dict]" = deque(maxlen=BUFFER_RECORDS)
        # record sinks (the flight recorder's full-fidelity ring rides
        # here): called per emitted record, under the tracer lock — a sink
        # must be CHEAP and leaf-locked only, and must never raise at us
        self._sinks: List = []

    # ------------------------------------------------------------------ #
    # configuration

    def configure(self, path: Optional[str] = None,
                  role: Optional[str] = None,
                  world_version: Optional[int] = None) -> None:
        """(Re)point the tracer. `path` opens (append) the JSONL sink —
        parent directories are created; an unopenable path logs once via
        the record buffer and stays memory-only."""
        with self._lock:
            if role is not None:
                self.role = role
            if world_version is not None:
                self._world_version = int(world_version)
            if path is not None and (path != self._path
                                     or self._file is None):
                self._close_locked()
                self._path = path
                try:
                    os.makedirs(
                        os.path.dirname(os.path.abspath(path)), exist_ok=True
                    )
                    # reconfigure path (boot / scenario swap), and the
                    # tracer lock is a leaf — no control-plane lock is
                    # ever held over configure():
                    # edl-lint: disable=EDL103
                    self._file = open(path, "a", encoding="utf-8")
                except OSError:
                    self._file = None
                    self._path = None

    def set_world_version(self, version: int) -> None:
        with self._lock:
            self._world_version = int(version)

    @property
    def world_version(self) -> int:
        with self._lock:
            return self._world_version

    @property
    def path(self) -> Optional[str]:
        with self._lock:
            return self._path

    # ------------------------------------------------------------------ #
    # emission

    def add_sink(self, fn) -> None:
        """Subscribe `fn(record_dict)` to every emitted record (the flight
        recorder's ring). Runs under the tracer lock: keep it to a leaf-
        locked append; exceptions are swallowed (emission is best-effort
        for sinks exactly as for the file)."""
        with self._lock:
            if fn not in self._sinks:
                self._sinks.append(fn)

    def remove_sink(self, fn) -> None:
        with self._lock:
            if fn in self._sinks:
                self._sinks.remove(fn)

    def _emit(self, rec: dict) -> None:
        with self._lock:
            rec.setdefault("role", self.role)
            rec.setdefault("world_version", self._world_version)
            self.records.append(rec)
            for sink in self._sinks:
                try:
                    sink(rec)
                except Exception:
                    # a broken sink must not cost the span (or the file
                    # sink below): edl-lint: disable=EDL303
                    continue
            if self._file is not None:
                try:
                    self._file.write(json.dumps(rec) + "\n")
                    self._file.flush()
                except (OSError, ValueError):
                    # ValueError: write to a closed file (teardown races)
                    self._file = None

    @contextmanager
    def span(self, name: str, *, trace_id: Optional[str] = None,
             parent_id: Optional[str] = None, **attrs) -> Iterator[Span]:
        parent = _ctx.get()
        tid = trace_id or (parent[0] if parent else new_trace_id())
        pid = parent_id if parent_id is not None else (
            parent[1] if parent and not trace_id else None
        )
        # an explicit trace_id starts/joins a foreign trace: the ambient
        # parent only applies when it belongs to the same trace
        if trace_id and parent and parent[0] == trace_id and parent_id is None:
            pid = parent[1]
        sid = new_span_id()
        handle = Span(name, tid, sid, pid, dict(attrs))
        token = _ctx.set((tid, sid))
        t_wall = time.time()
        t0 = time.perf_counter()
        error: Optional[str] = None
        try:
            yield handle
        except BaseException as e:
            error = repr(e)
            raise
        finally:
            _ctx.reset(token)
            rec = {
                "kind": "span",
                "name": name,
                "trace_id": tid,
                "span_id": sid,
                "parent_id": pid,
                "ts": t_wall,
                "dur_ms": round(1e3 * (time.perf_counter() - t0), 3),
            }
            if error is not None:
                rec["error"] = error
            rec.update(handle.attrs)
            self._emit(rec)

    def event(self, name: str, *, trace_id: Optional[str] = None, **attrs):
        parent = _ctx.get()
        tid = trace_id or (parent[0] if parent else None)
        rec = {
            "kind": "event",
            "name": name,
            "trace_id": tid,
            "parent_id": parent[1] if parent else None,
            "ts": time.time(),
        }
        rec.update(attrs)
        self._emit(rec)

    # ------------------------------------------------------------------ #

    @contextmanager
    def scoped(self, path: Optional[str] = None,
               role: Optional[str] = None,
               world_version: Optional[int] = None) -> Iterator["Tracer"]:
        """Temporarily repoint the tracer (file sink, role, world
        version) and restore EVERYTHING on exit — including the
        in-memory ring's prior contents. A simulation can flood
        thousands of spans through the real stack inside this block
        without leaving the process tracer full (a full ring makes
        every later `records[start:]` slice empty) or wearing the
        simulation's role on subsequent log lines."""
        with self._lock:
            prev_role = self.role
            prev_wv = self._world_version
            prev_path = self._path
            prev_had_file = self._file is not None
            prev_records = list(self.records)
        self.configure(path=path, role=role, world_version=world_version)
        try:
            yield self
        finally:
            with self._lock:
                self._close_locked()
                self._path = None
            if prev_path is not None and prev_had_file:
                self.configure(path=prev_path)
            with self._lock:
                self._path = prev_path
                self.role = prev_role
                self._world_version = prev_wv
                self.records.clear()
                self.records.extend(prev_records)

    def close(self) -> None:
        with self._lock:
            self._close_locked()

    def _close_locked(self) -> None:
        if self._file is not None:
            try:
                self._file.flush()
                # teardown flush of the leaf tracer lock (spans only
                # buffered-write on the hot path; fsync happens once, at
                # close/reconfigure): edl-lint: disable=EDL103
                os.fsync(self._file.fileno())
            except (OSError, ValueError):
                pass
            try:
                self._file.close()
            except (OSError, ValueError):
                pass
            self._file = None


# ---------------------------------------------------------------------- #
# module-level singleton + context plumbing

_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def configure(path: Optional[str] = None, role: Optional[str] = None,
              world_version: Optional[int] = None) -> Tracer:
    _TRACER.configure(path=path, role=role, world_version=world_version)
    return _TRACER


def span(name: str, **kw):
    return _TRACER.span(name, **kw)


def event(name: str, **kw) -> None:
    _TRACER.event(name, **kw)


def set_world_version(version: int) -> None:
    _TRACER.set_world_version(version)


def current_context() -> Optional[Tuple[str, str]]:
    """(trace_id, span_id) of the active span, or None."""
    return _ctx.get()


def current_trace_id() -> Optional[str]:
    ctx = _ctx.get()
    return ctx[0] if ctx else None


def rpc_metadata() -> Tuple[Tuple[str, str], ...]:
    """gRPC metadata pairs carrying the active trace context ((), when no
    span is open — callers skip the metadata kwarg entirely then)."""
    ctx = _ctx.get()
    if ctx is None:
        return ()
    return ((TRACE_ID_KEY, ctx[0]), (SPAN_ID_KEY, ctx[1]))


@contextmanager
def adopt(trace_id: str, parent_span_id: Optional[str] = None):
    """Enter a foreign trace context (the server side of an RPC hop, a
    worker picking up the master's reform trace id): spans opened inside
    join `trace_id` under `parent_span_id`."""
    token = _ctx.set((trace_id, parent_span_id or ""))
    try:
        yield
    finally:
        _ctx.reset(token)


def context_for_logs() -> Dict[str, object]:
    """What the JSON log formatter stamps on every record (log_utils pulls
    this through a registered provider — no import cycle)."""
    ctx = _ctx.get()
    out: Dict[str, object] = {
        "role": _TRACER.role,
        "world_version": _TRACER.world_version,
    }
    if ctx is not None:
        out["trace_id"] = ctx[0]
        out["span_id"] = ctx[1]
    return out


# log records share the trace context (EDL_LOG_JSON joins on trace_id)
from elasticdl_tpu_torch.common import log_utils as _log_utils  # noqa: E402

_log_utils.set_context_provider(context_for_logs)


# ---------------------------------------------------------------------- #
# trace analysis helpers (bench / tests)


def spans_for_trace(records, trace_id: str) -> List[dict]:
    """Span records of one trace, in emission (i.e. span-END) order."""
    return [
        r for r in records
        if r.get("kind") == "span" and r.get("trace_id") == trace_id
    ]


def phase_durations(records, trace_id: str,
                    prefix: str = "phase.") -> Dict[str, float]:
    """{phase_name: seconds} for `prefix`-named spans of one trace — the
    bench's per-phase recovery breakdown (compile / handoff / settle)."""
    out: Dict[str, float] = {}
    for r in spans_for_trace(records, trace_id):
        name = r["name"]
        if name.startswith(prefix):
            out[name[len(prefix):]] = round(
                out.get(name[len(prefix):], 0.0) + r["dur_ms"] / 1e3, 6
            )
    return out


def trace_path_for(trace_dir: str, summary_dir: str, role: str
                   ) -> Optional[str]:
    """The per-role trace.jsonl path a JobConfig implies ("" trace_dir
    derives <summary_dir>/trace; "off" disables the file sink)."""
    if (trace_dir or "").lower() == "off":
        return None
    base = trace_dir or (
        os.path.join(summary_dir, "trace") if summary_dir else ""
    )
    if not base:
        return None
    return os.path.join(base, role, "trace.jsonl")


def configure_from_config(cfg, role: str,
                          world_version: Optional[int] = None) -> Tracer:
    """Entrypoint helper: point the process tracer at the job's trace dir
    and stamp the role (master / worker-N / cohort-N)."""
    path = trace_path_for(
        getattr(cfg, "trace_dir", ""), getattr(cfg, "summary_dir", ""), role
    )
    if world_version is None:
        try:
            world_version = int(os.environ.get("EDL_WORLD_VERSION", "0") or 0)
        except ValueError:
            world_version = 0
    return configure(path=path, role=role, world_version=world_version)


def read_trace_file(path: str) -> List[dict]:
    """Parse a trace.jsonl (tolerating a truncated last line — the writer
    may have been killed mid-record)."""
    out: List[dict] = []
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue
    except OSError:
        return []
    return out
