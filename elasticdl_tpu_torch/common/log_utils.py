"""Uniform logger factory.

Reference parity: elasticdl/python/common/log_utils.py — plus the
observability hooks: `EDL_LOG_JSON=1` switches the formatter to structured
JSON lines carrying `role`, `world_version`, and the active
`trace_id`/`span_id` (so log lines join against trace.jsonl on trace id),
and the plain format gains a `[role]` prefix once a role is set.

The trace context comes from a registered provider
(observability/tracing.py injects `context_for_logs` at import) — this
module stays import-cycle-free and usable before observability loads.
"""

import json
import logging
import os
import sys
import time
from typing import Callable, Dict, Optional

_FORMAT = (
    "[%(asctime)s] [%(levelname)s] "
    "[%(name)s:%(lineno)d] %(message)s"
)

_configured = False
_role = ""
# () -> {"role": ..., "world_version": ..., "trace_id"?, "span_id"?}
_context_provider: Optional[Callable[[], Dict[str, object]]] = None


def set_role(role: str) -> None:
    """Stamp this process's role (master / worker-N / bench) on every log
    record — and, through observability.tracing, on every span."""
    global _role
    _role = role


def get_role() -> str:
    return _role


def set_context_provider(fn: Callable[[], Dict[str, object]]) -> None:
    """Register the trace-context source for formatters (called by
    observability.tracing at import; injectable for tests)."""
    global _context_provider
    _context_provider = fn


def _context() -> Dict[str, object]:
    ctx: Dict[str, object] = {}
    if _context_provider is not None:
        try:
            ctx = dict(_context_provider())
        except Exception:
            ctx = {}
    if _role and not ctx.get("role"):
        ctx["role"] = _role
    return ctx


class _PlainFormatter(logging.Formatter):
    """The classic format, prefixed with the role once one is known."""

    def format(self, record: logging.LogRecord) -> str:
        line = super().format(record)
        role = _context().get("role")
        return f"[{role}] {line}" if role else line


class _JsonFormatter(logging.Formatter):
    """One JSON object per line, joinable against trace.jsonl: shares the
    `role` / `world_version` / `trace_id` / `span_id` keys and schema."""

    def format(self, record: logging.LogRecord) -> str:
        out: Dict[str, object] = {
            "ts": round(record.created or time.time(), 6),
            "level": record.levelname,
            "logger": record.name,
            "line": record.lineno,
            "msg": record.getMessage(),
        }
        out.update(_context())
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out)


def make_formatter() -> logging.Formatter:
    if os.environ.get("EDL_LOG_JSON", "") in ("1", "true", "yes"):
        return _JsonFormatter()
    return _PlainFormatter(_FORMAT)


def default_logger(name: str = "elasticdl_tpu_torch") -> logging.Logger:
    global _configured
    if not _configured:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(make_formatter())
        root = logging.getLogger("elasticdl_tpu_torch")
        root.addHandler(handler)
        root.setLevel(os.environ.get("EDL_LOG_LEVEL", "INFO").upper())
        root.propagate = False
        _configured = True
    return logging.getLogger(name)
