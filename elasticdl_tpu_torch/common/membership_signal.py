"""Master -> worker pending-membership announcement (file-based).

The rescale fast path wants workers to know a resize is COMING before the
teardown lands, so the speculative compiler can precompile the announced
world size (training/compile_cache.py). The natural channel would be a
`pending_world_size` field on HeartbeatResponse, but this image's proto
toolchain cannot regenerate message bindings (no protoc/grpcio-tools), so
the announcement rides a small JSON file on storage both sides already
share — the log/checkpoint directory for the local process manager, a
mounted volume or ConfigMap in the k8s flavor. Writes are atomic
(tmp + rename), readers tolerate a missing/garbled file (None), and the
file is advisory: losing it degrades to the pre-announcement behavior
(the resize still happens, just against a colder cache).

The process manager exports the path to spawned workers as
`EDL_PENDING_WORLD_FILE`.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Optional

ENV_VAR = "EDL_PENDING_WORLD_FILE"

logger = logging.getLogger(__name__)


def write_signal(
    path: str,
    *,
    world_size: int,
    pending_size: Optional[int] = None,
    world_version: int = 0,
    trace_id: Optional[str] = None,
    master_generation: int = 0,
) -> bool:
    """Atomically (re)write the membership signal. Best-effort: a failed
    write is logged and must never take the caller (the master's watch
    loop) down with it.

    `trace_id` stitches the resize's observability timeline across roles:
    the master stamps the reform trace id here, workers adopt it for their
    rescale/boot spans (observability/tracing.py) — one resize, one trace
    id in both `trace.jsonl` files.

    `master_generation` (master/journal.py; 0 = no journal) marks WHICH
    master wrote the announcement, so a reader — and a successor master at
    takeover — can tell a live plan from one a dead master left behind."""
    payload = {
        "world_size": int(world_size),
        "pending_size": None if pending_size is None else int(pending_size),
        "world_version": int(world_version),
        "trace_id": trace_id or None,
        "master_generation": int(master_generation),
    }
    try:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
        return True
    except OSError:
        logger.exception("membership signal write failed (%s)", path)
        return False


def read_signal(path: Optional[str] = None) -> Optional[dict]:
    """Read the signal file (default: $EDL_PENDING_WORLD_FILE). None when
    unset, missing, or unreadable — all meaning 'no announcement'."""
    path = path or os.environ.get(ENV_VAR, "")
    if not path:
        return None
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return None
    return data if isinstance(data, dict) else None


def trace_id(path: Optional[str] = None) -> Optional[str]:
    """The announced resize's trace id, or None (no announcement / an
    announcement written before tracing existed)."""
    data = read_signal(path)
    if not data:
        return None
    tid = data.get("trace_id")
    return str(tid) if tid else None


def pending_size(path: Optional[str] = None) -> Optional[int]:
    """The announced next world size, or None when nothing is pending."""
    data = read_signal(path)
    if not data:
        return None
    pending = data.get("pending_size")
    try:
        return int(pending) if pending is not None else None
    except (TypeError, ValueError):
        return None


def master_generation(path: Optional[str] = None) -> int:
    """The generation of the master that wrote the signal (0 = unknown /
    written by a journal-less master)."""
    data = read_signal(path)
    if not data:
        return 0
    try:
        return int(data.get("master_generation") or 0)
    except (TypeError, ValueError):
        return 0


def default_path(base_dir: str = "") -> str:
    """Where the signal file lives for this process: the exported env path
    when the process manager set one, else `<base_dir>/membership_signal.json`
    (the manager's own default base is its log dir or the checkpoint dir).
    "" when neither is known."""
    env_path = os.environ.get(ENV_VAR, "")
    if env_path:
        return env_path
    return os.path.join(base_dir, "membership_signal.json") if base_dir else ""


def clear_stale_on_takeover(path: str, *, master_generation: int) -> bool:
    """A restarted master takes over: drop the dead master's announced plan
    (pending world size + reform trace id) so workers' speculative
    compilers stop precompiling against it, and stamp the file with the new
    master generation. The observed world_size/world_version survive — they
    describe the workers, which did not restart. No file, nothing stale:
    returns False without creating one (the next real announcement will).
    """
    data = read_signal(path)
    if data is None:
        return False
    ok = write_signal(
        path,
        world_size=int(data.get("world_size") or 0),
        pending_size=None,
        world_version=int(data.get("world_version") or 0),
        trace_id=None,
        master_generation=master_generation,
    )
    if ok:
        logger.warning(
            "membership signal cleared at master takeover (generation %d): "
            "pending plan %r dropped", master_generation,
            data.get("pending_size"),
        )
    return ok
