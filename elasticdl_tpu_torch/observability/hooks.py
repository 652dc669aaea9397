"""Shared decision-seam hook plumbing.

Both decision seams — `ClusterHealth.add_hook` (straggler onsets) and
`AlertEngine.add_hook` (alert onsets) — swallow consumer exceptions by
contract (scoring/evaluation must survive a crashing policy), but a
swallowed failure must never be DARK: it is counted on /metrics and
WARNING-logged with the hook's name, so a crashing autoscaler policy is
an incident visible in the flight ring, not a debug curiosity. One
helper so the two seams cannot drift (ISSUE 14 satellite + review
finding)."""

from __future__ import annotations

from elasticdl_tpu_torch.observability.registry import default_registry

_HOOK_ERRORS = default_registry().counter(
    "edl_hook_errors_total",
    "decision-seam hook callbacks that raised (swallowed, but counted)",
    labels=("source",))


def observe_hook_failure(source: str, hook, logger) -> None:
    """Count + name one swallowed hook exception. Call from inside the
    `except` block (logs with exc_info). `source` values come from the
    bounded two-seam literal set at every call site:
    edl-lint: disable=EDL405"""
    _HOOK_ERRORS.inc(source=source)
    logger.warning(
        "%s hook %s failed (swallowed; counted in "
        "edl_hook_errors_total{source=%s})",
        source,
        getattr(hook, "__qualname__", None)
        or getattr(hook, "__name__", repr(hook)),
        source,
        exc_info=True,
    )
