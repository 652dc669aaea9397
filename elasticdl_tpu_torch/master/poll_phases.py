"""Wait-poll phase attribution: where does one master poll pass spend
its wall?

The master's wait loop runs a fixed pipeline every ``poll_s`` —
membership reap, dispatcher poke, health scoring, goodput rollup,
time-series sampling, alert evaluation, autoscale decision. At 64
workers the whole pass is sub-millisecond and nobody cares; at
thousands of cohorts any one phase can quietly eat the poll budget and
starve the rest (the control-plane cliff the fleet soak exists to
find). ``edl_master_poll_phase_seconds{phase}`` breaks the pass down so
a slow poll names its culprit instead of being one opaque number.

Shared by the production wait loop (master/main.py) and the fleet
simulator's virtual poll (fleetsim/sim.py) so both report through the
same series. Phase timing is REAL wall (perf_counter) even under a
virtual clock — the whole point is to measure what the master's own
code costs, which no amount of time compression changes.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict

from elasticdl_tpu_torch.observability.registry import default_registry

#: bounded phase vocabulary (metric label values)
PHASES = (
    "membership", "dispatcher", "health", "goodput", "timeseries",
    "alerts", "autoscaler",
)

_reg = default_registry()
_POLL_PHASE = _reg.histogram(
    "edl_master_poll_phase_seconds",
    "wall seconds one master wait-poll pass spent in each phase "
    "(membership reap / dispatcher poke / health / goodput / "
    "timeseries / alerts / autoscaler)",
    labels=("phase",))


@contextmanager
def poll_phase(phase: str):
    """Time one phase of a poll pass into the labeled histogram."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        # phase values come from the bounded PHASES vocabulary at every
        # call site: edl-lint: disable=EDL405
        _POLL_PHASE.observe(time.perf_counter() - t0, phase=phase)


def phase_wall_summary() -> Dict[str, Dict[str, float]]:
    """Per-phase {count, p50_ms, p99_ms} — the soak's poll-wall
    breakdown artifact."""
    out: Dict[str, Dict[str, float]] = {}
    for phase in PHASES:
        n = _POLL_PHASE.count(phase=phase)
        if not n:
            continue
        out[phase] = {
            "count": n,
            "p50_ms": round(_POLL_PHASE.quantile(0.5, phase=phase) * 1e3, 4),
            "p99_ms": round(_POLL_PHASE.quantile(0.99, phase=phase) * 1e3, 4),
        }
    return out
