"""Scenario schema: the fleet soak's *data, not code* contract.

A scenario is one JSON object — a seeded, replayable schedule of fleet
events over compressed VIRTUAL time. The same file + the same seed
produces the identical event log on every run (the determinism the
fleetsim tests pin), so a cliff found at 03:00 in CI replays exactly on
a laptop. Schema (see docs/soak.md for the annotated example):

```
{
  "name": "rack_failure",            // required, [a-z0-9_]+
  "description": "...",
  "seed": 42,                        // every RNG in the run derives here
  "duration_s": 600,                 // VIRTUAL seconds simulated
  "workers": 1000,                   // simulated logical workers
  "racks": 16,                       // workers round-robin onto racks
  "cohort_members": 0,               // member processes per worker
  "poll_s": 1.0,                     // master wait-poll cadence (virtual)
  "heartbeat_s": 10.0,               // worker beat period (virtual)
  "heartbeat_timeout_s": 30.0,
  "task_timeout_s": 120.0,
  "shards": 2000,                    // training shards (1 task each)
  "records_per_task": 4096,
  "epochs": 1,                       // dispatcher epochs (a small shard
                                     // set x many epochs = a steady
                                     // backdrop that never drains todo)
  "eval_task_records": 0,            // records per injected eval task
                                     // (0 = inject_tasks unavailable)
  "lease_batch": 4,                  // max_tasks per GetTask
  "step_ms": 100.0,                  // baseline per-step wall
  "records_per_s": 40000.0,          // per-worker retire rate
  "data_wait_frac": 0.05,            // baseline input-blocked fraction
  "group_commit_ms": 2.0,            // journal window (REAL ms)
  "wait_backoff_s": 2.0,
  "alert_window_scale": 1.0,         // shrink alert windows to match
                                     // the compressed timescale
  "autoscale": null | {              // omit/null = loop off
    "min_workers", "max_workers", "cooldown_s", "hold_s",
    "actions_max", "rescale_cost_s", "horizon_s",
    "damping", "reversal_hold_s"
  },
  "layout": null | {                 // omit/null = layout loop off
    "num_shards", "max_shards", "min_shards", "max_replicas",
    "hot_k", "cooldown_s", "hold_s", "actions_max",
    "migrate_cost_s", "horizon_s"
  },
  "events": [ {"at_s": 120, "action": "kill_rack", "rack": 3}, ... ]
}
```

Event actions (each validated against REQUIRED_EVENT_FIELDS):

- ``kill_rack {rack}`` / ``rejoin_rack {rack}`` — correlated failure:
  every worker on the rack dies (stops beating, mid-lease) / reboots.
- ``kill_workers {count}`` / ``rejoin_workers {count}`` — seeded-random
  uncorrelated death/revival waves.
- ``rolling_restart {batch, interval_s, down_s}`` — restart the fleet
  `batch` workers at a time, each down `down_s`.
- ``stagger_joins {over_s}`` — slow-joiner herd: initial registration
  spread over a window instead of t=0.
- ``straggle {count, factor, for_s}`` — seeded-random workers run
  `factor`× slower for a while (honest step quantiles follow).
- ``set_data_wait {frac, count?}`` — flip (part of) the fleet's
  input-blocked fraction; drives the shrink alert.
- ``popularity_flip {hot_share, pull_p99_ms, count?, hot_shard?}`` —
  embedding hot set migrates: payloads carry the new hot-id share /
  pull p99 so the embedding alert rules see it. With a ``layout``
  block, payloads additionally carry the per-shard load shares and
  sketch head (``emb_shard_loads`` / ``emb_hot_ids``) the layout
  controller aggregates — concentrated on ``hot_shard`` (default 0) —
  and the modelled imbalance/p99/hit-rate RECOVER as the controller's
  fan-out/split actions take effect, closing the loop.
- ``inject_tasks {count}`` — burst of evaluation tasks into the real
  dispatcher (the backlog / grow-alert driver). Each task carries
  ``eval_task_records`` records, so burst-drain time is tunable
  independently of the training backdrop.
- ``kill_master {down_s}`` — SIGKILL-equivalent master death under
  load (journal aborted, queued unacked commits lost), then a real
  replay-recovery restart; workers reconnect through the
  generation-fence → re-register handshake.

Virtual-time semantics: ``at_s``/durations are virtual seconds; the
scheduler jumps the clock between events so a 10-minute soak runs in
seconds of wall. All REAL costs (journal fsync, lock passes, poll-phase
wall) are measured in real time — that is the point of the harness.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

#: bounded action vocabulary; {action: required numeric fields}
REQUIRED_EVENT_FIELDS: Dict[str, tuple] = {
    "kill_rack": ("rack",),
    "rejoin_rack": ("rack",),
    "kill_workers": ("count",),
    "rejoin_workers": ("count",),
    "rolling_restart": ("batch", "interval_s", "down_s"),
    "stagger_joins": ("over_s",),
    "straggle": ("count", "factor", "for_s"),
    "set_data_wait": ("frac",),
    "popularity_flip": ("hot_share", "pull_p99_ms"),
    "inject_tasks": ("count",),
    "kill_master": ("down_s",),
}

_AUTOSCALE_KEYS = {
    "min_workers", "max_workers", "cooldown_s", "hold_s", "actions_max",
    "rescale_cost_s", "horizon_s", "damping", "reversal_hold_s",
}

_LAYOUT_KEYS = {
    "num_shards", "max_shards", "min_shards", "max_replicas", "hot_k",
    "cooldown_s", "hold_s", "actions_max", "migrate_cost_s", "horizon_s",
}


@dataclass
class Scenario:
    name: str
    description: str = ""
    seed: int = 0
    duration_s: float = 600.0
    workers: int = 64
    racks: int = 8
    cohort_members: int = 0
    poll_s: float = 1.0
    heartbeat_s: float = 10.0
    heartbeat_timeout_s: float = 30.0
    task_timeout_s: float = 120.0
    shards: int = 256
    records_per_task: int = 4096
    epochs: int = 1
    eval_task_records: int = 0
    lease_batch: int = 4
    step_ms: float = 100.0
    records_per_s: float = 40000.0
    data_wait_frac: float = 0.05
    group_commit_ms: float = 2.0
    wait_backoff_s: float = 2.0
    alert_window_scale: float = 1.0
    autoscale: Optional[Dict[str, float]] = None
    layout: Optional[Dict[str, float]] = None
    events: List[Dict[str, Any]] = field(default_factory=list)

    def override(self, **kw) -> "Scenario":
        """A copy with fields replaced (the bench's undamped-twin and
        CI fleet-size knobs). `autoscale` overrides MERGE into the
        scenario's autoscale block. The copy re-runs the full schema
        validation, so an override can't mint a scenario that
        load_scenario would have rejected."""
        import dataclasses

        merged = dict(kw)
        if "autoscale" in merged and self.autoscale is not None \
                and merged["autoscale"] is not None:
            base = dict(self.autoscale)
            base.update(merged["autoscale"])
            merged["autoscale"] = base
        if "layout" in merged and self.layout is not None \
                and merged["layout"] is not None:
            base = dict(self.layout)
            base.update(merged["layout"])
            merged["layout"] = base
        out = dataclasses.replace(self, **merged)
        return validate_scenario(dataclasses.asdict(out))


def _fail(name: str, msg: str) -> ValueError:
    return ValueError(f"scenario {name!r}: {msg}")


def validate_scenario(raw: Dict[str, Any]) -> Scenario:
    """Dict → Scenario, or a ValueError that names the offending field —
    a scenario is config handed to a 1000-worker soak, and a typo must
    fail at load, not 400 virtual seconds in."""
    if not isinstance(raw, dict):
        raise ValueError("scenario must be a JSON object")
    name = str(raw.get("name") or "")
    if not name or not all(c.isalnum() or c == "_" for c in name):
        raise ValueError(
            f"scenario name {name!r} must be non-empty [a-zA-Z0-9_]+")
    known = {f.name for f in Scenario.__dataclass_fields__.values()}
    unknown = set(raw) - known
    if unknown:
        raise _fail(name, f"unknown field(s) {sorted(unknown)}")
    sc = Scenario(name=name, **{
        k: v for k, v in raw.items() if k != "name"
    })
    if sc.workers < 1:
        raise _fail(name, "workers must be >= 1")
    if sc.racks < 1:
        raise _fail(name, "racks must be >= 1")
    if sc.duration_s <= 0:
        raise _fail(name, "duration_s must be > 0")
    if sc.poll_s <= 0 or sc.heartbeat_s <= 0:
        raise _fail(name, "poll_s and heartbeat_s must be > 0")
    if sc.heartbeat_timeout_s <= sc.heartbeat_s:
        raise _fail(name, "heartbeat_timeout_s must exceed heartbeat_s")
    if sc.shards < 0 or sc.eval_task_records < 0:
        raise _fail(name, "shards/eval_task_records must be >= 0")
    if sc.epochs < 1:
        raise _fail(name, "epochs must be >= 1")
    if sc.lease_batch < 1:
        raise _fail(name, "lease_batch must be >= 1")
    if sc.records_per_s <= 0:
        raise _fail(name, "records_per_s must be > 0")
    if not 0.0 <= sc.data_wait_frac < 1.0:
        raise _fail(name, "data_wait_frac must be in [0, 1)")
    if sc.alert_window_scale <= 0:
        raise _fail(name, "alert_window_scale must be > 0")
    if sc.autoscale is not None:
        if not isinstance(sc.autoscale, dict):
            raise _fail(name, "autoscale must be an object or null")
        bad = set(sc.autoscale) - _AUTOSCALE_KEYS
        if bad:
            raise _fail(name, f"unknown autoscale key(s) {sorted(bad)}")
    if sc.layout is not None:
        if not isinstance(sc.layout, dict):
            raise _fail(name, "layout must be an object or null")
        bad = set(sc.layout) - _LAYOUT_KEYS
        if bad:
            raise _fail(name, f"unknown layout key(s) {sorted(bad)}")
        if int(sc.layout.get("num_shards", 8)) < 1:
            raise _fail(name, "layout.num_shards must be >= 1")
    for i, ev in enumerate(sc.events):
        if not isinstance(ev, dict):
            raise _fail(name, f"events[{i}] must be an object")
        action = ev.get("action")
        if action not in REQUIRED_EVENT_FIELDS:
            raise _fail(
                name,
                f"events[{i}] action {action!r} not in "
                f"{sorted(REQUIRED_EVENT_FIELDS)}")
        at = ev.get("at_s")
        if not isinstance(at, (int, float)) or at < 0:
            raise _fail(name, f"events[{i}] needs numeric at_s >= 0")
        if at > sc.duration_s:
            raise _fail(
                name, f"events[{i}] at_s {at} is past duration_s "
                      f"{sc.duration_s}")
        if action == "inject_tasks" and sc.eval_task_records < 1:
            raise _fail(
                name,
                f"events[{i}] inject_tasks needs eval_task_records >= 1")
        for fld in REQUIRED_EVENT_FIELDS[action]:
            if not isinstance(ev.get(fld), (int, float)):
                raise _fail(
                    name,
                    f"events[{i}] ({action}) needs numeric field "
                    f"{fld!r}")
    return sc


def load_scenario(path: str) -> Scenario:
    with open(path, encoding="utf-8") as f:
        raw = json.load(f)
    return validate_scenario(raw)


_SCENARIO_DIR = os.path.join(os.path.dirname(__file__), "scenarios")


def builtin_scenarios() -> List[str]:
    """Names of the committed scenario library."""
    return sorted(
        fn[:-5] for fn in os.listdir(_SCENARIO_DIR) if fn.endswith(".json")
    )


def builtin_scenario_path(name: str) -> str:
    path = os.path.join(_SCENARIO_DIR, f"{name}.json")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no builtin scenario {name!r}; have {builtin_scenarios()}")
    return path
