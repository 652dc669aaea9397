"""CLI: run one fleet-soak scenario against the real master.

    python -m elasticdl_tpu_torch.fleetsim <scenario.json | builtin-name> \
        [--workers N] [--seed S] [--duration-s D] \
        [--artifacts DIR] [--json] [--list]

Exit code: 0 when the run is clean — job accounting replays
record-identically, zero lost acked leases, and (with --artifacts) the
incident CLI's --strict pass over the run's artifacts returns 0 —
else 1.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

from elasticdl_tpu_torch.fleetsim.scenario import (
    builtin_scenario_path, builtin_scenarios, load_scenario,
)
from elasticdl_tpu_torch.fleetsim.sim import run_scenario


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m elasticdl_tpu_torch.fleetsim",
        description="scenario-driven fleet soak against the real master",
    )
    parser.add_argument(
        "scenario", nargs="?",
        help="scenario JSON path, or a builtin name (see --list)")
    parser.add_argument("--list", action="store_true",
                        help="list builtin scenarios and exit")
    parser.add_argument("--workers", type=int, default=0,
                        help="override the scenario's fleet size")
    parser.add_argument("--seed", type=int, default=None,
                        help="override the scenario's seed")
    parser.add_argument("--duration-s", type=float, default=0.0,
                        help="override the scenario's virtual duration")
    parser.add_argument("--artifacts", default="",
                        help="emit incident artifacts (journal, health, "
                             "alerts, trace, event log) into this dir and "
                             "run the incident CLI --strict over them")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="print the full result JSON")
    args = parser.parse_args(argv)

    if args.list:
        for name in builtin_scenarios():
            print(name)
        return 0
    if not args.scenario:
        parser.error("scenario required (or --list)")

    path = args.scenario
    if not os.path.exists(path):
        path = builtin_scenario_path(args.scenario)
    sc = load_scenario(path)
    overrides = {}
    if args.workers > 0:
        overrides["workers"] = args.workers
    if args.seed is not None:
        overrides["seed"] = args.seed
    if args.duration_s > 0:
        overrides["duration_s"] = args.duration_s
    if overrides:
        sc = sc.override(**overrides)

    with tempfile.TemporaryDirectory(prefix="fleetsim-") as tmp:
        result = run_scenario(
            sc, tmp, artifacts_dir=args.artifacts or None)

    if args.as_json:
        print(json.dumps(result, indent=2, sort_keys=True))
    else:
        print(
            f"{result['scenario']}: {result['workers_total']} workers, "
            f"{result['virtual_duration_s']:.0f} virtual s in "
            f"{result['wall_s']:.1f}s wall "
            f"({result['time_compression']:.0f}x)"
        )
        print(
            f"  leases/s {result['leases_per_s']:.0f}  "
            f"journal flush p99 "
            f"{result['journal']['flush_probe_p99_ms']}ms  "
            f"queue high-water "
            f"{result['journal']['commit_queue_high_water']}"
        )
        print(
            f"  replay identical: {result['replay']['identical']}  "
            f"lost acked leases: {result['lost_acked_leases']}  "
            f"autoscale reversals: {result['autoscale']['reversals']}"
        )

    ok = result["replay"]["identical"] and result["lost_acked_leases"] == 0
    if args.artifacts:
        ok = ok and result.get("incident_strict_rc") == 0
    if not ok:
        print("fleet soak FAILED the clean-run contract", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
