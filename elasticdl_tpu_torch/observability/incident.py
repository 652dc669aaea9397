"""Cross-role incident correlation: merge flight bundles, traces, the
journal tail, and cluster-health snapshots into ONE timeline.

    python -m elasticdl_tpu_torch.observability.incident <path> [path ...]
        [--json] [--strict] [--tail N]

A chaos failure (or a real one) leaves per-role evidence scattered: a
`flight-<role>-<pid>.json` bundle per process (observability/flight.py),
per-role `trace.jsonl` files, the master's replayed control-plane journal,
and `*health.json` rollup snapshots. This module reads all of it from one
directory (or explicit paths) and renders the incident as a single
timeline — the crash, the successor's recovery, each worker's reconnect,
straggler flags — ordered by wall clock, with the trace analyzer's
critical-path machinery (observability/analyzer.py) reused for any resize
timelines the records contain.

Tolerance contract (the analyzer's conventions):

- a bundle that fails to parse is a TORN bundle — tolerated and counted
  (the atomic tmp+replace writer means a torn bundle is itself evidence
  the writer died mid-incident), never a failure;
- a bundle that parses but violates the schema (no `records` list, no
  role) is a WRITER BUG: `--strict` exits 1;
- unparseable non-tail lines inside *.jsonl inputs are writer bugs too
  (`--strict` exits 1, via the analyzer's loader);
- a NAMED path that cannot be read at all is a USAGE error: exit 2.

Timeline entries are deduplicated across sources: a span that is both in
a worker's ring and in its trace.jsonl appears once.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from elasticdl_tpu_torch.observability import analyzer
from elasticdl_tpu_torch.observability.flight import BUNDLE_PREFIX

#: event names a postmortem reader always wants called out, whatever else
#: the ring carries
KEY_EVENT_NAMES = (
    "flight.crash", "flight.dump", "master.crash", "master.recovered",
    "worker.reconnect", "membership.reregister", "membership.death",
    "cluster.straggler", "cluster.straggler_cleared",
    "cluster.alert", "cluster.alert_cleared",
    "rpc.generation_handshake", "rpc.breaker_open", "rpc.breaker_reset",
    "reform.announce",
)

#: default journal-tail length carried into the report
TAIL_DEFAULT = 40


@dataclass
class LoadedBundles:
    bundles: List[dict] = field(default_factory=list)
    files: List[str] = field(default_factory=list)
    #: paths that failed to parse — the tolerated crash shape
    torn: List[str] = field(default_factory=list)
    #: (path, problem) pairs for parsed-but-malformed bundles (--strict)
    strict_violations: List[Tuple[str, str]] = field(default_factory=list)
    unreadable: List[str] = field(default_factory=list)


def _iter_bundle_files(paths: Iterable[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames.sort()
                for fn in sorted(filenames):
                    if fn.startswith(BUNDLE_PREFIX) and fn.endswith(".json"):
                        out.append(os.path.join(dirpath, fn))
        elif os.path.basename(p).startswith(BUNDLE_PREFIX):
            out.append(p)
    return out


def load_bundles(paths: Iterable[str]) -> LoadedBundles:
    loaded = LoadedBundles()
    for path in _iter_bundle_files(paths):
        loaded.files.append(path)
        try:
            with open(path, encoding="utf-8") as f:
                data = json.load(f)
        except OSError:
            loaded.unreadable.append(path)
            continue
        except ValueError:
            loaded.torn.append(path)
            continue
        problem = None
        if not isinstance(data, dict):
            problem = "bundle is not a JSON object"
        elif not isinstance(data.get("records"), list):
            problem = "bundle has no records list"
        elif not data.get("role"):
            problem = "bundle carries no role"
        if problem is not None:
            loaded.strict_violations.append((path, problem))
            # still usable as far as it goes — a partial schema carries
            # partial evidence
            if isinstance(data, dict):
                loaded.bundles.append(data)
            continue
        data["_path"] = path
        loaded.bundles.append(data)
    return loaded


# ---------------------------------------------------------------------- #
# journal tail


def _journal_files(paths: Iterable[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames.sort()
                for fn in sorted(filenames):
                    if "journal.jsonl" in fn:
                        out.append(os.path.join(dirpath, fn))
        elif "journal.jsonl" in os.path.basename(p):
            out.append(p)
    return out


def _load_journal(paths: Iterable[str], tail: int) -> Optional[dict]:
    """Replay every journal file found (master/journal.py's replay is
    jsonl-only and protobuf-free) and keep the parsed tail — generation
    boundaries and the last transitions before/after the incident."""
    files = _journal_files(paths)
    if not files:
        return None
    from elasticdl_tpu_torch.master.journal import replay_lines

    out: dict = {"files": files, "generations": [], "records": 0,
                 "dropped_lines": 0, "tail": []}
    for path in files:
        try:
            with open(path, encoding="utf-8") as f:
                lines = f.readlines()
        except OSError:
            continue
        result = replay_lines(lines)
        out["records"] += result.records
        out["dropped_lines"] += result.dropped_lines
        out["generations"].append(result.prior_generation)
        if result.dispatcher is not None:
            # the wasted-work bill the journal carries (ISSUE 12,
            # observability/goodput.py): re-trained / discarded records,
            # per reason — the incident's data-plane cost
            d = result.dispatcher
            out["wasted_records"] = (
                out.get("wasted_records", 0) + d.wasted_records)
            out["wasted_events"] = (
                out.get("wasted_events", 0) + d.wasted_events)
            out["records_completed"] = (
                out.get("records_completed", 0) + d.records_completed)
            by = out.setdefault("wasted_by_reason", {})
            for reason, ent in d.wasted_by_reason.items():
                tot = by.setdefault(reason, {"events": 0, "records": 0})
                tot["events"] += ent.get("events", 0)
                tot["records"] += ent.get("records", 0)
        parsed = []
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                parsed.append(json.loads(line))
            except ValueError:
                continue
        out["tail"].extend(
            {"file": os.path.basename(path), **rec}
            for rec in parsed[-tail:]
        )
        out["world_version"] = max(
            out.get("world_version", 0), result.world_version
        )
        if result.layout is not None:
            # layout-controller decision history (ISSUE 20): rotation
            # snapshots carry the totals forward, so the latest file's
            # replayed state IS the cumulative history
            out["layout"] = {
                "actions_applied": result.layout.actions_applied,
                "by_kind": dict(result.layout.by_kind),
                "decision_records": result.layout.records,
                "last_action_ts": result.layout.last_action_ts,
            }
    out["generations"] = sorted(set(out["generations"]))
    return out


def _health_snapshots(paths: Iterable[str]) -> List[dict]:
    out: List[dict] = []
    for p in paths:
        candidates: List[str] = []
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames.sort()
                for fn in sorted(filenames):
                    if fn.endswith("health.json"):
                        candidates.append(os.path.join(dirpath, fn))
        elif p.endswith("health.json"):
            candidates.append(p)
        for path in candidates:
            try:
                with open(path, encoding="utf-8") as f:
                    data = json.load(f)
            except (OSError, ValueError):
                continue
            if isinstance(data, dict):
                data["_path"] = os.path.basename(path)
                out.append(data)
    return out


# ---------------------------------------------------------------------- #
# timeline assembly


def _entry_key(rec: dict) -> Tuple:
    """Dedup key across sources (ring + trace.jsonl carry the same
    records): identity is what/when/who, not which file it came from."""
    return (
        str(rec.get("kind", "")), str(rec.get("name", "")),
        round(float(rec.get("ts", 0.0)), 6), str(rec.get("role", "")),
        str(rec.get("span_id", "")),
    )


def _timeline_entry(rec: dict, source: str) -> Optional[dict]:
    ts = rec.get("ts")
    if not isinstance(ts, (int, float)):
        return None
    entry = {
        "ts": float(ts),
        "kind": str(rec.get("kind", "")),
        "name": str(rec.get("name", "")),
        "role": str(rec.get("role", "")),
        "source": source,
    }
    for k in ("dur_ms", "reason", "error", "level", "msg", "worker_id",
              "generation", "trace_id", "score", "world_version",
              "rule", "severity", "value", "threshold"):
        if k in rec and rec[k] is not None:
            entry[k] = rec[k]
    return entry


def correlate(paths: Iterable[str], tail: int = TAIL_DEFAULT) -> dict:
    """The incident report: bundles + traces + journal + health, merged."""
    paths = list(paths)
    bundles = load_bundles(paths)
    traces = analyzer.load_traces(paths)

    seen: Dict[Tuple, dict] = {}
    span_records: List[dict] = []

    def add(rec: dict, source: str) -> None:
        entry = _timeline_entry(rec, source)
        if entry is None:
            return
        key = _entry_key(rec)
        if key not in seen:
            seen[key] = entry
        if rec.get("kind") in ("span", "event") and rec.get("trace_id"):
            span_records.append(rec)

    for b in bundles.bundles:
        role = str(b.get("role", "?"))
        # the dump itself is a timeline fact: when the black box was cut
        add({
            "kind": "dump", "name": "flight.dump", "ts": b.get("ts"),
            "role": role, "reason": b.get("reason"),
            "world_version": b.get("world_version"),
        }, source="bundle")
        for rec in b.get("records") or []:
            if isinstance(rec, dict):
                rec = dict(rec)
                rec.setdefault("role", role)
                add(rec, source="bundle")
    for rec in traces.records:
        add(rec, source="trace")

    timeline = sorted(seen.values(), key=lambda e: (e["ts"], e["name"]))
    key_events = [
        e for e in timeline
        if e["name"] in KEY_EVENT_NAMES or e["kind"] in ("dump", "log")
    ]

    # resize/critical-path analysis over every span that carries a trace
    # id, pooled across bundles AND trace files (the analyzer dedups
    # nothing — feed it the deduped pool)
    pooled = list({_entry_key(r): r for r in span_records}.values())
    analysis = analyzer.analyze_records(pooled)

    journal = _load_journal(paths, tail)
    health = _health_snapshots(paths)

    # the incident's bill (ISSUE 12): wasted records from the replayed
    # journal + non-productive worker-seconds from the NEWEST fleet
    # goodput rollup any health snapshot carries ("this incident cost
    # 412 worker-seconds and 18k re-trained records")
    goodput_summary: dict = {}
    if journal and journal.get("wasted_records") is not None:
        goodput_summary["wasted_records"] = journal["wasted_records"]
        goodput_summary["wasted_events"] = journal.get("wasted_events", 0)
        goodput_summary["records_completed"] = journal.get(
            "records_completed", 0)
        goodput_summary["wasted_by_reason"] = journal.get(
            "wasted_by_reason", {})
    best_fleet = None
    best_ts = -1.0
    for snap in health:
        gp = snap.get("goodput") or {}
        fleet = gp.get("fleet") or {}
        if not fleet:
            continue
        # newest by the rollup's OWN timestamp, not by wall_s: reporter
        # churn (a killed worker's ledger leaving the sum) makes a
        # pre-incident snapshot's cumulative wall LARGER than the
        # post-incident one, and the summary must describe the latest
        # fleet state
        ts = gp.get("ts")
        ts = float(ts) if isinstance(ts, (int, float)) else 0.0
        if best_fleet is None or ts > best_ts:
            best_fleet = fleet
            best_ts = ts
    if best_fleet:
        cats = best_fleet.get("categories") or {}
        goodput_summary["fleet_goodput_fraction"] = best_fleet.get(
            "goodput_fraction")
        goodput_summary["fleet_wall_s"] = best_fleet.get("wall_s")
        goodput_summary["non_productive_worker_seconds"] = round(
            sum(v for c, v in cats.items() if c != "train_compute"), 3)

    slow_calls, diary_violations = _collect_slow_calls(bundles.bundles)

    report = {
        "paths": paths,
        "bundles": [
            {
                "role": b.get("role"), "pid": b.get("pid"),
                "reason": b.get("reason"), "ts": b.get("ts"),
                "records": len(b.get("records") or []),
                "world_version": b.get("world_version"),
                "dump_seq": b.get("dump_seq"),
                "file": os.path.basename(b.get("_path", "")),
            }
            for b in bundles.bundles
        ],
        "bundle_files": bundles.files,
        "torn_bundles": bundles.torn,
        "strict_violations": (
            [{"file": p, "problem": w} for p, w in bundles.strict_violations]
            + [
                {"file": p, "line": n, "problem": f"unparseable line: {t}"}
                for p, n, t in traces.strict_violations
            ]
            + diary_violations
        ),
        "unreadable_files": (
            list(bundles.unreadable) + list(traces.unreadable_files)
        ),
        "roles": sorted({
            str(b.get("role")) for b in bundles.bundles if b.get("role")
        } | {e["role"] for e in timeline if e["role"]}),
        "timeline": timeline,
        "key_events": key_events,
        "traces": analysis,
        "journal": journal,
        "health": health,
        "goodput": goodput_summary,
        "slow_calls": slow_calls,
    }
    return report


#: worst retained diaries rendered in the text report
SLOW_CALLS_SHOWN = 8
#: a retained diary's stages must sum to its wall within this (the
#: recorder completes the `other` residual at retain time, so a larger
#: gap is a writer bug, not timing noise)
ATTRIBUTION_TOL = 0.01


def _collect_slow_calls(bundles: List[dict]) -> Tuple[dict, List[dict]]:
    """Pool the `diaries` blocks across bundles (ISSUE 19): the worst
    retained request diaries plus the merged per-stage attribution —
    the section that names where the incident's p99 went. Returns
    (summary, strict_violations): a retained diary whose stages do NOT
    sum to its wall within 1% is a writer bug."""
    calls: List[dict] = []
    attr: Dict[str, float] = {}
    violations: List[dict] = []
    finished = retained = 0
    slow_wall = 0.0
    for b in bundles:
        block = b.get("diaries")
        if not isinstance(block, dict):
            continue
        role = str(b.get("role", "?"))
        fname = os.path.basename(b.get("_path", ""))
        finished += int(block.get("finished") or 0)
        retained += int(block.get("retained") or 0)
        wall = block.get("slow_wall_s")
        if isinstance(wall, (int, float)):
            slow_wall += float(wall)
        for s, v in (block.get("attribution") or {}).items():
            if isinstance(v, (int, float)):
                attr[s] = attr.get(s, 0.0) + float(v)
        for call in block.get("slow_calls") or []:
            if not isinstance(call, dict):
                continue
            calls.append({**call, "role": role})
            w = call.get("wall_s")
            stages = call.get("stages")
            if (isinstance(w, (int, float)) and w > 0
                    and isinstance(stages, dict)):
                total = sum(v for v in stages.values()
                            if isinstance(v, (int, float)))
                if abs(total - w) > max(ATTRIBUTION_TOL * w, 1e-5):
                    violations.append({
                        "file": fname,
                        "problem": (
                            f"diary {call.get('op', '?')} stages sum "
                            f"{total:.6f}s != wall {w:.6f}s (>1%)"),
                    })
    if not calls and not attr:
        return {}, violations
    calls.sort(key=lambda c: float(c.get("wall_s") or 0.0), reverse=True)
    named = {s: v for s, v in attr.items() if s != "other"}
    pool = named or attr
    dominant = max(sorted(pool), key=lambda s: pool[s]) if pool else None
    summary = {
        "finished": finished,
        "retained": retained,
        "slow_wall_s": round(slow_wall, 6),
        "attribution": {s: round(v, 6) for s, v in sorted(attr.items())},
        "dominant_stage": dominant,
        "dominant_share": (
            round(pool[dominant] / slow_wall, 4)
            if dominant is not None and slow_wall > 0 else None),
        "calls": calls,
    }
    return summary, violations


# ---------------------------------------------------------------------- #
# rendering


def _waterfall(call: dict, width: int = 24) -> List[str]:
    """One retained diary as an indented stage waterfall: each stage a
    bar proportional to its share of the call's wall, largest first."""
    wall = float(call.get("wall_s") or 0.0)
    stages = call.get("stages")
    if wall <= 0 or not isinstance(stages, dict):
        return []
    out: List[str] = []
    for s, v in sorted(stages.items(), key=lambda kv: -float(kv[1] or 0)):
        if not isinstance(v, (int, float)) or v <= 0:
            continue
        share = min(1.0, float(v) / wall)
        bar = "#" * max(1, int(round(share * width)))
        out.append(
            f"    {s:<12s} {float(v) * 1e3:9.2f}ms  "
            f"{bar:<{width}s} {share:.0%}"
        )
    return out


def render_text(report: dict, max_entries: int = 200) -> str:
    lines: List[str] = []
    bundles = report["bundles"]
    lines.append(
        f"incident: {len(bundles)} flight bundle(s) "
        f"[{', '.join(report['roles'])}]"
        + (f", {len(report['torn_bundles'])} torn" if report["torn_bundles"]
           else "")
    )
    for b in bundles:
        lines.append(
            f"  bundle {b['file'] or '?'}  role={b['role']} pid={b['pid']} "
            f"reason={b['reason']} records={b['records']} "
            f"world_v={b.get('world_version')}"
        )
    journal = report.get("journal")
    if journal:
        lines.append(
            f"journal: {journal['records']} record(s) across "
            f"generation(s) {journal['generations']}, "
            f"{journal['dropped_lines']} dropped line(s), "
            f"tail of {len(journal['tail'])} kept"
        )
        ly = journal.get("layout")
        if ly:
            by = "  ".join(
                f"{k}={v}" for k, v in sorted(ly["by_kind"].items()))
            lines.append(
                f"layout: {ly['actions_applied']} applied action(s) of "
                f"{ly['decision_records']} journaled decision(s)"
                + (f"  [{by}]" if by else "")
            )
    goodput = report.get("goodput") or {}
    if goodput:
        # the headline bill, in one sentence a capacity owner can read
        parts = []
        if goodput.get("non_productive_worker_seconds") is not None:
            parts.append(
                f"{goodput['non_productive_worker_seconds']:g} "
                "non-productive worker-seconds"
            )
        if goodput.get("wasted_records") is not None:
            parts.append(
                f"{goodput['wasted_records']} re-trained/discarded "
                "record(s)"
            )
        if parts:
            lines.append("goodput: this incident cost " + " and ".join(parts))
        if goodput.get("fleet_goodput_fraction") is not None:
            lines.append(
                f"  fleet goodput fraction "
                f"{goodput['fleet_goodput_fraction']:.3f} over "
                f"{goodput.get('fleet_wall_s', 0):g} worker-seconds"
            )
        for reason, ent in sorted(
            (goodput.get("wasted_by_reason") or {}).items()
        ):
            lines.append(
                f"  wasted[{reason}]: {ent.get('records', 0)} record(s) "
                f"across {ent.get('events', 0)} event(s)"
            )
    slow = report.get("slow_calls") or {}
    if slow:
        dom = slow.get("dominant_stage")
        share = slow.get("dominant_share")
        head = (
            f"slow_calls: {slow.get('retained', 0)} retained of "
            f"{slow.get('finished', 0)} finished, "
            f"{slow.get('slow_wall_s', 0):g}s slow wall"
        )
        if dom:
            head += f" — dominant stage {dom}"
            if share is not None:
                head += f" ({share:.0%} of the slow wall)"
        lines.append(head)
        for call in (slow.get("calls") or [])[:SLOW_CALLS_SHOWN]:
            lines.append(
                f"  {call.get('op', '?'):<10s} "
                f"{float(call.get('wall_s') or 0.0) * 1e3:9.2f}ms "
                f"{call.get('status', '?'):<8s} "
                f"[{call.get('role', '?')}]"
                + (f"  {call['detail']}" if call.get("detail") else "")
            )
            lines.extend(_waterfall(call))
    for snap in report.get("health") or ():
        # snapshot_age_s (ISSUE 11): how stale the rollup was when it
        # was served — the difference between "the fleet was fine" and
        # "the master stopped looking"
        age = snap.get("snapshot_age_s")
        cluster = snap.get("cluster") or snap
        if age is None:
            age = cluster.get("snapshot_age_s")
        lines.append(
            f"health {snap.get('_path', '?')}: "
            f"{cluster.get('workers_reporting', 0)} reporting, "
            f"{cluster.get('straggler_count', 0)} straggler(s), "
            f"skew {cluster.get('skew', 1.0)}"
            + (f", rollup age {age}s" if age is not None else "")
        )

    timeline = report["timeline"]
    shown = timeline
    note = ""
    if len(timeline) > max_entries:
        # keep every key event + the most recent tail, in order
        keep = {id(e) for e in report["key_events"]}
        keep |= {id(e) for e in timeline[-max_entries:]}
        shown = [e for e in timeline if id(e) in keep]
        note = f" (showing {len(shown)} of {len(timeline)})"
    lines.append(f"timeline{note}:")
    t0 = timeline[0]["ts"] if timeline else 0.0
    for e in shown:
        extra = ""
        for k in ("reason", "error", "msg", "worker_id", "generation",
                  "rule", "severity", "value"):
            if k in e:
                extra += f" {k}={e[k]}"
        dur = f" {e['dur_ms']:.1f}ms" if "dur_ms" in e else ""
        lines.append(
            f"  +{e['ts'] - t0:9.3f}s  [{e['role'] or '?':<12s}] "
            f"{e['kind']:<5s} {e['name']}{dur}{extra}"
        )
    resize = report["traces"].get("resize_traces", 0)
    if resize:
        lines.append(f"{resize} resize timeline(s) — critical paths:")
        for t in report["traces"]["traces"]:
            tl = t.get("timeline")
            if not t["is_resize"] or not tl:
                continue
            phases = "  ".join(
                f"{k}={v:.3f}s" for k, v in tl["phases"].items()
            )
            lines.append(
                f"  trace {t['trace_id']}: wall {tl['wall_s']:.3f}s  {phases}"
            )
    return "\n".join(lines) + "\n"


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m elasticdl_tpu_torch.observability.incident",
        description="correlate flight bundles, traces, the journal tail "
                    "and health snapshots into one incident timeline",
    )
    parser.add_argument(
        "paths", nargs="+",
        help="directories (walked for flight-*.json / *.jsonl / "
             "*health.json) and/or explicit files",
    )
    parser.add_argument(
        "--json", action="store_true", dest="as_json",
        help="emit the full JSON report instead of text",
    )
    parser.add_argument(
        "--strict", action="store_true",
        help="exit 1 on writer bugs (malformed-but-parseable bundles, "
             "unparseable non-tail trace lines); torn bundles — the "
             "documented crash shape — stay tolerated",
    )
    parser.add_argument(
        "--tail", type=int, default=TAIL_DEFAULT,
        help=f"journal-tail records to keep (default {TAIL_DEFAULT})",
    )
    args = parser.parse_args(argv)

    report = correlate(args.paths, tail=args.tail)
    if args.as_json:
        print(json.dumps(report, indent=2, sort_keys=True, default=repr))
    else:
        print(render_text(report), end="")

    have_inputs = (
        report["bundle_files"] or report["torn_bundles"]
        or report["timeline"] or report.get("journal")
    )
    if not have_inputs:
        print("no incident inputs found", file=sys.stderr)
        return 2
    if report["unreadable_files"]:
        for path in report["unreadable_files"]:
            print(f"unreadable input file: {path}", file=sys.stderr)
        return 2
    if args.strict and report["strict_violations"]:
        for v in report["strict_violations"]:
            print(
                f"strict: {v['file']}: {v['problem']}", file=sys.stderr,
            )
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
