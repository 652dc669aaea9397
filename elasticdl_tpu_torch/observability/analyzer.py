"""Offline trace analysis: merge trace.jsonl files into per-resize
timelines and compute the critical path.

A resize writes spans from several processes — the master's
reform.announce/quiesce/teardown/spawn and every worker's
boot/rescale/compile/handoff work — stitched by one trace id
(observability/tracing.py). Reading that by hand means grepping N files
and mentally subtracting timestamps; this module does the arithmetic:

- **merge**: load any number of trace.jsonl files (or directories, walked
  for ``*.jsonl``), tolerating torn tails (a writer killed mid-record) and
  interleaved garbage lines, and group records by trace id;
- **critical path**: per trace, rebuild the span tree (parent ids only
  link within a process, so a cross-role trace has several roots — they
  become children of a synthetic ``timeline`` root spanning the whole
  incident) and walk the classic latest-ending-child chain: starting from
  a span's end, repeatedly attribute the interval to the latest-ending
  child that fits, recursing; uncovered gaps are the span's own time.
  Every instant of the timeline is attributed to exactly ONE segment, so
  the segment durations sum to the wall clock by construction — that is
  the property the bench leans on ("phase sum consistent with measured
  recovery wall-clock");
- **attribution**: segments roll up per phase (settle / handoff /
  compile / other, by span-name classification) and per role (master,
  worker-N, ...), answering "where did the resize actually spend its
  time" without reading a single raw line.

CLI: ``python -m elasticdl_tpu_torch.observability.analyze <paths> [--json]
[--strict] [--trace-id ID]`` (analyze.py). ``--strict`` fails (exit 1) on
any unparseable line that is NOT the final line of its file — a torn tail
is the documented crash shape and stays tolerated; garbage anywhere else
means a writer bug and CI should say so. `bench.py rescale` runs
`analyze_records` on its own span buffer so the critical path joins the
perf trajectory. Stdlib-only, jax-free, like the rest of the package.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

#: span names that mark a trace as a resize/recovery timeline
RESIZE_ROOT_NAMES = ("rescale", "reform", "timeline")

#: tolerance (seconds) for clock skew / float rounding when chaining
#: child spans — cross-process timestamps are wall clocks
EPS_S = 1e-4

#: span-name keyword -> phase classification, first match wins. "settle"
#: covers membership/world mechanics, "handoff" state movement,
#: "compile" executable builds; everything else is "other".
PHASE_KEYWORDS = (
    ("compile", ("compile",)),
    ("handoff", ("handoff", "drain", "stage_to_host", "ckpt")),
    ("settle", ("settle", "mesh", "world_form", "quiesce", "teardown",
                "spawn", "register", "build", "reform")),
)


def classify_phase(name: str) -> str:
    for phase, keys in PHASE_KEYWORDS:
        if any(k in name for k in keys):
            return phase
    return "other"


# ---------------------------------------------------------------------- #
# loading


@dataclass
class LoadedTraces:
    records: List[dict]
    files: List[str]
    #: (path, line_number, text-prefix) of every unparseable line
    bad_lines: List[Tuple[str, int, str]]
    #: bad lines that are NOT the final line of their file (--strict fails
    #: on these; a torn tail is the tolerated crash shape)
    strict_violations: List[Tuple[str, int, str]]
    #: named files that could not be opened at all — a USAGE problem (the
    #: writer never ran, the path is wrong), distinct from writer bugs:
    #: the CLI exits 2 for these, never 1
    unreadable_files: List[str]


def _iter_trace_files(paths: Iterable[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames.sort()
                for fn in sorted(filenames):
                    # metrics_history files (observability/timeseries.py;
                    # chaos writes them PREFIXED, chaos-smoke-seedN.
                    # metrics_history.jsonl) are jsonl but not traces:
                    # their lines parse fine and would pollute the record
                    # pool with value rows — substring match, like the
                    # journal walk
                    if fn.endswith(".jsonl") and "metrics_history" not in fn:
                        out.append(os.path.join(dirpath, fn))
        else:
            out.append(p)
    return out


def load_traces(paths: Iterable[str]) -> LoadedTraces:
    """Read every trace file under `paths`. Unparseable lines are counted,
    never fatal: the analyzer's whole job includes reading the traces of
    processes that died mid-write."""
    records: List[dict] = []
    bad: List[Tuple[str, int, str]] = []
    strict: List[Tuple[str, int, str]] = []
    unreadable: List[str] = []
    files = _iter_trace_files(paths)
    for path in files:
        file_bad: List[Tuple[int, str]] = []
        last_nonempty = 0
        try:
            with open(path, encoding="utf-8") as f:
                for lineno, line in enumerate(f, start=1):
                    line = line.strip()
                    if not line:
                        continue
                    last_nonempty = lineno
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        file_bad.append((lineno, line[:80]))
                        continue
                    if isinstance(rec, dict):
                        records.append(rec)
                    else:
                        file_bad.append((lineno, line[:80]))
        except OSError:
            unreadable.append(path)
            continue
        for lineno, text in file_bad:
            bad.append((path, lineno, text))
            if lineno != last_nonempty:
                strict.append((path, lineno, text))
    return LoadedTraces(
        records=records, files=files, bad_lines=bad,
        strict_violations=strict, unreadable_files=unreadable,
    )


# ---------------------------------------------------------------------- #
# span tree + critical path


@dataclass
class _Node:
    name: str
    role: str
    span_id: str
    parent_id: Optional[str]
    start: float
    dur: float
    children: List["_Node"] = field(default_factory=list)

    @property
    def end(self) -> float:
        return self.start + self.dur


@dataclass
class Segment:
    """One critical-path slice: [start, start+dur) attributed to `name`.
    `self_time` marks a parent span's own (un-childed) interval."""

    name: str
    role: str
    start: float
    dur: float
    self_time: bool = False


def _build_nodes(spans: List[dict]) -> Tuple[List[_Node], List[_Node]]:
    """(all nodes, roots). Spans missing timing fields are dropped —
    they cannot be placed on a timeline."""
    nodes: Dict[str, _Node] = {}
    ordered: List[_Node] = []
    for r in spans:
        ts, dur = r.get("ts"), r.get("dur_ms")
        sid = r.get("span_id")
        if not isinstance(ts, (int, float)) or not isinstance(dur, (int, float)):
            continue
        node = _Node(
            name=str(r.get("name", "?")),
            role=str(r.get("role", "")),
            span_id=str(sid) if sid else f"anon-{len(ordered)}",
            parent_id=r.get("parent_id") or None,
            start=float(ts),
            dur=max(0.0, float(dur) / 1e3),
        )
        nodes[node.span_id] = node
        ordered.append(node)
    roots: List[_Node] = []
    for n in ordered:
        parent = nodes.get(n.parent_id) if n.parent_id else None
        if parent is not None and parent is not n:
            parent.children.append(n)
        else:
            roots.append(n)
    for n in ordered:
        n.children.sort(key=lambda k: (k.start, k.end))
    return ordered, roots


def _walk_critical(node: _Node, out: List[Segment]) -> None:
    """Attribute [node.start, node.end) to segments: the latest-ending
    child chain is the critical path; intervals no child covers are the
    node's own time. Children overlapping the already-attributed tail
    (parallel work that finished earlier) are off-path by definition —
    shortening them would not move the end time."""
    cursor = node.end
    for child in sorted(node.children, key=lambda k: k.end, reverse=True):
        if child.end > cursor + EPS_S or child.start < node.start - EPS_S:
            continue    # overlaps the chosen chain, or outside the parent
        if cursor - child.end > EPS_S:
            out.append(Segment(
                name=node.name, role=node.role,
                start=child.end, dur=cursor - child.end, self_time=True,
            ))
        _walk_critical(child, out)
        cursor = child.start
    if cursor - node.start > EPS_S or not node.children:
        out.append(Segment(
            name=node.name, role=node.role,
            start=node.start, dur=max(0.0, cursor - node.start),
            self_time=bool(node.children),
        ))


def critical_path(root: _Node) -> List[Segment]:
    segs: List[Segment] = []
    _walk_critical(root, segs)
    segs.sort(key=lambda s: s.start)
    return segs


def _root_summary(root: _Node) -> dict:
    segs = critical_path(root)
    phases: Dict[str, float] = {}
    by_role: Dict[str, float] = {}
    for s in segs:
        phases[classify_phase(s.name)] = (
            phases.get(classify_phase(s.name), 0.0) + s.dur
        )
        by_role[s.role] = by_role.get(s.role, 0.0) + s.dur
    return {
        "name": root.name,
        "role": root.role,
        "start_ts": round(root.start, 6),
        "wall_s": round(root.dur, 6),
        "critical_path": [
            {
                "name": s.name + (" (self)" if s.self_time else ""),
                "role": s.role,
                "offset_s": round(s.start - root.start, 6),
                "dur_s": round(s.dur, 6),
            }
            for s in segs
        ],
        "phases": {k: round(v, 6) for k, v in sorted(phases.items())},
        "by_role": {k: round(v, 6) for k, v in sorted(by_role.items())},
    }


# ---------------------------------------------------------------------- #
# per-trace analysis


def _analyze_trace(trace_id: str, records: List[dict]) -> dict:
    spans = [r for r in records if r.get("kind") == "span"]
    events = [r for r in records if r.get("kind") == "event"]
    _, roots = _build_nodes(spans)
    roots.sort(key=lambda n: (n.start, n.end))
    summary: dict = {
        "trace_id": trace_id,
        "spans": len(spans),
        "events": len(events),
        "roles": sorted({
            str(r.get("role", "")) for r in records if r.get("role")
        }),
        "is_resize": any(
            n.name in RESIZE_ROOT_NAMES for n in roots
        ) or any(
            str(e.get("name", "")).startswith("reform.") for e in events
        ),
        "event_names": sorted({str(e.get("name", "")) for e in events}),
        "straggler_events": [
            {k: e.get(k) for k in
             ("worker_id", "score", "step_time_p50_s", "ts")}
            for e in events if e.get("name") == "cluster.straggler"
        ],
        "roots": [],
    }
    if not roots:
        summary["timeline"] = None
        return summary
    summary["roots"] = [_root_summary(n) for n in roots]
    if len(roots) == 1:
        # single-root trace: the timeline IS that root's summary (already
        # computed — the recursive walk is the analysis cost, and CI runs
        # this over every artifact)
        summary["timeline"] = summary["roots"][0]
    else:
        # cross-role timelines: parent ids never link across processes,
        # so a synthetic root spans the whole incident and chains the
        # per-process roots (master reform -> worker rescale) for one
        # end-to-end critical path
        start = min(n.start for n in roots)
        end = max(n.end for n in roots)
        summary["timeline"] = _root_summary(_Node(
            name="timeline", role="", span_id="timeline", parent_id=None,
            start=start, dur=end - start, children=list(roots),
        ))
    return summary


def analyze_records(records: List[dict],
                    trace_id: Optional[str] = None) -> dict:
    """Group records by trace id and analyze each; `trace_id` restricts
    to one. Traces are ordered by first-record timestamp — deterministic
    for any fixed input."""
    by_trace: Dict[str, List[dict]] = {}
    for r in records:
        tid = r.get("trace_id")
        if not tid:
            continue
        if trace_id is not None and tid != trace_id:
            continue
        by_trace.setdefault(str(tid), []).append(r)

    def first_ts(recs: List[dict]) -> float:
        tss = [r["ts"] for r in recs if isinstance(r.get("ts"), (int, float))]
        return min(tss) if tss else 0.0

    traces = [
        _analyze_trace(tid, recs)
        for tid, recs in sorted(
            by_trace.items(), key=lambda kv: (first_ts(kv[1]), kv[0])
        )
    ]
    return {
        "records": len(records),
        "traces": traces,
        "resize_traces": sum(1 for t in traces if t["is_resize"]),
    }


def analyze_paths(paths: Iterable[str],
                  trace_id: Optional[str] = None) -> dict:
    loaded = load_traces(paths)
    report = analyze_records(loaded.records, trace_id=trace_id)
    report["files"] = loaded.files
    report["unparseable_lines"] = [
        {"file": p, "line": n, "text": t} for p, n, t in loaded.bad_lines
    ]
    report["strict_violations"] = [
        {"file": p, "line": n, "text": t}
        for p, n, t in loaded.strict_violations
    ]
    report["unreadable_files"] = list(loaded.unreadable_files)
    return report


def resize_timeline(report: dict, trace_id: str) -> Optional[dict]:
    """Convenience: one trace's summary out of a report (bench uses it)."""
    for t in report.get("traces", ()):
        if t["trace_id"] == trace_id:
            return t
    return None


# ---------------------------------------------------------------------- #
# text rendering


def render_text(report: dict, resize_only: bool = True) -> str:
    lines: List[str] = []
    traces = report.get("traces", [])
    shown = [t for t in traces if t["is_resize"]] if resize_only else traces
    if resize_only and not shown:
        shown = traces
    lines.append(
        f"{report.get('records', 0)} records, {len(traces)} trace(s), "
        f"{report.get('resize_traces', 0)} resize timeline(s)"
        + (f", {len(report['unparseable_lines'])} unparseable line(s)"
           if report.get("unparseable_lines") else "")
    )
    for t in shown:
        tl = t.get("timeline")
        lines.append("")
        lines.append(
            f"trace {t['trace_id']}  [{', '.join(t['roles'])}]  "
            f"{t['spans']} span(s), {t['events']} event(s)"
            + ("  RESIZE" if t["is_resize"] else "")
        )
        if tl is None:
            lines.append("  (no timed spans)")
            continue
        lines.append(f"  wall {tl['wall_s']:.3f}s  critical path:")
        for seg in tl["critical_path"]:
            lines.append(
                f"    +{seg['offset_s']:8.3f}s  {seg['dur_s']:8.3f}s  "
                f"{seg['name']:<28s} [{seg['role']}]"
            )
        phase_sum = sum(tl["phases"].values())
        phase_txt = "  ".join(
            f"{k}={v:.3f}s" for k, v in tl["phases"].items()
        )
        lines.append(f"  phases: {phase_txt}  (sum {phase_sum:.3f}s)")
        role_txt = "  ".join(
            f"{k or '<gap>'}={v:.3f}s" for k, v in tl["by_role"].items()
        )
        lines.append(f"  by role: {role_txt}")
        if t["straggler_events"]:
            lines.append(
                f"  stragglers flagged: "
                f"{[e['worker_id'] for e in t['straggler_events']]}"
            )
    return "\n".join(lines) + "\n"
