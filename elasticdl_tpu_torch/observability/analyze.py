"""CLI for the trace critical-path analyzer (observability/analyzer.py).

    python -m elasticdl_tpu_torch.observability.analyze <path> [path ...]
        [--json] [--strict] [--trace-id ID] [--all-traces]

Paths are trace.jsonl files or directories (walked for ``*.jsonl`` — the
layout `--trace_dir` produces, one subdirectory per role, merges with no
flags). Text output shows each resize timeline's critical path and
per-phase/per-role attribution; ``--json`` emits the full report for
machines (CI stores it next to the trace artifacts).

Exit codes: 0 ok; 1 ``--strict`` violation (an unparseable line that is
not a file's torn tail — a writer bug, not a crash artifact); 2 usage —
no input files, or a named file that could not be opened at all (the
writer never ran; distinct from corruption).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from elasticdl_tpu_torch.observability import analyzer


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m elasticdl_tpu_torch.observability.analyze",
        description="merge trace.jsonl files and compute per-resize "
                    "critical paths",
    )
    parser.add_argument(
        "paths", nargs="+",
        help="trace.jsonl files and/or directories to walk for *.jsonl",
    )
    parser.add_argument(
        "--json", action="store_true", dest="as_json",
        help="emit the full JSON report instead of text",
    )
    parser.add_argument(
        "--strict", action="store_true",
        help="exit 1 on unparseable NON-tail lines (torn final lines from "
             "a killed writer stay tolerated)",
    )
    parser.add_argument(
        "--trace-id", default=None,
        help="analyze only this trace id",
    )
    parser.add_argument(
        "--all-traces", action="store_true",
        help="text mode: show every trace, not just resize timelines",
    )
    args = parser.parse_args(argv)

    report = analyzer.analyze_paths(args.paths, trace_id=args.trace_id)
    if args.as_json:
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        print(
            analyzer.render_text(report, resize_only=not args.all_traces),
            end="",
        )

    if not report["records"] and not report["files"]:
        print("no input files found", file=sys.stderr)
        return 2
    if report["unreadable_files"]:
        # a named-but-missing/unopenable file is a USAGE problem (the
        # writer never ran, the path is wrong) — exit 2, not a --strict
        # "writer bug" exit 1 (review find: a skipped best-effort trace
        # write must not be diagnosed as trace corruption)
        for path in report["unreadable_files"]:
            print(f"unreadable input file: {path}", file=sys.stderr)
        return 2
    if args.strict and report["strict_violations"]:
        for v in report["strict_violations"]:
            print(
                f"strict: unparseable line {v['file']}:{v['line']}: "
                f"{v['text']}", file=sys.stderr,
            )
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
