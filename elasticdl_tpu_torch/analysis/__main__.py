"""`python -m elasticdl_tpu_torch.analysis` — run edl-lint over the tree.

Exit codes: 0 clean (or every finding baselined), 1 new findings, parse
errors, or STALE baseline entries (tolerated debt that got fixed must
leave the ledger — run `--prune-baseline`), 2 usage errors. The default
target is the installed `elasticdl_tpu_torch` package directory; the
default baseline is `.edl-lint-baseline-torch.json` next to `pyproject.toml` (repo
checkouts) or absent (installed wheels).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from elasticdl_tpu_torch.analysis.core import (
    all_rules,
    load_baseline,
    prune_baseline,
    run_analysis,
    write_baseline,
)

BASELINE_NAME = ".edl-lint-baseline-torch.json"


def _default_paths() -> List[str]:
    import elasticdl_tpu_torch

    return [os.path.dirname(os.path.abspath(elasticdl_tpu_torch.__file__))]


def _default_baseline(paths: List[str]) -> Optional[str]:
    """Walk up from the first target looking for the checked-in baseline."""
    probe = os.path.abspath(paths[0])
    for _ in range(6):
        candidate = os.path.join(probe, BASELINE_NAME)
        if os.path.exists(candidate):
            return candidate
        parent = os.path.dirname(probe)
        if parent == probe:
            break
        probe = parent
    return None


def _explain(rule_id: str) -> int:
    """`--explain EDL102`: the rule's FULL class docstring — the what,
    the why-it-matters-here, and the sanctioned fix patterns — not just
    the one-line `doc` the listing shows."""
    wanted = rule_id.strip().lower()
    for rule in all_rules():
        if wanted in (rule.id.lower(), rule.name.lower()):
            print(f"{rule.id} ({rule.name})")
            body = (type(rule).__doc__ or rule.doc or "").rstrip()
            import inspect

            print(inspect.cleandoc(body) if body else "(no documentation)")
            return 0
    print(f"error: no such rule: {rule_id}", file=sys.stderr)
    return 2


def _github_annotation(f) -> str:
    """One GitHub Actions workflow command per finding: the web UI pins
    the message to the file/line in the PR diff."""
    msg = f"{f.rule} ({f.name}) {f.message}"
    # workflow-command escaping: %, CR, LF in properties and message
    msg = (msg.replace("%", "%25").replace("\r", "%0D").replace("\n", "%0A"))
    return (
        f"::error file={f.path},line={f.line},col={f.col},"
        f"title=edl-lint {f.rule}::{msg}"
    )


def _emit_lock_graph(paths: List[str], dest: str) -> None:
    """Build the EDL102 static lock-acquisition graph over `paths` and
    write it to `dest` (.dot extension → DOT, else JSON)."""
    from elasticdl_tpu_torch.analysis.concurrency import (
        build_lock_graph,
        render_lock_graph_dot,
    )
    from elasticdl_tpu_torch.analysis.core import (
        ModuleContext,
        ProjectContext,
        iter_python_files,
    )

    contexts = []
    for abs_path, rel_path in iter_python_files(paths):
        try:
            with open(abs_path, encoding="utf-8") as fh:
                contexts.append(ModuleContext(abs_path, fh.read(), rel_path))
        except (SyntaxError, UnicodeDecodeError):
            continue
    graph = build_lock_graph(ProjectContext(contexts))
    with open(dest, "w", encoding="utf-8") as fh:
        if dest.endswith(".dot"):
            fh.write(render_lock_graph_dot(graph))
        else:
            json.dump(graph, fh, indent=2)
            fh.write("\n")
    print(
        f"lock graph: {len(graph['nodes'])} lock(s), "
        f"{len(graph['edges'])} edge(s), {len(graph['cycles'])} cycle(s) "
        f"-> {dest}"
    )


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m elasticdl_tpu_torch.analysis",
        description="project-specific static analysis (edl-lint)",
    )
    parser.add_argument(
        "paths", nargs="*", help="files/directories to lint "
        "(default: the elasticdl_tpu_torch package)",
    )
    parser.add_argument("--json", action="store_true", help="JSON output")
    parser.add_argument(
        "--format", choices=("text", "github"), default="text",
        help="finding output format: 'github' emits workflow error "
        "annotations (::error file=...) for the CI job",
    )
    parser.add_argument(
        "--baseline", default=None,
        help=f"baseline file (default: nearest {BASELINE_NAME})",
    )
    parser.add_argument(
        "--no-baseline", action="store_true",
        help="ignore any baseline: report every finding as new",
    )
    parser.add_argument(
        "--write-baseline", action="store_true",
        help="write current findings to the baseline file and exit 0",
    )
    parser.add_argument(
        "--prune-baseline", action="store_true",
        help="drop stale (fixed) entries from the baseline file, keeping "
        "surviving justifications, then report as usual",
    )
    parser.add_argument(
        "--select", default="",
        help="comma-separated rule ids/names to run; family prefixes work "
        "(--select EDL1 runs every EDL1xx rule)",
    )
    parser.add_argument(
        "--explain", default=None, metavar="RULE",
        help="print a rule's full documentation (docstring) and exit",
    )
    parser.add_argument(
        "--lock-graph", default=None, metavar="DEST",
        help="also emit the EDL102 static lock-acquisition graph to DEST "
        "(.dot -> DOT, anything else -> JSON)",
    )
    parser.add_argument(
        "--list-rules", action="store_true", help="list rules and exit"
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in all_rules():
            print(f"{rule.id}  {rule.name}: {rule.doc}")
        return 0
    if args.explain:
        return _explain(args.explain)

    paths = args.paths or _default_paths()
    for p in paths:
        if not os.path.exists(p):
            print(f"error: no such path: {p}", file=sys.stderr)
            return 2

    baseline_path = args.baseline or _default_baseline(paths)
    baseline = (
        {} if args.no_baseline or not baseline_path
        else load_baseline(baseline_path)
    )
    select = {s.strip() for s in args.select.split(",") if s.strip()} or None

    result = run_analysis(paths, baseline=baseline, select=select)

    if args.lock_graph:
        _emit_lock_graph(paths, args.lock_graph)

    if args.write_baseline:
        target = baseline_path or os.path.join(os.getcwd(), BASELINE_NAME)
        write_baseline(target, result.findings)
        print(f"wrote {len(result.findings)} entries to {target}")
        return 0

    if args.prune_baseline and result.stale_baseline:
        if not baseline_path:
            print("error: --prune-baseline without a baseline file",
                  file=sys.stderr)
            return 2
        removed = prune_baseline(baseline_path, result.stale_baseline)
        print(f"pruned {removed} stale entr(y/ies) from {baseline_path}")
        result.stale_baseline = []

    if args.json:
        print(json.dumps(
            {
                "new": [f.__dict__ for f in result.new],
                "baselined": [f.__dict__ for f in result.baselined],
                "stale_baseline": result.stale_baseline,
                "errors": result.errors,
                "ok": result.ok,
            },
            indent=2,
        ))
    elif args.format == "github":
        for f in result.new:
            print(_github_annotation(f))
        for err in result.errors:
            print(f"::error title=edl-lint parse error::{err}")
        for fp in result.stale_baseline:
            print(f"::error title=edl-lint stale baseline::{fp} no longer "
                  "fires — run --prune-baseline")
        n_new, n_base = len(result.new), len(result.baselined)
        print(
            f"edl-lint: {n_new} new finding(s), {n_base} baselined, "
            f"{len(result.errors)} error(s)"
        )
    else:
        for f in result.new:
            print(f.render())
        for err in result.errors:
            print(f"parse error: {err}")
        if result.stale_baseline:
            print(
                f"STALE baseline: {len(result.stale_baseline)} entr(y/ies) "
                "no longer fire — fixed findings must leave the ledger "
                "(run --prune-baseline); failing"
            )
            for fp in result.stale_baseline:
                print(f"  {fp}")
        n_new, n_base = len(result.new), len(result.baselined)
        print(
            f"edl-lint: {n_new} new finding(s), {n_base} baselined, "
            f"{len(result.errors)} error(s)"
        )
    return 0 if result.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
