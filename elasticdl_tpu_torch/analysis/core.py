"""edl-lint framework: findings, suppressions, baseline, runner.

Design constraints that shaped this:

- AST-only, stdlib-only. The lint must run anywhere the package imports
  (CI images without dev extras, the TPU sandbox), so no libcst/ruff
  plugin machinery — `ast` + `end_lineno` (py3.8+) is enough for every
  rule here.
- Findings fingerprint WITHOUT line numbers (rule + file + enclosing
  def/class + message), so the checked-in baseline survives unrelated
  edits above a tolerated finding. Two identical findings in one scope
  get an occurrence suffix to stay distinct.
- Suppressions are per-line (`# edl-lint: disable=EDL201` on the line or
  on a comment-only line directly above) or per-file
  (`# edl-lint: disable-file=EDL201`). Rule ids and slugs both work.
  A suppression is a reviewed decision; the baseline is tolerated debt —
  new code should never add baseline entries.
"""

from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set, Tuple

#: files never linted (generated code has no style to enforce)
EXCLUDED_FILES = {"elasticdl_tpu_pb2.py"}

#: the directive may sit anywhere in a comment ("… reason: edl-lint:
#: disable=EDL201"), so justification prose and directive share a line
_DIRECTIVE_RE = re.compile(
    r"#.*?edl-lint:\s*(disable|disable-file)\s*=\s*([A-Za-z0-9_\-]+(?:\s*,\s*[A-Za-z0-9_\-]+)*)"
)


@dataclass(frozen=True)
class Finding:
    """One rule violation at a concrete source location."""

    rule: str       # id, e.g. "EDL301"
    name: str       # slug, e.g. "bare-master-stub"
    path: str       # relative, forward-slash path
    line: int
    col: int
    message: str
    context: str = ""   # innermost enclosing "Class.method" (or "<module>")
    # last line of the flagged node: a suppression anywhere in [line,
    # end_line] silences it (an `except:` finding is suppressible from its
    # `pass` body line). NOT part of the fingerprint.
    end_line: int = 0

    def fingerprint(self) -> str:
        """Line-independent identity used by the baseline."""
        return f"{self.rule}:{self.path}:{self.context}:{self.message}"

    def render(self) -> str:
        ctx = f" [{self.context}]" if self.context else ""
        return f"{self.path}:{self.line}:{self.col}: {self.rule} ({self.name}) {self.message}{ctx}"


class Rule:
    """Base class: subclasses set `id`, `name`, `doc` and yield Findings."""

    id: str = ""
    name: str = ""
    doc: str = ""

    def check(self, ctx: "ModuleContext") -> Iterator[Finding]:
        raise NotImplementedError

    def finding(
        self, ctx: "ModuleContext", node: ast.AST, message: str
    ) -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        return Finding(
            rule=self.id,
            name=self.name,
            path=ctx.rel_path,
            line=line,
            col=col,
            message=message,
            context=ctx.qualname_at(line),
            end_line=getattr(node, "end_lineno", line) or line,
        )


class ProjectRule(Rule):
    """A rule that needs the WHOLE parsed tree (call graph, cross-module
    state) instead of one module at a time. Subclasses implement
    `check_project`; suppression/baseline/CLI machinery is shared — each
    Finding is attributed to its module and suppressible there like any
    per-module finding."""

    def check(self, ctx: "ModuleContext") -> Iterator[Finding]:
        return iter(())

    def check_project(self, project: "ProjectContext") -> Iterator[Finding]:
        raise NotImplementedError


class ProjectContext:
    """Every parsed module of one run, plus shared lazily-built analyses.

    The tree is parsed ONCE (the same ModuleContexts the per-module rules
    saw); the call graph and any heavier shared models are built on first
    use and memoized in `cache`, so N project rules pay for one build."""

    def __init__(self, modules: Sequence["ModuleContext"]):
        self.modules = list(modules)
        self.by_path: Dict[str, "ModuleContext"] = {
            m.rel_path: m for m in self.modules
        }
        self.cache: Dict[str, object] = {}
        self._callgraph = None

    @property
    def callgraph(self):
        if self._callgraph is None:
            from elasticdl_tpu_torch.analysis.callgraph import CallGraph

            self._callgraph = CallGraph(self.modules)
        return self._callgraph

    def suppressed(self, finding: Finding) -> bool:
        ctx = self.by_path.get(finding.path)
        return ctx.suppressed(finding) if ctx is not None else False


class ModuleContext:
    """One parsed module plus the lookups every rule needs."""

    def __init__(self, path: str, source: str, rel_path: Optional[str] = None):
        self.path = path
        self.rel_path = (rel_path or path).replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self._suppressions = self._parse_suppressions()
        self._scopes = self._collect_scopes()

    # -------------------------------------------------------------- #
    # suppressions

    def _parse_suppressions(self) -> Tuple[Dict[int, Set[str]], Set[str]]:
        per_line: Dict[int, Set[str]] = {}
        per_file: Set[str] = set()
        pending: Set[str] = set()   # from a comment-only line, applies below
        for i, text in enumerate(self.lines, start=1):
            stripped = text.strip()
            m = _DIRECTIVE_RE.search(text)
            rules: Set[str] = set()
            if m:
                rules = {
                    r.strip().lower() for r in m.group(2).split(",") if r.strip()
                }
                if m.group(1) == "disable-file":
                    per_file |= rules
                    rules = set()
            if stripped.startswith("#"):
                # comment-only line: carry the directive to the next code line
                pending |= rules
                continue
            line_rules = rules | pending
            pending = set()
            if line_rules:
                per_line[i] = line_rules
        return per_line, per_file

    def suppressed(self, finding: Finding) -> bool:
        per_line, per_file = self._suppressions
        keys = {finding.rule.lower(), finding.name.lower(), "all"}
        if per_file & keys:
            return True
        last = max(finding.line, finding.end_line or finding.line)
        return any(
            per_line.get(line, set()) & keys
            for line in range(finding.line, last + 1)
        )

    # -------------------------------------------------------------- #
    # scope lookup

    def _collect_scopes(self) -> List[Tuple[int, int, str]]:
        scopes: List[Tuple[int, int, str]] = []

        def visit(node: ast.AST, prefix: str) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
                ):
                    qual = f"{prefix}.{child.name}" if prefix else child.name
                    scopes.append(
                        (child.lineno, child.end_lineno or child.lineno, qual)
                    )
                    visit(child, qual)
                else:
                    visit(child, prefix)

        visit(self.tree, "")
        return scopes

    def qualname_at(self, line: int) -> str:
        """Innermost def/class enclosing `line` ("<module>" if none)."""
        best = "<module>"
        best_span = None
        for start, end, qual in self._scopes:
            if start <= line <= end:
                span = end - start
                if best_span is None or span <= best_span:
                    best, best_span = qual, span
        return best

    def line_text(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1]
        return ""


# ------------------------------------------------------------------ #
# rule registry

_RULES: List[Rule] = []


def register(rule_cls: type) -> type:
    _RULES.append(rule_cls())
    return rule_cls


def all_rules() -> List[Rule]:
    """Every registered rule (importing the rule modules registers them)."""
    # imported lazily so `core` has no import cycle with the rule modules
    from elasticdl_tpu_torch.analysis import (  # noqa: F401
        concurrency,
        elasticity_rules,
        torch_rules,
        locks,
        observability_rules,
        rpc_rules,
    )

    return list(_RULES)


def select_rules(
    rules: Sequence[Rule], select: Optional[Set[str]]
) -> List[Rule]:
    """Filter by id, slug, or FAMILY PREFIX: `EDL1` selects every EDL1xx
    rule (`EDL` selects all). Matching is case-insensitive."""
    if not select:
        return list(rules)
    wanted = {s.lower() for s in select}
    out: List[Rule] = []
    for r in rules:
        rid = r.id.lower()
        if rid in wanted or r.name.lower() in wanted:
            out.append(r)
            continue
        if any(
            re.fullmatch(r"edl\d{0,2}", w) and rid.startswith(w)
            for w in wanted
        ):
            out.append(r)
    return out


# ------------------------------------------------------------------ #
# baseline

def load_baseline(path: str) -> Dict[str, str]:
    """fingerprint -> justification. Missing file = empty baseline."""
    if not path or not os.path.exists(path):
        return {}
    with open(path) as f:
        data = json.load(f)
    entries = data.get("entries", [])
    out: Dict[str, str] = {}
    for e in entries:
        out[e["fingerprint"]] = e.get("justification", "")
    return out


def _suffixed_fingerprints(findings: Sequence[Finding]) -> List[str]:
    """Fingerprints with an occurrence suffix disambiguating repeats (two
    identical findings in one scope must not collapse to one baseline
    entry). Deterministic given the runner's (path, line, col, rule) sort
    order, so write_baseline and run_analysis agree."""
    seen: Dict[str, int] = {}
    out: List[str] = []
    for f in findings:
        fp = f.fingerprint()
        n = seen.get(fp, 0)
        seen[fp] = n + 1
        out.append(fp if n == 0 else f"{fp}#{n}")
    return out


def prune_baseline(path: str, stale: Sequence[str]) -> int:
    """Drop `stale` fingerprints from the baseline file IN PLACE,
    preserving the surviving entries' justifications (write_baseline
    would reset them to TODO). Returns the number removed."""
    if not path or not os.path.exists(path) or not stale:
        return 0
    with open(path) as f:
        data = json.load(f)
    entries = data.get("entries", [])
    dead = set(stale)
    kept = [e for e in entries if e.get("fingerprint") not in dead]
    removed = len(entries) - len(kept)
    if removed:
        data["entries"] = kept
        with open(path, "w") as fh:
            json.dump(data, fh, indent=2)
            fh.write("\n")
    return removed


def write_baseline(path: str, findings: Sequence[Finding]) -> None:
    entries = [
        {
            "fingerprint": fp,
            "rule": f.rule,
            "path": f.path,
            "justification": "TODO: justify or fix",
        }
        for f, fp in zip(findings, _suffixed_fingerprints(findings))
    ]
    with open(path, "w") as fh:
        json.dump({"version": 1, "entries": entries}, fh, indent=2)
        fh.write("\n")


# ------------------------------------------------------------------ #
# runner

def iter_python_files(paths: Iterable[str]) -> Iterator[Tuple[str, str]]:
    """Yield (abs_path, rel_path) for every lintable .py under `paths`."""
    for root in paths:
        root = os.path.abspath(root)
        if os.path.isfile(root):
            # keep directory components: path-based allowlists (EDL301's
            # proto/service.py) and baseline fingerprints must match the
            # directory-walk spelling; fall back to the absolute path for
            # files outside the working tree
            rel = os.path.relpath(root, os.getcwd())
            yield root, (root if rel.startswith("..") else rel)
            continue
        base = os.path.dirname(root)
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = sorted(
                d for d in dirnames if d not in ("__pycache__", ".git")
            )
            for fn in sorted(filenames):
                if not fn.endswith(".py") or fn in EXCLUDED_FILES:
                    continue
                abs_path = os.path.join(dirpath, fn)
                yield abs_path, os.path.relpath(abs_path, base)


@dataclass
class AnalysisResult:
    findings: List[Finding]          # all unsuppressed findings
    new: List[Finding]               # not covered by the baseline
    baselined: List[Finding]         # covered by the baseline
    stale_baseline: List[str]        # baseline fingerprints no longer seen
    errors: List[str]                # unparseable files

    @property
    def ok(self) -> bool:
        # stale baseline entries FAIL the run (not a note): tolerated
        # debt that got fixed must leave the ledger (--prune-baseline),
        # or the baseline silently rots into covering future findings
        return not self.new and not self.errors and not self.stale_baseline


def run_analysis(
    paths: Sequence[str],
    rules: Optional[Sequence[Rule]] = None,
    baseline: Optional[Dict[str, str]] = None,
    select: Optional[Set[str]] = None,
) -> AnalysisResult:
    rules = select_rules(
        list(rules) if rules is not None else all_rules(), select
    )
    baseline = baseline or {}
    findings: List[Finding] = []
    errors: List[str] = []
    contexts: List[ModuleContext] = []
    for abs_path, rel_path in iter_python_files(paths):
        try:
            with open(abs_path, encoding="utf-8") as f:
                source = f.read()
            contexts.append(ModuleContext(abs_path, source, rel_path))
        except (SyntaxError, UnicodeDecodeError) as e:
            errors.append(f"{rel_path}: {e}")
    module_rules = [r for r in rules if not isinstance(r, ProjectRule)]
    project_rules = [r for r in rules if isinstance(r, ProjectRule)]
    for ctx in contexts:
        for rule in module_rules:
            for finding in rule.check(ctx):
                if not ctx.suppressed(finding):
                    findings.append(finding)
    if project_rules:
        project = ProjectContext(contexts)
        for rule in project_rules:
            for finding in rule.check_project(project):
                if not project.suppressed(finding):
                    findings.append(finding)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    fingerprints = _suffixed_fingerprints(findings)

    new, baselined = [], []
    for f, fp in zip(findings, fingerprints):
        (baselined if fp in baseline else new).append(f)
    live = set(fingerprints)
    stale = [fp for fp in baseline if fp not in live]
    return AnalysisResult(
        findings=findings, new=new, baselined=baselined,
        stale_baseline=stale, errors=errors,
    )
