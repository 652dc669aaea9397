"""EDL101 guarded-by: annotation-driven lock discipline for class state.

Convention (enforced here, documented in docs/development.md):

- Annotate a shared attribute at its `__init__` assignment:

      self._workers: Dict[int, WorkerInfo] = {}   # guarded_by: _lock

- Every other read/write of `self._workers` inside the class must then
  happen either lexically under `with self._lock:` (aliases via
  `with self._lock as l:` count; `self._lock.acquire()` does NOT — the
  release pairing isn't checkable), or inside a method that asserts it is
  called with the lock held:

      * a `_locked`-suffixed method name (the codebase's existing idiom), or
      * a `# holds: _lock` comment on the `def` line or the comment line
        directly above it.

- `__init__` is exempt (construction happens-before publication), as are
  other methods listed in _CONSTRUCTION_METHODS.

Nested functions and lambdas defined inside a method run later, on
whatever thread calls them — they get an EMPTY held-set even when defined
under the lock. If a closure really is only called under the lock,
suppress with `# edl-lint: disable=EDL101` at the access.

This is deliberately a LEXICAL checker, not an escape analysis: it can be
fooled by aliasing (`w = self._workers` under the lock, used after).
It exists to catch the common failure — a new method reading a guarded
map without the lock — at review time, not to prove the program race-free.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Set

from elasticdl_tpu_torch.analysis.core import Finding, ModuleContext, Rule, register

_GUARDED_RE = re.compile(
    r"self\.(?P<attr>\w+)\s*(?::[^=]*)?=.*#\s*guarded_by:\s*(?P<lock>\w+)"
)
# comment-only line form: `# guarded_by: _lock` annotating the NEXT line's
# `self.attr = ...` (used when the assignment line is already full)
_GUARDED_ABOVE_RE = re.compile(r"^\s*#\s*guarded_by:\s*(?P<lock>\w+)\s*$")
_SELF_ASSIGN_RE = re.compile(r"^\s*self\.(?P<attr>\w+)\s*(?::[^=]*)?=")
_HOLDS_RE = re.compile(r"#\s*holds:\s*(?P<locks>[\w, ]+)")

#: methods that run before the object is visible to other threads
_CONSTRUCTION_METHODS = {"__init__", "__new__", "__post_init__"}


def guarded_attrs(ctx: ModuleContext, cls: ast.ClassDef) -> Dict[str, str]:
    """attr -> lock name, from `guarded_by:` annotation comments in the
    class's construction methods (shared by EDL101 and EDL402)."""
    out: Dict[str, str] = {}
    end = cls.end_lineno or cls.lineno
    for line in range(cls.lineno, end + 1):
        # only annotations inside construction methods define guards
        # (an annotation elsewhere would be ambiguous about intent)
        qual = ctx.qualname_at(line)
        if qual.split(".")[-1] not in _CONSTRUCTION_METHODS:
            continue
        m = _GUARDED_RE.search(ctx.line_text(line))
        if m:
            out[m.group("attr")] = m.group("lock")
            continue
        m = _GUARDED_ABOVE_RE.match(ctx.line_text(line))
        if m:
            nxt = _SELF_ASSIGN_RE.match(ctx.line_text(line + 1))
            if nxt:
                out[nxt.group("attr")] = m.group("lock")
    return out


def _with_held_locks(node: ast.With) -> Set[str]:
    """Lock attribute names this `with` statement acquires (self.X only)."""
    held: Set[str] = set()
    for item in node.items:
        expr = item.context_expr
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
        ):
            held.add(expr.attr)
    return held


def method_held_locks(
    ctx: ModuleContext, node: ast.FunctionDef, class_locks: Set[str]
) -> Set[str]:
    """Locks a method declares it is called under (shared with EDL402)."""
    held: Set[str] = set()
    if node.name.endswith("_locked"):
        # the codebase idiom: `_foo_locked` is only called under the lock
        held |= class_locks
    for line in (node.lineno, node.lineno - 1):
        m = _HOLDS_RE.search(ctx.line_text(line))
        if m:
            held |= {
                name.strip() for name in m.group("locks").split(",") if name.strip()
            }
    return held


class _AccessVisitor(ast.NodeVisitor):
    """Walk one method body tracking the lexically-held lock set."""

    def __init__(
        self,
        rule: "GuardedByRule",
        ctx: ModuleContext,
        guarded: Dict[str, str],
        held: Set[str],
    ):
        self.rule = rule
        self.ctx = ctx
        self.guarded = guarded
        self.held = set(held)
        self.findings: List[Finding] = []

    def visit_With(self, node: ast.With) -> None:
        acquired = _with_held_locks(node)
        for item in node.items:
            self.visit(item.context_expr)   # the lock expression itself
            if item.optional_vars is not None:
                self.visit(item.optional_vars)
        saved = set(self.held)
        self.held |= acquired
        for stmt in node.body:
            self.visit(stmt)
        self.held = saved

    def _visit_deferred(self, node: ast.AST) -> None:
        """Nested defs/lambdas execute later: empty held-set inside."""
        saved = set(self.held)
        self.held = set()
        self.generic_visit(node)
        self.held = saved

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._visit_deferred(node)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._visit_deferred(node)

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self._visit_deferred(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if (
            isinstance(node.value, ast.Name)
            and node.value.id == "self"
            and node.attr in self.guarded
        ):
            lock = self.guarded[node.attr]
            if lock not in self.held:
                kind = "write" if isinstance(node.ctx, (ast.Store, ast.Del)) else "read"
                self.findings.append(
                    self.rule.finding(
                        self.ctx,
                        node,
                        f"{kind} of self.{node.attr} (guarded_by {lock}) "
                        f"outside `with self.{lock}`",
                    )
                )
        self.generic_visit(node)


@register
class GuardedByRule(Rule):
    id = "EDL101"
    name = "guarded-by"
    doc = (
        "access to a `# guarded_by: <lock>` attribute outside "
        "`with self.<lock>` (or a method annotated/`_locked`-named as "
        "holding it)"
    )

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for cls in ast.walk(ctx.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            guarded = guarded_attrs(ctx, cls)
            if not guarded:
                continue
            class_locks = set(guarded.values())
            for node in cls.body:
                yield from self._check_function(ctx, node, guarded, class_locks)

    def _check_function(
        self,
        ctx: ModuleContext,
        node: ast.AST,
        guarded: Dict[str, str],
        class_locks: Set[str],
    ) -> Iterator[Finding]:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return
        if node.name in _CONSTRUCTION_METHODS:
            return
        held = method_held_locks(ctx, node, class_locks)
        visitor = _AccessVisitor(self, ctx, guarded, held)
        for stmt in node.body:
            visitor.visit(stmt)
        yield from visitor.findings
