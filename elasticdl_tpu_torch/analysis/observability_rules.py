"""EDL4xx: observability hygiene.

EDL401 metric-name-pattern
    A metric registered through the registry factories (`counter`,
    `gauge`, `histogram`) with a literal name that does not match the
    project naming pattern `edl_<subsystem>_<name>` (lowercase,
    underscore-separated — observability/registry._NAME_RE). The runtime
    registry rejects bad names too; this rule catches them at lint time,
    before the first scrape, and covers names the runtime path may not
    reach in tests (conditionally-registered metrics).

    Only literal string names are checkable statically; dynamic names are
    the runtime validator's job.

EDL402 span-emit-under-lock
    A span opened or an event emitted (`tracing.span`/`tracing.event`,
    `get_tracer().span/event`, or a directly-imported `span`/`event`)
    lexically inside the critical section of a `guarded_by:`-annotated
    lock — via `with self.<lock>:` or inside a method declared to hold it
    (`# holds: <lock>` / `_locked` suffix). Trace emission writes (and
    flushes) trace.jsonl under the tracer's own lock; doing that while
    holding a control-plane lock puts file I/O inside a contended critical
    section and couples the subsystem's lock to the tracer's. PR 4 fixed
    exactly this by hand in the process manager (the reform.spawn span now
    wraps the lock, not the reverse) and in the dispatcher (lease/report
    events emit after release); this rule codifies the idiom. Metric
    mutations (`.inc()`/`.set()`/`.observe()`) stay fine under locks —
    metric locks are leaf locks and touch no files.

    Emit after releasing: compute inside the lock, emit outside (the
    membership/dispatcher pattern), or open the span around the `with
    self._lock:` block (the process-manager pattern).

EDL404 span-sink-in-hot-loop
    A span opened or an event emitted (same call shapes as EDL402)
    lexically inside a PER-STEP hot loop — a for/while whose body
    dispatches device steps (`train_step`/`train_many`/`eval_step`/...,
    the EDL201 hot-loop definition). Every span/event emission writes
    (and flushes) trace.jsonl under the tracer lock: per-step emission
    puts file I/O on the training hot path, thousands of times per task.
    Per-step telemetry belongs in the structures built for it — the step
    profiler's phase accumulators (observability/profile.py: perf_counter
    reads + float adds) and the flight recorder's in-memory ring
    (observability/flight.py), which capture full fidelity without
    touching a file until an incident dumps them. Emit spans at task /
    rescale / reform granularity instead.

EDL405 unbounded-metric-label-cardinality
    A metric mutation (`.inc()`/`.set()`/`.observe()`/`.add()` on a
    registry metric) whose label VALUE derives from a loop variable —
    a `for` target or comprehension target lexically enclosing the
    call. Label values become registry dictionary keys that live
    forever: a label fed from a per-id / per-task / per-row loop grows
    the registry (and every scrape) without bound — the classic
    cardinality explosion. Bounded enumerations are fine and common:
    a loop over a module-level constant tuple (the profiler's PHASES)
    is recognized and exempt; a loop whose bound the linter cannot see
    (range(num_shards), dict iteration) but a reviewer CAN — per-shard
    labels bounded by --embedding_shards — carries an explicit
    `# edl-lint: disable=EDL405` with justification. Everything else
    should label by a bounded dimension (op, phase, method) and carry
    the unbounded one as a value, not a label.

EDL406 wall-clock-duration-measurement
    A subtraction whose BOTH operands are wall-clock stamps — a
    ``time.time()`` call and/or a local name assigned directly from one
    in the same scope (``t0 = time.time() ... time.time() - t0``). A
    wall-clock delta used as a duration is corrupted by NTP steps and
    leap adjustments: a 30 s clock slew lands as a 30 s "step time" in a
    histogram, a negative phase in the goodput ledger, a phantom reform
    spike — monotonic/perf_counter deltas are immune and cost the same.
    Epoch arithmetic against STORED wall-clock stamps (heartbeat
    staleness windows, cross-process `updated_at` comparisons) is
    intentionally out of scope: only local-local / call-local pairs
    flag, and the rare intended case carries a reviewed
    ``# edl-lint: disable=EDL406`` with justification.

EDL407 per-call-span-in-data-plane-hot-path
    A span opened or an event emitted (same call shapes as EDL402/404)
    inside a per-call function of the embedding data plane's fused
    pull/push hot path — the modules behind `pull_unique_multi`
    (embedding/data_plane.py, tier.py, shm.py, transport.py), in
    functions on the per-call path (pull*/push*/serve*/hedge*/retry*/
    the wire-call shims and codec helpers). These paths run per fused
    read — thousands of times per step at wire speed — and every raw
    span/event emission writes (and flushes) trace.jsonl under the
    tracer lock. Per-call telemetry on the data plane goes through the
    request-diary recorder (observability/reqtrace.py): `stage()` /
    `event()` land in the caller's open diaries cheaply when diaries
    are active and no-op otherwise, and tail-based sampling decides
    AFTER the call whether anything is worth keeping. Spans stay at
    phase/reshard granularity. Same emit detection as EDL404; distinct
    rule because the data plane's hot path is per-CALL (no train_step
    dispatch in sight for the hot-loop heuristic to catch).

EDL403 fsync-under-lock
    An ``os.fsync`` call lexically inside a `guarded_by:`-annotated
    lock's critical section. An fsync is milliseconds on local disk and
    tens of milliseconds on NFS/GCS-FUSE; under a control-plane lock it
    serializes every mutator behind the disk and bounds master dispatch
    throughput to ~1/fsync-latency fleet-wide — the exact wall the
    journal's group-commit pipeline (master/journal.py) exists to remove.
    The idiom this codifies: mutators ENQUEUE onto the journal's commit
    queue under their lock and wait for durability after releasing; only
    the journal's committer (and reviewed leaf-I/O teardown paths, via
    explicit `# edl-lint: disable=EDL403` with justification) fsyncs
    while holding a lock.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator, List, Set

from elasticdl_tpu_torch.analysis.core import Finding, ModuleContext, Rule, register
from elasticdl_tpu_torch.analysis.torch_rules import (
    _DISPATCH_METHODS,
    _called_attr_names,
)
from elasticdl_tpu_torch.analysis.locks import (
    _CONSTRUCTION_METHODS,
    guarded_attrs,
    method_held_locks,
)

#: kept textually in sync with observability/registry._NAME_RE (a test
#: pins the two together)
METRIC_NAME_RE = re.compile(r"^edl_[a-z][a-z0-9]*_[a-z0-9_]*[a-z0-9]$")

_FACTORIES = {"counter", "gauge", "histogram"}


def _metric_name_arg(node: ast.Call) -> "ast.Constant | None":
    """The literal name argument of a registry-factory call, if any."""
    if node.args and isinstance(node.args[0], ast.Constant) \
            and isinstance(node.args[0].value, str):
        return node.args[0]
    for kw in node.keywords:
        if kw.arg == "name" and isinstance(kw.value, ast.Constant) \
                and isinstance(kw.value.value, str):
            return kw.value
    return None


@register
class MetricNamePatternRule(Rule):
    id = "EDL401"
    name = "metric-name-pattern"
    doc = (
        "metric name outside the registry naming pattern "
        "edl_<subsystem>_<name> — keep the scrape surface grep-able"
    )

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            attr = (
                func.attr if isinstance(func, ast.Attribute)
                else func.id if isinstance(func, ast.Name) else ""
            )
            if attr not in _FACTORIES:
                continue
            name_node = _metric_name_arg(node)
            if name_node is None:
                continue
            value = name_node.value
            # only metric-shaped literals are in scope: a bare
            # `counter("x")` from an unrelated library (collections-style
            # counters take iterables, not names) would otherwise flag —
            # the registry convention is that every metric name starts
            # with edl_, so anything else passed to these factories is
            # either a naming violation (starts wrong) or not a metric at
            # all; the distinguishing signal is an identifier-looking
            # string
            if not re.match(r"^[A-Za-z_][A-Za-z0-9_]*$", value):
                continue
            if not METRIC_NAME_RE.match(value):
                yield self.finding(
                    ctx, name_node,
                    f"metric name {value!r} does not match "
                    "edl_<subsystem>_<name> (EDL401; see "
                    "docs/observability.md)",
                )


# ------------------------------------------------------------------ #
# EDL402 span-emit-under-lock


_EMIT_ATTRS = {"span", "event"}


def _direct_emit_imports(tree: ast.AST) -> Set[str]:
    """Local names bound to tracing.span/tracing.event by a
    `from ...observability.tracing import span, event` (any alias)."""
    names: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module \
                and node.module.endswith("tracing"):
            for alias in node.names:
                if alias.name in _EMIT_ATTRS:
                    names.add(alias.asname or alias.name)
    return names


def _is_emit_call(node: ast.Call, direct_names: Set[str]) -> bool:
    func = node.func
    if isinstance(func, ast.Name):
        return func.id in direct_names
    if not isinstance(func, ast.Attribute) or func.attr not in _EMIT_ATTRS:
        return False
    base = func.value
    # tracing.span(...) / tracing.event(...) — the tree's idiom (lazy
    # in-function imports make import-tracking unreliable, so the base
    # NAME is the signal)
    if isinstance(base, ast.Name) and base.id == "tracing":
        return True
    # get_tracer().span(...) / tracing.get_tracer().event(...)
    if isinstance(base, ast.Call):
        f = base.func
        fname = (
            f.id if isinstance(f, ast.Name)
            else f.attr if isinstance(f, ast.Attribute) else ""
        )
        return fname == "get_tracer"
    return False


class _CallUnderLockVisitor(ast.NodeVisitor):
    """Walk one method body tracking which class locks are lexically held
    (same `with self.<lock>` semantics as EDL101's visitor), flagging
    calls matching `predicate` while any of them is. Shared by EDL402
    (span/event emission) and EDL403 (os.fsync)."""

    def __init__(self, rule: Rule, ctx: ModuleContext,
                 class_locks: Set[str], held: Set[str],
                 predicate, message_fn):
        self.rule = rule
        self.ctx = ctx
        self.class_locks = class_locks
        self.held = set(held)
        self.predicate = predicate
        self.message_fn = message_fn
        self.findings: List[Finding] = []

    def visit_With(self, node: ast.With) -> None:
        # items are processed IN ORDER, growing the held set as each lock
        # is acquired: `with tracing.span(...): with self._lock:` (the
        # span wrapping the lock) is the idiomatic GOOD shape, while the
        # combined `with self._lock, tracing.span(...):` acquires the
        # lock FIRST and then opens the span under it — flagged
        saved = set(self.held)
        for item in node.items:
            self.visit(item.context_expr)
            if item.optional_vars is not None:
                self.visit(item.optional_vars)
            expr = item.context_expr
            if (
                isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "self"
                and expr.attr in self.class_locks
            ):
                self.held.add(expr.attr)
        for stmt in node.body:
            self.visit(stmt)
        self.held = saved

    def _visit_deferred(self, node: ast.AST) -> None:
        # nested defs/lambdas run later, on whatever thread calls them
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

    def visit_Call(self, node: ast.Call) -> None:
        if self.held and self.predicate(node):
            locks = ", ".join(sorted(self.held))
            self.findings.append(
                self.rule.finding(
                    ctx=self.ctx, node=node,
                    message=self.message_fn(node, locks),
                )
            )
        self.generic_visit(node)


@register
class SpanEmitUnderLockRule(Rule):
    id = "EDL402"
    name = "span-emit-under-lock"
    doc = (
        "span/event emitted inside a guarded_by-annotated lock's critical "
        "section — trace emission does file I/O; emit after releasing"
    )

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        direct_names = _direct_emit_imports(ctx.tree)

        def message(node: ast.Call, locks: str) -> str:
            kind = (
                node.func.attr if isinstance(node.func, ast.Attribute)
                else node.func.id
            )
            return (
                f"{kind} emission inside the critical section of "
                f"self.{locks} — trace emission is file I/O under "
                "the tracer lock; emit after releasing, or open "
                "the span around the lock (EDL402)"
            )

        yield from _scan_calls_under_locks(
            self, ctx, lambda node: _is_emit_call(node, direct_names),
            message,
        )


def _scan_calls_under_locks(rule, ctx, predicate, message_fn):
    """Run the held-lock call scan over every guarded class (the shared
    chassis of EDL402/EDL403)."""
    for cls in ast.walk(ctx.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        guarded = guarded_attrs(ctx, cls)
        if not guarded:
            continue
        class_locks = set(guarded.values())
        for node in cls.body:
            if not isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef)
            ):
                continue
            if node.name in _CONSTRUCTION_METHODS:
                # construction happens-before publication: the lock
                # cannot be contended yet (EDL101's exemption)
                continue
            held = method_held_locks(ctx, node, class_locks) & class_locks
            visitor = _CallUnderLockVisitor(
                rule, ctx, class_locks, held, predicate, message_fn
            )
            for stmt in node.body:
                visitor.visit(stmt)
            yield from visitor.findings


# ------------------------------------------------------------------ #
# EDL403 fsync-under-lock


def _direct_fsync_imports(tree: ast.AST) -> Set[str]:
    """Local names bound to os.fsync by `from os import fsync` (aliases)."""
    names: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == "os":
            for alias in node.names:
                if alias.name == "fsync":
                    names.add(alias.asname or alias.name)
    return names


def _is_fsync_call(node: ast.Call, direct_names: Set[str]) -> bool:
    func = node.func
    if isinstance(func, ast.Name):
        return func.id in direct_names
    return (
        isinstance(func, ast.Attribute)
        and func.attr == "fsync"
        and isinstance(func.value, ast.Name)
        and func.value.id == "os"
    )


@register
class FsyncUnderLockRule(Rule):
    id = "EDL403"
    name = "fsync-under-lock"
    doc = (
        "os.fsync inside a guarded_by-annotated lock's critical section — "
        "per-commit fsync under a control-plane lock serializes every "
        "mutator behind the disk; enqueue on the journal's group-commit "
        "queue and wait after releasing instead"
    )

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        direct_names = _direct_fsync_imports(ctx.tree)

        def message(node: ast.Call, locks: str) -> str:
            return (
                f"os.fsync inside the critical section of self.{locks} — "
                "this bounds fleet-wide throughput to ~1/fsync-latency; "
                "route the record through the journal's group-commit "
                "queue and wait for durability AFTER releasing the lock "
                "(EDL403; the journal committer and reviewed leaf-I/O "
                "teardowns carry explicit disables)"
            )

        yield from _scan_calls_under_locks(
            self, ctx, lambda node: _is_fsync_call(node, direct_names),
            message,
        )


# ------------------------------------------------------------------ #
# EDL404 span-sink-in-hot-loop


@register
class SpanSinkInHotLoopRule(Rule):
    id = "EDL404"
    name = "span-sink-in-hot-loop"
    doc = (
        "span/event emitted inside a per-step hot loop — trace emission "
        "is file I/O; per-step telemetry goes through the flight ring / "
        "step profiler, spans stay at task/rescale granularity"
    )

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        direct_names = _direct_emit_imports(ctx.tree)
        reported: Set[int] = set()   # a call nested in two loops fires once
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.For, ast.While)):
                continue
            body = list(node.body) + list(node.orelse)
            called: Set[str] = set()
            for stmt in body:
                called |= _called_attr_names(stmt)
            if not (called & _DISPATCH_METHODS):
                continue
            for stmt in body:
                for sub in ast.walk(stmt):
                    if (
                        isinstance(sub, ast.Call)
                        and _is_emit_call(sub, direct_names)
                        and id(sub) not in reported
                    ):
                        reported.add(id(sub))
                        kind = (
                            sub.func.attr
                            if isinstance(sub.func, ast.Attribute)
                            else sub.func.id
                        )
                        yield self.finding(
                            ctx, sub,
                            f"{kind} emission inside a per-step hot loop "
                            "— trace emission writes trace.jsonl; "
                            "per-step telemetry goes through the flight "
                            "ring / step profiler "
                            "(observability/flight.py, profile.py), "
                            "spans stay at task/rescale granularity "
                            "(EDL404)",
                        )


# ------------------------------------------------------------------ #
# EDL407 per-call-span-in-data-plane-hot-path


#: the fused pull/push data plane — every module a `pull_unique_multi`
#: traverses between the tier and the owner's store
_DATA_PLANE_HOT_MODULES = (
    "elasticdl_tpu_torch/embedding/data_plane.py",
    "elasticdl_tpu_torch/embedding/tier.py",
    "elasticdl_tpu_torch/embedding/shm.py",
    "elasticdl_tpu_torch/embedding/transport.py",
)

#: per-call function names inside those modules: the pull/push ladders,
#: the hedge race, retry rungs, wire-call shims (gRPC + shm ring), the
#: server-side serve path and the codec helpers. Case-insensitive so
#: the CamelCase gRPC servicer methods (EmbeddingPullMulti) match.
_HOT_FUNC_RE = re.compile(
    r"^_?(pull|push|serve|hedge|retry|call|shm|wire|codec|"
    r"encode|decode|embedding)",
    re.IGNORECASE,
)


def _in_data_plane_module(ctx: ModuleContext) -> bool:
    return any(ctx.rel_path.endswith(m) for m in _DATA_PLANE_HOT_MODULES)


@register
class PerCallSpanInDataPlaneHotPathRule(Rule):
    id = "EDL407"
    name = "per-call-span-in-data-plane-hot-path"
    doc = (
        "span/event emitted inside the fused pull/push data-plane hot "
        "path — per-call telemetry goes through the request-diary "
        "recorder (reqtrace.stage()/event(), tail-sampled); spans stay "
        "at phase/reshard granularity"
    )

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if not _in_data_plane_module(ctx):
            return
        direct_names = _direct_emit_imports(ctx.tree)
        reported: Set[int] = set()   # nested hot defs fire once
        for node in ast.walk(ctx.tree):
            if not isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef)
            ):
                continue
            if not _HOT_FUNC_RE.match(node.name):
                continue
            for sub in ast.walk(node):
                if (
                    isinstance(sub, ast.Call)
                    and _is_emit_call(sub, direct_names)
                    and id(sub) not in reported
                ):
                    reported.add(id(sub))
                    kind = (
                        sub.func.attr
                        if isinstance(sub.func, ast.Attribute)
                        else sub.func.id
                    )
                    yield self.finding(
                        ctx, sub,
                        f"{kind} emission inside the data plane's "
                        f"per-call hot path ({node.name}) — trace "
                        "emission writes trace.jsonl per fused call; "
                        "route per-call telemetry through the request-"
                        "diary recorder (observability/reqtrace.py: "
                        "stage()/event() land in the caller's diary, "
                        "tail-based sampling keeps only the slow/"
                        "errored/degraded ones), and keep spans at "
                        "phase/reshard granularity (EDL407)",
                    )


# ------------------------------------------------------------------ #
# EDL406 wall-clock-duration-measurement


def _direct_time_imports(tree: ast.AST) -> Set[str]:
    """Local names bound to time.time by `from time import time` (any
    alias)."""
    names: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == "time":
            for alias in node.names:
                if alias.name == "time":
                    names.add(alias.asname or alias.name)
    return names


def _is_wallclock_call(node: ast.AST, direct_names: Set[str]) -> bool:
    if not isinstance(node, ast.Call) or node.args or node.keywords:
        return False
    func = node.func
    if isinstance(func, ast.Name):
        return func.id in direct_names
    return (
        isinstance(func, ast.Attribute)
        and func.attr == "time"
        and isinstance(func.value, ast.Name)
        and func.value.id == "time"
    )


def _scope_bodies(tree: ast.AST):
    """One statement body per scope: the module body and every function
    body, each analyzed independently — a name tracked in one function
    says nothing about another's."""
    yield getattr(tree, "body", [])
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            yield node.body if not isinstance(node, ast.Lambda) \
                else [node.body]


def _walk_scope(body):
    """ast.walk over a scope body WITHOUT descending into nested
    function/lambda scopes (those get their own _scope_bodies entry)."""
    from collections import deque

    queue = deque(body)
    while queue:
        node = queue.popleft()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            # a nested scope: its body gets its own _scope_bodies entry
            continue
        queue.extend(ast.iter_child_nodes(node))


@register
class WallClockDurationRule(Rule):
    id = "EDL406"
    name = "wall-clock-duration-measurement"
    doc = (
        "time.time() delta used as a duration — NTP steps corrupt "
        "ledgers and histograms; use time.monotonic()/perf_counter() "
        "for durations (epoch arithmetic against stored stamps carries "
        "a reviewed disable)"
    )

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        direct_names = _direct_time_imports(ctx.tree)
        for body in _scope_bodies(ctx.tree):
            # pass 1: simple names assigned DIRECTLY from time.time() in
            # this scope (nested defs are separate scopes, not entered)
            tracked: Set[str] = set()
            for node in _walk_scope(body):
                if isinstance(node, ast.Assign) and _is_wallclock_call(
                    node.value, direct_names
                ):
                    for target in node.targets:
                        if isinstance(target, ast.Name):
                            tracked.add(target.id)

            def stampish(node: ast.AST) -> bool:
                return _is_wallclock_call(node, direct_names) or (
                    isinstance(node, ast.Name) and node.id in tracked
                )

            for node in _walk_scope(body):
                if (
                    isinstance(node, ast.BinOp)
                    and isinstance(node.op, ast.Sub)
                    and stampish(node.left)
                    and stampish(node.right)
                ):
                    yield self.finding(
                        ctx, node,
                        "wall-clock delta used as a duration — an "
                        "NTP step lands here as a phantom (or "
                        "negative) interval; measure durations with "
                        "time.monotonic()/perf_counter() (EDL406; "
                        "intended epoch arithmetic carries a "
                        "reviewed disable)",
                    )


# ------------------------------------------------------------------ #
# EDL405 unbounded-metric-label-cardinality


#: metric mutator attribute names whose keyword args are label values
_MUTATOR_ATTRS = {"inc", "set", "observe", "add"}

#: keyword args of the mutators that are NOT labels
_NON_LABEL_KWARGS = {"n", "value"}


def _metric_var_names(tree: ast.AST) -> Set[str]:
    """Names bound (anywhere) to a registry-factory call result:
    `X = reg.counter(...)` / `X = registry.gauge(...)` — the receivers
    whose mutator keywords are label values."""
    names: Set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        value = node.value
        if not isinstance(value, ast.Call):
            continue
        func = value.func
        attr = (
            func.attr if isinstance(func, ast.Attribute)
            else func.id if isinstance(func, ast.Name) else ""
        )
        if attr not in _FACTORIES:
            continue
        # only metric-shaped factory calls (same literal-name gate as
        # EDL401 — a collections.Counter(...) assignment stays out)
        name_node = _metric_name_arg(value)
        if name_node is None or not name_node.value.startswith("edl_"):
            continue
        for target in node.targets:
            if isinstance(target, ast.Name):
                names.add(target.id)
            elif isinstance(target, ast.Attribute):
                names.add(target.attr)
    return names


def _module_const_seqs(tree: ast.AST) -> Set[str]:
    """Module-level names bound to a literal tuple/list of constants —
    the recognizably-BOUNDED iterables (profile.py's PHASES)."""
    out: Set[str] = set()
    for node in getattr(tree, "body", []):
        if not isinstance(node, ast.Assign):
            continue
        v = node.value
        if isinstance(v, (ast.Tuple, ast.List)) and all(
            isinstance(e, ast.Constant) for e in v.elts
        ):
            for target in node.targets:
                if isinstance(target, ast.Name):
                    out.add(target.id)
    return out


def _is_bounded_iter(node: ast.AST, const_seqs: Set[str]) -> bool:
    """Iterables whose cardinality is statically knowable: a literal
    tuple/list (of anything), or a module-level constant sequence by
    name. range()/data-driven iterables are NOT bounded as far as the
    linter can see — a reviewer may know better (disable with
    justification)."""
    if isinstance(node, (ast.Tuple, ast.List)):
        return True
    if isinstance(node, ast.Name) and node.id in const_seqs:
        return True
    return False


def _target_names(target: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for sub in ast.walk(target):
        if isinstance(sub, ast.Name):
            out.add(sub.id)
    return out


class _LabelCardinalityVisitor(ast.NodeVisitor):
    """Walk one scope tracking loop-bound names from UNBOUNDED iterables;
    flag metric-mutator calls whose label keyword values mention one."""

    def __init__(self, rule: Rule, ctx: ModuleContext,
                 metric_names: Set[str], const_seqs: Set[str]):
        self.rule = rule
        self.ctx = ctx
        self.metric_names = metric_names
        self.const_seqs = const_seqs
        self.loop_vars: Set[str] = set()
        self.findings: List[Finding] = []

    def visit_For(self, node: ast.For) -> None:
        added: Set[str] = set()
        if not _is_bounded_iter(node.iter, self.const_seqs):
            added = _target_names(node.target) - self.loop_vars
            self.loop_vars |= added
        self.generic_visit(node)
        self.loop_vars -= added

    def _visit_comp(self, node) -> None:
        added: Set[str] = set()
        for gen in node.generators:
            if not _is_bounded_iter(gen.iter, self.const_seqs):
                added |= _target_names(gen.target) - self.loop_vars
        self.loop_vars |= added
        self.generic_visit(node)
        self.loop_vars -= added

    visit_ListComp = _visit_comp
    visit_SetComp = _visit_comp
    visit_GeneratorExp = _visit_comp
    visit_DictComp = _visit_comp

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if (
            self.loop_vars
            and isinstance(func, ast.Attribute)
            and func.attr in _MUTATOR_ATTRS
            and self._receiver_is_metric(func.value)
        ):
            for kw in node.keywords:
                if kw.arg is None or kw.arg in _NON_LABEL_KWARGS:
                    continue
                used = {
                    n.id for n in ast.walk(kw.value)
                    if isinstance(n, ast.Name)
                } & self.loop_vars
                if used:
                    self.findings.append(self.rule.finding(
                        self.ctx, node,
                        f"label {kw.arg!r} derives from loop "
                        f"variable(s) {sorted(used)} — per-iteration "
                        "label values grow the registry without bound; "
                        "label by a bounded dimension instead, or "
                        "disable with the bound's justification "
                        "(EDL405)",
                    ))
                    break
        self.generic_visit(node)

    def _receiver_is_metric(self, base: ast.AST) -> bool:
        if isinstance(base, ast.Name):
            return base.id in self.metric_names
        if isinstance(base, ast.Attribute):
            return base.attr in self.metric_names
        return False


@register
class UnboundedMetricLabelCardinalityRule(Rule):
    id = "EDL405"
    name = "unbounded-metric-label-cardinality"
    doc = (
        "metric label value derived from a loop variable over an "
        "unbounded iterable — per-id/per-task labels explode the "
        "registry; label by bounded dimensions"
    )

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        metric_names = _metric_var_names(ctx.tree)
        if not metric_names:
            return
        const_seqs = _module_const_seqs(ctx.tree)
        visitor = _LabelCardinalityVisitor(
            self, ctx, metric_names, const_seqs)
        visitor.visit(ctx.tree)
        yield from visitor.findings
