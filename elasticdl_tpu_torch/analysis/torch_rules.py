"""EDL2xx: PyTorch performance/correctness hazards.

The twins of the JAX package's `analysis/jax_rules.py`, with its rule
ids and slugs, so a `# edl-lint: disable=EDL201` (or `=jit-cache-churn`)
means the same thing in both trees. The port runs eagerly on the card: a
host sync drains the CUDA stream, a data-dependent shape is a host sync
wherever it runs and cannot be captured into a CUDA graph, and a
`torch.compile` / `torch.jit` / CUDA-graph capture built per call
re-traces or re-captures every time.

EDL201 host-sync-in-hot-loop
    `float()/int()/bool()/.item()/.tolist()/.cpu()/.numpy()/np.asarray()/
    np.array()/torch.cuda.synchronize()/.nonzero()/torch.nonzero()/
    torch.unique()` lexically inside a loop that dispatches device work
    (a call to one of the Trainer step/many entry points). These wait for
    the card's queue to drain each iteration. Besides, `torch.nonzero`
    and `torch.unique` fire ANYWHERE: their output shape depends on the
    data, so the host waits for the card on every call, in the model's
    forward as much as in the loop, and a CUDA graph cannot capture them.
    (In JAX such a call does not trace at all under jit without a static
    size, which is why the reference's rule needs no such clause.) Some
    syncs are the point (loss read-back that times the step, mask-based
    record accounting) — those carry `# edl-lint: disable=EDL201` with
    their justification.

EDL202 jit-cache-churn
    a compile or capture built inside a loop, or built and called at
    once: `torch.compile(...)`, `torch.jit.script(...)`,
    `torch.jit.trace(...)`, `torch.cuda.make_graphed_callables(...)`,
    `torch.cuda.CUDAGraph()`, `torch.cuda.graph(...)`, and the port's
    kernel build `native.build(...)` (ops/native.py). Each builds a
    fresh compiled callable, graph or library every time: dynamo's cache
    keys on the new function object and re-traces, a new CUDA graph
    re-captures the stream, a build re-hashes its source. Build once and
    keep it (module/instance attribute, or `ops/native.load`, which
    caches the loaded library).

EDL203 tracer-leak
    assignment to `self.*` (or a nonlocal/global) inside a function that
    is compiled or captured: decorated with `torch.compile` /
    `torch.jit.script`, or passed to `torch.compile`, `torch.jit.script`,
    `torch.jit.trace` or `torch.cuda.make_graphed_callables` in the same
    module. Eager PyTorch has no tracer to leak; what fills the hazard's
    place is a tensor escaping its graph: a captured function's tensors
    live in the CUDA graph's private pool, so one stored in long-lived
    state is overwritten by the next replay, and `torch.compile` replays
    the mutation outside its graph and guards (and recompiles) on it.
    Return the value instead.

EDL204 unordered-iteration
    iteration over a `set` (literal, comprehension, or `set(...)` call)
    in a `for`/comprehension. Set order varies across processes
    (PYTHONHASHSEED), so any pytree/spec built from it can differ
    between cohort members. Sort first.

EDL205 unkeyed-jit-in-rescale-path
    a compile or capture of EDL202's list called inside a
    reform/rescale/resize/handoff code path without going through the
    program cache (training/compile_cache.py get_or_build/store_aot;
    the cache's own module is the sanctioned construction site). The
    rescale fast path exists to make recovery compile-free; a fresh
    compile or capture built during recovery pays the full re-trace the
    cache was built to avoid. Route it through the cache (the builder
    lambda handed to `get_or_build` is exempt).

EDL206 per-row-embedding-rpc-in-hot-loop
    an embedding-tier `.pull(...)`/`.push(...)` call issued PER ID —
    lexically inside a nested loop (or comprehension) within a
    step-dispatch hot loop (EDL201's definition). The tier client
    dedupes the whole batch and issues ONE batched call per shard; a
    per-row call re-creates the reference's per-key PS traffic, paying a
    transport round trip per id instead of per shard. Receivers are
    matched by name (tier/client/emb/transport/store) so unrelated
    `.push` methods stay quiet; one batched call directly in the
    dispatch loop body is the sanctioned shape.

EDL207 blocking-pull-with-pipeline-available
    a blocking tier `.pull(...)`/`.pull_unique(...)` DIRECTLY in the
    step-dispatch hot loop (EDL201/EDL206's hot-loop definition) while
    a pull pipeline is available in the enclosing scope — a parameter
    or binding named `*pipeline(s)`, or anything constructed from a
    `*PullPipeline(...)` ctor. Route it through `pipeline.submit()`
    ahead / `pipeline.get()` in the loop. `.push` stays exempt — writes
    are the step's own output and cannot be issued ahead.

EDL209 uncoalesced-per-table-pull
    a tier `.pull(...)`/`.pull_unique(...)` issued once PER TABLE — an
    inner loop within a step-dispatch hot loop whose body passes the
    loop variable into the tier call. `pull_unique_multi({table: ids,
    ...})` fuses every table's misses into ONE wire call per owner.

EDL204, EDL206, EDL207 and EDL209 do not depend on the framework: their
code below is the reference's, from `_TIER_RECEIVER` on.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator, List, Optional, Set

from elasticdl_tpu_torch.analysis.core import (
    Finding, ModuleContext, Rule, register,
)

#: calls that dispatch device work — a loop containing one is a hot loop
_DISPATCH_METHODS = {
    "train_step", "train_many", "eval_step", "eval_many",
    "predict_step", "predict_many", "apply_gradients",
}

#: builtin conversions that force a host sync when fed a device value
_SYNC_BUILTINS = {"float", "int", "bool"}

#: tensor methods that copy device data to the host (a sync)
_SYNC_METHODS = {"tolist", "cpu", "numpy"}

#: torch functions whose output shape depends on the data: a host sync
#: wherever they run, and never capturable into a CUDA graph
_DATA_DEPENDENT_SHAPE = {"nonzero", "unique", "unique_consecutive"}


def _dotted(node: ast.AST) -> str:
    """'torch.cuda.graph' for that attribute chain ('' if it does not end
    in a plain name)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return ""
    parts.append(node.id)
    return ".".join(reversed(parts))


#: compile/capture builders that take the function (or module) they
#: compile first and return a callable, so calling the result at once
#: discards it; and those that build a graph or a library
_CALLABLE_BUILDERS = {
    "torch.compile", "torch.jit.script", "torch.jit.trace",
    "torch.jit.trace_module", "torch.cuda.make_graphed_callables",
    "jit.script", "jit.trace",
}
_CAPTURES = {"torch.cuda.CUDAGraph", "torch.cuda.graph", "native.build"}


def _is_torch_capture(func: ast.AST) -> bool:
    """A compile, script, trace, CUDA-graph capture or native build."""
    if isinstance(func, ast.Call):
        # functools.partial(torch.compile, ...)
        f = func.func
        partial = (
            isinstance(f, ast.Name) and f.id == "partial"
        ) or (isinstance(f, ast.Attribute) and f.attr == "partial")
        return bool(partial and func.args and _is_torch_capture(func.args[0]))
    name = _dotted(func)
    return name in _CALLABLE_BUILDERS or name in _CAPTURES


def _capture_name(func: ast.AST) -> str:
    return _dotted(func) or "partial(...)"


def _called_attr_names(node: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute):
            out.add(sub.func.attr)
    return out


def _shape_sync(func: ast.AST) -> str:
    """'torch.nonzero' for a module-qualified data-dependent-shape call."""
    name = _dotted(func)
    head, _, attr = name.rpartition(".")
    if head == "torch" and attr in _DATA_DEPENDENT_SHAPE:
        return name
    return ""


@register
class HostSyncInHotLoopRule(Rule):
    """A host sync in a loop that dispatches device steps: float(),
    int(), bool(), .item(), .tolist(), .cpu(), .numpy(), np.asarray(),
    np.array(), torch.cuda.synchronize(), .nonzero(). Each waits for the
    card's queue to drain every iteration. torch.nonzero, torch.unique
    and torch.unique_consecutive fire anywhere: their output shape
    depends on the data, so the host waits on every call, and a CUDA
    graph cannot capture them. Deliberate syncs (the loss read-back that
    times a step, record accounting) carry `# edl-lint: disable=EDL201`
    with their reason."""

    id = "EDL201"
    name = "host-sync-in-hot-loop"
    doc = (
        "host-device sync (float/int/bool/.item/.tolist/.cpu/.numpy/"
        "np.asarray/cuda.synchronize) inside a loop that dispatches device "
        "steps, or a data-dependent shape (torch.nonzero/unique) anywhere"
    )

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        reported: Set[int] = set()   # a call nested in two loops fires once
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.For, ast.While)):
                continue
            body = list(node.body) + list(node.orelse)
            called = set()
            for stmt in body:
                called |= _called_attr_names(stmt)
            if not (called & _DISPATCH_METHODS):
                continue
            for stmt in body:
                yield from self._scan(ctx, stmt, reported)
        for node in ast.walk(ctx.tree):
            if (isinstance(node, ast.Call) and id(node) not in reported
                    and _shape_sync(node.func)):
                reported.add(id(node))
                yield self.finding(
                    ctx, node,
                    f"{_shape_sync(node.func)}() has a data-dependent "
                    "shape: the host waits for the device on every call "
                    "and no CUDA graph can capture it; use a fixed-shape "
                    "form (a mask, a padded index) or hoist",
                )

    def _scan(
        self, ctx: ModuleContext, node: ast.AST, reported: Set[int]
    ) -> Iterator[Finding]:
        for sub in ast.walk(node):
            if id(sub) in reported:
                continue
            reported.add(id(sub))
            if not isinstance(sub, ast.Call):
                continue
            func = sub.func
            if (
                isinstance(func, ast.Name)
                and func.id in _SYNC_BUILTINS
                and sub.args
                and not isinstance(sub.args[0], ast.Constant)
            ):
                yield self.finding(
                    ctx, sub,
                    f"{func.id}() in a dispatch loop forces a host sync "
                    "per iteration; accumulate on device or hoist",
                )
            elif _shape_sync(func) or (isinstance(func, ast.Attribute)
                                       and func.attr == "nonzero"):
                what = _shape_sync(func) or ".nonzero"
                yield self.finding(
                    ctx, sub,
                    f"{what}() in a dispatch loop has a data-dependent "
                    "shape: a host sync per iteration; use a fixed-shape "
                    "form or hoist",
                )
            elif isinstance(func, ast.Attribute) and func.attr == "item":
                yield self.finding(
                    ctx, sub,
                    ".item() in a dispatch loop forces a host sync per "
                    "iteration; accumulate on device or hoist",
                )
            elif isinstance(func, ast.Attribute) and func.attr in (
                "asarray", "array",
            ) and isinstance(func.value, ast.Name) and func.value.id in (
                "np", "numpy",
            ):
                yield self.finding(
                    ctx, sub,
                    f"np.{func.attr}() in a dispatch loop copies device "
                    "data to host per iteration; accumulate on device or hoist",
                )
            elif _dotted(func) in ("torch.cuda.synchronize",
                                   "cuda.synchronize"):
                yield self.finding(
                    ctx, sub,
                    "torch.cuda.synchronize() in a dispatch loop drains "
                    "the device queue per iteration; time with CUDA "
                    "events or hoist",
                )
            elif isinstance(func, ast.Attribute) and func.attr in \
                    _SYNC_METHODS:
                yield self.finding(
                    ctx, sub,
                    f".{func.attr}() in a dispatch loop copies device data "
                    "to the host per iteration; accumulate on device or "
                    "hoist",
                )


@register
class JitCacheChurnRule(Rule):
    """A compile or capture made inside a loop, or made and called at
    once: torch.compile, torch.jit.script / trace, torch.cuda.
    make_graphed_callables, torch.cuda.CUDAGraph(), torch.cuda.graph(),
    and the kernel build `native.build`. Each call builds a fresh
    compiled callable, graph or library, so dynamo re-traces (its cache
    keys on the new function object), a CUDA graph re-captures, a build
    re-hashes its sources. Build once and keep it on the module or the
    instance (`native.load` caches the loaded library)."""

    id = "EDL202"
    name = "jit-cache-churn"
    doc = (
        "torch.compile / torch.jit / CUDA-graph capture / native build made "
        "per call (inside a loop, or immediately invoked) — re-traces or "
        "re-captures every execution; build once and keep it"
    )

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        loops = [
            n for n in ast.walk(ctx.tree) if isinstance(n, (ast.For, ast.While))
        ]
        seen: Set[int] = set()
        for loop in loops:
            for sub in ast.walk(loop):
                if (
                    isinstance(sub, ast.Call)
                    and _is_torch_capture(sub.func)
                    and id(sub) not in seen
                ):
                    seen.add(id(sub))
                    yield self.finding(
                        ctx, sub,
                        f"{_capture_name(sub.func)} inside a loop builds a "
                        "fresh compile or capture per iteration (a re-trace "
                        "every time); hoist and keep it",
                    )
        for sub in ast.walk(ctx.tree):
            # torch.compile(f)(args): the compiled callable dies after one
            # call
            if (
                isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Call)
                and _is_torch_capture(sub.func.func)
                and id(sub.func) not in seen
            ):
                yield self.finding(
                    ctx, sub,
                    f"{_capture_name(sub.func.func)}(...)(...) immediate "
                    "call discards the compiled callable — every execution "
                    "re-traces; keep it on the module/instance",
                )


#: decorators that compile the function they wrap
_COMPILING_DECORATORS = {"torch.compile", "torch.jit.script", "jit.script"}


def _compiles(node: ast.AST) -> bool:
    """A decorator `@torch.compile`, `@torch.compile(...)`,
    `@torch.jit.script`."""
    if isinstance(node, ast.Call):
        node = node.func
    return _dotted(node) in _COMPILING_DECORATORS


@register
class TracerLeakRule(Rule):
    """Assignment to self.* or to a nonlocal/global inside a compiled or
    captured function (decorated with torch.compile / torch.jit.script,
    or passed to torch.compile, torch.jit.script / trace or torch.cuda.
    make_graphed_callables in the same module). Eager PyTorch has no
    tracer to leak; its counterpart is a tensor escaping its graph: a
    captured function's tensors live in the CUDA graph's private pool,
    so one kept in long-lived state is overwritten by the next replay,
    and torch.compile replays the mutation outside its graph and guards
    (and recompiles) on it. Return the value instead."""

    id = "EDL203"
    name = "tracer-leak"
    doc = (
        "assignment to self.*/nonlocal/global inside a compiled or "
        "captured function — stores a graph's tensor into long-lived state"
    )

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for fn in self._compiled_functions(ctx):
            yield from self._scan_body(ctx, fn)

    def _compiled_functions(self, ctx: ModuleContext) -> List[ast.AST]:
        out: List[ast.AST] = []
        by_name = {}
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                by_name.setdefault(node.name, node)
                if any(_compiles(d) for d in node.decorator_list):
                    out.append(node)
        for node in ast.walk(ctx.tree):
            if (isinstance(node, ast.Call) and node.args
                    and _dotted(node.func) in _CALLABLE_BUILDERS):
                arg = node.args[0]
                if isinstance(arg, ast.Lambda):
                    out.append(arg)
                elif isinstance(arg, ast.Name) and arg.id in by_name:
                    out.append(by_name[arg.id])
        return out

    def _scan_body(self, ctx: ModuleContext, fn: ast.AST) -> Iterator[Finding]:
        body = getattr(fn, "body", None)
        if not isinstance(body, list):
            return  # Lambda: a single expression can hold no assignments
        declared: Set[str] = set()
        for node in body:
            for sub in ast.walk(node):
                if isinstance(sub, (ast.Nonlocal, ast.Global)):
                    declared |= set(sub.names)
        for node in body:
            for sub in ast.walk(node):
                if isinstance(sub, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                    targets = (
                        sub.targets if isinstance(sub, ast.Assign) else [sub.target]
                    )
                    for t in targets:
                        if (
                            isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"
                        ):
                            yield self.finding(
                                ctx, sub,
                                f"assignment to self.{t.attr} inside a "
                                "compiled or captured function stores a "
                                "graph's tensor into long-lived state (a "
                                "replay overwrites it); return it instead",
                            )
                        elif isinstance(t, ast.Name) and t.id in declared:
                            yield self.finding(
                                ctx, sub,
                                f"assignment to nonlocal/global {t.id!r} "
                                "inside a compiled or captured function "
                                "lets a graph's tensor escape; return it "
                                "instead",
                            )


#: function names that ARE the rescale/recovery path — a compile here is
#: paid at the worst possible time (mid-recovery), so it must be cache-keyed
_RESCALE_PATH = re.compile(r"reform|rescale|resize|handoff", re.IGNORECASE)

#: program-cache entry points whose builder arguments legitimately
#: construct the program being cached
_CACHE_BUILDERS = {"get_or_build", "store_aot", "cached_jit"}

#: the program cache's own module builds what it caches
_CACHE_MODULE = "training/compile_cache.py"


@register
class UnkeyedJitInRescalePathRule(Rule):
    """A compile or capture of EDL202's list made inside a reform,
    rescale, resize or handoff function, outside the program cache
    (`compile_cache.get_or_build` / `store_aot` builder arguments, and
    training/compile_cache.py itself). Recovery is where a re-trace or a
    re-capture costs most; route it through the cache."""

    id = "EDL205"
    name = "unkeyed-jit-in-rescale-path"
    doc = (
        "torch.compile / torch.jit / CUDA-graph capture / native build "
        "inside a reform/rescale/resize/handoff code path without the "
        "program cache — recovery pays a fresh re-trace the rescale fast "
        "path exists to avoid"
    )

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if ctx.rel_path.endswith(_CACHE_MODULE):
            return
        reported: Set[int] = set()
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if not _RESCALE_PATH.search(node.name):
                continue
            # anything under a cache entry point (the builder closure handed
            # to get_or_build/store_aot) is the sanctioned construction site
            exempt: Set[int] = set()
            for sub in ast.walk(node):
                if (
                    isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and sub.func.attr in _CACHE_BUILDERS
                ):
                    for inner in ast.walk(sub):
                        exempt.add(id(inner))
            for sub in ast.walk(node):
                if (
                    isinstance(sub, ast.Call)
                    and _is_torch_capture(sub.func)
                    and id(sub) not in exempt
                    and id(sub) not in reported
                ):
                    reported.add(id(sub))
                    yield self.finding(
                        ctx, sub,
                        f"{_capture_name(sub.func)} inside rescale-path "
                        f"function {node.name!r} defeats the program cache "
                        "— recovery re-traces; route it through "
                        "compile_cache.get_or_build",
                    )


#: receiver names that mark a call as embedding-TIER traffic (the rule
#: must not fire on unrelated `.push` methods — a stack's push, say)
_TIER_RECEIVER = re.compile(r"tier|client|emb|transport|store", re.IGNORECASE)


def _tier_call(node: ast.AST) -> Optional[str]:
    """'pull'/'pull_unique'/'push' when `node` is an embedding-tier
    data-plane call."""
    if not (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in ("pull", "pull_unique", "push")):
        return None
    recv = node.func.value
    names = []
    while isinstance(recv, ast.Attribute):
        names.append(recv.attr)
        recv = recv.value
    if isinstance(recv, ast.Name):
        names.append(recv.id)
    if any(_TIER_RECEIVER.search(n) for n in names):
        return node.func.attr
    return None


@register
class PerRowEmbeddingRpcRule(Rule):
    id = "EDL206"
    name = "per-row-embedding-rpc-in-hot-loop"
    doc = (
        "embedding-tier pull/push issued per id (nested loop or "
        "comprehension) inside a step-dispatch hot loop — a transport "
        "round trip per row; dedupe the batch and issue one call per shard"
    )

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        reported: Set[int] = set()
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.For, ast.While)):
                continue
            body = list(node.body) + list(node.orelse)
            called = set()
            for stmt in body:
                called |= _called_attr_names(stmt)
            if not (called & _DISPATCH_METHODS):
                # shares EDL201's hot-loop definition: only loops that
                # dispatch device steps are in scope
                continue
            if any(
                isinstance(n, (ast.For, ast.While))
                and _called_attr_names(n) & _DISPATCH_METHODS
                for stmt in body for n in ast.walk(stmt)
            ):
                # an INNER loop is the real dispatch loop (epoch loop
                # around a step loop): scan at that depth, or a batched
                # call in the step loop's own body would read as
                # "nested" relative to the epoch loop
                continue
            for stmt in body:
                yield from self._scan(ctx, stmt, reported)

    def _scan(
        self, ctx: ModuleContext, node: ast.AST, reported: Set[int]
    ) -> Iterator[Finding]:
        """Flag tier calls nested one loop (or comprehension) deeper than
        the dispatch loop's own body — the per-id shape. A tier call
        sitting directly in the dispatch body is the batched idiom."""
        for sub in ast.walk(node):
            inner: Iterator[ast.AST] = ()
            if isinstance(sub, (ast.For, ast.While)):
                inner = (n for s in (list(sub.body) + list(sub.orelse))
                         for n in ast.walk(s))
            elif isinstance(sub, (ast.ListComp, ast.SetComp, ast.DictComp,
                                  ast.GeneratorExp)):
                inner = ast.walk(sub)
            for cand in inner:
                what = _tier_call(cand)
                if what is None or id(cand) in reported:
                    continue
                reported.add(id(cand))
                yield self.finding(
                    ctx, cand,
                    f"embedding tier .{what}() per id inside the "
                    "step-dispatch hot loop pays a transport round trip "
                    "per row; dedupe the batch and issue one batched "
                    "call per shard (tier.EmbeddingTierClient does this)",
                )


#: a binding that makes the pull pipeline "available in scope":
#: parameters/assignments named like the thing, or anything constructed
#: from a *PullPipeline(...) ctor
_PIPELINE_NAME = re.compile(r"(^|_)pipelines?$", re.IGNORECASE)
_PIPELINE_CTOR = re.compile(r"PullPipeline")


def _scope_nodes(scope: ast.AST) -> Iterator[ast.AST]:
    """Walk one lexical scope: never descends into nested function
    defs (they are their own scopes — a pipeline bound in a helper must
    not police its caller)."""
    stack = [scope]
    while stack:
        node = stack.pop()
        if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                and node is not scope):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _pipeline_in_scope(scope: ast.AST) -> bool:
    if isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
        a = scope.args
        params = (list(getattr(a, "posonlyargs", ())) + list(a.args)
                  + list(a.kwonlyargs))
        if a.vararg:
            params.append(a.vararg)
        if a.kwarg:
            params.append(a.kwarg)
        if any(_PIPELINE_NAME.search(p.arg) for p in params):
            return True
    for sub in _scope_nodes(scope):
        if isinstance(sub, ast.Assign):
            v = sub.value
            if isinstance(v, ast.Call):
                f = v.func
                name = (f.attr if isinstance(f, ast.Attribute)
                        else f.id if isinstance(f, ast.Name) else "")
                if _PIPELINE_CTOR.search(name):
                    return True
            for t in sub.targets:
                if isinstance(t, ast.Name) and _PIPELINE_NAME.search(t.id):
                    return True
    return False


def _direct_body_calls(stmts) -> Iterator[ast.Call]:
    """Calls at the loop's OWN depth: nested loops/comprehensions are
    EDL206's territory, nested defs their own scope."""
    stack = list(stmts)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.For, ast.While, ast.ListComp,
                             ast.SetComp, ast.DictComp, ast.GeneratorExp,
                             ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if isinstance(node, ast.Call):
            yield node
        stack.extend(ast.iter_child_nodes(node))


@register
class BlockingPullWithPipelineRule(Rule):
    id = "EDL207"
    name = "blocking-pull-with-pipeline-available"
    doc = (
        "blocking tier .pull/.pull_unique in the step-dispatch hot loop "
        "while a pull pipeline is in scope — the owner RPC serializes "
        "behind compute it could overlap; route it through "
        "pipeline.submit()/get()"
    )

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        scopes = [ctx.tree] + [
            n for n in ast.walk(ctx.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        reported: Set[int] = set()
        for scope in scopes:
            if not _pipeline_in_scope(scope):
                continue
            for node in _scope_nodes(scope):
                if not isinstance(node, (ast.For, ast.While)):
                    continue
                loop_body = list(node.body) + list(node.orelse)
                called = set()
                for stmt in loop_body:
                    called |= _called_attr_names(stmt)
                if not (called & _DISPATCH_METHODS):
                    # shares EDL201/EDL206's hot-loop definition
                    continue
                if any(
                    isinstance(n, (ast.For, ast.While))
                    and _called_attr_names(n) & _DISPATCH_METHODS
                    for stmt in loop_body for n in ast.walk(stmt)
                ):
                    # an INNER loop is the real dispatch loop (epoch
                    # wrapper): scan at that depth (EDL206's scoping)
                    continue
                for cand in _direct_body_calls(loop_body):
                    what = _tier_call(cand)
                    if what in (None, "push") or id(cand) in reported:
                        # pushes are the step's own OUTPUT — they cannot
                        # be issued ahead of the compute that makes them
                        continue
                    reported.add(id(cand))
                    yield self.finding(
                        ctx, cand,
                        f"blocking tier .{what}() in the step-dispatch "
                        "hot loop while a pull pipeline is in scope: the "
                        "owner RPC serializes behind compute it could "
                        "overlap — submit() the next batch ahead and "
                        "get() here (EmbeddingPullPipeline)",
                    )


def _target_names(target: ast.AST) -> Set[str]:
    """Names bound by a For target (`for t in ...`, `for t, ids in ...`)."""
    names: Set[str] = set()
    for n in ast.walk(target):
        if isinstance(n, ast.Name):
            names.add(n.id)
    return names


@register
class UncoalescedPerTablePullRule(Rule):
    id = "EDL209"
    name = "uncoalesced-per-table-pull"
    doc = (
        "tier .pull/.pull_unique issued once per table (inner loop over "
        "table names inside a step-dispatch hot loop) — one owner round "
        "trip per table; pull_unique_multi fuses every table into one "
        "wire call per owner"
    )

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        reported: Set[int] = set()
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.For, ast.While)):
                continue
            body = list(node.body) + list(node.orelse)
            called = set()
            for stmt in body:
                called |= _called_attr_names(stmt)
            if not (called & _DISPATCH_METHODS):
                # shares EDL201/EDL206's hot-loop definition
                continue
            if any(
                isinstance(n, (ast.For, ast.While))
                and _called_attr_names(n) & _DISPATCH_METHODS
                for stmt in body for n in ast.walk(stmt)
            ):
                # an INNER loop is the real dispatch loop (epoch wrapper)
                continue
            for stmt in body:
                for sub in ast.walk(stmt):
                    if not isinstance(sub, ast.For):
                        continue
                    loop_vars = _target_names(sub.target)
                    if not loop_vars:
                        continue
                    yield from self._scan(ctx, sub, loop_vars, reported)

    def _scan(
        self, ctx: ModuleContext, loop: ast.For, loop_vars: Set[str],
        reported: Set[int],
    ) -> Iterator[Finding]:
        """Flag pull/pull_unique in the inner loop's DIRECT body that
        receive the loop variable — the per-table shape. (Deeper
        nesting re-enters check() via the outer walk; pushes are the
        step's own output and are EDL206's concern.)"""
        for cand in _direct_body_calls(list(loop.body)
                                       + list(loop.orelse)):
            what = _tier_call(cand)
            if what in (None, "push") or id(cand) in reported:
                continue
            args = list(cand.args) + [kw.value for kw in cand.keywords]
            if not any(
                isinstance(n, ast.Name) and n.id in loop_vars
                for a in args for n in ast.walk(a)
            ):
                continue
            reported.add(id(cand))
            yield self.finding(
                ctx, cand,
                f"tier .{what}() once per table in the step-dispatch "
                "hot loop pays one owner round trip per table; fuse "
                "the batch into pull_unique_multi({table: ids, ...}) — "
                "one EmbeddingPullMulti wire call per owner, with the "
                "owner's watermarks piggybacked",
            )


def _is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Name) and f.id in ("set", "frozenset"):
            return True
    return False


@register
class UnorderedIterationRule(Rule):
    id = "EDL204"
    name = "unordered-iteration"
    doc = (
        "iterating a set: order varies across processes (hash seed), so "
        "pytrees/specs built from it differ between cohort members"
    )

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            iters: List[ast.AST] = []
            if isinstance(node, ast.For):
                iters.append(node.iter)
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                                   ast.GeneratorExp)):
                iters.extend(gen.iter for gen in node.generators)
            for it in iters:
                if _is_set_expr(it):
                    yield self.finding(
                        ctx, it,
                        "iteration over a set has process-dependent order; "
                        "wrap in sorted() before building pytrees or specs",
                    )
