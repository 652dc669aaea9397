"""EDL3xx: RPC / control-plane hygiene.

PR 1 hardened the wire layer (RetryingMasterStub: deadlines, idempotent-
only retries, circuit breaker). These rules keep callers from quietly
eroding that hardening:

EDL301 bare-master-stub
    `MasterStub(...)` constructed outside proto/service.py: every
    production caller must go through RetryingMasterStub, or it loses
    deadlines, the breaker, and the fault-injection sites.

EDL302 rpc-missing-deadline
    a known Master-RPC method invoked without `timeout=`, when the
    receiver was locally bound to a bare `MasterStub(...)` (tracked by
    assignment within the module). RetryingMasterStub carries per-RPC
    policy deadlines, so its callers may omit timeout; a bare stub call
    without one blocks forever on a half-dead master.

EDL303 silent-exception-swallow
    a broad handler (bare `except`, `Exception`, `BaseException`) whose
    body neither logs nor raises nor does anything else (only
    pass/.../continue/return-constant). A narrowed handler
    (`except OSError: pass`) is a reviewed decision and is not flagged.

EDL304 sleep-retry-no-jitter
    constant-argument `time.sleep` inside a loop that also catches
    exceptions (the retry shape). Synchronized constant backoff is how a
    relaunched fleet produces a thundering herd against a recovering
    master; use the stub's jittered backoff or randomize the sleep.

EDL305 non-atomic-state-file-write
    `open(..., "w")` onto a `*.json`/`*.jsonl` state file in a scope that
    never calls `os.replace`/`os.rename`. A crash mid-write leaves a torn
    file the next reader chokes on; the required idiom is write-to-a-
    `.tmp`-sibling + fsync + `os.replace` (the journal and
    membership_signal writers are the reference implementations —
    master/journal.py `_rotate_locked`, common/membership_signal.py
    `write_signal`). Opening the `.tmp` sibling itself, append-mode
    handles (a WAL's appends are torn-tail-tolerant by design), and
    scopes that do replace/rename are all quiet.

EDL208 rpc-call-without-deadline
    an embedding DATA-PLANE stub call (the EmbeddingPull/Push/
    FetchShard/FetchDelta/Watermark RPC surface, or any method on a
    local bound to a bare `DataPlaneStub(...)`) without a `timeout=`
    argument. The data plane is the partition-critical path (ISSUE 15):
    a deadline-less call against a blackholed owner blocks its worker
    thread for the channel's whole connect saga, exactly the failure
    the deadline-budget machinery exists to bound. The reference
    fixture is embedding/data_plane.py's GrpcTransport, which threads
    every call's budget down as the gRPC deadline; production callers
    go through it (or ResilientTransport), never a bare stub. Numbered
    in the EDL2xx embedding family (EDL206/EDL207's sibling) despite
    living here with its RPC-hygiene kin. Lint targets are the package
    tree — tests (outside it) may hold deadline-less calls to probe
    the failure mode itself.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Set

from elasticdl_tpu_torch.analysis.core import Finding, ModuleContext, Rule, register

#: the Master service RPC surface (proto/service.py _RPCS)
RPC_METHODS = {
    "RegisterWorker", "GetTask", "ReportTaskResult",
    "ReportEvaluationMetrics", "Heartbeat", "GetJobStatus",
}

#: modules allowed to construct the bare stub (the wrapper itself)
_BARE_STUB_ALLOWED = ("proto/service.py",)

_LOG_NAMES = {"logger", "logging", "log", "warnings", "print"}


def _is_call_to(node: ast.AST, name: str) -> bool:
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Name) and f.id == name:
            return True
        if isinstance(f, ast.Attribute) and f.attr == name:
            return True
    return False


@register
class BareMasterStubRule(Rule):
    id = "EDL301"
    name = "bare-master-stub"
    doc = (
        "MasterStub constructed outside proto/service.py — use "
        "RetryingMasterStub (deadlines, retries, breaker, fault sites)"
    )

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if ctx.rel_path.endswith(_BARE_STUB_ALLOWED):
            return
        for node in ast.walk(ctx.tree):
            if _is_call_to(node, "MasterStub"):
                yield self.finding(
                    ctx, node,
                    "bare MasterStub bypasses RetryingMasterStub "
                    "(no deadline policy, no retries, no circuit breaker)",
                )


@register
class RpcMissingDeadlineRule(Rule):
    id = "EDL302"
    name = "rpc-missing-deadline"
    doc = (
        "Master RPC on a bare MasterStub without timeout= — blocks "
        "forever against a half-dead master"
    )

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        bare = self._bare_stub_names(ctx)
        for node in ast.walk(ctx.tree):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in RPC_METHODS
            ):
                continue
            recv = node.func.value
            is_bare = (
                isinstance(recv, ast.Name) and recv.id in bare
            ) or _is_call_to(recv, "MasterStub")
            if not is_bare:
                continue
            if not any(kw.arg == "timeout" for kw in node.keywords):
                yield self.finding(
                    ctx, node,
                    f"{node.func.attr} on a bare MasterStub without "
                    "timeout= has no deadline at all",
                )

    def _bare_stub_names(self, ctx: ModuleContext) -> Set[str]:
        names: Set[str] = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Assign) and _is_call_to(
                node.value, "MasterStub"
            ):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        names.add(t.id)
        return names


#: the embedding data-plane RPC surface (embedding/data_plane.py
#: _DATA_RPCS) — names unique enough that ANY call spelling is a stub
#: call (the servicer's same-named methods are definitions, not calls)
DATA_PLANE_RPCS = {
    "EmbeddingPull", "EmbeddingPush", "EmbeddingFetchShard",
    "EmbeddingFetchDelta", "EmbeddingWatermark",
    # wire-speed lane (ISSUE 18): fused pulls, shm negotiation, and the
    # streaming fetch variants are data-plane calls like any other —
    # a deadline-less call still wedges on a partitioned owner
    "EmbeddingPullMulti", "EmbeddingWatermarkMulti",
    "EmbeddingShmNegotiate", "EmbeddingFetchShardStream",
    "EmbeddingFetchDeltaStream",
}


@register
class DataPlaneCallWithoutDeadlineRule(Rule):
    id = "EDL208"
    name = "rpc-call-without-deadline"
    doc = (
        "embedding data-plane stub call without timeout= — blocks a "
        "worker thread for the whole connect saga against a "
        "partitioned owner; route through GrpcTransport/"
        "ResilientTransport (deadline budgets) or pass timeout="
    )

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        bare = self._bare_stub_names(ctx)
        for node in ast.walk(ctx.tree):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
            ):
                continue
            method = node.func.attr
            recv = node.func.value
            is_data_call = method in DATA_PLANE_RPCS or (
                isinstance(recv, ast.Name) and recv.id in bare
            ) or _is_call_to(recv, "DataPlaneStub")
            if not is_data_call:
                continue
            if any(kw.arg == "timeout" for kw in node.keywords):
                continue
            yield self.finding(
                ctx, node,
                f"data-plane call {method} without timeout= has no "
                "deadline — it will block for the channel's whole "
                "connect saga against a partitioned owner",
            )

    def _bare_stub_names(self, ctx: ModuleContext) -> Set[str]:
        names: Set[str] = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Assign) and _is_call_to(
                node.value, "DataPlaneStub"
            ):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        names.add(t.id)
        return names


def _body_is_silent(body: List[ast.stmt]) -> bool:
    """True when the handler body visibly does nothing with the error."""
    for stmt in body:
        if isinstance(stmt, ast.Pass) or isinstance(stmt, ast.Continue):
            continue
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Constant):
            continue  # docstring / `...`
        if isinstance(stmt, ast.Return):
            v = stmt.value
            if v is None or isinstance(v, ast.Constant):
                continue
            return False
        return False
    return True


def _is_broad_exception(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    names = []
    for node in [t] + (list(t.elts) if isinstance(t, ast.Tuple) else []):
        if isinstance(node, ast.Name):
            names.append(node.id)
        elif isinstance(node, ast.Attribute):
            names.append(node.attr)
    return any(n in ("Exception", "BaseException") for n in names)


@register
class SilentExceptionSwallowRule(Rule):
    id = "EDL303"
    name = "silent-exception-swallow"
    doc = (
        "broad except whose body neither logs nor raises — failures "
        "disappear; narrow the type, log, or re-raise"
    )

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not _is_broad_exception(node):
                continue
            if _body_is_silent(node.body):
                yield self.finding(
                    ctx, node,
                    "broad except silently swallows the error; narrow the "
                    "exception type, log it, or re-raise",
                )


def _module_str_constants(tree: ast.Module) -> dict:
    """Top-level `NAME = "literal"` assignments (state-file names are
    conventionally module constants, e.g. export.py's INFO_FILE)."""
    out = {}
    for node in tree.body:
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and isinstance(node.value, ast.Constant)
            and isinstance(node.value.value, str)
        ):
            out[node.targets[0].id] = node.value.value
    return out


def _open_write_mode(call: ast.Call) -> bool:
    """True for open(...) with an explicit write/truncate mode. Append
    ("a") is deliberately quiet: an append-only log's durability story is
    torn-tail tolerance, not whole-file atomicity."""
    mode = None
    if len(call.args) >= 2:
        mode = call.args[1]
    for kw in call.keywords:
        if kw.arg == "mode":
            mode = kw.value
    return (
        isinstance(mode, ast.Constant)
        and isinstance(mode.value, str)
        and mode.value.startswith("w")
    )


def _json_state_path(expr: ast.AST, consts: dict) -> bool:
    """True when the path expression names a .json/.jsonl file and is NOT
    the .tmp sibling (writing the tmp file IS the atomic idiom's first
    half)."""
    json_like = tmp_like = False
    for node in ast.walk(expr):
        s = None
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            s = node.value
        elif isinstance(node, ast.Name):
            s = consts.get(node.id)
        if s is None:
            continue
        if ".json" in s:
            json_like = True
        if ".tmp" in s:
            tmp_like = True
    return json_like and not tmp_like


@register
class NonAtomicStateFileWriteRule(Rule):
    id = "EDL305"
    name = "non-atomic-state-file-write"
    doc = (
        "open(*.json, 'w') without the tmp-sibling + os.replace idiom — "
        "a crash mid-write leaves a torn state file"
    )

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        consts = _module_str_constants(ctx.tree)
        yield from self._scan_scope(ctx, ctx.tree, consts)

    def _scan_scope(
        self, ctx: ModuleContext, scope: ast.AST, consts: dict
    ) -> Iterator[Finding]:
        """One function body (or the module top level): flag candidate
        writes only when the scope never replaces/renames — a scope that
        does is taken to be implementing the atomic idiom."""
        candidates: List[ast.Call] = []
        replaces = False
        inner: List[ast.AST] = []
        stack = list(ast.iter_child_nodes(scope))
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                inner.append(node)
                continue
            if isinstance(node, ast.Call):
                if (
                    isinstance(node.func, ast.Name)
                    and node.func.id == "open"
                    and node.args
                    and _open_write_mode(node)
                    and _json_state_path(node.args[0], consts)
                ):
                    candidates.append(node)
                elif (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("replace", "rename")
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "os"
                ):
                    replaces = True
            stack.extend(ast.iter_child_nodes(node))
        if not replaces:
            for call in candidates:
                yield self.finding(
                    ctx, call,
                    "non-atomic overwrite of a JSON state file: write a "
                    ".tmp sibling and os.replace() it (crash mid-write "
                    "otherwise leaves a torn file for the next reader)",
                )
        for fn in inner:
            yield from self._scan_scope(ctx, fn, consts)


@register
class SleepRetryNoJitterRule(Rule):
    id = "EDL304"
    name = "sleep-retry-no-jitter"
    doc = (
        "constant time.sleep in a retry loop — synchronized backoff "
        "(thundering herd); add jitter or use the stub's backoff"
    )

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for loop in ast.walk(ctx.tree):
            if not isinstance(loop, (ast.For, ast.While)):
                continue
            has_try = any(
                isinstance(sub, ast.Try)
                for stmt in loop.body
                for sub in ast.walk(stmt)
            )
            if not has_try:
                continue
            for stmt in loop.body:
                for sub in ast.walk(stmt):
                    if (
                        isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Attribute)
                        and sub.func.attr == "sleep"
                        and isinstance(sub.func.value, ast.Name)
                        and sub.func.value.id == "time"
                        and sub.args
                        and isinstance(sub.args[0], ast.Constant)
                    ):
                        yield self.finding(
                            ctx, sub,
                            "constant sleep in a retry loop synchronizes "
                            "retries across workers; jitter it (e.g. "
                            "uniform(0.5, 1.5) * base) or reuse the stub's "
                            "backoff",
                        )
