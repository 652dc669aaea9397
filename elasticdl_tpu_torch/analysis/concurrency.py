"""EDL1xx lock-discipline family: whole-program concurrency analysis.

Three ProjectRules built on one shared model (`ConcurrencyModel`,
memoized on the ProjectContext):

- EDL102 lock-order-inversion — every `with self.<lock>:` site is an
  acquisition node; held-lock sets are propagated interprocedurally
  (through the call graph, seeded from `with` nesting, `# holds:`
  declarations, and the `_locked` naming idiom), producing a static
  lock-acquisition graph whose cycles are potential deadlocks. The
  runtime recorder (`lockorder.py`) only sees orders that executed;
  this sees every order the code can express. `--lock-graph` emits the
  graph (JSON/DOT) for CI artifacts and the runtime-superset
  cross-check in tests/test_lock_order.py.

- EDL103 blocking-call-under-lock — "may block" (sleep, Commit.wait /
  Event.wait, queue get/put, subprocess, socket/file I/O, os.fsync, RPC
  stubs) is propagated through the call graph; any may-block call made
  while a lock is held is flagged, generalizing the lexical EDL403
  beyond fsync. A reviewed `# edl-lint: disable=EDL103` ON the blocking
  line sanctions the site AND stops propagation through it (the journal
  committer's fsync is the canonical sanctioned site).

- EDL104 guarded-state-escape — a `# guarded_by:` MUTABLE attribute
  whose REFERENCE leaves the critical section: returned/yielded, stored
  onto another object, aliased to a differently-guarded attribute, or
  captured by a thread/queue/executor sink, without a copy taken inside
  the lock. This is the aliasing gap locks.py's EDL101 concedes by
  design — EDL101 proves accesses happen under the lock; EDL104 proves
  the lock still means something after the method returns.

Lock identity is `ClassName.attr` abstracted over instances, with the
master control plane's canonical runtime names (the ones
`lockorder.instrument_master` registers) substituted where known, so
the static graph and the runtime recorder's edges share a vocabulary.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from elasticdl_tpu_torch.analysis.callgraph import CallGraph, ClassInfo, FunctionInfo
from elasticdl_tpu_torch.analysis.core import (
    Finding,
    ModuleContext,
    ProjectContext,
    ProjectRule,
    register,
)
from elasticdl_tpu_torch.analysis.locks import (
    _CONSTRUCTION_METHODS,
    _HOLDS_RE,
    guarded_attrs,
)

#: (class name, lock attr) -> the canonical name lockorder.instrument_master
#: registers that lock under at runtime. Keep the two in sync: the
#: cross-check test asserts the static graph over master/ is a superset
#: of the runtime recorder's edges BY THESE NAMES.
CANONICAL_LOCK_NAMES: Dict[Tuple[str, str], str] = {
    ("Membership", "_lock"): "membership",
    ("TaskDispatcher", "_lock"): "dispatcher",
    ("ProcessManager", "_lock"): "process_manager",
    ("MasterServicer", "_loss_lock"): "servicer.loss",
    ("MasterServicer", "_ctrl_lock"): "servicer.ctrl",
    ("EvaluationService", "_lock"): "evaluation",
    ("ControlPlaneJournal", "_lock"): "journal.file",
    ("ControlPlaneJournal", "_qcv"): "journal.queue",
    ("Autoscaler", "_lock"): "autoscaler",
}

#: attr names treated as locks even without a visible threading.X()
#: construction (helper-assigned locks, fixture classes)
_LOCKISH_NAME_RE = re.compile(r"(^_.*lock\w*$|^_qcv$|^_cv$|^_cond\w*$)")

#: containers whose construction marks a guarded attr as MUTABLE
_MUTABLE_CTORS = {
    "dict", "list", "set", "deque", "defaultdict", "OrderedDict",
    "Counter", "bytearray",
}
_MUTABLE_ANN_RE = re.compile(
    r"\b(Dict|List|Set|MutableMapping|MutableSequence|MutableSet|"
    r"deque|defaultdict|DefaultDict|OrderedDict|dict|list|set)\b"
)

#: calls that take a snapshot: a copy wrapped around the guarded attr
#: inside the lock makes the escape safe
_COPY_CALLS = {
    "dict", "list", "tuple", "set", "frozenset", "sorted", "copy",
    "deepcopy", "replace", "asdict",
}


def lock_node(class_name: str, attr: str) -> str:
    """Graph-node name for a class's lock attribute."""
    return CANONICAL_LOCK_NAMES.get((class_name, attr), f"{class_name}.{attr}")


# ------------------------------------------------------------------ #
# shared model


@dataclass
class _Acquire:
    lock: str                     # node name
    held: Tuple[str, ...]         # nodes held at this acquisition
    node: ast.AST
    module: ModuleContext
    kind: str                     # "lock" | "rlock" | "condition"
    suppressed: bool              # reviewed disable=EDL102 on the site


@dataclass
class _CallSite:
    call: ast.Call
    callees: Tuple[str, ...]      # FunctionInfo keys
    held: Tuple[str, ...]
    node: ast.AST
    module: ModuleContext


@dataclass
class _Blocker:
    desc: str                     # e.g. "time.sleep()"
    held: Tuple[str, ...]
    node: ast.AST
    module: ModuleContext
    sanctioned: bool              # disable=EDL103 on the line: no local
                                  # finding AND no propagation to callers


@dataclass
class _FnSummary:
    info: FunctionInfo
    entry_holds: Tuple[str, ...] = ()
    acquires: List[_Acquire] = field(default_factory=list)
    calls: List[_CallSite] = field(default_factory=list)
    blockers: List[_Blocker] = field(default_factory=list)


class _ModuleAliases:
    """Import-aware names for the blocking primitives one module can
    reach: `time.sleep` aliases, `os.fsync`, subprocess entry points."""

    def __init__(self, ctx: ModuleContext):
        self.time_sleep: Set[str] = set()       # sleep / snooze / ...
        self.time_mods: Set[str] = set()        # time / walltime / ...
        self.os_mods: Set[str] = set()
        self.os_funcs: Set[str] = set()         # fsync/fdatasync from-imports
        self.subprocess_mods: Set[str] = set()
        self.subprocess_funcs: Set[str] = set() # run/check_call/Popen/...
        self.socket_mods: Set[str] = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    local = (a.asname or a.name).split(".")[0]
                    if a.name == "time":
                        self.time_mods.add(local)
                    elif a.name == "os":
                        self.os_mods.add(local)
                    elif a.name == "subprocess":
                        self.subprocess_mods.add(local)
                    elif a.name == "socket":
                        self.socket_mods.add(local)
            elif isinstance(node, ast.ImportFrom):
                for a in node.names:
                    local = a.asname or a.name
                    if node.module == "time" and a.name == "sleep":
                        self.time_sleep.add(local)
                    elif node.module == "os" and a.name in (
                        "fsync", "fdatasync"
                    ):
                        self.os_funcs.add(local)
                    elif node.module == "subprocess" and a.name in (
                        "run", "call", "check_call", "check_output", "Popen"
                    ):
                        self.subprocess_funcs.add(local)


def _dotted_tail(expr: ast.AST) -> str:
    """Terminal identifier of a receiver expression ('' if none)."""
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        return expr.attr
    return ""


_SUBPROCESS_BLOCKING = {"run", "call", "check_call", "check_output", "Popen"}
_SOCKET_METHODS = {"recv", "recv_into", "accept", "connect", "sendall"}
_THREADISH_RE = re.compile(r"(thread|committer|watcher|poller|proc)", re.I)
_QUEUEISH_RE = re.compile(r"(queue|_q\d*$)", re.I)
_STUBISH_RE = re.compile(r"stub", re.I)


def _classify_blocker(
    call: ast.Call, aliases: _ModuleAliases
) -> Optional[str]:
    """Human-readable description if this call can block, else None.
    Condition-wait exemption is applied by the caller (needs held-set)."""
    f = call.func
    if isinstance(f, ast.Name):
        if f.id in aliases.time_sleep:
            return "time.sleep()"
        if f.id in aliases.os_funcs:
            return f"os.{f.id}() (disk flush)"
        if f.id in aliases.subprocess_funcs:
            return f"subprocess.{f.id}() (process spawn/wait)"
        if f.id == "open":
            return "open() (file I/O)"
        return None
    if not isinstance(f, ast.Attribute):
        return None
    recv, method = f.value, f.attr
    recv_name = _dotted_tail(recv)
    if method == "sleep" and isinstance(recv, ast.Name) \
            and recv.id in aliases.time_mods:
        return "time.sleep()"
    if method in ("fsync", "fdatasync") and isinstance(recv, ast.Name) \
            and recv.id in aliases.os_mods:
        return f"os.{method}() (disk flush)"
    if method in _SUBPROCESS_BLOCKING and isinstance(recv, ast.Name) \
            and recv.id in aliases.subprocess_mods:
        return f"subprocess.{method}() (process spawn/wait)"
    if method == "wait":
        # Commit.wait / Event.wait / Condition.wait / Popen.wait — all
        # block; the Condition-on-the-innermost-held-lock idiom is
        # exempted by the caller, which knows the held set
        return f"{recv_name or '<recv>'}.wait()"
    if method == "communicate":
        return f"{recv_name}.communicate() (subprocess drain)"
    if method == "result" and not isinstance(recv, ast.Call):
        return f"{recv_name}.result() (future wait)"
    if method == "join" and _THREADISH_RE.search(recv_name or ""):
        return f"{recv_name}.join() (thread join)"
    if method in _SOCKET_METHODS and (
        (isinstance(recv, ast.Name) and recv.id in aliases.socket_mods)
        or re.search(r"(sock|conn|chan)", recv_name or "", re.I)
    ):
        return f"{recv_name}.{method}() (socket I/O)"
    if method in ("get", "put") and _QUEUEISH_RE.search(recv_name or ""):
        blocking = True
        args = list(call.args)
        if len(args) >= (2 if method == "put" else 1):
            blk = args[1] if method == "put" else args[0]
            if isinstance(blk, ast.Constant) and blk.value is False:
                blocking = False
        for kw in call.keywords:
            if kw.arg == "block" and isinstance(kw.value, ast.Constant) \
                    and kw.value.value is False:
                blocking = False
        if blocking:
            return f"{recv_name}.{method}() (queue wait)"
        return None
    if _STUBISH_RE.search(recv_name or "") and method[:1].isupper():
        return f"{recv_name}.{method}() (RPC)"
    return None


class _FunctionVisitor(ast.NodeVisitor):
    """One pass over a def: tracks the lexically-held lock-node stack,
    recording acquisitions, resolvable calls, and blocking primitives."""

    def __init__(
        self,
        model: "ConcurrencyModel",
        info: FunctionInfo,
        cls: Optional[ClassInfo],
        entry_holds: Tuple[str, ...],
    ):
        self.model = model
        self.info = info
        self.cls = cls
        self.ctx = info.module
        self.aliases = model.aliases(info.module)
        self.locks = model.class_locks(cls) if cls is not None else {}
        self.held: List[str] = list(entry_holds)
        self.summary = _FnSummary(info=info, entry_holds=entry_holds)
        self.local_types = model.graph.local_types(info.node)

    # ---- lock regions ---- #

    def _with_locks(self, node: ast.With) -> List[Tuple[str, str, ast.AST]]:
        """(node-name, kind, item-node) for each lock this with acquires."""
        out = []
        for item in node.items:
            expr = item.context_expr
            if (
                isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "self"
                and self.cls is not None
            ):
                attr = expr.attr
                kind = self.locks.get(attr)
                if kind is None and _LOCKISH_NAME_RE.match(attr):
                    kind = "lock"
                if kind is not None:
                    out.append(
                        (lock_node(self.cls.name, attr), kind, expr)
                    )
            elif isinstance(expr, ast.Name):
                kind = self.model.module_lock_kind(self.ctx, expr.id)
                if kind is not None:
                    out.append(
                        (f"{self.ctx.rel_path}:{expr.id}", kind, expr)
                    )
        return out

    def visit_With(self, node: ast.With) -> None:
        acquired = self._with_locks(node)
        for item in node.items:
            self.visit(item.context_expr)
            if item.optional_vars is not None:
                self.visit(item.optional_vars)
        for name, kind, expr in acquired:
            self.summary.acquires.append(_Acquire(
                lock=name, held=tuple(self.held), node=node,
                module=self.ctx, kind=kind,
                suppressed=self.model.site_disabled(self.ctx, node, "edl102"),
            ))
            self.held.append(name)
        for stmt in node.body:
            self.visit(stmt)
        for _ in acquired:
            self.held.pop()

    visit_AsyncWith = visit_With

    # nested defs / lambdas run later, on whatever thread calls them:
    # their bodies get an empty held-set and do NOT contribute calls or
    # blockers to THIS function's summary (they are summarized — and
    # charged — only if the call graph reaches them by name)

    def _deferred(self, node: ast.AST) -> None:
        return  # do not descend

    visit_FunctionDef = _deferred
    visit_AsyncFunctionDef = _deferred
    visit_Lambda = _deferred

    # ---- calls ---- #

    def visit_Call(self, node: ast.Call) -> None:
        desc = _classify_blocker(node, self.aliases)
        if desc is not None and not self._condition_wait_exempt(node):
            self.summary.blockers.append(_Blocker(
                desc=desc, held=tuple(self.held), node=node,
                module=self.ctx,
                sanctioned=self.model.site_disabled(self.ctx, node, "edl103"),
            ))
        callees = self.model.graph.resolve_call(
            node, self.info, self.local_types
        )
        if callees:
            self.summary.calls.append(_CallSite(
                call=node,
                callees=tuple(c.key for c in callees),
                held=tuple(self.held),
                node=node,
                module=self.ctx,
            ))
        self.generic_visit(node)

    def _condition_wait_exempt(self, call: ast.Call) -> bool:
        """`self._cv.wait()` where _cv is the ONLY held lock and is a
        Condition: wait releases it, so nothing stays blocked."""
        f = call.func
        if not (isinstance(f, ast.Attribute)
                and f.attr in ("wait", "wait_for")):
            return False
        recv = f.value
        if not (
            isinstance(recv, ast.Attribute)
            and isinstance(recv.value, ast.Name)
            and recv.value.id == "self"
            and self.cls is not None
        ):
            return False
        if self.locks.get(recv.attr) != "condition":
            return False
        node_name = lock_node(self.cls.name, recv.attr)
        return list(self.held) == [node_name]


class ConcurrencyModel:
    """Per-run shared state for the EDL1xx family: function summaries,
    the transitive acquire sets, the may-block closure, and the global
    lock graph. Built once per ProjectContext."""

    def __init__(self, project: ProjectContext):
        self.project = project
        self.graph: CallGraph = project.callgraph
        self._aliases: Dict[str, _ModuleAliases] = {}
        self._module_locks: Dict[str, Dict[str, str]] = {}
        self._class_locks: Dict[str, Dict[str, str]] = {}
        self.summaries: Dict[str, _FnSummary] = {}
        self._lock_kinds: Dict[str, str] = {}   # node name -> kind
        self._build_summaries()
        self.acquires_trans = self._fixpoint_acquires()
        self.may_block = self._fixpoint_may_block()
        self.edges = self._build_edges()

    # ---- caches ---- #

    def aliases(self, ctx: ModuleContext) -> _ModuleAliases:
        a = self._aliases.get(ctx.rel_path)
        if a is None:
            a = self._aliases[ctx.rel_path] = _ModuleAliases(ctx)
        return a

    def module_lock_kind(self, ctx: ModuleContext, name: str) -> Optional[str]:
        """Module-global locks: `_REG_LOCK = threading.Lock()`."""
        locks = self._module_locks.get(ctx.rel_path)
        if locks is None:
            locks = {}
            for node in ctx.tree.body:
                if (
                    isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                ):
                    from elasticdl_tpu_torch.analysis.callgraph import _lock_kind

                    kind = _lock_kind(node.value)
                    if kind is not None:
                        locks[node.targets[0].id] = kind
            self._module_locks[ctx.rel_path] = locks
        return locks.get(name)

    def class_locks(self, cls: ClassInfo) -> Dict[str, str]:
        """attr -> kind for every lock the class (or its bases) owns,
        unioned with the guarded_by annotations' lock names (a guard
        must be a lock even if its construction wasn't recognized)."""
        cached = self._class_locks.get(cls.key)
        if cached is not None:
            return cached
        out = dict(self.graph.lock_attrs_of(cls))
        for c in self.graph.mro(cls):
            for lock in guarded_attrs(c.module, c.node).values():
                out.setdefault(lock, "lock")
        self._class_locks[cls.key] = out
        return out

    def site_disabled(
        self, ctx: ModuleContext, node: ast.AST, rule_key: str
    ) -> bool:
        """Is there a reviewed `# edl-lint: disable=<rule>` on this node's
        lines? Used to stop EDL103 propagation at sanctioned blockers and
        drop EDL102 edges at reviewed acquisition sites."""
        per_line, per_file = ctx._suppressions
        keys = {rule_key, "all"}
        if per_file & keys:
            return True
        start = getattr(node, "lineno", 1)
        end = getattr(node, "end_lineno", start) or start
        return any(
            per_line.get(line, set()) & keys
            for line in range(start, end + 1)
        )

    # ---- summaries ---- #

    def _entry_holds(
        self, cls: Optional[ClassInfo], fn: FunctionInfo
    ) -> Tuple[str, ...]:
        """Locks a def declares it is called under — `# holds:` names and
        the `_locked` suffix — resolved against the DEFINING class's
        known locks (unresolvable names are dropped: a mixin's `# holds:
        _lock` can't name a node until a subclass owns the lock)."""
        if cls is None:
            return ()
        locks = self.class_locks(cls)
        if not locks:
            return ()
        names: Set[str] = set()
        node = fn.node
        if fn.name.endswith("_locked"):
            # "_foo_locked runs under THE lock": prefer the canonical
            # `_lock`; a class without one means every lock it owns
            names |= {"_lock"} if "_lock" in locks else set(locks)
        for line in (node.lineno, node.lineno - 1):
            m = _HOLDS_RE.search(fn.module.line_text(line))
            if m:
                names |= {
                    n.strip() for n in m.group("locks").split(",") if n.strip()
                }
        return tuple(
            lock_node(cls.name, n) for n in sorted(names) if n in locks
        )

    def _build_summaries(self) -> None:
        for key, fn in self.graph.functions.items():
            cls = None
            if fn.class_name:
                for c in self.graph.resolve_class_name(
                    fn.class_name, fn.module
                ):
                    if c.module.rel_path == fn.module.rel_path:
                        cls = c
                        break
            entry = self._entry_holds(cls, fn)
            visitor = _FunctionVisitor(self, fn, cls, entry)
            for stmt in fn.node.body:
                visitor.visit(stmt)
            self.summaries[key] = visitor.summary
            for acq in visitor.summary.acquires:
                self._lock_kinds.setdefault(acq.lock, acq.kind)

    def lock_kind(self, node_name: str) -> str:
        return self._lock_kinds.get(node_name, "lock")

    # ---- fixpoints ---- #

    def _fixpoint_acquires(self) -> Dict[str, Set[str]]:
        """Transitive closure: every lock a call to F may acquire.
        Construction-time acquisitions don't count against callers —
        `__init__` runs happens-before publication (same exemption the
        guarded-by rule grants), so constructing an object under a lock
        does not order the new object's lock after the held one."""
        acq: Dict[str, Set[str]] = {
            k: {a.lock for a in s.acquires if not a.suppressed}
            for k, s in self.summaries.items()
        }
        changed = True
        while changed:
            changed = False
            for k, s in self.summaries.items():
                cur = acq[k]
                before = len(cur)
                for c in s.calls:
                    for callee in c.callees:
                        if callee.split(".")[-1] in _CONSTRUCTION_METHODS:
                            continue
                        cur |= acq.get(callee, set())
                if len(cur) != before:
                    changed = True
        return acq

    def _fixpoint_may_block(self) -> Dict[str, Tuple[str, str]]:
        """key -> (description, witness site) for functions that may
        block. Sanctioned blockers (reviewed disable=EDL103) neither
        count locally nor propagate."""
        out: Dict[str, Tuple[str, str]] = {}
        for k, s in self.summaries.items():
            for b in s.blockers:
                if b.sanctioned:
                    continue
                site = f"{b.module.rel_path}:{b.node.lineno}"
                out[k] = (b.desc, site)
                break
        changed = True
        while changed:
            changed = False
            for k, s in self.summaries.items():
                if k in out:
                    continue
                for c in s.calls:
                    hit = next(
                        (cl for cl in c.callees
                         if cl in out
                         and cl.split(".")[-1] not in _CONSTRUCTION_METHODS),
                        None,
                    )
                    if hit is not None:
                        desc, site = out[hit]
                        callee_disp = hit.split("::")[-1]
                        out[k] = (
                            f"{desc} via {callee_disp}",
                            site,
                        )
                        changed = True
                        break
        return out

    # ---- the lock graph ---- #

    def _build_edges(self) -> Dict[Tuple[str, str], List[str]]:
        """(held, acquired) -> acquisition sites, unioned over every
        function: direct `with` nesting plus call-through acquisition
        (caller holds H, callee transitively acquires A => H -> A)."""
        edges: Dict[Tuple[str, str], List[str]] = {}

        def add(h: str, a: str, site: str) -> None:
            if h == a:
                return
            sites = edges.setdefault((h, a), [])
            if site not in sites:
                sites.append(site)

        for k, s in self.summaries.items():
            for acq in s.acquires:
                if acq.suppressed:
                    continue
                site = f"{acq.module.rel_path}:{acq.node.lineno} ({k.split('::')[-1]})"
                for h in acq.held:
                    add(h, acq.lock, site)
            for c in s.calls:
                if not c.held:
                    continue
                site = (
                    f"{c.module.rel_path}:{c.node.lineno} "
                    f"({k.split('::')[-1]} -> call)"
                )
                for callee in c.callees:
                    if callee.split(".")[-1] in _CONSTRUCTION_METHODS:
                        continue
                    for a in self.acquires_trans.get(callee, set()):
                        for h in c.held:
                            add(h, a, site)
        return edges

    def cycles(self) -> List[List[str]]:
        """Elementary cycles in the acquisition-order graph, each
        reported once in canonical rotation (same algorithm family as
        lockorder.LockOrderRecorder.cycles)."""
        edge_list = list(self.edges)
        out: List[List[str]] = []
        seen: Set[Tuple[str, ...]] = set()
        for (a, b) in edge_list:
            path = self._find_path(b, a, edge_list)
            if path is None:
                continue
            cyc = [a] + path
            nodes = cyc[:-1] if cyc[0] == cyc[-1] else cyc
            k = min(range(len(nodes)), key=lambda i: nodes[i])
            canon = tuple(nodes[k:] + nodes[:k])
            if canon not in seen:
                seen.add(canon)
                out.append(list(canon))
        return out

    @staticmethod
    def _find_path(
        src: str, dst: str, edges: List[Tuple[str, str]]
    ) -> Optional[List[str]]:
        stack = [(src, [src])]
        seen: Set[str] = set()
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            if node in seen:
                continue
            seen.add(node)
            for (a, b) in edges:
                if a == node:
                    stack.append((b, path + [b]))
        return None

    def reentrant_acquires(self) -> Iterator[_Acquire]:
        """`with self.X` (or a call that re-acquires X) while X is
        already held — a self-deadlock on a plain Lock."""
        for s in self.summaries.values():
            for acq in s.acquires:
                if acq.suppressed or acq.kind != "lock":
                    continue
                if acq.lock in acq.held:
                    yield acq


def concurrency_model(project: ProjectContext) -> ConcurrencyModel:
    model = project.cache.get("concurrency")
    if model is None:
        model = ConcurrencyModel(project)
        project.cache["concurrency"] = model
    return model


# ------------------------------------------------------------------ #
# lock-graph emission (CLI --lock-graph, CI artifact, cross-check test)


def build_lock_graph(project: ProjectContext) -> Dict:
    """JSON-ready static lock-acquisition graph: nodes (with kinds),
    directed edges with their source sites, and any cycles."""
    model = concurrency_model(project)
    nodes = sorted(
        {n for e in model.edges for n in e}
        | set(model._lock_kinds)
    )
    return {
        "version": 1,
        "nodes": [
            {"name": n, "kind": model.lock_kind(n)} for n in nodes
        ],
        "edges": [
            {"from": a, "to": b, "sites": sites}
            for (a, b), sites in sorted(model.edges.items())
        ],
        "cycles": model.cycles(),
    }


def render_lock_graph_dot(graph: Dict) -> str:
    lines = ["digraph lock_order {", "  rankdir=LR;"]
    cyc_nodes = {n for c in graph["cycles"] for n in c}
    for n in graph["nodes"]:
        attrs = ' [color=red, penwidth=2]' if n["name"] in cyc_nodes else ""
        lines.append(f'  "{n["name"]}"{attrs};')
    for e in graph["edges"]:
        label = e["sites"][0].split(" ")[0] if e["sites"] else ""
        lines.append(
            f'  "{e["from"]}" -> "{e["to"]}" [label="{label}"];'
        )
    lines.append("}")
    return "\n".join(lines) + "\n"


# ------------------------------------------------------------------ #
# EDL102


@register
class LockOrderInversionRule(ProjectRule):
    """Static lock-order inversion detection.

    Builds the whole-program lock-acquisition graph: a directed edge
    A -> B means some code path acquires B while holding A — either a
    literal `with self._b:` nested inside `with self._a:`, or a call
    made under A to a function that (transitively) acquires B. Held
    sets are seeded from `with` nesting, `# holds: <lock>` declarations
    and the `_locked` method-name idiom, and propagated through the
    class/method-resolving call graph, so a cross-module inversion
    (membership -> journal in one path, journal -> membership in
    another) is caught without either file mentioning the other's lock.

    A cycle in the graph is a POTENTIAL deadlock: two threads walking
    the cycle's edges concurrently can each hold the lock the other
    wants. The runtime recorder (`analysis/lockorder.py`) proves the
    orders that executed are acyclic; this rule proves no OTHER order
    is expressible. Re-entrant acquisition of a plain (non-reentrant)
    Lock is reported by the same rule — that one needs no second
    thread to deadlock.

    Fix by acquiring in a single global order (document it where the
    locks are declared), or release before calling into the other
    component (the membership death-callback idiom). Suppress a
    reviewed-impossible edge with `# edl-lint: disable=EDL102` ON the
    acquisition site — that drops the edge from the graph (and the
    `--lock-graph` artifact) rather than just hiding a finding.
    """

    id = "EDL102"
    name = "lock-order-inversion"
    doc = (
        "cycle in the static lock-acquisition graph (interprocedural "
        "held-set propagation over `with self.<lock>:` sites, `# holds:` "
        "declarations, and the `_locked` idiom) — a potential deadlock "
        "even if no run has interleaved it yet"
    )

    def check_project(self, project: ProjectContext) -> Iterator[Finding]:
        model = concurrency_model(project)
        for cycle in sorted(model.cycles()):
            yield from self._cycle_finding(model, cycle)
        for acq in model.reentrant_acquires():
            yield self.finding(
                acq.module, acq.node,
                f"re-entrant acquisition: `with` on {acq.lock} while "
                f"already holding it — self-deadlock on a "
                f"non-reentrant Lock",
            )

    def _cycle_finding(
        self, model: ConcurrencyModel, cycle: List[str]
    ) -> Iterator[Finding]:
        ring = cycle + [cycle[0]]
        legs = []
        anchor: Optional[Tuple[ModuleContext, ast.AST]] = None
        for a, b in zip(ring, ring[1:]):
            sites = model.edges.get((a, b), [])
            legs.append(f"{a} -> {b} at {sites[0] if sites else '<?>'}")
            if anchor is None:
                anchor = self._site_node(model, (a, b))
        msg = (
            "lock-order inversion: cycle "
            + " -> ".join(ring)
            + " ("
            + "; ".join(legs)
            + ")"
        )
        if anchor is not None:
            ctx, node = anchor
            yield self.finding(ctx, node, msg)

    @staticmethod
    def _site_node(
        model: ConcurrencyModel, edge: Tuple[str, str]
    ) -> Optional[Tuple[ModuleContext, ast.AST]]:
        """The AST site backing an edge's first recorded occurrence."""
        target_sites = model.edges.get(edge, [])
        if not target_sites:
            return None
        first = target_sites[0]
        for s in model.summaries.values():
            for acq in s.acquires:
                if f"{acq.module.rel_path}:{acq.node.lineno}" in first \
                        and edge[1] == acq.lock and edge[0] in acq.held:
                    return acq.module, acq.node
            for c in s.calls:
                if f"{c.module.rel_path}:{c.node.lineno}" in first \
                        and edge[0] in c.held:
                    return c.module, c.node
        return None


# ------------------------------------------------------------------ #
# EDL103


@register
class BlockingCallUnderLockRule(ProjectRule):
    """Blocking call while holding a lock, interprocedurally.

    "May block" seeds: `time.sleep`, `.wait()` (Commit / Event /
    Condition / Popen), `queue.get/put` (blocking forms), subprocess
    spawn/drain, socket I/O, `open()` / `os.fsync` / `os.fdatasync`,
    `.result()` futures, thread `.join()`, and RPC-stub calls. The
    property propagates through the call graph: a function that calls a
    may-block function may block. Any call made while a lock is held —
    `with self._lock:` nesting, a `# holds:`/`_locked` method — to a
    blocking primitive or a may-block function is flagged.

    Why it matters here: every master lock serializes gRPC handler
    threads; one fsync or RPC stalled under a lock convoys the whole
    handler pool (the journal's group-commit redesign exists precisely
    to move the fsync out from under the owner locks). EDL403 catches
    the lexical fsync-under-lock case; this rule generalizes it to
    every blocker and every call depth.

    The Condition idiom is exempt: `self._cv.wait()` while `_cv` is the
    ONLY held lock releases it (that is what Conditions are for).

    A reviewed `# edl-lint: disable=EDL103` on the BLOCKING line both
    silences the site and stops propagation — callers of a sanctioned
    blocker are not charged (the journal committer's fsync runs on a
    dedicated thread under its private file lock; every control-plane
    append routed through it must stay clean).
    """

    id = "EDL103"
    name = "blocking-call-under-lock"
    doc = (
        "call that may block (sleep / wait / queue / subprocess / "
        "socket / file I/O / RPC stub — propagated interprocedurally "
        "through the call graph) made while holding a lock: one stalled "
        "holder convoys every thread behind the lock"
    )

    def check_project(self, project: ProjectContext) -> Iterator[Finding]:
        model = concurrency_model(project)
        for key, s in model.summaries.items():
            for b in s.blockers:
                if b.sanctioned or not b.held:
                    continue
                yield self.finding(
                    b.module, b.node,
                    f"blocking {b.desc} while holding "
                    f"{', '.join(b.held)}",
                )
            for c in s.calls:
                if not c.held:
                    continue
                for callee in c.callees:
                    hit = model.may_block.get(callee)
                    if hit is None:
                        continue
                    if callee.split(".")[-1] in _CONSTRUCTION_METHODS:
                        continue
                    desc, site = hit
                    yield self.finding(
                        c.module, c.node,
                        f"call to {callee.split('::')[-1]} while holding "
                        f"{', '.join(c.held)} — it may block "
                        f"({desc} at {site})",
                    )
                    break


# ------------------------------------------------------------------ #
# EDL104


@register
class GuardedStateEscapeRule(ProjectRule):
    """A guarded MUTABLE attribute's reference escaping its lock.

    EDL101 proves every touch of a `# guarded_by:` attribute happens
    under the lock; it deliberately ignores aliasing. This rule closes
    the half the reviews kept catching by hand (Autoscaler.snapshot in
    PR 14, PushQueue journaling in PR 15): inside the critical section
    the code hands out the CONTAINER ITSELF —

      - `return self._workers` / `yield self._stats`
      - `other.cache = self._members` (stored onto another object)
      - `self._last = self._doing` (aliased under a different guard)
      - `Thread(target=f, args=(self._health,))`, `q.put(self._map)`,
        `pool.submit(f, self._rows)` (captured by another thread)
      - returning a live `.keys()/.values()/.items()` view

    — after which every "guarded" access contract is void: the caller
    mutates or iterates the container with no lock at all, racing the
    next guarded writer (the snapshot-without-copy crash class).

    Take a copy INSIDE the lock instead: `dict(self._workers)`,
    `list(...)`, `sorted(...)`, `.copy()`, `copy.deepcopy(...)` all
    sanitize the escape. Scalars are exempt (rebinding an int escapes a
    value, not shared state); attributes whose constructed type can't
    be shown mutable are skipped rather than guessed.
    """

    id = "EDL104"
    name = "guarded-state-escape"
    doc = (
        "`# guarded_by:` mutable attribute returned/yielded/stored/"
        "thread-captured as a live reference (no copy inside the lock) — "
        "the lock stops meaning anything once the reference escapes"
    )

    def check_project(self, project: ProjectContext) -> Iterator[Finding]:
        for ctx in project.modules:
            for cls in ast.walk(ctx.tree):
                if isinstance(cls, ast.ClassDef):
                    yield from self._check_class(ctx, cls)

    def _check_class(
        self, ctx: ModuleContext, cls: ast.ClassDef
    ) -> Iterator[Finding]:
        guarded = guarded_attrs(ctx, cls)
        if not guarded:
            return
        mutable = {
            attr for attr in guarded if _attr_is_mutable(ctx, cls, attr)
        }
        if not mutable:
            return
        for node in cls.body:
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if node.name in _CONSTRUCTION_METHODS:
                continue
            v = _EscapeVisitor(self, ctx, guarded, mutable)
            for stmt in node.body:
                v.visit(stmt)
            yield from v.findings


def _attr_is_mutable(
    ctx: ModuleContext, cls: ast.ClassDef, attr: str
) -> bool:
    """Mutability from the construction-method assignment: container
    display/constructor, or a container-typed annotation. Unknown
    types are NOT flagged (conservative)."""
    for node in ast.walk(cls):
        target = value = ann = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target, value = node.targets[0], node.value
        elif isinstance(node, ast.AnnAssign):
            target, value, ann = node.target, node.value, node.annotation
        if not (
            isinstance(target, ast.Attribute)
            and isinstance(target.value, ast.Name)
            and target.value.id == "self"
            and target.attr == attr
        ):
            continue
        if isinstance(value, (ast.Dict, ast.List, ast.Set)):
            return True
        if isinstance(value, ast.Call):
            f = value.func
            name = f.id if isinstance(f, ast.Name) else (
                f.attr if isinstance(f, ast.Attribute) else ""
            )
            if name in _MUTABLE_CTORS:
                return True
        if ann is not None and _MUTABLE_ANN_RE.search(ast.unparse(ann)):
            return True
    return False


_ESCAPE_SINK_CALLS = {"put", "submit", "put_nowait"}
_THREAD_CTORS = {"Thread", "Timer"}


class _EscapeVisitor(ast.NodeVisitor):
    """Walk one method finding guarded-container references that leave."""

    def __init__(
        self,
        rule: GuardedStateEscapeRule,
        ctx: ModuleContext,
        guarded: Dict[str, str],
        mutable: Set[str],
    ):
        self.rule = rule
        self.ctx = ctx
        self.guarded = guarded
        self.mutable = mutable
        self.aliases: Dict[str, str] = {}   # local name -> guarded attr
        self.findings: List[Finding] = []

    # nested defs/lambdas: separate escape surface, skipped (EDL101
    # already empties their held-set; chasing closures is out of scope)
    def visit_FunctionDef(self, node):  # noqa: D102
        return

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef

    # ---- alias tracking + stores ---- #

    def _guarded_ref(self, expr: ast.AST) -> Optional[str]:
        """Guarded-attr name if expr is a live reference to it: the
        attribute itself, a tracked local alias, or a .keys/.values/
        .items() view of either."""
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
            and expr.attr in self.mutable
        ):
            return expr.attr
        if isinstance(expr, ast.Name) and expr.id in self.aliases:
            return self.aliases[expr.id]
        if (
            isinstance(expr, ast.Call)
            and isinstance(expr.func, ast.Attribute)
            and expr.func.attr in ("keys", "values", "items")
            and not expr.args
        ):
            return self._guarded_ref(expr.func.value)
        return None

    def visit_Assign(self, node: ast.Assign) -> None:
        ref = self._guarded_ref(node.value)
        for target in node.targets:
            if ref is None:
                break
            if isinstance(target, ast.Name):
                # alias into a local: not yet an escape, but remembered
                self.aliases[target.id] = ref
            elif isinstance(target, ast.Attribute):
                if (
                    isinstance(target.value, ast.Name)
                    and target.value.id == "self"
                ):
                    if self.guarded.get(target.attr) == self.guarded.get(ref):
                        continue   # same guard domain: still covered
                    self._escape(
                        node, ref,
                        f"aliased into self.{target.attr} (guard "
                        f"'{self.guarded.get(target.attr, 'none')}' != "
                        f"'{self.guarded[ref]}')",
                    )
                else:
                    self._escape(
                        node, ref,
                        f"stored onto {_dotted_tail(target.value) or 'another object'}"
                        f".{target.attr}",
                    )
            elif isinstance(target, ast.Subscript):
                self._escape(node, ref, "stored into a container")
        self.generic_visit(node)

    def visit_Return(self, node: ast.Return) -> None:
        if node.value is not None:
            ref = self._guarded_ref(node.value)
            if ref is not None:
                self._escape(node, ref, "returned as a live reference")
        self.generic_visit(node)

    def visit_Yield(self, node: ast.Yield) -> None:
        if node.value is not None:
            ref = self._guarded_ref(node.value)
            if ref is not None:
                self._escape(node, ref, "yielded as a live reference")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        sinky = (
            isinstance(f, ast.Attribute) and f.attr in _ESCAPE_SINK_CALLS
        ) or (
            isinstance(f, ast.Name) and f.id in _THREAD_CTORS
        ) or (
            isinstance(f, ast.Attribute) and f.attr in _THREAD_CTORS
        )
        if sinky:
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                refs = []
                ref = self._guarded_ref(arg)
                if ref is not None:
                    refs.append((arg, ref))
                elif isinstance(arg, (ast.Tuple, ast.List)):
                    for el in arg.elts:
                        r = self._guarded_ref(el)
                        if r is not None:
                            refs.append((el, r))
                for el, r in refs:
                    self._escape(
                        node, r,
                        "handed to another thread "
                        f"({_dotted_tail(f) or 'sink'})",
                    )
        self.generic_visit(node)

    def _escape(self, node: ast.AST, attr: str, how: str) -> None:
        self.findings.append(
            self.rule.finding(
                self.ctx, node,
                f"self.{attr} (guarded_by {self.guarded[attr]}) escapes: "
                f"{how} — copy inside the lock "
                f"(dict()/list()/sorted()/.copy()) instead",
            )
        )
