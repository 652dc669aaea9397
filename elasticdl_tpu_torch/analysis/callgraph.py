"""Whole-program call graph for the project-wide (ProjectRule) passes.

Parses nothing itself — it is built from the ModuleContexts the runner
already parsed — and resolves calls with the cheapest analysis that is
right for THIS codebase (stdlib `ast` only, no type checker):

- ``self.m(...)``          -> the defining class or its project bases (MRO)
- ``ClassName(...)``       -> ``ClassName.__init__``
- ``ClassName.m(...)``     -> the unbound method
- ``self._attr.m(...)``    -> via the attr's inferred type(s); attrs are
  typed from constructor calls (``self._x = Foo(...)``), annotations
  (``self._x: Foo``, class-level ``_x: "Optional[Foo]" = None`` — string
  annotations are parsed, so forward references work), and annotated
  ``__init__`` parameters assigned to attrs (``self._x = journal`` where
  ``journal: ControlPlaneJournal``). Lookup walks the MRO, so a mixin's
  class-level annotation types the subclass's attribute too.
- ``local.m(...)``         -> via per-function local inference (a local
  assigned from a project-class constructor or an annotated parameter)
- ``mod.f(...)`` / ``f(...)`` -> module functions through the import map
- duck fallback: a method name defined by exactly ONE project class (and
  not shadowing a builtin-container/threading/file method) resolves to
  that class even when the receiver's type is unknown. This is what makes
  un-annotated glue code analyzable; the blocklist keeps ``d.get(...)``
  from resolving to ``TaskDispatcher.get``.

Deliberately NOT handled (callers must tolerate unresolved calls):
callbacks invoked through containers (``for cb in self._cbs: cb()``),
``getattr`` dispatch, and decorators that replace the function. A call
site that resolves to nothing contributes nothing — rules built on the
graph stay sound for what the graph DOES claim, and the runtime
lock-order recorder covers the dynamic remainder.
"""

from __future__ import annotations

import ast
import threading
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from elasticdl_tpu_torch.analysis.core import ModuleContext

#: method names too generic for duck resolution — defined by builtin
#: containers / sync primitives / file objects, so an unknown receiver
#: is far more likely one of those than a project class
_COMMON_METHOD_NAMES: Set[str] = set()
for _t in (dict, list, set, frozenset, str, bytes, tuple):
    _COMMON_METHOD_NAMES.update(
        n for n in dir(_t) if not n.startswith("__")
    )
_COMMON_METHOD_NAMES |= {
    n for n in dir(threading.Lock()) if not n.startswith("__")
}
_COMMON_METHOD_NAMES |= {
    "acquire", "release", "wait", "notify", "notify_all", "start", "run",
    "join", "close", "open", "flush", "read", "write", "readline",
    "send", "recv", "submit", "result", "cancel", "is_set", "set",
    "clear", "get", "put", "inc", "dec", "observe", "info", "debug",
    "warning", "error", "exception", "critical", "log", "emit", "next",
    "stop", "reset", "name", "empty", "full", "fileno", "register",
}


@dataclass
class FunctionInfo:
    """One def: a method (class_name set) or a module-level function."""

    key: str                      # "rel/path.py::Class.method" | "::func"
    name: str
    node: ast.AST                 # FunctionDef | AsyncFunctionDef
    module: ModuleContext
    class_name: Optional[str] = None

    @property
    def display(self) -> str:
        return f"{self.class_name}.{self.name}" if self.class_name else self.name


@dataclass
class ClassInfo:
    key: str                      # "rel/path.py::Class"
    name: str
    node: ast.ClassDef
    module: ModuleContext
    bases: List[str] = field(default_factory=list)
    methods: Dict[str, FunctionInfo] = field(default_factory=dict)
    #: attr -> set of project-class NAMES the attr may hold
    attr_types: Dict[str, Set[str]] = field(default_factory=dict)
    #: attr -> "lock" | "rlock" | "condition" (threading constructions
    #: seen anywhere in the class body)
    lock_attrs: Dict[str, str] = field(default_factory=dict)


def _func_defs(cls: ast.ClassDef) -> Iterator[ast.AST]:
    for child in cls.body:
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield child


_LOCK_CTORS = {"Lock": "lock", "RLock": "rlock", "Condition": "condition"}


def _lock_kind(value: ast.AST) -> Optional[str]:
    """'lock'/'rlock'/'condition' if value is a threading.X() construction
    (bare `Lock()` from-imports count too)."""
    if not isinstance(value, ast.Call):
        return None
    f = value.func
    if isinstance(f, ast.Attribute):
        return _LOCK_CTORS.get(f.attr)
    if isinstance(f, ast.Name):
        return _LOCK_CTORS.get(f.id)
    return None


class CallGraph:
    """Classes, functions, and a resolver — see the module docstring."""

    def __init__(self, modules: Sequence[ModuleContext]):
        self.modules = list(modules)
        self.classes: Dict[str, ClassInfo] = {}
        self.functions: Dict[str, FunctionInfo] = {}
        self.by_class_name: Dict[str, List[ClassInfo]] = {}
        #: method name -> [(ClassInfo, FunctionInfo)] across the project
        self._methods_by_name: Dict[str, List[Tuple[ClassInfo, FunctionInfo]]] = {}
        #: per module: local name -> imported module dotted path ("time")
        self._module_imports: Dict[str, Dict[str, str]] = {}
        #: per module: local name imported FROM somewhere ("CommitGate")
        self._from_imports: Dict[str, Set[str]] = {}
        self._mro_cache: Dict[str, List[ClassInfo]] = {}
        self._attr_cache: Dict[Tuple[str, str], Set[str]] = {}
        for m in self.modules:
            self._index_module(m)
        for cls in self.classes.values():
            self._infer_class_attrs(cls)

    # -------------------------------------------------------------- #
    # indexing

    def _index_module(self, ctx: ModuleContext) -> None:
        imports: Dict[str, str] = {}
        froms: Set[str] = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    imports[(a.asname or a.name).split(".")[0]] = a.name
            elif isinstance(node, ast.ImportFrom):
                for a in node.names:
                    froms.add(a.asname or a.name)
        self._module_imports[ctx.rel_path] = imports
        self._from_imports[ctx.rel_path] = froms

        for node in ctx.tree.body:
            if isinstance(node, ast.ClassDef):
                self._index_class(ctx, node)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                key = f"{ctx.rel_path}::{node.name}"
                self.functions[key] = FunctionInfo(
                    key=key, name=node.name, node=node, module=ctx,
                )

    def _index_class(self, ctx: ModuleContext, node: ast.ClassDef) -> None:
        info = ClassInfo(
            key=f"{ctx.rel_path}::{node.name}", name=node.name,
            node=node, module=ctx,
        )
        for b in node.bases:
            if isinstance(b, ast.Name):
                info.bases.append(b.id)
            elif isinstance(b, ast.Attribute):
                info.bases.append(b.attr)
        for fn in _func_defs(node):
            key = f"{ctx.rel_path}::{node.name}.{fn.name}"
            fi = FunctionInfo(
                key=key, name=fn.name, node=fn, module=ctx,
                class_name=node.name,
            )
            info.methods[fn.name] = fi
            self.functions[key] = fi
            self._methods_by_name.setdefault(fn.name, []).append((info, fi))
        self.classes[info.key] = info
        self.by_class_name.setdefault(info.name, []).append(info)

    # -------------------------------------------------------------- #
    # attribute / annotation type inference

    def _class_names_in_annotation(self, ann: ast.AST) -> Set[str]:
        """Project-class names mentioned anywhere in an annotation
        (handles Optional[X], X | None, and "quoted forward refs")."""
        out: Set[str] = set()
        stack = [ann]
        while stack:
            n = stack.pop()
            if isinstance(n, ast.Constant) and isinstance(n.value, str):
                try:
                    stack.append(ast.parse(n.value, mode="eval").body)
                except SyntaxError:
                    continue
                continue
            for sub in ast.walk(n):
                if isinstance(sub, ast.Name) and sub.id in self.by_class_name:
                    out.add(sub.id)
                elif isinstance(sub, ast.Attribute) and sub.attr in self.by_class_name:
                    out.add(sub.attr)
        return out

    def _callee_class_name(self, value: ast.AST) -> Optional[str]:
        """Class name if value is `ClassName(...)` / `mod.ClassName(...)`."""
        if not isinstance(value, ast.Call):
            return None
        f = value.func
        name = f.id if isinstance(f, ast.Name) else (
            f.attr if isinstance(f, ast.Attribute) else None
        )
        return name if name in self.by_class_name else None

    def _infer_class_attrs(self, cls: ClassInfo) -> None:
        # class-level annotated declarations (mixin idiom:
        # `_journal: "Optional[ControlPlaneJournal]" = None`)
        for stmt in cls.node.body:
            if isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target, ast.Name):
                names = self._class_names_in_annotation(stmt.annotation)
                if names:
                    cls.attr_types.setdefault(stmt.target.id, set()).update(names)

        for fn in _func_defs(cls.node):
            params: Dict[str, Set[str]] = {}
            args = fn.args
            for a in list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs):
                if a.annotation is not None:
                    names = self._class_names_in_annotation(a.annotation)
                    if names:
                        params[a.arg] = names
            for node in ast.walk(fn):
                target = value = ann = None
                if isinstance(node, ast.Assign) and len(node.targets) == 1:
                    target, value = node.targets[0], node.value
                elif isinstance(node, ast.AnnAssign):
                    target, value, ann = node.target, node.value, node.annotation
                if not (
                    isinstance(target, ast.Attribute)
                    and isinstance(target.value, ast.Name)
                    and target.value.id == "self"
                ):
                    continue
                attr = target.attr
                kind = _lock_kind(value) if value is not None else None
                if kind is not None:
                    cls.lock_attrs.setdefault(attr, kind)
                    continue
                types: Set[str] = set()
                if ann is not None:
                    types |= self._class_names_in_annotation(ann)
                ctor = self._callee_class_name(value) if value is not None else None
                if ctor:
                    types.add(ctor)
                if isinstance(value, ast.Name) and value.id in params:
                    types |= params[value.id]
                if types:
                    cls.attr_types.setdefault(attr, set()).update(types)

    # -------------------------------------------------------------- #
    # resolution helpers

    def resolve_class_name(
        self, name: str, ctx: Optional[ModuleContext] = None
    ) -> List[ClassInfo]:
        """Candidates for a bare class name, preferring the referencing
        module's own class, then an explicit from-import, then any."""
        candidates = self.by_class_name.get(name, [])
        if len(candidates) <= 1 or ctx is None:
            return list(candidates)
        own = [c for c in candidates if c.module.rel_path == ctx.rel_path]
        if own:
            return own
        if name in self._from_imports.get(ctx.rel_path, set()):
            return list(candidates)
        return list(candidates)

    def mro(self, cls: ClassInfo) -> List[ClassInfo]:
        """The class plus its project bases, breadth-first (close enough
        to real MRO for method lookup in this codebase)."""
        cached = self._mro_cache.get(cls.key)
        if cached is not None:
            return cached
        out, queue, seen = [], [cls], set()
        while queue:
            c = queue.pop(0)
            if c.key in seen:
                continue
            seen.add(c.key)
            out.append(c)
            for base in c.bases:
                queue.extend(self.resolve_class_name(base, c.module))
        self._mro_cache[cls.key] = out
        return out

    def lookup_method(self, cls: ClassInfo, name: str) -> Optional[FunctionInfo]:
        for c in self.mro(cls):
            if name in c.methods:
                return c.methods[name]
        return None

    def attr_types_of(self, cls: ClassInfo, attr: str) -> Set[str]:
        """Inferred type names for self.<attr>, unioned over the MRO."""
        ck = (cls.key, attr)
        cached = self._attr_cache.get(ck)
        if cached is not None:
            return cached
        out: Set[str] = set()
        for c in self.mro(cls):
            out |= c.attr_types.get(attr, set())
        self._attr_cache[ck] = out
        return out

    def lock_attrs_of(self, cls: ClassInfo) -> Dict[str, str]:
        out: Dict[str, str] = {}
        for c in reversed(self.mro(cls)):
            out.update(c.lock_attrs)
        return out

    def _module_function(
        self, ctx: ModuleContext, name: str
    ) -> Optional[FunctionInfo]:
        return self.functions.get(f"{ctx.rel_path}::{name}")

    def local_types(self, fn: ast.AST) -> Dict[str, Set[str]]:
        """Per-function poor-man's locals typing: `x = ClassName(...)`
        assignments and annotated parameters."""
        out: Dict[str, Set[str]] = {}
        args = getattr(fn, "args", None)
        if args is not None:
            for a in list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs):
                if a.annotation is not None:
                    names = self._class_names_in_annotation(a.annotation)
                    if names:
                        out[a.arg] = names
        for node in ast.walk(fn):
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
            ):
                ctor = self._callee_class_name(node.value)
                if ctor:
                    out.setdefault(node.targets[0].id, set()).add(ctor)
        return out

    # -------------------------------------------------------------- #
    # call resolution

    def resolve_call(
        self,
        call: ast.Call,
        scope: FunctionInfo,
        local_types: Optional[Dict[str, Set[str]]] = None,
    ) -> List[FunctionInfo]:
        """Possible project callees of `call` made from inside `scope`.
        Empty list = unresolved (external, dynamic, or builtin)."""
        f = call.func
        ctx = scope.module
        if isinstance(f, ast.Name):
            return self._resolve_name_call(f.id, ctx)
        if not isinstance(f, ast.Attribute):
            return []
        method = f.attr
        recv = f.value

        # self.m(...) — exact MRO lookup on the enclosing class
        if isinstance(recv, ast.Name) and recv.id == "self" and scope.class_name:
            for cls in self.resolve_class_name(scope.class_name, ctx):
                m = self.lookup_method(cls, method)
                if m is not None:
                    return [m]
            return []

        # receivers whose class set we can infer
        type_names: Set[str] = set()
        if isinstance(recv, ast.Name):
            if recv.id in self.by_class_name:
                # ClassName.m(...) unbound
                type_names.add(recv.id)
            elif recv.id in self._module_imports.get(ctx.rel_path, {}):
                # mod.f(...): only ever a module function of a PROJECT
                # module; externals resolve to nothing (never duck-typed)
                dotted = self._module_imports[ctx.rel_path][recv.id]
                target = self._module_by_dotted(dotted)
                if target is not None:
                    fn = self._module_function(target, method)
                    if fn is not None:
                        return [fn]
                    for cls in self.by_class_name.get(method, []):
                        if cls.module.rel_path == target.rel_path:
                            init = self.lookup_method(cls, "__init__")
                            return [init] if init else []
                return []
            elif local_types and recv.id in local_types:
                type_names |= local_types[recv.id]
        elif (
            isinstance(recv, ast.Attribute)
            and isinstance(recv.value, ast.Name)
            and recv.value.id == "self"
            and scope.class_name
        ):
            for cls in self.resolve_class_name(scope.class_name, ctx):
                type_names |= self.attr_types_of(cls, recv.attr)

        out: List[FunctionInfo] = []
        for tname in sorted(type_names):
            for cls in self.resolve_class_name(tname, ctx):
                m = self.lookup_method(cls, method)
                if m is not None and m not in out:
                    out.append(m)
        if out:
            return out

        # duck fallback: unique project definition, non-generic name
        if method not in _COMMON_METHOD_NAMES:
            owners = self._methods_by_name.get(method, [])
            if len(owners) == 1:
                return [owners[0][1]]
        return []

    def _resolve_name_call(
        self, name: str, ctx: ModuleContext
    ) -> List[FunctionInfo]:
        fn = self._module_function(ctx, name)
        if fn is not None:
            return [fn]
        for cls in self.resolve_class_name(name, ctx):
            init = self.lookup_method(cls, "__init__")
            if init is not None:
                return [init]
        return []

    def _module_by_dotted(self, dotted: str) -> Optional[ModuleContext]:
        """'elasticdl_tpu.master.journal' -> its ModuleContext (matched on
        the rel-path tail so partial trees still resolve)."""
        tail = dotted.replace(".", "/") + ".py"
        for m in self.modules:
            if m.rel_path == tail or m.rel_path.endswith("/" + tail):
                return m
        return None
