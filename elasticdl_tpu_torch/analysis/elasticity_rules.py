"""EDL5xx: elasticity / closed-loop-autoscaler discipline.

EDL501 rescale-action-outside-policy
    A direct instance-manager resize/evict call — `.add_worker()`,
    `.remove_worker(...)`, `.evict_worker(...)`, or
    `.kill_worker(..., relaunch=False)` (the permanent-eviction
    spelling) — outside the sanctioned modules: the autoscaler policy
    engine (master/autoscaler.py), the operator entry points
    (client/local.py, client/api.py), and the manager implementations
    themselves. ISSUE 14 made every rescale decision cost-gated,
    cooldown-bounded, and journal-replayed; an ad-hoc call site
    bypasses all three at once — it can flap against the policy's own
    actions, double-fire after a master restart (nothing journaled it),
    and spend recovery cost the goodput ledger attributes to nobody.
    Route the action through `Autoscaler`/its target adapters, or carry
    a reviewed `# edl-lint: disable=EDL501` with justification.

    Receiver gating (so unrelated `.add_worker` methods stay quiet):
    the call's receiver must be manager-ish — a name (or attribute)
    matching `manager`/`mgr`, or a local name assigned from a
    `ProcessManager(...)` / `K8sInstanceManager(...)` construction in
    the same module. `kill_worker` with `relaunch=True` (or omitted) is
    the chaos/test hook — an in-place relaunch, not a resize — and is
    not flagged.

EDL503 layout-mutation-outside-policy
    A direct embedding-layout mutation on the shard-map owner —
    `.update_replicas(...)`, `.set_hot_ids(...)`, `.begin_split()`, or
    `.begin_merge()` — outside the sanctioned modules: the layout
    policy engine (master/layout_controller.py) and the owner
    implementation itself (embedding/sharding.py). ISSUE 20 made every
    layout decision cost-gated (blocked-read-seconds), per-kind
    cooldown-bounded, and journal-replayed (`layout` records); an
    ad-hoc call site bypasses all three — it can flap against the
    controller's own actions, double-fire after a master takeover
    (nothing journaled the DECISION, only the map transition), and
    stall the read path with a migration the cost model never priced.
    Route the mutation through `LayoutController`/its target adapters,
    or carry a reviewed `# edl-lint: disable=EDL503` with
    justification. (`begin_resharding` — the worker-death re-plan — is
    NOT a layout action and stays unflagged.)

    Receiver gating mirrors EDL501: the receiver must be owner-ish — a
    name (or attribute) matching `owner`/`embedding`/`shard_map` — or a
    local name assigned from a `ShardMapOwner(...)` construction in the
    same module.

EDL502 sleep-in-simulated-time
    A bare `time.sleep(...)` (or `sleep(...)` imported from `time`)
    inside `elasticdl_tpu_torch/fleetsim/`. The fleet simulator runs on a
    virtual clock (ISSUE 16): every delay must be an event scheduled
    via `Scheduler.after(...)` / `Scheduler.at(...)` so the clock can
    jump over it. A real sleep burns wall time inside the compressed
    run (a 600 s scenario stops finishing in seconds), dodges the
    deterministic heap ordering that makes same-seed runs digest-
    identical, and silently skews the REAL costs measured around it
    (journal fsync, poll-phase walls). Schedule the delay, or carry a
    reviewed `# edl-lint: disable=EDL502` (e.g. a deliberate wall-time
    throttle in the CLI layer, outside the simulated run).
"""

from __future__ import annotations

import ast
import re
from typing import Iterator, Set

from elasticdl_tpu_torch.analysis.core import Finding, ModuleContext, Rule, register

#: always resize/evict, whatever the arguments
_RESIZE_METHODS = {"add_worker", "remove_worker", "evict_worker"}

#: the manager classes whose constructions track receivers
_MANAGER_CLASSES = {"ProcessManager", "K8sInstanceManager"}

#: modules where direct calls are the sanctioned path: the policy
#: engine, the operator entry points, and the implementations
_ALLOWED_SUFFIXES = (
    "master/autoscaler.py",
    "master/process_manager.py",
    "master/k8s_instance_manager.py",
    "client/local.py",
    "client/api.py",
)

_MANAGERISH = re.compile(r"(manager|mgr)", re.IGNORECASE)


def _receiver_name(expr: ast.AST) -> str:
    """The receiver's trailing name: `manager` -> manager,
    `self.instance_manager` -> instance_manager, `a.b.mgr` -> mgr."""
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        return expr.attr
    return ""


def _is_manager_construction(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    name = f.id if isinstance(f, ast.Name) else (
        f.attr if isinstance(f, ast.Attribute) else "")
    return name in _MANAGER_CLASSES


def _relaunch_false(call: ast.Call) -> bool:
    """kill_worker's eviction spelling: relaunch=False, literally."""
    for kw in call.keywords:
        if kw.arg == "relaunch" and isinstance(kw.value, ast.Constant):
            return kw.value.value is False
    # positional: kill_worker(wid, False, ...)
    if len(call.args) >= 2 and isinstance(call.args[1], ast.Constant):
        return call.args[1].value is False
    return False


@register
class RescaleActionOutsidePolicyRule(Rule):
    id = "EDL501"
    name = "rescale-action-outside-policy"
    doc = (
        "direct instance-manager resize/evict call outside the "
        "autoscaler policy / client entry points — bypasses the cost "
        "gate, cooldown, and decision journal"
    )

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if ctx.rel_path.endswith(_ALLOWED_SUFFIXES):
            return
        tracked = self._constructed_managers(ctx)
        for node in ast.walk(ctx.tree):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
            ):
                continue
            method = node.func.attr
            if method in _RESIZE_METHODS:
                evictish = True
            elif method == "kill_worker" and _relaunch_false(node):
                evictish = True
            else:
                evictish = False
            if not evictish:
                continue
            recv = _receiver_name(node.func.value)
            if not (
                recv in tracked
                or _MANAGERISH.search(recv)
                or _is_manager_construction(node.func.value)
            ):
                continue
            yield self.finding(
                ctx, node,
                f"direct {method}() on an instance manager bypasses the "
                "autoscaler's cost gate, cooldown, and decision journal; "
                "route the rescale through master/autoscaler.py (or carry "
                "a reviewed disable)",
            )

    @staticmethod
    def _constructed_managers(ctx: ModuleContext) -> Set[str]:
        names: Set[str] = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Assign) and _is_manager_construction(
                node.value
            ):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        names.add(t.id)
                    elif isinstance(t, ast.Attribute):
                        names.add(t.attr)
        return names


#: the four journaled layout transitions on ShardMapOwner — the whole
#: mutation surface the layout controller owns (begin_resharding is the
#: worker-death re-plan, not a layout action)
_LAYOUT_METHODS = {
    "update_replicas", "set_hot_ids", "begin_split", "begin_merge",
}

#: modules where direct layout calls are the sanctioned path
_LAYOUT_ALLOWED_SUFFIXES = (
    "master/layout_controller.py",
    "embedding/sharding.py",
)

_OWNERISH = re.compile(r"(owner|embedding|shard_map)", re.IGNORECASE)


def _is_owner_construction(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    name = f.id if isinstance(f, ast.Name) else (
        f.attr if isinstance(f, ast.Attribute) else "")
    return name == "ShardMapOwner"


@register
class LayoutMutationOutsidePolicyRule(Rule):
    id = "EDL503"
    name = "layout-mutation-outside-policy"
    doc = (
        "direct shard-map layout mutation outside the layout policy "
        "engine — bypasses the cost gate, per-kind cooldown, and "
        "journaled decision history"
    )

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if ctx.rel_path.endswith(_LAYOUT_ALLOWED_SUFFIXES):
            return
        tracked = self._constructed_owners(ctx)
        for node in ast.walk(ctx.tree):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _LAYOUT_METHODS
            ):
                continue
            recv = _receiver_name(node.func.value)
            if not (
                recv in tracked
                or _OWNERISH.search(recv)
                or _is_owner_construction(node.func.value)
            ):
                continue
            yield self.finding(
                ctx, node,
                f"direct {node.func.attr}() on the shard-map owner "
                "bypasses the layout controller's cost gate, per-kind "
                "cooldown, and journaled decision history; route the "
                "mutation through master/layout_controller.py (or carry "
                "a reviewed disable)",
            )

    @staticmethod
    def _constructed_owners(ctx: ModuleContext) -> Set[str]:
        names: Set[str] = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Assign) and _is_owner_construction(
                node.value
            ):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        names.add(t.id)
                    elif isinstance(t, ast.Attribute):
                        names.add(t.attr)
        return names


#: the virtual-time package: every module under here runs (or builds
#: objects that run) inside the scenario scheduler's compressed clock
_FLEETSIM_PREFIX = "elasticdl_tpu_torch/fleetsim/"


def _is_time_sleep(node: ast.Call, time_sleep_names: Set[str]) -> bool:
    """`time.sleep(...)` / `<alias>.sleep(...)` where the receiver is
    the `time` module, or a bare `sleep(...)` imported from `time`."""
    f = node.func
    if isinstance(f, ast.Attribute) and f.attr == "sleep":
        return isinstance(f.value, ast.Name) and f.value.id in time_sleep_names
    if isinstance(f, ast.Name):
        return f.id in time_sleep_names and f.id != "time"
    return False


@register
class SleepInSimulatedTimeRule(Rule):
    id = "EDL502"
    name = "sleep-in-simulated-time"
    doc = (
        "bare time.sleep inside the fleet simulator — burns wall time "
        "the virtual clock is supposed to jump over and breaks "
        "same-seed determinism; schedule the delay on the event heap"
    )

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if _FLEETSIM_PREFIX not in ctx.rel_path:
            return
        names = self._time_module_names(ctx)
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call) and _is_time_sleep(node, names):
                yield self.finding(
                    ctx, node,
                    "time.sleep() inside elasticdl_tpu_torch/fleetsim/ burns "
                    "real wall time in a virtual-clock run and breaks "
                    "same-seed determinism; schedule the delay via "
                    "Scheduler.after()/at() (or carry a reviewed disable)",
                )

    @staticmethod
    def _time_module_names(ctx: ModuleContext) -> Set[str]:
        """Names that resolve to the `time` module or its `sleep`:
        `import time` / `import time as t` / `from time import sleep
        [as snooze]`."""
        names: Set[str] = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "time":
                        names.add(a.asname or a.name)
            elif isinstance(node, ast.ImportFrom) and node.module == "time":
                for a in node.names:
                    if a.name == "sleep":
                        names.add(a.asname or a.name)
        return names
