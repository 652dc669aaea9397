"""Runtime lock-order recording for the master control plane.

The static guarded-by pass proves accesses happen under *a* lock; it says
nothing about the order different threads take *several* locks in. The
master holds four independent locks (membership, dispatcher, process
manager, servicer) and three thread families (gRPC handler pool, watcher,
wait loop) — a new call path that nests two of them in opposite orders is
a deadlock that strikes only under load. This module makes the order
observable in tests:

    rec = LockOrderRecorder()
    rec.instrument(membership, name="membership")
    rec.instrument(dispatcher, name="dispatcher")
    ... drive the control plane ...
    rec.assert_no_cycles()

`instrument` replaces the object's `_lock` with a recording wrapper.
Every acquisition records edges {already-held lock} -> {acquired lock}
into one process-global-per-recorder directed graph; a cycle in that
graph is a lock-order inversion — a *potential* deadlock — even if the
run never actually deadlocked (the graph unions orders across threads,
which is exactly what wall-clock luck hides). With raise_on_cycle=True
(default) the offending acquire raises immediately, pointing at both
sites; the chaos smoke runs with it enabled so any inversion introduced
into the control plane fails tier-1 deterministically.

Re-entrant acquisition of the SAME recorded lock is reported as its own
violation. On a plain (non-reentrant) `threading.Lock` it ALWAYS raises —
even with raise_on_cycle=False — because proceeding would self-deadlock
the calling thread on the spot, hanging the test instead of failing it.
On an RLock (where proceeding is safe) it is recorded and raises only
under raise_on_cycle.
"""

from __future__ import annotations

import _thread
import threading
import traceback
from typing import Dict, List, Optional, Set, Tuple

#: lock types where re-acquisition by the holder deadlocks immediately
_NON_REENTRANT_TYPES = (_thread.LockType,)


class LockOrderViolation(RuntimeError):
    """A lock acquisition created a cycle in the acquisition-order graph."""


def _acquisition_site() -> str:
    """most-recent caller outside this module, as 'file:line (func)'."""
    for frame in reversed(traceback.extract_stack()[:-2]):
        if "lockorder" not in frame.filename:
            return f"{frame.filename}:{frame.lineno} ({frame.name})"
    return "<unknown>"


class _RecordingLock:
    """Wraps a lock, reporting acquire/release to the recorder.

    Supports the contexts the control plane uses: `with lock:` and
    explicit acquire()/release(). Only successful acquisitions create
    edges (a failed non-blocking try-acquire records nothing); when a
    successful acquire closes a cycle under raise_on_cycle, the lock is
    released again before the violation propagates, so the failing test
    does not strand it for other threads."""

    def __init__(self, inner, name: str, recorder: "LockOrderRecorder"):
        self._inner = inner
        self._name = name
        self._recorder = recorder

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._recorder._before_acquire(
            self._name, isinstance(self._inner, _NON_REENTRANT_TYPES)
        )
        got = self._inner.acquire(blocking, timeout)
        if got:
            try:
                self._recorder._acquired(self._name)
            except LockOrderViolation:
                self.release()   # inner lock AND held-stack entry
                raise
        return got

    def release(self) -> None:
        self._inner.release()
        self._recorder._released(self._name)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __getattr__(self, name: str):
        # Condition support: wait/wait_for/notify/notify_all pass through
        # to the wrapped primitive. wait() internally releases and
        # re-acquires the UNDERLYING lock without telling the recorder —
        # the held-stack deliberately keeps the lock "held" across the
        # wait, matching the lexical `with cv:` nesting the static
        # analyzer (EDL102) sees, so the two graphs stay comparable.
        return getattr(self._inner, name)


class LockOrderRecorder:
    def __init__(self, raise_on_cycle: bool = True):
        self.raise_on_cycle = raise_on_cycle
        # edge (held -> acquired) -> first acquisition site that created it
        self._edges: Dict[Tuple[str, str], str] = {}
        self._violations: List[str] = []
        self._meta = threading.Lock()
        self._held = threading.local()

    # -------------------------------------------------------------- #
    # instrumentation

    def wrap(self, lock, name: str) -> _RecordingLock:
        return _RecordingLock(lock, name, self)

    def instrument(self, obj, name: Optional[str] = None, attr: str = "_lock"):
        """Replace `obj.<attr>` with a recording wrapper (idempotent)."""
        lock = getattr(obj, attr)
        if isinstance(lock, _RecordingLock):
            return lock
        label = name if name is not None else f"{type(obj).__name__}{attr}"
        wrapped = self.wrap(lock, label)
        setattr(obj, attr, wrapped)
        return wrapped

    # -------------------------------------------------------------- #
    # recording

    def _held_stack(self) -> List[str]:
        stack = getattr(self._held, "stack", None)
        if stack is None:
            stack = []
            self._held.stack = stack
        return stack

    def _before_acquire(self, name: str, non_reentrant: bool) -> None:
        held = self._held_stack()
        if name in held:
            site = _acquisition_site()
            msg = (
                f"re-entrant acquisition of lock '{name}' at {site} "
                "(already held by this thread)"
            )
            if non_reentrant:
                # proceeding would self-deadlock THIS thread right here:
                # raising is the only outcome that fails the test instead
                # of hanging it, so observe mode doesn't apply
                with self._meta:
                    self._violations.append(msg + " — self-deadlock on a "
                                            "non-reentrant lock")
                raise LockOrderViolation(msg)
            self._record_violation(msg)

    def _acquired(self, name: str) -> None:
        """Record edges for a SUCCESSFUL acquire (failed try-acquires
        create none). Raises (after the caller releases the inner lock)
        when the new edge closes a cycle under raise_on_cycle."""
        held = self._held_stack()
        if name in held:       # re-entrant on an RLock: no edge, no push
            held.append(name)
            return
        site = _acquisition_site()
        try:
            with self._meta:
                for h in held:
                    edge = (h, name)
                    if edge not in self._edges:
                        self._edges[edge] = site
                        cycle = self._find_cycle(name, h)
                        if cycle is not None:
                            self._record_violation(
                                self._cycle_message(cycle, site), locked=True
                            )
        finally:
            # push even when raising: acquire() releases the inner lock on
            # violation and _released pops this entry, keeping the stack
            # balanced either way
            held.append(name)

    def _released(self, name: str) -> None:
        held = self._held_stack()
        if name in held:
            # remove the most recent acquisition (handles out-of-order
            # release, which threading.Lock permits)
            for i in range(len(held) - 1, -1, -1):
                if held[i] == name:
                    del held[i]
                    break

    def _record_violation(self, msg: str, locked: bool = False) -> None:
        if locked:
            self._violations.append(msg)
        else:
            with self._meta:
                self._violations.append(msg)
        if self.raise_on_cycle:
            raise LockOrderViolation(msg)

    # -------------------------------------------------------------- #
    # graph

    def _find_cycle(
        self, src: str, dst: str, edges: Optional[List[Tuple[str, str]]] = None
    ) -> Optional[List[str]]:
        """Path src -> ... -> dst in the edge graph (caller just added
        dst -> src, so such a path closes a cycle)."""
        edge_list = list(self._edges) if edges is None else edges
        stack = [(src, [src])]
        seen: Set[str] = set()
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            if node in seen:
                continue
            seen.add(node)
            for (a, b) in edge_list:
                if a == node:
                    stack.append((b, path + [b]))
        return None

    def _cycle_message(self, path: List[str], new_site: str) -> str:
        full = [path[-1]] + path   # dst -> src ... -> dst
        arrows = " -> ".join(full)
        sites = []
        for a, b in zip(full, full[1:]):
            sites.append(f"  {a} -> {b} first seen at {self._edges.get((a, b))}")
        return (
            f"lock-order inversion: cycle {arrows}\n"
            + "\n".join(sites)
            + f"\n  closing edge acquired at {new_site}"
        )

    # -------------------------------------------------------------- #
    # inspection

    def edges(self) -> Dict[Tuple[str, str], str]:
        with self._meta:
            return dict(self._edges)

    def violations(self) -> List[str]:
        with self._meta:
            return list(self._violations)

    def cycles(self) -> List[List[str]]:
        """All elementary order cycles currently in the graph."""
        with self._meta:
            edges = list(self._edges)
        out: List[List[str]] = []
        seen_cycles: Set[Tuple[str, ...]] = set()
        for (a, b) in edges:
            path = self._find_cycle(b, a, edges)
            if path is not None:
                cyc = [a] + path
                # canonicalize rotation so each cycle reports once
                nodes = cyc[:-1] if cyc[0] == cyc[-1] else cyc
                k = min(range(len(nodes)), key=lambda i: nodes[i])
                canon = tuple(nodes[k:] + nodes[:k])
                if canon not in seen_cycles:
                    seen_cycles.add(canon)
                    out.append(list(canon))
        return out

    def assert_no_cycles(self) -> None:
        vio = self.violations()
        cyc = self.cycles()
        if vio or cyc:
            raise LockOrderViolation(
                "lock-order violations:\n"
                + "\n".join(vio)
                + ("\ncycles: " + repr(cyc) if cyc else "")
            )


def instrument_master(
    recorder: LockOrderRecorder,
    membership=None,
    dispatcher=None,
    process_manager=None,
    servicer=None,
    evaluation=None,
    journal=None,
    autoscaler=None,
) -> LockOrderRecorder:
    """Instrument the standard master-side locks under their canonical
    names (the chaos smoke, the fleet soak, and the lock-order tests all
    share this wiring — and EDL102's CANONICAL_LOCK_NAMES mirrors it, so
    the static lock graph and the runtime edges use one vocabulary)."""
    if membership is not None:
        recorder.instrument(membership, name="membership")
    if dispatcher is not None:
        recorder.instrument(dispatcher, name="dispatcher")
    if process_manager is not None:
        recorder.instrument(process_manager, name="process_manager")
    if servicer is not None:
        recorder.instrument(servicer, name="servicer.loss", attr="_loss_lock")
        if hasattr(servicer, "_ctrl_lock"):
            recorder.instrument(servicer, name="servicer.ctrl", attr="_ctrl_lock")
    if evaluation is not None:
        recorder.instrument(evaluation, name="evaluation")
    if journal is not None:
        recorder.instrument(journal, name="journal.file")
        if hasattr(journal, "_qcv"):
            recorder.instrument(journal, name="journal.queue", attr="_qcv")
    if autoscaler is not None:
        recorder.instrument(autoscaler, name="autoscaler")
    return recorder
