"""Shard math + the master-owned, journal-durable embedding shard map.

Id -> shard: `shard_of(id) = id % num_shards` on the hashed id space —
the reference's `id % ps_num` (elasticdl/python/worker/ps_client.py).
Vocab ids in this repo are already hash-bucketed at preprocessing time
(api/preprocessing.hashing), so the modulo IS `hash(id) % num_shards`
with the identity as the final mix, and it buys what a fresh hash could
not: a dense per-shard row space (`local = id // num_shards`) that the
fused gather / scatter-add kernels can address contiguously.

Shard -> owner: the master assigns shards to workers round-robin and
rebalances on world change with MINIMAL MOVEMENT (`plan_moves`): a shard
whose owner survives stays put; only shards stranded on dead workers or
pulled for balance migrate. Every map transition is committed through
the control-plane journal (`emb_shard_map` / `emb_reshard_begin` /
`emb_reshard_commit` records) so a master crash mid-resharding replays
to a CONSISTENT map: a begun-but-uncommitted resharding rolls back to
the pre-move assignment and flags `reshard_interrupted`, which clients
treat as "conservatively requeue in-flight pushes" (exactly-once is
preserved by the stores' per-client sequence fencing either way).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from elasticdl_tpu_torch.common.log_utils import default_logger
from elasticdl_tpu_torch.observability import tracing
from elasticdl_tpu_torch.observability.registry import default_registry

logger = default_logger(__name__)

_reg = default_registry()
_MAP_VERSION = _reg.gauge(
    "edl_embedding_shard_map_version", "current embedding shard map version")
_RESHARDS = _reg.counter(
    "edl_embedding_reshards_total", "committed resharding transitions")
_SHARDS_MOVED = _reg.counter(
    "edl_embedding_shards_moved_total", "shard migrations committed")
_RESHARD_ROLLBACKS = _reg.counter(
    "edl_embedding_reshard_rollbacks_total",
    "reshardings rolled back at journal replay (master died mid-move)")


def shard_of(ids: Any, num_shards: int):
    """Owning shard per id (vectorized). ids are hashed-vocab ints; the
    modulo is the reference's `id % ps_num` placement."""
    return np.asarray(ids) % num_shards


def local_rows(ids: Any, num_shards: int):
    """Row index inside the owning shard's dense local table."""
    return np.asarray(ids) // num_shards


def shard_row_count(padded_vocab: int, num_shards: int) -> int:
    """Rows every shard allocates (uniform: shards are interchangeable
    migration units; the ceil padding is dead rows on the tail shards)."""
    return -(-padded_vocab // num_shards)


@dataclass(frozen=True)
class TableSpec:
    """One tier table: geometry + deterministic init.

    `vocab` is the PADDED row count (ops/embedding.padded_vocab — the
    same geometry rule checkpoints bake). `seed` makes shard creation
    reproducible on any owner: a shard materialized fresh is bit-identical
    wherever it is built, so bootstrap needs no transfer."""

    name: str
    vocab: int
    dim: int
    seed: int = 0
    init_scale: float = 0.05

    def to_wire(self) -> Dict[str, Any]:
        return {"name": self.name, "vocab": self.vocab, "dim": self.dim,
                "seed": self.seed, "init_scale": self.init_scale}

    @staticmethod
    def from_wire(d: Dict[str, Any]) -> "TableSpec":
        return TableSpec(
            name=str(d["name"]), vocab=int(d["vocab"]), dim=int(d["dim"]),
            seed=int(d.get("seed", 0)),
            init_scale=float(d.get("init_scale", 0.05)),
        )


@dataclass(frozen=True)
class ShardMapView:
    """An immutable snapshot of the shard map a client operates under.

    `version` fences the data plane: pulls/pushes carry it, and an owner
    serving a different version rejects the call so a client can never
    write through a stale map (the resharding exactly-once contract)."""

    version: int
    num_shards: int
    owners: Tuple[int, ...]                 # shard id -> owner worker id
    tables: Tuple[TableSpec, ...] = ()
    resharding: bool = False                # a move plan is in flight
    # shard id -> READ-replica worker ids (possibly empty): replicas
    # serve pulls within the staleness bound; writes stay primary-only.
    # Committed next to `owners` in the same journal records, so a
    # successor master replays the replica map identically.
    replicas: Tuple[Tuple[int, ...], ...] = ()
    # owner ADDRESS BOOK (ISSUE 15): (worker id, data-plane endpoint)
    # pairs for workers serving an embedding/data_plane.py endpoint —
    # sourced from registration, ridden on the shard-map response, and
    # adopted by GrpcTransport.update_addresses at every client refresh.
    # Empty for local-transport deployments.
    addrs: Tuple[Tuple[int, str], ...] = ()
    # ultra-hot id set (ISSUE 20): sketch-head ids the layout controller
    # promoted to worker-replicated status. Clients PIN these rows in
    # their hot-row cache (refreshed through the same watermark fence as
    # any cached row); demotion shrinks the tuple. Journaled beside the
    # map so a successor master replays the same promotion state.
    hot_ids: Tuple[int, ...] = ()

    def owner_of(self, shard: int) -> int:
        return self.owners[shard]

    def replicas_of(self, shard: int) -> Tuple[int, ...]:
        return self.replicas[shard] if shard < len(self.replicas) else ()

    def shards_owned_by(self, owner: int) -> List[int]:
        return [s for s, o in enumerate(self.owners) if o == owner]

    def shards_replicated_on(self, owner: int) -> List[int]:
        return [s for s, r in enumerate(self.replicas) if owner in r]


@dataclass(frozen=True)
class ShardMove:
    """One planned migration: shard `shard` leaves `src` for `dst`.
    `src < 0` means the donor is DEAD — the recipient restores the shard
    from the tier checkpoint (or re-materializes from the table seed if
    no checkpoint exists) instead of a live transfer.

    `kind` (ISSUE 20) widens the move vocabulary for layout actions:

    - ``"move"``  — the classic cross-owner migration above;
    - ``"split"`` — `shard` is a CHILD id under the DOUBLED shard count;
      `parent` names the parent shard whose resident rows the owner
      re-interleaves locally (store.split_resident) — no cross-owner
      transfer, but the recipient still confirms through the same
      two-phase handshake so a crash mid-split rolls back;
    - ``"merge"`` — `shard` is a PARENT id under the HALVED count; the
      owner folds its two co-resident children back together.

    Defaulted fields keep `from_wire` compatible with pre-split journal
    records."""

    shard: int
    src: int
    dst: int
    kind: str = "move"
    parent: int = -1

    def to_wire(self) -> Dict[str, int]:
        out = {"shard": self.shard, "src": self.src, "dst": self.dst}
        if self.kind != "move":
            out["kind"] = self.kind
            out["parent"] = self.parent
        return out

    @staticmethod
    def from_wire(d: Dict[str, Any]) -> "ShardMove":
        return ShardMove(
            int(d["shard"]), int(d["src"]), int(d["dst"]),
            kind=str(d.get("kind", "move")), parent=int(d.get("parent", -1)),
        )


def assign_round_robin(num_shards: int, owners: Sequence[int]) -> List[int]:
    """Initial placement: shard s -> owners[s % len(owners)]."""
    owners = sorted(owners)
    if not owners:
        raise ValueError("embedding tier needs at least one owner")
    return [owners[s % len(owners)] for s in range(num_shards)]


def plan_moves(
    current: Sequence[int], new_owners: Sequence[int],
    dead: Sequence[int] = (),
    prefer: Optional[Dict[int, int]] = None,
) -> List[ShardMove]:
    """Minimal-movement rebalance of `current` (shard -> owner) onto the
    surviving/new owner set.

    Invariants: (1) a shard whose owner survives moves only if the
    balance demands it; (2) stranded shards (leaving owner) are assigned
    first, to the least-loaded survivors; (3) the result is balanced to
    within one shard per owner. Deterministic (sorted owner order) so
    every process computing the same inputs plans the same moves.

    `dead` names owners KNOWN dead (reaped by membership): their shards
    get ``src = -1`` (restore-from-checkpoint moves). An owner merely
    LEAVING the set (planned shrink) stays the live donor — its shards
    transfer device-to-device before it goes; if it turns out
    unreachable anyway, reshard.apply_moves falls back to the
    checkpoint/seed restore path per shard.

    `prefer` maps a stranded shard to the survivor that should take it
    when the balance allows — the replica-promotion hint (ISSUE 13): a
    dead owner's shard lands on a worker already holding a synced read
    replica, so recovery installs by promotion instead of copy."""
    new_owners = sorted(set(new_owners))
    if not new_owners:
        raise ValueError("cannot rebalance onto an empty owner set")
    dead = set(dead)
    prefer = prefer or {}
    n = len(current)
    target_cap = -(-n // len(new_owners))
    load: Dict[int, int] = {o: 0 for o in new_owners}
    keep: List[Tuple[int, int]] = []      # (shard, surviving owner)
    stranded: List[Tuple[int, int]] = []  # (shard, donor or -1)
    for s, o in enumerate(current):
        if o in load:
            keep.append((s, o))
        else:
            stranded.append((s, -1 if o in dead else o))
    # survivors keep up to the balanced capacity; overflow shards move
    moves: List[ShardMove] = []
    overflow: List[Tuple[int, int]] = []
    for s, o in keep:
        if load[o] < target_cap:
            load[o] += 1
        else:
            overflow.append((s, o))
    def least_loaded() -> int:
        return min(new_owners, key=lambda o: (load[o], o))
    for s, src in stranded:
        pref = prefer.get(s)
        if pref is not None and pref in load and load[pref] < target_cap:
            dst = pref
        else:
            dst = least_loaded()
        load[dst] += 1
        moves.append(ShardMove(shard=s, src=src, dst=dst))
    for s, src in overflow:
        dst = least_loaded()
        load[dst] += 1
        moves.append(ShardMove(shard=s, src=src, dst=dst))
    return moves


def assign_replicas(
    owners: Sequence[int], pool: Sequence[int],
    replica_count: Any,
    current: Sequence[Sequence[int]] = (),
) -> List[List[int]]:
    """Per-shard read-replica assignment: up to `replica_count` workers
    per shard drawn from `pool`, never the shard's own primary,
    deterministic (sorted pool, shard-rotated) so every process planning
    from the same inputs lands the same map. Replicas already holding
    the shard (`current`, the pre-transition assignment) are kept when
    still eligible — a synced copy is worth more than a balanced one.

    `replica_count` is an int (uniform fan-out, the PR 13 contract) or a
    per-shard sequence of ints (ISSUE 20: the layout controller's
    skew-adaptive fan-out — hot shards get more read copies, cold
    shards drop to primary-only)."""
    pool = sorted(set(pool))
    if isinstance(replica_count, (list, tuple)):
        per_shard = [int(c) for c in replica_count]
        if len(per_shard) != len(owners):
            raise ValueError(
                f"per-shard replica counts ({len(per_shard)}) must match "
                f"num_shards ({len(owners)})"
            )
    else:
        per_shard = [int(replica_count)] * len(owners)
    out: List[List[int]] = []
    for s, p in enumerate(owners):
        cands = [o for o in pool if o != p]
        rc = min(per_shard[s], len(cands))
        if rc <= 0:
            out.append([])
            continue
        prior = list(current[s]) if s < len(current) else []
        kept = [o for o in prior if o in cands][:rc]
        rest = [o for o in cands if o not in kept]
        start = s % len(rest) if rest else 0
        rot = rest[start:] + rest[:start]
        out.append(kept + rot[: rc - len(kept)])
    return out


def apply_moves_to_assignment(
    current: Sequence[int], moves: Sequence[ShardMove],
) -> List[int]:
    out = list(current)
    for m in moves:
        out[m.shard] = m.dst
    return out


class ShardMapOwner:
    """The master's authoritative shard map, durable through the journal.

    Lifecycle: `bootstrap(owners)` assigns the initial map (journaled as
    `emb_shard_map`); `begin_resharding(new_owners)` plans minimal moves
    and journals `emb_reshard_begin` (the map version bumps and the view
    flips `resharding=True` — clients hold pushes or carry the fence);
    recipients confirm installed shards via `confirm_moves` (the servicer
    RPC lands here) and when the plan is fully confirmed the owner
    journals `emb_reshard_commit` and the new map becomes plain current.

    Crash semantics: replay of a begin WITHOUT its commit rolls back to
    the pre-move map (`restore_from_replay`) and marks the replayed state
    `reshard_interrupted` — the successor master re-plans against the
    live membership, and clients requeue unconfirmed pushes (store-side
    sequence fencing dedupes any that actually landed).

    Lock order: _lock -> journal queue (the journal never calls back).
    The ack-after-fsync discipline matches dispatcher/membership: journal
    commits are enqueued inside `_lock` and waited AFTER release, before
    the transition is acknowledged to any caller.
    """

    def __init__(self, num_shards: int, journal=None,
                 replica_count: int = 0):
        if num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        if replica_count < 0:
            raise ValueError("replica_count must be >= 0")
        self.num_shards = num_shards
        self.replica_count = replica_count
        self._journal = journal
        self._lock = threading.Lock()
        # tables enter ONLY via register_table (journaled) or
        # restore_from_replay — a ctor shortcut would silently skip the
        # journal and lose the table specs at master takeover
        self._tables: Dict[str, TableSpec] = {}  # guarded_by: _lock
        self._owners: List[int] = []             # guarded_by: _lock
        self._replicas: List[List[int]] = []     # guarded_by: _lock
        self._hot_ids: List[int] = []            # guarded_by: _lock
        self._version = 0                        # guarded_by: _lock
        # per-shard replica targets, set ONLY by the layout controller
        # (None = uniform self.replica_count everywhere)
        self._replica_counts: Optional[List[int]] = None  # guarded_by: _lock
        self._pending: Optional[Dict[str, Any]] = None  # guarded_by: _lock
        self._interrupted = False                # guarded_by: _lock
        self._listeners: List[Callable[[ShardMapView], None]] = []

    # -------------------------------------------------------------- #
    # construction / recovery

    def restore_from_replay(self, state) -> None:
        """Adopt the journal's replayed map (master takeover; `state` is
        a master/journal.py EmbeddingState). A mid-flight resharding was
        already rolled back by the replay; the `reshard_interrupted`
        flag survives so `view()` advertises it until the next committed
        transition."""
        with self._lock:
            self.num_shards = state.num_shards or self.num_shards
            self._owners = list(state.owners)
            self._replicas = [
                list(r) for r in getattr(state, "replicas", [])
            ]
            self._hot_ids = [
                int(i) for i in getattr(state, "hot_ids", [])
            ]
            counts = getattr(state, "replica_counts", None)
            self._replica_counts = (
                [int(c) for c in counts] if counts else None
            )
            self._version = state.version
            self._tables = {
                t["name"]: TableSpec.from_wire(t) for t in state.tables
            }
            self._interrupted = state.reshard_interrupted
            version = self._version
        if state.reshard_interrupted:
            _RESHARD_ROLLBACKS.inc()
            logger.warning(
                "embedding shard map recovered MID-RESHARDING: rolled back "
                "to committed map v%d; clients must requeue in-flight "
                "pushes (sequence fencing dedupes re-sends)", state.version,
            )
        _MAP_VERSION.set(version)

    # -------------------------------------------------------------- #

    def add_listener(self, fn: Callable[[ShardMapView], None]) -> None:
        """Called with the new view after every committed transition
        (exceptions swallowed — listeners are advisory)."""
        self._listeners.append(fn)

    def register_table(self, spec: TableSpec) -> None:
        commit = None
        with self._lock:
            if spec.name in self._tables:
                if self._tables[spec.name] != spec:
                    raise ValueError(
                        f"table {spec.name!r} already registered with a "
                        "different spec"
                    )
                return
            self._tables[spec.name] = spec
            if self._journal is not None:
                commit = self._journal.append("emb_table", **spec.to_wire())
        if commit is not None:
            commit.wait()

    def bootstrap(self, owners: Sequence[int]) -> ShardMapView:
        """First placement (idempotent: re-bootstrapping with a live map
        is a no-op returning the current view)."""
        commit = None
        with self._lock:
            if self._owners:
                return self._view_locked()
            self._owners = assign_round_robin(self.num_shards, owners)
            self._replicas = assign_replicas(
                self._owners, sorted(set(owners)), self.replica_count)
            self._version = 1
            self._interrupted = False
            if self._journal is not None:
                commit = self._journal.append(
                    "emb_shard_map", version=self._version,
                    num_shards=self.num_shards, owners=list(self._owners),
                    replicas=[list(r) for r in self._replicas],
                )
            view = self._view_locked()
        if commit is not None:
            # ack-after-fsync: the map is not served before it is durable
            commit.wait()
        _MAP_VERSION.set(view.version)
        self._notify(view)
        return view

    # -------------------------------------------------------------- #
    # resharding

    def begin_resharding(
        self, new_owners: Sequence[int], dead: Sequence[int] = (),
    ) -> Tuple[ShardMapView, List[ShardMove]]:
        """Plan minimal moves onto `new_owners` and journal the intent.
        Returns (pending view, moves). No-op (current view, []) when the
        assignment is already exactly servable by `new_owners`."""
        commit = None
        with self._lock:
            if not self._owners:
                raise RuntimeError("begin_resharding before bootstrap")
            if self._pending is not None:
                raise RuntimeError(
                    "resharding already in flight (version "
                    f"{self._pending['version']})"
                )
            # replica-promotion preference: a dead owner's shard goes to
            # a surviving replica holder when the balance allows — the
            # recipient promotes its synced copy instead of copying
            alive = set(new_owners)
            prefer: Dict[int, int] = {}
            for s, o in enumerate(self._owners):
                if o in alive:
                    continue
                for r in (self._replicas[s]
                          if s < len(self._replicas) else []):
                    if r in alive:
                        prefer[s] = r
                        break
            moves = plan_moves(self._owners, new_owners, dead, prefer)
            if not moves:
                return self._view_locked(), []
            version = self._version + 1
            new_assignment = apply_moves_to_assignment(self._owners, moves)
            new_replicas = assign_replicas(
                new_assignment, sorted(alive),
                (self._replica_counts if self._replica_counts is not None
                 else self.replica_count),
                current=self._replicas,
            )
            self._pending = {
                "version": version,
                "moves": moves,
                "confirmed": set(),
                "prior_owners": list(self._owners),
                "prior_replicas": [list(r) for r in self._replicas],
            }
            self._owners = new_assignment
            self._replicas = new_replicas
            self._version = version
            if self._journal is not None:
                commit = self._journal.append(
                    "emb_reshard_begin", version=version,
                    num_shards=self.num_shards,
                    owners=list(self._owners),
                    replicas=[list(r) for r in self._replicas],
                    moves=[m.to_wire() for m in moves],
                )
            view = self._view_locked()
        if commit is not None:
            commit.wait()
        tracing.event(
            "embedding.reshard_begin", version=view.version,
            moves=len(moves),
        )
        logger.warning(
            "embedding resharding v%d: %d shard move(s) planned",
            view.version, len(moves),
        )
        self._notify(view)
        return view, moves

    def confirm_moves(
        self, version: int, shard_ids: Sequence[int],
    ) -> bool:
        """A recipient installed these shards (servicer RPC). Returns
        True when accepted (version matches the in-flight plan; an
        already-confirmed shard is idempotent). The plan commits — one
        `emb_reshard_commit` journal record, acked after fsync — when
        every planned move is confirmed."""
        commit = None
        committed_view = None
        with self._lock:
            p = self._pending
            if p is None or p["version"] != version:
                # a stale confirm (pre-crash, or re-sent after commit):
                # harmless if the map already moved past it
                return p is None and version <= self._version
            p["confirmed"].update(int(s) for s in shard_ids)
            planned = {m.shard for m in p["moves"]}
            if planned <= p["confirmed"]:
                self._pending = None
                self._interrupted = False
                if self._journal is not None:
                    commit = self._journal.append(
                        "emb_reshard_commit", version=version,
                    )
                committed_view = self._view_locked()
                moved = len(planned)
        if commit is not None:
            commit.wait()
        if committed_view is not None:
            _RESHARDS.inc()
            _SHARDS_MOVED.inc(moved)
            _MAP_VERSION.set(committed_view.version)
            tracing.event(
                "embedding.reshard_commit", version=version, moves=moved,
            )
            logger.warning(
                "embedding resharding v%d COMMITTED (%d shard(s) moved)",
                version, moved,
            )
            self._notify(committed_view)
        return True

    def pending_moves(self) -> List[ShardMove]:
        with self._lock:
            return list(self._pending["moves"]) if self._pending else []

    # -------------------------------------------------------------- #
    # layout actions — driven by master/layout_controller.py (ISSUE 20).
    # edl-lint EDL503 flags calls to these from anywhere else: ad-hoc
    # layout mutation bypasses the cost gate, the cooldowns, and the
    # journaled decision history a master takeover replays.

    def update_replicas(
        self, replica_counts: Sequence[int], pool: Sequence[int],
    ) -> ShardMapView:
        """Re-fan replica assignments to per-shard targets (single
        phase: replicas are pull-only, so no exactly-once fence is
        needed — the version bump routes clients, and a pull landing on
        a not-yet-installed replica falls back to the primary through
        the existing degraded ladder). Journaled as `emb_replica_map`;
        the targets stick across later reshardings until the controller
        changes them again."""
        commit = None
        with self._lock:
            if not self._owners:
                raise RuntimeError("update_replicas before bootstrap")
            if self._pending is not None:
                raise RuntimeError(
                    "update_replicas during in-flight resharding"
                )
            counts = [max(0, int(c)) for c in replica_counts]
            if len(counts) != self.num_shards:
                raise ValueError(
                    f"replica_counts has {len(counts)} entries for "
                    f"{self.num_shards} shards"
                )
            self._replica_counts = counts
            self._replicas = assign_replicas(
                self._owners, sorted(set(pool)), counts,
                current=self._replicas,
            )
            self._version += 1
            if self._journal is not None:
                commit = self._journal.append(
                    "emb_replica_map", version=self._version,
                    replicas=[list(r) for r in self._replicas],
                    replica_counts=list(counts),
                )
            view = self._view_locked()
        if commit is not None:
            commit.wait()
        _MAP_VERSION.set(view.version)
        tracing.event("embedding.replica_map", version=view.version)
        self._notify(view)
        return view

    def set_hot_ids(self, ids: Sequence[int]) -> ShardMapView:
        """Publish the ultra-hot id set (promotion/demotion is the
        controller's call; this just makes it durable and visible).
        Single phase for the same reason as `update_replicas`: hot-id
        pinning only changes what clients CACHE, never where writes
        land."""
        commit = None
        with self._lock:
            if self._pending is not None:
                raise RuntimeError("set_hot_ids during in-flight resharding")
            hot = sorted({int(i) for i in ids})
            if hot == self._hot_ids:
                return self._view_locked()
            self._hot_ids = hot
            self._version += 1
            if self._journal is not None:
                commit = self._journal.append(
                    "emb_hot_ids", version=self._version,
                    hot_ids=list(hot),
                )
            view = self._view_locked()
        if commit is not None:
            commit.wait()
        _MAP_VERSION.set(view.version)
        self._notify(view)
        return view

    def begin_split(self) -> Tuple[ShardMapView, List[ShardMove]]:
        """Double the shard count: every parent shard s splits in place
        into children s and s + old_n on the SAME owner (id g lands in
        shard g % 2n, which is s or s + n for every g that was in s —
        no rows change hosts, so the 'move' is a local re-key). Runs
        through the ordinary two-phase begin→confirm→commit fence:
        owners confirm the child ids once `store.split_resident` has
        re-keyed rows, watermarks, and delta logs. Replicas are dropped
        (their keyspace just changed); the controller re-fans them out
        as a separate, cost-gated action."""
        commit = None
        with self._lock:
            if not self._owners:
                raise RuntimeError("begin_split before bootstrap")
            if self._pending is not None:
                raise RuntimeError("split during in-flight resharding")
            old_n = self.num_shards
            new_n = old_n * 2
            version = self._version + 1
            new_owners = list(self._owners) * 2
            moves = []
            for s, o in enumerate(self._owners):
                moves.append(ShardMove(s, o, o, kind="split", parent=s))
                moves.append(
                    ShardMove(s + old_n, o, o, kind="split", parent=s))
            self._pending = {
                "version": version,
                "moves": moves,
                "confirmed": set(),
                "prior_owners": list(self._owners),
                "prior_replicas": [list(r) for r in self._replicas],
                "prior_num_shards": old_n,
            }
            self.num_shards = new_n
            self._owners = new_owners
            self._replicas = [[] for _ in range(new_n)]
            self._replica_counts = None
            self._version = version
            if self._journal is not None:
                commit = self._journal.append(
                    "emb_reshard_begin", version=version,
                    num_shards=new_n,
                    owners=list(self._owners),
                    replicas=[list(r) for r in self._replicas],
                    moves=[m.to_wire() for m in moves],
                )
            view = self._view_locked()
        if commit is not None:
            commit.wait()
        tracing.event(
            "embedding.split_begin", version=view.version,
            num_shards=view.num_shards,
        )
        logger.warning(
            "embedding shard SPLIT v%d: %d -> %d shards",
            view.version, view.num_shards // 2, view.num_shards,
        )
        self._notify(view)
        return view, moves

    def begin_merge(self) -> Tuple[ShardMapView, List[ShardMove]]:
        """Halve the shard count: children s and s + new_n fold back
        into parent s. Only legal when every child pair is co-owned
        (the inverse of a split that never re-homed a child) — the
        merge is then a local interleave with no cross-host copy; the
        controller suppresses the action otherwise rather than paying
        a migration it can't cost-model. Child delta logs are cleared
        by `store.merge_resident` (entry keys don't compose across the
        fold), so replicas full-resync — which is why replicas are
        dropped here too."""
        commit = None
        with self._lock:
            if not self._owners:
                raise RuntimeError("begin_merge before bootstrap")
            if self._pending is not None:
                raise RuntimeError("merge during in-flight resharding")
            old_n = self.num_shards
            if old_n % 2 != 0 or old_n < 2:
                raise ValueError(f"cannot merge {old_n} shards")
            new_n = old_n // 2
            for s in range(new_n):
                if self._owners[s] != self._owners[s + new_n]:
                    raise ValueError(
                        f"children {s} and {s + new_n} live on different "
                        "owners; merge requires co-owned pairs"
                    )
            version = self._version + 1
            new_owners = self._owners[:new_n]
            moves = [
                ShardMove(s, new_owners[s], new_owners[s],
                          kind="merge", parent=s)
                for s in range(new_n)
            ]
            self._pending = {
                "version": version,
                "moves": moves,
                "confirmed": set(),
                "prior_owners": list(self._owners),
                "prior_replicas": [list(r) for r in self._replicas],
                "prior_num_shards": old_n,
            }
            self.num_shards = new_n
            self._owners = new_owners
            self._replicas = [[] for _ in range(new_n)]
            self._replica_counts = None
            self._version = version
            if self._journal is not None:
                commit = self._journal.append(
                    "emb_reshard_begin", version=version,
                    num_shards=new_n,
                    owners=list(self._owners),
                    replicas=[list(r) for r in self._replicas],
                    moves=[m.to_wire() for m in moves],
                )
            view = self._view_locked()
        if commit is not None:
            commit.wait()
        tracing.event(
            "embedding.merge_begin", version=view.version,
            num_shards=view.num_shards,
        )
        logger.warning(
            "embedding shard MERGE v%d: %d -> %d shards",
            view.version, view.num_shards * 2, view.num_shards,
        )
        self._notify(view)
        return view, moves

    # -------------------------------------------------------------- #

    def view(self) -> ShardMapView:
        with self._lock:
            return self._view_locked()

    def _view_locked(self) -> ShardMapView:  # holds: _lock
        return ShardMapView(
            version=self._version,
            num_shards=self.num_shards,
            owners=tuple(self._owners),
            tables=tuple(self._tables.values()),
            resharding=self._pending is not None or self._interrupted,
            replicas=tuple(tuple(r) for r in self._replicas),
            hot_ids=tuple(self._hot_ids),
        )

    def _notify(self, view: ShardMapView) -> None:
        for fn in self._listeners:
            try:
                fn(view)
            except Exception:
                logger.exception("shard-map listener failed (ignored)")


