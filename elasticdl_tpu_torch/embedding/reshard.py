"""Shard migration: executing a ShardMapOwner move plan.

Rides the same announce -> quiesce -> handoff shape as mesh rescale
(docs/elasticity.md): the master journals `emb_reshard_begin` with the
move plan, the shards move device-to-device through the live-handoff
staging path (parallel/elastic.stage_leaf + reshard_state — the donor's
rows are staged exactly like a TrainState leaf whose owner set changes),
recipients confirm via `ShardMapOwner.confirm_moves`, and the commit is
journaled before the new map is considered current. Exactly-once update
accounting travels WITH the shard: the per-client seq watermarks are
part of the migration payload, so a push retried across the move still
dedupes at the new owner.

Dead-donor moves (`src < 0` — kill-worker recovery) restore from the
tier checkpoint when one exists and fall back to deterministic seed
materialization (store._init_shard_rows) for never-pushed shards.

The whole plan execution is spanned (`embedding.reshard` with one
`embedding.shard_move` child per move) so the trace analyzer can put
resharding on the recovery critical path — CI runs it --strict over the
bench leg's spans.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

from elasticdl_tpu_torch.common.log_utils import default_logger
from elasticdl_tpu_torch.embedding import sharding
from elasticdl_tpu_torch.embedding.transport import OwnerUnavailableError
from elasticdl_tpu_torch.observability import tracing
from elasticdl_tpu_torch.observability.registry import default_registry

logger = default_logger(__name__)

_reg = default_registry()
_MOVE_S = _reg.histogram(
    "edl_embedding_shard_move_seconds", "per-shard migration wall time")
_RESTORED = _reg.counter(
    "edl_embedding_shards_restored_total",
    "dead-donor shards rebuilt from checkpoint/seed", labels=("source",))


def apply_moves(
    view: sharding.ShardMapView,
    moves: Sequence[sharding.ShardMove],
    transport,
    checkpoint_dir: str = "",
    mesh=None,
    confirm=None,
) -> Dict[str, Any]:
    """Execute a move plan against a (local) transport's stores.

    For every move and every table: fetch the payload from the donor
    (live transfer) or from the checkpoint/seed (dead donor), stage it
    through the live-handoff path onto `mesh` when one is given (the
    device-to-device lane mesh rescale uses), install at the recipient,
    and `confirm(version, [shard])` toward the master. Donors release
    their copy only AFTER the confirm round — a crash mid-move leaves
    the committed map (and the donor's copy) intact.

    Returns stats: moved/restored counts and wall time.
    """
    from elasticdl_tpu_torch.parallel import elastic

    t0 = time.perf_counter()
    moved = restored = 0
    with tracing.span("embedding.reshard", version=view.version,
                      moves=len(moves)) as sp:
        for mv in moves:
            t_mv = time.perf_counter()
            with tracing.span("embedding.shard_move", shard=mv.shard,
                              src=mv.src, dst=mv.dst):
                dst_store = transport.store_of(mv.dst)
                resident = set(dst_store.resident_shards())
                for spec in view.tables:
                    if (spec.name, mv.shard) in resident:
                        # idempotent re-execution (a retried plan, or a
                        # recovery install where only SOME tables are
                        # missing): a live resident shard — possibly
                        # carrying pushes newer than any checkpoint —
                        # must never be clobbered by a stale payload
                        continue
                    payload = _fetch_payload(
                        transport, spec, mv, view.num_shards,
                        checkpoint_dir)
                    if payload.pop("_restored", False):
                        restored += 1
                    else:
                        moved += 1
                    if mesh is not None:
                        # the live-handoff lane: stage the donor rows and
                        # lay them out on the recipient's mesh exactly as
                        # a rescale lays out a TrainState leaf
                        staged = elastic.stage_leaf(payload["rows"])
                        payload["rows"] = elastic.reshard_state(
                            staged, mesh)
                    dst_store.install_shard(spec.name, mv.shard, payload)
            _MOVE_S.observe(time.perf_counter() - t_mv)
        if confirm is not None:
            confirm(view.version, [mv.shard for mv in moves])
        # only after the plan is confirmed (committed by the master) do
        # live donors drop their copy — an uncommitted resharding must
        # leave every donor able to keep serving the old map
        for mv in moves:
            if mv.src < 0:
                continue
            try:
                src_store = transport.store_of(mv.src)
            except OwnerUnavailableError:
                logger.info(
                    "donor %d gone before releasing shard %d (already "
                    "dead or deregistered) — nothing to release", mv.src,
                    mv.shard,
                )
                continue
            for spec in view.tables:
                src_store.release_shard(spec.name, mv.shard)
        for _, st in _stores_by_owner(transport, view).items():
            st.adopt_version(view.version)
        sp.set(moved=moved, restored=restored)
    stats = {
        "moves": len(moves), "payloads_transferred": moved,
        "payloads_restored": restored,
        "seconds": round(time.perf_counter() - t0, 4),
    }
    return stats


def _fetch_payload(transport, spec, mv: sharding.ShardMove,
                   num_shards: int, checkpoint_dir: str) -> Dict[str, Any]:
    from elasticdl_tpu_torch.embedding import store as store_lib

    if mv.src >= 0:
        try:
            payload = dict(
                transport.fetch_shard(mv.src, spec.name, mv.shard))
            payload["_restored"] = False
            return payload
        except Exception:
            # the planned donor died between plan and execution: same
            # recovery as a dead-donor move — checkpoint, then seed
            logger.warning(
                "shard %s/%d donor %d unreachable; restoring instead",
                spec.name, mv.shard, mv.src,
            )
    if checkpoint_dir:
        payload = store_lib.load_shard_file(
            checkpoint_dir, spec.name, mv.shard)
        if payload is not None:
            _RESTORED.inc(source="checkpoint")
            payload["_restored"] = True
            return payload
    logger.warning(
        "shard %s/%d lost its owner with no checkpoint; re-materializing "
        "from seed (any un-checkpointed pushes to it are gone — size "
        "checkpoint cadence accordingly, docs/performance.md)",
        spec.name, mv.shard,
    )
    _RESTORED.inc(source="seed")
    return {
        "rows": store_lib._init_shard_rows(spec, mv.shard, num_shards),
        "applied": {},
        "_restored": True,
    }


def _stores_by_owner(transport, view: sharding.ShardMapView):
    out = {}
    for owner in sorted(set(view.owners)):
        try:
            out[owner] = transport.store_of(owner)
        except OwnerUnavailableError:
            continue   # a dead owner has no store to version-stamp
    return out


def drain_to_checkpoint(store, checkpoint_dir: str,
                        tables: Optional[List[str]] = None) -> int:
    """Preemption-drain hook: persist every resident shard (rows + seq
    watermarks) so a planned kill loses nothing — the tier twin of the
    worker's drain checkpoint. Returns shards written."""
    n = store.save(checkpoint_dir, tables)
    tracing.event("embedding.drain", shards=n)
    return n
