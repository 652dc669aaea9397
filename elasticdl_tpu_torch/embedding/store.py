"""The owner side of the embedding tier: dense per-shard tables served
with one gather per pull and one deduped scatter-add per push.

Counterpart of `elasticdl_tpu/embedding/store.py`, whose text it keeps
apart from the device mode. Shard s of table T is one (rows, dim) float32
table addressed by `local = id // num_shards`, so a pull is a single
gather and a push is one dense placement.

Two serving modes, chosen when the store is built (`device=`):

- **device** (`device=None` with `EDL_EMB_TIER_DEVICE` unset or "1",
  `device=True`, or a `torch.device`): shard rows live as a float32
  tensor on the store's device, by default the card
  (`common/runtime.resolve_device`, which raises where there is none:
  there is no quiet host fallback). A pull gathers at the clamped local
  ids (`ops/embedding.gather_rows`; out-of-range ids, the client's pow2
  `-1` sentinels, read zero rows) and copies the rows to host numpy. A
  push places the dense delta with kernel K1
  (`ops/embedding.scatter_add_dense` -> `ops/placement.
  place_sorted_grads` -> `csrc/place_sorted_grads.cu`: two launches a
  push), forms `scale * delta` as its own tensor and adds it, two
  roundings as the host path's `tab[ids] += scale * vals` has, and swaps
  the new table in under the shard lock. The update is out of place: a
  concurrent pull may still read the old table. On a CPU tensor K1's
  wrapper runs its plain version. The programs are keyed through the
  process-global `training/compile_cache` by table shape and pow2-padded
  request length, so a shard migrating onto a new owner in this process
  finds them already built.
- **host** (`device=False`, or `EDL_EMB_TIER_DEVICE=0`): shard rows live
  as numpy; pull is one `take`, push is one in-place deduped scatter-add
  — cost scales with touched rows, not shard size.

Every payload that leaves the store (`extract_shard`, split/merge, the
replica paths, `save`) is host numpy, copied off the device. Shard files
keep the reference's format, so either package reads the other's.

Exactly-once pushes: every push carries ``(client_id, seq)`` with seq
strictly increasing per client; the store keeps the last applied seq per
(table, shard, client) and re-sends (client retries after a lost ack, or
requeues after an interrupted resharding) come back ``applied=False``
without touching the table. The seq watermarks TRAVEL with the shard
(`extract_shard` / `install_shard` / checkpoint files), so migration and
restore preserve the fence.

Push watermarks (the read path): every APPLIED push also bumps
a per-(table, shard) **watermark** — a dense counter of writes the shard
has absorbed. Pulls and push acks can carry it (``with_watermark=True``),
which is what fences the worker-local hot-row cache (tier.py: a cached
row tagged with watermark W is a miss once the owner is known to be past
``W + staleness_bound``) and what tags the **delta log**: the store keeps
a bounded log of recent applied pushes so a read replica can sync by
fetching only the deltas past its own watermark (`fetch_delta` /
`apply_replica_delta`) instead of re-copying the shard. Replica copies
are resident in a SEPARATE namespace (`install_replica`): they serve
pulls (``replica=True``) but reject pushes — writes stay primary-only —
and can be promoted to primary wholesale (`promote_replica`) when the
owner dies, watermark and exactly-once seq fence included.
"""

from __future__ import annotations

import io
import json
import os
import threading
import time
import zlib
from collections import deque
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from elasticdl_tpu_torch.common import runtime
from elasticdl_tpu_torch.common.log_utils import default_logger
from elasticdl_tpu_torch.embedding import sharding
from elasticdl_tpu_torch.observability.registry import default_registry

logger = default_logger(__name__)

_reg = default_registry()
_PULLED = _reg.counter(
    "edl_embedding_store_pulled_rows_total",
    "rows served by owner stores", labels=("table",))
_PUSHED = _reg.counter(
    "edl_embedding_store_pushed_rows_total",
    "deduped update rows applied by owner stores", labels=("table",))
_DUP_PUSHES = _reg.counter(
    "edl_embedding_store_duplicate_pushes_total",
    "pushes deduplicated by the exactly-once sequence fence")
_STALE = _reg.counter(
    "edl_embedding_store_stale_map_rejects_total",
    "pulls/pushes rejected for a stale shard-map version")
_SHARDS = _reg.gauge(
    "edl_embedding_store_shards", "shards resident in this process's store")
# per-shard skew telemetry: label cardinality is bounded by
# --embedding_shards x registered tables x {pull,push} — a config
# constant, not data (the EDL405 boundary)
_SHARD_ROWS = _reg.counter(
    "edl_embedding_store_shard_load_rows_total",
    "rows served (pull) / applied (push) per resident shard",
    labels=("table", "shard", "op"))
_OP_S = _reg.histogram(
    "edl_embedding_store_op_seconds",
    "owner-side serve wall time per call", labels=("op",))
_REPLICA_SYNCS = _reg.counter(
    "edl_embedding_replica_delta_syncs_total",
    "delta batches applied to resident replica shards")
_REPLICA_RESYNCS = _reg.counter(
    "edl_embedding_replica_full_resyncs_total",
    "replica syncs that fell back to a full shard copy (delta log "
    "did not reach back to the replica's watermark)")
_REPLICA_PROMOTIONS = _reg.counter(
    "edl_embedding_replica_promotions_total",
    "replica shards promoted to primary (owner death recovery)")

#: delta-log depth per resident shard: how many applied pushes a replica
#: may lag before its sync falls back to a full shard copy
DELTA_LOG = int(os.environ.get("EDL_EMB_DELTA_LOG", "64") or 64)


class StaleShardMapError(RuntimeError):
    """The caller's shard-map version does not match the store's (or the
    shard is not resident here) — refresh the map and re-route."""


class _Shard:
    """One resident shard: the dense local table + the exactly-once
    per-client sequence watermarks (mutations guarded by the store lock
    at the serving layer; the apply itself runs outside it)."""

    __slots__ = ("rows", "applied", "lock", "wm", "deltas")

    def __init__(self, rows, applied: Optional[Dict[str, int]] = None,
                 wm: int = 0):
        self.rows = rows            # tensor (device) / ndarray (host)
        self.applied: Dict[str, int] = dict(applied or {})
        # per-shard leaf lock: pull/push on DIFFERENT shards never
        # serialize behind each other (the store lock only guards the
        # shard directory)
        self.lock = threading.Lock()
        # push watermark: +1 per APPLIED push. The hot-row cache's
        # staleness fence and the replica delta protocol both count in
        # these units — "N pushes behind", not wall time, so a quiet
        # shard never goes stale and a hot one ages fast.
        self.wm = int(wm)
        # recent applied pushes, watermark-tagged, for replica delta
        # sync (guarded by `lock`; bounded — a replica further behind
        # than the log re-copies the shard)
        self.deltas: "deque" = deque(maxlen=DELTA_LOG)


def _init_shard_rows(spec: sharding.TableSpec, shard: int,
                     num_shards: int) -> np.ndarray:
    """Deterministic shard materialization: bit-identical wherever it is
    built (fresh bootstrap needs no transfer; a dead owner's shard can be
    re-materialized only if it was never pushed to — otherwise the
    checkpoint is the source of truth)."""
    rows = sharding.shard_row_count(spec.vocab, num_shards)
    # crc32, NOT hash(): Python's str hash is salted per process
    # (PYTHONHASHSEED), and shard materialization must be bit-identical
    # ACROSS processes — the same pitfall EDL204 documents for set order
    rng = np.random.default_rng(
        np.random.SeedSequence(
            [spec.seed, zlib.crc32(spec.name.encode()), shard]))
    out = rng.uniform(-spec.init_scale, spec.init_scale,
                      (rows, spec.dim)).astype(np.float32)
    # rows past the padded vocab's tail never map to a real id but are
    # part of the dense shard; zero them so accounting sums stay honest
    first_dead = -(-max(0, spec.vocab - shard) // num_shards)
    out[first_dead:] = 0.0
    return out


def _default_device_mode() -> Optional[bool]:
    env = os.environ.get("EDL_EMB_TIER_DEVICE", "")
    if env in ("0", "1"):
        return env == "1"
    return None


def _resolve_device(device) -> Optional[torch.device]:
    """The store's device, or None for host mode. `device=None` reads
    EDL_EMB_TIER_DEVICE ("0": host); otherwise, and for `device=True`,
    it is the card (raising where there is none)."""
    if device is None:
        device = _default_device_mode()
        if device is None:
            device = True
    if device is False:
        return None
    return runtime.resolve_device(None if device is True else device)


def _host_copy(rows) -> np.ndarray:
    """A point-in-time float32 numpy copy of a shard's rows (a tensor on
    any device, or an ndarray)."""
    if isinstance(rows, torch.Tensor):
        return np.array(rows.detach().cpu().numpy(), np.float32, copy=True)
    return np.array(rows, np.float32, copy=True)


class EmbeddingShardStore:
    """Shards this worker owns, served to tier clients via a transport."""

    def __init__(self, owner: int, compile_cache=None,
                 device: Union[bool, runtime.DeviceLike] = None):
        self.owner = owner
        self._lock = threading.Lock()
        self._tables: Dict[str, sharding.TableSpec] = {}  # guarded_by: _lock
        self._num_shards = 0                              # guarded_by: _lock
        self._map_version = 0                             # guarded_by: _lock
        self._shards: Dict[Tuple[str, int], _Shard] = {}  # guarded_by: _lock
        # read-replica copies, SEPARATE namespace: a worker may be
        # primary for shard 3 and replica for shard 5 in the same store;
        # replicas serve pulls only and are promotable wholesale
        self._replicas: Dict[Tuple[str, int], _Shard] = {}  # guarded_by: _lock
        # replica delta logging is OFF until a shard map carrying
        # replica assignments shows up (attach/set_delta_logging):
        # without replicas nothing ever consumes the log, and buffering
        # 64 pushes of gradient rows per shard is real memory + two
        # array copies per push on the hot path
        self._log_deltas = False                          # guarded_by: _lock
        # decided here, not lazily: a device-mode store where there is
        # no card fails at construction
        self.device = _resolve_device(device)
        self._device_mode = self.device is not None
        if compile_cache is None:
            from elasticdl_tpu_torch.training import compile_cache as cc

            compile_cache = cc.global_cache()
        self._cache = compile_cache

    def _use_device(self) -> bool:
        return self._device_mode

    def _place(self, rows):
        """Rows (an ndarray or a tensor) -> the store's serving format: a
        float32 tensor on the store's device in device mode, a mutable
        owned numpy array in host mode (the in-place scatter must never
        write a caller's buffer)."""
        if self._use_device():
            if isinstance(rows, torch.Tensor):
                return rows.detach().to(self.device, torch.float32,
                                        copy=True)
            return torch.from_numpy(
                np.array(rows, np.float32, copy=True)).to(self.device)
        return _host_copy(rows)

    # -------------------------------------------------------------- #
    # map adoption / shard lifecycle

    def attach(self, view: sharding.ShardMapView,
               checkpoint_dir: str = "") -> List[int]:
        """Adopt a shard-map view: register its tables, materialize every
        owned-but-missing shard (from the tier checkpoint when present,
        else deterministically from the table seed), and adopt the map
        version. Shards this view assigns elsewhere are NOT dropped here —
        the donor keeps them until the migration commits (reshard.py
        releases them). Returns the shard ids freshly materialized."""
        created: List[int] = []
        with self._lock:
            self._num_shards = view.num_shards
            self._map_version = view.version
            self._log_deltas = any(
                view.replicas_of(s) for s in range(view.num_shards))
            for spec in view.tables:
                self._tables[spec.name] = spec
            owned = [s for s, o in enumerate(view.owners)
                     if o == self.owner]
            for spec in view.tables:
                for s in owned:
                    if (spec.name, s) in self._shards:
                        continue
                    rows = None
                    if checkpoint_dir:
                        payload = load_shard_file(
                            checkpoint_dir, spec.name, s)
                        if payload is not None:
                            self._shards[(spec.name, s)] = _Shard(
                                self._place(payload["rows"]),
                                payload["applied"],
                                wm=int(payload.get("wm", 0)),
                            )
                            created.append(s)
                            continue
                    rows = _init_shard_rows(spec, s, view.num_shards)
                    self._shards[(spec.name, s)] = _Shard(self._place(rows))
                    created.append(s)
            _SHARDS.set(len(self._shards))
        return created

    def adopt_version(self, version: int) -> None:
        with self._lock:
            self._map_version = version

    def set_delta_logging(self, enabled: bool) -> None:
        """Replica-map reaction (WorkerTierRuntime): start/stop keeping
        the per-shard push delta log. A log that starts mid-history is
        safe — fetch_delta's contiguity check routes a too-far-behind
        replica to the full-copy path."""
        with self._lock:
            self._log_deltas = bool(enabled)

    @property
    def map_version(self) -> int:
        with self._lock:
            return self._map_version

    def resident_shards(self, table: Optional[str] = None) -> List[Tuple[str, int]]:
        with self._lock:
            return [k for k in self._shards
                    if table is None or k[0] == table]

    def _get_shard(self, table: str, shard: int,
                   map_version: Optional[int],
                   replica: bool = False) -> _Shard:
        with self._lock:
            if (map_version is not None
                    and map_version != self._map_version):
                _STALE.inc()
                raise StaleShardMapError(
                    f"shard map v{map_version} (store at "
                    f"v{self._map_version})"
                )
            pool = self._replicas if replica else self._shards
            sh = pool.get((table, shard))
        if sh is None:
            _STALE.inc()
            raise StaleShardMapError(
                f"shard {table}/{shard} not "
                f"{'replica-' if replica else ''}resident on owner "
                f"{self.owner}"
            )
        return sh

    # -------------------------------------------------------------- #
    # data plane

    def pull(self, table: str, shard: int, local_ids: np.ndarray,
             map_version: Optional[int] = None,
             with_watermark: bool = False, replica: bool = False):
        """One fused gather: (n,) local row ids -> (n, dim) rows.
        Out-of-range ids (the client's pow2 padding sentinels) return
        zero rows. ``with_watermark=True`` returns ``(rows, wm)`` — the
        shard's push watermark as of the serve, the hot-row cache's
        freshness tag. ``replica=True`` serves from this store's replica
        copy of the shard (its watermark is wherever the last delta sync
        left it — the client's staleness fence decides acceptability)."""
        t0 = time.perf_counter()
        sh = self._get_shard(table, shard, map_version, replica=replica)
        ids = np.ascontiguousarray(np.asarray(local_ids, np.int32))
        with sh.lock:
            rows = sh.rows
            wm = sh.wm
        if self._use_device():
            out = self._pull_fn(tuple(rows.shape), ids.shape[0])(rows, ids)
        else:
            in_range = (ids >= 0) & (ids < rows.shape[0])
            out = rows.take(np.where(in_range, ids, 0), axis=0)
            out[~in_range] = 0.0
        # REAL rows only: the request is pow2-padded with -1 sentinels
        # (min bucket 256), and counting the padding would inflate the
        # traffic counters operators size capacity from
        real = int((ids >= 0).sum())
        _PULLED.inc(real, table=table)
        _SHARD_ROWS.inc(real, table=table, shard=str(shard), op="pull")
        _OP_S.observe(time.perf_counter() - t0, op="pull")
        if with_watermark:
            return out, wm
        return out

    def push(self, table: str, shard: int, local_ids: np.ndarray,
             rows: np.ndarray, *, client_id: str, seq: int,
             map_version: Optional[int] = None,
             scale: float = 1.0, with_watermark: bool = False):
        """One deduped scatter-add: ``shard_table += scale * sum(rows at
        local_ids)``. Returns False (without touching the table) when the
        exactly-once fence says ``(client_id, seq)`` was already applied
        — the ack a retried/requeued push gets. ``with_watermark=True``
        returns ``(applied, wm)`` with the post-apply watermark (a
        duplicate returns the CURRENT watermark — the fence held, the
        caller's freshness knowledge still advances)."""
        t0 = time.perf_counter()
        with self._lock:
            is_replica = ((table, shard) in self._replicas
                          and (table, shard) not in self._shards)
            log_deltas = self._log_deltas
        if is_replica:
            # writes are primary-only: a client pushing here holds a map
            # that predates (or misread) the replica split — same remedy
            # as any stale-map write: refresh and re-route
            _STALE.inc()
            raise StaleShardMapError(
                f"shard {table}/{shard} on owner {self.owner} is a READ "
                "replica; pushes go to the primary"
            )
        sh = self._get_shard(table, shard, map_version)
        ids = np.ascontiguousarray(np.asarray(local_ids, np.int32))
        vals = np.ascontiguousarray(np.asarray(rows, np.float32))
        with sh.lock:
            last = sh.applied.get(client_id, -1)
            if seq <= last:
                _DUP_PUSHES.inc()
                return (False, sh.wm) if with_watermark else False
            if self._use_device():
                sh.rows = self._apply_fn(tuple(sh.rows.shape), ids.shape[0])(
                    sh.rows, ids, vals, np.float32(scale))
            else:
                self._host_apply(sh.rows, ids, vals, scale)
            sh.applied[client_id] = seq
            sh.wm += 1
            wm = sh.wm
            if log_deltas:
                # delta log (replica sync): real rows only — a replica
                # re-applies through the same sentinel-dropping path,
                # and the log should not hold the pow2 padding
                keep = ids >= 0
                sh.deltas.append({
                    "wm": wm, "ids": ids[keep].copy(),
                    "rows": vals[keep].copy(), "scale": float(scale),
                    "client_id": client_id, "seq": int(seq),
                })
        # real (non-sentinel) rows only — see the pull counter note
        real = int((ids >= 0).sum())
        _PUSHED.inc(real, table=table)
        _SHARD_ROWS.inc(real, table=table, shard=str(shard), op="push")
        _OP_S.observe(time.perf_counter() - t0, op="push")
        if with_watermark:
            return True, wm
        return True

    @staticmethod
    def _host_apply(tab: np.ndarray, ids: np.ndarray, vals: np.ndarray,
                    scale: float) -> None:
        """In-place scatter-add, O(touched rows). Out-of-range ids
        (padding sentinels) drop. Two regimes:

        - UNIQUE ids (a deduping client — tier.py sums duplicates before
          sending): one vectorized fancy-index add. This is the fast
          path the client-side dedupe exists to unlock.
        - duplicate ids (a non-deduping client): ``np.add.at`` — the
          row-serial accumulate that is numpy's honest general primitive
          for colliding indices, and the faithful stand-in for the
          reference PS's per-row hash-map apply
          (elasticdl/pkg/ps/optimizer.go). Its cost IS the per-row
          traffic the deduped protocol removes; the bench's single-host
          baseline measures it on purpose.
        """
        keep = (ids >= 0) & (ids < tab.shape[0])
        ids, vals = ids[keep], vals[keep]
        if not ids.shape[0]:
            return
        # sorted-unique probe without a full unique(): the deduping
        # client sends SORTED unique ids, so one vectorized monotonicity
        # check identifies the fast path
        sorted_unique = bool(np.all(ids[1:] > ids[:-1]))
        if sorted_unique:
            tab[ids] += scale * vals
        else:
            np.add.at(tab, ids, scale * vals)

    # -------------------------------------------------------------- #
    # device programs (compile-cache keyed: warm resharding finds them)

    def _pull_fn(self, table_shape, n):
        key = ("emb_tier_pull", table_shape, int(n))

        def build():
            from elasticdl_tpu_torch.ops import embedding as emb_ops

            def f(tab, ids):
                # a copy: the ids may be a read-only wire buffer
                ids = torch.tensor(ids, device=tab.device)
                in_range = (ids >= 0) & (ids < tab.shape[0])
                safe = torch.where(in_range, ids, 0)
                with torch.no_grad():
                    out = emb_ops.gather_rows(tab, safe)
                    out = torch.where(in_range[:, None], out, 0.0)
                return out.cpu().numpy()

            return f

        return self._cache.get_or_build(key, build)

    def _apply_fn(self, table_shape, n):
        key = ("emb_tier_apply", table_shape, int(n))

        def build():
            from elasticdl_tpu_torch.ops import embedding as emb_ops

            def f(tab, ids, vals, scale):
                dev = tab.device
                with torch.no_grad():
                    # K1: the dense (rows, dim) sum of vals at ids
                    delta = emb_ops.scatter_add_dense(
                        torch.tensor(ids, device=dev),
                        torch.tensor(vals, device=dev),
                        tab.shape[0], dtype=tab.dtype)
                    # scale * delta first, as its own tensor, then the add:
                    # two float32 roundings, as the host path's
                    # `tab[ids] += scale * vals` has
                    step = torch.tensor(scale, dtype=tab.dtype,
                                        device=dev) * delta
                    return tab + step

            # out of place: a concurrent pull on the same shard may still
            # read the old table (the per-shard lock scopes the swap, not
            # the gather)
            return f

        return self._cache.get_or_build(key, build)

    # -------------------------------------------------------------- #
    # migration / checkpoint payloads

    def extract_shard(self, table: str, shard: int,
                      replica: bool = False) -> Dict[str, Any]:
        """The migration payload: rows + exactly-once watermarks + push
        watermark. The shard stays resident (the donor serves reads until
        the move commits); `release_shard` drops it afterwards."""
        sh = self._get_shard(table, shard, None, replica=replica)
        with sh.lock:
            return {
                # copy, not a view: in host mode the live array mutates
                # in place under later pushes — a payload must be a
                # point-in-time snapshot
                "rows": _host_copy(sh.rows),
                "applied": dict(sh.applied),
                "wm": int(sh.wm),
            }

    def install_shard(self, table: str, shard: int,
                      payload: Dict[str, Any]) -> None:
        with self._lock:
            self._shards[(table, shard)] = _Shard(
                self._place(payload["rows"]),
                {str(k): int(v) for k, v in payload["applied"].items()},
                wm=int(payload.get("wm", 0)),
            )
            _SHARDS.set(len(self._shards))

    def release_shard(self, table: str, shard: int) -> None:
        with self._lock:
            self._shards.pop((table, shard), None)
            _SHARDS.set(len(self._shards))

    # -------------------------------------------------------------- #
    # shard split / merge: local re-key, no cross-host copy

    def split_resident(self, view: sharding.ShardMapView) -> List[int]:
        """Re-key every resident shard for a DOUBLED shard count: parent
        s's row j (global id s + j*n) lands in child s when j is even,
        child s + n when j is odd, at child-local row j // 2 — a pure
        interleave, no id changes hosts. The exactly-once fence must
        survive the re-key, so each child inherits a full COPY of the
        parent's per-client seq watermarks (a push retried across the
        split dedupes at whichever child its ids now route to) and the
        parent's push watermark; the delta log is re-keyed per child
        with one entry per parent entry — possibly with zero rows — so
        watermark contiguity holds and a replica syncing across the
        split never sees a gap. Replica copies are dropped (their
        keyspace just changed); the controller re-fans them out.
        Returns the child shard ids now resident (confirm_moves
        payload)."""
        created: List[int] = []
        with self._lock:
            old_n = self._num_shards
            if view.num_shards != old_n * 2:
                raise ValueError(
                    f"split view has {view.num_shards} shards; store at "
                    f"{old_n}"
                )
            for spec in view.tables:
                self._tables[spec.name] = spec
            for (table, s), sh in sorted(self._shards.items()):
                spec = self._tables[table]
                child_rows = sharding.shard_row_count(
                    spec.vocab, view.num_shards)
                with sh.lock:
                    rows = _host_copy(sh.rows)
                    applied = dict(sh.applied)
                    wm = int(sh.wm)
                    deltas = list(sh.deltas)
                for child, parity in ((s, 0), (s + old_n, 1)):
                    out = np.zeros((child_rows, rows.shape[1]), np.float32)
                    part = rows[parity::2]
                    out[: part.shape[0]] = part
                    csh = _Shard(self._place(out), dict(applied), wm=wm)
                    for d in deltas:
                        mask = (d["ids"] % 2) == parity
                        csh.deltas.append(dict(
                            d, ids=(d["ids"][mask] // 2).astype(np.int32),
                            rows=d["rows"][mask].copy(),
                        ))
                    self._shards[(table, child)] = csh
                    if child != s:
                        created.append(child)
                if s not in created:
                    created.append(s)
            self._replicas.clear()
            self._num_shards = view.num_shards
            self._map_version = view.version
            self._log_deltas = any(
                view.replicas_of(s2) for s2 in range(view.num_shards))
            _SHARDS.set(len(self._shards))
        return sorted(set(created))

    def merge_resident(self, view: sharding.ShardMapView) -> List[int]:
        """Inverse of `split_resident` for a HALVED shard count: children
        s and s + new_n interleave back into parent s (legal only when
        both are resident here — the owner enforces co-ownership before
        planning the merge). The parent's exactly-once fence is the
        per-client MAX over both children and its push watermark the max
        of theirs; the delta log is CLEARED — child entry watermarks
        don't compose into one parent sequence, so replicas full-resync
        (they were dropped by the layout transition anyway). Returns the
        parent shard ids now resident."""
        created: List[int] = []
        with self._lock:
            old_n = self._num_shards
            new_n = view.num_shards
            if old_n != new_n * 2:
                raise ValueError(
                    f"merge view has {new_n} shards; store at {old_n}"
                )
            for spec in view.tables:
                self._tables[spec.name] = spec
            parents = sorted({
                (t, s if s < new_n else s - new_n)
                for (t, s) in self._shards
            })
            for table, s in parents:
                ev = self._shards.pop((table, s), None)
                od = self._shards.pop((table, s + new_n), None)
                if ev is None or od is None:
                    raise StaleShardMapError(
                        f"merge of {table}/{s}: both children must be "
                        f"resident on owner {self.owner}"
                    )
                spec = self._tables[table]
                p_cnt = sharding.shard_row_count(spec.vocab, new_n)
                with ev.lock:
                    ev_rows = _host_copy(ev.rows)
                    ev_applied = dict(ev.applied)
                    ev_wm = int(ev.wm)
                with od.lock:
                    od_rows = _host_copy(od.rows)
                    od_applied = dict(od.applied)
                    od_wm = int(od.wm)
                out = np.zeros((p_cnt, ev_rows.shape[1]), np.float32)
                out[0::2] = ev_rows[: (p_cnt + 1) // 2]
                out[1::2] = od_rows[: p_cnt // 2]
                applied = dict(ev_applied)
                for cid, seq in od_applied.items():
                    applied[cid] = max(applied.get(cid, -1), seq)
                self._shards[(table, s)] = _Shard(
                    self._place(out), applied, wm=max(ev_wm, od_wm))
                if s not in created:
                    created.append(s)
            self._replicas.clear()
            self._num_shards = new_n
            self._map_version = view.version
            self._log_deltas = any(
                view.replicas_of(s2) for s2 in range(view.num_shards))
            _SHARDS.set(len(self._shards))
        return sorted(created)

    # -------------------------------------------------------------- #
    # read replicas: pull-only copies + delta sync

    def install_replica(self, table: str, shard: int,
                        payload: Dict[str, Any]) -> None:
        """Adopt a replica copy of a shard this store does NOT own
        (payload = the primary's `extract_shard`). Serves pulls with
        ``replica=True``; never pushes."""
        with self._lock:
            self._replicas[(table, shard)] = _Shard(
                self._place(payload["rows"]),
                {str(k): int(v) for k, v in payload["applied"].items()},
                wm=int(payload.get("wm", 0)),
            )

    def release_replica(self, table: str, shard: int) -> None:
        with self._lock:
            self._replicas.pop((table, shard), None)

    def resident_replicas(self) -> List[Tuple[str, int]]:
        with self._lock:
            return list(self._replicas)

    def replica_watermark(self, table: str, shard: int) -> int:
        sh = self._get_shard(table, shard, None, replica=True)
        with sh.lock:
            return sh.wm

    def promote_replica(self, table: str, shard: int) -> int:
        """Owner-death recovery: this store's replica copy BECOMES the
        primary — rows, exactly-once seq fence, and push watermark move
        wholesale, so a client push retried across the promotion still
        dedupes. Returns the promoted copy's watermark."""
        with self._lock:
            sh = self._replicas.pop((table, shard), None)
            if sh is None:
                raise StaleShardMapError(
                    f"no replica of {table}/{shard} resident on owner "
                    f"{self.owner} to promote"
                )
            self._shards[(table, shard)] = sh
            _SHARDS.set(len(self._shards))
        _REPLICA_PROMOTIONS.inc()
        with sh.lock:
            return sh.wm

    def shard_watermark(self, table: str, shard: int,
                        replica: bool = False) -> int:
        """The shard's push watermark — the hot-row cache's freshness
        probe (a fully-cache-served client must still learn the owner
        moved on; tier.py probes this on a lookup cadence).
        ``replica=True`` reads the replica copy's watermark: a LOWER
        bound on the primary's, which is what the degraded-mode ladder
        probes when the primary has partitioned away (tier.py
        _maybe_probe_watermarks)."""
        sh = self._get_shard(table, shard, None, replica=replica)
        with sh.lock:
            return sh.wm

    def fetch_delta(self, table: str, shard: int,
                    since_wm: int) -> Optional[Dict[str, Any]]:
        """Primary side of replica sync: every applied push past
        ``since_wm``, watermark-tagged and in order — or None when the
        bounded delta log no longer reaches back that far (the replica
        falls back to a full `extract_shard` copy)."""
        sh = self._get_shard(table, shard, None)
        with sh.lock:
            wm = sh.wm
            if since_wm >= wm:
                return {"wm": wm, "entries": []}
            entries = [d for d in sh.deltas if d["wm"] > since_wm]
            # contiguity: the log must hold EVERY watermark in
            # (since_wm, wm] or the replica would silently skip pushes
            if len(entries) != wm - since_wm:
                return None
            return {
                "wm": wm,
                "entries": [dict(d, ids=d["ids"].copy(),
                                 rows=d["rows"].copy())
                            for d in entries],
            }

    def apply_replica_delta(self, table: str, shard: int,
                            delta: Dict[str, Any]) -> int:
        """Replica side of sync: apply the primary's delta batch in
        watermark order (idempotent — entries at or below the replica's
        watermark are skipped). Returns the replica's new watermark."""
        sh = self._get_shard(table, shard, None, replica=True)
        with sh.lock:
            for e in sorted(delta["entries"], key=lambda d: d["wm"]):
                if e["wm"] <= sh.wm:
                    continue
                if e["wm"] != sh.wm + 1:
                    raise StaleShardMapError(
                        f"replica {table}/{shard} delta gap: at wm "
                        f"{sh.wm}, next entry {e['wm']} — full resync "
                        "required"
                    )
                raw_ids = np.asarray(e["ids"], np.int32)
                raw_vals = np.asarray(e["rows"], np.float32)
                # pow2-pad like the client's push protocol (sentinel -1
                # rows drop in the apply) so device-mode replicas land on
                # the same handful of compiled programs as primaries
                n = 256
                while n < raw_ids.shape[0]:
                    n <<= 1
                ids = np.full((n,), -1, np.int32)
                ids[: raw_ids.shape[0]] = raw_ids
                vals = np.zeros((n, raw_vals.shape[1]
                                 if raw_vals.ndim == 2 else sh.rows.shape[1]),
                                np.float32)
                vals[: raw_vals.shape[0]] = raw_vals
                if self._use_device():
                    sh.rows = self._apply_fn(
                        tuple(sh.rows.shape), ids.shape[0])(
                        sh.rows, ids, vals, np.float32(e["scale"]))
                else:
                    self._host_apply(sh.rows, ids, vals, e["scale"])
                sh.wm = e["wm"]
                cid = str(e.get("client_id", ""))
                if cid:
                    sh.applied[cid] = max(
                        sh.applied.get(cid, -1), int(e.get("seq", -1)))
            new_wm = sh.wm
        _REPLICA_SYNCS.inc()
        return new_wm

    def sync_replica_from(self, transport, primary: int, table: str,
                          shard: int) -> int:
        """One replica sync round against the primary over the
        transport: delta when the log reaches, full copy otherwise.
        Returns the replica's post-sync watermark."""
        try:
            since = self.replica_watermark(table, shard)
        except StaleShardMapError:
            since = -1
        if since >= 0:
            if hasattr(transport, "fetch_delta_stream"):
                # streaming lane: apply chunk by chunk so a
                # mid-stream drop leaves the replica consistently at
                # whatever watermark the applied prefix reached — the
                # next round resumes from there, and any re-sent
                # entries fall to apply_replica_delta's idempotent
                # watermark fence (no double-apply)
                found = True
                wm = since
                for frame in transport.fetch_delta_stream(
                        primary, table, shard, since):
                    if not frame.get("found", True):
                        found = False
                        break
                    if frame["entries"]:
                        wm = self.apply_replica_delta(
                            table, shard,
                            {"wm": frame["wm"],
                             "entries": frame["entries"]})
                    else:
                        wm = max(wm, int(frame.get("wm", wm)))
                if found:
                    return wm
            else:
                delta = transport.fetch_delta(
                    primary, table, shard, since)
                if delta is not None:
                    return self.apply_replica_delta(table, shard, delta)
            _REPLICA_RESYNCS.inc()
        payload = transport.fetch_shard(primary, table, shard)
        self.install_replica(table, shard, payload)
        return int(payload.get("wm", 0))

    # -------------------------------------------------------------- #
    # sharded save/restore (training/checkpoint.py delegates here)

    def save(self, directory: str, tables: Optional[List[str]] = None) -> int:
        """Write every resident shard (of `tables`, default all) as one
        atomic file each; returns how many were written. Layout:
        ``<dir>/emb/<table>-shard<id>.npz`` with the rows and the
        exactly-once watermarks — a restore resumes the fence, so a push
        replayed from before the save still dedupes."""
        written = 0
        for table, shard in self.resident_shards():
            if tables is not None and table not in tables:
                continue
            payload = self.extract_shard(table, shard)
            save_shard_file(directory, table, shard, payload)
            written += 1
        return written

    def restore_missing(self, directory: str) -> int:
        """Install any checkpointed shard for this owner's current map
        that is not yet resident (kill-worker recovery path); returns how
        many were restored. Shards with no file stay absent — attach()
        decides whether to re-materialize from seed."""
        restored = 0
        with self._lock:
            tables = dict(self._tables)
            num_shards = self._num_shards
        for table in tables:
            for shard in range(num_shards):
                with self._lock:
                    if (table, shard) in self._shards:
                        continue
                payload = load_shard_file(directory, table, shard)
                if payload is not None:
                    self.install_shard(table, shard, payload)
                    restored += 1
        return restored




# ------------------------------------------------------------------ #
# shard files (atomic tmp+replace; EDL305 discipline)


def _shard_path(directory: str, table: str, shard: int) -> str:
    return os.path.join(directory, "emb", f"{table}-shard{shard:05d}.npz")


def save_shard_file(directory: str, table: str, shard: int,
                    payload: Dict[str, Any]) -> str:
    path = _shard_path(directory, table, shard)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    buf = io.BytesIO()
    np.savez(
        buf, rows=(_host_copy(payload["rows"])
                   if isinstance(payload["rows"], torch.Tensor)
                   else np.asarray(payload["rows"], np.float32)),
        applied=np.frombuffer(
            json.dumps(payload["applied"]).encode(), np.uint8),
        wm=np.asarray(int(payload.get("wm", 0)), np.int64),
    )
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
        f.flush()
        # a torn shard file would restore silently-wrong rows; fsync +
        # atomic replace, same contract as the control-plane journal:
        # edl-lint: disable=EDL403
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def peek_shard_watermark(directory: str, table: str,
                         shard: int) -> Optional[int]:
    """The checkpoint file's push watermark WITHOUT materializing the
    rows (npz members load lazily) — the replica-vs-checkpoint
    freshness arbitration on the recovery critical path must not pay a
    full shard read per candidate."""
    path = _shard_path(directory, table, shard)
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            return int(z["wm"]) if "wm" in z.files else 0
    except (OSError, ValueError, KeyError):
        logger.exception("embedding shard file %s unreadable; ignored", path)
        return None


def load_shard_file(directory: str, table: str,
                    shard: int) -> Optional[Dict[str, Any]]:
    path = _shard_path(directory, table, shard)
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            rows = z["rows"]
            applied = json.loads(bytes(z["applied"]).decode())
            # pre-watermark files load at wm 0 — conservative:
            # every cached row fetched before the restore reads stale
            wm = int(z["wm"]) if "wm" in z.files else 0
    except (OSError, ValueError, KeyError):
        logger.exception("embedding shard file %s unreadable; ignored", path)
        return None
    return {"rows": rows, "wm": wm,
            "applied": {str(k): int(v) for k, v in applied.items()}}
