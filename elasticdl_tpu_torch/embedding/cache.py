"""Worker-local staleness-bounded hot-row cache (ISSUE 13, read layer 1).

The measurement that motivates it is PR 11's own telemetry: on the
zipf(1.3) bench stream the Space-Saving sketch reports
``hot_id_share ~= 0.69`` against a 0.11 dedupe ratio — a small head of
the id distribution carries most pull traffic, so a bounded worker-local
cache over that head absorbs most reads without touching the owning
shard (the Google ads training-infra trick, 2501.10546).

Freshness is **watermark-fenced**, not TTL'd: every owner shard counts
applied pushes (store.py ``_Shard.wm``), pulls and push acks carry the
count, and the client tracks the highest watermark it has OBSERVED per
(table, shard). A cached row tagged with the watermark at which it was
fetched is served only while

    ``entry_wm + staleness_bound >= observed_owner_wm``

i.e. the row is at most ``staleness_bound`` *pushes* behind what the
client knows the owner has absorbed. The unit is writes, not seconds: a
quiet table never goes stale, a hot one ages exactly as fast as it is
written. The bound is conservative — the watermark is per *shard*, so a
row can read stale because its neighbours were written — which keeps the
contract one-sided: a hit is never MORE than ``staleness_bound`` pushes
old, misses are merely wasted freshness.

Write-through keeps the worker's own training loop hot: after a push
acks, pushed rows whose cache entry was fresh as of the pre-push
watermark get the delta applied in place and re-tagged at the post-push
watermark (the common single-writer recsys case); entries that
interleaved with someone else's push are dropped instead of patched.

Everything is vectorized: per table the cache is a dense
``slot_of[vocab]`` index (int32 — 4 bytes/vocab-row, small next to the
table itself) plus slot-major rows/watermark/recency arrays, so a batch
lookup is a handful of numpy gathers, never a Python loop over ids.
Eviction is batch-LRU: recency ticks advance per lookup, and an
over-full insert evicts the oldest-ticked slots via one argpartition.

Invalidation is all-or-nothing on shard-map change: a reshard commit or
map-epoch bump re-keys shard ownership AND watermark history, so the
client drops the whole cache (`invalidate_all`) rather than reason about
which entries survive — correctness over warmth, reshards are rare.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Optional, Tuple

import numpy as np

from elasticdl_tpu_torch.observability.registry import default_registry

_reg = default_registry()
_HITS = _reg.counter(
    "edl_embedding_cache_hits_total",
    "pull ids (occurrence-weighted) served from the worker-local "
    "hot-row cache")
_MISSES = _reg.counter(
    "edl_embedding_cache_misses_total",
    "pull ids (occurrence-weighted) that went to the owning shard")
_STALE_EVICTIONS = _reg.counter(
    "edl_embedding_cache_stale_evictions_total",
    "cached rows evicted by the watermark staleness fence")
_INVALIDATIONS = _reg.counter(
    "edl_embedding_cache_invalidations_total",
    "full cache drops (reshard commit / shard-map epoch change)")

#: recent-lookup window backing the heartbeat payload's cache hit rate
#: (cumulative counters cannot forget a cold start — a hot-set migration
#: must show up as a FRESH collapse, which is what the alert rule reads)
RECENT_WINDOW = 128


class _TableCache:
    """One table's slot store (all arrays slot-major; no per-id Python).

    Guarded by the owning HotRowCache's lock."""

    __slots__ = ("vocab", "dim", "capacity", "slot_of", "ids", "rows",
                 "wm", "tick_of", "free", "tick")

    def __init__(self, vocab: int, dim: int, capacity: int):
        self.vocab = int(vocab)
        self.dim = int(dim)
        self.capacity = int(capacity)
        self.slot_of = np.full(self.vocab, -1, np.int32)
        self.ids = np.full(self.capacity, -1, np.int64)
        self.rows = np.zeros((self.capacity, self.dim), np.float32)
        self.wm = np.zeros(self.capacity, np.int64)
        self.tick_of = np.zeros(self.capacity, np.int64)
        self.free = list(range(self.capacity - 1, -1, -1))
        self.tick = 0

    def _evict_slots(self, slots: np.ndarray) -> None:
        if not slots.size:
            return
        self.slot_of[self.ids[slots]] = -1
        self.ids[slots] = -1
        self.free.extend(int(s) for s in slots)


class HotRowCache:
    """Staleness-bounded LRU over hot embedding rows, one slot store per
    table. ``staleness_bound`` is in push-watermark units (see module
    doc); ``capacity_rows`` bounds EACH table's slots (the per-table hot
    set is what the sketch sizes — docs/performance.md "Embedding read
    path")."""

    def __init__(self, capacity_rows: int, staleness_bound: int = 1):
        if capacity_rows <= 0:
            raise ValueError("capacity_rows must be > 0 (0 = cache off: "
                             "don't construct one)")
        if staleness_bound < 0:
            raise ValueError("staleness_bound must be >= 0")
        self.capacity_rows = int(capacity_rows)
        self.staleness_bound = int(staleness_bound)
        self._lock = threading.Lock()
        self._tables: Dict[str, _TableCache] = {}      # guarded_by: _lock
        # rolling (hits, total) per lookup — recent hit rate
        self._recent: "deque" = deque(maxlen=RECENT_WINDOW)  # guarded_by: _lock
        self.hits = 0          # occurrence-weighted, cumulative
        self.misses = 0
        self.stale_evictions = 0

    def _table_locked(self, name: str, vocab: int,
                      dim: int) -> _TableCache:  # holds: _lock
        tc = self._tables.get(name)
        if tc is None:
            tc = _TableCache(vocab, dim, self.capacity_rows)
            self._tables[name] = tc
        return tc

    # -------------------------------------------------------------- #

    def lookup(
        self, table: str, vocab: int, dim: int, uniq: np.ndarray,
        owner_wm: np.ndarray, num_shards: int,
        counts: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Batch probe: ``(hit_mask, rows_for_hits)`` over sorted-unique
        in-range ``uniq``. ``owner_wm`` is the client's per-shard
        observed-watermark array; entries past the staleness fence are
        evicted (counted) and read as misses. ``counts`` weights the
        hit/miss accounting by raw occurrences — the cache exists to
        absorb *traffic*, so its hit rate is traffic-weighted."""
        with self._lock:
            tc = self._table_locked(table, vocab, dim)
            tc.tick += 1
            slots = tc.slot_of[uniq]
            found = slots >= 0
            hit_mask = np.zeros(uniq.shape[0], bool)
            rows = None
            if found.any():
                fidx = np.flatnonzero(found)
                fs = slots[fidx].astype(np.int64)
                shards = uniq[fidx] % num_shards
                fresh = (tc.wm[fs] + self.staleness_bound
                         >= owner_wm[shards])
                stale_slots = fs[~fresh]
                if stale_slots.size:
                    tc._evict_slots(stale_slots)
                    n_stale = int(stale_slots.size)
                    self.stale_evictions += n_stale
                    _STALE_EVICTIONS.inc(n_stale)
                hit_idx = fidx[fresh]
                hit_mask[hit_idx] = True
                hs = fs[fresh]
                rows = tc.rows[hs].copy()
                tc.tick_of[hs] = tc.tick
            if counts is None:
                h = int(hit_mask.sum())
                m = int(uniq.shape[0] - h)
            else:
                h = int(counts[hit_mask].sum())
                m = int(counts.sum()) - h
            self.hits += h
            self.misses += m
            _HITS.inc(h)
            _MISSES.inc(m)
            self._recent.append((h, h + m))
            return hit_mask, rows

    def insert(self, table: str, vocab: int, dim: int, ids: np.ndarray,
               rows: np.ndarray, wms: np.ndarray) -> None:
        """Admit freshly-pulled rows tagged with the watermark their
        serving response carried (per-id — rows from different shards
        land at different watermarks). Overwrites resident entries in
        place; over-capacity admission evicts the oldest-ticked slots."""
        if not ids.size:
            return
        with self._lock:
            tc = self._table_locked(table, vocab, dim)
            slots = tc.slot_of[ids]
            have = slots >= 0
            hs = slots[have].astype(np.int64)
            tc.rows[hs] = rows[have]
            tc.wm[hs] = wms[have]
            tc.tick_of[hs] = tc.tick
            need_idx = np.flatnonzero(~have)
            n = need_idx.size
            if not n:
                return
            if n > tc.capacity:
                # admit only the LAST capacity rows (arbitrary but
                # deterministic); a batch larger than the whole cache
                # cannot be fully resident anyway
                need_idx = need_idx[-tc.capacity:]
                n = tc.capacity
            short = n - len(tc.free)
            if short > 0:
                occupied = np.flatnonzero(tc.ids >= 0)
                oldest = occupied[np.argpartition(
                    tc.tick_of[occupied], short - 1)[:short]]
                tc._evict_slots(oldest)
            # C-speed bulk pop off the free stack (a per-slot .pop()
            # loop measured 2.6 ms per batch — the cache must not cost
            # what it saves)
            take = np.asarray(tc.free[len(tc.free) - n:], np.int64)
            del tc.free[len(tc.free) - n:]
            tc.ids[take] = ids[need_idx]
            tc.rows[take] = rows[need_idx]
            tc.wm[take] = wms[need_idx]
            tc.tick_of[take] = tc.tick
            tc.slot_of[ids[need_idx]] = take.astype(np.int32)

    def write_through(
        self, table: str, ids: np.ndarray, deltas: np.ndarray,
        num_shards: int, prev_wm: np.ndarray, new_wm: np.ndarray,
    ) -> None:
        """The worker's own push landed: patch pushed rows in place.

        Sound only for entries that were fresh as of the pre-push
        watermark AND whose shard advanced by exactly our one push
        (``new_wm == prev_wm + 1``): then ``cached + delta`` IS the row
        at ``new_wm``. Anything else — an interleaved foreign push, an
        entry fetched before other writes — is dropped, not patched; it
        would otherwise be re-tagged fresh while missing writes."""
        if not ids.size:
            return
        with self._lock:
            tc = self._tables.get(table)
            if tc is None:
                return
            slots = tc.slot_of[ids]
            have = slots >= 0
            if not have.any():
                return
            hidx = np.flatnonzero(have)
            hs = slots[hidx].astype(np.int64)
            shards = ids[hidx] % num_shards
            clean = ((new_wm[shards] == prev_wm[shards] + 1)
                     & (tc.wm[hs] == prev_wm[shards]))
            cs = hs[clean]
            tc.rows[cs] += deltas[hidx[clean]]
            tc.wm[cs] = new_wm[shards[clean]]
            tc.tick_of[cs] = tc.tick
            tc._evict_slots(hs[~clean])

    def invalidate_all(self) -> None:
        """Shard-map change: ownership and watermark history re-keyed —
        drop everything (reshard commit / map epoch bump / promotion)."""
        with self._lock:
            self._tables.clear()
            self._recent.clear()
        _INVALIDATIONS.inc()

    # -------------------------------------------------------------- #

    def hit_rate(self) -> float:
        """Traffic-weighted hit rate over the recent lookup window (the
        heartbeat/alert signal: a hot-set migration collapses THIS, even
        hours into a job whose lifetime counters look fine)."""
        with self._lock:
            h = sum(x for x, _ in self._recent)
            t = sum(x for _, x in self._recent)
        return (h / t) if t else 0.0

    def stats(self) -> Dict[str, float]:
        with self._lock:
            resident = sum(
                int((tc.ids >= 0).sum()) for tc in self._tables.values())
        total = self.hits + self.misses
        return {
            "hits": self.hits, "misses": self.misses,
            "stale_evictions": self.stale_evictions,
            "resident_rows": resident,
            "hit_rate": round(self.hits / total, 4) if total else 0.0,
            "recent_hit_rate": round(self.hit_rate(), 4),
        }
