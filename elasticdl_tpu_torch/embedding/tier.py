"""The worker side of the embedding tier: per-batch deduped, per-shard
batched pull -> compute -> push.

Reference parity: elasticdl/python/worker/worker.py's
pull_embedding_vectors / push_gradients — but where the reference paid
one RPC pair per PS pod per minibatch with the FULL id stream, this
client (1) DEDUPES the batch's ids once (`np.unique`), (2) groups the
unique ids by owning shard with vectorized modulo math, (3) issues ONE
batched call per shard (never per row — edl-lint EDL206 polices the
per-row anti-pattern), and (4) sums duplicate gradients client-side
(sorted segment reduce) so the owner applies one deduped scatter-add.
On skewed (production recsys) id distributions the deduped stream is a
fraction of the raw batch — `edl_embedding_dedupe_ratio` measures it.

Request lengths are padded to power-of-two buckets (sentinel id -1) so
the owner's jitted pull/apply programs stay in a handful of
compile-cache entries per table instead of recompiling per batch shape.

Exactly-once pushes: every `push()` call takes one sequence number and
sends it to every touched shard; any retry — lost ack, stale shard map
mid-resharding, owner handoff — re-sends the SAME seq, and the store's
per-(shard, client) watermark turns duplicates into acked no-ops. A
push returns only when every shard acked, so a client that returns from
`push()` KNOWS the update landed exactly once.

The serving-grade READ path (ISSUE 13) stacks three switchable layers
on top, each taking traffic off the owner RPC:

1. **hot-row cache** (`cache_rows > 0`): a worker-local staleness-
   bounded LRU over unique ids (embedding/cache.py) consulted before
   any shard call — only misses travel; responses carry the shard push
   watermark that fences freshness, the worker's own pushes write
   through, and any shard-map change drops the cache whole.
2. **read replicas** (`read_replicas=True` + a master map carrying
   replica assignments): misses fan out to the least-loaded replica of
   each shard; a replica answering from further back than the staleness
   bound is rejected and the primary serves. Writes NEVER go to
   replicas.
3. **pull pipeline** (`EmbeddingPullPipeline`): step N+1's pull issued
   while step N computes — `get()` blocks only on what compute did not
   already cover, which is the only part that still bills the goodput
   ledger's `emb_pull_blocked`. `drain()` hands back in-flight id
   batches on rescale/reshard so they re-issue under the fresh map.

tier_stats() reports the two latencies the split creates: `emb_pull_
p99_ms` (owner RPC rounds only — what the embedding_pull_p99 alert
pages on) vs `emb_read_p99_ms` (effective reads, cache included).
"""

from __future__ import annotations

import threading
import time
import uuid
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from elasticdl_tpu_torch.common import faults
from elasticdl_tpu_torch.common.log_utils import default_logger
from elasticdl_tpu_torch.embedding import sharding
from elasticdl_tpu_torch.embedding.cache import HotRowCache
from elasticdl_tpu_torch.embedding.sketch import DecayingSpaceSaving, SpaceSaving
from elasticdl_tpu_torch.embedding.store import StaleShardMapError
from elasticdl_tpu_torch.embedding.transport import (
    DEGRADED_READS,
    OwnerUnavailableError,
)
from elasticdl_tpu_torch.observability import reqtrace
from elasticdl_tpu_torch.observability.registry import (
    default_registry,
    quantile_sorted,
)

logger = default_logger(__name__)

_reg = default_registry()
_PULL_S = _reg.histogram(
    "edl_embedding_pull_seconds", "client pull wall time per batch")
_PUSH_S = _reg.histogram(
    "edl_embedding_push_seconds", "client push wall time per batch")
_PULL_IDS = _reg.counter(
    "edl_embedding_pull_ids_total", "raw ids in pulled batches")
_PULL_UNIQUE = _reg.counter(
    "edl_embedding_pull_unique_ids_total", "deduped ids actually requested")
_PUSH_IDS = _reg.counter(
    "edl_embedding_push_ids_total", "raw ids in pushed batches")
_PUSH_SENT = _reg.counter(
    "edl_embedding_push_ids_sent_total", "deduped ids actually sent")
_DEDUPE_RATIO = _reg.gauge(
    "edl_embedding_dedupe_ratio",
    "ids sent / ids in batch, most recent push (1.0 = no duplicates)")
_REFRESHES = _reg.counter(
    "edl_embedding_map_refreshes_total",
    "shard-map refreshes forced by stale-map/owner errors")
_RETRIES = _reg.counter(
    "edl_embedding_push_retries_total",
    "push rounds re-sent after an error (seq fence dedupes)")
_SHARD_CALLS = _reg.histogram(
    "edl_embedding_shard_batch_ids",
    "deduped ids per per-shard call (batching effectiveness)")
# skew telemetry (ISSUE 11): the measurement ground for the hot-row
# cache / read replicas (ROADMAP 1) — docs/observability.md "Embedding
# skew telemetry"
_HOT_SHARE = _reg.gauge(
    "edl_embedding_hot_id_share",
    "guaranteed lower bound on the share of pull traffic carried by the "
    "Space-Saving sketch's top-K ids (1.0 = all traffic hits K ids)")
_SHARD_IMBALANCE = _reg.gauge(
    "edl_embedding_shard_load_imbalance",
    "max per-shard pull load over the uniform mean (1.0 = perfectly "
    "balanced shards)")
_SHARD_LOAD = _reg.gauge(
    "edl_embedding_client_shard_load_rows",
    "deduped rows this client pulled per shard (rolling window)",
    labels=("shard",))
# read-path telemetry (ISSUE 13): per-shard replica serves are bounded
# by --embedding_shards (config, not data): edl-lint: disable=EDL405
_REPLICA_READS = _reg.counter(
    "edl_embedding_replica_reads_total",
    "per-shard pulls served by a read replica (within the staleness "
    "bound) instead of the primary", labels=("shard",))
_REPLICA_STALE = _reg.counter(
    "edl_embedding_replica_stale_rejects_total",
    "replica answers rejected for exceeding the staleness bound "
    "(primary re-served the shard)")
_PIPE_DEPTH = _reg.gauge(
    "edl_embedding_pull_pipeline_depth",
    "configured lookahead of the newest pull pipeline (0 = pipeline off)")
_PIPE_BLOCKED_S = _reg.histogram(
    "edl_embedding_pull_pipeline_blocked_seconds",
    "time get() actually waited on a pipelined pull — the residual the "
    "compute overlap did not cover")


_GOODPUT_LEDGER = None
#: set on pipeline worker threads: a background pull overlaps compute,
#: so its wall time must NOT bill the goodput ledger's emb_pull_blocked
#: (only the get()-side residual wait does) nor the effective-read
#: latency window
_BILL_TLS = threading.local()


def _goodput_pull(seconds: float) -> None:
    """Tee pull wall time into the process goodput ledger: client pulls
    block the step (the pull pipeline exists to change that), so they
    are the `emb_pull_blocked` category — distinct from compute, which
    times only the jitted step dispatch. Pipeline worker threads are
    exempt (their pulls overlap compute; the residual `get()` wait
    bills instead). The ledger reference is cached after the first pull
    (same idiom as StepProfiler's tee): this runs per pull on the step
    path and must not pay the singleton lock every time. (Tests calling
    goodput.reset_for_tests may leave a stale cached ledger here — adds
    then land on a detached ledger, which is harmless; nothing asserts
    on it across resets.)"""
    if getattr(_BILL_TLS, "off", False):
        return
    global _GOODPUT_LEDGER
    if _GOODPUT_LEDGER is None:
        from elasticdl_tpu_torch.observability import goodput

        _GOODPUT_LEDGER = goodput.get_ledger()
    _GOODPUT_LEDGER.add("emb_pull_blocked", seconds)


#: rolling window of recent client pull/push wall times backing the
#: heartbeat payload's emb_pull_p99_ms (the cumulative histogram cannot
#: forget a quiet past, so a fresh spike would be diluted)
LATENCY_WINDOW = 128

#: smallest pow2 padding bucket — below this, padding overhead dominates
MIN_BUCKET = 256


def pad_pow2(n: int) -> int:
    b = MIN_BUCKET
    while b < n:
        b <<= 1
    return b


def _dedupe_sum(ids: np.ndarray, rows: np.ndarray):
    """(sorted unique ids, per-unique summed rows): ONE argsort + one
    gather + one segment reduce — the client half of the deduped push
    (duplicate ids ADD, matching sparse-gradient semantics). Sorted
    output is part of the protocol: the store's fast path is a
    vectorized unique-index add gated on sorted-unique input."""
    order = np.argsort(ids, kind="stable")
    sids = ids[order]
    is_start = np.empty(sids.shape[0], bool)
    is_start[0] = True
    np.not_equal(sids[1:], sids[:-1], out=is_start[1:])
    starts = np.flatnonzero(is_start)
    if starts.shape[0] == sids.shape[0]:
        return sids, rows[order]
    return sids[starts], np.add.reduceat(rows[order], starts, axis=0)


class _MultiSub:
    """One (table, shard) sub-pull of a fused multi-table round (ISSUE
    18): the per-shard padded request plus where its rows scatter back
    (`sel` indexes the table's miss stream)."""

    __slots__ = ("table", "shard", "sel", "n", "padded", "target",
                 "is_replica")

    def __init__(self, table: str, shard: int, sel: np.ndarray, n: int,
                 padded: np.ndarray, target: int, is_replica: bool):
        self.table = table
        self.shard = shard
        self.sel = sel
        self.n = n
        self.padded = padded
        self.target = target
        self.is_replica = is_replica


class EmbeddingTierClient:
    """Per-worker handle on the tier: a shard-map view + a transport.

    `map_fetch` returns the CURRENT ShardMapView (workers wire the
    master's GetEmbeddingShardMap RPC; tests/bench hand a closure over a
    ShardMapOwner). The client refreshes on any stale-map or dead-owner
    error and replays the affected call — pushes under the same seq, so
    resharding mid-push is exactly-once by construction."""

    def __init__(
        self,
        map_fetch: Callable[[], sharding.ShardMapView],
        transport,
        client_id: str,
        dedupe: bool = True,
        max_retries: int = 8,
        retry_backoff_s: float = 0.05,
        fanout_workers: int = 0,
        sketch_k: int = 0,
        sketch_every: int = 1,
        sketch_window: int = 0,
        cache_rows: int = 0,
        cache_staleness: int = 1,
        read_replicas: bool = False,
    ):
        self._map_fetch = map_fetch
        self._transport = transport
        self._wm_replica_ok: Optional[bool] = None  # lazy capability probe
        self._pull_multi_ok: Optional[bool] = None  # lazy capability probe
        # incarnation-scoped identity: the stores' seq watermarks OUTLIVE
        # this client (they ride drain checkpoints and shard migrations),
        # so a relaunched worker reusing a bare worker-id client_id would
        # restart seq at 1 and have its first pushes silently swallowed
        # as duplicates. The nonce makes every client incarnation its own
        # watermark namespace; exactly-once across a relaunch boundary is
        # the task-accounting layer's job (a re-run task re-pushes on
        # purpose — its pre-crash work was never reported done).
        self.client_id = f"{client_id}:{uuid.uuid4().hex[:8]}"
        self.dedupe = dedupe
        self._max_retries = max_retries
        self._backoff_s = retry_backoff_s
        self._lock = threading.Lock()
        self._view: Optional[sharding.ShardMapView] = None  # guarded_by: _lock
        self._seq = 0                                        # guarded_by: _lock
        # skew telemetry (ISSUE 11), all under the client's leaf lock:
        # the Space-Saving sketch observes every deduped pull stream
        # (0 = default K_DEFAULT; its own leaf lock), per-shard load
        # counts feed the imbalance gauge, and bounded recent-latency
        # windows back the heartbeat payload's p99s (appends AND the
        # tier_stats sort both take _lock: iterating a deque while
        # another thread appends raises "mutated during iteration")
        # sketch_window > 0 switches to the exponential-decay variant
        # (ISSUE 20): the sketch halves itself every `window` stream
        # weight, so hot_share and the exported head track RECENT
        # traffic — after a popularity flip the new head overtakes the
        # old one within a couple of windows instead of letting a job-
        # lifetime cumulative count chase yesterday's distribution. The
        # layout controller's promotion/demotion both read this head.
        k = sketch_k if sketch_k > 0 else 128
        self.sketch = (DecayingSpaceSaving(k, window=sketch_window)
                       if sketch_window > 0 else SpaceSaving(k))
        # sketch feed sampling (ISSUE 13): the Space-Saving update is
        # per-unique-id PYTHON heap work — at serving rates it becomes
        # the pull's dominant cost (profiled ~75% of a cached pull) and,
        # being GIL-bound, the one thing a background pipeline pull
        # cannot overlap. hot_share is a traffic statistic: feeding
        # every Nth batch estimates it unbiasedly over the stream.
        # Default 1 (every batch — ISSUE 11's exact-telemetry contract);
        # serving-grade read paths sample (bench uses the staleness
        # stride; docs/performance.md "Embedding read path").
        self.sketch_every = max(1, int(sketch_every))
        self._sketch_tick = 0                                # guarded_by: _lock
        self._shard_loads: Optional[np.ndarray] = None      # guarded_by: _lock
        # LATENCY SPLIT (ISSUE 13 bugfix): `_pull_times` records OWNER
        # RPC rounds only — what the embedding_pull_p99 alert pages on;
        # a cache serving most reads must not dilute it. `_read_times`
        # records the effective read the step saw (cache included, and
        # pipelined reads record only their residual get() wait).
        self._pull_times: "deque[float]" = deque(maxlen=LATENCY_WINDOW)  # guarded_by: _lock
        self._read_times: "deque[float]" = deque(maxlen=LATENCY_WINDOW)  # guarded_by: _lock
        self._push_times: "deque[float]" = deque(maxlen=LATENCY_WINDOW)  # guarded_by: _lock
        # read path (ISSUE 13): hot-row cache + per-(table, shard)
        # OBSERVED owner push watermarks (the staleness fence's "what
        # the owner is known to have absorbed") + replica read-target
        # rolling loads + pipeline lookahead (the newest pipeline's)
        self.staleness_bound = max(0, int(cache_staleness))
        if cache_rows > 0 and not dedupe:
            # the cache (and its write-through) assumes the sorted-
            # unique deduped protocol; a non-deduping client is the
            # reference-PS baseline shape and gets no cache
            raise ValueError(
                "embedding cache requires the deduping client "
                "(dedupe=True)")
        self.cache: Optional[HotRowCache] = (
            HotRowCache(cache_rows, self.staleness_bound)
            if cache_rows > 0 else None)
        self.read_replicas = bool(read_replicas)
        self._owner_wm: Dict[str, np.ndarray] = {}          # guarded_by: _lock
        self._target_loads: Dict[int, int] = {}             # guarded_by: _lock
        self._pipeline_depth = 0
        # freshness probes: a FULLY cache-served pull touches no shard,
        # so the observed watermark would never advance and the
        # staleness fence would never fire for a read-mostly client —
        # every `wm_probe_every` consecutive full-hit lookups per table,
        # ask each primary for its bare watermark (no rows on the wire).
        # The worker's own push acks make this a no-op in training.
        self.wm_probe_every = 16
        self._full_hits: Dict[str, int] = {}                # guarded_by: _lock
        self.refresh()
        # fanout_workers > 0: per-shard calls to distinct owners run
        # concurrently — right for REMOTE transports, where the calls
        # are network-bound and genuinely overlap. The in-process
        # LocalTransport default stays inline: measured on this box,
        # thread fan-in over GIL-holding numpy work on small deduped
        # arrays is a net LOSS (~2x) over inline dispatch.
        self._pool: Optional[ThreadPoolExecutor] = None
        if fanout_workers > 0 and self.view.num_shards > 1:
            self._pool = ThreadPoolExecutor(
                max_workers=min(fanout_workers, self.view.num_shards),
                thread_name_prefix=f"emb-{client_id}",
            )

    def _fanout(self, calls) -> None:
        """Run the per-shard thunks, concurrently when a pool exists.
        Thunks handle their own errors (they record failures for the
        caller's retry round) — every shard's attempt completes before
        this returns."""
        if self._pool is None or len(calls) <= 1:
            for c in calls:
                c()
            return
        for f in [self._pool.submit(c) for c in calls]:
            f.result()

    # -------------------------------------------------------------- #

    def refresh(self) -> sharding.ShardMapView:
        view = self._map_fetch()
        # owner address book (ISSUE 15): a remote transport learns where
        # the owners serve from the same response that names them —
        # adopted BEFORE the view swap so no call routes to an owner
        # whose address the transport does not know yet
        if view.addrs and hasattr(self._transport, "update_addresses"):
            self._transport.update_addresses(dict(view.addrs))
        invalidate = False
        with self._lock:
            old = self._view
            self._view = view
            if old is not None and (old.version != view.version
                                    or old.num_shards != view.num_shards):
                # shard-map change: ownership AND watermark history are
                # re-keyed (a migrated shard's watermark traveled, but a
                # promoted/restored one may not line up) — drop the
                # whole cache and the observed-watermark state rather
                # than reason per entry. Reshards are rare; staleness
                # bugs are forever.
                invalidate = True
                self._owner_wm.clear()
                self._target_loads.clear()
        if invalidate and self.cache is not None:
            self.cache.invalidate_all()
        # ultra-hot promotion (ISSUE 20): a NEW hot set on the map is
        # the layout controller telling every worker "these ids carry
        # the head of the traffic — hold them locally". Warm them
        # through the normal pull path (cache write-through + staleness
        # fences apply; they stay resident by being genuinely hot).
        # Best-effort: a failed prefetch is just a later cache miss.
        if (self.cache is not None and view.hot_ids
                and (old is None or tuple(old.hot_ids)
                     != tuple(view.hot_ids))):
            self._prefetch_hot(view)
        return view

    def _prefetch_hot(self, view: sharding.ShardMapView) -> None:
        hot = np.asarray(view.hot_ids, np.int64)
        for spec in view.tables:
            ids = hot[(hot >= 0) & (hot < spec.vocab)]
            if not ids.size:
                continue
            try:
                self.pull(spec.name, ids)
            except Exception:
                logger.debug("hot-set prefetch failed for %r (ignored)",
                             spec.name, exc_info=True)

    def _owner_wm_locked(self, table: str, num_shards: int) -> np.ndarray:
        arr = self._owner_wm.get(table)
        if arr is None or arr.shape[0] != num_shards:
            arr = np.zeros(num_shards, np.int64)
            self._owner_wm[table] = arr
        return arr

    def _note_wm(self, table: str, num_shards: int, shard: int,
                 wm: int) -> None:
        """Advance the observed owner watermark (monotonic: a replica's
        lagging answer never walks freshness knowledge backwards)."""
        with self._lock:
            arr = self._owner_wm_locked(table, num_shards)
            if wm > arr[shard]:
                arr[shard] = wm

    @property
    def view(self) -> sharding.ShardMapView:
        with self._lock:
            return self._view

    def table(self, name: str) -> sharding.TableSpec:
        for t in self.view.tables:
            if t.name == name:
                return t
        raise KeyError(f"table {name!r} not registered with the tier")

    def _next_seq(self) -> int:
        with self._lock:
            self._seq += 1
            return self._seq

    # -------------------------------------------------------------- #
    # pull

    def pull(self, table: str, ids: np.ndarray) -> np.ndarray:
        """Batch lookup: int ids of any shape -> vectors of shape
        ``ids.shape + (dim,)``. Negative ids (bag padding sentinels)
        return zero vectors. One deduped, pow2-padded call per shard."""
        t0 = time.perf_counter()
        spec = self.table(table)
        flat = np.asarray(ids).reshape(-1).astype(np.int64)
        valid = (flat >= 0) & (flat < spec.vocab)
        all_valid = bool(valid.all())
        vids = flat if all_valid else flat[valid]
        _PULL_IDS.inc(int(flat.shape[0]))
        if not vids.shape[0]:
            out = np.zeros((flat.shape[0], spec.dim), np.float32)
        else:
            if self.dedupe:
                uniq, inverse, id_counts = np.unique(
                    vids, return_inverse=True, return_counts=True)
            else:
                uniq, inverse, id_counts = vids, None, None
            _PULL_UNIQUE.inc(int(uniq.shape[0]))
            # skew measurement: the sketch sees every id's true
            # occurrence weight (one dict op per UNIQUE id), sampled at
            # the configured batch stride
            if self._sketch_due():
                self.sketch.update_batch(uniq, id_counts)
            vectors = self._pull_unique(table, spec, uniq, id_counts)
            expanded = vectors if inverse is None else vectors[inverse]
            if all_valid:
                out = expanded
            else:
                out = np.zeros((flat.shape[0], spec.dim), np.float32)
                out[valid] = expanded
        dt = time.perf_counter() - t0
        _PULL_S.observe(dt)
        _goodput_pull(dt)
        self._note_read_time(dt)
        return out.reshape(*np.asarray(ids).shape, spec.dim)

    def _sketch_due(self) -> bool:
        if self.sketch_every == 1:
            return True
        with self._lock:
            due = self._sketch_tick % self.sketch_every == 0
            self._sketch_tick += 1
        return due

    def _note_read_time(self, dt: float) -> None:
        """Effective-read latency window — skipped on pipeline worker
        threads (the step never saw that wall; get()'s residual wait is
        recorded instead)."""
        if getattr(_BILL_TLS, "off", False):
            return
        with self._lock:
            self._read_times.append(dt)

    def _pull_unique(self, table: str, spec, uniq: np.ndarray,
                     counts: Optional[np.ndarray] = None) -> np.ndarray:
        """The read path over a sorted-unique in-range id stream: hot-row
        cache first (watermark-fenced), owner/replica shard calls for
        the misses only, miss rows admitted to the cache tagged with the
        watermark their serving response carried."""
        if self.cache is None:
            rows, _ = self._pull_owner(table, spec, uniq)
            return rows
        view = self.view
        with self._lock:
            owner_arr = self._owner_wm_locked(
                table, view.num_shards).copy()
        hit_mask, hit_rows = self.cache.lookup(
            table, spec.vocab, spec.dim, uniq, owner_arr,
            view.num_shards, counts)
        out = np.empty((uniq.shape[0], spec.dim), np.float32)
        if hit_rows is not None:
            out[hit_mask] = hit_rows
            self._attribute_degraded_hits(view, uniq, hit_mask, counts)
        miss = ~hit_mask
        if miss.any():
            miss_ids = uniq[miss]
            rows_m, wms_m = self._pull_owner(table, spec, miss_ids)
            out[miss] = rows_m
            self.cache.insert(
                table, spec.vocab, spec.dim, miss_ids, rows_m, wms_m)
            with self._lock:
                self._full_hits[table] = 0
        else:
            self._maybe_probe_watermarks(table, view)
        return out

    def _attribute_degraded_hits(self, view, uniq, hit_mask,
                                 counts) -> None:
        """The degraded ladder's \"cache\" rung, honestly attributed
        (ISSUE 15): a cache hit is normally fenced by watermarks the
        owner keeps refreshing — but while the owner's breaker is OPEN
        the observed watermark is frozen (probes fall back to replicas,
        or fail entirely), so hits on that owner's shards are served
        beyond `wm_probe` reach. They still honor the LAST verified
        bound; counting them `edl_emb_degraded_reads_total{mode=
        \"cache\"}` is what keeps the partition from hiding inside a
        healthy-looking hit rate."""
        degraded_fn = getattr(self._transport, "owner_degraded", None)
        if degraded_fn is None or not hit_mask.any():
            return
        bad_shards = [
            s for s in range(view.num_shards)
            if degraded_fn(view.owner_of(s))
        ]
        if not bad_shards:
            return
        hit_ids = uniq[hit_mask]
        shards = sharding.shard_of(hit_ids, view.num_shards)
        sel = np.isin(shards, np.asarray(bad_shards))
        if not sel.any():
            return
        if counts is None:
            n = int(sel.sum())
        else:
            n = int(counts[hit_mask][sel].sum())
        DEGRADED_READS.inc(n, mode="cache")
        reqtrace.event("degraded", mode="cache", ids=n)

    def _wm_probe_accepts_replica(self) -> bool:
        """Whether the transport's `shard_watermark` takes `replica=`
        (minimal test transports may not). Decided ONCE by signature
        inspection, not by catching TypeError per probe — a genuine
        TypeError raised inside a real transport must surface, not
        silently freeze the watermark fence."""
        ok = self._wm_replica_ok
        if ok is None:
            try:
                import inspect

                params = inspect.signature(
                    self._transport.shard_watermark).parameters
                ok = "replica" in params or any(
                    p.kind is inspect.Parameter.VAR_KEYWORD
                    for p in params.values())
            except (TypeError, ValueError):
                ok = True   # unintrospectable: assume the full contract
            self._wm_replica_ok = ok
        return ok

    def _maybe_probe_watermarks(self, table: str, view) -> None:
        """Bound a read-mostly client's staleness: after
        `wm_probe_every` consecutive fully-cache-served lookups, fetch
        each primary's bare watermark so the next lookup's fence sees
        how far the owners really moved. Best-effort — a dead owner's
        probe is the retry path's problem, not the hit path's.

        Partition fallback (ISSUE 15): when the PRIMARY's probe fails,
        ask its replicas for THEIR watermark. A replica's watermark is
        a lower bound on the primary's — enough to keep the staleness
        contract one-sided during a partition: foreign pushes that the
        replica has synced WILL advance the observed watermark and
        evict rows past the bound, even though the primary is
        unreachable (the satellite test pins this)."""
        with self._lock:
            n = self._full_hits.get(table, 0) + 1
            self._full_hits[table] = 0 if n >= self.wm_probe_every else n
        if n < self.wm_probe_every:
            return
        for shard in range(view.num_shards):
            wm = self._probe_shard_wm(table, shard, view)
            if wm is not None:
                self._note_wm(table, view.num_shards, shard, int(wm))

    def _probe_shard_wm(self, table: str, shard: int,
                        view) -> Optional[int]:
        """One shard's bare freshness probe with the partition ladder
        (ISSUE 15): the primary first; on failure, any replica's
        watermark (a lower bound on the primary's). None when every
        rung failed — best-effort, the fence keeps its last bound."""
        try:
            return self._transport.shard_watermark(
                view.owner_of(shard), table, shard)
        except (StaleShardMapError, OwnerUnavailableError,
                faults.FaultInjected):
            if not self._wm_probe_accepts_replica():
                return None
            for rep in view.replicas_of(shard):
                if rep == view.owner_of(shard):
                    continue
                try:
                    return self._transport.shard_watermark(
                        rep, table, shard, replica=True)
                except (StaleShardMapError, OwnerUnavailableError,
                        faults.FaultInjected):
                    continue
            return None

    def _maybe_probe_watermarks_multi(self, tables: List[str],
                                      view) -> None:
        """The fused probe cadence (ISSUE 18): tables served entirely
        from cache advance the same per-table counter as the unary
        path, and the ones that come due probe TOGETHER — one
        `watermark_multi` call per owner covering every due table's
        shards, instead of tables x shards bare probes. An owner whose
        fused probe fails falls back to the unary ladder (primary,
        then replicas) per shard. In a steady-state training loop this
        rarely fires at all: any fused pull's piggybacked owner
        watermarks reset the counters first."""
        due = []
        with self._lock:
            for table in tables:
                n = self._full_hits.get(table, 0) + 1
                self._full_hits[table] = (
                    0 if n >= self.wm_probe_every else n)
                if n >= self.wm_probe_every:
                    due.append(table)
        if not due:
            return
        wmm = getattr(self._transport, "watermark_multi", None)
        if wmm is None:
            for table in due:
                for shard in range(view.num_shards):
                    wm = self._probe_shard_wm(table, shard, view)
                    if wm is not None:
                        self._note_wm(
                            table, view.num_shards, shard, int(wm))
            return
        by_owner: Dict[int, list] = {}
        for shard in range(view.num_shards):
            owner = view.owner_of(shard)
            for table in due:
                by_owner.setdefault(owner, []).append((table, shard))
        for owner, pairs in sorted(by_owner.items()):
            try:
                wms = wmm(owner, pairs)
            except (StaleShardMapError, OwnerUnavailableError,
                    faults.FaultInjected):
                for table, shard in pairs:
                    wm = self._probe_shard_wm(table, shard, view)
                    if wm is not None:
                        self._note_wm(
                            table, view.num_shards, shard, int(wm))
                continue
            for (table, shard), wm in zip(pairs, wms):
                self._note_wm(table, view.num_shards, shard, int(wm))

    def _pull_owner(self, table: str, spec,
                    uniq: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """One call per owning shard (or its freshest-enough replica)
        over the deduped miss stream; retried whole against a refreshed
        map on stale/dead-owner errors (reads are idempotent). Returns
        ``(rows, per_id_watermarks)``. The wall across ALL rounds lands
        in the owner-RPC latency window — an outage pull records the
        outage, which is exactly what the pull-p99 alert needs to see."""
        if self._supports_pull_multi():
            # fused lane (ISSUE 18): even a single table's misses
            # coalesce across shards into ONE call per owner — under a
            # per-call-dominated wire the per-shard loop was most of
            # the pull (4 owned shards = 4x the per-call tax)
            return self._pull_owner_multi({table: uniq})[table]
        t0 = time.perf_counter()
        try:
            for attempt in range(self._max_retries + 1):
                view = self.view
                try:
                    return self._pull_once(view, table, uniq)
                except (StaleShardMapError, OwnerUnavailableError,
                        faults.FaultInjected) as e:
                    self._note_retry("pull", attempt, e)
            raise OwnerUnavailableError(
                f"embedding pull for {table!r} failed after "
                f"{self._max_retries} retries"
            )
        finally:
            with self._lock:
                self._pull_times.append(time.perf_counter() - t0)

    def pull_unique(self, table: str, ids: np.ndarray):
        """The deduped-end-to-end lookup: returns ``(unique_rows,
        inverse, unique_ids)`` where ``unique_rows[inverse].reshape(
        ids.shape + (dim,))`` are the full vectors. The expansion is the
        CALLER'S gather — done inside the jitted step (TierEmbedding's
        `inverse` input), it runs on device memory bandwidth and, more
        importantly, autodiff through it hands back gradients PER UNIQUE
        ROW, already duplicate-summed — so the matching push needs no
        client-side re-dedupe at all. Negative/out-of-range ids map to
        the LAST unique slot, which is a zero row (a reserved padding
        slot), so combiner masking semantics match `pull`."""
        t0 = time.perf_counter()
        spec = self.table(table)
        flat = np.asarray(ids).reshape(-1).astype(np.int64)
        valid = (flat >= 0) & (flat < spec.vocab)
        _PULL_IDS.inc(int(flat.shape[0]))
        uniq, inverse, id_counts = np.unique(
            np.where(valid, flat, np.int64(-1)),
            return_inverse=True, return_counts=True)
        has_pad = bool(uniq.shape[0]) and uniq[0] < 0
        if has_pad:
            # rotate the sentinel slot to the END: unique ids stay a
            # sorted in-range stream for the per-shard calls, and slot
            # U-1 is the reserved zero row
            uniq = np.concatenate([uniq[1:], uniq[:1]])
            inverse = np.where(
                inverse == 0, uniq.shape[0] - 1, inverse - 1)
            id_counts = np.concatenate([id_counts[1:], id_counts[:1]])
        _PULL_UNIQUE.inc(int(uniq.shape[0]) - int(has_pad))
        rows = np.zeros((uniq.shape[0], spec.dim), np.float32)
        real = uniq.shape[0] - int(has_pad)
        if real:
            # the sentinel slot never reaches the sketch — padding is
            # protocol, not traffic (feed sampled at the batch stride)
            if self._sketch_due():
                self.sketch.update_batch(uniq[:real], id_counts[:real])
            rows[:real] = self._pull_unique(
                table, spec, uniq[:real], id_counts[:real])
        dt = time.perf_counter() - t0
        _PULL_S.observe(dt)
        _goodput_pull(dt)
        self._note_read_time(dt)
        return rows, inverse.reshape(np.asarray(ids).shape), uniq

    def _pick_read_target(self, view, shard: int) -> Tuple[int, bool]:
        """(worker id, is_replica) for one shard read: the least-loaded
        of primary + replicas (rolling client-side counts), primary-only
        while a reshard is in flight (replica copies may be mid-move).
        Writes never come through here."""
        primary = view.owner_of(shard)
        if not self.read_replicas or view.resharding:
            return primary, False
        reps = view.replicas_of(shard)
        if not reps:
            return primary, False
        with self._lock:
            loads = dict(self._target_loads)
        target = min(
            (primary,) + tuple(reps),
            key=lambda o: (loads.get(o, 0), o))
        return target, target != primary

    def _note_target_load(self, target: int, n: int) -> None:
        with self._lock:
            self._target_loads[target] = (
                self._target_loads.get(target, 0) + n)
            if self._target_loads[target] > (1 << 20):
                for k in self._target_loads:
                    self._target_loads[k] //= 2

    def _pull_once(
        self, view, table: str, uniq: np.ndarray,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """One serving round: ``(rows, per_id_watermarks)`` — each id's
        watermark is its shard's push watermark as carried by whichever
        store (primary or accepted replica) served it."""
        shards = sharding.shard_of(uniq, view.num_shards)
        local = sharding.local_rows(uniq, view.num_shards)
        out = np.empty((uniq.shape[0], self.table(table).dim), np.float32)
        wms = np.zeros(uniq.shape[0], np.int64)
        errs = []
        errs_lock = threading.Lock()

        def one(shard: int, sel):
            ids_s = local[sel].astype(np.int32)
            _SHARD_CALLS.observe(float(ids_s.shape[0]))
            n = pad_pow2(ids_s.shape[0])
            padded = np.full((n,), -1, np.int32)
            padded[: ids_s.shape[0]] = ids_s
            target, is_replica = self._pick_read_target(view, shard)
            rows = wm = None
            if is_replica:
                with self._lock:
                    known = int(self._owner_wm_locked(
                        table, view.num_shards)[shard])
                try:
                    rows, wm = self._transport.pull(
                        target, table, shard, padded,
                        map_version=view.version,
                        with_watermark=True, replica=True,
                    )
                    if wm + self.staleness_bound < known:
                        # the replica is further behind the owner than
                        # the bound allows — the primary serves, and the
                        # lagging answer is discarded (never cached)
                        _REPLICA_STALE.inc()
                        rows = wm = None
                    else:
                        _REPLICA_READS.inc(shard=str(shard))
                except (StaleShardMapError, OwnerUnavailableError,
                        faults.FaultInjected):
                    # replica miss/death is never an error round: the
                    # primary is the fallback within the SAME attempt
                    rows = wm = None
            if rows is None:
                try:
                    rows, wm = self._transport.pull(
                        view.owner_of(shard), table, shard, padded,
                        map_version=view.version, with_watermark=True,
                    )
                    target = view.owner_of(shard)
                except (StaleShardMapError, OwnerUnavailableError,
                        faults.FaultInjected) as e:
                    with errs_lock:
                        errs.append(e)
                    return
            out[sel] = rows[: ids_s.shape[0]]
            wms[sel] = int(wm)
            self._note_wm(table, view.num_shards, shard, int(wm))
            self._note_target_load(target, int(ids_s.shape[0]))

        self._fanout([
            (lambda s=int(shard): one(s, shards == s))
            for shard in np.unique(shards)
        ])
        if errs:
            raise errs[0]
        # load accounting only for the attempt that SERVED: a retried
        # round against a stale map would double-count rows that were
        # never pulled — skewing the imbalance signal exactly when the
        # shard-imbalance alert reads it (mid-resharding)
        self._note_shard_loads(shards, view.num_shards)
        return out, wms

    # -------------------------------------------------------------- #
    # fused multi-table pull (ISSUE 18)

    def _supports_pull_multi(self) -> bool:
        """Whether the transport offers the fused `pull_multi` lane.
        Wrappers with a `__getattr__` passthrough (ResilientTransport)
        make a plain hasattr() true even when their INNER transport
        lacks the method, so they export `supports_pull_multi()` and
        that answer wins. Decided once."""
        ok = self._pull_multi_ok
        if ok is None:
            probe = getattr(self._transport, "supports_pull_multi", None)
            if callable(probe):
                ok = bool(probe())
            else:
                ok = hasattr(self._transport, "pull_multi")
            self._pull_multi_ok = ok
        return ok

    def pull_unique_multi(
        self, table_ids: Dict[str, np.ndarray],
    ) -> Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Fused multi-table lookup (ISSUE 18): `pull_unique` semantics
        for every table in ``table_ids`` — same dedupe, sentinel
        rotation, cache and staleness fences — but all tables' misses
        travel in ONE `pull_multi` call per read target instead of one
        call per (table, shard). Under a per-call-dominated wire (the
        measured loopback truth) this is where the per-call gap closes;
        the response's piggybacked owner watermarks refresh EVERY
        table's freshness fence, so a steady-state training loop stops
        paying watermark probe calls entirely. Returns ``{table:
        (unique_rows, inverse, unique_ids)}`` exactly as per-table
        `pull_unique` would. Transports without the fused lane fall
        back to per-table calls — same results, per-table wire cost."""
        if not self._supports_pull_multi():
            return {
                table: self.pull_unique(table, ids)
                for table, ids in table_ids.items()
            }
        t0 = time.perf_counter()
        rec = reqtrace.get_recorder()
        diary = rec.start("tier_pull", tables=len(table_ids))
        states: Dict[str, Dict[str, Any]] = {}
        with reqtrace.stage("dedupe"):
            for table, ids in table_ids.items():
                spec = self.table(table)
                flat = np.asarray(ids).reshape(-1).astype(np.int64)
                valid = (flat >= 0) & (flat < spec.vocab)
                _PULL_IDS.inc(int(flat.shape[0]))
                uniq, inverse, id_counts = np.unique(
                    np.where(valid, flat, np.int64(-1)),
                    return_inverse=True, return_counts=True)
                has_pad = bool(uniq.shape[0]) and uniq[0] < 0
                if has_pad:
                    # sentinel slot rotated to the END, as in
                    # pull_unique: slot U-1 is the reserved zero row
                    uniq = np.concatenate([uniq[1:], uniq[:1]])
                    inverse = np.where(
                        inverse == 0, uniq.shape[0] - 1, inverse - 1)
                    id_counts = np.concatenate(
                        [id_counts[1:], id_counts[:1]])
                _PULL_UNIQUE.inc(int(uniq.shape[0]) - int(has_pad))
                real = uniq.shape[0] - int(has_pad)
                if real and self._sketch_due():
                    self.sketch.update_batch(
                        uniq[:real], id_counts[:real])
                states[table] = {
                    "spec": spec, "uniq": uniq, "counts": id_counts,
                    "real": real, "miss_mask": None,
                    "rows": np.zeros((uniq.shape[0], spec.dim),
                                     np.float32),
                    "inverse": inverse.reshape(np.asarray(ids).shape),
                }
        view = self.view
        try:
            misses: Dict[str, np.ndarray] = {}
            full_hit: List[str] = []
            for table, st in states.items():
                real = st["real"]
                if not real:
                    continue
                uniq_r = st["uniq"][:real]
                if self.cache is None:
                    misses[table] = uniq_r
                    continue
                counts_r = st["counts"][:real]
                with self._lock:
                    owner_arr = self._owner_wm_locked(
                        table, view.num_shards).copy()
                hit_mask, hit_rows = self.cache.lookup(
                    table, st["spec"].vocab, st["spec"].dim, uniq_r,
                    owner_arr, view.num_shards, counts_r)
                if hit_rows is not None:
                    st["rows"][:real][hit_mask] = hit_rows
                    self._attribute_degraded_hits(
                        view, uniq_r, hit_mask, counts_r)
                miss = ~hit_mask
                if miss.any():
                    misses[table] = uniq_r[miss]
                    st["miss_mask"] = miss
                else:
                    full_hit.append(table)
            if misses:
                served = self._pull_owner_multi(misses)
                for table, (rows_m, wms_m) in served.items():
                    st = states[table]
                    miss = st["miss_mask"]
                    if miss is None:
                        st["rows"][:st["real"]] = rows_m
                    else:
                        st["rows"][:st["real"]][miss] = rows_m
                    if self.cache is not None:
                        self.cache.insert(
                            table, st["spec"].vocab, st["spec"].dim,
                            misses[table], rows_m, wms_m)
                        with self._lock:
                            self._full_hits[table] = 0
            if full_hit:
                # fully-cache-served tables keep the probe cadence
                # honest; a fused pull's piggyback just reset their
                # counters, so the residual probe only fires for a
                # client whose batches stopped missing entirely
                self._maybe_probe_watermarks_multi(full_hit, view)
        except BaseException as e:
            rec.finish(diary, status="error",
                       detail=f"{type(e).__name__}: {e}")
            raise
        rec.finish(diary, status=(
            "degraded" if any(ev.get("name") == "degraded"
                              for ev in diary.events) else "ok"))
        dt = time.perf_counter() - t0
        _PULL_S.observe(dt)
        _goodput_pull(dt)
        self._note_read_time(dt)
        return {
            table: (st["rows"], st["inverse"], st["uniq"])
            for table, st in states.items()
        }

    def _pull_owner_multi(
        self, misses: Dict[str, np.ndarray],
    ) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
        """The fused analogue of `_pull_owner`: one `pull_multi` call
        per read target covering EVERY table's misses on it, retried
        whole against a refreshed map on stale/dead-owner errors (reads
        are idempotent). Returns ``{table: (rows, per_id_watermarks)}``
        parallel to each table's miss stream; the wall across ALL
        rounds lands in the owner-RPC latency window."""
        t0 = time.perf_counter()
        try:
            for attempt in range(self._max_retries + 1):
                view = self.view
                try:
                    return self._pull_once_multi(view, misses)
                except (StaleShardMapError, OwnerUnavailableError,
                        faults.FaultInjected) as e:
                    self._note_retry("pull", attempt, e)
            raise OwnerUnavailableError(
                f"fused embedding pull over {sorted(misses)} failed "
                f"after {self._max_retries} retries"
            )
        finally:
            with self._lock:
                self._pull_times.append(time.perf_counter() - t0)

    def _pull_once_multi(
        self, view, misses: Dict[str, np.ndarray],
    ) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
        """One fused serving round: per-shard sub-pulls built exactly
        as `_pull_once` would (padded, least-loaded read target), then
        grouped by (target, replica) so each owner serves ONE
        `pull_multi` covering every table that misses on it. Replica
        groups go first; a sub whose replica failed OR answered past
        the staleness bound falls back to its primary's group within
        the SAME attempt. Each response's piggybacked owner watermarks
        advance the freshness fence for every resident shard — the
        probe traffic this kills is the point of the piggyback."""
        out: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        shard_arrays: Dict[str, np.ndarray] = {}
        subs: List[_MultiSub] = []
        for table, miss in misses.items():
            dim = self.table(table).dim
            out[table] = (np.empty((miss.shape[0], dim), np.float32),
                          np.zeros(miss.shape[0], np.int64))
            shards = sharding.shard_of(miss, view.num_shards)
            local = sharding.local_rows(miss, view.num_shards)
            shard_arrays[table] = shards
            for shard in np.unique(shards):
                sel = shards == shard
                ids_s = local[sel].astype(np.int32)
                _SHARD_CALLS.observe(float(ids_s.shape[0]))
                n = pad_pow2(ids_s.shape[0])
                padded = np.full((n,), -1, np.int32)
                padded[: ids_s.shape[0]] = ids_s
                target, is_rep = self._pick_read_target(view, int(shard))
                subs.append(_MultiSub(
                    table, int(shard), sel, int(ids_s.shape[0]),
                    padded, target, is_rep))
        groups: Dict[Tuple[int, bool], List[_MultiSub]] = {}
        for sub in subs:
            groups.setdefault((sub.target, sub.is_replica),
                              []).append(sub)
        known_tables = {t.name for t in view.tables}
        errs: List[Exception] = []
        fallback: List[_MultiSub] = []
        box_lock = threading.Lock()

        def note_piggyback(owner_wms) -> None:
            # every resident primary on the serving store rode back;
            # advancing their fences here is what lets steady-state
            # freshness probes stop being calls (monotonic _note_wm —
            # a replica's own primaries are authoritative too)
            refreshed = set()
            for (t, s), wm in owner_wms.items():
                if t in known_tables and int(s) < view.num_shards:
                    self._note_wm(t, view.num_shards, int(s), int(wm))
                    refreshed.add(t)
            if refreshed:
                with self._lock:
                    for t in refreshed:
                        self._full_hits[t] = 0

        def accept(sub: _MultiSub, rows, wm, target: int) -> None:
            rows_t, wms_t = out[sub.table]
            rows_t[sub.sel] = rows[: sub.n]
            wms_t[sub.sel] = int(wm)
            self._note_wm(sub.table, view.num_shards, sub.shard, int(wm))
            self._note_target_load(target, sub.n)

        def serve_replica(target: int, group: List[_MultiSub]) -> None:
            with self._lock:
                known = {
                    sub: int(self._owner_wm_locked(
                        sub.table, view.num_shards)[sub.shard])
                    for sub in group
                }
            try:
                results, owner_wms = self._transport.pull_multi(
                    target,
                    [(s.table, s.shard, s.padded) for s in group],
                    map_version=view.version, replica=True)
            except (StaleShardMapError, OwnerUnavailableError,
                    faults.FaultInjected):
                # replica miss/death is never an error round: the
                # primary serves these subs within the SAME attempt
                with box_lock:
                    fallback.extend(group)
                return
            note_piggyback(owner_wms)
            for sub, (rows, wm) in zip(group, results):
                if wm + self.staleness_bound < known[sub]:
                    # further behind the owner than the bound allows —
                    # the primary serves; the lagging answer is
                    # discarded (never cached)
                    _REPLICA_STALE.inc()
                    with box_lock:
                        fallback.append(sub)
                else:
                    # bounded by the shard map's num_shards:
                    # edl-lint: disable=EDL405
                    _REPLICA_READS.inc(shard=str(sub.shard))
                    accept(sub, rows, wm, target)

        def serve_primary(owner: int, group: List[_MultiSub]) -> None:
            try:
                results, owner_wms = self._transport.pull_multi(
                    owner,
                    [(s.table, s.shard, s.padded) for s in group],
                    map_version=view.version)
            except (StaleShardMapError, OwnerUnavailableError,
                    faults.FaultInjected) as e:
                with box_lock:
                    errs.append(e)
                return
            note_piggyback(owner_wms)
            for sub, (rows, wm) in zip(group, results):
                accept(sub, rows, wm, owner)

        rep_groups = [(t, g) for (t, r), g in groups.items() if r]
        if rep_groups:
            self._fanout([
                (lambda tg=tg: serve_replica(*tg)) for tg in rep_groups
            ])
        primary: Dict[int, List[_MultiSub]] = {}
        for (t, r), g in groups.items():
            if not r:
                primary.setdefault(t, []).extend(g)
        for sub in fallback:
            primary.setdefault(view.owner_of(sub.shard), []).append(sub)
        if primary:
            self._fanout([
                (lambda og=og: serve_primary(*og))
                for og in sorted(primary.items())
            ])
        if errs:
            raise errs[0]
        # load accounting only for the round that SERVED (see
        # _pull_once: a retried round must not double-count)
        for table, shards in shard_arrays.items():
            self._note_shard_loads(shards, view.num_shards)
        return out

    # -------------------------------------------------------------- #
    # skew telemetry (ISSUE 11)

    def _note_shard_loads(self, shards: np.ndarray,
                          num_shards: int) -> None:
        """Accumulate per-shard deduped pull traffic (one bincount + a
        vector add under the leaf lock — the hot-path half; the gauge
        refresh and hot-share computation live in tier_stats(), on the
        heartbeat/scrape cadence). Rolling: loads halve once the window
        outgrows its bound, so the signal tracks RECENT traffic instead
        of averaging a reshard away."""
        counts = np.bincount(shards, minlength=num_shards)
        with self._lock:
            if (self._shard_loads is None
                    or self._shard_loads.shape[0] != num_shards):
                self._shard_loads = np.zeros(num_shards, np.int64)
            self._shard_loads += counts
            if int(self._shard_loads.sum()) > (1 << 20):
                self._shard_loads //= 2

    def tier_stats(self) -> Dict[str, object]:
        """The compact skew row that rides the heartbeat stats payload
        (observability/health.py budget: few keys, scalars only — plus
        the two ≤64-char STRING vectors below) so the master's fleet
        rollup sees tier skew without scraping workers: hot-id traffic
        share, shard load imbalance, per-shard load shares + the sketch
        head (`emb_shard_loads` / `emb_hot_ids`, the layout
        controller's inputs — ISSUE 20), and RECENT pull/push p99s (a
        bounded window, not the job-lifetime histogram — a fresh
        owner-loss spike must not be diluted by a quiet past). Also the
        ONE place the skew gauges refresh — heartbeat/scrape cadence,
        never per pull (the sketch's hot_share sorts its counters).

        Latency split (ISSUE 13 bugfix): `emb_pull_p99_ms` is OWNER RPC
        rounds only — the embedding_pull_p99 alert keeps paging on real
        shard trouble instead of being diluted once a cache serves most
        reads — while `emb_read_p99_ms` is the effective read the step
        saw (cache included; pipelined reads contribute their residual
        get() wait). The cache hit rate and pipeline depth ride along —
        the fleet series' hot-set-migration sensor."""
        with self._lock:
            loads = (None if self._shard_loads is None
                     else self._shard_loads.copy())
            pulls = sorted(self._pull_times)
            reads = sorted(self._read_times)
            pushes = sorted(self._push_times)
            pipe_depth = self._pipeline_depth
        hot_share = round(self.sketch.hot_share(), 4)
        _HOT_SHARE.set(hot_share)
        out: Dict[str, object] = {"emb_hot_id_share": hot_share}
        if loads is not None and int(loads.sum()):
            total = int(loads.sum())
            imbalance = round(
                float(loads.max()) * loads.shape[0] / total, 4)
            out["emb_shard_imbalance"] = imbalance
            _SHARD_IMBALANCE.set(imbalance)
            for s in range(loads.shape[0]):
                # per-shard labels are bounded by --embedding_shards (a
                # config constant, not data): edl-lint: disable=EDL405
                _SHARD_LOAD.set(float(loads[s]), shard=str(s))
            # layout-controller telemetry (ISSUE 20): per-shard load
            # shares ride the heartbeat as ONE compact string — integer
            # percents, comma-joined — because decode_stats drops
            # nested containers and truncates strings at 64 chars. The
            # key is emitted only when the full vector fits: a
            # truncated vector would parse as the wrong shard count and
            # the controller treats that worker as non-reporting (no
            # data = hold), which is the safe failure mode.
            shares = ",".join(
                str(int(round(100.0 * float(c) / total))) for c in loads)
            if len(shares) <= 64:
                out["emb_shard_loads"] = shares
        # the sketch head (hottest first) rides the same way: as many
        # whole ids as fit the 64-char string budget — the layout
        # controller aggregates these into a fleet-quorum ultra-hot set
        head = [str(i) for i, _c, _e in self.sketch.top(16)]
        if head:
            ids = ""
            for tok in head:
                cand = tok if not ids else ids + "," + tok
                if len(cand) > 64:
                    break
                ids = cand
            if ids:
                out["emb_hot_ids"] = ids
        if pulls:
            out["emb_pull_p99_ms"] = round(
                1e3 * quantile_sorted(pulls, 0.99), 3)
        if reads:
            out["emb_read_p99_ms"] = round(
                1e3 * quantile_sorted(reads, 0.99), 3)
        if pushes:
            out["emb_push_p99_ms"] = round(
                1e3 * quantile_sorted(pushes, 0.99), 3)
        if self.cache is not None:
            out["emb_cache_hit_rate"] = round(self.cache.hit_rate(), 4)
        if pipe_depth:
            out["emb_pipeline_depth"] = float(pipe_depth)
        return out

    # -------------------------------------------------------------- #
    # push

    def push(self, table: str, ids: np.ndarray, grads: np.ndarray,
             scale: float = 1.0) -> Dict[str, float]:
        """Batch sparse update: ``table[id] += scale * grad`` with
        duplicate ids summed client-side. Returns push stats (the
        dedupe ratio the bench records). Blocks until every touched
        shard acked — exactly once, across retries and resharding."""
        t0 = time.perf_counter()
        spec = self.table(table)
        flat = np.asarray(ids).reshape(-1).astype(np.int64)
        rows = np.asarray(grads, np.float32).reshape(-1, spec.dim)
        valid = (flat >= 0) & (flat < spec.vocab)
        if bool(valid.all()):
            vids, vrows = flat, rows   # no-sentinel fast path: no copies
        else:
            vids, vrows = flat[valid], rows[valid]
        n_batch = int(flat.shape[0])
        _PUSH_IDS.inc(n_batch)
        if not vids.shape[0]:
            dt = time.perf_counter() - t0
            _PUSH_S.observe(dt)
            with self._lock:
                self._push_times.append(dt)
            return {"ids_in_batch": n_batch, "ids_sent": 0,
                    "dedupe_ratio": 0.0}
        if self.dedupe:
            uniq, sums = _dedupe_sum(vids, vrows)
        else:
            order = np.argsort(vids, kind="stable")
            uniq, sums = vids[order], vrows[order]
        seq = self._next_seq()
        self._push_unique(table, uniq, sums, seq, scale)
        sent = int(uniq.shape[0])
        _PUSH_SENT.inc(sent)
        ratio = sent / max(1, n_batch)
        _DEDUPE_RATIO.set(ratio)
        dt = time.perf_counter() - t0
        _PUSH_S.observe(dt)
        with self._lock:
            self._push_times.append(dt)
        return {"ids_in_batch": n_batch, "ids_sent": sent,
                "dedupe_ratio": round(ratio, 4)}

    def _push_unique(self, table: str, uniq, sums, seq: int,
                     scale: float) -> None:
        """Send the deduped stream, one call per shard, ALL under one
        seq. Unacked shards are conservatively re-sent whole against a
        refreshed map (interrupted resharding, lost acks); the store's
        watermark makes re-applied shards no-ops, so the update lands
        exactly once no matter how many rounds this takes.

        With the hot-row cache on, acks carry the post-apply push
        watermark and the pushed rows WRITE THROUGH: an entry that was
        fresh as of the pre-push watermark (and whose shard advanced by
        exactly our push) gets the delta applied in place — the worker's
        own training loop keeps its hot set warm without re-pulling."""
        # watermark acks feed BOTH fences: the cache's freshness tag and
        # the replica-read staleness check (a replica-reading client
        # without a cache still needs to know the owners moved on)
        want_wm = self.cache is not None or self.read_replicas
        prev_wm = None
        if want_wm:
            with self._lock:
                prev_wm = self._owner_wm_locked(
                    table, self._view.num_shards).copy()
        ack_wms: Dict[int, int] = {}
        alock = threading.Lock()
        pending = None   # shard ids still unacked (None = all)
        view = self.view
        for attempt in range(self._max_retries + 1):
            view = self.view
            shards = sharding.shard_of(uniq, view.num_shards)
            local = sharding.local_rows(uniq, view.num_shards)
            todo = np.unique(shards) if pending is None else pending
            failed = []
            errbox = []
            flock = threading.Lock()

            def one(shard: int, sel):
                ids_s = local[sel].astype(np.int32)
                _SHARD_CALLS.observe(float(ids_s.shape[0]))
                n = pad_pow2(ids_s.shape[0])
                padded_ids = np.full((n,), -1, np.int32)
                padded_ids[: ids_s.shape[0]] = ids_s
                padded_rows = np.zeros((n, sums.shape[1]), np.float32)
                padded_rows[: ids_s.shape[0]] = sums[sel]
                try:
                    ack = self._transport.push(
                        view.owner_of(shard), table, shard,
                        padded_ids, padded_rows, client_id=self.client_id,
                        seq=seq, map_version=view.version, scale=scale,
                        with_watermark=want_wm,
                    )
                    if want_wm:
                        _, wm = ack
                        with alock:
                            ack_wms[int(shard)] = int(wm)
                except (StaleShardMapError, OwnerUnavailableError,
                        faults.FaultInjected) as e:
                    with flock:
                        failed.append(shard)
                        errbox.append(e)

            self._fanout([
                (lambda s=int(shard): one(s, shards == s))
                for shard in todo
            ])
            err = errbox[0] if errbox else None
            if not failed:
                if want_wm:
                    self._write_through(
                        table, view, uniq, sums, scale, prev_wm, ack_wms)
                return
            # NOTE: after a map refresh the ids of a failed shard may hash
            # to the same shard id but a NEW owner — recomputing shards
            # from the refreshed view each round handles moves; num_shards
            # itself never changes within a map's lifetime.
            pending = np.asarray(failed)
            self._note_retry("push", attempt, err)
        raise OwnerUnavailableError(
            f"embedding push for {table!r} (seq {seq}) has "
            f"{len(pending)} unacked shard(s) after {self._max_retries} "
            "retries"
        )

    def _write_through(self, table: str, view, uniq, sums, scale: float,
                       prev_wm: np.ndarray,
                       ack_wms: Dict[int, int]) -> None:
        """Patch the worker's own push into its cache and advance the
        observed watermarks. `prev_wm` may be sized for an older map
        (refresh mid-retry re-keyed everything and dropped the cache —
        the patch is then a no-op by construction)."""
        if prev_wm is None or prev_wm.shape[0] != view.num_shards:
            return
        new_wm = prev_wm.copy()
        for s, wm in ack_wms.items():
            if s < new_wm.shape[0]:
                new_wm[s] = wm
            self._note_wm(table, view.num_shards, s, wm)
        if self.cache is None:
            return
        self.cache.write_through(
            table, np.asarray(uniq, np.int64),
            np.asarray(scale, np.float32) * np.asarray(sums, np.float32),
            view.num_shards, prev_wm, new_wm)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    def _note_retry(self, what: str, attempt: int, err) -> None:
        _RETRIES.inc()
        _REFRESHES.inc()
        logger.warning(
            "embedding %s retry %d (%s: %s); refreshing shard map",
            what, attempt + 1, type(err).__name__, err,
        )
        time.sleep(self._backoff_s * min(4, attempt + 1))
        self.refresh()


class EmbeddingPullPipeline:
    """Read layer 3: overlap step N+1's deduped pull with step N's
    compute (templated on DevicePrefetcher's depth/drain shape — the
    host->device lookahead's tier twin).

    The caller keeps up to `depth` id batches submitted ahead
    (`submit`), and `get()` returns pulls IN SUBMIT ORDER, blocking only
    on whatever the overlapped compute did not already cover — that
    residual wait is the only part that still bills the goodput ledger's
    `emb_pull_blocked` and the client's effective-read window (the
    background pull's own wall is exempt via the billing thread-local).

    One puller thread: the pulls themselves are GIL-holding numpy over
    small deduped arrays (measured: thread fan-in LOSES in-process, see
    EmbeddingTierClient.fanout note), so the pipeline buys pull-vs-
    compute overlap, not pull-vs-pull parallelism.

    Elasticity contract (the DevicePrefetcher `drain()` semantics): on
    rescale/reshard the caller drains — in-flight and queued id batches
    come BACK as host arrays to resubmit under the refreshed map — and
    `get()` itself re-issues synchronously when a completed result was
    pulled under a map the client has since abandoned, so a pipelined
    step can never consume rows routed by a stale map."""

    def __init__(self, client: EmbeddingTierClient, table: str,
                 depth: int = 2):
        if depth < 1:
            raise ValueError("pipeline depth must be >= 1")
        self.client = client
        self.table = table
        self.depth = int(depth)
        self._pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"emb-pipe-{table}")
        self._q: "deque" = deque()     # (ids, future) in submit order
        self._lock = threading.Lock()
        self._closed = False
        client._pipeline_depth = self.depth
        _PIPE_DEPTH.set(float(self.depth))

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)

    def submit(self, ids: np.ndarray) -> None:
        """Queue the next batch's pull (non-blocking). The ids are
        copied — the caller's buffer may be reused."""
        ids = np.array(ids, np.int64, copy=True)
        with self._lock:
            if self._closed:
                raise RuntimeError("pipeline is closed")
            if len(self._q) >= self.depth:
                raise RuntimeError(
                    f"pipeline depth {self.depth} exceeded: get() before "
                    "submitting further batches")
            self._q.append((ids, self._pool.submit(self._pull, ids)))

    def _pull(self, ids: np.ndarray):
        _BILL_TLS.off = True
        try:
            rows, inverse, uniq = self.client.pull_unique(self.table, ids)
            return rows, inverse, uniq, self.client.view.version
        finally:
            _BILL_TLS.off = False

    def get(self):
        """Next submitted batch's ``(rows, inverse, unique_ids)``,
        blocking on the residual the compute overlap did not cover."""
        with self._lock:
            if not self._q:
                raise RuntimeError("pipeline is empty: submit() first")
            ids, fut = self._q.popleft()
        t0 = time.perf_counter()
        rows, inverse, uniq, version = fut.result()
        blocked = time.perf_counter() - t0
        _PIPE_BLOCKED_S.observe(blocked)
        _goodput_pull(blocked)
        self.client._note_read_time(blocked)
        if version != self.client.view.version:
            # pulled under a map the client has since abandoned (reshard
            # landed between completion and consumption): re-issue under
            # the fresh map — this one blocks for real and bills as such
            rows, inverse, uniq = self.client.pull_unique(self.table, ids)
        return rows, inverse, uniq

    def drain(self) -> List[np.ndarray]:
        """Rescale/reshard: hand back every queued/in-flight id batch
        (submit order) for re-submission under the refreshed map.
        Unstarted pulls are cancelled; the in-flight one (if any) is
        abandoned — its result is discarded, never served."""
        with self._lock:
            pending = [(ids, fut) for ids, fut in self._q]
            self._q.clear()
        for _, fut in pending:
            fut.cancel()
        return [ids for ids, _ in pending]

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._q.clear()
        self._pool.shutdown(wait=False)
        self.client._pipeline_depth = 0
        _PIPE_DEPTH.set(0.0)


def view_from_response(resp) -> Optional[sharding.ShardMapView]:
    """GetEmbeddingShardMapResponse -> ShardMapView (None when the
    master has no map yet — version 0)."""
    if not resp.version:
        return None
    rc = int(getattr(resp, "replica_count", 0) or 0)
    flat = list(getattr(resp, "shard_replicas", ()) or ())
    replicas: Tuple[Tuple[int, ...], ...] = ()
    if rc and flat:
        replicas = tuple(
            tuple(int(o) for o in flat[s * rc:(s + 1) * rc] if int(o) >= 0)
            for s in range(int(resp.num_shards))
        )
    # owner address book (ISSUE 15): parallel arrays on the wire, pairs
    # in the view (old masters never set them — empty book, local
    # transport routing only)
    addr_ids = list(getattr(resp, "addr_worker_ids", ()) or ())
    addr_strs = list(getattr(resp, "addrs", ()) or ())
    addrs = tuple(
        (int(w), a) for w, a in zip(addr_ids, addr_strs) if a
    )
    return sharding.ShardMapView(
        version=int(resp.version),
        num_shards=int(resp.num_shards),
        owners=tuple(int(o) for o in resp.shard_owners),
        tables=tuple(
            sharding.TableSpec(
                name=t.name, vocab=int(t.vocab), dim=int(t.dim),
                seed=int(t.seed), init_scale=float(t.init_scale),
            )
            for t in resp.tables
        ),
        resharding=bool(resp.resharding),
        replicas=replicas,
        addrs=addrs,
        # ultra-hot set (ISSUE 20): old masters never set it — empty
        hot_ids=tuple(
            int(i) for i in (getattr(resp, "hot_ids", ()) or ())),
    )


def stub_map_fetch(stub, worker_id: int,
                   poll_s: float = 0.5, max_polls: int = 20):
    """A `map_fetch` closure over the master's GetEmbeddingShardMap RPC
    (workers wire this into EmbeddingTierClient). Polls while the master
    has no map yet (version 0 — e.g. before the first worker registered);
    raises OwnerUnavailableError once the poll budget is gone."""
    from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb

    def fetch() -> sharding.ShardMapView:
        for _ in range(max_polls):
            view = view_from_response(
                stub.GetEmbeddingShardMap(
                    pb.GetEmbeddingShardMapRequest(worker_id=worker_id)
                )
            )
            if view is not None:
                return view
            time.sleep(poll_s)
        raise OwnerUnavailableError(
            "master served no embedding shard map (tier disabled, or no "
            "workers alive to own shards)"
        )

    return fetch


def confirm_reshard(stub, worker_id: int, version: int,
                    shard_ids) -> bool:
    """The recipient half of a shard migration: report installed shards
    so the master can commit the plan (idempotent — safe to retry)."""
    from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb

    resp = stub.ReportEmbeddingReshard(
        pb.ReportEmbeddingReshardRequest(
            worker_id=worker_id, version=version,
            shard_ids=[int(s) for s in shard_ids],
        )
    )
    return bool(resp.accepted)


#: process-local default transport: single-process jobs (and the thread
#: cohorts tests/bench run) share one registry, so every worker-side
#: store in this process is reachable without a wire
_default_transport = None
_default_transport_lock = threading.Lock()


def default_transport():
    from elasticdl_tpu_torch.embedding.transport import LocalTransport

    global _default_transport
    with _default_transport_lock:
        if _default_transport is None:
            _default_transport = LocalTransport()
        return _default_transport


class WorkerTierRuntime:
    """Everything one worker process runs for the tier: its owning store
    (registered in the transport), the pull/push client, and the
    reshard reaction — fetch newly-owned shards (live donor first, then
    checkpoint, then seed) and confirm them to the master so the plan
    can commit.

    The worker wires this at boot (worker/worker.py `_init_embedding_
    tier`, cohort leaders in cohort.py run()); `on_world_change()` runs
    at task boundaries after a membership bump (never on the heartbeat
    thread — shard installs can take a while), and `drain()` rides the
    preemption/forced-checkpoint path so a planned kill loses no acked
    push."""

    def __init__(self, stub, worker_id: int, checkpoint_dir: str = "",
                 transport=None, cache_rows: int = 0,
                 cache_staleness: int = 1, read_replicas: bool = False,
                 pipeline_depth: int = 0, bind_servicer=None,
                 device=None):
        from elasticdl_tpu_torch.embedding.store import EmbeddingShardStore

        self._stub = stub
        self.worker_id = worker_id
        self.checkpoint_dir = checkpoint_dir
        self.pipeline_depth = max(0, int(pipeline_depth))
        self.transport = transport if transport is not None \
            else default_transport()
        self.store = EmbeddingShardStore(worker_id, device=device)
        self.transport.register(self.store)
        if bind_servicer is not None:
            # gRPC data plane (ISSUE 15): the worker's endpoint came up
            # before registration (its address rides RegisterWorker);
            # the store binds late, here, once it exists
            bind_servicer.bind_store(self.store)
        self.client = EmbeddingTierClient(
            stub_map_fetch(stub, worker_id), self.transport,
            client_id=f"worker-{worker_id}",
            cache_rows=cache_rows, cache_staleness=cache_staleness,
            read_replicas=read_replicas,
        )
        if hasattr(self.transport, "set_view_fn"):
            # the robustness layer hedges to replicas and re-routes
            # drained pushes off the client's live view
            self.transport.set_view_fn(lambda: self.client.view)
        created = self.store.attach(self.client.view, checkpoint_dir)
        if created and self.client.view.resharding:
            confirm_reshard(
                stub, worker_id, self.client.view.version, created)
        self._install_replicas(self.client.view)

    def on_world_change(self) -> int:
        """Re-fetch the map; install shards newly assigned here (live
        donor -> checkpoint -> seed, through reshard.apply_moves so the
        migration is spanned and exactly-once), confirm them. Returns
        how many shards moved in."""
        from elasticdl_tpu_torch.embedding import reshard, sharding as sh

        old = self.client.view
        view = self.client.refresh()
        # replica PROMOTION first (owner-death fast recovery): a shard
        # newly mine for which I hold a replica copy becomes primary in
        # place — rows, seq fence, and watermark move wholesale — unless
        # a drained checkpoint is FRESHER (its watermark outranks the
        # replica's last sync; bit-exactness beats warmth)
        promoted = self._promote_replicas(view)
        # residency, not version delta, decides what to install: the
        # client may have refreshed mid-push-retry already, so an equal
        # version can still mean shards are missing here
        resident = set(self.store.resident_shards())
        mine = [
            s for s, o in enumerate(view.owners)
            if o == self.worker_id and any(
                (t.name, s) not in resident for t in view.tables
            )
        ]
        if not mine and not promoted:
            self.store.adopt_version(view.version)
            self._install_replicas(view)
            return 0
        moves = [
            sh.ShardMove(
                shard=s,
                src=(old.owners[s]
                     if s < len(old.owners)
                     and old.owners[s] != self.worker_id else -1),
                dst=self.worker_id,
            )
            for s in sorted(set(mine) | promoted)
        ]
        reshard.apply_moves(
            view, moves, self.transport,
            checkpoint_dir=self.checkpoint_dir,
            confirm=lambda v, shards: confirm_reshard(
                self._stub, self.worker_id, v, shards),
        )
        self._install_replicas(view)
        return len(moves)

    def _promote_replicas(self, view) -> set:
        """Promote resident replica copies of shards this view newly
        assigns here. Returns the promoted shard ids (they still ride
        the move/confirm round so the master's plan commits)."""
        from elasticdl_tpu_torch.embedding import store as store_lib

        promoted = set()
        replica_resident = set(self.store.resident_replicas())
        if not replica_resident:
            return promoted
        resident = set(self.store.resident_shards())
        for s, o in enumerate(view.owners):
            if o != self.worker_id:
                continue
            for t in view.tables:
                if (t.name, s) in resident or (t.name, s) not in replica_resident:
                    continue
                rep_wm = self.store.replica_watermark(t.name, s)
                ckpt_wm = -1
                if self.checkpoint_dir:
                    peeked = store_lib.peek_shard_watermark(
                        self.checkpoint_dir, t.name, s)
                    if peeked is not None:
                        ckpt_wm = peeked
                if ckpt_wm > rep_wm:
                    # the drained checkpoint saw pushes the replica
                    # never synced: let apply_moves restore from it
                    continue
                self.store.promote_replica(t.name, s)
                promoted.add(s)
                logger.warning(
                    "embedding shard %s/%d promoted from replica at "
                    "watermark %d (map v%d)", t.name, s, rep_wm,
                    view.version,
                )
        return promoted

    def _install_replicas(self, view) -> int:
        """Adopt this view's replica assignments: install copies for
        shards newly replicated here (full fetch from the primary; the
        sync loop keeps them fresh by delta), drop copies no longer
        assigned. Best-effort — a dead primary just defers the install
        to the next sync round."""
        # primaries only pay the per-push delta log while the map
        # actually carries replicas to consume it
        self.store.set_delta_logging(
            any(view.replicas_of(s) for s in range(view.num_shards)))
        assigned = {
            (t.name, s)
            for s in view.shards_replicated_on(self.worker_id)
            for t in view.tables
        }
        resident = set(self.store.resident_replicas())
        for (table, s) in resident - assigned:
            self.store.release_replica(table, s)
        installed = 0
        for (table, s) in assigned - resident:
            try:
                self.store.sync_replica_from(
                    self.transport, view.owner_of(s), table, s)
                installed += 1
            except Exception:
                logger.warning(
                    "replica install %s/%d from owner %d failed; will "
                    "retry on the next sync round", table, s,
                    view.owner_of(s), exc_info=True,
                )
        return installed

    def sync_replicas(self) -> int:
        """One delta-sync round over every replica copy resident here
        (worker run loop, task boundaries; cheap when nothing is
        assigned). Also retries any ASSIGNED-but-missing install — a
        replica whose primary was not up yet at assignment time lands
        on a later round. Returns shards synced. Never raises — a dead
        primary mid-recovery is the reshard reaction's problem, not the
        sync loop's."""
        view = self.client.view
        synced = 0
        if hasattr(self.transport, "drain_queued"):
            # reconnect drain (ISSUE 15): pushes parked behind an open
            # owner breaker re-send in order on the task-boundary
            # cadence — the same cadence that already retries deferred
            # replica installs
            try:
                self.transport.drain_queued()
            except Exception:
                logger.debug("queued-push drain deferred", exc_info=True)
        if set(self.store.resident_replicas()) != {
            (t.name, s)
            for s in view.shards_replicated_on(self.worker_id)
            for t in view.tables
        }:
            synced += self._install_replicas(view)
        for (table, s) in self.store.resident_replicas():
            if s >= len(view.owners) or view.owner_of(s) == self.worker_id:
                continue
            try:
                self.store.sync_replica_from(
                    self.transport, view.owner_of(s), table, s)
                synced += 1
            except Exception:
                logger.debug(
                    "replica sync %s/%d failed (primary down?)", table, s,
                    exc_info=True,
                )
        return synced

    def drain(self) -> int:
        """Persist this worker's resident shards (rows + seq watermarks)
        beside the checkpoints — the tier half of the preemption drain."""
        if not self.checkpoint_dir:
            return 0
        from elasticdl_tpu_torch.embedding import reshard

        return reshard.drain_to_checkpoint(self.store, self.checkpoint_dir)

    def close(self) -> None:
        self.transport.deregister(self.worker_id)
        self.client.close()


class EmbeddingTierSession:
    """Training integration: pull -> jitted compute (grads w.r.t. the
    pulled vectors) -> push, per batch.

    `tables` maps table name -> the batch feature key holding its ids.
    The jitted step is compile-cache keyed (training/compile_cache) on
    the vector/batch avals, so rescale/resharding reuses the executable.
    The model consumes vectors through api/layers.TierEmbedding (the
    vectors are a jit INPUT — the tier pull happens outside the trace,
    which is what lets the table exceed one host's memory)."""

    def __init__(self, client: EmbeddingTierClient,
                 tables: Dict[str, str], compile_cache=None,
                 pipeline_depth: int = 0, device=None):
        from elasticdl_tpu_torch.common import runtime

        self.client = client
        self.tables = dict(tables)
        self.device = runtime.resolve_device(device)
        if compile_cache is None:
            from elasticdl_tpu_torch.training import compile_cache as cc

            compile_cache = cc.global_cache()
        self._cache = compile_cache
        # pull/compute overlap (ISSUE 13 layer 3): one pipeline per
        # table; run() keeps `pipeline_depth` batches of pulls in
        # flight behind the current step's compute
        self.pipeline_depth = max(0, int(pipeline_depth))
        self._pipes: Dict[str, EmbeddingPullPipeline] = {}

    def pull_batch(self, batch: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """Full (expanded) vectors for every table, one FUSED pull per
        owner across tables (ISSUE 18). The unique-row gather happens
        here client-side; invalid/padding ids land on the reserved
        zero row, matching `pull` semantics."""
        pulled = self.client.pull_unique_multi({
            name: np.asarray(batch[key])
            for name, key in self.tables.items()
        })
        return {name: rows[inverse]
                for name, (rows, inverse, _uniq) in pulled.items()}

    def _pipe(self, name: str) -> EmbeddingPullPipeline:
        p = self._pipes.get(name)
        if p is None:
            p = EmbeddingPullPipeline(
                self.client, name, depth=self.pipeline_depth)
            self._pipes[name] = p
        return p

    def drain_pipelines(self) -> int:
        """Rescale/reshard hook: abandon in-flight pulls (they requeue
        inside run(); a direct driver resubmits what this returns)."""
        n = 0
        for p in self._pipes.values():
            n += len(p.drain())
        return n

    def close(self) -> None:
        for p in self._pipes.values():
            p.close()
        self._pipes.clear()

    def run(self, loss_fn, batches, lr: float = 0.0):
        """Pipelined step stream: yields ``(loss, push_stats)`` per
        batch with up to `pipeline_depth` NEXT batches' pulls in flight
        while the current batch computes and pushes (depth 0 degrades to
        the plain blocking `step`). If a reshard/rescale lands mid-
        stream, get() re-issues under the fresh map — no drained batch
        is lost and none is served stale."""
        if self.pipeline_depth <= 0:
            for batch in batches:
                yield self.step(loss_fn, batch, lr)
            return
        it = iter(batches)
        window: "deque" = deque()      # batches whose pulls are in flight

        def _submit(batch) -> None:
            window.append(batch)
            for name, key in self.tables.items():
                self._pipe(name).submit(np.asarray(batch[key]))

        def _get_all():
            # a drain_pipelines() from a rescale hook mid-run empties
            # the pipes while `window` still holds their batches: heal
            # by re-submitting the window IN ORDER under the (by then
            # refreshed) map — the docstring's "no drained batch is
            # lost" is this re-issue, not a hope
            for name, key in self.tables.items():
                p = self._pipe(name)
                if len(p) != len(window):
                    p.drain()
                    for b in window:
                        p.submit(np.asarray(b[key]))
            return {name: self._pipe(name).get() for name in self.tables}

        try:
            for batch in it:           # prime the lookahead window
                _submit(batch)
                if len(window) >= self.pipeline_depth:
                    break
            for batch in it:
                pulled = _get_all()
                done = window.popleft()
                # submit the NEXT batch before computing this one — the
                # whole point: its pull rides under our compute+push
                # (submitting after the step would serialize them)
                _submit(batch)
                yield self._finish_pulled(loss_fn, done, pulled, lr)
            while window:
                pulled = _get_all()
                done = window.popleft()
                yield self._finish_pulled(loss_fn, done, pulled, lr)
        finally:
            self.drain_pipelines()

    def _finish_pulled(self, loss_fn, batch, pulled, lr: float):
        vectors = {n: p[0] for n, p in pulled.items()}
        inverses = {n: p[1] for n, p in pulled.items()}
        uniq_ids = {n: p[2] for n, p in pulled.items()}
        return self._finish_step(
            loss_fn, batch, vectors, inverses, uniq_ids, lr)

    def step(self, loss_fn, batch: Dict[str, Any],
             lr: float = 0.0) -> Tuple[float, Dict[str, Dict[str, float]]]:
        """One tier step, deduped END TO END: pull one row per unique id
        (`pull_unique`), run ``loss_fn(vectors, inverses, batch)`` jitted
        with grads w.r.t. the unique vectors (the in-step `inverse`
        gather — TierEmbedding — makes autodiff hand back per-unique-row
        gradients, duplicate-summed for free), push ``-lr * grad``
        straight back (tier-side SGD — the reference's PS-resident
        optimizer, minus its per-row apply). Returns (loss, per-table
        push stats)."""
        vectors: Dict[str, Any] = {}
        inverses: Dict[str, Any] = {}
        uniq_ids: Dict[str, Any] = {}
        # ONE fused pull per owner across every table (ISSUE 18) —
        # under a per-call-dominated wire the per-table loop was the
        # step's dominant cost; transports without the fused lane
        # degrade to per-table calls inside pull_unique_multi
        pulled = self.client.pull_unique_multi({
            name: np.asarray(batch[key])
            for name, key in self.tables.items()
        })
        for name, (rows, inverse, uniq) in pulled.items():
            vectors[name], inverses[name], uniq_ids[name] = (
                rows, inverse, uniq)
        return self._finish_step(
            loss_fn, batch, vectors, inverses, uniq_ids, lr)

    def _finish_step(self, loss_fn, batch, vectors, inverses, uniq_ids,
                     lr: float) -> Tuple[float, Dict[str, Dict[str, float]]]:
        loss, grads = self._grad_fn(loss_fn, vectors, batch)(
            vectors, inverses, batch)
        stats = {}
        if lr:
            for name in self.tables:
                stats[name] = self.client.push(
                    name, uniq_ids[name], np.asarray(grads[name]),
                    scale=-lr,
                )
        return float(loss), stats

    def _grad_fn(self, loss_fn, vectors, batch):
        import torch

        key = (
            "emb_tier_step", id(loss_fn), str(self.device),
            tuple(sorted(
                (k, np.asarray(v).shape) for k, v in vectors.items())),
            tuple(sorted(
                (k, np.asarray(v).shape) for k, v in batch.items()
                if hasattr(v, "shape") or isinstance(v, np.ndarray))),
        )

        def build():
            device = self.device

            def put(v):
                if isinstance(v, dict):
                    return {k: put(x) for k, x in v.items()}
                if isinstance(v, np.ndarray) or hasattr(v, "shape"):
                    return torch.as_tensor(np.asarray(v)).to(device)
                return v

            def value_and_grad(vectors, inverses, batch):
                # the pulled rows become leaf tensors on the device; the
                # loss's backward hands back their (duplicate-summed)
                # gradients, which go back to host numpy for the push
                leaves = {
                    k: torch.as_tensor(np.asarray(v, np.float32)).to(
                        device).requires_grad_(True)
                    for k, v in vectors.items()
                }
                loss = loss_fn(leaves, put(inverses), put(batch))
                loss.backward()
                return loss.detach(), {
                    k: (v.grad.cpu().numpy() if v.grad is not None
                        else np.zeros(v.shape, np.float32))
                    for k, v in leaves.items()
                }

            return value_and_grad

        return self._cache.get_or_build(key, build)
