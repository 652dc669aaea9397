"""Transport between tier clients and owning stores.

The data plane is pluggable: `LocalTransport` serves the in-process
deployments this repo can actually run (single-process workers, the
thread-cohort bench swarm) and is the reference implementation of the
call contract; the cross-host `GrpcTransport` (embedding/data_plane.py)
slots in behind the same methods without touching client or store, and
`SimWireTransport` puts a deterministic simulated wire in front of any
inner transport so the bench's read-layer legs and the real gRPC legs
are interchangeable runs of the same scenario.

Every call crosses a REAL boundary even in-process: requests and
responses are numpy arrays (never shared jax buffers), and the
fault-injection sites wrap each call so chaos schedules can drop or
delay tier traffic deterministically — the exactly-once tests ride
these. Each method fires a REQUEST-side site (``emb.pull``,
``emb.push``, ``emb.fetch_shard``, ``emb.fetch_delta``,
``emb.watermark``) before the owner serves, and a RESPONSE-side
``.recv`` twin after it (``emb.pull.recv``, ``emb.push.recv``,
``emb.fetch_shard.recv``, ``emb.fetch_delta.recv``): a ``.recv`` drop
models a reply lost AFTER the owner applied — the hard case for a
non-idempotent push, which the per-(client, seq) fence must absorb
(the caller re-sends under the same seq and the store acks the
duplicate without touching the table).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

import numpy as np

from elasticdl_tpu_torch.common import faults
from elasticdl_tpu_torch.common.log_utils import default_logger
from elasticdl_tpu_torch.observability import reqtrace
from elasticdl_tpu_torch.observability.registry import default_registry

logger = default_logger(__name__)

#: the degraded-mode ladder's honesty counter (ISSUE 15), shared by the
#: robustness layer (data_plane.ResilientTransport: mode="replica" when
#: a hedge served because the primary FAILED, mode="blocked" when every
#: rung failed) and the tier client (tier.py: mode="cache" for hits
#: served while the owner's breaker is open — freshness is then running
#: on the last observed watermark, beyond wm_probe reach). Registered
#: here because the ladder spans both modules and the registry rejects
#: duplicate names.
DEGRADED_READS = default_registry().counter(
    "edl_emb_degraded_reads_total",
    "reads served (or refused) by the degraded-mode ladder while an "
    "owner was partitioned away, by rung",
    labels=("mode",))


class OwnerUnavailableError(ConnectionError):
    """The owner is not reachable (dead worker / not yet registered)."""


class LocalTransport:
    """In-process owner registry: owner id -> EmbeddingShardStore.

    Thread-safe; `deregister` models worker death (subsequent calls to
    that owner raise OwnerUnavailableError, exactly what a dead remote
    peer looks like to the client's retry path)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stores: Dict[int, Any] = {}     # guarded_by: _lock

    def register(self, store) -> None:
        with self._lock:
            self._stores[store.owner] = store

    def deregister(self, owner: int) -> None:
        with self._lock:
            self._stores.pop(owner, None)

    def owners(self):
        with self._lock:
            return sorted(self._stores)

    def store_of(self, owner: int):
        """The live store (reshard.py uses this for local migrations)."""
        with self._lock:
            store = self._stores.get(owner)
        if store is None:
            raise OwnerUnavailableError(f"embedding owner {owner} is gone")
        return store

    # -------------------------------------------------------------- #
    # the call contract (a remote transport implements exactly these)

    def pull(self, owner: int, table: str, shard: int,
             local_ids: np.ndarray,
             map_version: Optional[int] = None,
             with_watermark: bool = False, replica: bool = False):
        faults.fire("emb.pull")
        store = self.store_of(owner)
        with reqtrace.stage("store"):
            out = store.pull(
                table, shard, local_ids, map_version=map_version,
                with_watermark=with_watermark, replica=replica)
        # response-side injection: the owner DID serve; the reply is lost
        # on the way back (reads are idempotent — the caller re-pulls)
        faults.fire("emb.pull.recv")
        return out

    def push(self, owner: int, table: str, shard: int,
             local_ids: np.ndarray, rows: np.ndarray, *, client_id: str,
             seq: int, map_version: Optional[int] = None,
             scale: float = 1.0, with_watermark: bool = False):
        faults.fire("emb.push")
        store = self.store_of(owner)
        with reqtrace.stage("store"):
            applied = store.push(
                table, shard, local_ids, rows, client_id=client_id,
                seq=seq, map_version=map_version, scale=scale,
                with_watermark=with_watermark,
            )
        # lost-ack injection: the store DID apply; the caller never hears
        # back and must re-send — the store's seq fence absorbs the dup
        faults.fire("emb.push.recv")
        return applied

    def fetch_shard(self, owner: int, table: str,
                    shard: int) -> Dict[str, Any]:
        faults.fire("emb.fetch_shard")
        payload = self.store_of(owner).extract_shard(table, shard)
        faults.fire("emb.fetch_shard.recv")
        return payload

    def shard_watermark(self, owner: int, table: str, shard: int,
                        replica: bool = False) -> int:
        """Watermark-only freshness probe (no rows cross the wire) —
        what bounds a fully-cache-served client's staleness.
        ``replica=True`` probes the owner's replica copy: a lower bound
        on the primary's watermark, the degraded ladder's fallback when
        the primary has partitioned away."""
        faults.fire("emb.watermark")
        return self.store_of(owner).shard_watermark(
            table, shard, replica=replica)

    def fetch_delta(self, owner: int, table: str, shard: int,
                    since_wm: int) -> Optional[Dict[str, Any]]:
        """Replica sync: the primary's applied pushes past ``since_wm``
        (watermark-tagged, contiguous) or None when its bounded delta log
        no longer reaches back — the replica then re-copies the shard."""
        faults.fire("emb.fetch_delta")
        delta = self.store_of(owner).fetch_delta(table, shard, since_wm)
        faults.fire("emb.fetch_delta.recv")
        return delta

    # -------------------------------------------------------------- #
    # wire-speed lanes (ISSUE 18) — optional contract extensions a
    # client feature-detects with hasattr; the unary methods above stay
    # the floor every transport must provide

    def pull_multi(self, owner: int, requests,
                   map_version: Optional[int] = None,
                   replica: bool = False):
        """One fused call serving every (table, shard, local_ids)
        sub-pull in ``requests`` against one owner. Returns
        ``(results, owner_wms)``: ``results`` is a list of ``(rows,
        wm)`` parallel to ``requests``; ``owner_wms`` maps EVERY
        resident primary ``(table, shard)`` on the owner to its push
        watermark — the piggyback that keeps steady-state freshness
        probes off the wire. One request-side and one response-side
        fault site fire per FUSED call (the wire sees one call), so a
        chaos drop loses every sub-pull together, exactly like the
        real fused RPC."""
        faults.fire("emb.pull")
        store = self.store_of(owner)
        with reqtrace.stage("store"):
            results = []
            for table, shard, local_ids in requests:
                results.append(store.pull(
                    table, shard, local_ids, map_version=map_version,
                    with_watermark=True, replica=replica))
            owner_wms = {
                key: store.shard_watermark(*key)
                for key in store.resident_shards()
            }
        faults.fire("emb.pull.recv")
        return results, owner_wms

    def watermark_multi(self, owner: int, pairs,
                        replica: bool = False):
        """Batched freshness probe: one call returns the watermark of
        every ``(table, shard)`` in ``pairs`` (parallel list) — the
        residual probe lane for clients so fully cache-served that no
        pull piggyback refreshes them."""
        faults.fire("emb.watermark")
        store = self.store_of(owner)
        return [store.shard_watermark(t, s, replica=replica)
                for t, s in pairs]

    def fetch_delta_stream(self, owner: int, table: str, shard: int,
                           since_wm: int, chunk_entries: int = 64):
        """Streaming replica sync: yields delta CHUNKS (each a
        ``{"found", "wm", "entries", "last"}`` frame, fence fields in
        the first) so the replica applies incrementally and a
        mid-stream drop resumes from wherever the applied watermark
        got to — re-sent entries fall to the idempotent wm fence."""
        faults.fire("emb.fetch_delta")
        delta = self.store_of(owner).fetch_delta(table, shard, since_wm)
        faults.fire("emb.fetch_delta.recv")
        return _delta_frames(delta, chunk_entries)


def _delta_frames(delta: Optional[Dict[str, Any]],
                  chunk_entries: int):
    """Chunk one fetch_delta payload into stream frames (the reference
    framing GrpcTransport's server stream mirrors on the real wire)."""
    if delta is None:
        yield {"found": False, "wm": 0, "entries": [], "last": True}
        return
    entries = delta["entries"]
    wm = delta["wm"]
    if not entries:
        yield {"found": True, "wm": wm, "entries": [], "last": True}
        return
    for off in range(0, len(entries), chunk_entries):
        batch = entries[off:off + chunk_entries]
        yield {
            "found": True, "wm": wm, "entries": batch,
            "last": off + chunk_entries >= len(entries),
        }


class SimWireTransport:
    """Any transport behind a deterministic simulated wire: every
    data-plane call sleeps ``base + real_rows * per_row`` before
    serving. sleep() releases the GIL, so pipeline overlap and replica
    fan-out compose exactly as against a real network peer — which is
    what the read layers exist for; in-process the serve is free and
    there is nothing to cache or overlap.

    Folded behind the shared transport contract (ISSUE 15) so the
    bench's sim-wire legs and the real gRPC transport are
    interchangeable runs of the same scenario — and so the model's
    constants (`bench.py` ET_WIRE_US / ET_WIRE_ROW_US) can be
    CALIBRATED against the measured loopback RPC cost the `data_plane`
    leg reports (`wire_truth`). Wire constants ride the bench record;
    0/0 disables the model entirely (pure delegation)."""

    def __init__(self, inner, call_us: float, row_us: float):
        self._inner = inner
        self._call_s = call_us * 1e-6
        self._row_s = row_us * 1e-6

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def _wire(self, rows: int) -> None:
        if self._call_s or self._row_s:
            with reqtrace.stage("wire"):
                time.sleep(self._call_s + rows * self._row_s)

    def pull(self, owner, table, shard, local_ids, **kw):
        self._wire(int((local_ids >= 0).sum()))
        return self._inner.pull(owner, table, shard, local_ids, **kw)

    def push(self, owner, table, shard, local_ids, rows, **kw):
        self._wire(int((local_ids >= 0).sum()))
        return self._inner.push(owner, table, shard, local_ids, rows, **kw)

    def shard_watermark(self, owner, table, shard, replica=False):
        self._wire(0)
        return self._inner.shard_watermark(
            owner, table, shard, replica=replica)

    def fetch_shard(self, owner, table, shard):
        payload = self._inner.fetch_shard(owner, table, shard)
        self._wire(int(payload["rows"].shape[0]))
        return payload

    def fetch_delta(self, owner, table, shard, since_wm):
        delta = self._inner.fetch_delta(owner, table, shard, since_wm)
        if delta is None:
            self._wire(0)
        else:
            self._wire(sum(int(e["ids"].shape[0])
                           for e in delta["entries"]))
        return delta

    # wire-speed lanes (ISSUE 18): ONE per-call cost per fused call —
    # the whole point of coalescing under a per-call-dominated wire

    def pull_multi(self, owner, requests, **kw):
        self._wire(sum(int((ids >= 0).sum())
                       for _, _, ids in requests))
        return self._inner.pull_multi(owner, requests, **kw)

    def watermark_multi(self, owner, pairs, replica=False):
        self._wire(0)
        return self._inner.watermark_multi(owner, pairs, replica=replica)

    def fetch_delta_stream(self, owner, table, shard, since_wm,
                           chunk_entries: int = 64):
        # one per-call cost up front (one streaming call), then the
        # per-row cost lands frame by frame as chunks are consumed
        self._wire(0)
        for frame in self._inner.fetch_delta_stream(
                owner, table, shard, since_wm,
                chunk_entries=chunk_entries):
            if self._row_s and frame["entries"]:
                time.sleep(self._row_s * sum(
                    int(e["ids"].shape[0]) for e in frame["entries"]))
            yield frame
