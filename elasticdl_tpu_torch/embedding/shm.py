"""Same-host shared-memory short-circuit for the embedding data plane.

When a tier client and an owning store land on the same host (common in
the bench swarm and in packed deployments), the gRPC loopback tax —
~1ms/call measured by the `wire_truth` probe — is pure overhead: both
ends can see the same bytes. This module gives each (client, owner)
pair a dedicated SPSC ring in one `multiprocessing.shared_memory`
segment, negotiated over the regular gRPC channel
(`EmbeddingShmNegotiate`): the owner creates the segment and a poll
thread, the client attaches and round-trips serialized data-plane
requests through it. Payloads are the SAME protobuf messages the gRPC
lane carries — the ring replaces the socket, not the codec — so the
fused zero-copy row layout rides unchanged.

Protocol (single segment, 64-byte header + request slot + response
slot, all header fields aligned u64):

    [magic][slot_bytes][req_seq][resp_seq][req_len][resp_len]
    [req_method][resp_status]

The client writes the request payload FIRST, then length+method, then
bumps ``req_seq`` — the publish. The server polls for ``req_seq !=
resp_seq``, serves against the store, writes the response payload, and
publishes by setting ``resp_seq = req_seq``. One in-flight request per
ring (SPSC); the client serializes its threads on an in-process lock.
Seq-last publication keeps the pattern safe on x86's total store
order; this short-circuit is only negotiated same-host, so there is no
cross-architecture wire to worry about.

Failure is always an option and always transparent: negotiation
declined, segment gone (owner died, /dev/shm wiped), payload larger
than the slot, or a response deadline miss all surface as
`ShmRingError` — the caller (GrpcTransport) drops the ring and falls
back to the gRPC lane, counting the fallback. A partition is modeled
by the address book changing (the bench's blackhole swaps the owner's
addr), which drops the ring with the channel — the short-circuit never
outlives the address that negotiated it.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional, Tuple

from elasticdl_tpu_torch.common.log_utils import default_logger
from elasticdl_tpu_torch.observability import reqtrace
from elasticdl_tpu_torch.observability.registry import default_registry

logger = default_logger(__name__)

try:
    from multiprocessing import shared_memory as _shm_mod
    HAVE_SHM = True
except Exception:  # pragma: no cover - exotic platforms only
    _shm_mod = None
    HAVE_SHM = False

#: ring request method ids (the shm lane's tiny method table — only the
#: hot unary calls ride the ring; bulk fetch/stream stays on gRPC)
M_PULL_MULTI = 1
M_PULL = 2
M_PUSH = 3
M_WATERMARK = 4
M_WATERMARK_MULTI = 5

#: ring response status codes
S_OK = 0
S_STALE = 1        # payload = utf8 detail -> StaleShardMapError
S_ERROR = 2        # payload = utf8 detail -> OwnerUnavailableError

_MAGIC = 0xED1E57D1
_HDR_BYTES = 64
_I_MAGIC, _I_SLOT, _I_REQ_SEQ, _I_RESP_SEQ = 0, 1, 2, 3
_I_REQ_LEN, _I_RESP_LEN, _I_REQ_METHOD, _I_RESP_STATUS = 4, 5, 6, 7

#: default/granted slot sizing: 1 MiB holds a fused pull of ~16k rows
#: at dim 16 with headroom; anything larger falls back to gRPC per-call
DEFAULT_SLOT_BYTES = 1 << 20
MAX_SLOT_BYTES = 1 << 22

#: server poll + client spin cadence; sleep() floors around 50-100us on
#: Linux (timer slack), which still beats the ~1ms gRPC loopback by 10x
POLL_S = float(os.environ.get("EDL_EMB_SHM_POLL_US", "20")) * 1e-6
_SPIN_ITERS = 200

SHM_CALLS = default_registry().counter(
    "edl_emb_shm_calls_total",
    "client-side shm ring round-trips ATTEMPTED, by method — the "
    "fallback share's denominator (edl_emb_shm_reads_total counts "
    "only the ones that completed)",
    labels=("method",))
SHM_READS = default_registry().counter(
    "edl_emb_shm_reads_total",
    "data-plane calls served over the same-host shared-memory ring, "
    "by method",
    labels=("method",))
SHM_FALLBACKS = default_registry().counter(
    "edl_emb_shm_fallbacks_total",
    "shm short-circuit attempts that fell back to the gRPC lane, by "
    "reason (negotiate / attach / too_big / timeout / gone)",
    labels=("reason",))
SHM_RINGS = default_registry().gauge(
    "edl_emb_shm_rings",
    "shared-memory rings currently served by this owner")
SHM_OCCUPANCY = default_registry().gauge(
    "edl_emb_shm_ring_occupancy",
    "rings on this owner currently serving a request (busy rings; "
    "occupancy near edl_emb_shm_rings means poll threads saturated)")

_METHOD_NAMES = {
    M_PULL_MULTI: "pull_multi", M_PULL: "pull", M_PUSH: "push",
    M_WATERMARK: "watermark", M_WATERMARK_MULTI: "watermark_multi",
}


class ShmRingError(RuntimeError):
    """The ring is unusable (gone / timed out / payload too big) —
    the caller falls back to gRPC and drops the ring."""


class ShmRingTimeout(ShmRingError):
    """The response deadline passed — lets the caller count the
    fallback as `timeout` rather than `gone`."""


def same_host(host: str) -> bool:
    """Is `host` (the address-book host part of a data_addr) this
    machine? Loopback literals and our own hostname qualify; anything
    else is treated as remote — a false negative only costs the
    short-circuit, never correctness."""
    if not host:
        return False
    if host in ("127.0.0.1", "localhost", "::1", "[::1]", "0.0.0.0"):
        return True
    try:
        import socket
        return host == socket.gethostname()
    except Exception:
        # hostname unavailable -> "remote": costs only the
        # short-circuit, never correctness: edl-lint: disable=EDL303
        return False


def _np():
    import numpy as np
    return np


class _Ring:
    """Header + slot views over one attached/created segment."""

    def __init__(self, seg, slot_bytes: int):
        np = _np()
        self.seg = seg
        self.slot_bytes = int(slot_bytes)
        self.hdr = np.ndarray((8,), dtype=np.uint64, buffer=seg.buf)
        self.buf = seg.buf
        self.req_off = _HDR_BYTES
        self.resp_off = _HDR_BYTES + self.slot_bytes

    def write_slot(self, off: int, payload: bytes) -> None:
        self.buf[off:off + len(payload)] = payload

    def read_slot(self, off: int, n: int) -> bytes:
        return bytes(self.buf[off:off + n])


def _segment_size(slot_bytes: int) -> int:
    return _HDR_BYTES + 2 * slot_bytes


class ShmRingServer:
    """Owner side: creates ring segments on negotiation and serves each
    with a daemon poll thread dispatching into ``serve_fn(method,
    payload) -> (status, payload)`` (bound to the data-plane store by
    data_plane.EmbeddingDataServer)."""

    def __init__(self, serve_fn: Callable[[int, bytes],
                                          Tuple[int, bytes]],
                 tag: str = "", max_slot_bytes: int = MAX_SLOT_BYTES):
        self._serve_fn = serve_fn
        self._max_slot = int(max_slot_bytes)
        self._tag = tag or f"{os.getpid():x}"
        self._lock = threading.Lock()
        self._rings = {}              # name -> (_Ring, stop Event)
        self._counter = 0
        self._stopped = False

    def negotiate(self, slot_bytes: int) -> Optional[Tuple[str, int]]:
        """Create one ring for one client; returns (segment_name,
        granted_slot_bytes) or None when shm is unavailable/stopped."""
        if not HAVE_SHM or self._stopped:
            return None
        granted = max(1 << 12, min(int(slot_bytes) or DEFAULT_SLOT_BYTES,
                                   self._max_slot))
        with self._lock:
            self._counter += 1
            name = (f"edl_emb_{self._tag}_{self._counter}_"
                    f"{os.urandom(3).hex()}")
        try:
            seg = _shm_mod.SharedMemory(
                name=name, create=True, size=_segment_size(granted))
        except Exception as e:
            logger.warning("shm negotiate failed creating %s: %s",
                           name, e)
            return None
        ring = _Ring(seg, granted)
        ring.hdr[_I_MAGIC] = _MAGIC
        ring.hdr[_I_SLOT] = granted
        stop = threading.Event()
        t = threading.Thread(target=self._serve_ring,
                             args=(ring, stop),
                             name=f"edl-shm-{self._counter}",
                             daemon=True)
        with self._lock:
            self._rings[seg.name] = (ring, stop)
            SHM_RINGS.set(len(self._rings))
        t.start()
        return seg.name, granted

    def _serve_ring(self, ring: _Ring, stop: threading.Event) -> None:
        hdr = ring.hdr
        idle = 0
        last_sleep = 0.0
        rec = reqtrace.get_recorder()
        while not stop.is_set():
            req = int(hdr[_I_REQ_SEQ])
            if req == int(hdr[_I_RESP_SEQ]):
                idle += 1
                # adaptive poll: a short hot window catches a client's
                # back-to-back next call (the throughput regime keeps
                # idle pinned near 0), then exponential backoff to a
                # 1ms cadence — a ring serving intermittent traffic
                # must not sit at a 20us wakeup cadence between calls
                # or its poll threads starve everything else on a
                # small box, including the owner's own gRPC lane
                if idle < 16:
                    last_sleep = POLL_S
                else:
                    last_sleep = min(1e-3,
                                     POLL_S * (1 << min(8, idle >> 4)))
                time.sleep(last_sleep)
                continue
            idle = 0
            method = int(hdr[_I_REQ_METHOD])
            n = int(hdr[_I_REQ_LEN])
            payload = ring.read_slot(ring.req_off, n)
            # serve-side request diary: the request waited at most one
            # poll interval before we saw it — the honest serve_queue
            # bound this lane can observe; the dispatcher's codec/store
            # stages land via the thread-local stack
            d = rec.start("serve", lane="shm",
                          method=_METHOD_NAMES.get(method, str(method)))
            d.add("serve_queue", last_sleep)
            last_sleep = 0.0
            SHM_OCCUPANCY.add(1)
            try:
                status, out = self._serve_fn(method, payload)
            except Exception as e:
                status, out = S_ERROR, str(e).encode("utf-8")
            finally:
                SHM_OCCUPANCY.add(-1)
            if len(out) > ring.slot_bytes:
                status, out = S_ERROR, b"shm response exceeds slot"
            rec.finish(d, "ok" if status == S_OK else "error",
                       "" if status == S_OK
                       else out.decode("utf-8", "replace")[:128])
            ring.write_slot(ring.resp_off, out)
            hdr[_I_RESP_LEN] = len(out)
            hdr[_I_RESP_STATUS] = status
            hdr[_I_RESP_SEQ] = req          # publish

    def stop(self) -> None:
        with self._lock:
            rings, self._rings = dict(self._rings), {}
            self._stopped = True
            SHM_RINGS.set(0)
        for _name, (ring, stop) in rings.items():
            stop.set()
            try:
                ring.seg.close()
                ring.seg.unlink()
            except Exception:
                # segment already gone — nothing left to release:
                # edl-lint: disable=EDL303
                pass


class ShmRingClient:
    """Client side: attaches to a negotiated segment and round-trips
    serialized requests. Thread-safe via an in-process lock (one
    in-flight request per ring — SPSC)."""

    def __init__(self, name: str, slot_bytes: int):
        if not HAVE_SHM:
            raise ShmRingError("shared_memory unavailable")
        try:
            seg = _shm_mod.SharedMemory(name=name)
        except Exception as e:
            raise ShmRingError(f"attach {name}: {e}") from e
        # the OWNER holds the segment's lifetime; keep Python's
        # resource tracker from unlinking (and warning about) a
        # segment this process merely borrowed
        try:
            from multiprocessing import resource_tracker
            resource_tracker.unregister(seg._name,  # noqa: SLF001
                                        "shared_memory")
        except Exception:
            # tracker internals shifted — cosmetic only (a spurious
            # resource_tracker warning at exit):
            # edl-lint: disable=EDL303
            pass
        self._ring = _Ring(seg, slot_bytes)
        if int(self._ring.hdr[_I_MAGIC]) != _MAGIC:
            seg.close()
            raise ShmRingError(f"bad magic in {name}")
        self._name = name
        self.slot_bytes = int(slot_bytes)
        self._lock = threading.Lock()
        self._dead = False

    def _segment_exists(self) -> bool:
        """Is the owner's segment still linked? Our own mapping stays
        valid after an unlink, so a response deadline alone cannot
        distinguish a slow owner (`timeout`) from one that tore the
        lane down (`gone`)."""
        path = "/dev/shm/" + self._name.lstrip("/")
        if os.path.isdir("/dev/shm"):
            return os.path.exists(path)
        try:
            probe = _shm_mod.SharedMemory(name=self._name)
        except FileNotFoundError:
            return False
        except Exception:
            # probe failed for a reason OTHER than unlink — treat the
            # segment as alive; the caller's timeout label is the
            # conservative one: edl-lint: disable=EDL303
            return True
        try:
            from multiprocessing import resource_tracker
            resource_tracker.unregister(probe._name,  # noqa: SLF001
                                        "shared_memory")
        except Exception:
            # tracker internals shifted — cosmetic only (a spurious
            # resource_tracker warning at exit):
            # edl-lint: disable=EDL303
            pass
        probe.close()
        return True

    def call(self, method: int, payload: bytes,
             timeout_s: float = 1.0) -> Tuple[int, bytes]:
        if self._dead:
            raise ShmRingError("ring closed")
        if len(payload) > self.slot_bytes:
            raise ShmRingError(
                f"payload {len(payload)}B exceeds slot "
                f"{self.slot_bytes}B")
        SHM_CALLS.inc(method=_METHOD_NAMES.get(method, str(method)))
        with self._lock, reqtrace.stage("shm"):
            ring = self._ring
            hdr = ring.hdr
            try:
                seq = int(hdr[_I_REQ_SEQ]) + 1
                ring.write_slot(ring.req_off, payload)
                hdr[_I_REQ_LEN] = len(payload)
                hdr[_I_REQ_METHOD] = method
                hdr[_I_REQ_SEQ] = seq       # publish
                deadline = time.monotonic() + max(0.01, timeout_s)
                spins = 0
                while int(hdr[_I_RESP_SEQ]) != seq:
                    spins += 1
                    if spins > _SPIN_ITERS:
                        if time.monotonic() > deadline:
                            if not self._segment_exists():
                                raise ShmRingError(
                                    "ring segment unlinked under us")
                            raise ShmRingTimeout("ring response timeout")
                        # the lock IS the SPSC serialization: one
                        # in-flight request per ring, so the response
                        # wait holds it by design (deadline-bounded):
                        # edl-lint: disable=EDL103
                        time.sleep(POLL_S)
                status = int(hdr[_I_RESP_STATUS])
                out = ring.read_slot(ring.resp_off,
                                     int(hdr[_I_RESP_LEN]))
            except ShmRingError:
                raise
            except Exception as e:
                # segment yanked out from under us mid-call
                raise ShmRingError(f"ring I/O failed: {e}") from e
        SHM_READS.inc(method=_METHOD_NAMES.get(method, str(method)))
        return status, out

    def close(self) -> None:
        with self._lock:
            if self._dead:
                return
            self._dead = True
            try:
                self._ring.seg.close()
            except Exception:
                # double-close on teardown races is harmless:
                # edl-lint: disable=EDL303
                pass
