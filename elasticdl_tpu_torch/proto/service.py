"""gRPC service glue for the Master service, written against grpc's generic
handler API (this image has protoc for messages but no grpcio-tools plugin,
so the service bindings that `elasticdl_pb2_grpc.py` would contain in the
reference are spelled out here by hand).

Reference parity: the generated MasterServicer/MasterStub pair of
elasticdl/proto/elasticdl.proto — plus the hardening the reference never
had: every client call carries a deadline, idempotent RPCs retry with
exponential backoff + jitter, and a circuit breaker stops a worker from
hammering a dead master (RetryingMasterStub). Fault-injection sites
(`rpc.<method>` / `rpc.<method>.recv`, common/faults.py) wrap each send so
chaos schedules can drop/delay/lose-response any call deterministically.
"""

from __future__ import annotations

import random
import re
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import grpc

from elasticdl_tpu_torch.common import faults
from elasticdl_tpu_torch.common.constants import GRPC
from elasticdl_tpu_torch.common.log_utils import default_logger
from elasticdl_tpu_torch.observability import tracing
from elasticdl_tpu_torch.observability.registry import default_registry
from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb

logger = default_logger(__name__)

SERVICE_NAME = "elasticdl_tpu.Master"

#: metadata keys of the master-generation handshake (master/journal.py).
#: The generation is a monotonic counter persisted in the control-plane
#: journal header and bumped on every master restart. It rides gRPC
#: metadata (this image cannot regenerate proto messages): the server
#: stamps its generation onto every response's trailing metadata; clients
#: claim the generation they believe current on every call, and the
#: servicer fences mismatches with FAILED_PRECONDITION so a report leased
#: under a pre-crash master can never be double-counted by its successor.
GENERATION_KEY = "edl-master-generation"
#: marks a RegisterWorker as a RECONNECT of an existing member (idempotent
#: re-register; no membership-version bump for a live worker) rather than
#: a fresh join
REREGISTER_KEY = "edl-reregister"

# control-plane wire metrics (scraped via /metrics; docs/observability.md)
_reg = default_registry()
_RPC_CALLS = _reg.counter(
    "edl_rpc_client_calls_total",
    "client RPC attempts (per method, incl. retries)", labels=("method",))
_RPC_RETRIES = _reg.counter(
    "edl_rpc_client_retries_total",
    "retry attempts after a retryable failure", labels=("method",))
_RPC_FAILURES = _reg.counter(
    "edl_rpc_client_failures_total",
    "failed RPC attempts (any error)", labels=("method",))
_RPC_DEADLINE = _reg.counter(
    "edl_rpc_client_deadline_exceeded_total",
    "attempts that hit their deadline", labels=("method",))
_BREAKER_OPEN = _reg.gauge(
    "edl_rpc_breaker_open", "1 while the master circuit breaker is open")
_BREAKER_TRIPS = _reg.counter(
    "edl_rpc_breaker_trips_total", "circuit-breaker open transitions")
_BREAKER_RESETS = _reg.counter(
    "edl_rpc_breaker_reset_total",
    "breaker resets by a successful master-generation handshake")
_CHANNEL_REFRESHES = _reg.counter(
    "edl_rpc_channel_refreshes_total",
    "client channels rebuilt after repeated transport failures")
_RPC_LATENCY = _reg.histogram(
    "edl_rpc_client_latency_seconds",
    "successful-call wall latency", labels=("method",))

# rpc name -> (request type, response type)
_RPCS = {
    "RegisterWorker": (pb.RegisterWorkerRequest, pb.RegisterWorkerResponse),
    "GetTask": (pb.GetTaskRequest, pb.GetTaskResponse),
    "ReportTaskResult": (pb.ReportTaskResultRequest, pb.ReportTaskResultResponse),
    "ReportEvaluationMetrics": (
        pb.ReportEvaluationMetricsRequest,
        pb.ReportEvaluationMetricsResponse,
    ),
    "Heartbeat": (pb.HeartbeatRequest, pb.HeartbeatResponse),
    "GetJobStatus": (pb.Empty, pb.JobStatusResponse),
    "GetEmbeddingShardMap": (
        pb.GetEmbeddingShardMapRequest,
        pb.GetEmbeddingShardMapResponse,
    ),
    "ReportEmbeddingReshard": (
        pb.ReportEmbeddingReshardRequest,
        pb.ReportEmbeddingReshardResponse,
    ),
}

#: methods whose server-side handling opens a span when the client sent a
#: trace context (Heartbeat excluded: 1/s/worker would drown the timeline)
_TRACED_SERVER_RPCS = frozenset(_RPCS) - {"Heartbeat"}


def rpc_site(name: str) -> str:
    """Fault-injection site for an RPC: snake_case under the rpc. prefix
    (GetTask -> rpc.get_task)."""
    return "rpc." + re.sub(r"(?<!^)(?=[A-Z])", "_", name).lower()


@dataclass(frozen=True)
class RpcPolicy:
    """Per-RPC client behavior: default deadline, retry eligibility.

    `idempotent` means a retry after an ambiguous failure (deadline, lost
    response) cannot change job state a second time. Only those RPCs are
    retried; for the rest a retry is the caller's decision because it needs
    protocol context:

      RegisterWorker          NOT idempotent — re-registering allocates a
                              fresh membership version (and possibly id)
      GetTask                 NOT idempotent — a lost response leaves a task
                              leased; retrying would lease a second one and
                              expire the first into a spurious requeue
      ReportTaskResult        NOT idempotent at this layer — the dispatcher
                              dedupes, but the duplicate returns
                              accepted=False, which the preemption-drain
                              protocol treats as a rejection (it would
                              delete the drain checkpoint it must keep)
      Heartbeat               NOT idempotent — the servicer consumes the
                              one-shot should_checkpoint flag on read, so a
                              retry after a lost response would report
                              should_checkpoint=False and silently swallow
                              a master-requested (resize-quiesce)
                              checkpoint. The heartbeat LOOP is the retry
                              mechanism: the next beat arrives in
                              worker_heartbeat_s anyway.
      ReportEvaluationMetrics idempotent — the evaluation service dedupes
                              by task_id and drops repeats silently
      GetJobStatus            idempotent — read-only
    """

    timeout_s: float
    idempotent: bool
    max_attempts: int = 3


DEFAULT_POLICIES: Dict[str, RpcPolicy] = {
    "RegisterWorker": RpcPolicy(timeout_s=30.0, idempotent=False),
    "GetTask": RpcPolicy(timeout_s=30.0, idempotent=False),
    "ReportTaskResult": RpcPolicy(timeout_s=30.0, idempotent=False),
    "ReportEvaluationMetrics": RpcPolicy(timeout_s=30.0, idempotent=True),
    "Heartbeat": RpcPolicy(timeout_s=10.0, idempotent=False),
    "GetJobStatus": RpcPolicy(timeout_s=10.0, idempotent=True),
    # embedding tier control plane: the map read is a pure read; the
    # reshard confirm is idempotent at the ShardMapOwner (re-confirming
    # an already-confirmed shard — or a whole already-committed plan —
    # changes nothing), so both retry safely
    "GetEmbeddingShardMap": RpcPolicy(timeout_s=10.0, idempotent=True),
    "ReportEmbeddingReshard": RpcPolicy(timeout_s=30.0, idempotent=True),
}


def jittered(seconds: float, rng: Optional[random.Random] = None) -> float:
    """An interval with full spread jitter: ``uniform(0.5, 1.5) * base``.

    The polling/heartbeat twin of the stub's retry backoff jitter (EDL304):
    a swarm of workers relaunched together — or unblocked together by a
    master restart or a rescale settling — would otherwise beat and
    re-poll in phase forever, hitting the master as one synchronized herd
    every interval. Every periodic control-plane sleep (heartbeat loops,
    WAIT backoffs, lease re-polls) goes through here so the fleet's
    arrivals stay spread."""
    return max(0.0, seconds) * (rng or random).uniform(0.5, 1.5)


class MasterUnreachableError(ConnectionError):
    """Raised fast (no wire traffic) while the circuit breaker is open."""


class CircuitBreaker:
    """Consecutive-failure circuit breaker shared by all of a stub's RPCs.

    After `failure_threshold` consecutive failures the circuit opens: calls
    fail immediately with MasterUnreachableError for `cooldown_s`, then ONE
    probe call is let through (half-open); its outcome closes or re-opens
    the circuit. This keeps a worker from burning its master-unreachable
    grace window inside per-call connect timeouts against a dead address —
    the wall-clock-based `_master_unreachable` exit logic in the worker
    still makes the kill decision; the breaker just makes the failing
    window cheap and the log honest.
    """

    def __init__(self, failure_threshold: int = 5, cooldown_s: float = 10.0,
                 telemetry: bool = True):
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        # telemetry=False reuses the state machine without the
        # master-breaker gauges/events/log lines (the embedding data
        # plane keeps per-owner breakers and its own edl_emb_owner_*
        # metrics — a partitioned owner must not read as a master
        # outage on edl_rpc_breaker_open, nor close it back to 0)
        self._telemetry = telemetry
        # consecutive_failures is read lock-free by RetryingMasterStub's
        # error message (a snapshot for humans, not a decision input)
        self.consecutive_failures = 0
        self._opened_at: Optional[float] = None      # guarded_by: _lock
        self._probe_in_flight = False                # guarded_by: _lock
        # shared by the worker's heartbeat thread and main task loop: the
        # counter increment and the half-open single-probe admission are
        # read-modify-write and need the lock to stay exact
        self._lock = threading.Lock()

    @property
    def is_open(self) -> bool:
        with self._lock:
            return self._opened_at is not None

    def allow(self) -> bool:
        with self._lock:
            if self._opened_at is None:
                return True
            if (
                time.monotonic() - self._opened_at >= self.cooldown_s
                and not self._probe_in_flight
            ):
                # half-open: admit one probe; concurrent callers keep
                # failing fast until the probe resolves
                self._probe_in_flight = True
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            reopened = self._opened_at is not None
            self.consecutive_failures = 0
            self._opened_at = None
            self._probe_in_flight = False
        if reopened and self._telemetry:
            _BREAKER_OPEN.set(0)
            tracing.event("rpc.breaker_closed")
            logger.info("master circuit closed again (probe succeeded)")

    def reset(self) -> bool:
        """Clear ALL breaker state (close the circuit, zero the failure
        count, release any probe slot). The generation-handshake hook: a
        stale-generation rejection proves the master is back (the fence is
        an application answer riding a healthy transport), so treating it
        as one more transport failure would hold the circuit open forever
        against a live master. Returns True when anything was cleared."""
        with self._lock:
            dirty = (
                self._opened_at is not None
                or self.consecutive_failures > 0
                or self._probe_in_flight
            )
            self.consecutive_failures = 0
            self._opened_at = None
            self._probe_in_flight = False
        if dirty and self._telemetry:
            _BREAKER_OPEN.set(0)
            _BREAKER_RESETS.inc()
            tracing.event("rpc.breaker_reset")
            logger.info("master circuit reset (generation handshake)")
        return dirty

    def record_failure(self) -> None:
        with self._lock:
            self.consecutive_failures += 1
            self._probe_in_flight = False
            opened_now = False
            if self._opened_at is not None:
                self._opened_at = time.monotonic()  # re-open: restart cooldown
            elif self.consecutive_failures >= self.failure_threshold:
                self._opened_at = time.monotonic()
                opened_now = True
            failures = self.consecutive_failures
        if opened_now and self._telemetry:
            _BREAKER_OPEN.set(1)
            _BREAKER_TRIPS.inc()
            tracing.event("rpc.breaker_open", consecutive_failures=failures)
            logger.warning(
                "master circuit OPEN after %d consecutive RPC failures; "
                "failing fast for %.1fs between probes",
                failures, self.cooldown_s,
            )


def _traced_handler(
    name: str, method: Callable, generation_fn: Optional[Callable[[], int]] = None
) -> Callable:
    """Wrap a servicer method so an incoming trace context (gRPC metadata
    set by RetryingMasterStub) re-opens on the handler thread: the worker's
    span becomes the parent of a server-side `rpc.server.<method>` span,
    and one resize reads as one timeline across both roles.

    When `generation_fn` yields a nonzero master generation, it is stamped
    onto the response's trailing metadata — the server half of the
    generation handshake (RetryingMasterStub adopts it client-side)."""
    span_name = "rpc.server." + rpc_site(name)[len("rpc."):]

    def stamped(request, context):
        gen = generation_fn() if generation_fn is not None else 0
        if gen:
            try:
                context.set_trailing_metadata(((GENERATION_KEY, str(gen)),))
            except Exception:
                # the handshake is advisory on exotic contexts (in-process
                # fakes without trailing-metadata support); the RPC itself
                # must still be served: edl-lint: disable=EDL303
                pass
        return method(request, context)

    def handler(request, context):
        md = {}
        try:
            md = {k: v for k, v in (context.invocation_metadata() or ())}
        except Exception:
            # metadata is observability-only; a context that can't supply
            # it still serves the RPC: edl-lint: disable=EDL303
            pass
        trace_id = md.get(tracing.TRACE_ID_KEY)
        if not trace_id or name not in _TRACED_SERVER_RPCS:
            return stamped(request, context)
        with tracing.adopt(trace_id, md.get(tracing.SPAN_ID_KEY)):
            with tracing.span(span_name):
                return stamped(request, context)

    return handler


def add_master_servicer(server: grpc.Server, servicer: Any) -> None:
    """Register a servicer object exposing methods named after the rpcs."""
    handlers = {}
    # the generation is read per call, not captured: a MasterServicer built
    # before its journal replayed (tests) still stamps the final value
    generation_fn = (
        (lambda: int(getattr(servicer, "generation", 0) or 0))
        if hasattr(servicer, "generation") else None
    )
    for name, (req_t, _resp_t) in _RPCS.items():
        method = _traced_handler(name, getattr(servicer, name), generation_fn)
        handlers[name] = grpc.unary_unary_rpc_method_handler(
            method,
            request_deserializer=req_t.FromString,
            response_serializer=lambda msg: msg.SerializeToString(),
        )
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(SERVICE_NAME, handlers),)
    )


class MasterStub:
    """Client stub for the Master service."""

    def __init__(self, channel: grpc.Channel):
        self._methods = {}
        for name, (req_t, resp_t) in _RPCS.items():
            self._methods[name] = channel.unary_unary(
                f"/{SERVICE_NAME}/{name}",
                request_serializer=lambda msg: msg.SerializeToString(),
                response_deserializer=resp_t.FromString,
            )

    def __getattr__(self, name: str):
        try:
            return self._methods[name]
        except KeyError as e:
            raise AttributeError(name) from e


class RetryingMasterStub:
    """MasterStub hardened for the worker side of an elastic job.

    Every call gets a deadline (the per-RPC policy default, or an explicit
    `timeout=`); idempotent RPCs (see RpcPolicy) retry transient failures
    with exponential backoff + full jitter; a shared CircuitBreaker fails
    fast against a dead master. With no fault schedule active and no
    failures, the only behavior change over the bare stub is the deadline.

    `on_success` (if given) runs after every successful call — the worker
    wires its `_last_master_ok` clock here so the master-unreachable exit
    logic sees every RPC, not just the two loops that updated it by hand.
    """

    #: failures worth retrying: transport errors and injected faults. An
    #: INVALID_ARGUMENT-style local error also lands here — acceptable,
    #: since retries are bounded and only on idempotent calls.
    RETRYABLE = (grpc.RpcError, faults.FaultInjected)

    def __init__(
        self,
        channel: grpc.Channel,
        policies: Optional[Dict[str, RpcPolicy]] = None,
        on_success: Optional[Callable[[], None]] = None,
        breaker: Optional[CircuitBreaker] = None,
        backoff_base_s: float = 0.2,
        backoff_max_s: float = 5.0,
        rng: Optional[random.Random] = None,
        sleep: Callable[[float], None] = time.sleep,
        stub: Any = None,
        channel_factory: Optional[Callable[[], grpc.Channel]] = None,
        refresh_after: int = 3,
    ):
        self._stub = stub if stub is not None else MasterStub(channel)
        # Bounded reconnect loop for UNAVAILABLE-during-restart: a gRPC
        # channel whose subchannel wedged against a restarted master (stale
        # backoff state, dead reuseport flow) can report connect failures
        # long after the master is back. With a channel_factory, every
        # `refresh_after` consecutive transport failures the stub REBUILDS
        # the channel — fresh sockets, fresh resolver — instead of trusting
        # the wedged one forever. The workers wire this; injected test
        # stubs don't need it.
        self._channel = channel
        self._channel_factory = channel_factory
        self._refresh_after = max(1, refresh_after)
        self._transport_failures = 0          # guarded_by: _refresh_lock
        self._last_refresh = 0.0              # guarded_by: _refresh_lock
        self._refresh_lock = threading.Lock()
        self._policies = dict(DEFAULT_POLICIES)
        if policies:
            self._policies.update(policies)
        self._on_success = on_success
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        # The master generation this client believes current (None until
        # the first handshake). Claimed on every call as gRPC metadata so
        # the servicer can fence pre-restart stragglers; adopted from the
        # server's trailing metadata. The OWNER (worker/cohort) clears it
        # to None before a re-register — a generation-free RegisterWorker
        # is the handshake that learns the new one.
        self.generation: Optional[int] = None
        self._backoff_base_s = backoff_base_s
        self._backoff_max_s = backoff_max_s
        self._rng = rng if rng is not None else random.Random()
        self._sleep = sleep

    def _backoff(self, attempt: int) -> float:
        """Exponential with full jitter: uniform(0, base * 2^attempt]."""
        cap = min(self._backoff_max_s, self._backoff_base_s * (2 ** attempt))
        return cap * self._rng.uniform(0.1, 1.0)

    def __getattr__(self, name: str):
        if name not in _RPCS:
            raise AttributeError(name)
        policy = self._policies.get(name) or RpcPolicy(30.0, False)
        site = rpc_site(name)
        # the closure below is cached on the instance (end of this method):
        # __getattr__ runs once per RPC name, not once per call

        def call(request, timeout: Optional[float] = None, metadata=None):
            attempts = policy.max_attempts if policy.idempotent else 1
            deadline = timeout if timeout is not None else policy.timeout_s
            last: Optional[BaseException] = None
            for attempt in range(attempts):
                if not self.breaker.allow():
                    raise MasterUnreachableError(
                        f"{name}: circuit open after "
                        f"{self.breaker.consecutive_failures} consecutive "
                        "failures"
                    )
                t_call = time.perf_counter()
                # resolved per attempt, not captured: a channel refresh
                # swaps self._stub and the next attempt must use the NEW
                # multicallables, not a closed channel's
                method = getattr(self._stub, name)
                try:
                    _RPC_CALLS.inc(method=name)
                    faults.fire(site)
                    # the active trace context (a rescale span, a reform
                    # boot) rides the wire as gRPC metadata so the master's
                    # handler joins the same timeline — alongside the
                    # generation claim the servicer fences on; no metadata,
                    # no kwarg (injected test stubs only take
                    # (request, timeout))
                    md = list(tracing.rpc_metadata() or ())
                    if self.generation is not None:
                        md.append((GENERATION_KEY, str(self.generation)))
                    if metadata:
                        md.extend(metadata)
                    # with_call (real grpc multicallables only) exposes the
                    # server's trailing metadata — the generation handshake
                    with_call = getattr(method, "with_call", None)
                    rpc_call = None
                    if with_call is not None:
                        resp, rpc_call = with_call(
                            request, timeout=deadline, metadata=md or None
                        )
                    elif md:
                        resp = method(request, timeout=deadline, metadata=md)
                    else:
                        resp = method(request, timeout=deadline)
                    # lost-response injection: the server DID process the
                    # call; the caller never hears back
                    faults.fire(site + ".recv")
                except self.RETRYABLE as e:
                    if is_stale_generation(e):
                        # the master is BACK, under a new generation: this
                        # is an application-level fence on a healthy
                        # transport. Clear the breaker (it would otherwise
                        # re-open on every fenced probe and never close)
                        # and surface the rejection — the caller owns the
                        # re-register handshake.
                        self.breaker.reset()
                        raise
                    last = e
                    self.breaker.record_failure()
                    self._note_transport_failure()
                    _RPC_FAILURES.inc(method=name)
                    if _is_deadline_exceeded(e):
                        _RPC_DEADLINE.inc(method=name)
                    if attempt + 1 < attempts:
                        delay = self._backoff(attempt)
                        _RPC_RETRIES.inc(method=name)
                        tracing.event(
                            "rpc.retry", method=name, attempt=attempt + 1,
                            backoff_s=round(delay, 4),
                        )
                        logger.warning(
                            "%s failed (%s); retry %d/%d in %.2fs",
                            name, _err_summary(e), attempt + 1,
                            attempts - 1, delay,
                        )
                        self._sleep(delay)
                    continue
                except BaseException:
                    # non-retryable error (closed channel, bad request
                    # object, ...): record it so a half-open probe never
                    # leaves _probe_in_flight latched — otherwise the
                    # circuit would stay open forever against a healthy
                    # master — then surface it unchanged
                    self.breaker.record_failure()
                    _RPC_FAILURES.inc(method=name)
                    raise
                self.breaker.record_success()
                with self._refresh_lock:
                    self._transport_failures = 0
                if rpc_call is not None:
                    self._adopt_generation(rpc_call)
                _RPC_LATENCY.observe(
                    time.perf_counter() - t_call, method=name)
                if self._on_success is not None:
                    self._on_success()
                return resp
            raise last

        setattr(self, name, call)
        return call

    def _note_transport_failure(self) -> None:
        """Count a real wire failure; every `refresh_after`-th in a row
        rebuilds the channel (when a factory was wired). Rate-limited so
        the worker's heartbeat and task threads don't thrash a rebuild."""
        if self._channel_factory is None:
            return
        with self._refresh_lock:
            self._transport_failures += 1
            now = time.monotonic()
            if (
                self._transport_failures % self._refresh_after != 0
                or now - self._last_refresh < 2.0
            ):
                return
            self._last_refresh = now
            old = self._channel
            try:
                self._channel = self._channel_factory()
                # swap the stub LAST: concurrent calls resolve their
                # multicallable per attempt off self._stub
                self._stub = MasterStub(self._channel)
            except Exception:
                logger.exception("channel refresh failed; keeping old channel")
                self._channel = old
                return
            failures = self._transport_failures
        _CHANNEL_REFRESHES.inc()
        tracing.event("rpc.channel_refresh", consecutive_failures=failures)
        logger.warning(
            "rebuilt master channel after %d consecutive transport "
            "failures (stale subchannel state survives a master restart)",
            failures,
        )
        # The old channel is NOT force-closed: the stub is shared between
        # threads (heartbeat + task loop), and Channel.close() CANCELS every
        # in-flight RPC on it — a healthy non-idempotent ReportTaskResult
        # racing the refresh would be killed and never retried, expiring the
        # lease and re-running the task. Dropping the reference lets grpc
        # tear it down once the last in-flight call off it completes.

    def _adopt_generation(self, rpc_call: Any) -> None:
        """Read the master generation off a successful call's trailing
        metadata. Adopting a CHANGED generation is the handshake landing:
        the breaker is reset (edl_rpc_breaker_reset_total) so the restart's
        accumulated failures stop penalizing the recovered master."""
        try:
            trailing = rpc_call.trailing_metadata() or ()
        except Exception:
            # trailing metadata is the advisory half of the handshake;
            # a call object without it is not an error:
            # edl-lint: disable=EDL303
            return
        gen = None
        for k, v in trailing:
            if k == GENERATION_KEY:
                try:
                    gen = int(v)
                except (TypeError, ValueError):
                    return
                break
        if not gen:
            return
        prev, self.generation = self.generation, gen
        if prev is not None and prev != gen:
            self.breaker.reset()
            tracing.event(
                "rpc.generation_handshake", prev_generation=prev,
                generation=gen,
            )
            logger.warning(
                "master generation handshake: %d -> %d (master restarted)",
                prev, gen,
            )


def is_stale_generation(e: BaseException) -> bool:
    """True for the servicer's stale-master-generation fence: a
    FAILED_PRECONDITION whose details name the generation. Callers react by
    re-registering (clear `stub.generation`, RegisterWorker with
    REREGISTER_KEY), then re-leasing — never by treating the master as
    dead."""
    code = getattr(e, "code", None)
    details = getattr(e, "details", None)
    try:
        return (
            callable(code)
            and code() == grpc.StatusCode.FAILED_PRECONDITION
            and callable(details)
            and "generation" in str(details())
        )
    except Exception:
        # classification-only: an exotic error object is simply not a
        # stale-generation fence: edl-lint: disable=EDL303
        return False


def register_with_retry(
    stub: "RetryingMasterStub",
    *,
    name: str,
    preferred_id: int,
    window_s: float,
    shutdown: threading.Event,
    what: str = "worker",
    member_names=(),
    data_addr: str = "",
):
    """Boot-time registration hardened against a master that is down or
    RESTARTING right now (observed: a master crash with the registration
    handler already run server-side cancels the response — the join is
    journaled but this process never hears its id, and an unretried failure
    kills the whole worker, recovering only via the relaunch budget and
    leaving a ghost member). RegisterWorker is not blindly retriable (a
    duplicate plain join allocates a second id), so retries with a known
    ``preferred_id`` carry the REREGISTER marker: the successor master
    treats them as an idempotent reconnect of the journaled member.

    Bounded by the same clock that governs all master-unreachable
    decisions; ``window_s <= 0`` means that clock is DISABLED (config.py:
    "0 disables") — retry until ``shutdown`` fires, never give up on the
    master. Shared by worker.py and cohort.py so the handshake cannot
    diverge between the two worker flavors."""
    from elasticdl_tpu_torch.observability import goodput as goodput_lib

    deadline = (time.monotonic() + window_s) if window_s > 0 else None
    attempt = 0
    ledger = goodput_lib.get_ledger()
    while True:
        request = pb.RegisterWorkerRequest(
            worker_name=name,
            preferred_id_plus_one=preferred_id + 1 if preferred_id >= 0 else 0,
            member_names=list(member_names),
            data_plane_addr=data_addr,
        )
        metadata = (
            ((REREGISTER_KEY, "1"),) if attempt and preferred_id >= 0 else None
        )
        try:
            return stub.RegisterWorker(request, timeout=30, metadata=metadata)
        except Exception as e:
            attempt += 1
            if is_stale_generation(e):
                # raced a restart mid-handshake: drop the adopted claim
                # and register fresh against the successor
                stub.generation = None
            elif deadline is not None and time.monotonic() >= deadline:
                raise
            logger.warning(
                "%s boot registration failed (attempt %d): %s; retrying",
                what, attempt, e,
            )
            # goodput: riding out a down/restarting master is the
            # `reconnect` category (the generation-fence window)
            with ledger.phase("reconnect"):
                shutdown.wait(random.uniform(0.5, 1.5))
            if shutdown.is_set():
                raise


def reregister(stub: "RetryingMasterStub", *, name: str, worker_id: int,
               member_names=(), data_addr: str = ""):
    """The reconnect handshake after a master restart: clear the stale
    generation claim (a generation-free RegisterWorker is what learns the
    new one from the response's trailing metadata), then re-register under
    the EXISTING worker id with the REREGISTER marker — the restarted
    master treats it as an idempotent reconnect of a replayed member, not
    a fresh join (no membership-version bump for a live worker, so the
    cohort does not re-form). Callers apply the response to their own
    state; shared by worker.py and cohort.py."""
    from elasticdl_tpu_torch.observability import goodput as goodput_lib

    stub.generation = None
    # goodput: the re-register handshake is `reconnect` time — part of
    # the master-restart bill the fleet ledger totals
    with goodput_lib.get_ledger().phase("reconnect"):
        return stub.RegisterWorker(
            pb.RegisterWorkerRequest(
                worker_name=name, preferred_id_plus_one=worker_id + 1,
                member_names=list(member_names),
                data_plane_addr=data_addr,
            ),
            timeout=30,
            metadata=((REREGISTER_KEY, "1"),),
        )


def _is_deadline_exceeded(e: BaseException) -> bool:
    code = getattr(e, "code", None)
    try:
        return callable(code) and code() == grpc.StatusCode.DEADLINE_EXCEEDED
    except Exception:
        # classification-only (a metric label): an exotic error object
        # counts as not-a-deadline: edl-lint: disable=EDL303
        return False


def _err_summary(e: BaseException) -> str:
    code = getattr(e, "code", None)
    try:
        return str(code()) if callable(code) else repr(e)
    except Exception:
        return repr(e)


def make_channel(addr: str) -> grpc.Channel:
    return grpc.insecure_channel(addr, options=GRPC.OPTIONS)


def make_server(max_workers: int = 32) -> grpc.Server:
    from concurrent import futures

    return grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers),
        # so_reuseport off: gRPC's default SO_REUSEPORT lets a successor
        # master "successfully" bind a port whose previous (crashed, not
        # yet fully closed) server still holds a listener in the reuseport
        # group — the kernel then keeps hashing existing clients' reconnect
        # flows onto the dead socket and they see connection-refused until
        # it finally closes. An exclusive bind fails HONESTLY (0 /
        # RuntimeError -> PortBindError -> retry) until the port is truly
        # free, which is what the master-restart path needs.
        options=GRPC.OPTIONS + [("grpc.so_reuseport", 0)],
    )
