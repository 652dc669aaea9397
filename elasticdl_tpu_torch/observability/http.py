"""/metrics + /healthz scrape endpoint (stdlib http.server).

Strictly best-effort and off the hot path: serving runs on daemon threads
(ThreadingHTTPServer), a failed bind or a dead server never takes the
process down, and the `metrics_scrape` fault site lets chaos schedules
abort scrapes (`drop`), slow them (`delay`), or kill the ENDPOINT
(`crash` — the server shuts down; the training process must not notice).

Binding goes through `net.bind_with_retry` for the ephemeral-port case
(the launcher TOCTOU discipline every other server here follows); a
fixed port raises PortBindError so callers can retry or disable.
"""

from __future__ import annotations

import errno
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

from elasticdl_tpu_torch.common import faults
from elasticdl_tpu_torch.common.log_utils import default_logger
from elasticdl_tpu_torch.common.net import PortBindError, bind_with_retry
from elasticdl_tpu_torch.observability import tracing
from elasticdl_tpu_torch.observability.registry import (
    MetricsRegistry,
    default_registry,
)

logger = default_logger(__name__)

#: fault-injection site fired per scrape request (see common/faults.py)
SCRAPE_FAULT_SITE = "metrics_scrape"

#: env knob for the default servers master/worker start: a port number,
#: "0" = ephemeral (the default), "-1"/"off" = disabled
PORT_ENV = "EDL_METRICS_PORT"


class ObservabilityServer:
    """One /metrics + /healthz endpoint over a registry."""

    #: endpoint -> one-line description: what GET / serves, so an
    #: operator curling a process learns its surface without reading
    #: source (every process serves all of these; master-only state —
    #: alerts, fleet goodput — answers with a disabled/absent marker
    #: elsewhere)
    ENDPOINTS = {
        "/": "this index",
        "/metrics": "Prometheus text: the process metric registry",
        "/healthz": "liveness + role/world-version (master adds "
                    "generation, membership, cluster rollup, alerts, "
                    "fleet goodput)",
        "/timeseries": "recent metric history ring "
                       "(?window=<s>&series=a,b)",
        "/alerts": "alert engine state (active/history/rules; "
                   "disabled off-master)",
        "/goodput": "goodput ledger: per-category wall-clock "
                    "attribution (master adds the fleet rollup + "
                    "wasted-work bill)",
        "/debug/flight": "dump + serve the flight-recorder ring "
                         "(explicit incident trigger)",
    }

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 role: str = "", host: str = "127.0.0.1",
                 health_fn: Optional[Callable[[], Dict]] = None,
                 flight=None, timeseries=None, alerts=None,
                 goodput_fn: Optional[Callable[[], Dict]] = None):
        self.registry = registry or default_registry()
        self.role = role
        self.host = host
        # /debug/flight serves (and dumps) this recorder's bundle; None
        # falls back to the process singleton at request time — the
        # recorder may be configured after the server starts
        self.flight = flight
        # /timeseries serves this store's recent window (None falls back
        # to the process singleton — every process has one); /alerts
        # serves the engine's snapshot (masters wire one; elsewhere the
        # endpoint answers with an empty, disabled-marked state)
        self.timeseries = timeseries
        self.alerts = alerts
        # /goodput serves the process ledger's attribution; the master
        # wires goodput_fn to add its FleetGoodput rollup (cached state,
        # never a recompute — same contract as health_fn)
        self.goodput_fn = goodput_fn
        # /healthz enrichment: a dict merged into the response (the master
        # wires generation/alive-count/cluster-rollup here). Best-effort
        # like everything else on this surface — a raising callback marks
        # the response, never 500s it, and the underlying state (e.g. the
        # ClusterHealth rollup) is computed elsewhere: a dead or dying
        # endpoint never blocks health SCORING.
        self.health_fn = health_fn
        self.port: Optional[int] = None
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ #

    def _handler_class(self):
        outer = self

        class Handler(BaseHTTPRequestHandler):
            # never let a slow/half-open scraper pin a handler thread
            timeout = 10

            def do_GET(self):
                fired = faults.check(SCRAPE_FAULT_SITE)
                if fired is not None and fired.action == "drop":
                    # abort the connection with no response — the scraper
                    # sees a reset, training sees nothing
                    self.close_connection = True
                    return
                if fired is not None and fired.action == "crash":
                    # kill the ENDPOINT, not the process: serving is
                    # best-effort; chaos tests assert training continues
                    outer.stop(_from_handler=True)
                    self.close_connection = True
                    return
                if self.path.split("?")[0] == "/":
                    # the index (ISSUE 12 satellite): every mounted
                    # endpoint with a one-line description — no more
                    # reading the source to learn what a process serves
                    payload = {
                        "role": outer.role,
                        "endpoints": dict(outer.ENDPOINTS),
                    }
                    body = (
                        json.dumps(payload, indent=1, sort_keys=True)
                        + "\n"
                    ).encode()
                    ctype = "application/json"
                elif self.path.split("?")[0] == "/metrics":
                    body = outer.registry.render_prometheus().encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif self.path.split("?")[0] == "/debug/flight":
                    # explicit incident trigger: dump the flight ring (the
                    # atomic file write is best-effort) AND serve the
                    # bundle back. dump()/bundle() copy the ring under its
                    # leaf lock and do file I/O outside it, so a dump in
                    # progress never blocks a concurrent /metrics or
                    # /healthz scrape (satellite-tested).
                    from elasticdl_tpu_torch.observability import (
                        flight as flight_lib,
                    )

                    rec = outer.flight or flight_lib.get_recorder()
                    bundle = rec.bundle(reason="http")
                    bundle["dumped_to"] = rec.dump(
                        reason="http", bundle=bundle
                    )
                    body = (
                        json.dumps(bundle, default=repr) + "\n"
                    ).encode()
                    ctype = "application/json"
                elif self.path.split("?")[0] == "/timeseries":
                    # the bounded snapshot ring (observability/
                    # timeseries.py): ?window=<s> bounds the window,
                    # ?series=a,b filters. to_payload copies the ring
                    # under its leaf lock and does the arithmetic
                    # outside, so a scrape never blocks sampling.
                    from urllib.parse import parse_qs, urlsplit

                    from elasticdl_tpu_torch.observability import (
                        timeseries as ts_lib,
                    )

                    q = parse_qs(urlsplit(self.path).query)
                    try:
                        window = float(q.get("window", ["300"])[0])
                    except ValueError:
                        window = 300.0
                    wanted = None
                    if q.get("series"):
                        wanted = [
                            s for s in q["series"][0].split(",") if s
                        ]
                    store = outer.timeseries or ts_lib.get_store()
                    payload = store.to_payload(
                        window_s=window, series=wanted)
                    payload["role"] = outer.role
                    body = (
                        json.dumps(payload, default=repr) + "\n"
                    ).encode()
                    ctype = "application/json"
                elif self.path.split("?")[0] == "/alerts":
                    # the alert engine's cached state (observability/
                    # alerts.py) — a scrape never triggers an evaluation
                    if outer.alerts is not None:
                        payload = outer.alerts.snapshot()
                    else:
                        payload = {"enabled": False, "active": [],
                                   "history": [], "rules": []}
                    payload["role"] = outer.role
                    body = (
                        json.dumps(payload, default=repr) + "\n"
                    ).encode()
                    ctype = "application/json"
                elif self.path.split("?")[0] == "/goodput":
                    # the goodput ledger (observability/goodput.py):
                    # this process's per-category wall-clock attribution
                    # (snapshot copies under the leaf lock, arithmetic
                    # outside), plus — on the master — the cached fleet
                    # rollup and wasted-work bill. Best-effort like
                    # health_fn: a raising fleet callback marks the
                    # response, never 500s it.
                    from elasticdl_tpu_torch.observability import (
                        goodput as goodput_lib,
                    )

                    payload = {
                        "role": outer.role,
                        "ledger": goodput_lib.get_ledger().snapshot(),
                    }
                    if outer.goodput_fn is not None:
                        try:
                            extra = outer.goodput_fn()
                            if isinstance(extra, dict):
                                payload["fleet"] = extra
                        except Exception:
                            # edl-lint: disable=EDL303
                            payload["fleet_error"] = True
                    body = (
                        json.dumps(payload, default=repr) + "\n"
                    ).encode()
                    ctype = "application/json"
                elif self.path.split("?")[0] == "/healthz":
                    payload = {
                        "status": "ok",
                        "role": outer.role,
                        "world_version": tracing.get_tracer().world_version,
                        "pid": os.getpid(),
                    }
                    if outer.health_fn is not None:
                        try:
                            extra = outer.health_fn()
                            if isinstance(extra, dict):
                                payload.update(extra)
                        except Exception:
                            # enrichment is advisory; the probe answer
                            # ("the process serves") must still go out:
                            # edl-lint: disable=EDL303
                            payload["health_extra_error"] = True
                    body = (json.dumps(payload) + "\n").encode()
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):  # quiet by default
                logger.debug("metrics endpoint: " + fmt, *args)

        return Handler

    def _build(self, port: int) -> ThreadingHTTPServer:
        handler = self._handler_class()
        try:
            srv = ThreadingHTTPServer((self.host, port), handler)
        except OSError as e:
            if e.errno == errno.EADDRINUSE:
                raise PortBindError(
                    f"metrics endpoint lost port {port} to the bind race"
                ) from e
            raise
        srv.daemon_threads = True
        return srv

    def start(self, port: int = 0) -> int:
        """Bind and serve on a daemon thread; returns the bound port.
        port=0 picks an ephemeral port through net.bind_with_retry."""
        if self._server is not None:
            return self.port
        if port == 0:
            self.port, self._server = bind_with_retry(self._build)
        else:
            self._server = self._build(port)
            self.port = port
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="edl-metrics-http",
            daemon=True,
        )
        self._thread.start()
        logger.info(
            "metrics endpoint serving on http://%s:%d/metrics (role %s)",
            self.host, self.port, self.role or "?",
        )
        return self.port

    def stop(self, _from_handler: bool = False) -> None:
        server, self._server = self._server, None
        thread, self._thread = self._thread, None
        if server is None:
            return
        if _from_handler:
            # shutdown() deadlocks when called from a handler thread of the
            # same server; hand it to a throwaway thread
            def _kill():
                server.shutdown()
                server.server_close()

            threading.Thread(
                target=_kill, name="edl-metrics-kill", daemon=True
            ).start()
            return
        server.shutdown()
        server.server_close()
        if thread is not None:
            thread.join(timeout=5)

    @property
    def address(self) -> Optional[str]:
        return f"http://{self.host}:{self.port}" if self.port else None


def start_server(role: str = "", port: Optional[int] = None,
                 registry: Optional[MetricsRegistry] = None,
                 health_fn: Optional[Callable[[], Dict]] = None,
                 timeseries=None, alerts=None,
                 goodput_fn: Optional[Callable[[], Dict]] = None,
                 ) -> Optional[ObservabilityServer]:
    """Best-effort endpoint start for the master/worker entrypoints.
    A set (non-empty) EDL_METRICS_PORT env overrides `port` in BOTH
    directions: it can disable a configured endpoint ("-1"/"off") or
    enable/repoint one the config disabled. Otherwise `port` decides:
    None/0 = ephemeral, < 0 = disabled. Returns None instead of raising —
    observability must never be the reason a job fails to boot."""
    raw = os.environ.get(PORT_ENV)
    if raw is not None and raw.strip():
        raw = raw.strip().lower()
        if raw in ("-1", "off", "disabled", "none"):
            return None
        try:
            port = int(raw)
        except ValueError:
            # a typo'd override must not silently bind a random port the
            # operator's scraper will never find — disable, loudly
            logger.warning(
                "%s=%r is not a port number; metrics endpoint disabled",
                PORT_ENV, raw,
            )
            return None
    if port is None:
        port = 0
    if port < 0:
        return None
    server = ObservabilityServer(
        registry=registry, role=role, health_fn=health_fn,
        timeseries=timeseries, alerts=alerts, goodput_fn=goodput_fn,
    )
    try:
        server.start(port)
    except Exception:
        logger.exception("metrics endpoint failed to start; continuing")
        return None
    return server
