"""Elastic control-plane observability: metrics registry + trace spans +
scrape surface.

Three stdlib-only layers (nothing here may import jax — the registry and
tracer are wired into modules that must stay importable everywhere,
including the framework-free client submit path):

- `registry`: process-local metrics (counters, gauges, histograms with
  bounded reservoirs; thread-safe), rendered in Prometheus text format.
  Every metric name follows `edl_<subsystem>_<name>` — enforced at
  registration time AND statically by edl-lint EDL401.
- `tracing`: named spans/events for elastic lifecycle transitions
  (reform, rescale, checkpoint save/restore/handoff, speculative compile,
  RPC retries, prefetcher drains, task lease transitions), written as
  `trace.jsonl` lines carrying role, world version, and a trace id that
  propagates master<->worker through gRPC metadata so one resize produces
  one coherent cross-role timeline.
- `http`: a tiny stdlib HTTP endpoint (`/metrics` Prometheus text,
  `/healthz` JSON) the master and each worker expose, bound via
  `net.bind_with_retry`, strictly best-effort (fault site
  `metrics_scrape` lets chaos tests kill it and assert training never
  notices).
- `health`: the interpretation layer — heartbeat-piggybacked worker
  stats (gRPC metadata, optional/back-compatible) feeding per-worker
  rolling records in Membership, scored by a median/MAD straggler
  detector whose rollup rides the master's /metrics + /healthz.
- `analyzer` (+ the `analyze` CLI): offline trace merge and per-resize
  critical-path attribution over the `trace.jsonl` files.
- `flight`: the per-process incident black box — a bounded in-memory
  ring of recent spans/events/logs/metric deltas at full fidelity,
  dumped as an atomic `flight-<role>-<pid>.json` bundle on crash,
  SIGUSR2, `/debug/flight`, or straggler-hook escalation.
- `profile`: the always-on step profiler — per-step phase attribution
  (data_wait / h2d / compute / handoff) and memory watermarks, exported
  as `edl_step_phase_seconds` / `edl_mem_*` gauges and riding the
  heartbeat stats payload.
- `incident` (+ CLI): offline cross-role correlation of flight bundles,
  traces, the journal tail, and health snapshots into one timeline.

See docs/observability.md for the metric catalog and trace schema.
"""

from elasticdl_tpu_torch.observability.registry import (  # noqa: F401
    MetricsRegistry,
    default_registry,
)
from elasticdl_tpu_torch.observability import tracing  # noqa: F401
