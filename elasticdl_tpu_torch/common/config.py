"""Typed job configuration with argv round-trip.

Reference parity: elasticdl/python/common/args.py. The reference's config plane
works by parsing argparse flags in the client, then *re-serializing the parsed
namespace back into argv* for the master pod's command line, which does the same
for workers. That propagation trick is simple and debuggable, so we keep it —
but as one typed dataclass (`JobConfig`) with `to_argv()` / `from_argv()`
instead of hand-maintained parallel argparse groups.

Roles (client / master / worker) share this single schema; each reads the
fields it needs. Freeform `--model_params` / `--data_reader_params` key=value
strings pass user parameters through to model-zoo code, matching the
reference's behavior.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field, fields
from typing import Any, Dict, List, Optional

from elasticdl_tpu_torch.common.constants import DEFAULT_MASTER_PORT, JobType


def parse_kv_params(s: str) -> Dict[str, Any]:
    """Parse 'a=1;b=hello;c=0.5' into a dict with literal-ish coercion.

    Reference parity: the reference's `--model_params` / `--envs` freeform
    key=value passthrough (elasticdl/python/common/args.py).
    """
    out: Dict[str, Any] = {}
    if not s:
        return out
    for item in s.split(";"):
        item = item.strip()
        if not item:
            continue
        if "=" not in item:
            raise ValueError(f"Malformed key=value item: {item!r}")
        k, v = item.split("=", 1)
        k, v = k.strip(), v.strip()
        for caster in (int, float):
            try:
                out[k] = caster(v)
                break
            except ValueError:
                continue
        else:
            if v.lower() in ("true", "false"):
                out[k] = v.lower() == "true"
            else:
                out[k] = v
    return out


def format_kv_params(d: Dict[str, Any]) -> str:
    return ";".join(f"{k}={v}" for k, v in d.items())


# Valid --remat_policy names. The jax.checkpoint policies they map to live
# in training/trainer.resolve_remat_policy (kept out of this module so the
# client submit path stays framework-free); tests pin the two in sync.
REMAT_POLICY_NAMES = ("dots", "dots_no_batch", "nothing")


@dataclass
class JobConfig:
    """Everything a training/evaluation/prediction job needs, in one place."""

    # --- identity ---
    job_name: str = "edl-job"
    job_type: str = JobType.TRAINING_WITH_EVALUATION

    # --- model-zoo contract (reference: --model_zoo / --model_def) ---
    model_zoo: str = "model_zoo"
    model_def: str = ""           # dotted path: "mnist.mnist_cnn.custom_model"
    model_params: Dict[str, Any] = field(default_factory=dict)
    # Optional per-function overrides (reference: --loss=..., --optimizer=...)
    loss: str = ""
    optimizer: str = ""
    dataset_fn: str = ""
    eval_metrics_fn: str = ""
    prediction_outputs_processor: str = ""

    # --- data ---
    training_data: str = ""
    validation_data: str = ""
    prediction_data: str = ""
    data_reader: str = ""          # "" = infer from path; "recordio"|"csv"|...
    data_reader_params: Dict[str, Any] = field(default_factory=dict)
    records_per_task: int = 4096
    num_epochs: int = 1
    minibatch_size: int = 64
    shuffle: bool = True
    shuffle_seed: int = 0

    # --- evaluation (units: model-version steps = minibatches, matching the
    # reference's --evaluation_steps; 0 = evaluate at epoch end only) ---
    evaluation_steps: int = 0
    evaluation_start_delay_steps: int = 0

    # --- checkpointing (reference: --checkpoint_steps etc.) ---
    checkpoint_dir: str = ""
    checkpoint_steps: int = 0
    keep_checkpoint_max: int = 3
    output: str = ""               # final model export dir
    summary_dir: str = ""          # JSONL + TensorBoard summaries (master-side)
    # Elastic linear LR scaling: on membership change, scale the (injected)
    # learning rate by alive_workers/num_workers (see training/lr_modulation)
    scale_lr_with_workers: bool = False
    # >1: workers run K train steps per XLA dispatch (Trainer.train_many,
    # lax.scan over a stacked batch group) — amortizes host->device dispatch
    # latency; loss/step-time telemetry becomes per-group, preemption checks
    # happen at group boundaries.
    steps_per_dispatch: int = 1
    # Async host->device batch prefetch depth (0 disables; see data/prefetch)
    prefetch_batches: int = 2
    # Wire dtype for float batch features ("" = native, "bfloat16" halves
    # transfer bytes; lossless for bf16-compute models — see data/prefetch)
    wire_dtype: str = ""

    # --- profiling (SURVEY §5 tracing; the reference had no in-repo tracer,
    # jax.profiler makes this nearly free) ---
    profile_dir: str = ""          # "" = off; else jax.profiler trace output
    profile_start_step: int = 5    # skip compile + warmup steps
    profile_steps: int = 20        # trace this many steps, then stop

    # --- observability (metrics registry + trace spans; observability/) ---
    # /metrics + /healthz HTTP endpoint per process: 0 = ephemeral port
    # (default), -1 disables; the EDL_METRICS_PORT env overrides either.
    metrics_port: int = 0
    # control-plane trace spans (trace.jsonl, one file per role under
    # <trace_dir>/<role>/): "" derives <summary_dir>/trace when summary_dir
    # is set (spans stay in-memory otherwise); "off" disables the file sink.
    trace_dir: str = ""
    # Incident flight recorder (observability/flight.py): where per-process
    # flight-<role>-<pid>.json bundles land on crash, SIGUSR2, the
    # /debug/flight endpoint, or straggler-hook escalation. "" derives
    # <summary_dir|checkpoint_dir>/flight
    # (memory-only when neither is set); "off" disables dumping (the ring
    # still records); EDL_FLIGHT_DIR overrides either way.
    flight_dir: str = ""
    # Flight ring capacity (records kept at full fidelity per process).
    flight_ring: int = 4096
    # Metrics time series (observability/timeseries.py): every process
    # keeps a bounded ring of periodic registry snapshots, served by
    # GET /timeseries and persisted as a rolling metrics_history.jsonl
    # under <summary_dir|checkpoint_dir>/timeseries/<role>/. The master's
    # ring additionally carries fleet series computed from heartbeat
    # stats payloads — the alert engine's input.
    timeseries_interval_s: float = 5.0
    timeseries_samples: int = 720      # ring capacity: 720 x 5s = 1h
    # Declarative alert rules (observability/alerts.py), evaluated on the
    # master's wait poll: "" = the shipped default rule set (straggler,
    # backlog-per-worker, data_wait-dominant fleet, embedding pull p99,
    # shard imbalance), "off" = disabled, else a path to a JSON list of
    # rule objects (see docs/observability.md "Alert rules").
    alert_rules: str = ""
    # Straggler-scorer quorum (observability/health.py ClusterHealth):
    # minimum workers with fresh telemetry before robust-z scoring runs.
    # Floor 2 — a 2-worker fleet can still flag a straggler through the
    # min_ratio gate; below that "who is slow" is undecidable. The old
    # hard-coded 3 is the default.
    straggler_quorum: int = 3

    # --- closed-loop autoscaler (master/autoscaler.py; ROADMAP 3) ---
    # false (default) = every rescale stays human-initiated (the
    # pre-autoscaler behavior; also the way to DISABLE the loop). true =
    # the master turns health signals into journaled, fenced rescale
    # actions: evict confirmed stragglers (drain-first), grow on
    # sustained dispatcher backlog, shrink when data_wait dominates.
    autoscale: bool = False
    # world bounds the policy may move within (max 0 = unbounded)
    autoscale_min_workers: int = 1
    autoscale_max_workers: int = 0
    # minimum seconds between APPLIED actions (anti-flap; inherited
    # across master restarts via the journal's autoscale records)
    autoscale_cooldown_s: float = 120.0
    # hysteresis: a signal must persist this long before it is acted on
    autoscale_hold_s: float = 30.0
    # per-job action budget — the blast-radius cap; once spent, every
    # further decision suppresses with `budget_exhausted`
    autoscale_actions_max: int = 8
    # cost-model seed: projected per-worker rescale cost in seconds.
    # Seed it from YOUR deployment's measured `bench.py rescale`
    # `time_to_recovery_s` (bench-baselines/bench-rescale.json); the
    # model then updates online from observed re-formation durations.
    autoscale_rescale_cost_s: float = 10.0
    # horizon the projected goodput gain accrues over: an action is
    # taken only when gain(horizon) > rescale_cost x world
    autoscale_horizon_s: float = 300.0
    # signal damping in [0, 1): EWMA smoothing factor applied to the
    # grow/shrink alert values — a decision needs the SMOOTHED value
    # past the rule threshold by a deadband margin, so one noisy sample
    # cannot thrash the loop. 0 (default) = decide on raw signals.
    autoscale_damping: float = 0.0
    # anti-thrash reversal hold: a grow→shrink (or shrink→grow)
    # candidate within this many seconds of the last applied opposite
    # action suppresses with reason `reversal_hold`. 0 = off.
    autoscale_reversal_hold_s: float = 0.0

    # --- closed-loop LAYOUT controller (master/layout_controller.py;
    # ISSUE 20 — the embedding-tier sibling of the autoscaler above) ---
    # false (default) = the embedding layout stays human-operated; true
    # = skew signals (shard imbalance, cache-hit collapse, the sketch's
    # hot-id share) drive journaled, cost-gated layout actions: per-
    # shard replica fan-out, shard split/merge through the two-phase
    # reshard fence, and hot-id promotion into a worker-replicated set.
    layout_autoscale: bool = False
    # shard-count bounds for split/merge. max 0 = splitting DISABLED
    # (replica fan-out and hot-id actions still run); merge never folds
    # below the bootstrap shard count regardless of min.
    layout_max_shards: int = 0
    layout_min_shards: int = 1
    # per-shard read-replica cap for replica_fanout
    layout_max_replicas: int = 2
    # ultra-hot set size (worker-replicated sketch head); 0 disables
    # hot promotion
    layout_hot_k: int = 16
    # PER-KIND cooldown between applied actions of the same kind (a
    # replica fan-out must not cool down a pending split); inherited
    # across master restarts via the journal's `layout` records
    layout_cooldown_s: float = 60.0
    # hysteresis: a skew signal must persist this long before action
    layout_hold_s: float = 15.0
    # per-job layout action budget (blast-radius cap)
    layout_actions_max: int = 16
    # cost-model seed: projected blocked-read-seconds per shard touched
    # by a migration. Seed it from YOUR deployment's measured `bench.py
    # embedding_tier` reshard `recovery_s` (bench-baselines/
    # bench-embedding-tier.json); EWMA-updated from real migrations.
    layout_migrate_cost_s: float = 0.16
    # horizon the projected read-stall relief accrues over
    layout_horizon_s: float = 120.0

    # --- cluster shape / elasticity ---
    # Who owns worker lifecycles: "" = the launcher (local subprocess
    # manager, or the k8s StatefulSet's own self-healing); "k8s" = the MASTER
    # creates/watches/relaunches worker pods through the k8s API — the
    # reference's k8s_instance_manager flavor (master/k8s_instance_manager.py)
    instance_manager: str = ""
    num_workers: int = 1
    # >1 = multi-process SPMD cohort: one jax.distributed world + one global
    # mesh across this many processes (worker/cohort.py). The master sees one
    # logical worker (the cohort leader).
    num_processes: int = 1
    num_minibatches_per_task: int = 0   # 0 = derive from records_per_task
    max_task_retries: int = 3
    relaunch_max: int = 3               # reference: --relaunch_pod_max_num
    task_timeout_s: float = 600.0
    worker_heartbeat_s: float = 10.0
    # No successful master RPC for this long -> the worker assumes the
    # master is permanently gone and exits EX_TEMPFAIL (a live instance
    # manager relaunches it; a truly orphaned worker frees its resources
    # instead of spinning on a dead address forever). 0 disables.
    master_unreachable_timeout_s: float = 300.0
    # Persistent XLA compilation cache (common/runtime.py): relaunched
    # workers deserialize the previous generation's executables instead of
    # paying the 20-40 s TPU recompile on every elastic recovery. Point it
    # at storage shared across relaunches (e.g. next to checkpoint_dir).
    compilation_cache_dir: str = ""
    # <0 keeps JAX's default floor (~1 s: only expensive programs persist);
    # >=0 overrides it (tests use 0 so test-sized programs cache too).
    compilation_cache_min_compile_s: float = -1.0
    # Rescale fast path: once steady state is reached, precompile the step
    # programs for neighbor world sizes (N±1, plus any size announced by
    # the master's pending-membership signal) in a background thread so a
    # resize lands on a warm executable cache (training/compile_cache.py).
    speculative_compile: bool = False
    # Chaos (local launcher): survive up to this many in-process master
    # crashes — the `master_crash` fault site's `drop` action raised out of
    # Master.wait is caught by client/local.py, which crashes the master
    # abruptly and rebuilds it on the same port; the successor replays the
    # control-plane journal (requires checkpoint_dir) and workers reconnect
    # under the bumped generation without restarting. 0 = a master crash
    # fails the job (the pre-journal behavior).
    master_restarts: int = 0
    # fsync every control-journal commit (the crash-durability contract:
    # a transition is on disk before its effect is observable). Task
    # lease/report commits happen under the dispatcher lock, so on a
    # high-latency checkpoint filesystem (NFS / GCS FUSE) per-commit
    # fsync bounds master dispatch throughput to ~1/fsync-latency
    # fleet-wide. false trades the last-commit durability window (a crash
    # may lose transitions still in the page cache; workers then redo the
    # affected tasks — at-least-once, never silent loss) for throughput.
    journal_fsync: bool = True
    # Journal group-commit window (ms). 0 = per-commit mode (the
    # journal_fsync tradeoff above in full). >0 = mutators enqueue onto an
    # ordered commit queue and a committer thread flushes the whole window
    # under ONE write+fsync; RPC responses that acknowledge a journaled
    # transition are released only after their commit's fsync lands
    # (ack-after-fsync), so durability is NOT weakened — per-request fsync
    # cost is amortized across every commit in the window instead. See
    # docs/performance.md "Control-plane throughput".
    journal_group_commit_ms: float = 0.0
    # Batched task leases: workers ask for up to this many tasks per
    # GetTask round-trip (one group-committed journal batch) and drain the
    # local lease queue before re-polling. 1 = classic one-lease-per-poll.
    # Sizing caveat: the master's task_timeout_s clock starts at LEASE
    # time for every task in the batch — keep batch * per-task wall time
    # well under task_timeout_s or tail leases expire while queued.
    task_lease_batch: int = 1

    # --- elastic sharded embedding tier (elasticdl_tpu/embedding/) ---
    # >0 enables the tier: embedding tables declared by the model are
    # id-sharded (`shard = id % embedding_shards`) across owning workers,
    # pulled/pushed per batch (deduped, per-shard batched), with the
    # shard map owned by the master and journaled (survives master
    # crash-restart); shards migrate on world change. Size it at 1-4x the
    # expected worker count — see docs/performance.md "Embedding tier
    # sizing". 0 = off (tables live in HBM inside the jitted step, the
    # default single-host path).
    embedding_shards: int = 0
    # --- serving-grade embedding reads (ISSUE 13), three switchable
    # layers on top of the tier (each independently attributable in
    # `bench.py embedding_tier`):
    # worker-local hot-row cache capacity in ROWS PER TABLE (0 = off).
    # Size from the measured hot set: `hot_id_share` in tier_stats()
    # says what fraction of pull traffic the sketch's top-K ids carry —
    # see docs/performance.md "Embedding read path".
    embedding_cache_rows: int = 0
    # staleness bound in PUSH-WATERMARK units (shard pushes, not
    # seconds): a cached row / replica answer more than this many
    # applied pushes behind the observed owner watermark is refetched.
    # 0 = always revalidate against the owner's watermark; larger
    # trades convergence freshness for hit rate.
    embedding_cache_staleness: int = 1
    # read replicas per shard (0 = off): the master assigns and
    # journal-commits replica owners next to primaries; replicas sync
    # by watermark-tagged deltas, reads fan out to the least-loaded
    # fresh-enough copy, writes stay primary-only, and a dead owner's
    # shard promotes a surviving replica.
    embedding_read_replicas: int = 0
    # pull pipeline lookahead (0 = off): overlap the NEXT batch's
    # deduped pull with the current step's compute; drained (batches
    # re-issued) across rescale/reshard.
    embedding_pull_pipeline: int = 0
    # --- partition-tolerant gRPC data plane (ISSUE 15,
    # embedding/data_plane.py) ---
    # "local" = the in-process LocalTransport (single-process jobs, the
    # thread-cohort bench swarm); "grpc" = each worker serves its owning
    # shards over a per-worker EmbeddingData endpoint (bound next to the
    # observability endpoint, address ridden on RegisterWorker and the
    # shard-map response) and routes peers' shards through
    # GrpcTransport, wrapped in the ResilientTransport robustness layer
    # (deadlines, per-owner breakers, hedged reads, degraded-mode
    # serving, queued pushes).
    embedding_transport: str = "local"
    # per-call deadline BUDGET for data-plane pulls/pushes, in ms:
    # retries and backoff sleeps spend it, each attempt's wire deadline
    # is the remainder split over remaining attempts, and it propagates
    # to the owner as the gRPC deadline (EDL208 polices stub calls that
    # skip it).
    embedding_rpc_deadline_ms: int = 2000
    # hedge delay for data-plane reads, in ms: a pull whose primary has
    # not answered after this long races a replica (first credible
    # answer wins). 0 = derive from the measured pull p99 (x1.5, 1 ms
    # floor) — see docs/performance.md "Hedge-delay sizing"; < 0
    # disables hedging.
    embedding_hedge_ms: int = 0
    # bounded push queue behind an open owner breaker (entries; 0 =
    # never queue — pushes block/raise through the partition instead).
    # Queued pushes journal to <checkpoint_dir>/emb-push-queue.jsonl
    # and drain in order on reconnect under their original seqs.
    embedding_push_queue: int = 1024
    # same-host shared-memory short-circuit (ISSUE 18): when a tier
    # client and an owning store share a host, hot data-plane calls
    # ride a negotiated shared-memory ring instead of the gRPC
    # loopback (~10x lower per-call cost); any ring failure falls
    # back to gRPC transparently. grpc transport only; off = always
    # use the socket.
    embedding_shm: bool = True

    # --- mesh / parallelism (TPU-native; no reference analog) ---
    mesh_shape: str = ""           # "" = all devices on axis "data"; "4,2" = data=4, model=2
    # Multi-slice: per-axis DCN (across-slice) factors, named form only
    # ("data=2" = data-parallel across 2 slices). mesh_shape then describes
    # ONE slice's ICI layout; see parallel/mesh.build_hybrid_mesh.
    dcn_mesh_shape: str = ""
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = False            # jax.checkpoint the forward pass
    # named jax.checkpoint policy (implies remat): "dots" keeps MXU outputs
    # and recomputes elementwise, "dots_no_batch" also drops attention
    # scores, "nothing" recomputes everything (min HBM). "" = full remat
    # when --remat is set. See training/trainer.resolve_remat_policy.
    remat_policy: str = ""
    # Gradient accumulation: split each minibatch into K micro-batches and
    # scan forward+backward holding one micro-batch of activations live —
    # with a per-example (vector) loss, grads are EXACTLY the full-batch
    # step's (masked-weighted), so K is a pure HBM knob for raising
    # effective batch size. A loss returning a pre-reduced SCALAR weighs
    # micro-batches equally instead (trainer warns once). Must divide
    # minibatch_size.
    grad_accum_steps: int = 1

    # --- addresses / runtime ---
    master_addr: str = f"localhost:{DEFAULT_MASTER_PORT}"
    coordinator_addr: str = ""     # jax.distributed coordination service
    use_tpu: bool = True
    log_level: str = "INFO"

    # --- k8s submission (client-side; reference: --image_name etc.) ---
    image_name: str = ""
    namespace: str = "default"
    master_resource_request: str = "cpu=1,memory=2048Mi"
    worker_resource_request: str = "cpu=4,memory=8192Mi"
    tpu_type: str = ""             # e.g. "v5e-32"
    volume: str = ""
    image_pull_policy: str = "IfNotPresent"
    restart_policy: str = "Never"
    envs: Dict[str, Any] = field(default_factory=dict)

    # ------------------------------------------------------------------ #

    def validate(self) -> None:
        if not self.model_def:
            raise ValueError("model_def is required (e.g. mnist.mnist_cnn.custom_model)")
        if self.remat_policy and self.remat_policy not in REMAT_POLICY_NAMES:
            # fail at submit time, not after TPUs are allocated and the
            # first train step builds — against the plain name set, NOT by
            # importing training.trainer (which pulls jax/optax/flax into
            # the framework-free client submit path). trainer's
            # resolve_remat_policy does the jax lookup at construction;
            # a test pins the two lists together.
            raise ValueError(
                f"unknown remat policy {self.remat_policy!r}; choose from "
                f"{sorted(REMAT_POLICY_NAMES)} or '' for full remat"
            )
        if self.grad_accum_steps < 1:
            raise ValueError("grad_accum_steps must be >= 1")
        if self.master_restarts < 0:
            raise ValueError("master_restarts must be >= 0")
        if self.journal_group_commit_ms < 0:
            raise ValueError("journal_group_commit_ms must be >= 0 (0 = "
                             "per-commit fsync)")
        if self.journal_group_commit_ms > 10_000:
            # Commit.wait gives a flush 30s before declaring the journal
            # wedged; a window at (or past) that order would fail every
            # journaled RPC before its batch could ever flush. 10s is
            # already far beyond any sane fsync latency it could amortize.
            raise ValueError(
                "journal_group_commit_ms must be <= 10000 (the window is "
                "latency every journaled ack pays; size it near your "
                "fsync latency — see docs/performance.md)"
            )
        if self.task_lease_batch < 1:
            raise ValueError("task_lease_batch must be >= 1")
        if self.embedding_shards < 0:
            raise ValueError("embedding_shards must be >= 0 (0 = tier off)")
        if self.embedding_cache_rows < 0:
            raise ValueError(
                "embedding_cache_rows must be >= 0 (0 = cache off)")
        if self.embedding_cache_staleness < 0:
            raise ValueError(
                "embedding_cache_staleness must be >= 0 (watermark "
                "units: pushes a cached row may lag the owner)")
        if self.embedding_read_replicas < 0:
            raise ValueError(
                "embedding_read_replicas must be >= 0 (0 = no replicas)")
        if self.embedding_pull_pipeline < 0:
            raise ValueError(
                "embedding_pull_pipeline must be >= 0 (0 = blocking "
                "pulls)")
        if (self.embedding_read_replicas > 0
                and self.embedding_shards <= 0):
            raise ValueError(
                "embedding_read_replicas requires the tier "
                "(embedding_shards > 0)")
        if self.embedding_transport not in ("local", "grpc"):
            raise ValueError(
                "embedding_transport must be 'local' or 'grpc' "
                f"(got {self.embedding_transport!r})")
        if (self.embedding_transport == "grpc"
                and self.embedding_shards <= 0):
            raise ValueError(
                "embedding_transport='grpc' requires the tier "
                "(embedding_shards > 0)")
        if self.embedding_rpc_deadline_ms <= 0:
            # a deadline-less data plane blocks forever against a
            # half-dead owner — the exact failure EDL208 polices in code
            raise ValueError(
                "embedding_rpc_deadline_ms must be > 0 (the per-call "
                "deadline budget; there is no 'no deadline' mode)")
        if self.embedding_push_queue < 0:
            raise ValueError(
                "embedding_push_queue must be >= 0 (0 = never queue "
                "behind a partitioned owner)")
        if self.flight_ring < 16:
            # a ring too small to hold even one incident's records would
            # silently produce useless bundles; fail at submit time
            raise ValueError("flight_ring must be >= 16 records")
        if self.timeseries_interval_s <= 0:
            raise ValueError("timeseries_interval_s must be > 0")
        if self.timeseries_samples < 8:
            # a ring shorter than any alert window is a rule engine
            # evaluating over nothing; fail at submit time
            raise ValueError("timeseries_samples must be >= 8")
        if self.straggler_quorum < 2:
            # with 1 reporter the median IS the reporter and scoring is
            # vacuous; 2 works through the min_ratio gate (the satellite
            # unlock for 2-worker fleets)
            raise ValueError("straggler_quorum must be >= 2")
        if self.autoscale:
            if self.autoscale_min_workers < 1:
                raise ValueError("autoscale_min_workers must be >= 1")
            if (self.autoscale_max_workers
                    and self.autoscale_max_workers
                    < self.autoscale_min_workers):
                raise ValueError(
                    "autoscale_max_workers must be 0 (unbounded) or >= "
                    "autoscale_min_workers")
            if self.autoscale_cooldown_s < 0:
                raise ValueError("autoscale_cooldown_s must be >= 0")
            if self.autoscale_hold_s < 0:
                raise ValueError("autoscale_hold_s must be >= 0")
            if self.autoscale_actions_max < 1:
                raise ValueError(
                    "autoscale_actions_max must be >= 1 (use "
                    "--autoscale false to disable the loop)")
            if self.autoscale_rescale_cost_s <= 0:
                raise ValueError(
                    "autoscale_rescale_cost_s must be > 0 (seed it from "
                    "bench.py rescale's time_to_recovery_s)")
            if self.autoscale_horizon_s <= 0:
                raise ValueError("autoscale_horizon_s must be > 0")
            if not 0.0 <= self.autoscale_damping < 1.0:
                raise ValueError(
                    "autoscale_damping must be in [0, 1): it is the EWMA "
                    "smoothing factor (0 = no damping); 1 would freeze "
                    "the smoothed signal forever")
            if self.autoscale_reversal_hold_s < 0:
                raise ValueError(
                    "autoscale_reversal_hold_s must be >= 0 (0 = off)")
            if not self.checkpoint_dir:
                # decisions are journaled and replayed at takeover; a
                # journal-less autoscaler would re-fire after every
                # master restart — the same reason master_restarts
                # requires a checkpoint_dir
                raise ValueError(
                    "autoscale requires checkpoint_dir: decisions are "
                    "journaled under <checkpoint_dir>/control/ and "
                    "replayed at master takeover"
                )
        if self.layout_autoscale:
            if self.layout_max_shards < 0:
                raise ValueError(
                    "layout_max_shards must be >= 0 (0 disables splits)")
            if self.layout_min_shards < 1:
                raise ValueError("layout_min_shards must be >= 1")
            if (self.layout_max_shards
                    and self.layout_max_shards < self.layout_min_shards):
                raise ValueError(
                    "layout_max_shards must be 0 (splits disabled) or >= "
                    "layout_min_shards")
            if self.layout_max_replicas < 0:
                raise ValueError("layout_max_replicas must be >= 0")
            if self.layout_hot_k < 0:
                raise ValueError(
                    "layout_hot_k must be >= 0 (0 disables hot promotion)")
            if self.layout_cooldown_s < 0:
                raise ValueError("layout_cooldown_s must be >= 0")
            if self.layout_hold_s < 0:
                raise ValueError("layout_hold_s must be >= 0")
            if self.layout_actions_max < 1:
                raise ValueError(
                    "layout_actions_max must be >= 1 (use "
                    "--layout_autoscale false to disable the loop)")
            if self.layout_migrate_cost_s <= 0:
                raise ValueError(
                    "layout_migrate_cost_s must be > 0 (seed it from the "
                    "bench embedding_tier reshard recovery_s)")
            if self.layout_horizon_s <= 0:
                raise ValueError("layout_horizon_s must be > 0")
            if not self.checkpoint_dir:
                # same contract as autoscale: decisions are journaled
                # `layout` records replayed at master takeover; without
                # a journal a restarted master would re-fire them
                raise ValueError(
                    "layout_autoscale requires checkpoint_dir: layout "
                    "decisions are journaled under <checkpoint_dir>/"
                    "control/ and replayed at master takeover"
                )
        if self.master_restarts > 0 and not self.checkpoint_dir:
            # a journal-less successor rebuilds the dispatcher from scratch
            # — every already-finished task would be recreated and re-run,
            # silently breaking exactly-once accounting; fail at submit time
            raise ValueError(
                "master_restarts requires checkpoint_dir: master recovery "
                "replays the control-plane journal under "
                "<checkpoint_dir>/control/"
            )
        if self.grad_accum_steps > 1 and (
            self.minibatch_size % self.grad_accum_steps
        ):
            raise ValueError(
                f"grad_accum_steps ({self.grad_accum_steps}) must divide "
                f"minibatch_size ({self.minibatch_size})"
            )
        if self.minibatch_size <= 0:
            raise ValueError("minibatch_size must be positive")
        if self.num_workers <= 0:
            raise ValueError("num_workers must be positive")
        if self.num_processes <= 0:
            raise ValueError("num_processes must be positive")
        if self.instance_manager not in ("", "k8s"):
            raise ValueError(
                f"instance_manager must be '' or 'k8s', got "
                f"{self.instance_manager!r}"
            )
        if self.instance_manager == "k8s" and self.num_processes > 1:
            # the master-managed-pod flavor has no per-pod cohort addressing
            # (coordinator DNS + stable process ids) — without this guard the
            # worker pod's jax.distributed init waits forever for peers that
            # were never created
            raise ValueError(
                "instance_manager='k8s' manages plain worker pods and cannot "
                "form an SPMD cohort; for num_processes>1 use the default "
                "StatefulSet flavor (stable ordinals + headless service)"
            )
        if self.instance_manager == "k8s" and self.tpu_type:
            from elasticdl_tpu_torch.common.constants import TPU_TYPES

            hosts = TPU_TYPES.get(self.tpu_type, (None, None, 1, None))[2]
            if hosts > 1:
                # statically knowable at submit time — failing here beats the
                # master discovering it pod-by-pod minutes later in-cluster
                raise ValueError(
                    f"tpu_type={self.tpu_type} is a {hosts}-host slice (one "
                    "SPMD cohort); instance_manager='k8s' manages plain "
                    "single-host pods — use the default StatefulSet flavor"
                )
        is_training = self.job_type in (
            JobType.TRAINING_ONLY, JobType.TRAINING_WITH_EVALUATION
        )
        if is_training and self.num_workers > 1:
            # N independent worker processes would each hold their own model
            # replica with NO gradient exchange (and only worker 0 would
            # checkpoint) — silently-divergent training. The reference's
            # semantic is one shared model across workers (SURVEY §3.3);
            # here that is the SPMD cohort: one jax.distributed world of
            # `num_processes` processes behind a single logical worker.
            raise ValueError(
                f"num_workers={self.num_workers} with a training job would "
                "train num_workers INDEPENDENT model replicas (gradients are "
                "never exchanged between plain workers). For data-parallel "
                f"training use the SPMD cohort: num_processes="
                f"{self.num_workers} (and num_workers=1). Plain "
                "num_workers>1 is only valid for evaluation_only / "
                "prediction_only jobs, whose tasks are embarrassingly "
                "parallel."
            )

    # --- argv round-trip ------------------------------------------------ #

    _DICT_FIELDS = ("model_params", "data_reader_params", "envs")

    def to_argv(self) -> List[str]:
        """Serialize to a flat argv, skipping fields at their default value."""
        argv: List[str] = []
        defaults = JobConfig()
        for f in fields(self):
            v = getattr(self, f.name)
            if v == getattr(defaults, f.name):
                continue
            flag = "--" + f.name
            if f.name in self._DICT_FIELDS:
                argv += [flag, format_kv_params(v)]
            elif isinstance(v, bool):
                argv += [flag, "true" if v else "false"]
            else:
                argv += [flag, str(v)]
        return argv

    @classmethod
    def from_argv(cls, argv: List[str]) -> "JobConfig":
        parser = cls.build_parser()
        ns, unknown = parser.parse_known_args(argv)
        if unknown:
            raise ValueError(f"Unknown flags: {unknown}")
        return cls.from_namespace(ns)

    @classmethod
    def build_parser(cls, parser: Optional[argparse.ArgumentParser] = None) -> argparse.ArgumentParser:
        parser = parser or argparse.ArgumentParser("elasticdl-tpu")
        defaults = cls()
        for f in fields(cls):
            flag = "--" + f.name
            default = getattr(defaults, f.name)
            if f.name in cls._DICT_FIELDS:
                parser.add_argument(flag, type=str, default=format_kv_params(default))
            elif isinstance(default, bool):
                parser.add_argument(
                    flag, type=lambda s: s.lower() in ("true", "1", "yes"), default=default
                )
            else:
                parser.add_argument(flag, type=type(default), default=default)
        return parser

    @classmethod
    def from_namespace(cls, ns: argparse.Namespace) -> "JobConfig":
        kwargs: Dict[str, Any] = {}
        for f in fields(cls):
            v = getattr(ns, f.name)
            if f.name in cls._DICT_FIELDS and isinstance(v, str):
                v = parse_kv_params(v)
            kwargs[f.name] = v
        cfg = cls(**kwargs)
        return cfg

    def replace(self, **kw: Any) -> "JobConfig":
        return dataclasses.replace(self, **kw)

    def dcn_axes_sizes(self) -> Dict[str, int]:
        """Parse `dcn_mesh_shape` (named form only; {} when unset)."""
        if not self.dcn_mesh_shape:
            return {}
        if "=" not in self.dcn_mesh_shape:
            raise ValueError(
                f"dcn_mesh_shape must use the named form 'data=2', got "
                f"{self.dcn_mesh_shape!r}"
            )
        sizes: Dict[str, int] = {}
        for part in self.dcn_mesh_shape.split(","):
            name, _, size = part.partition("=")
            name = name.strip()
            if not name or not size.strip().isdigit() or int(size) < 1:
                raise ValueError(
                    f"dcn_mesh_shape entry {part!r} is not name=positive-size "
                    f"(got dcn_mesh_shape={self.dcn_mesh_shape!r})"
                )
            if name in sizes:
                raise ValueError(
                    f"dcn_mesh_shape names axis {name!r} twice: "
                    f"{self.dcn_mesh_shape!r}"
                )
            sizes[name] = int(size)
        return sizes

    def mesh_axes_sizes(self, n_devices: int) -> Dict[str, int]:
        """Resolve `mesh_shape` against an actual device count.

        Two forms: positional "4" / "4,2" (data[, model], back-compat) and
        named "data=2,seq=4" / "data=4,model=2" — named supports any axis
        set (data/model/seq/pp/expert) in mesh order, so a job can request
        the sequence-, tensor-, pipeline-, or expert-parallel meshes the
        zoo transformer consumes.
        """
        if not self.mesh_shape:
            return {"data": n_devices}
        if "=" in self.mesh_shape:
            sizes: Dict[str, int] = {}
            for part in self.mesh_shape.split(","):
                name, _, size = part.partition("=")
                name = name.strip()
                if not name or not size.strip().isdigit():
                    raise ValueError(
                        f"mesh_shape entry {part!r} is not name=size "
                        f"(got mesh_shape={self.mesh_shape!r})"
                    )
                if name in sizes:
                    raise ValueError(
                        f"mesh_shape names axis {name!r} twice: {self.mesh_shape!r}"
                    )
                sizes[name] = int(size)
        else:
            parts = [int(p) for p in self.mesh_shape.split(",")]
            if len(parts) == 1:
                sizes = {"data": parts[0]}
            elif len(parts) == 2:
                sizes = {"data": parts[0], "model": parts[1]}
            else:
                raise ValueError(
                    f"positional mesh_shape must have 1 or 2 dims, got "
                    f"{self.mesh_shape!r}; use named form 'data=4,seq=2'"
                )
        total = 1
        for s in sizes.values():
            total *= s
        if total != n_devices:
            raise ValueError(
                f"mesh_shape {self.mesh_shape!r} needs {total} devices, have {n_devices}"
            )
        return sizes
