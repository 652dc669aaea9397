"""Master entrypoint: task service + membership + evaluation over gRPC.

Counterpart of `elasticdl_tpu/master/main.py`, whose text it keeps: parse
args, create data shards and the task dispatcher, start the gRPC servicer
and services, run to job end. The services it wires (dispatcher, journal,
membership, evaluation, health, time series, alerts, goodput) are the
port's copies of the reference's, and the model module it loads for
metric finalization is the port's zoo. The branches a local DeepFM job
does not take, and whose modules the port has not taken over, raise
`NotImplementedError` naming their ROADMAP item: the closed-loop
autoscaler (`--autoscale`, item 18), the embedding tier's shard map and
layout controller (`--embedding_shards`, item 20), zoo `callbacks()`
(item 28) and the Kubernetes instance manager (`--instance_manager k8s`,
item 25).
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Optional

from elasticdl_tpu_torch.common import faults
from elasticdl_tpu_torch.common.config import JobConfig
from elasticdl_tpu_torch.common.constants import JobType
from elasticdl_tpu_torch.common.log_utils import default_logger
from elasticdl_tpu_torch.data.reader import create_data_reader
from elasticdl_tpu_torch.master.evaluation_service import EvaluationService
from elasticdl_tpu_torch.master.journal import ControlPlaneJournal
from elasticdl_tpu_torch.master.membership import Membership
from elasticdl_tpu_torch.master.poll_phases import poll_phase
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.proto.service import add_master_servicer, make_server

logger = default_logger(__name__)


def check_supported(cfg: JobConfig) -> None:
    """Raise for the master options whose modules the port has not taken
    over yet, before anything binds or opens."""
    if cfg.autoscale:
        raise NotImplementedError(
            "--autoscale (the closed-loop autoscaler) comes with the "
            "elastic cohort, ROADMAP item 18")
    if cfg.embedding_shards > 0:
        raise NotImplementedError(
            "--embedding_shards (the embedding tier's shard map and layout "
            "controller) is ROADMAP item 20 (slice 5)")
    if cfg.instance_manager == "k8s":
        raise NotImplementedError(
            "--instance_manager k8s (master-owned worker pods) is ROADMAP "
            "item 25")


class Master:
    def __init__(self, cfg: JobConfig):
        cfg.validate()
        check_supported(cfg)
        self.cfg = cfg
        # observability first: every span/log below carries the role, and
        # trace.jsonl lands under <trace_dir|summary_dir/trace>/master/
        from elasticdl_tpu_torch.observability import flight as flight_lib
        from elasticdl_tpu_torch.observability import tracing

        tracing.configure_from_config(cfg, role="master")
        # flight recorder (observability/flight.py): the master's black
        # box — dumps on crash/SIGUSR2//debug/flight and on straggler
        # onset (the health hook below)
        flight_lib.configure_from_config(cfg, role="master")
        flight_lib.install_crash_hooks()
        self.metrics_server = None

        # Bind the serving port BEFORE the journal opens: every journal
        # open replays + rotates + bumps the generation, so a lost bind
        # (the crashed predecessor's port lingering for a beat — exactly
        # what _rebuild_master retries through) must fail before any
        # generation is committed, or each retry inflates it past the real
        # restart count. add_insecure_port is legal before handlers are
        # registered; PortBindError (a RuntimeError) lets launchers that
        # picked the port via free_port() retry with a fresh one
        # (net.bind_with_retry). Depending on grpc version, a lost bind
        # returns 0 or raises.
        self.summary = None
        self.journal: Optional[ControlPlaneJournal] = None
        self.server = make_server()
        port = int(cfg.master_addr.rsplit(":", 1)[1])
        from elasticdl_tpu_torch.common.net import PortBindError

        try:
            bound = self.server.add_insecure_port(f"[::]:{port}")
        except RuntimeError as e:
            self._release_on_bind_failure()
            raise PortBindError(f"could not bind master port {port}: {e}") from e
        if bound == 0:
            self._release_on_bind_failure()
            raise PortBindError(f"could not bind master port {port}")

        def shards_for(path: str):
            if not path:
                return []
            reader = create_data_reader(
                path, cfg.data_reader, **cfg.data_reader_params
            )
            return reader.create_shards()

        train_shards = (
            shards_for(cfg.training_data)
            if cfg.job_type
            in (JobType.TRAINING_ONLY, JobType.TRAINING_WITH_EVALUATION)
            else []
        )
        eval_shards = shards_for(cfg.validation_data)
        predict_shards = (
            shards_for(cfg.prediction_data)
            if cfg.job_type == JobType.PREDICTION_ONLY
            else []
        )

        # Control-plane durability (master/journal.py): with a checkpoint
        # dir, task/membership state transitions are journaled and a master
        # restart replays them — a crash becomes a recoverable event instead
        # of a job-killing one. Opening the journal FIRST (before dispatcher
        # and membership) means their constructors see the replayed state.
        self.journal = (
            ControlPlaneJournal(
                cfg.checkpoint_dir, fsync=cfg.journal_fsync,
                group_commit_ms=cfg.journal_group_commit_ms,
            )
            if cfg.checkpoint_dir else None
        )
        if self.journal is not None and self.journal.recovered:
            tracing.event(
                "master.recovered", generation=self.journal.generation,
            )
            # A dead master's announced resize plan must not outlive it:
            # clear the membership signal's pending world size + reform
            # trace id (workers' speculative compilers would otherwise keep
            # precompiling against the dead plan) and stamp our generation.
            from elasticdl_tpu_torch.common import membership_signal

            signal_path = membership_signal.default_path(cfg.checkpoint_dir)
            if signal_path:
                membership_signal.clear_stale_on_takeover(
                    signal_path, master_generation=self.journal.generation
                )
        self.dispatcher = TaskDispatcher(
            training_shards=train_shards,
            evaluation_shards=eval_shards,
            prediction_shards=predict_shards,
            records_per_task=cfg.records_per_task,
            num_epochs=cfg.num_epochs,
            max_task_retries=cfg.max_task_retries,
            shuffle=cfg.shuffle,
            shuffle_seed=cfg.shuffle_seed,
            task_timeout_s=cfg.task_timeout_s,
            # end-of-job durability: one exclusive SAVE_MODEL task before
            # job-end whenever training checkpoints somewhere (SURVEY §2.1)
            final_save_model=bool(cfg.checkpoint_dir) and bool(train_shards),
            journal=self.journal,
        )
        self.membership = Membership(
            heartbeat_timeout_s=3 * cfg.worker_heartbeat_s,
            journal=self.journal,
        )
        self.membership.add_death_callback(self.dispatcher.recover_tasks)
        # Cluster health intelligence (observability/health.py): scores the
        # heartbeat-piggybacked worker telemetry for stragglers every wait
        # poll, exports the edl_cluster_* rollup (served by this process's
        # /metrics), and feeds the enriched /healthz. The hook is log-only
        # — the seam where elasticity decisions will plug in.
        from elasticdl_tpu_torch.observability.health import ClusterHealth

        # --straggler_quorum (floor 2, validated at boot): a 2-worker
        # fleet can flag its straggler through the min_ratio gate; the
        # old hard-coded 3 stays the default
        self.health = ClusterHealth(
            self.membership, min_workers=cfg.straggler_quorum,
        )
        # the straggler hook's consumer here: onset cuts the
        # MASTER's black box (fleet view, journal state, recent control-
        # plane events at the moment the fleet went ragged). The OFFENDER
        # side is launcher-wired (client/local.py SIGUSR2s the worker
        # process — only the launcher knows pids).
        self.health.add_hook(self._straggler_flight_hook)
        # Observe->decide backbone (observability/timeseries.py
        # + alerts.py): the master's time-series ring additionally
        # accumulates FLEET series computed from the heartbeat stats
        # payloads it already receives (_fleet_series), and the alert
        # engine evaluates its declarative rules against that history on
        # every wait poll.
        from elasticdl_tpu_torch.observability import alerts as alerts_lib
        from elasticdl_tpu_torch.observability import timeseries as timeseries_lib

        self.timeseries = timeseries_lib.configure_from_config(
            cfg, role="master")
        base_dir = cfg.summary_dir or cfg.checkpoint_dir
        self.alerts = alerts_lib.AlertEngine(
            self.timeseries,
            rules=alerts_lib.rules_from_config(cfg),
            json_path=(os.path.join(base_dir, "control", "alerts.json")
                       if base_dir else None),
        )
        # Fleet goodput ledger (observability/goodput.py): the
        # rollup over heartbeat ledger payloads + the dispatcher's
        # journal-durable wasted-work bill — recomputed every wait poll,
        # exported as edl_goodput_* gauges, sampled into the time series
        # (the goodput_burn / wasted_work_ratio default rules' input),
        # served at /goodput and inside /healthz.
        from elasticdl_tpu_torch.observability.goodput import FleetGoodput

        self.goodput = FleetGoodput(self.membership, self.dispatcher)

        # Fleet tail attribution (observability/reqtrace.py):
        # the rollup over heartbeat rt_* diary payloads — names the
        # fleet-dominant slow-request stage and pulses when it shifts
        # (the emb_attr_dominant_shift default rule's input).
        from elasticdl_tpu_torch.observability.reqtrace import FleetAttribution

        self.attribution = FleetAttribution()

        metrics = None
        callbacks = []
        if eval_shards or cfg.model_def:
            # the master loads the model module too — it owns metric
            # finalization and job-level callbacks (reference: the master's
            # evaluation service + the zoo callbacks() contract)
            from elasticdl_tpu_torch.common.model_utils import get_module_attr, load_module

            module, _ = load_module(cfg.model_zoo, cfg.model_def)
            metrics_fn = get_module_attr(
                module, "eval_metrics_fn", cfg.eval_metrics_fn, required=False
            )
            metrics = dict(metrics_fn()) if metrics_fn else {}
            callbacks_fn = get_module_attr(module, "callbacks", "", required=False)
            callbacks = list(callbacks_fn()) if callbacks_fn else []
        self.evaluation: Optional[EvaluationService] = (
            EvaluationService(
                self.dispatcher,
                metrics,
                evaluation_steps=cfg.evaluation_steps,
                start_delay_steps=cfg.evaluation_start_delay_steps,
            )
            if eval_shards
            else None
        )
        if cfg.summary_dir:
            from elasticdl_tpu_torch.master.summary_service import SummaryService

            self.summary = SummaryService(cfg.summary_dir)
            if self.evaluation is not None:
                self.evaluation.add_result_callback(self.summary.on_eval_results)
        self.servicer = MasterServicer(
            self.dispatcher, self.membership, self.evaluation,
            summary_service=self.summary,
            # journaled masters fence RPCs from before their last restart
            # (0 = fencing off for volatile masters; proto/service.py)
            generation=self.journal.generation if self.journal else 0,
        )
        self.callbacks = callbacks
        if callbacks:
            self._release_on_bind_failure()
            raise NotImplementedError(
                "zoo callbacks() (api/callbacks.JobContext) are ROADMAP "
                "item 28")
        # a completed eviction (or any death) prunes the sticky drain-
        # handshake bit — a revived worker id must not inherit it
        self.membership.add_death_callback(self.servicer.clear_evict)
        add_master_servicer(self.server, self.servicer)

    def _release_on_bind_failure(self) -> None:
        """A lost bind abandons this instance (bind_with_retry constructs a
        fresh Master per attempt): release what __init__ already built, or
        every failed attempt keeps its summary file handles and gRPC thread
        pool alive for the rest of the job."""
        try:
            self.server.stop(None)
        except Exception:
            logger.exception("abandoned master: server stop failed")
        if self.summary is not None:
            try:
                self.summary.close()
            except Exception:
                logger.exception("abandoned master: summary close failed")
        if self.journal is not None:
            # two live journal handles would interleave writers on the
            # same file; the retry's next Master must be the sole owner
            try:
                self.journal.close()
            except Exception:
                logger.exception("abandoned master: journal close failed")

    def start(self) -> None:
        self.server.start()
        logger.info("master serving on %s", self.cfg.master_addr)
        # /metrics + /healthz (best-effort; never a boot failure; a set
        # EDL_METRICS_PORT overrides cfg.metrics_port either way)
        from elasticdl_tpu_torch.observability.http import start_server

        self.metrics_server = start_server(
            role="master", port=self.cfg.metrics_port,
            health_fn=self._healthz_extra,
            timeseries=self.timeseries, alerts=self.alerts,
            goodput_fn=self.goodput.snapshot,
        )
        if self.evaluation is not None and self.cfg.job_type == JobType.EVALUATION_ONLY:
            self.evaluation.trigger(0)

    def _straggler_flight_hook(self, info: dict) -> None:
        """Straggler onset -> snapshot the master's flight ring. Hook
        exceptions are swallowed by ClusterHealth, and dump() never
        raises, so this can only ever cost a file write."""
        from elasticdl_tpu_torch.observability import flight as flight_lib

        flight_lib.get_recorder().dump(
            f"straggler:worker-{info.get('worker_id')}"
        )

    def _healthz_extra(self) -> dict:
        """What the master's /healthz adds over the per-process base:
        which master (generation), which worker set (membership version +
        alive count), the latest cluster-health rollup (whose
        `snapshot_age_s` is stamped at serve time, so a scraper can tell
        a live rollup from one frozen at a wedge), and the active alert
        set. Reads only cached/cheap state — a scrape never triggers a
        recompute."""
        return {
            "generation": self.journal.generation if self.journal else 0,
            "membership_version": self.membership.version,
            "alive_workers": self.membership.alive_count(),
            "cluster": self.health.snapshot(),
            "alerts_active": self.alerts.active(),
            # the fleet goodput/wasted-work picture rides health
            # snapshots too, so chaos artifacts (and the incident CLI
            # reading them) carry the incident's bill
            "goodput": self.goodput.snapshot(),
        }

    def _fleet_series(self) -> dict:
        """The master's extra sampler input: fleet aggregates computed
        from the heartbeat stats records Membership already holds, plus
        control-plane load shape (backlog per worker). Runs only when a
        time-series sample is actually due."""
        from elasticdl_tpu_torch.observability.timeseries import fleet_series

        counts = self.dispatcher.counts()
        snap = self.health.snapshot()
        series = fleet_series(
            self.membership.health_snapshot(),
            straggler_count=snap.get("straggler_count", 0),
            todo_tasks=counts.get("todo", 0),
            alive_workers=self.membership.alive_count(),
        )
        # goodput series join the same sample: the fraction + wasted
        # ratio the default alert rules window over
        series.update(self.goodput.series())
        # tail-attribution series (dominant stage + shift pulse) join
        # too — emb_attr_dominant_shift reads the pulse from this store
        series.update(self.attribution.series(
            self.membership.health_snapshot()))
        return series

    def wait(
        self,
        poll_s: float = 1.0,
        timeout_s: Optional[float] = None,
        abort_fn=None,
    ) -> bool:
        """Block until all tasks are done. Returns True on completion.
        `abort_fn() -> bool` aborts the wait (e.g. every worker failed
        permanently — without it a dead job would block forever)."""
        deadline = time.time() + timeout_s if timeout_s else None
        while not self.dispatcher.finished():
            # chaos hook (common/faults.py): `crash` here is the real
            # kill-the-master shape for separate-process masters (os._exit,
            # nothing downstream runs); `drop` raises FaultInjected out of
            # wait() — the catchable in-process flavor client/local.py's
            # --master_restarts recovery path consumes
            faults.fire("master_crash")
            # every phase is timed into edl_master_poll_phase_seconds
            # (master/poll_phases.py) so a slow poll at fleet scale
            # names its culprit instead of being one opaque number
            with poll_phase("membership"):
                self.membership.reap()
            with poll_phase("dispatcher"):
                self.dispatcher.poke()
            # fleet rollup + straggler scoring (never raises; gauges and
            # edge-triggered cluster.straggler events update here)
            with poll_phase("health"):
                self.health.update()
            # fleet goodput rollup (never raises): heartbeat ledger
            # payloads + the dispatcher's wasted-work bill -> the
            # edl_goodput_* gauges the sampler below snapshots
            with poll_phase("goodput"):
                self.goodput.update()
            # time-series sample when due (fleet series computed only
            # then) + declarative alert evaluation over the history —
            # edge-triggered cluster.alert events, edl_alert_* metrics,
            # flight-ring dump on page severity. Neither ever raises.
            with poll_phase("timeseries"):
                self.timeseries.maybe_sample(extra_fn=self._fleet_series)
            with poll_phase("alerts"):
                self.alerts.evaluate()
            if self.summary is not None:
                # control-plane metrics ride the summary stream (rate-
                # limited inside; never raises)
                self.summary.maybe_snapshot_registry(
                    self.dispatcher.completed_versions
                )
            if deadline and time.time() > deadline:
                return False
            if abort_fn is not None and abort_fn():
                logger.error("job aborted: no workers left to make progress")
                return False
            time.sleep(poll_s)
        return True

    def crash(self) -> None:
        """Simulated hard master death (the `master_crash` fault site /
        --master_restarts chaos path, for in-process masters that cannot
        os._exit). Tears the serving surface down ABRUPTLY: in-flight RPCs
        are cancelled, no shutdown flag reaches workers, no final summary or
        trace flush happens. The journal is closed without ceremony — every
        commit was already fsynced at append time, so this loses exactly
        what a SIGKILL would: nothing that was acknowledged. The successor
        master replays the journal and takes over under generation+1."""
        try:
            # wait for termination so the listener sockets are truly closed
            # — the successor binds the SAME port and must not race a
            # half-dead listener (see make_server's so_reuseport note)
            self.server.stop(None).wait(timeout=5.0)
        except Exception:
            logger.exception("crashed master: server stop failed")
        if self.metrics_server is not None:
            try:
                self.metrics_server.stop()
            except Exception:
                logger.debug("crashed master: metrics stop failed", exc_info=True)
            self.metrics_server = None
        if self.journal is not None:
            # abort, not close: queued group commits whose acks were never
            # released are dropped, exactly as SIGKILL would drop them
            self.journal.abort()
        # the black box survives the simulated kill (a real SIGKILL is
        # covered by the fault injector's pre-crash hook instead)
        from elasticdl_tpu_torch.observability import flight as flight_lib

        flight_lib.get_recorder().dump("master_crash")
        logger.warning("master CRASHED (simulated): serving stopped abruptly")

    def shutdown(self, grace_s: float = 5.0) -> None:
        self.servicer.request_shutdown()
        counts = self.dispatcher.counts()
        mean_loss = self.servicer.mean_training_loss()
        results = self.evaluation.latest_results() if self.evaluation else {}
        logger.info(
            "job finished: %s mean_loss=%s eval=%s",
            counts, f"{mean_loss:.4f}" if mean_loss is not None else "n/a", results,
        )
        # give workers a heartbeat cycle to see the shutdown flag
        time.sleep(min(grace_s, self.cfg.worker_heartbeat_s))
        self.server.stop(grace_s)
        # only after the server stops: late reports may still hit the
        # summary writer while RPCs are in flight
        if self.summary is not None:
            try:
                # one final registry snapshot so the job-end metric state
                # is in events.jsonl, then close durably
                self.summary.snapshot_registry(
                    self.dispatcher.completed_versions
                )
            except Exception:
                logger.exception("final registry snapshot failed")
            self.summary.close()
        if self.metrics_server is not None:
            self.metrics_server.stop()
            self.metrics_server = None
        # terminal observe->decide state: one last fleet sample into the
        # rolling history + the alert engine's final alerts.json, so the
        # job's artifacts carry the end-of-run picture
        try:
            self.timeseries.sample(extra=self._fleet_series())
            self.alerts.write_json()
        except Exception:
            logger.exception("final timeseries/alerts persistence failed")
        if self.journal is not None:
            if self.dispatcher.finished():
                # clean completion: a journal left behind would make the
                # next submission reusing this checkpoint_dir replay
                # job_end/training_done and come up born-finished
                self.journal.discard()
            else:
                # aborted/timed-out shutdown: keep the journal — a resume
                # against the same checkpoint_dir recovers from it
                self.journal.close()
        from elasticdl_tpu_torch.observability import tracing

        tracing.get_tracer().close()

    def run(self) -> int:
        self.start()
        ok = self.wait()
        self.shutdown()
        return 0 if ok else 1


def main(argv: Optional[List[str]] = None) -> int:
    cfg = JobConfig.from_argv(sys.argv[1:] if argv is None else argv)
    return Master(cfg).run()


if __name__ == "__main__":
    raise SystemExit(main())
