"""Local job launcher: master + worker processes on this host.

Counterpart of `elasticdl_tpu/client/local.py` (`run_local`): the port's
Master runs in-process and its ProcessManager spawns
`elasticdl_tpu_torch.worker.main` subprocesses, which train on the card
(a worker's device can be named through `extra_env`, e.g.
`{"EDL_TORCH_DEVICE": "cpu"}`). The closed-loop autoscaler's action
surface is not wired: the port's Master refuses `--autoscale` (ROADMAP
item 18).

Master crash-restart chaos (`--master_restarts`): when the
`master_crash` fault site fires its catchable `drop` flavor inside
Master.wait, this launcher crashes the master ABRUPTLY (no shutdown
handshake reaches the workers), rebuilds it on the same port, and rebinds
the process manager to the successor. The new master replays the
control-plane journal (master/journal.py), takes over under generation+1,
and the still-running workers reconnect through the generation handshake —
no worker process restarts, no lost task accounting.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from elasticdl_tpu_torch.common import faults
from elasticdl_tpu_torch.common.config import JobConfig
from elasticdl_tpu_torch.common.log_utils import default_logger
from elasticdl_tpu_torch.master.main import Master
from elasticdl_tpu_torch.master.process_manager import ProcessManager

logger = default_logger(__name__)


from elasticdl_tpu_torch.common.net import PortBindError, bind_with_retry, free_port  # noqa: F401  (re-export)


def _rebuild_master(cfg: JobConfig, attempts: int = 20) -> Master:
    """Construct the successor master on the SAME address the workers hold.
    The crashed server's port can linger for a beat after grpc stop, so a
    lost bind is retried briefly rather than failing the recovery."""
    last: Optional[Exception] = None
    for _ in range(attempts):
        try:
            return Master(cfg)
        except PortBindError as e:
            last = e
            # ONE local launcher waiting for its own crashed server's port
            # to free — no fleet to desynchronize: edl-lint: disable=EDL304
            time.sleep(0.25)
    raise RuntimeError(
        f"master restart could not rebind {cfg.master_addr}: {last}"
    )


def run_local(
    cfg: JobConfig,
    extra_env: Optional[Dict[str, str]] = None,
    log_dir: Optional[str] = None,
    timeout_s: Optional[float] = None,
) -> int:
    """Run a whole job on this host: in-process master, subprocess workers."""
    if cfg.master_addr.endswith(":0"):
        # bind_with_retry closes free_port()'s TOCTOU window: Master binds
        # its port during construction and raises PortBindError when the
        # pick was lost to a concurrent bind — retry with a fresh port
        # instead of failing the whole job submission
        def build(port: int) -> Master:
            return Master(cfg.replace(master_addr=f"localhost:{port}"))

        port, master = bind_with_retry(build)
        cfg = cfg.replace(master_addr=f"localhost:{port}")
    else:
        master = Master(cfg)
    manager = ProcessManager(
        cfg,
        membership=master.membership,
        extra_env=extra_env,
        log_dir=log_dir,
        job_finished_fn=master.dispatcher.finished,
        # planned resizes quiesce through the heartbeat should_checkpoint bit
        checkpoint_request_fn=lambda: master.servicer.request_checkpoint(0),
        journal=master.journal,
    )
    # Straggler-onset OFFENDER snapshot (the master's own hook already
    # dumps the MASTER's flight ring): only this launcher knows worker
    # pids, so the SIGUSR2 trigger that cuts the offender's black box is
    # wired here. Cohort member names carry their process index
    # (`...#p<i>`), so the signal lands on the one slow process.
    def _offender_flight_hook(info: dict) -> None:
        name = str(info.get("worker_name", ""))
        process_index = None
        if "#p" in name:
            try:
                process_index = int(name.rsplit("#p", 1)[1])
            except ValueError:
                process_index = None
        worker_id = int(info.get("worker_id", -1))
        if process_index is not None:
            # a cohort member: the proc table is keyed by process index
            # under the leader's logical worker
            manager.request_flight_dump(0, process_index=process_index)
        elif worker_id >= 0:
            manager.request_flight_dump(worker_id)

    master.health.add_hook(_offender_flight_hook)
    master.start()
    manager.start_workers()
    deadline = time.time() + timeout_s if timeout_s else None
    restarts_left = cfg.master_restarts
    try:
        while True:
            remaining = deadline - time.time() if deadline else None
            try:
                ok = master.wait(timeout_s=remaining, abort_fn=manager.all_failed)
                break
            except faults.FaultInjected as e:
                if e.site != "master_crash" or restarts_left <= 0:
                    raise
                restarts_left -= 1
                logger.warning(
                    "master crash injected (%s); restarting in place "
                    "(%d restart(s) left)", e, restarts_left,
                )
                master.crash()
                master = _rebuild_master(cfg)
                # the successor's health scorer needs the launcher hook
                # re-wired (Master.__init__ only adds its own master-side
                # dump hook)
                master.health.add_hook(_offender_flight_hook)
                manager.rebind_master(
                    master.membership,
                    master.dispatcher.finished,
                    lambda m=master: m.servicer.request_checkpoint(0),
                    journal=master.journal,
                )
                master.start()
    finally:
        # final fleet rollup before teardown (ClusterHealth.update never
        # raises): a local run surfaces "was any worker dragging" without
        # anyone having scraped /metrics during the job
        rollup = master.health.update()
        if rollup.get("workers_reporting"):
            logger.info(
                "final cluster health: %d/%d worker(s) reporting, "
                "step-time skew %.2f, %d straggler(s)",
                rollup["workers_reporting"], rollup.get("workers_alive", 0),
                rollup.get("skew", 1.0), rollup["straggler_count"],
            )
        master.shutdown()
        manager.stop()
    return 0 if ok else 1
