"""A two-process gloo cohort through the port's Master and ProcessManager,
on the CPU: the twins of `tests/test_cohort.py`.

The port's master runs in this process and its process manager spawns
two `elasticdl_tpu_torch.worker.main` members a job, asked for the CPU
through the manager's environment (`EDL_TORCH_DEVICE=cpu`, so the world
is gloo); the cohort variables a polluted environment can carry are
cleared first, so only the manager sets them. DeepFM
(`field_vocab=64;hidden=16,16`) trains on `synthetic://criteo` in 4
tasks of 4 steps at minibatch 64. The four jobs run at once, each on its
own master and ports, each with a deadline of 90 s:

- `test_cohort_job_end_to_end` (reference 93): 4 tasks finished, none
  failed, both members' world lines, the export present;
- the same with `--steps_per_dispatch 2` (reference 121);
- `test_cohort_member_kill_relaunches_and_resumes` (reference 197, which
  the reference skip-guards on the CPU): SIGKILL to member 1 once the
  first interval checkpoint (every task) is durable; the manager
  relaunches the cohort, which logs "cohort resumed from checkpoint at
  step", and every task finishes;
- `test_cohort_leader_sigterm_drains_via_checkpoint` (reference 223):
  SIGTERM to the leader after the first finished task, with no interval
  checkpoints; the drain's collective save is the only checkpoint, and
  the relaunched cohort resumes at exactly its step.
"""

import glob
import os
import re
import sys
import threading
import time

from elasticdl_tpu_torch.common.config import JobConfig
from elasticdl_tpu_torch.common.net import free_port
from elasticdl_tpu_torch.master.main import Master
from elasticdl_tpu_torch.master.process_manager import ProcessManager
from elasticdl_tpu_torch.training.checkpoint import CheckpointManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TZOO = os.path.join(REPO, "elasticdl_tpu_torch", "model_zoo")
COHORT_ENV = ("EDL_PROCESS_ID", "EDL_NUM_PROCESSES",
              "EDL_PROCESS_ID_FROM_HOSTNAME", "EDL_COORDINATOR_ADDR",
              "EDL_WORLD_VERSION")
DEADLINE_S = 90


def job_config(out, *extra):
    return JobConfig.from_argv([
        "--model_zoo", TZOO, "--model_def", "deepfm.deepfm.custom_model",
        "--model_params", "field_vocab=64;hidden=16,16",
        "--compute_dtype", "float32",
        "--training_data", "synthetic://criteo?n=1024&shards=4",
        "--records_per_task", "256", "--minibatch_size", "64",
        "--num_epochs", "1", "--num_processes", "2",
        "--master_addr", f"localhost:{free_port()}",
        "--worker_heartbeat_s", "1", *extra])


class Job(threading.Thread):
    """One cohort job, driven as the reference's `run_job` drives it
    (planned resizes quiesce through the servicer's checkpoint request);
    `mid_job(master, manager)` returns True once it has acted."""

    def __init__(self, out, cfg, mid_job=None):
        super().__init__(daemon=True)
        self.out, self.cfg, self.mid_job = out, cfg, mid_job
        self.counts, self.error, self.saw_reform = None, None, False
        self.cohort_size, self.reformations = None, None

    def run(self):
        try:
            self._run()
        except BaseException as e:   # re-raised by the test
            self.error = e

    def _run(self):
        master = Master(self.cfg)
        manager = ProcessManager(
            self.cfg, membership=master.membership,
            # one thread a member: eight of them share the host
            extra_env={"EDL_TORCH_DEVICE": "cpu", "PYTHONPATH": REPO,
                       "OMP_NUM_THREADS": "1"},
            log_dir=os.path.join(self.out, "logs"),
            job_finished_fn=master.dispatcher.finished,
            checkpoint_request_fn=lambda: master.servicer.request_checkpoint(0),
            resize_checkpoint_timeout_s=30.0)
        master.start()
        manager.start_workers()
        try:
            deadline = time.time() + DEADLINE_S
            fired = self.mid_job is None
            while not master.dispatcher.finished() and time.time() < deadline:
                master.membership.reap()
                master.dispatcher.poke()
                if not fired:
                    fired = self.mid_job(master, manager)
                time.sleep(0.2)
            self.counts = master.dispatcher.counts()
            self.saw_reform = bool(manager.reformation_log)
            self.cohort_size = manager.cohort_size
            self.reformations = [(o, n) for _, o, n in manager.reformation_log]
            assert master.dispatcher.finished(), (self.counts, self.log()[-3000:])
        finally:
            master.shutdown()
            manager.stop()

    def log(self) -> str:
        return "\n".join(open(f, errors="replace").read() for f in sorted(
            glob.glob(os.path.join(self.out, "logs", "*.log"))))


def signal_member(process_id, how, ready):
    """Kill or terminate a member once `ready(master)` holds."""
    def act(master, manager):
        if not ready(master):
            return False
        wp = manager._procs.get(process_id)
        if wp is None or wp.proc.poll() is not None:
            return False
        getattr(wp.proc, how)()
        return True
    return act


def checkpointed(master):
    """An interval checkpoint is durable: the first lands with the second
    task (its step is due when that task is leased)."""
    return CheckpointManager(
        master.cfg.checkpoint_dir).latest_step() is not None


def a_task_done(master):
    return master.dispatcher.counts()["finished_training"] >= 1


def check_end_to_end(job):
    assert job.counts["finished_training"] == 4, job.counts
    assert job.counts["failed_permanently"] == 0, job.counts
    log = job.log()
    assert "distributed world v0 up: process 0/2" in log, log[-3000:]
    assert "distributed world v0 up: process 1/2" in log, log[-3000:]
    assert "(backend gloo, device cpu)" in log
    assert os.path.exists(os.path.join(job.out, "export", "params.pt"))


def check_kill_relaunches_and_resumes(job):
    assert job.counts["finished_training"] == 4, job.counts
    assert job.counts["failed_permanently"] == 0, job.counts
    assert job.saw_reform
    log = job.log()
    assert "distributed world v1 up: process 1/2" in log, log[-3000:]
    assert "cohort resumed from checkpoint at step" in log, log[-3000:]


def check_sigterm_drains(job):
    assert job.counts["finished_training"] == 4, job.counts
    assert job.counts["failed_permanently"] == 0, job.counts
    log = job.log()
    assert "leader preempted: draining cohort via collective checkpoint" in log
    saved = re.search(r"preemption checkpoint saved at step (\d+)", log)
    resumed = re.search(r"cohort resumed from checkpoint at step (\d+)", log)
    assert saved and resumed, log[-3000:]
    # the restored step IS the pre-kill step: nothing trained was redone
    assert resumed.group(1) == saved.group(1), (saved.group(), resumed.group())


def test_cohort_jobs_against_the_reference_twins(tmp_path, monkeypatch):
    """Every case above, in one collected test (ROADMAP.md, conventions:
    one collected test per port test file), the jobs at once."""
    for k in COHORT_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.syspath_prepend(TZOO)
    cases = []
    for name, extra, mid_job, check in (
        ("e2e", ["--output", "{out}/export"], None, check_end_to_end),
        ("grouped", ["--output", "{out}/export", "--steps_per_dispatch",
                     "2"], None, check_end_to_end),
        ("kill", ["--checkpoint_dir", "{out}/ckpt", "--checkpoint_steps",
                  "4"], signal_member(1, "kill", checkpointed),
         check_kill_relaunches_and_resumes),
        ("sigterm", ["--checkpoint_dir", "{out}/ckpt", "--checkpoint_steps",
                     "0"], signal_member(0, "terminate", a_task_done),
         check_sigterm_drains),
    ):
        out = str(tmp_path / name)
        cfg = job_config(out, *(a.format(out=out) for a in extra))
        cases.append((Job(out, cfg, mid_job), check))
    modules = {k: sys.modules.pop(k) for k in list(sys.modules)
               if k == "deepfm" or k.startswith("deepfm.")}
    try:
        for job, _ in cases:
            job.start()
        for job, _ in cases:
            job.join(DEADLINE_S + 60)
    finally:
        for k in [k for k in sys.modules
                  if k == "deepfm" or k.startswith("deepfm.")]:
            del sys.modules[k]
        sys.modules.update(modules)
    for job, check in cases:
        assert not job.is_alive()
        if job.error is not None:
            raise job.error
        check(job)
