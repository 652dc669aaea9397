"""Deliberate resizing of a gloo cohort through the port's Master and
ProcessManager, on the CPU: the twins of the reference's skip-guarded
resize tests (`tests/test_cohort.py:363, 427, 460`), and the closed-loop
autoscaler's shrink of a cohort.

The harness is `tests/test_torch_cohort_job.py`'s `Job` (DeepFM
`field_vocab=64;hidden=16,16` on `synthetic://criteo`, minibatch 64,
members asked for the CPU, one thread a member) at the reference's
sizes (tasks of 1024 records, 16 steps), with
the reference's `run_job` wiring: the manager's planned resizes quiesce
through the master's heartbeat `should_checkpoint` bit. The jobs run at
once, each on its own master and ports, each with a deadline of 90 s:

- `test_cohort_resizes_down_at_exhausted_budget` (reference 363): with
  `--relaunch_max 0`, member 1 is SIGKILLed once 2 tasks have finished;
  the cohort re-forms at 1 (`reformation_log` [(2, 1)]), logs "up:
  process 0/1" and the resume line, and all 8 tasks finish once;
- `test_cohort_scales_up_on_add_worker` (reference 427): `add_worker()`
  after 2 tasks returns 3; the world re-forms at 3 ([(2, 3)], "up:
  process 2/3") and all 24 tasks finish once;
- `test_cohort_remove_worker_quiesces_then_resizes` (reference 460):
  `remove_worker()` after 2 tasks returns 1, with interval checkpoints
  off, so the quiesce's collective checkpoint is the only one before
  the final SAVE_MODEL's; the cohort re-forms at 1 and resumes at
  exactly its step;
- the autoscaler's shrink (the reference's `ProcessManagerTarget` over
  a cohort, `elasticdl_tpu/master/autoscaler.py:209-228`): the job
  through the CLI in a process of its own (`client/local.py` binds the
  target; the time series ring is per process, so the policy sees this
  job's samples alone), `--autoscale` with the reference's
  `fleet_data_wait_dominant` rule (value mode, threshold 0.001 of a step
  blocked on input, which every CPU step crosses) and a rescale cost of
  1 s: one `shrink` applied and journaled, the cohort re-formed 2 -> 1
  through the quiesce, and every task finished once.

Every case also asserts the port's resize log line ("cohort world
resized 2 -> N processes; global batch and LR unchanged") and that no
task failed.
"""

import json
import os
import re
import subprocess
import sys

from tests.test_torch_cohort_job import (
    COHORT_ENV, DEADLINE_S, REPO, Job, job_config)

from elasticdl_tpu_torch.master.journal import replay_lines
from elasticdl_tpu_torch.training.checkpoint import CheckpointManager


def after_two_tasks(act):
    def mid_job(master, manager):
        if master.dispatcher.counts()["finished_training"] < 2:
            return False
        return act(manager)
    return mid_job


def kill_follower(manager):
    wp = manager._procs.get(1)
    if wp is None or wp.proc.poll() is not None:
        return False
    wp.proc.kill()
    return True


def scale_up(manager):
    assert manager.add_worker() == 3
    return True


def scale_down(manager):
    assert manager.remove_worker() == 1
    return True


def check_log(log, size):
    assert f"up: process {size - 1}/{size}" in log, log[-3000:]
    assert (f"cohort world resized 2 -> {size} processes; global batch and "
            "LR unchanged") in log, log[-3000:]


def check_resized(job, tasks, size, reformations):
    assert job.counts["finished_training"] == tasks, job.counts
    assert job.counts["failed_permanently"] == 0, job.counts
    assert job.cohort_size == size, job.cohort_size
    assert job.reformations == reformations, job.reformations
    log = job.log()
    check_log(log, size)
    return log


def check_down(job):
    log = check_resized(job, 8, 1, [(2, 1)])
    assert "cohort resumed from checkpoint at step" in log, log[-3000:]


def check_up(job):
    check_resized(job, 24, 3, [(2, 3)])


def check_quiesce(job):
    log = check_resized(job, 24, 1, [(2, 1)])
    # the quiesce checkpoint was written before teardown and restored
    # after: with interval checkpoints off it is the first on disk (the
    # job's final SAVE_MODEL writes the other)
    saved = CheckpointManager(job.cfg.checkpoint_dir).all_steps()
    resumed = re.findall(r"cohort resumed from checkpoint at step (\d+)", log)
    assert len(saved) == 2 and resumed == [str(saved[0])], (
        saved, resumed, log[-3000:])


class Cli:
    """The job through `python -m elasticdl_tpu_torch.client.main train`
    in a process of its own, its members asked for the CPU."""

    def __init__(self, out, argv):
        self.out, self.argv, self.error = out, argv, None

    def start(self):
        os.makedirs(self.out)
        env = {k: v for k, v in os.environ.items() if k not in COHORT_ENV}
        env.update(EDL_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       p for p in (REPO, env.get("PYTHONPATH")) if p))
        self.log_file = open(os.path.join(self.out, "cli.log"), "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "elasticdl_tpu_torch.client.main",
             "train", *self.argv], cwd=REPO, env=env, stdout=self.log_file,
            stderr=subprocess.STDOUT)

    def join(self, timeout):
        try:
            self.proc.wait(timeout)
        except subprocess.TimeoutExpired:   # the check reports the exit
            self.proc.kill()
            self.proc.wait()
        self.log_file.close()

    def is_alive(self):
        return self.proc.poll() is None

    def log(self):
        with open(os.path.join(self.out, "cli.log"), errors="replace") as f:
            return f.read()


def check_autoscale(cli):
    log = cli.log()
    assert cli.proc.returncode == 0, log[-3000:]
    check_log(log, 1)
    assert "cohort RESIZED 2 -> 1 processes" in log, log[-3000:]
    assert "AUTOSCALE shrink applied: world 2 -> 1" in log, log[-3000:]
    path = os.path.join(cli.out, "ckpt", "control", "journal.jsonl.completed")
    with open(path, encoding="utf-8") as f:
        lines = f.readlines()
    records = [json.loads(line) for line in lines]
    applied = [r for r in records if r.get("t") == "autoscale"
               and r.get("decision") == "applied"]
    assert [r["kind"] for r in applied] == ["shrink"], applied
    state = replay_lines(lines)
    assert state.autoscale.by_kind == {"shrink": 1}, state.autoscale
    assert state.dispatcher.finished_training == 24
    assert state.dispatcher.failed_permanently == 0


def test_cohort_resizes_against_the_reference_twins(tmp_path, monkeypatch):
    """Every case above, in one collected test (ROADMAP.md, conventions:
    one collected test per port test file), the jobs at once."""
    for k in COHORT_ENV:
        monkeypatch.delenv(k, raising=False)
    from tests.test_torch_cohort_job import TZOO

    monkeypatch.syspath_prepend(TZOO)
    rules = tmp_path / "rules.json"
    rules.write_text(json.dumps([{
        "name": "fleet_data_wait_dominant",
        "series": "edl_fleet_data_wait_frac", "threshold": 0.001,
        "mode": "value", "window_s": 5.0}]))
    cases = []
    # the reference's sizes: tasks of 1024 records (16 steps), 8 tasks
    # for the kill and 24 for the planned resizes, long enough that the
    # quiesce and the re-formation land mid-job
    for name, data, extra, mid_job, check in (
        ("down", "n=8192&shards=8", ["--checkpoint_steps", "8",
                                     "--relaunch_max", "0"],
         after_two_tasks(kill_follower), check_down),
        ("up", "n=24576&shards=24", ["--checkpoint_steps", "8"],
         after_two_tasks(scale_up), check_up),
        ("quiesce", "n=24576&shards=24", ["--checkpoint_steps", "100000"],
         after_two_tasks(scale_down), check_quiesce),
    ):
        out = str(tmp_path / name)
        cfg = job_config(out, "--checkpoint_dir", f"{out}/ckpt",
                         *extra).replace(
            training_data=f"synthetic://criteo?{data}",
            records_per_task=1024)
        cases.append((Job(out, cfg, mid_job), check))
    out = str(tmp_path / "autoscale")
    cli = job_config(out).replace(
        training_data="synthetic://criteo?n=24576&shards=24",
        records_per_task=1024, master_addr="localhost:0").to_argv()
    cases.append((Cli(out, cli + [
        "--checkpoint_dir", f"{out}/ckpt", "--checkpoint_steps", "8",
        "--autoscale", "true", "--autoscale_hold_s", "0",
        "--autoscale_cooldown_s", "1", "--autoscale_rescale_cost_s", "1",
        "--alert_rules", str(rules), "--timeseries_interval_s", "0.5"]),
        check_autoscale))
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
