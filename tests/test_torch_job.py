"""The port's job path against the reference's, on the CPU.

(a) In-process parity. The reference's master and worker, then the port's,
run the same DeepFM job (`field_vocab=1000;hidden=32,32`, float32 compute,
minibatch 256, `synthetic://criteo` with 2048 training records in 4 tasks
of 2 steps, eval at epoch end over 512 records, interval checkpoints,
SAVE_MODEL and the final export). Both start from one state: the
reference's `init_state`, saved through the reference's CheckpointManager,
and its conversion (`convert.train_state_from_flax`: params and Adam's
moments and count) saved through the port's; each worker restores it at
its first batch. The reference runs on a one-device mesh with the exact
embedding backward (`EDL_EMB_SCATTER=sorted`). The dispatchers' counts,
the eval metric keys, AUC and accuracy are equal; the eval loss and the
final params agree within the DeepFM step test's tolerances after Adam
steps (`tests/test_torch_deepfm.py`: rtol 1e-4, atol 1e-5).

A prediction-only job over the port job's checkpoints then restores its
final state and streams predictions equal to that state's, exactly.

(b) The launcher. `run_local` runs the port's master in-process and one
`elasticdl_tpu_torch.worker.main` subprocess, asked for the CPU through
`extra_env` (`EDL_TORCH_DEVICE=cpu`). The cohort variables a polluted
environment can carry (`EDL_PROCESS_ID`, `EDL_NUM_PROCESSES`,
`EDL_PROCESS_ID_FROM_HOSTNAME`, `EDL_COORDINATOR_ADDR`) are cleared first,
and the job has a 90 s deadline. It asserts the tasks finished, a finite
eval AUC, a checkpoint step, SAVE_MODEL's export and a clean worker exit.
"""

import contextlib
import logging
import math
import os
import re
import signal
import sys
import threading
import time

import jax
import numpy as np
import torch

from elasticdl_tpu.common.config import JobConfig as JJobConfig
from elasticdl_tpu.master.main import Master as JMaster
from elasticdl_tpu.parallel.mesh import build_mesh
from elasticdl_tpu.training.checkpoint import CheckpointManager as JCheckpoint
from elasticdl_tpu.training.model_spec import ModelSpec as JModelSpec
from elasticdl_tpu.training.trainer import Trainer as JTrainer
from elasticdl_tpu.worker.worker import Worker as JWorker
from elasticdl_tpu_torch import convert
from elasticdl_tpu_torch.client import local
from elasticdl_tpu_torch.client.local import run_local
from elasticdl_tpu_torch.common.config import JobConfig
from elasticdl_tpu_torch.common.constants import PodStatus
from elasticdl_tpu_torch.common.net import free_port
from elasticdl_tpu_torch.master.main import Master
from elasticdl_tpu_torch.master.process_manager import ProcessManager
from elasticdl_tpu_torch.training import export
from elasticdl_tpu_torch.training.checkpoint import CheckpointManager
from elasticdl_tpu_torch.training.model_spec import ModelSpec
from elasticdl_tpu_torch.training.trainer import Trainer
from elasticdl_tpu_torch.worker.worker import Worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JZOO = os.path.join(REPO, "model_zoo")
TZOO = os.path.join(REPO, "elasticdl_tpu_torch", "model_zoo")
COHORT_ENV = ("EDL_PROCESS_ID", "EDL_NUM_PROCESSES",
              "EDL_PROCESS_ID_FROM_HOSTNAME", "EDL_COORDINATOR_ADDR")
B = 256


@contextlib.contextmanager
def zoo(root):
    """Both zoos name their module `deepfm.deepfm`, and masters and
    workers import it by that name: run a job with `root` first on
    sys.path and the other zoo's cached modules set aside."""
    names = [k for k in sys.modules if k == "deepfm" or k.startswith("deepfm.")]
    saved = {k: sys.modules.pop(k) for k in names}
    path = list(sys.path)
    try:
        sys.path.insert(0, root)
        yield
    finally:
        for k in [k for k in sys.modules
                  if k == "deepfm" or k.startswith("deepfm.")]:
            del sys.modules[k]
        sys.modules.update(saved)
        sys.path[:] = path


def _argv(zoo_root, out, n=2048, shards=4, eval_n=512):
    return [
        "--model_zoo", zoo_root, "--model_def", "deepfm.deepfm.custom_model",
        "--model_params", "field_vocab=1000;hidden=32,32",
        "--compute_dtype", "float32", "--minibatch_size", str(B),
        "--training_data", f"synthetic://criteo?n={n}&shards={shards}",
        "--records_per_task", "512",
        "--validation_data", f"synthetic://criteo?n={eval_n}&shards=2",
        "--checkpoint_dir", os.path.join(out, "ckpt"),
        "--checkpoint_steps", "4", "--keep_checkpoint_max", "2",
        "--output", os.path.join(out, "export"),
        "--master_addr", f"localhost:{free_port()}",
        "--worker_heartbeat_s", "1",
    ]


def _example():
    return {"features": {"dense": np.zeros((B, 13), np.float32),
                         "cat": np.zeros((B, 26), np.int32)},
            "labels": np.zeros((B,), np.int32),
            "mask": np.ones((B,), np.float32)}


def _run_job(master_cls, worker_cls, cfg, zoo_root, **worker_kw):
    """Master and worker in this process, the worker on a thread."""
    with zoo(zoo_root):
        master = master_cls(cfg)
        master.start()
        worker = worker_cls(cfg, **worker_kw)
        rc = []
        thread = threading.Thread(target=lambda: rc.append(worker.run()))
        thread.start()
        try:
            assert master.wait(poll_s=0.1, timeout_s=90)
            counts = master.dispatcher.counts()
            results = (master.evaluation.latest_results()
                       if master.evaluation else {})
        finally:
            master.shutdown(grace_s=0.5)
            thread.join(30)
    assert rc == [0]
    return counts, results, worker


def case_port_job_matches_reference_job(tmp, monkeypatch):
    monkeypatch.setenv("EDL_EMB_SCATTER", "sorted")
    jcfg = JJobConfig.from_argv(_argv(JZOO, os.path.join(tmp, "ref")))
    tcfg = JobConfig.from_argv(_argv(TZOO, os.path.join(tmp, "port")))
    mesh = build_mesh(devices=jax.devices()[:1])
    with zoo(JZOO):
        jt = JTrainer(JModelSpec.from_config(jcfg), mesh)
        js = jt.init_state(_example())
        JCheckpoint(jcfg.checkpoint_dir).save(js, wait=True)
        adam = js.opt_state.inner_state[0]
        host = jax.device_get((js.params, adam.mu, adam.nu, adam.count,
                               js.step))
    with zoo(TZOO):
        tt = Trainer(ModelSpec.from_config(tcfg), device="cpu")
        ts = convert.load_train_state(
            tt.init_state(_example()),
            convert.train_state_from_flax(*host, expected=tt.model))
        CheckpointManager(tcfg.checkpoint_dir).save(ts, wait=True)

    jcounts, jres, jw = _run_job(JMaster, JWorker, jcfg, JZOO, mesh=mesh)
    tcounts, tres, tw = _run_job(Master, Worker, tcfg, TZOO, device="cpu")
    assert tcounts == jcounts
    assert tcounts["finished_training"] == 4 and tcounts["failed_permanently"] == 0
    assert sorted(tres) == sorted(jres) == ["accuracy", "auc", "loss"]
    assert tres["auc"] == jres["auc"] and tres["accuracy"] == jres["accuracy"]
    np.testing.assert_allclose(tres["loss"], jres["loss"], rtol=1e-4)
    assert tw._state.model_version == jw._state.model_version == 8
    want = convert.params_from_flax(jax.device_get(jw._state.params))
    assert set(tw._state.params) == set(want)
    for name, p in tw._state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    # both wrote their interval checkpoints and the final export
    assert CheckpointManager(tcfg.checkpoint_dir).all_steps() == [4, 8]
    assert export.read_info(tcfg.output)["step"] == 8
    return tcfg, tw


def case_prediction_job_restores_and_predicts(tmp, tcfg, trained, monkeypatch):
    """A prediction-only job over the trained job's checkpoint directory:
    the worker restores step 8 and streams its outputs through DeepFM's
    `prediction_outputs_processor`; they equal the trained state's
    predictions on the same records exactly (same device, same math)."""
    out = os.path.join(tmp, "predictions")
    monkeypatch.setenv("EDL_PREDICT_OUT", out)
    cfg = tcfg.replace(
        job_type="prediction_only", training_data="", validation_data="",
        prediction_data="synthetic://criteo?n=600&shards=1", output="",
        master_addr=f"localhost:{free_port()}")
    counts, _, worker = _run_job(Master, Worker, cfg, TZOO, device="cpu")
    assert counts["failed_permanently"] == 0
    assert worker._state.model_version == 8
    got = np.concatenate([np.load(os.path.join(out, f))
                          for f in sorted(os.listdir(out))])
    assert got.shape == (600,)
    svc = worker._data_service(2)   # pb.PREDICTION
    want = np.concatenate([
        trained._trainer.predict_step(trained._state, b).numpy()[
            b["mask"] > 0]
        for b in svc.batches("synthetic-criteo-0", 0, 600)])
    np.testing.assert_array_equal(got, want)


class _WaitingManager(ProcessManager):
    """The launcher's process manager, recorded for the test, whose stop()
    first gives the workers up to 30 s to exit on their own: the test
    checks that the worker finishes the job and exits 0 by itself, which
    must not race the launcher's teardown terminating it."""

    made = []

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.made.append(self)

    def stop(self, grace_s: float = 10.0) -> None:
        deadline = time.time() + 30
        while not self.all_exited() and time.time() < deadline:
            time.sleep(0.1)
        super().stop(grace_s)


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def case_launcher_runs_a_subprocess_worker(tmp, monkeypatch):
    for name in COHORT_ENV:
        monkeypatch.delenv(name, raising=False)
    cfg = JobConfig.from_argv(_argv(TZOO, tmp, n=1024, shards=2)).replace(
        master_addr="localhost:0")
    with zoo(TZOO):       # the in-process master and load_model import it
        _launch_and_check(cfg, tmp, monkeypatch)


def _launch_and_check(cfg, tmp, monkeypatch):
    monkeypatch.setattr(local, "ProcessManager", _WaitingManager)
    records = _Records()
    root = logging.getLogger("elasticdl_tpu_torch")
    root.addHandler(records)
    try:
        rc = run_local(
            cfg, extra_env={"EDL_TORCH_DEVICE": "cpu", "PYTHONPATH": REPO},
            log_dir=os.path.join(tmp, "logs"), timeout_s=90)
    finally:
        root.removeHandler(records)
    log = open(os.path.join(tmp, "logs", "worker-0.log")).read()
    assert rc == 0, log[-3000:]
    assert _WaitingManager.made[-1].statuses() == {0: PodStatus.SUCCEEDED}, \
        log[-3000:]
    assert "on cpu" in log and "job done after" in log
    # the master's closing line carries the dispatcher counts and the
    # eval results
    finished = [m for m in records.messages if m.startswith("job finished")]
    assert len(finished) == 1, records.messages
    assert "'finished_training': 2, 'failed_permanently': 0" in finished[0]
    auc = float(re.search(r"'auc': ([0-9.e-]+)", finished[0]).group(1))
    loss = float(re.search(r"eval=.*'loss': ([0-9.e-]+)", finished[0]).group(1))
    assert 0.0 < auc < 1.0 and math.isfinite(loss)
    assert CheckpointManager(cfg.checkpoint_dir).all_steps() == [4]
    model, _ = export.load_model(cfg.output, TZOO, device="cpu")
    assert export.read_info(cfg.output)["step"] == 4
    ex = _example()
    with torch.no_grad():
        out = model({k: torch.from_numpy(v) for k, v in ex["features"].items()})
    assert out.shape == (B,) and bool(torch.isfinite(out).all())


def _keep_process_hooks(monkeypatch):
    """Masters and workers built in this process install process-wide
    crash hooks (both packages' flight recorders: `sys.excepthook`, a
    SIGUSR2 handler, the fault injectors' crash hooks). Put them back as
    they were after the test, so later tests in this process see the
    state they would have seen without it. Returns the SIGUSR2 handler
    to restore."""
    from elasticdl_tpu.common import faults as jfaults
    from elasticdl_tpu.observability import flight as jflight
    from elasticdl_tpu_torch.common import faults as tfaults
    from elasticdl_tpu_torch.observability import flight as tflight

    monkeypatch.setattr(sys, "excepthook", sys.excepthook)
    for flight, faults in ((jflight, jfaults), (tflight, tfaults)):
        monkeypatch.setattr(flight, "_HOOKS_INSTALLED", flight._HOOKS_INSTALLED)
        monkeypatch.setattr(faults, "_CRASH_HOOKS", list(faults._CRASH_HOOKS))
    return signal.getsignal(signal.SIGUSR2)


def test_job_path_matches_reference(tmp_path, monkeypatch):
    """Every case above, in one collected test (ROADMAP.md, conventions:
    one collected test per port test file)."""
    sigusr2 = _keep_process_hooks(monkeypatch)
    try:
        _cases(tmp_path, monkeypatch)
    finally:
        signal.signal(signal.SIGUSR2, sigusr2)


def _cases(tmp_path, monkeypatch):
    tcfg, trained = case_port_job_matches_reference_job(
        str(tmp_path / "a"), monkeypatch)
    case_prediction_job_restores_and_predicts(
        str(tmp_path / "a"), tcfg, trained, monkeypatch)
    case_launcher_runs_a_subprocess_worker(str(tmp_path / "b"), monkeypatch)
