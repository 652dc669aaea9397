"""The new zoo models through the port's job path, on the CPU.

- ResNet-20 (depth 8, float32, learning rate 0.01) on
  `synthetic://cifar10`: the reference's
  master and worker and the port's, both in this process (the worker on
  a thread), from one initial state (the reference's, converted with
  `convert.train_state_from_flax`: params, SGD's trace, BatchNorm's
  `batch_stats`), through 4 training tasks of 2 steps at minibatch 32,
  eval at epoch end, interval checkpoints, SAVE_MODEL and the export.
  The dispatcher counts and eval accuracy must be equal, the eval loss
  within rtol 1e-4 (eight steps' differences in the params and running
  averages carry into it: 5.5e-5 measured), and the final params and running averages within
  rtol 1e-5 with atol 1e-4 of the largest param and of the largest
  statistic (`tests/test_torch_zoo_parallel.py`'s param tolerance: eight
  SGD steps through BatchNorm's fast variance; 2.6e-5 measured on a
  running mean).
- Wide & Deep (hidden 32,16) on `synthetic://census` through the port's
  job: the per-record CSV parser, K1 in every step, 4 tasks, eval AUC.
- For both port jobs: the newest checkpoint restores the final state bit
  for bit (params, buffers, optimizer slots, step), and the export
  predicts as that state does (bit for bit: one device, one program).
- A two-member gloo cohort of ResNet-20 through the port's Master and
  ProcessManager (`tests/test_torch_cohort_job.py`'s `Job`): 4 tasks,
  eval at epoch end (the members all-gather the outputs), a collective
  checkpoint and export whose running averages equal the checkpoint's.

Every spawned member gets an environment with the cohort variables
cleared (`COHORT_ENV`).
"""

import os
import threading

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
from elasticdl_tpu_torch.common.config import JobConfig
from elasticdl_tpu_torch.common.net import free_port
from elasticdl_tpu_torch.master.main import Master
from elasticdl_tpu_torch.training import export
from elasticdl_tpu_torch.training.checkpoint import CheckpointManager
from elasticdl_tpu_torch.training.model_spec import ModelSpec
from elasticdl_tpu_torch.training.trainer import Trainer
from elasticdl_tpu_torch.worker.worker import Worker
from tests.test_torch_cohort_job import COHORT_ENV, Job
from tests.test_torch_zoo import (
    JZOO, TZOO, assert_close, port_arrays, reference_state, zoo)

JOBS = {
    "resnet20": ("cifar10.resnet.custom_model", "depth=8;learning_rate=0.01", 32,
                 "synthetic://cifar10?n=256&shards=2", 64,
                 "synthetic://cifar10?n=64&shards=1"),
    "wide_deep": ("census.wide_deep.custom_model", "hidden=32,16", 64,
                  "synthetic://census?n=512&shards=2", 128,
                  "synthetic://census?n=128&shards=1"),
}


def argv(name, root, out, *extra):
    model_def, params, b, data, per_task, eval_data = JOBS[name]
    return ["--model_zoo", root, "--model_def", model_def,
            "--model_params", params, "--compute_dtype", "float32",
            "--minibatch_size", str(b), "--training_data", data,
            "--records_per_task", str(per_task),
            "--validation_data", eval_data,
            "--checkpoint_dir", os.path.join(out, "ckpt"),
            "--checkpoint_steps", "4", "--keep_checkpoint_max", "2",
            "--output", os.path.join(out, "export"),
            "--worker_heartbeat_s", "1", *extra]


def run_job(master_cls, worker_cls, cfg, root, **worker_kw):
    """Master and worker in this process, the worker on a thread."""
    with zoo(root):
        master = master_cls(cfg)
        master.start()
        worker = worker_cls(cfg, **worker_kw)
        rc = []
        thread = threading.Thread(target=lambda: rc.append(worker.run()))
        thread.start()
        try:
            assert master.wait(poll_s=0.1, timeout_s=90)
            counts = master.dispatcher.counts()
            results = master.evaluation.latest_results()
        finally:
            master.shutdown(grace_s=0.5)
            thread.join(30)
    assert rc == [0]
    assert counts["finished_training"] == 4, counts
    assert counts["failed_permanently"] == 0, counts
    return counts, results, worker


def check_restore_and_export(name, cfg, worker):
    """The newest checkpoint restores the worker's final state bit for
    bit; the export predicts as that state does."""
    final = worker._state
    with zoo(TZOO):
        fresh = Trainer(ModelSpec.from_config(cfg), device="cpu").init_state(
            None)
    assert CheckpointManager(cfg.checkpoint_dir).latest_step() == final.step
    CheckpointManager(cfg.checkpoint_dir).restore(fresh)
    assert fresh.step == final.step
    for got, want in zip(port_arrays(fresh), port_arrays(final)):
        if isinstance(want, dict):
            for k, v in want.items():
                for n, a in (v.items() if isinstance(v, dict) else [(k, v)]):
                    np.testing.assert_array_equal(
                        (got[k][n] if isinstance(v, dict) else got[k]), a,
                        err_msg=f"{name} {n}")
        else:
            assert got == want
    with zoo(TZOO):
        model, variables = export.load_model(cfg.output, TZOO, device="cpu")
    assert set(variables["buffers"]) == set(final.buffers)
    r = np.random.RandomState(3)
    if name == "resnet20":
        feats = r.rand(8, 32, 32, 3).astype(np.float32)
        tfeats = torch.from_numpy(feats)
    else:
        feats = {"dense": r.randn(8, 5).astype(np.float32),
                 "cat": r.randint(0, 400, (8, 9)).astype(np.int32)}
        tfeats = {k: torch.from_numpy(v) for k, v in feats.items()}
    with torch.no_grad():
        np.testing.assert_array_equal(
            model(tfeats, training=False).numpy(),
            worker._trainer.predict_step(final, {"features": feats}).numpy())


def case_resnet20_job_matches_reference(tmp):
    jcfg = JJobConfig.from_argv(argv("resnet20", JZOO,
                                     os.path.join(tmp, "ref"),
                                     "--master_addr",
                                     f"localhost:{free_port()}"))
    tcfg = JobConfig.from_argv(argv("resnet20", TZOO,
                                    os.path.join(tmp, "port"),
                                    "--master_addr",
                                    f"localhost:{free_port()}"))
    mesh = build_mesh(devices=jax.devices()[:1])
    example = {"features": np.zeros((32, 32, 32, 3), np.float32),
               "labels": np.zeros((32,), np.int32)}
    with zoo(JZOO):
        jt = JTrainer(JModelSpec.from_config(jcfg), mesh)
        js = jt.init_state(example)
        JCheckpoint(jcfg.checkpoint_dir).save(js, wait=True)
        converted = reference_state(js)
    with zoo(TZOO):
        tt = Trainer(ModelSpec.from_config(tcfg), device="cpu")
        ts = convert.load_train_state(tt.init_state(None), converted)
        CheckpointManager(tcfg.checkpoint_dir).save(ts, wait=True)
    jcounts, jres, jw = run_job(JMaster, JWorker, jcfg, JZOO, mesh=mesh)
    tcounts, tres, tw = run_job(Master, Worker, tcfg, TZOO, device="cpu")
    assert tcounts == jcounts
    assert sorted(tres) == sorted(jres) == ["accuracy", "loss"]
    assert tres["accuracy"] == jres["accuracy"]
    np.testing.assert_allclose(tres["loss"], jres["loss"], rtol=1e-4)
    want = reference_state(jw._state)
    got_params, _, got_buffers, _ = port_arrays(tw._state)
    assert tw._state.step == int(jax.device_get(jw._state.step)) == 8
    assert_close(got_params, {k: v.numpy() for k, v in want["params"].items()},
                 1e-5, 1e-4, "param")
    assert_close(got_buffers, {k: v.numpy() for k, v in
                               want["buffers"].items()}, 1e-5, 1e-4, "buffer")
    check_restore_and_export("resnet20", tcfg, tw)


def case_wide_deep_job(tmp):
    cfg = JobConfig.from_argv(argv("wide_deep", TZOO,
                                   os.path.join(tmp, "census"),
                                   "--master_addr",
                                   f"localhost:{free_port()}"))
    _, results, worker = run_job(Master, Worker, cfg, TZOO, device="cpu")
    assert sorted(results) == ["accuracy", "auc", "loss"]
    assert all(np.isfinite(v) for v in results.values()), results
    assert worker._state.step == 8
    check_restore_and_export("wide_deep", cfg, worker)


def case_resnet20_cohort(tmp):
    out = os.path.join(tmp, "cohort")
    cfg = JobConfig.from_argv(argv(
        "resnet20", TZOO, out, "--num_processes", "2", "--num_epochs", "1",
        "--master_addr", f"localhost:{free_port()}"))
    job = Job(out, cfg)
    with zoo(TZOO):
        job.start()
        job.join(150)
    assert not job.is_alive()
    if job.error is not None:
        raise job.error
    assert job.counts["finished_training"] == 4, job.counts
    assert job.counts["failed_permanently"] == 0, job.counts
    log = job.log()
    for p in (0, 1):
        assert f"distributed world v0 up: process {p}/2" in log, log[-3000:]
    with zoo(TZOO):
        _, variables = export.load_model(cfg.output, TZOO, device="cpu")
        state = Trainer(ModelSpec.from_config(cfg), device="cpu").init_state(
            None)
    CheckpointManager(cfg.checkpoint_dir).restore(state)
    assert state.step == 8
    for k, b in state.buffers.items():
        assert torch.equal(variables["buffers"][k], b), k


def test_zoo_jobs(tmp_path, monkeypatch):
    """Every case above, in one collected test (ROADMAP.md, conventions:
    one collected test per port test file)."""
    for k in COHORT_ENV:
        monkeypatch.delenv(k, raising=False)
    tmp = str(tmp_path)
    case_resnet20_job_matches_reference(tmp)
    case_wide_deep_job(tmp)
    case_resnet20_cohort(tmp)
