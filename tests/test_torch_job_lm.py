"""The port's job path for the transformer LM and for grouped dispatch,
against the reference's, on the CPU.

(a) The LM job (twin of `tests/test_e2e_local.py::
test_local_transformer_lm_job_end_to_end`, at its width: vocab 32, 1
layer, dim 32, 4 heads, float32, `synthetic://lm` with 512 records of 16
tokens in 4 tasks, minibatch 16, eval at epoch end over 64 records). The
reference's master and worker, then the port's, run in this process from
one state: the reference worker's initial state (its `init_state` from
the job's seed), and its conversion (`convert.train_state_from_flax`)
saved through the port's CheckpointManager, which the port's worker
restores. The dispatchers' counts and the token accuracy
are equal; the eval loss agrees within rtol 1e-4 and the final params
within rtol 1e-4, atol 1e-5 after 32 AdamW steps. Each block's k bias is
held apart: its gradient is 0 in exact arithmetic, so each side's Adam
moves it by rounding noise, up to the learning rate a step; both are
held within 32 x 3e-4 of its initial 0. The port's job records steps
2-3 with `--profile_dir` and writes the trace.

(b) Grouped dispatch (twin of `test_local_job_with_grouped_dispatch`):
DeepFM (`field_vocab=1000;hidden=32,32`, float32) with
`--steps_per_dispatch 2 --wire_dtype bfloat16` and tasks of 3 minibatches,
so each task runs one full group through `train_many` and one partial
group as a single step, and the eval (2 minibatches) one `eval_many`
group. All 4 tasks finish, none fails; the dispatchers' counts, the eval
results and the final params (bit for bit) equal the port's own
ungrouped job's: the same steps on the same batches. The counts of an
ungrouped job are held to the reference's in (a) and in
`tests/test_torch_job.py`.

The cohort variables a polluted environment can carry (`EDL_PROCESS_ID`,
`EDL_NUM_PROCESSES`, `EDL_PROCESS_ID_FROM_HOSTNAME`,
`EDL_COORDINATOR_ADDR`) are cleared first.
"""

import contextlib
import os
import signal
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from elasticdl_tpu.common.config import JobConfig as JJobConfig
from elasticdl_tpu.master.main import Master as JMaster
from elasticdl_tpu.parallel.mesh import build_mesh
from elasticdl_tpu.training.trainer import Trainer as JTrainer
from elasticdl_tpu.worker.worker import Worker as JWorker
from elasticdl_tpu_torch import convert
from elasticdl_tpu_torch.common.config import JobConfig
from elasticdl_tpu_torch.common.net import free_port
from elasticdl_tpu_torch.master.main import Master
from elasticdl_tpu_torch.training.checkpoint import CheckpointManager
from elasticdl_tpu_torch.training.model_spec import ModelSpec
from elasticdl_tpu_torch.training.trainer import Trainer
from elasticdl_tpu_torch.worker.worker import Worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JZOO = os.path.join(REPO, "model_zoo")
TZOO = os.path.join(REPO, "elasticdl_tpu_torch", "model_zoo")
COHORT_ENV = ("EDL_PROCESS_ID", "EDL_NUM_PROCESSES",
              "EDL_PROCESS_ID_FROM_HOSTNAME", "EDL_COORDINATOR_ADDR")
LM_PARAMS = ("vocab=32;num_layers=1;dim=32;heads=4;max_len=32;"
             "seq_parallel=none")


@contextlib.contextmanager
def zoo(root):
    """Both zoos name their modules `deepfm.deepfm` and
    `transformer.transformer_lm`, and masters and workers import them by
    those names: run a job with `root` first on sys.path and the other
    zoo's cached modules set aside."""
    def ours(k):
        return k.split(".")[0] in ("deepfm", "transformer")

    saved = {k: sys.modules.pop(k) for k in [k for k in sys.modules
                                             if ours(k)]}
    path = list(sys.path)
    try:
        sys.path.insert(0, root)
        yield
    finally:
        for k in [k for k in sys.modules if ours(k)]:
            del sys.modules[k]
        sys.modules.update(saved)
        sys.path[:] = path


def _lm_argv(zoo_root, *extra):
    return [
        "--model_zoo", zoo_root,
        "--model_def", "transformer.transformer_lm.custom_model",
        "--model_params", LM_PARAMS, "--compute_dtype", "float32",
        "--minibatch_size", "16", "--records_per_task", "128",
        "--training_data", "synthetic://lm?n=512&shards=4&vocab=32&seq_len=16",
        "--validation_data",
        "synthetic://lm?n=64&shards=1&vocab=32&seq_len=16",
        "--master_addr", f"localhost:{free_port()}",
        "--worker_heartbeat_s", "1", *extra,
    ]


def _grouped_argv(zoo_root, *extra):
    return [
        "--model_zoo", zoo_root, "--model_def", "deepfm.deepfm.custom_model",
        "--model_params", "field_vocab=1000;hidden=32,32",
        "--compute_dtype", "float32", "--minibatch_size", "64",
        "--training_data", "synthetic://criteo?n=768&shards=2",
        "--records_per_task", "192",
        "--validation_data", "synthetic://criteo?n=128&shards=1",
        "--wire_dtype", "bfloat16",
        "--master_addr", f"localhost:{free_port()}",
        "--worker_heartbeat_s", "1", *extra,
    ]


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
            results = master.evaluation.latest_results()
        finally:
            master.shutdown(grace_s=0.5)
            thread.join(30)
    assert rc == [0] and not thread.is_alive()
    return counts, results, worker


def case_lm_job_matches_reference_job(tmp):
    jcfg = JJobConfig.from_argv(_lm_argv(JZOO))
    profile_dir = os.path.join(tmp, "profile")
    tcfg = JobConfig.from_argv(_lm_argv(
        TZOO, "--checkpoint_dir", os.path.join(tmp, "ckpt"),
        "--profile_dir", profile_dir, "--profile_start_step", "2",
        "--profile_steps", "2"))
    # the reference worker's initial state, read as its init returns it
    # (before its first step donates it)
    inits = []
    real_init = JTrainer.init_state

    def init_state(self, example):
        state = real_init(self, example)
        adam = state.opt_state.inner_state[0]
        inits.append(jax.device_get((state.params, adam.mu, adam.nu,
                                     adam.count, state.step)))
        return state

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JTrainer, "init_state", init_state)
        jcounts, jres, jw = _run_job(
            JMaster, JWorker, jcfg, JZOO,
            mesh=build_mesh(devices=jax.devices()[:1]))
    assert len(inits) == 1
    example = {"features": np.zeros((16, 16), np.int32),
               "labels": np.zeros((16, 16), np.int32),
               "mask": np.ones((16,), np.float32)}
    with zoo(TZOO):
        tt = Trainer(ModelSpec.from_config(tcfg), device="cpu")
        ts = convert.load_train_state(
            tt.init_state(example),
            convert.train_state_from_flax(*inits[0], expected=tt.model))
        CheckpointManager(tcfg.checkpoint_dir).save(ts, wait=True)
    tcounts, tres, tw = _run_job(Master, Worker, tcfg, TZOO, device="cpu")
    assert tcounts == jcounts
    assert tcounts["finished_training"] == 4
    assert tcounts["failed_permanently"] == 0
    assert sorted(tres) == sorted(jres) == ["loss", "token_accuracy"]
    assert tres["token_accuracy"] == jres["token_accuracy"]
    assert 0.0 <= tres["token_accuracy"] <= 1.0
    np.testing.assert_allclose(tres["loss"], jres["loss"], rtol=1e-4)
    assert tw._state.model_version == jw._state.model_version == 32
    want = convert.params_from_flax(jax.device_get(jw._state.params))
    assert set(tw._state.params) == set(want)
    for name, p in tw._state.params.items():
        got = p.detach().numpy()
        if name.endswith(".k.bias"):
            for x in (got, want[name].numpy()):
                assert np.abs(x).max() <= 32 * 3e-4, name
            continue
        np.testing.assert_allclose(got, want[name].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    # the profiler window: worker 0's steps 2 and 3, one Chrome trace
    traces = os.listdir(profile_dir)
    assert traces == ["worker-0.steps-2-4.pt.trace.json"], traces
    assert os.path.getsize(os.path.join(profile_dir, traces[0])) > 0


def case_grouped_job_matches_single_steps():
    tcfg = JobConfig.from_argv(_grouped_argv(TZOO, "--steps_per_dispatch",
                                             "2"))
    tcounts, tres, grouped = _run_job(Master, Worker, tcfg, TZOO,
                                      device="cpu")
    assert tcounts["finished_training"] == 4
    assert tcounts["failed_permanently"] == 0
    assert grouped._global_step == 12 and grouped._state.model_version == 12
    assert sorted(tres) == ["accuracy", "auc", "loss"]
    scounts, sres, single = _run_job(
        Master, Worker, JobConfig.from_argv(_grouped_argv(TZOO)), TZOO,
        device="cpu")
    assert tcounts == scounts
    assert sres == tres
    for name, p in grouped._state.params.items():
        assert torch.equal(p, single._state.params[name]), name


def _keep_process_hooks(monkeypatch):
    """Masters and workers built in this process install process-wide
    crash hooks (both packages' flight recorders). Put them back as they
    were after the test. Returns the SIGUSR2 handler to restore."""
    from elasticdl_tpu.common import faults as jfaults
    from elasticdl_tpu.observability import flight as jflight
    from elasticdl_tpu_torch.common import faults as tfaults
    from elasticdl_tpu_torch.observability import flight as tflight

    monkeypatch.setattr(sys, "excepthook", sys.excepthook)
    for flight, faults in ((jflight, jfaults), (tflight, tfaults)):
        monkeypatch.setattr(flight, "_HOOKS_INSTALLED", flight._HOOKS_INSTALLED)
        monkeypatch.setattr(faults, "_CRASH_HOOKS", list(faults._CRASH_HOOKS))
    return signal.getsignal(signal.SIGUSR2)


def test_lm_and_grouped_jobs_match_reference(tmp_path, monkeypatch):
    """Every case above, in one collected test (ROADMAP.md, conventions:
    one collected test per port test file)."""
    for name in COHORT_ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("EDL_EMB_SCATTER", "sorted")
    monkeypatch.delenv("EDL_FLASH", raising=False)
    sigusr2 = _keep_process_hooks(monkeypatch)
    try:
        case_lm_job_matches_reference_job(str(tmp_path))
        case_grouped_job_matches_single_steps()
    finally:
        signal.signal(signal.SIGUSR2, sigusr2)


# ---------------------------------------------------------------- F2


def moe_job_side_by_side(tmp, model_params, dtype):
    """The MoE LM job as `chip_smoke.py`'s `moe_job` runs it (32 steps in
    4 tasks, groups of 4 steps, checkpoints every 16 steps, eval at epoch
    end), at a reduced width on the CPU: the reference's master and worker,
    then the port's from the reference worker's converted initial state.
    Returns {"reference", "port"}: each job's losses (one a step), eval
    results, dispatcher counts and final `moe_aux` buffers.

        python tests/test_torch_job_lm.py f2 [float32|bfloat16]"""
    from elasticdl_tpu_torch.training import trainer as trainer_lib

    def argv(zoo_root, ckpt):
        return [
            "--model_zoo", zoo_root,
            "--model_def", "transformer.transformer_lm.custom_model",
            "--model_params", model_params, "--compute_dtype", dtype,
            "--minibatch_size", "8", "--records_per_task", "64",
            "--training_data",
            "synthetic://lm?n=256&shards=4&vocab=512&seq_len=64",
            "--validation_data",
            "synthetic://lm?n=64&shards=1&vocab=512&seq_len=64",
            "--steps_per_dispatch", "4", "--checkpoint_dir", ckpt,
            "--checkpoint_steps", "16", "--keep_checkpoint_max", "2",
            "--master_addr", f"localhost:{free_port()}",
            "--worker_heartbeat_s", "1"]

    inits, losses = [], {"reference": [], "port": []}
    real_init, real_jmany = JTrainer.init_state, JTrainer.train_many
    real_tmany = trainer_lib.Trainer.train_many

    def init_state(self, example):
        state = real_init(self, example)
        adam = state.opt_state.inner_state[0]
        inits.append(jax.device_get((state.params, adam.mu, adam.nu,
                                     adam.count, state.step,
                                     state.extra_vars.get("losses"))))
        return state

    def jmany(self, state, stacked):
        state, logs = real_jmany(self, state, stacked)
        losses["reference"] += [float(x) for x in np.asarray(logs["loss"])]
        return state, logs

    def tmany(self, state, stacked):
        state, logs = real_tmany(self, state, stacked)
        losses["port"] += [float(x) for x in logs["loss"]]
        return state, logs

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JTrainer, "init_state", init_state)
        mp.setattr(JTrainer, "train_many", jmany)
        mp.setattr(trainer_lib.Trainer, "train_many", tmany)
        jcfg = JJobConfig.from_argv(argv(JZOO, os.path.join(tmp, "j")))
        counts, results, jw = _run_job(
            JMaster, JWorker, jcfg, JZOO,
            mesh=build_mesh(devices=jax.devices()[:1]))
        aux = jax.device_get(jw._state.extra_vars.get("losses", {}))
        out["reference"] = {
            "counts": counts, "eval": results,
            "moe_aux": [float(np.asarray(aux[b]["moe"]["moe_aux"]))
                        for b in sorted(aux)]}
        tcfg = JobConfig.from_argv(argv(TZOO, os.path.join(tmp, "t")))
        params, mu, nu, count, step, init_losses = inits[0]
        with zoo(TZOO):
            tt = Trainer(ModelSpec.from_config(tcfg), device="cpu")
            ts = convert.load_train_state(
                tt.init_state(None), convert.train_state_from_flax(
                    params, mu, nu, count, step, expected=tt.model,
                    losses=init_losses))
            CheckpointManager(tcfg.checkpoint_dir).save(ts, wait=True)
        counts, results, tw = _run_job(Master, Worker, tcfg, TZOO,
                                       device="cpu")
        out["port"] = {
            "counts": counts, "eval": results,
            "moe_aux": [float(v) for k, v in sorted(
                tw._state.buffers.items()) if k.endswith("moe_aux")]}
    for side in out:
        out[side]["losses"] = losses[side]
    return out


if __name__ == "__main__" and sys.argv[1] == "f2":
    import json
    import tempfile

    dtype = sys.argv[2] if len(sys.argv) > 2 else "float32"
    lm = "vocab=512;num_layers=2;dim=64;heads=4;max_len=64;seq_parallel=none"
    report = {}
    for name, params in (("moe", lm + ";moe_experts=8"), ("plain", lm)):
        with tempfile.TemporaryDirectory() as tmp:
            report[name] = moe_job_side_by_side(tmp, params, dtype)
    print(json.dumps({"dtype": dtype, **report}))
