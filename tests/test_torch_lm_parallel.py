"""The port's transformer LM under a mesh against the reference, on the CPU.

Four gloo ranks (`python tests/test_torch_lm_parallel.py ranks ...`, the
harness of `tests/test_torch_mesh_embedding.py`) run a plan of LM runs
(`run_ranks`): each on a mesh over some of them, from the reference's
initial params converted with `convert.train_state_from_flax(...,
row_shards=)`, so each rank holds its part of every split leaf. The
reference runs its `Trainer` in-process on the same meshes of the
conftest's 8-device CPU mesh, with its materialized attention (its CPU
default). `tests/test_torch_moe.py` and `tests/test_torch_pipeline.py`
drive the same harness with plans of their own.

The LM is `vocab=64;num_layers=2;dim=64;heads=4;max_len=64`, float32,
batches of 8 x 32 tokens with two masked rows.

- {data 2}, and {data 2, model 2} with `tp_axis=model` (q, k, v and
  mlp_in split by columns, proj and mlp_out by rows, the lm_head by
  columns over the vocab with its logits gathered): three AdamW steps'
  losses rtol 1e-4; the params after the first step and after the third
  rtol 2e-4 with atol 2e-5 (the reference's own tensor-parallel
  tolerance, `tests/test_transformer_lm.py:169`) for all but 0.1% of
  each leaf's entries, and every entry within 2 x steps x lr
  (`assert_params_close` says why Adam lets an entry whose gradient is
  near rounding level step apart by that much; the k biases' is 0 in
  exact arithmetic); eval's token accuracy equal, its loss pair and the
  predictions rtol 5e-5.
- Replicas equal after the three steps: every rank's part of every
  leaf equals the assembled whole's, bit for bit, on every mesh.
- A checkpoint saved at {data 2, model 2} restores exactly at {model 4}
  (another world size and split) and in one process: params and Adam's
  moments bit for bit.
- One short gloo cohort job of the MoE LM (4 experts) on {expert 2}
  through the port's Master and ProcessManager: every task finishes.
"""

import json
import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tests.test_torch_cohort_step import flat, unflat  # noqa: E402
from tests.test_torch_mesh_embedding import (  # noqa: E402
    COHORT_ENV,
    rank_context,
    start_ranks,
    wait_ranks,
)

TZOO = os.path.join(REPO, "elasticdl_tpu_torch", "model_zoo")
JZOO = os.path.join(REPO, "model_zoo")
LM = "vocab=64;num_layers=2;dim=64;heads=4;max_len=64;seq_parallel=none"
B, T, V = 8, 32, 64
STEPS = 3


def lm_batch(seed):
    r = np.random.RandomState(seed)
    toks = r.randint(0, V, (B, T + 1)).astype(np.int32)
    mask = np.ones((B,), np.float32)
    mask[r.choice(B, 2, replace=False)] = 0.0
    return {"features": toks[:, :-1], "labels": toks[:, 1:], "mask": mask}


def lm_spec(zoo_root, cfg_cls, spec_cls, params, dtype="float32"):
    """A ModelSpec of the LM from one zoo root; both zoos name their
    module `transformer.transformer_lm`, so any cached `transformer`
    modules are set aside for the load and put back after it."""
    def ours(k):
        return k == "transformer" or k.startswith("transformer.")

    saved = {k: sys.modules.pop(k) for k in [k for k in sys.modules
                                             if ours(k)]}
    path = list(sys.path)
    try:
        sys.path.insert(0, zoo_root)
        return spec_cls.from_config(cfg_cls.from_argv([
            "--model_zoo", zoo_root, "--model_def",
            "transformer.transformer_lm.custom_model", "--model_params",
            params, "--compute_dtype", dtype]))
    finally:
        for k in [k for k in sys.modules if ours(k)]:
            del sys.modules[k]
        sys.modules.update(saved)
        sys.path[:] = path


# ---------------------------------------------------------------- ranks


def run_ranks(rank: int, world: int, port: str, workdir: str,
              probes=None) -> None:
    """Every run of `plan.json`, in order, each on its mesh over ranks [0,
    n). A run: name, sizes (the mesh), params (the LM's model_params;
    without them only the probe runs, with no trainer), and optionally
    accum, remat, remat_policy, steps, init (the inputs' prefix of the
    reference's initial params), restore (a checkpoint directory to start
    from instead), save (one to write at the end), eval (a batch to
    evaluate and predict) and probe (a name in `probes`: fn(mesh,
    trainer, state, inputs' tree fn, run name) -> more outputs). Each
    rank writes its parts of everything to rank<r>.npz."""
    from elasticdl_tpu_torch import convert
    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.parallel import mesh as mesh_lib
    from elasticdl_tpu_torch.training.checkpoint import CheckpointManager
    from elasticdl_tpu_torch.training.model_spec import ModelSpec
    from elasticdl_tpu_torch.training.trainer import Trainer

    ctx = rank_context(rank, world, port)
    with open(os.path.join(workdir, "plan.json")) as f:
        plan = json.load(f)
    inputs = dict(np.load(os.path.join(workdir, "inputs.npz")))
    out = {}

    def tree(prefix):
        return unflat({k[len(prefix):]: v for k, v in inputs.items()
                       if k.startswith(prefix)})

    for run in plan:
        name, sizes = run["name"], run["sizes"]
        n = int(np.prod(list(sizes.values())))
        mesh = mesh_lib.build_mesh(sizes, list(range(n)))
        if mesh is not None and "params" not in run:
            out.update(probes[run["probe"]](mesh, None, None, tree, name))
        elif mesh is not None:
            spec = lm_spec(TZOO, JobConfig, ModelSpec, run["params"])
            tr = Trainer(spec, device="cpu", mesh=mesh,
                         grad_accum=run.get("accum", 1),
                         remat=run.get("remat", False),
                         remat_policy=run.get("remat_policy", ""))
            state = tr.init_state(None)
            if "restore" in run:
                CheckpointManager(os.path.join(workdir, run["restore"])
                                  ).restore(state)
            else:
                state = port_state(tr, tree(f"{run['init']}/params/"),
                                   tree(f"{run['init']}/losses/"))
            losses = []
            for i in range(run.get("steps", 0)):
                losses.append(float(tr.train_step(
                    state, tree(f"batch{i}/"))[1]["loss"]))
                if i == 0:
                    out.update({f"{name}.param1.{k}": p.detach().numpy()
                                .copy() for k, p in state.params.items()})
            out[f"{name}.losses"] = np.array(losses)
            for k, p in state.params.items():
                out[f"{name}.param.{k}"] = p.detach().numpy().copy()
                rows = state.row_shards.get(k)
                if rows is not None:
                    out[f"{name}.shard.{k}"] = np.array(
                        [rows.dim, rows.start, rows.stop])
            for i, slot in state.optimizer.state_dict()["state"].items():
                k = list(state.params)[i]
                for key in ("exp_avg", "exp_avg_sq"):
                    out[f"{name}.{key}.{k}"] = slot[key].numpy().copy()
            for k, b in state.buffers.items():
                out[f"{name}.buffer.{k}"] = b.numpy().copy()
            if "eval" in run:
                batch = tree(f"batch{run['eval']}/")
                for k, v in tr.eval_step(state, batch,
                                         tr.new_metric_states()).items():
                    out[f"{name}.eval.{k}"] = np.asarray(v)
                out[f"{name}.pred"] = tr.predict_step(state, batch).numpy()
            if "save" in run:
                CheckpointManager(os.path.join(workdir, run["save"])).save(
                    state, wait=True)
            if "probe" in run:
                out.update(probes[run["probe"]](mesh, tr, state, tree, name))
        ctx.barrier()
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    ctx.shutdown()


def start_plan(workdir, plan, inputs, script=None):
    """Write the plan and the inputs and start the four ranks."""
    with open(os.path.join(workdir, "plan.json"), "w") as f:
        json.dump(plan, f)
    np.savez(os.path.join(workdir, "inputs.npz"), **inputs)
    return start_ranks(script or os.path.abspath(__file__), 4, workdir)


def rank_parts(workdir):
    return [dict(np.load(os.path.join(workdir, f"rank{r}.npz")))
            for r in range(4)]


def whole(parts, run, n, what="param"):
    """{leaf: the whole leaf} of run `run` over ranks [0, n), assembled
    from their parts; asserts that every rank's part equals the whole's
    (the replicas are equal), bit for bit."""
    out = {}
    head = f"{run}.{what}."
    for key in [k for k in parts[0] if k.startswith(head)]:
        leaf = key[len(head):]
        shard = parts[0].get(f"{run}.shard.{leaf}")
        if shard is None:
            full = parts[0][key]
        else:
            dim = int(shard[0])
            pieces = {}
            for p in parts[:n]:
                d, start, stop = p[f"{run}.shard.{leaf}"]
                pieces[int(start)] = p[key]
            full = np.concatenate([pieces[s] for s in sorted(pieces)],
                                  axis=dim)
        for r, p in enumerate(parts[:n]):
            got = p[key]
            want = full
            if shard is not None:
                d, start, stop = p[f"{run}.shard.{leaf}"]
                want = np.take(full, np.arange(start, stop), axis=int(d))
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{run} {leaf} rank {r}")
        out[leaf] = full
    return out


# ---------------------------------------------------------------- reference


def reference_run(params, sizes, batches, steps, accum=1, remat=False,
                  eval_batch=None):
    """The reference's LM on mesh `sizes`, as numpy trees: {"init" (its
    initial params), "init_losses" (its initial `losses` collection),
    "losses", "first" and "params" (the params after the first step and
    after the last), "states" and "pred" (eval and predict on
    `eval_batch`), "extra" (its final extra_vars)}."""
    import jax

    from elasticdl_tpu.common.config import JobConfig as JJobConfig
    from elasticdl_tpu.parallel.mesh import build_mesh
    from elasticdl_tpu.training.model_spec import ModelSpec as JModelSpec
    from elasticdl_tpu.training.trainer import Trainer as JTrainer

    n = int(np.prod(list(sizes.values())))
    spec = lm_spec(JZOO, JJobConfig, JModelSpec, params)
    jt = JTrainer(spec, build_mesh(sizes, jax.devices()[:n]),
                  grad_accum=accum, remat=remat)
    js = jt.init_state(batches[0])
    out = {"init": jax.device_get(js.params),
           "init_losses": jax.device_get(js.extra_vars).get("losses", {}),
           "losses": [], "first": None}
    for b in batches[:steps]:
        js, logs = jt.train_step(js, b)
        out["losses"].append(float(logs["loss"]))
        out["first"] = out["first"] or jax.device_get(js.params)
    out["params"] = jax.device_get(js.params)
    out["extra"] = jax.device_get(js.extra_vars)
    if eval_batch is not None:
        out["states"] = jax.device_get(
            jt.eval_step(js, eval_batch, jt.new_metric_states()))
        out["pred"] = np.asarray(jt.predict_step(js, eval_batch))
    return out


def init_inputs(run, want):
    """The reference's initial params and `losses` tree, as the ranks'
    inputs for a run with `init` = `run`."""
    return {f"{run}/{what}/{k}": v
            for what in ("params", "losses")
            for k, v in flat(want["init" if what == "params"
                                  else "init_losses"]).items()}


def port_state(tr, init, init_losses):
    """A port TrainState from the reference's initial params and
    `losses` collection (its MoE layers' `moe_aux`)."""
    from elasticdl_tpu_torch import convert

    state = tr.init_state(None)
    return convert.load_train_state(state, convert.train_state_from_flax(
        init, row_shards=state.row_shards, losses=init_losses or None))


def port_params(flax_params):
    from elasticdl_tpu_torch import convert

    return {k: v.numpy() for k, v in
            convert.params_from_flax(flax_params).items()}


LR = 3e-4                        # the zoo's AdamW learning rate


def assert_params_close(got, flax_params, what, steps):
    """Params after `steps` AdamW steps: rtol 2e-4 with atol 2e-5 for all
    but 0.1% of each leaf's entries, and every entry within 2 x steps x
    lr. Adam moves an entry by up to lr a step whatever its gradient's
    size (g / (|g| + 1e-8) on the first step), so an entry whose gradient
    is near rounding level (the k biases': 0 in exact arithmetic) can
    step apart on the two sides by up to 2 x lr a step."""
    for k, v in port_params(flax_params).items():
        err = np.abs(got[k] - v)
        assert err.max() <= 2 * steps * LR, (what, k, err.max())
        if not k.endswith(".k.bias"):
            off = err > 2e-5 + 2e-4 * np.abs(v)
            assert off.mean() <= 1e-3, (what, k, off.sum(), err.max())


def batch_inputs(count, seed0=100):
    batches = [lm_batch(seed0 + i) for i in range(count)]
    inputs = {f"batch{i}/{k}": v for i, b in enumerate(batches)
              for k, v in flat(b).items()}
    return batches, inputs


# ---------------------------------------------------------------- cases


TP = LM + ";tp_axis=model"
PLAN = [
    {"name": "data2", "params": LM, "sizes": {"data": 2}, "init": "data2",
     "steps": STEPS, "eval": STEPS},
    {"name": "tp", "params": TP, "sizes": {"data": 2, "model": 2},
     "init": "tp", "steps": STEPS, "eval": STEPS, "save": "ckpt"},
    {"name": "restore_model4", "params": TP, "sizes": {"model": 4},
     "restore": "ckpt"},
    {"name": "restore_one", "params": TP, "sizes": {"data": 1},
     "restore": "ckpt"},
]
MESHES = {"data2": {"data": 2}, "tp": {"data": 2, "model": 2}}


def case_steps_match_reference(parts, want):
    for run, sizes in MESHES.items():
        n = int(np.prod(list(sizes.values())))
        w = want[run]
        states, pred = w["states"], w["pred"]
        np.testing.assert_allclose(parts[0][f"{run}.losses"], w["losses"],
                                   rtol=1e-4, err_msg=run)
        assert_params_close(whole(parts, run, n, "param1"), w["first"], run,
                            1)
        assert_params_close(whole(parts, run, n), w["params"], run, STEPS)
        np.testing.assert_array_equal(parts[0][f"{run}.eval.token_accuracy"],
                                      np.asarray(states["token_accuracy"]))
        np.testing.assert_allclose(parts[0][f"{run}.eval._loss"],
                                   np.asarray(states["_loss"]), rtol=5e-5)
        np.testing.assert_allclose(parts[0][f"{run}.pred"], pred, rtol=5e-5,
                                   atol=5e-5 * np.abs(pred).max())


def case_split_leaves_are_split(parts):
    """q is split by columns (its weight's rows), mlp_out by rows (its
    weight's columns), the lm_head over the vocab: each rank of {data 2,
    model 2} holds half."""
    for leaf, dim, size in (("block_0.q.weight", 0, 32),
                            ("block_0.mlp_out.weight", 1, 128),
                            ("lm_head.weight", 0, 32),
                            ("lm_head.bias", 0, 32)):
        d, start, stop = parts[1][f"tp.shard.{leaf}"]
        assert (d, stop - start) == (dim, size), (leaf, d, start, stop)
        assert parts[1][f"tp.param.{leaf}"].shape[dim] == size, leaf
    assert "tp.shard.block_0.proj.bias" not in parts[0]


def case_checkpoint_restores_at_other_sizes(parts):
    saved = whole(parts, "tp", 4)
    for run, n in (("restore_model4", 4), ("restore_one", 1)):
        got = whole(parts, run, n)
        assert set(got) == set(saved)
        for k, v in saved.items():
            np.testing.assert_array_equal(got[k], v, err_msg=f"{run} {k}")
        for key in ("exp_avg", "exp_avg_sq"):
            want = whole(parts, "tp", 4, key)
            for k, v in whole(parts, run, n, key).items():
                np.testing.assert_array_equal(v, want[k], err_msg=k)


def case_moe_cohort_job(tmp):
    """The MoE LM through a two-member gloo cohort on {expert 2}."""
    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.common.net import free_port
    from tests.test_torch_cohort_job import Job

    out = os.path.join(tmp, "job")
    cfg = JobConfig.from_argv([
        "--model_zoo", TZOO, "--model_def",
        "transformer.transformer_lm.custom_model", "--model_params",
        LM + ";moe_experts=4", "--compute_dtype", "float32",
        "--training_data", "synthetic://lm?n=64&shards=2&vocab=64&seq_len=32",
        "--records_per_task", "16", "--minibatch_size", "8",
        "--num_epochs", "1", "--num_processes", "2",
        "--mesh_shape", "expert=2",
        "--master_addr", f"localhost:{free_port()}",
        "--worker_heartbeat_s", "1"])
    job = Job(out, cfg)
    modules = {k: sys.modules.pop(k) for k in list(sys.modules)
               if k == "transformer" or k.startswith("transformer.")}
    sys.path.insert(0, TZOO)
    try:
        job.start()
        job.join(150)
    finally:
        sys.path.remove(TZOO)
        for k in [k for k in sys.modules
                  if k == "transformer" or k.startswith("transformer.")]:
            del sys.modules[k]
        sys.modules.update(modules)
    assert not job.is_alive()
    if job.error is not None:
        raise job.error
    assert job.counts["finished_training"] == 4, job.counts
    assert job.counts["failed_permanently"] == 0, job.counts
    log = job.log()
    assert "distributed world v0 up: process 1/2" in log, log[-3000:]


def test_lm_under_a_mesh_against_the_reference(monkeypatch):
    """Every case above, in one collected test (ROADMAP.md, conventions:
    one collected test per port test file)."""
    for k in COHORT_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.delenv("EDL_FLASH", raising=False)
    with tempfile.TemporaryDirectory() as workdir:
        batches, inputs = batch_inputs(STEPS + 1)
        want = {}
        for run, sizes in MESHES.items():
            params = TP if run == "tp" else LM
            want[run] = reference_run(params, sizes, batches, STEPS,
                                      eval_batch=batches[STEPS])
            inputs.update(init_inputs(run, want[run]))
        ranks = start_plan(workdir, PLAN, inputs)
        wait_ranks(ranks, timeout_s=120)
        parts = rank_parts(workdir)
        case_steps_match_reference(parts, want)
        case_split_leaves_are_split(parts)
        case_checkpoint_restores_at_other_sizes(parts)
        case_moe_cohort_job(workdir)


if __name__ == "__main__" and sys.argv[1] == "ranks":
    run_ranks(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
