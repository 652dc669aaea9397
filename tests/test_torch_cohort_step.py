"""The port's data-parallel DeepFM step against the reference's, on the CPU.

Four gloo ranks (`python tests/test_torch_cohort_step.py ranks ...`, the
harness of `tests/test_torch_mesh_embedding.py`) run DeepFM
(`field_vocab=64;hidden=16,16`, float32 compute, batches of 16 with
masked rows) on meshes over some or all of them, from the reference's
initial state converted with `convert.train_state_from_flax(...,
row_shards=)`, so each rank holds its rows of the table and of Adam's
moments. The reference runs its `Trainer` in-process on the same meshes
of the conftest's 8-device CPU mesh, with the exact embedding backward
(`EDL_EMB_SCATTER=sorted`).

- Three Adam steps at {data 2} and at {data 2, model 2}: losses rtol 1e-4
  and the final params rtol 1e-4 with atol 1e-5 (the tolerances of
  `tests/test_torch_deepfm.py` and `tests/test_torch_job.py` after Adam
  steps); the replicated parameters bit-identical on every rank (an
  allgather of a checksum of their bits).
- `grad_accum=2` at {data 2} against the reference's unaccumulated
  {data 2} run, the same way (accumulation changes only the order of the
  sums; the reference's own accumulation test holds it so).
- With dropout 0.1, the {data 2} step against the one-process step from
  the same state: loss rtol 1e-6, gradients rtol 1e-5 with atol 1e-6 of
  each one's largest value (both draw the global batch's mask; only the
  order of the sums differs).
- A checkpoint saved at {data 2} restores exactly at one process and at
  {data 4} (params and Adam's moments, bit for bit), and the one-process
  port's eval metric states and predictions equal the {data 2} ones
  (states exactly, the loss pair and predictions within rtol 1e-6).
- A mesh with a `seq` axis beside a `model`, `expert` or `pp` one is
  refused, naming ROADMAP item 35, and so is the MoE or the pipeline on a
  `seq` axis; the LM on a `seq` axis alone or with `data` is taken (its
  steps are `tests/test_torch_seq_parallel.py`'s, the LM under the other
  axes `tests/test_torch_lm_parallel.py`'s).
"""

import os
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tests.test_torch_mesh_embedding import (  # noqa: E402
    COHORT_ENV,
    rank_context,
    start_ranks,
    wait_ranks,
)

TZOO = os.path.join(REPO, "elasticdl_tpu_torch", "model_zoo")
JZOO = os.path.join(REPO, "model_zoo")
PARAMS = "field_vocab=64;hidden=16,16"
B, STEPS = 16, 3
# (name, mesh axes, grad_accum, the reference run it is held against)
RUNS = (("data2", {"data": 2}, 1, "data2"),
        ("data2_model2", {"data": 2, "model": 2}, 1, "data2_model2"),
        ("accum2", {"data": 2}, 2, "data2"))


def batch(seed):
    r = np.random.RandomState(seed)
    return {
        "features": {"dense": (r.rand(B, 13) * 20).astype(np.float32),
                     "cat": r.randint(0, 1 << 30, (B, 26)).astype(np.int32)},
        "labels": r.randint(0, 2, (B,)).astype(np.int32),
        "mask": (r.rand(B) > 0.2).astype(np.float32),
    }


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def unflat(d):
    out = {}
    for k, v in d.items():
        node = out
        *head, last = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


# ---------------------------------------------------------------- ranks


def run_ranks(rank: int, world: int, port: str, workdir: str) -> None:
    from elasticdl_tpu_torch import convert
    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.parallel import mesh as mesh_lib
    from elasticdl_tpu_torch.training.checkpoint import CheckpointManager
    from elasticdl_tpu_torch.training.model_spec import ModelSpec
    from elasticdl_tpu_torch.training.trainer import Trainer

    ctx = rank_context(rank, world, port)
    sys.path.insert(0, TZOO)
    inputs = dict(np.load(os.path.join(workdir, "inputs.npz")))
    out = {}

    def trainer(mesh, accum=1, params=PARAMS):
        spec = ModelSpec.from_config(JobConfig.from_argv([
            "--model_zoo", TZOO, "--model_def", "deepfm.deepfm.custom_model",
            "--model_params", params, "--compute_dtype", "float32"]))
        return Trainer(spec, device="cpu", mesh=mesh, grad_accum=accum)

    def start(tr, run):
        init = [unflat({k[len(f"{run}.{w}/"):]: v for k, v in inputs.items()
                        if k.startswith(f"{run}.{w}/")})
                for w in ("params", "mu", "nu")]
        state = tr.init_state(None)
        return convert.load_train_state(state, convert.train_state_from_flax(
            *init, inputs[f"{run}.count"], inputs[f"{run}.step"],
            row_shards=state.row_shards))

    def record(prefix, state):
        for k, p in state.params.items():
            out[f"{prefix}.param.{k}"] = p.detach().numpy().copy()
        for i, slot in state.optimizer.state_dict()["state"].items():
            name = list(state.params)[i]
            for key in ("exp_avg", "exp_avg_sq"):
                out[f"{prefix}.{key}.{name}"] = slot[key].numpy().copy()
        rows = state.row_shards.get("fm_embedding.table")
        out[f"{prefix}.row_start"] = np.array(rows.start if rows else 0)

    def checksum(state):
        """Two int64 sums over the bits of the replicated parameters."""
        bits = torch.cat([p.detach().reshape(-1) for k, p in
                          state.params.items() if k not in state.row_shards]
                         ).view(torch.int32).to(torch.int64)
        pos = torch.arange(bits.numel(), dtype=torch.int64)
        return [int(bits.sum()), int((bits * pos).sum())]

    batches = [{k: v for k, v in unflat({
        key[len(f"batch{i}/"):]: val for key, val in inputs.items()
        if key.startswith(f"batch{i}/")}).items()} for i in range(STEPS + 1)]
    states = {}
    for run, sizes, accum, ref in RUNS:
        n = int(np.prod(list(sizes.values())))
        mesh = mesh_lib.build_mesh(sizes, list(range(n)))
        sums = [0, 0]
        if mesh is not None:
            tr = trainer(mesh, accum)
            state = start(tr, ref)
            losses = [float(tr.train_step(state, b)[1]["loss"])
                      for b in batches[:STEPS]]
            out[f"{run}.losses"] = np.array(losses)
            out[f"{run}.block"] = np.array(mesh_lib.batch_block(mesh, B))
            record(run, state)
            sums = checksum(state)
            states[run] = (tr, state, mesh)
        out[f"{run}.checksums"] = ctx.allgather_ints(sums)

    # dropout 0.1: the {data 2} step against the one-process step
    mesh2 = mesh_lib.build_mesh({"data": 2}, [0, 1])
    dropped = PARAMS + ";dropout=0.1"
    if mesh2 is not None:
        for name, mesh in (("drop2", mesh2),) + (
                (("drop1", None),) if rank == 0 else ()):
            tr = trainer(mesh, params=dropped)
            state = start(tr, "data2")
            loss, grads = tr.compute_grads(state, batches[0])
            out[f"{name}.loss"] = loss.numpy()
            for k, g in grads.items():
                out[f"{name}.grad.{k}"] = g.numpy().copy()
            out[f"{name}.row_start"] = np.array(
                state.row_shards["fm_embedding.table"].start
                if state.row_shards else 0)

    # a checkpoint saved at {data 2}, restored at one process and {data 4}
    ckpt = os.path.join(workdir, "ckpt")
    evaluate = batches[STEPS]
    if mesh2 is not None:
        tr, state, _ = states["data2"]
        CheckpointManager(ckpt).save(state, wait=True)
        metric = tr.eval_step(state, evaluate, tr.new_metric_states())
        for k, v in metric.items():
            out[f"eval2.{k}"] = np.asarray(v)
        out["pred2"] = tr.predict_step(state, evaluate).numpy()
    ctx.barrier()
    if rank == 0:
        tr = trainer(None)
        state = tr.init_state(None)
        CheckpointManager(ckpt).restore(state)
        record("restore1", state)
        metric = tr.eval_step(state, evaluate, tr.new_metric_states())
        for k, v in metric.items():
            out[f"eval1.{k}"] = np.asarray(v)
        out["pred1"] = tr.predict_step(state, evaluate).numpy()
    mesh4 = mesh_lib.build_mesh({"data": 4})
    tr = trainer(mesh4)
    state = tr.init_state(None)
    CheckpointManager(ckpt).restore(state)
    record("restore4", state)
    ctx.barrier()
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    ctx.shutdown()


# ---------------------------------------------------------------- cases


def reference_runs(workdir):
    """The reference's inits (saved for the ranks), then its runs:
    {run: (losses, final params)}."""
    import jax

    from elasticdl_tpu.common.config import JobConfig as JJobConfig
    from elasticdl_tpu.parallel.mesh import build_mesh
    from elasticdl_tpu.training.model_spec import ModelSpec as JModelSpec
    from elasticdl_tpu.training.trainer import Trainer as JTrainer
    from tests.test_torch_job import zoo

    batches = [batch(100 + i) for i in range(STEPS + 1)]
    inputs = {f"batch{i}/{k}": v for i, b in enumerate(batches)
              for k, v in flat(b).items()}
    runs = {}
    for run, sizes, _, ref in RUNS:
        if run != ref:
            continue
        n = int(np.prod(list(sizes.values())))
        with zoo(JZOO):
            spec = JModelSpec.from_config(JJobConfig.from_argv([
                "--model_zoo", JZOO, "--model_def",
                "deepfm.deepfm.custom_model", "--model_params", PARAMS,
                "--compute_dtype", "float32"]))
        jt = JTrainer(spec, build_mesh(sizes, jax.devices()[:n]))
        js = jt.init_state(batches[0])
        adam = js.opt_state.inner_state[0]
        params, mu, nu, count, step = jax.device_get(
            (js.params, adam.mu, adam.nu, adam.count, js.step))
        for what, tree in (("params", params), ("mu", mu), ("nu", nu)):
            inputs.update({f"{run}.{what}/{k}": v
                           for k, v in flat(tree).items()})
        inputs[f"{run}.count"] = np.asarray(count)
        inputs[f"{run}.step"] = np.asarray(step)
        runs[run] = (jt, js)
    np.savez(os.path.join(workdir, "inputs.npz"), **inputs)
    ranks = start_ranks(os.path.abspath(__file__), 4, workdir)
    want = {}
    for run, (jt, js) in runs.items():
        losses = []
        for b in batches[:STEPS]:
            js, logs = jt.train_step(js, b)
            losses.append(float(logs["loss"]))
        want[run] = (np.array(losses), jax.device_get(js.params))
    return ranks, want


def _port_params(flax_params):
    from elasticdl_tpu_torch import convert

    return {k: v.numpy() for k, v in
            convert.params_from_flax(flax_params).items()}


def _whole(parts, prefix, n):
    """The full params of a run over ranks [0, n): the table's row ranges
    concatenated, the replicated params from rank 0."""
    out = {k[len(f"{prefix}.param."):]: v for k, v in parts[0].items()
           if k.startswith(f"{prefix}.param.")}
    shards = sorted((int(p[f"{prefix}.row_start"]),
                     p[f"{prefix}.param.fm_embedding.table"])
                    for p in parts[:n])
    out["fm_embedding.table"] = np.concatenate([s for _, s in shards])
    return out


def case_steps_match_reference(parts, want):
    for run, sizes, _, ref in RUNS:
        n = int(np.prod(list(sizes.values())))
        losses, params = want[ref]
        np.testing.assert_allclose(parts[0][f"{run}.losses"], losses,
                                   rtol=1e-4, err_msg=run)
        got = _whole(parts, run, n)
        for k, v in _port_params(params).items():
            np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-5,
                                       err_msg=f"{run} {k}")
        sums = parts[0][f"{run}.checksums"][:n]
        assert (sums == sums[0]).all(), (run, sums)


def case_dropout_step_does_not_depend_on_world_size(parts):
    one, two = parts[0], parts[:2]
    for r in two:
        np.testing.assert_allclose(r["drop2.loss"], one["drop1.loss"],
                                   rtol=1e-6)
    table1 = one["drop1.grad.fm_embedding.table"]
    for k in [k for k in one if k.startswith("drop1.grad.")]:
        name = k[len("drop1.grad."):]
        for r in two:
            got = r[f"drop2.grad.{name}"]
            want = one[k]
            if name == "fm_embedding.table":
                start = int(r["drop2.row_start"])
                want = table1[start:start + len(got)]
            np.testing.assert_allclose(
                got, want, rtol=1e-5, atol=1e-6 * np.abs(one[k]).max(),
                err_msg=name)


def case_checkpoint_restores_at_other_sizes(parts):
    saved = _whole(parts, "data2", 2)
    keys = ("exp_avg", "exp_avg_sq")
    restored1 = _whole(parts, "restore1", 1)
    restored4 = _whole(parts, "restore4", 4)
    for k, v in saved.items():
        np.testing.assert_array_equal(restored1[k], v, err_msg=k)
        np.testing.assert_array_equal(restored4[k], v, err_msg=k)
    for key in keys:
        for r in range(4):
            got = parts[r][f"restore4.{key}.fm_embedding.table"]
            start = int(parts[r]["restore4.row_start"])
            rows2 = [(int(parts[q]["data2.row_start"]),
                      parts[q][f"data2.{key}.fm_embedding.table"])
                     for q in range(2)]
            whole = np.concatenate([s for _, s in sorted(rows2,
                                                         key=lambda x: x[0])])
            np.testing.assert_array_equal(got, whole[start:start + len(got)])
            np.testing.assert_array_equal(
                parts[r][f"restore4.{key}.dnn_0.weight"],
                parts[0][f"data2.{key}.dnn_0.weight"])
    for name in ("auc", "accuracy"):
        np.testing.assert_array_equal(parts[0][f"eval1.{name}"],
                                      parts[0][f"eval2.{name}"])
        np.testing.assert_array_equal(parts[1][f"eval2.{name}"],
                                      parts[0][f"eval2.{name}"])
    np.testing.assert_allclose(parts[0]["eval1._loss"],
                               parts[0]["eval2._loss"], rtol=1e-6)
    np.testing.assert_allclose(parts[0]["pred1"], parts[0]["pred2"],
                               rtol=1e-6)
    np.testing.assert_array_equal(parts[1]["pred2"], parts[0]["pred2"])


def case_seq_axis_is_refused():
    """Sequence parallelism beside tensor, expert or pipeline parallelism
    is ROADMAP item 35: a trainer under a mesh with a `seq` axis and one
    of those refuses the LM, and so do the MoE and the pipeline on a
    `seq` axis; the LM on {data 2, seq 2}, {seq 2} and {data 2, model 2}
    is taken."""
    import pytest

    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.parallel.mesh import Mesh
    from elasticdl_tpu_torch.training.model_spec import ModelSpec
    from elasticdl_tpu_torch.training.trainer import Trainer
    from tests.test_torch_job_lm import LM_PARAMS, zoo

    def spec(params):
        with zoo(TZOO):
            return ModelSpec.from_config(JobConfig.from_argv([
                "--model_zoo", TZOO, "--model_def",
                "transformer.transformer_lm.custom_model",
                "--model_params", params]))

    def mesh(sizes):
        n = int(np.prod(list(sizes.values())))
        return Mesh(sizes, range(n), 0, groups={}, world=None)

    for sizes in ({"seq": 2, "model": 2}, {"seq": 2, "expert": 2},
                  {"seq": 2, "pp": 2}):
        with pytest.raises(NotImplementedError, match="item 35"):
            Trainer(spec(LM_PARAMS), device="cpu", mesh=mesh(sizes))
    for extra in (";moe_experts=2", ";pp_axis=pp"):
        with pytest.raises(NotImplementedError, match="item 35"):
            Trainer(spec(LM_PARAMS + extra), device="cpu",
                    mesh=mesh({"data": 2, "seq": 2}))
    for sizes in ({"data": 2, "seq": 2}, {"seq": 2}, {"data": 2, "model": 2}):
        Trainer(spec(LM_PARAMS), device="cpu", mesh=mesh(sizes))


def test_cohort_step_against_the_reference(monkeypatch):
    """Every case above, in one collected test (ROADMAP.md, conventions:
    one collected test per port test file)."""
    for k in COHORT_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("EDL_EMB_SCATTER", "sorted")
    with tempfile.TemporaryDirectory() as workdir:
        ranks, want = reference_runs(workdir)
        wait_ranks(ranks)
        parts = [dict(np.load(os.path.join(workdir, f"rank{r}.npz")))
                 for r in range(4)]
        case_steps_match_reference(parts, want)
        case_dropout_step_does_not_depend_on_world_size(parts)
        case_checkpoint_restores_at_other_sizes(parts)
    case_seq_axis_is_refused()


if __name__ == "__main__" and sys.argv[1] == "ranks":
    run_ranks(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
