"""The hybrid multi-slice mesh over the port's ranks against the
reference's over devices: the twins of `tests/test_hybrid_mesh.py:15, 30,
38, 44, 70, 105`.

On GPUs a slice is a host: `parallel/mesh.build_hybrid_mesh` lays the
world's ranks out as the reference lays out devices without slice
topology (contiguous blocks of prod(ICI) ranks, one a slice, each axis
the product of its DCN and ICI factors with the DCN factor slowest).

- Layout (15, 30, 38): `hybrid_layout` over 8 ranks gives the reference
  mesh's device ids, axis names and sizes for dcn {data 2} x ici {data 2,
  model 2} and for dcn {data 2} x ici {data 4}, and the reference's error
  for a size mismatch ("needs 16 devices").
- `build_job_mesh` from a config (44), in a world of four gloo ranks:
  `--dcn_mesh_shape data=2 --mesh_shape model=2` gives the reference's
  mesh over 4 devices (axes (model, data), the same grid); no
  `--dcn_mesh_shape` gives every rank on `data`; `data=3` fails with the
  reference's "does not divide" and a positional form with its "named
  form".
- DeepFM on that hybrid mesh (70): three Adam steps from the reference's
  initial state (converted with its row shards) against the reference's
  Trainer on its hybrid mesh of 4 CPU devices: losses rtol 1e-4, final
  params rtol 1e-4 with atol 1e-5 (`tests/test_torch_cohort_step.py`'s
  tolerances after Adam steps), replicated parameters bit-identical on
  every rank, and every rank's batch block and table rows where the
  hybrid grid puts them. The same steps on the flat {data 2, model 2}
  mesh, whose ranks sit at the same coordinates in another linear order,
  give the same losses and params bit for bit, and a checkpoint saved
  from the hybrid mesh (the leader gathers the table's rows in mesh
  order, which is not the world's) restores them exactly in one
  process.
- Hybrid equals flat (105): the MNIST CNN's step on dcn {data 2} x ici
  {data 2} equals its step on the flat {data 4} mesh from the same
  seed, loss and parameters bit for bit (the reference holds its two
  within rel 1e-5).
"""

import os
import sys
import tempfile

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tests.test_torch_cohort_step import (  # noqa: E402
    B,
    JZOO,
    PARAMS,
    STEPS,
    TZOO,
    _port_params,
    _whole,
    batch,
    flat,
    unflat,
)
from tests.test_torch_mesh_embedding import (  # noqa: E402
    COHORT_ENV,
    rank_context,
    start_ranks,
    wait_ranks,
)

ICI, DCN = {"model": 2}, {"data": 2}
MNIST_B = 16


def mnist_batch(seed=1):
    r = np.random.RandomState(seed)
    return {"features": r.rand(MNIST_B, 28, 28, 1).astype(np.float32),
            "labels": r.randint(0, 10, (MNIST_B,)).astype(np.int32),
            "mask": np.ones((MNIST_B,), np.float32)}


# ---------------------------------------------------------------- ranks


def run_ranks(rank: int, world: int, port: str, workdir: str) -> None:
    import torch

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

    def cfg(**kw):
        return JobConfig(model_zoo="z", model_def="m.m.f", **kw)

    job = mesh_lib.build_job_mesh(cfg(mesh_shape="model=2",
                                      dcn_mesh_shape="data=2"))
    out["job.names"] = np.array(job.axis_names)
    out["job.sizes"] = np.array(list(job.shape.values()))
    out["job.ranks"] = np.array(job.ranks)
    plain = mesh_lib.build_job_mesh(cfg())
    out["plain.shape"] = np.array(list(plain.shape.items()))
    for shape, match in (("data=3", "does not divide"), ("2", "named form")):
        with pytest.raises(ValueError, match=match):
            mesh_lib.build_job_mesh(cfg(dcn_mesh_shape=shape))

    def deepfm(mesh):
        spec = ModelSpec.from_config(JobConfig.from_argv([
            "--model_zoo", TZOO, "--model_def", "deepfm.deepfm.custom_model",
            "--model_params", PARAMS, "--compute_dtype", "float32"]))
        tr = Trainer(spec, device="cpu", mesh=mesh)
        init = [unflat({k[len(f"{w}/"):]: v for k, v in inputs.items()
                        if k.startswith(f"{w}/")})
                for w in ("params", "mu", "nu")]
        state = tr.init_state(None)
        return tr, convert.load_train_state(
            state, convert.train_state_from_flax(
                *init, inputs["count"], inputs["step"],
                row_shards=state.row_shards))

    batches = [unflat({k[len(f"batch{i}/"):]: v for k, v in inputs.items()
                       if k.startswith(f"batch{i}/")}) for i in range(STEPS)]
    for run, mesh in (("hybrid", mesh_lib.build_hybrid_mesh(ICI, DCN)),
                      ("flat", mesh_lib.build_mesh({"data": 2,
                                                    "model": 2}))):
        tr, state = deepfm(mesh)
        out[f"{run}.losses"] = np.array(
            [float(tr.train_step(state, b)[1]["loss"]) for b in batches])
        for k, p in state.params.items():
            out[f"{run}.param.{k}"] = p.detach().numpy().copy()
        out[f"{run}.row_start"] = np.array(
            state.row_shards["fm_embedding.table"].start)
        out[f"{run}.block"] = np.array(mesh_lib.batch_block(mesh, B))
        out[f"{run}.coords"] = np.array([mesh.coords["data"],
                                         mesh.coords["model"]])
        bits = torch.cat([p.detach().reshape(-1) for k, p in
                          state.params.items() if k not in state.row_shards]
                         ).view(torch.int32).to(torch.int64)
        out[f"{run}.checksums"] = ctx.allgather_ints(
            [int(bits.sum()), int((bits * torch.arange(bits.numel())).sum())])
        if run == "hybrid":
            # a collective save from the hybrid mesh, restored in one
            # process: the leader gathers the table's rows in mesh order
            ckpt = os.path.join(workdir, "ckpt")
            CheckpointManager(ckpt).save(state, wait=True)
            ctx.barrier()
            if rank == 0:
                tr1, one = deepfm(None)
                CheckpointManager(ckpt).restore(one)
                for k, p in one.params.items():
                    out[f"restore1.param.{k}"] = p.detach().numpy().copy()
                out["restore1.row_start"] = np.array(0)

    mnist = mnist_batch()
    for run, mesh in (("mnist_hybrid",
                       mesh_lib.build_hybrid_mesh({"data": 2}, {"data": 2})),
                      ("mnist_flat", mesh_lib.build_mesh({"data": 4}))):
        spec = ModelSpec.from_config(JobConfig.from_argv([
            "--model_zoo", TZOO, "--model_def", "mnist.mnist_cnn.custom_model",
            "--model_params", "learning_rate=0.01",
            "--compute_dtype", "float32"]))
        tr = Trainer(spec, device="cpu", mesh=mesh, seed=0)
        state = tr.init_state(None)
        out[f"{run}.loss"] = np.array(float(tr.train_step(state, mnist)[1]
                                            ["loss"]))
        for k, p in state.params.items():
            out[f"{run}.param.{k}"] = p.detach().numpy().copy()
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    ctx.shutdown()


# ---------------------------------------------------------------- cases


def grid_ids(mesh):
    return np.vectorize(lambda d: d.id)(mesh.devices)


def case_layout_matches_the_reference():
    import jax

    from elasticdl_tpu.parallel.mesh import build_hybrid_mesh as jhybrid
    from elasticdl_tpu_torch.parallel.mesh import hybrid_layout

    for ici, dcn in (({"data": 2, "model": 2}, {"data": 2}),
                     ({"data": 4}, {"data": 2})):
        ref = jhybrid(ici, dcn, devices=jax.devices()[:8])
        sizes, grid = hybrid_layout(ici, dcn, range(8))
        assert tuple(sizes) == ref.axis_names
        assert sizes == dict(ref.shape)
        np.testing.assert_array_equal(grid, grid_ids(ref))
    np.testing.assert_array_equal(
        hybrid_layout({"data": 2, "model": 2}, {"data": 2}, range(8))[1],
        [[0, 1], [2, 3], [4, 5], [6, 7]])
    for build in (lambda: jhybrid({"data": 4, "model": 2}, {"data": 2},
                                  devices=jax.devices()[:8]),
                  lambda: hybrid_layout({"data": 4, "model": 2},
                                        {"data": 2}, range(8))):
        with pytest.raises(ValueError, match="needs 16 devices, have 8"):
            build()


def reference_runs(workdir):
    """The reference's DeepFM on its hybrid mesh of 4 devices: the initial
    state (saved for the ranks), then its 3 steps; and its job mesh."""
    import jax

    from elasticdl_tpu.common.config import JobConfig as JJobConfig
    from elasticdl_tpu.parallel.mesh import build_hybrid_mesh, build_job_mesh
    from elasticdl_tpu.training.model_spec import ModelSpec as JModelSpec
    from elasticdl_tpu.training.trainer import Trainer as JTrainer
    from tests.test_torch_job import zoo

    devices = jax.devices()[:4]
    job = build_job_mesh(JJobConfig(model_zoo="z", model_def="m.m.f",
                                    mesh_shape="model=2",
                                    dcn_mesh_shape="data=2"), devices)
    batches = [batch(100 + i) for i in range(STEPS)]
    inputs = {f"batch{i}/{k}": v for i, b in enumerate(batches)
              for k, v in flat(b).items()}
    with zoo(JZOO):
        spec = JModelSpec.from_config(JJobConfig.from_argv([
            "--model_zoo", JZOO, "--model_def", "deepfm.deepfm.custom_model",
            "--model_params", PARAMS, "--compute_dtype", "float32"]))
    jt = JTrainer(spec, build_hybrid_mesh(ICI, DCN, devices=devices))
    js = jt.init_state(batches[0])
    adam = js.opt_state.inner_state[0]
    params, mu, nu, count, step = jax.device_get(
        (js.params, adam.mu, adam.nu, adam.count, js.step))
    for what, tree in (("params", params), ("mu", mu), ("nu", nu)):
        inputs.update({f"{what}/{k}": v for k, v in flat(tree).items()})
    inputs["count"], inputs["step"] = np.asarray(count), np.asarray(step)
    np.savez(os.path.join(workdir, "inputs.npz"), **inputs)
    ranks = start_ranks(os.path.abspath(__file__), 4, workdir)
    losses = []
    for b in batches:
        js, logs = jt.train_step(js, b)
        losses.append(float(logs["loss"]))
    return ranks, job, (np.array(losses), jax.device_get(js.params))


def case_job_mesh_matches_the_reference(parts, job):
    for p in parts:
        assert tuple(p["job.names"]) == job.axis_names
        assert dict(zip(p["job.names"], p["job.sizes"])) == dict(job.shape)
        np.testing.assert_array_equal(
            p["job.ranks"].reshape(tuple(p["job.sizes"])), grid_ids(job))
        assert [tuple(x) for x in p["plain.shape"]] == [("data", "4")]


def case_steps_match_the_reference(parts, want):
    losses, params = want
    np.testing.assert_allclose(parts[0]["hybrid.losses"], losses, rtol=1e-4)
    got = _whole(parts, "hybrid", 4)
    for k, v in _port_params(params).items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    # rank r sits at (data, model) = (r // 2, r % 2) on both meshes: its
    # batch block follows its data coordinate, its table rows the mesh's
    # linear order (hybrid: ranks 0, 2, 1, 3 own rows 0..3 quarters)
    for r, p in enumerate(parts):
        for run in ("hybrid", "flat"):
            assert tuple(p[f"{run}.coords"]) == (r // 2, r % 2)
            assert tuple(p[f"{run}.block"]) == (r // 2 * B // 2,
                                                (r // 2 + 1) * B // 2)
        assert p["hybrid.row_start"] == parts[0]["flat.row_start"] + (
            [0, 2, 1, 3][r] * int(parts[1]["flat.row_start"]))
    for run in ("hybrid", "flat"):
        sums = parts[0][f"{run}.checksums"]
        assert (sums == sums[0]).all(), (run, sums)
    # the hybrid mesh's checkpoint restores its params in one process
    restored = _whole(parts[:1], "restore1", 1)
    for k, v in got.items():
        np.testing.assert_array_equal(restored[k], v, err_msg=k)
    # the flat mesh's steps, bit for bit
    np.testing.assert_array_equal(parts[0]["flat.losses"],
                                  parts[0]["hybrid.losses"])
    flat_params = _whole(parts, "flat", 4)
    for k, v in got.items():
        np.testing.assert_array_equal(flat_params[k], v, err_msg=k)


def case_hybrid_equals_flat(parts):
    for p in parts:
        assert p["mnist_hybrid.loss"] == parts[0]["mnist_flat.loss"]
        for k in [k for k in p if k.startswith("mnist_flat.param.")]:
            np.testing.assert_array_equal(
                p[k.replace("mnist_flat", "mnist_hybrid")], p[k], err_msg=k)


def test_hybrid_mesh_against_the_reference(monkeypatch):
    """Every case above, in one collected test (ROADMAP.md, conventions:
    one collected test per port test file)."""
    for k in COHORT_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("EDL_EMB_SCATTER", "sorted")
    case_layout_matches_the_reference()
    with tempfile.TemporaryDirectory() as workdir:
        ranks, job, want = reference_runs(workdir)
        wait_ranks(ranks)
        parts = [dict(np.load(os.path.join(workdir, f"rank{r}.npz")))
                 for r in range(4)]
    case_job_mesh_matches_the_reference(parts, job)
    case_steps_match_the_reference(parts, want)
    case_hybrid_equals_flat(parts)


if __name__ == "__main__" and sys.argv[1] == "ranks":
    run_ranks(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
