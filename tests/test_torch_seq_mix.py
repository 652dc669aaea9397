"""The port's sequence parallelism beside tensor and expert parallelism
against the reference, on the CPU.

Four gloo ranks run a plan (`tests/test_torch_lm_parallel.py`'s harness,
`run_ranks`), each mesh built in turn inside that one world; the
reference runs its `Trainer` in-process on the same meshes of 4 of the
conftest's 8 CPU devices (its attention there: the XLA ring recurrence
or its Ulysses all-to-all, under GSPMD for `model` and `expert`), every
program compiled once: the runs of one model share one initial state
(the reference's init draws the same parameters on any mesh), each
copy placed on its own mesh. The LM is `vocab=64;num_layers=2;dim=64;
heads=4;max_len=64`, float32, batches of 8 x 32 tokens with two masked
rows, and each port run starts from the reference's initial params,
converted.

- The mesh's lines over three axes: on {seq 2, model 2}, {seq 2, expert
  2} and {data 2, seq 2} each axis's group is the ranks that share every
  other coordinate (an all-gather of the world ranks over it), the batch
  falls back to a data axis of size 1 where the mesh has none, and the
  rank's columns follow its `seq` coordinate.
- Ring with `tp_axis=model` on {seq 2, model 2}, Ulysses with it (4 heads:
  the rank's 2 split over seq 2 by the all-to-all), the MoE LM (4
  experts) with the ring on {data 2, seq 2} and on {seq 2, expert 2}, and
  Ulysses with `tp_axis=model` at 2 heads on {seq 2, model 2}, where the
  rank's one head does not split over seq 2 and the sequence gather runs
  (the reference accepts it, since 2 % 2 == 0), and the pipelined LM
  (`pp_axis=pp`, no pp axis: the stages' fold, whose attention gathers
  the sequence) on {data 2, seq 2}: two AdamW steps (one for the MoE and
  pipelined runs, to keep the file's time near its budget) with losses
  rtol 1e-4; the params after each step, split leaves assembled over
  `model` or `expert`, by `assert_params_close`
  (`tests/test_torch_seq_parallel.py`'s tolerances); eval's token
  accuracy equal, its loss pair and the predictions rtol 5e-5; every
  replica bit-equal; the MoE runs' `moe_aux` buffers rtol 1e-6.
- The route's block arithmetic in one process (`ops.moe.blocks_local`):
  2 x 2 (data, seq) blocks at capacity factor 0.5, where tokens drop and
  the arrival order decides which: each block's slots, keep and capacity
  equal the global route's exactly, its aux within rel 1e-6, and its
  index route's output rows those of the reference's global
  `switch_moe` (rtol 1e-5, atol 1e-6).
- {seq 2, pp 2} raises the error that says why (the reference's program
  aborts inside XLA on that mesh), in the trainer and in
  `PipelinedBlocks.shard`.
"""

import os
import sys
import tempfile

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tests.test_torch_lm_parallel import (  # noqa: E402
    COHORT_ENV,
    JZOO,
    TZOO,
    assert_params_close,
    batch_inputs,
    lm_spec,
    rank_parts,
    run_ranks,
    start_plan,
    wait_ranks,
    whole,
)
from tests.test_torch_moe import _aux_of  # noqa: E402
from tests.test_torch_cohort_step import flat  # noqa: E402

LM = "vocab=64;num_layers=2;dim=64;heads=4;max_len=64"
TP_SEQ = {"seq": 2, "model": 2}
# name: (model params, mesh, train steps, the run whose initial state it
# starts from: the same parameters, which the reference's init draws alike
# on any mesh)
RUNS = {
    "ring_tp": (LM + ";tp_axis=model", TP_SEQ, 2, "ring_tp"),
    "ulysses_tp": (LM + ";tp_axis=model;seq_parallel=ulysses", TP_SEQ, 2,
                   "ring_tp"),
    "moe_data_seq": (LM + ";moe_experts=4", {"data": 2, "seq": 2}, 1,
                     "moe_data_seq"),
    "moe_seq_expert": (LM + ";moe_experts=4", {"seq": 2, "expert": 2}, 1,
                       "moe_data_seq"),
    "ulysses_tp_h2": ("vocab=64;num_layers=2;dim=64;heads=2;max_len=64;"
                      "tp_axis=model;seq_parallel=ulysses", TP_SEQ, 2,
                      "ring_tp"),
    "pipeline_data_seq": (LM + ";pp_axis=pp;seq_parallel=none",
                          {"data": 2, "seq": 2}, 1, "pipeline_data_seq"),
}
EVAL = 2                        # the batch that eval and predict read
LINES = {"lines_seq_model": TP_SEQ, "lines_seq_expert": {"seq": 2,
                                                         "expert": 2},
         "lines_data_seq": {"data": 2, "seq": 2}}
PLAN = [{"name": name, "sizes": sizes, "probe": "lines"}
        for name, sizes in LINES.items()] + [
    {"name": name, "params": params, "sizes": sizes, "init": init,
     "steps": steps, "eval": EVAL}
    for name, (params, sizes, steps, init) in RUNS.items()]


# ---------------------------------------------------------------- ranks


def probe_lines(mesh, tr, state, tree, name):
    """The world ranks each axis's group gathers, and the rank's block."""
    import torch.distributed as dist

    from elasticdl_tpu_torch.parallel import mesh as mesh_lib

    out = {f"{name}.coords": np.array([mesh.coords[a]
                                       for a in mesh.axis_names]),
           f"{name}.data_axis": np.array(mesh_lib.data_axis(mesh)),
           f"{name}.batch_block": np.array(mesh_lib.batch_block(mesh, 8)),
           f"{name}.seq_block": np.array(mesh_lib.seq_block(mesh, 32))}
    me = torch.tensor([dist.get_rank()])
    for axis in mesh.axis_names:
        out[f"{name}.line.{axis}"] = mesh_lib.all_gather(
            mesh, axis, me).numpy()
    return out


# ---------------------------------------------------------------- reference


def reference_trainers(batch):
    """{run: (the reference's Trainer on the run's mesh, its initial
    state)}; a run that starts from another's state gets a copy of it, on
    its own mesh's shardings (one init program a model)."""
    import jax
    import jax.numpy as jnp

    from elasticdl_tpu.common.config import JobConfig as JJobConfig
    from elasticdl_tpu.parallel.mesh import build_mesh
    from elasticdl_tpu.training.model_spec import ModelSpec as JModelSpec
    from elasticdl_tpu.training.trainer import Trainer as JTrainer

    out = {}
    for name, (params, sizes, _, init) in RUNS.items():
        n = int(np.prod(list(sizes.values())))
        jt = JTrainer(lm_spec(JZOO, JJobConfig, JModelSpec, params),
                      build_mesh(sizes, jax.devices()[:n]))
        if init == name:
            out[name] = (jt, jt.init_state(batch))
            continue
        state = jax.tree_util.tree_map(jnp.copy, out[init][1])
        if sizes != RUNS[init][1]:
            state = jax.device_put(state, jax.tree_util.tree_map(
                lambda x: x.sharding, jt.abstract_train_state(batch)))
        out[name] = (jt, state)
    return out


def reference_inputs(name, js):
    """The reference's initial params and `losses` tree, as the ranks'
    inputs for the run `name`."""
    import jax

    trees = {"params": jax.device_get(js.params),
             "losses": jax.device_get(js.extra_vars).get("losses", {})}
    return {f"{name}/{what}/{k}": v for what, t in trees.items()
            for k, v in flat(t).items()}


def reference_steps(jt, js, batches, steps):
    """`steps` train steps, then eval and predict on batch EVAL:
    {"losses", "params" (after each step), "extra", "states", "pred",
    "placed" (the state's shardings after the first step)}."""
    import jax

    out = {"losses": [], "params": []}
    for b in batches[:steps]:
        js, logs = jt.train_step(js, b)
        out["losses"].append(float(logs["loss"]))
        out["params"].append(jax.device_get(js.params))
        out.setdefault("placed", jax.tree_util.tree_map(
            lambda x: x.sharding, js))
    out["extra"] = jax.device_get(js.extra_vars)
    out["states"] = jax.device_get(
        jt.eval_step(js, batches[EVAL], jt.new_metric_states()))
    out["pred"] = np.asarray(jt.predict_step(js, batches[EVAL]))
    return out


# ---------------------------------------------------------------- cases


def case_mesh_lines(parts):
    """Each axis's group is the line of ranks that share every other
    coordinate; the batch and the columns follow the coordinates."""
    for name, sizes in LINES.items():
        axes = list(sizes)
        grid = np.arange(4).reshape(tuple(sizes.values()))
        for r, p in enumerate(parts):
            coords = dict(zip(axes, p[f"{name}.coords"]))
            assert coords == dict(zip(axes, np.unravel_index(r, grid.shape)))
            for i, axis in enumerate(axes):
                line = np.moveaxis(grid, i, 0)[
                    (slice(None),) + tuple(coords[a] for a in axes
                                           if a != axis)]
                np.testing.assert_array_equal(p[f"{name}.line.{axis}"], line,
                                              err_msg=f"{name} {axis} {r}")
            assert str(p[f"{name}.data_axis"]) == "data"
            d = coords.get("data", 0)
            per = 8 // sizes.get("data", 1)
            np.testing.assert_array_equal(p[f"{name}.batch_block"],
                                          [d * per, (d + 1) * per])
            s = coords["seq"]
            np.testing.assert_array_equal(p[f"{name}.seq_block"],
                                          [16 * s, 16 * (s + 1)])


def case_runs_match_reference(parts, want):
    for name, (params, sizes, steps, _) in RUNS.items():
        w = want[name]
        np.testing.assert_allclose(parts[0][f"{name}.losses"], w["losses"],
                                   rtol=1e-4, err_msg=name)
        assert len(w["losses"]) == steps
        assert_params_close(whole(parts, name, 4, "param1"), w["params"][0],
                            name, 1)
        assert_params_close(whole(parts, name, 4), w["params"][-1], name,
                            steps)
        states, pred = w["states"], w["pred"]
        for p in parts:
            np.testing.assert_array_equal(
                p[f"{name}.eval.token_accuracy"],
                np.asarray(states["token_accuracy"]), err_msg=name)
            np.testing.assert_allclose(p[f"{name}.eval._loss"],
                                       np.asarray(states["_loss"]),
                                       rtol=5e-5, err_msg=name)
            np.testing.assert_allclose(p[f"{name}.pred"], pred, rtol=5e-5,
                                       atol=5e-5 * np.abs(pred).max(),
                                       err_msg=name)
        if "moe_experts" in params:
            for k, v in _aux_of(w["extra"]).items():
                for p in parts:
                    np.testing.assert_allclose(p[f"{name}.buffer.{k}"], v,
                                               rtol=1e-6, err_msg=k)
    # the split leaves are split: heads over model, experts over expert
    d, start, stop = parts[1]["ring_tp.shard.block_0.q.weight"]
    assert (d, stop - start) == (0, 32), (d, start, stop)
    d, start, stop = parts[1]["moe_seq_expert.shard.block_0.moe.w1"]
    assert (d, start, stop) == (0, 2, 4), (d, start, stop)
    assert "moe_data_seq.shard.block_0.moe.w1" not in parts[0]


def case_route_blocks_match_global():
    """2 x 2 (data, seq) blocks at capacity factor 0.5, in one process."""
    import jax
    import jax.numpy as jnp

    from elasticdl_tpu.ops.moe import switch_moe as reference_moe
    from elasticdl_tpu_torch.ops import moe

    r = np.random.RandomState(11)
    b, t, c, e, h = 8, 32, 16, 4, 32
    x = r.randn(b, t, c).astype(np.float32)
    ws = [r.randn(c, e).astype(np.float32)] + [
        (r.randn(*s) * 0.1).astype(np.float32)
        for s in ((e, c, h), (e, h), (e, h, c), (e, c))]
    tx, tws = torch.tensor(x), [torch.tensor(w) for w in ws]
    cf = 0.5
    whole_route = moe.route(tx.reshape(-1, c), tws[0], cf)
    assert int((~whole_route.keep).sum()) > 0     # tokens drop
    want_out, want_aux = jax.jit(reference_moe, static_argnums=(6,))(
        jnp.asarray(x.reshape(-1, c)), *map(jnp.asarray, ws), cf)
    want_out = np.asarray(want_out).reshape(b, t, c)
    order = np.arange(b * t).reshape(b, t)
    blocks = moe.blocks_local(tx, tws[0], 2, 2)
    assert len(blocks) == 4
    for i, (xb, blk) in enumerate(blocks):
        d, s = divmod(i, 2)
        rows, cols = slice(4 * d, 4 * d + 4), slice(16 * s, 16 * s + 16)
        sel = torch.from_numpy(order[rows, cols].reshape(-1))
        got = moe.route(xb, tws[0], cf, blk)
        assert got.cap == whole_route.cap == int(cf * b * t / e)
        assert torch.equal(got.pos, whole_route.pos[sel]), i
        assert torch.equal(got.keep, whole_route.keep[sel]), i
        assert float(got.aux) == pytest.approx(float(whole_route.aux),
                                               rel=1e-6)
        assert float(got.aux) == pytest.approx(float(want_aux), rel=1e-5)
        out, _ = moe.switch_moe(xb, *tws, capacity_factor=cf, blocks=blk)
        np.testing.assert_allclose(out.numpy(),
                                   want_out[rows, cols].reshape(-1, c),
                                   rtol=1e-5, atol=1e-6, err_msg=str(i))


def case_seq_beside_pp_raises():
    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.parallel import mesh as mesh_lib
    from elasticdl_tpu_torch.training.model_spec import ModelSpec
    from elasticdl_tpu_torch.training.trainer import Trainer

    mesh = mesh_lib.Mesh({"seq": 2, "pp": 2}, range(4), 0, {}, None)
    spec = lm_spec(TZOO, JobConfig, ModelSpec,
                   LM + ";pp_axis=pp;seq_parallel=none")
    with pytest.raises(NotImplementedError, match="hlo_instruction.cc:1585"):
        Trainer(spec, device="cpu", mesh=mesh)
    with pytest.raises(NotImplementedError, match="aborts inside XLA"):
        spec.model.pipeline.shard(mesh)
    # the reference's own check of the pipeline with a ring stays
    with pytest.raises(ValueError, match="seq_parallel='none'"):
        lm_spec(TZOO, JobConfig, ModelSpec, LM + ";pp_axis=pp")


def test_seq_beside_model_and_expert_against_the_reference(monkeypatch):
    """Every case above, in one collected test (ROADMAP.md, conventions:
    one collected test per port test file)."""
    import jax

    for k in COHORT_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.delenv("EDL_FLASH", raising=False)
    with tempfile.TemporaryDirectory() as workdir:
        batches, inputs = batch_inputs(EVAL + 1)
        trainers = reference_trainers(batches[0])
        for name, (_, _, _, init) in RUNS.items():
            if init == name:
                inputs.update(reference_inputs(name, trainers[name][1]))
        ranks = start_plan(workdir, PLAN, inputs, os.path.abspath(__file__))
        try:
            want = {}
            for name, (_, _, steps, init) in RUNS.items():
                jt, js = trainers[name]
                if init != name and RUNS[init][1] == RUNS[name][1]:
                    # where the reference's step leaves the state on this
                    # mesh (GSPMD moves pos_embed onto seq), so the second
                    # step reuses the first one's program
                    js = jax.device_put(js, want[init]["placed"])
                want[name] = reference_steps(jt, js, batches, steps)
            case_route_blocks_match_global()
            case_seq_beside_pp_raises()
        finally:
            wait_ranks(ranks, timeout_s=150)
        parts = rank_parts(workdir)
        case_mesh_lines(parts)
        case_runs_match_reference(parts, want)


if __name__ == "__main__" and sys.argv[1] == "ranks":
    run_ranks(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5],
              probes={"lines": probe_lines})
