"""The port's GPipe pipeline (`parallel/pipeline.py`) and the pipelined LM
against the reference, on the CPU.

Four gloo ranks run the plan below (the harness of
`tests/test_torch_lm_parallel.py`); the reference runs in-process.

- `gpipe` on {pp 2} and {pp 4}, for M in {1, 2, 4} microbatches, against
  the reference's sequential fold of the same stages
  (`tests/test_pipeline.py`'s relu stage and params, its first S
  stages): the output on every pp rank rtol 1e-5, and the gradient of
  sum(out ** 2) with respect to each stage's params (on that stage's
  rank) rtol 1e-4 with atol 1e-6, as `tests/test_pipeline.py:44-69` holds
  them; every rank's gradient of the stages it does not hold is 0.
- Its error cases: a batch that M does not divide, a stack of stages that
  is neither the axis's size nor 1, a `PipelinedBlocks` whose layers do
  not match the axis, and the LM's own checks (pp with tp, with dropout,
  with sequence parallelism).
- The pipelined LM (2 layers, `pp_axis=pp`, `pp_microbatches=2`, float32)
  on {data 2, pp 2}, against the reference's no-pp step on {data 2} (its
  sequential fold): three AdamW steps' losses rtol 1e-4 (the reference's
  own pipeline check holds the loss to rel 1e-4), the params after the
  first and the third step as `tests/test_torch_lm_parallel.
  assert_params_close` holds them, replicas equal bit for bit, then
  eval and predict on every rank (token accuracy equal, the loss pair
  and the logits rtol 5e-5); the same
  with `grad_accum=2` against the reference's accumulation; and with
  remat, whose recompute replays the pipeline's messages, bit for bit
  the run without it.
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
    LM,
    STEPS,
    assert_params_close,
    batch_inputs,
    init_inputs,
    rank_parts,
    reference_run,
    run_ranks,
    start_plan,
    wait_ranks,
    whole,
)

PP_LM = LM + ";pp_axis=pp;pp_microbatches=2"
MESH = {"data": 2, "pp": 2}
MICRO = (1, 2, 4)
PLAN = [
    {"name": "gpipe2", "sizes": {"pp": 2}, "probe": "gpipe"},
    {"name": "gpipe4", "sizes": {"pp": 4}, "probe": "gpipe"},
    {"name": "pp", "params": PP_LM, "sizes": MESH, "init": "pp",
     "steps": STEPS, "eval": STEPS},
    {"name": "pp_accum", "params": PP_LM, "sizes": MESH, "init": "pp_accum",
     "steps": STEPS, "accum": 2},
    {"name": "pp_remat", "params": PP_LM, "sizes": MESH, "init": "pp",
     "steps": STEPS, "remat": True},
]


def stage_inputs():
    from tests.test_pipeline import make_params

    params = {k: np.asarray(v) for k, v in make_params().items()}
    x = np.random.RandomState(1).randn(8, 8).astype(np.float32)
    return params, x


def torch_stage(p, a):
    return torch.relu(a @ p["w"] + p["b"])


def probe_gpipe(mesh, tr, state, tree, name):
    """gpipe's output and stage-param gradients for each M, from the full
    stack of the axis's stages (this rank takes its own)."""
    from elasticdl_tpu_torch.parallel import pipeline

    params, x = stage_inputs()
    s = mesh.shape["pp"]
    out = {}
    for m in MICRO:
        p = {k: torch.tensor(v[:s], requires_grad=True)
             for k, v in params.items()}
        y = pipeline.gpipe(torch_stage, p, torch.tensor(x),
                           num_microbatches=m, mesh=mesh)
        (y ** 2).sum().backward()
        out[f"{name}.m{m}.out"] = y.detach().numpy()
        for k, v in p.items():
            out[f"{name}.m{m}.grad.{k}"] = v.grad.numpy()
    out[f"{name}.stage"] = np.array(pipeline.stage_index(mesh))
    return out


def reference_folds():
    """The reference's sequential fold of the first S stages: {S: (out,
    {param: grad})}."""
    import jax
    import jax.numpy as jnp

    from tests.test_pipeline import stage

    params, x = stage_inputs()
    want = {}
    for s in (2, 4):
        p = {k: jnp.asarray(v[:s]) for k, v in params.items()}

        def fold(p):
            a = jnp.asarray(x)
            for i in range(s):
                a = stage(jax.tree_util.tree_map(lambda l: l[i], p), a)
            return a

        grads = jax.grad(lambda p: jnp.sum(fold(p) ** 2))(p)
        want[s] = (np.asarray(fold(p)),
                   {k: np.asarray(v) for k, v in grads.items()})
    return want


def case_gpipe_matches_sequential_fold(parts, want):
    for s in (2, 4):
        out, grads = want[s]
        for m in MICRO:
            for r, part in enumerate(parts[:s]):
                key = f"gpipe{s}.m{m}"
                np.testing.assert_allclose(part[f"{key}.out"], out,
                                           rtol=1e-5, err_msg=key)
                stage = int(part[f"gpipe{s}.stage"])
                assert stage == r
                for k, g in grads.items():
                    got = part[f"{key}.grad.{k}"]
                    np.testing.assert_allclose(got[stage], g[stage],
                                               rtol=1e-4, atol=1e-6,
                                               err_msg=f"{key} {k}")
                    others = np.delete(got, stage, axis=0)
                    assert not others.any(), (key, k)


def case_error_cases():
    from elasticdl_tpu_torch.model_zoo.transformer import transformer_lm as lm
    from elasticdl_tpu_torch.parallel import pipeline
    from elasticdl_tpu_torch.parallel.mesh import Mesh

    params, _ = stage_inputs()
    p = {k: torch.tensor(v) for k, v in params.items()}
    pp4 = Mesh({"pp": 4}, range(4), 0, groups={}, world=None)
    with pytest.raises(ValueError, match="divisible"):
        pipeline.gpipe(torch_stage, p, torch.zeros((6, 8)),
                       num_microbatches=4, mesh=pp4)
    pp2 = Mesh({"pp": 2}, range(2), 0, groups={}, world=None)
    with pytest.raises(ValueError, match="must match"):
        pipeline.gpipe(torch_stage, p, torch.zeros((8, 8)),
                       num_microbatches=4, mesh=pp2)
    model = lm.custom_model(num_layers=4, pp_axis="pp", seq_parallel="none")
    with pytest.raises(ValueError, match="must match"):
        model.pipeline.shard(pp2)
    with pytest.raises(ValueError, match="mutually exclusive"):
        lm.custom_model(pp_axis="pp", tp_axis="model", seq_parallel="none")
    for kw, msg in (({"dropout": 0.1, "seq_parallel": "none"}, "dropout"),
                    ({"seq_parallel": "ring"}, "seq_parallel")):
        with pytest.raises(ValueError, match=msg):
            lm.custom_model(pp_axis="pp", **kw)


def case_pipelined_lm_matches_reference(parts, want):
    for run in ("pp", "pp_accum"):
        w = want[run]
        np.testing.assert_allclose(parts[0][f"{run}.losses"], w["losses"],
                                   rtol=1e-4, err_msg=run)
        assert_params_close(whole(parts, run, 4, "param1"), w["first"], run,
                            1)
        assert_params_close(whole(parts, run, 4), w["params"], run, STEPS)
    states, pred = want["pp"]["states"], want["pp"]["pred"]
    for p in parts:
        np.testing.assert_array_equal(p["pp.eval.token_accuracy"],
                                      np.asarray(states["token_accuracy"]))
        np.testing.assert_allclose(p["pp.eval._loss"],
                                   np.asarray(states["_loss"]), rtol=5e-5)
        np.testing.assert_allclose(p["pp.pred"], pred, rtol=5e-5,
                                   atol=5e-5 * np.abs(pred).max())
    d, start, stop = parts[1]["pp.shard.pipeline.wq"]
    assert (d, start, stop) == (0, 1, 2)
    assert parts[1]["pp.param.pipeline.wq"].shape == (1, 64, 64)
    np.testing.assert_array_equal(parts[0]["pp_remat.losses"],
                                  parts[0]["pp.losses"])
    remat, plain = whole(parts, "pp_remat", 4), whole(parts, "pp", 4)
    for k, v in plain.items():
        np.testing.assert_array_equal(remat[k], v, err_msg=k)


def test_pipeline_against_the_reference(monkeypatch):
    """Every case above, in one collected test (ROADMAP.md, conventions:
    one collected test per port test file)."""
    for k in COHORT_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.delenv("EDL_FLASH", raising=False)
    with tempfile.TemporaryDirectory() as workdir:
        batches, inputs = batch_inputs(STEPS + 1)
        want = {"pp": reference_run(PP_LM, {"data": 2}, batches, STEPS,
                                    eval_batch=batches[STEPS]),
                "pp_accum": reference_run(PP_LM, {"data": 2}, batches, STEPS,
                                          accum=2)}
        for run, w in want.items():
            inputs.update(init_inputs(run, w))
        ranks = start_plan(workdir, PLAN, inputs, os.path.abspath(__file__))
        try:
            folds = reference_folds()
            case_error_cases()
        finally:
            wait_ranks(ranks, timeout_s=120)
        parts = rank_parts(workdir)
        case_gpipe_matches_sequential_fold(parts, folds)
        case_pipelined_lm_matches_reference(parts, want)


if __name__ == "__main__" and sys.argv[1] == "ranks":
    run_ranks(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5],
              probes={"gpipe": probe_gpipe})
