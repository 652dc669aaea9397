"""The ported DeepFM train step against the reference, on the CPU.

Both packages build DeepFM (`field_vocab=1000`, `hidden=32,32`) through
their own `JobConfig -> ModelSpec -> Trainer`; the reference runs on a
one-device mesh with the exact embedding backward
(`EDL_EMB_SCATTER=sorted`). The port starts from the reference's
initial params, carried across by `convert.params_from_flax`.

Tolerances, in float32 compute: outputs and loss rtol 1e-5; gradients
rtol 1e-5 with atol 1e-6 of each gradient's largest value (entries that
cancel to ~0 carry only rounding); five Adam steps' losses rtol 1e-4
(Adam's m / (sqrt(v) + eps) magnifies rounding in gradients near 0 up to
the learning rate). In bfloat16 compute the DNN tower rounds to 8
mantissa bits (~4e-3 relative per rounding) at every layer, and the two
libraries' bf16 matmuls may round a product to the neighbouring bf16
value, so outputs are held to 1e-3 of the logits' scale instead (the
tower is a fraction of the logit; measured ~3e-7 at init).
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from elasticdl_tpu.common.config import JobConfig as JJobConfig
from elasticdl_tpu.parallel.mesh import build_mesh
from elasticdl_tpu.training.model_spec import ModelSpec as JModelSpec
from elasticdl_tpu.training.trainer import (
    Trainer as JTrainer, _masked_scalar_loss as j_masked_loss)
from elasticdl_tpu_torch import convert
from elasticdl_tpu_torch.common.config import JobConfig
from elasticdl_tpu_torch.training import lr_modulation
from elasticdl_tpu_torch.training.model_spec import ModelSpec
from elasticdl_tpu_torch.training.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = "field_vocab=1000;hidden=32,32"
B = 128


def _spec(zoo_root, cfg_cls, spec_cls, dtype):
    """Build a ModelSpec from one zoo root. Both zoos name their module
    `deepfm.deepfm`, so the load runs with that root first on sys.path and
    any cached `deepfm` modules set aside, then restored."""
    names = [k for k in sys.modules if k == "deepfm" or k.startswith("deepfm.")]
    saved = {k: sys.modules.pop(k) for k in names}
    path = list(sys.path)
    try:
        sys.path.insert(0, zoo_root)
        cfg = cfg_cls.from_argv([
            "--model_zoo", zoo_root, "--model_def",
            "deepfm.deepfm.custom_model", "--model_params", PARAMS,
            "--compute_dtype", dtype])
        return spec_cls.from_config(cfg)
    finally:
        for k in [k for k in sys.modules
                  if k == "deepfm" or k.startswith("deepfm.")]:
            del sys.modules[k]
        sys.modules.update(saved)
        sys.path[:] = path


def _batch(seed):
    r = np.random.RandomState(seed)
    return {
        "features": {
            "dense": (r.rand(B, 13) * 20).astype(np.float32),
            "cat": r.randint(0, 1 << 30, (B, 26)).astype(np.int32),
        },
        "labels": r.randint(0, 2, (B,)).astype(np.int32),
        "mask": (r.rand(B) > 0.1).astype(np.float32),
    }


class Pair:
    """The reference's and the port's trainers, starting from the same
    params."""

    def __init__(self, dtype="float32"):
        self.jspec = _spec(os.path.join(REPO, "model_zoo"),
                           JJobConfig, JModelSpec, dtype)
        self.tspec = _spec(
            os.path.join(REPO, "elasticdl_tpu_torch", "model_zoo"),
            JobConfig, ModelSpec, dtype)
        self.jt = JTrainer(self.jspec, build_mesh(devices=jax.devices()[:1]))
        self.tt = Trainer(self.tspec, device="cpu")
        example = _batch(0)
        self.js = self.jt.init_state(example)
        self.ts = self.tt.init_state(example)
        params = jax.device_get(self.js.params)
        self.tt.model.load_state_dict(
            convert.params_from_flax(params, self.tt.model))


def case_forward_and_loss_parity_f32():
    p = Pair()
    batch = _batch(1)
    want = np.asarray(p.jt.predict_step(p.js, batch))
    got = p.tt.predict_step(p.ts, batch).numpy()
    assert got.shape == (B,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    jloss = float(j_masked_loss(p.jspec.loss, batch["labels"], want,
                                batch["mask"]))
    tloss, _ = p.tt.compute_grads(p.ts, batch)
    np.testing.assert_allclose(float(tloss), jloss, rtol=1e-5)


def case_forward_parity_bf16():
    p = Pair("bfloat16")
    assert p.tt.model.compute_dtype == torch.bfloat16
    batch = _batch(2)
    want = np.asarray(p.jt.predict_step(p.js, batch))
    got = p.tt.predict_step(p.ts, batch).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-3)


def case_gradient_parity_f32():
    p = Pair()
    batch = _batch(3)

    def jloss(params):
        out = p.jspec.model.apply({"params": params}, batch["features"],
                                  training=True)
        return j_masked_loss(p.jspec.loss, batch["labels"], out,
                             batch["mask"])

    jl, jg = jax.jit(jax.value_and_grad(jloss))(p.js.params)
    want = convert.params_from_flax(jax.device_get(jg))
    tl, got = p.tt.compute_grads(p.ts, batch)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name].numpy()
        np.testing.assert_allclose(
            g.numpy(), w, rtol=1e-5, atol=1e-6 * np.abs(w).max(),
            err_msg=name)


def case_five_adam_steps_eval_and_predict():
    p = Pair()
    jlosses, tlosses = [], []
    for i in range(5):
        batch = _batch(10 + i)
        p.js, jlogs = p.jt.train_step(p.js, batch)
        p.ts, tlogs = p.tt.train_step(p.ts, batch)
        jlosses.append(float(jlogs["loss"]))
        tlosses.append(float(tlogs["loss"]))
    assert p.ts.step == p.ts.model_version == 5
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)

    batch = _batch(20)
    jstates = p.jt.eval_step(p.js, batch, p.jt.new_metric_states())
    tstates = p.tt.eval_step(p.ts, batch, p.tt.new_metric_states())
    assert set(tstates) == set(jstates) == {"auc", "accuracy", "_loss"}
    for k in ("auc", "accuracy"):
        np.testing.assert_array_equal(tstates[k], np.asarray(jstates[k]),
                                      err_msg=k)
    np.testing.assert_allclose(tstates["_loss"], np.asarray(jstates["_loss"]),
                               rtol=1e-4)
    jres = p.jt.metric_results(jstates)
    tres = p.tt.metric_results(tstates)
    assert tres["auc"] == jres["auc"] and tres["accuracy"] == jres["accuracy"]
    np.testing.assert_allclose(tres["loss"], jres["loss"], rtol=1e-4)
    np.testing.assert_allclose(
        p.tt.predict_step(p.ts, batch).numpy(),
        np.asarray(p.jt.predict_step(p.js, batch)), rtol=1e-4, atol=1e-5)


def case_set_learning_rate_takes_effect():
    spec = _spec(os.path.join(REPO, "elasticdl_tpu_torch", "model_zoo"),
                 JobConfig, ModelSpec, "float32")
    tr = Trainer(spec, device="cpu")
    state = tr.init_state(_batch(0))
    assert lr_modulation.get_learning_rate(state.optimizer) == 1e-3
    before = {k: v.detach().clone() for k, v in state.params.items()}
    state = tr.set_learning_rate(state, 0.0)
    assert lr_modulation.get_learning_rate(state.optimizer) == 0.0
    state, _ = tr.train_step(state, _batch(1))
    for k, v in state.params.items():
        assert torch.equal(v.detach(), before[k]), k
    state = tr.set_learning_rate(state, 1e-2)
    state, _ = tr.train_step(state, _batch(1))
    moved = (state.params["dnn_0.weight"].detach()
             - before["dnn_0.weight"]).abs().max()
    assert float(moved) > 1e-3
    with pytest.raises(KeyError):
        lr_modulation.set_hyperparam(state.optimizer, "momentum_decay", 0.1)


def case_convert_rejects_bad_keys_and_shapes():
    spec = _spec(os.path.join(REPO, "elasticdl_tpu_torch", "model_zoo"),
                 JobConfig, ModelSpec, "float32")
    model = spec.model
    r = np.random.RandomState(0)

    def good():
        return {
            "fm_embedding": {"table": r.rand(26112, 17)},
            "dense_linear": {"kernel": r.rand(13, 1), "bias": r.rand(1)},
            "dnn_0": {"kernel": r.rand(429, 32), "bias": r.rand(32)},
            "dnn_1": {"kernel": r.rand(32, 32), "bias": r.rand(32)},
            "dnn_out": {"kernel": r.rand(32, 1), "bias": r.rand(1)},
            "bias": r.rand(1),
        }

    sd = convert.params_from_flax({"params": good()}, model)
    assert sd["dnn_0.weight"].shape == (32, 429)
    model.load_state_dict(sd)

    bad = good()
    bad["extra"] = {"kernel": r.rand(2, 2)}
    with pytest.raises(ValueError, match="extra"):
        convert.params_from_flax(bad)
    bad = good()
    del bad["dnn_out"]
    with pytest.raises(ValueError, match="dnn_out"):
        convert.params_from_flax(bad)
    bad = good()
    del bad["dnn_1"]["bias"]
    with pytest.raises(ValueError, match="missing"):
        convert.params_from_flax(bad)
    bad = good()
    bad["dnn_0"]["bias"] = r.rand(31)
    with pytest.raises(ValueError, match="does not match"):
        convert.params_from_flax(bad)
    bad = good()
    bad["fm_embedding"]["table"] = r.rand(26000, 17)      # unpadded rows
    with pytest.raises(ValueError, match="shape"):
        convert.params_from_flax(bad, model)
    bad = good()
    bad["dnn_2"] = {"kernel": r.rand(32, 32), "bias": r.rand(32)}
    with pytest.raises(ValueError, match="missing"):
        convert.params_from_flax(bad, model)


def case_job_config_parses_like_the_reference(argv):
    got = JobConfig.from_argv(argv)
    want = JJobConfig.from_argv(argv)
    for f in ("model_zoo", "model_def", "model_params", "compute_dtype",
              "loss", "optimizer", "dataset_fn", "eval_metrics_fn",
              "prediction_outputs_processor"):
        assert getattr(got, f) == getattr(want, f), f
    # the port's JobConfig is the reference's whole one (a copy since the
    # job path): both reject a flag neither knows
    for cls in (JobConfig, JJobConfig):
        with pytest.raises(ValueError, match="Unknown flags"):
            cls.from_argv(["--no_such_flag", "2"])


def case_lr_rules_match_the_reference():
    from elasticdl_tpu.training import lr_modulation as jlr

    for alive, base in ((1, 4), (4, 4), (8, 4), (0, 0)):
        assert lr_modulation.linear_scale(0.1, alive, base) == \
            jlr.linear_scale(0.1, alive, base)
    for staleness in (-1, 0, 3):
        assert lr_modulation.staleness_modulation(0.1, staleness, 0.5) == \
            jlr.staleness_modulation(0.1, staleness, 0.5)


def case_apply_learning_rate_tolerates_an_optimizer_without_one():
    class NoLR(torch.optim.Optimizer):
        def __init__(self, params):
            super().__init__(params, {"momentum": 0.9})

    spec = _spec(os.path.join(REPO, "elasticdl_tpu_torch", "model_zoo"),
                 JobConfig, ModelSpec, "float32")
    spec.optimizer = NoLR
    tr = Trainer(spec, device="cpu")
    state = tr.init_state(_batch(0))
    assert lr_modulation.apply_learning_rate(tr, state, 0.5) is state
    assert lr_modulation.get_learning_rate(state.optimizer) is None
    spec.optimizer = lr_modulation.modulated(torch.optim.SGD,
                                             learning_rate=0.1)
    state = tr.init_state(_batch(0))
    lr_modulation.apply_learning_rate(tr, state, 0.5)
    assert lr_modulation.get_learning_rate(state.optimizer) == 0.5


def test_deepfm_against_the_reference():
    """Every case above, in one collected test (ROADMAP.md, conventions:
    one collected test per port test file). The reference runs the exact
    sorted embedding backward."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("EDL_EMB_SCATTER", "sorted")
        case_forward_and_loss_parity_f32()
        case_forward_parity_bf16()
        case_gradient_parity_f32()
        case_five_adam_steps_eval_and_predict()
    case_set_learning_rate_takes_effect()
    case_convert_rejects_bad_keys_and_shapes()
    for argv in (
        [],
        ["--model_def", "deepfm.deepfm.custom_model", "--model_params",
         "field_vocab=100000;hidden=400,400;learning_rate=0.5;flag=true"],
        ["--compute_dtype", "float32", "--loss", "loss", "--optimizer",
         "optimizer", "--eval_metrics_fn", "eval_metrics_fn"],
    ):
        case_job_config_parses_like_the_reference(argv)
    case_lr_rules_match_the_reference()
    case_apply_learning_rate_tolerates_an_optimizer_without_one()
