"""The ported transformer LM train step against the reference, on the CPU.

Both packages build the LM (`vocab=64;num_layers=2;dim=64;heads=4;
max_len=64`, T=32, B=8, a mask with zeros) through their own
`JobConfig -> ModelSpec -> Trainer`; the reference runs on a one-device
mesh. The port starts from the reference's initial params, carried across
by `convert.params_from_flax`, and its attention runs the plain versions
of the flash kernels.

The fast cases hold the port to the reference's materialized attention
(its CPU default): in float32 that path computes the kernels' function
and only the summation order differs, since rounding p to v's dtype is a
no-op there. Tolerances, float32: logits and loss rtol 5e-5; every
gradient rtol 5e-5 with atol 5e-5 of its largest value (entries that
cancel to ~0 carry only rounding); three AdamW steps' losses rtol 1e-4
(Adam's m / (sqrt(v) + eps) magnifies rounding in gradients near 0);
eval's token accuracy equal and its loss rtol 5e-5. In bfloat16 the
reference's materialized path rounds p to bf16 before the PV product, the
flash contract keeps p in float32, and the two libraries round their bf16
matmuls differently; measured here, that moves the logits by ~0.7% of
their rms (at most ~0.9% of their largest value), each parameter's
gradient by at most ~2% of its norm and the loss by ~6e-5. So bfloat16 is
held to: logits atol 2e-2 of their largest value, loss rtol 1e-3, each
gradient's error norm within 5e-2 of its norm (the k biases, ~0 in exact
arithmetic, excepted). Scaling v by 1.05 inside attention breaks all
three.

One case runs the reference through its Pallas kernels in interpret mode
(`interpret_mode()` with EDL_FLASH=1) and holds the port to it with the
float32 tolerances.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from elasticdl_tpu.common.config import JobConfig as JJobConfig
from elasticdl_tpu.ops import pallas_attention as jflash
from elasticdl_tpu.parallel.mesh import build_mesh
from elasticdl_tpu.training.model_spec import ModelSpec as JModelSpec
from elasticdl_tpu.training.trainer import (
    Trainer as JTrainer, _masked_scalar_loss as j_masked_loss)
from elasticdl_tpu_torch import convert
from elasticdl_tpu_torch.common.config import JobConfig
from elasticdl_tpu_torch.training.model_spec import ModelSpec
from elasticdl_tpu_torch.training.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = "vocab=64;num_layers=2;dim=64;heads=4;max_len=64"
B, T, V = 8, 32, 64


def _spec(zoo_root, cfg_cls, spec_cls, dtype):
    """Build a ModelSpec from one zoo root. Both zoos name their module
    `transformer.transformer_lm`, so the load runs with that root first on
    sys.path and any cached `transformer` modules set aside, then
    restored."""
    def ours(k):
        return k == "transformer" or k.startswith("transformer.")

    saved = {k: sys.modules.pop(k) for k in [k for k in sys.modules
                                             if ours(k)]}
    path = list(sys.path)
    try:
        sys.path.insert(0, zoo_root)
        cfg = cfg_cls.from_argv([
            "--model_zoo", zoo_root, "--model_def",
            "transformer.transformer_lm.custom_model", "--model_params",
            PARAMS, "--compute_dtype", dtype])
        return spec_cls.from_config(cfg)
    finally:
        for k in [k for k in sys.modules if ours(k)]:
            del sys.modules[k]
        sys.modules.update(saved)
        sys.path[:] = path


def _batch(seed):
    r = np.random.RandomState(seed)
    toks = r.randint(0, V, (B, T + 1)).astype(np.int32)
    mask = np.ones((B,), np.float32)
    mask[r.choice(B, 2, replace=False)] = 0.0
    return {"features": toks[:, :-1], "labels": toks[:, 1:], "mask": mask}


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

    def reference_grads(self, batch):
        def jloss(params):
            out = self.jspec.model.apply({"params": params},
                                         batch["features"], training=True)
            return j_masked_loss(self.jspec.loss, batch["labels"], out,
                                 batch["mask"])

        loss, grads = jax.jit(jax.value_and_grad(jloss))(self.js.params)
        return float(loss), convert.params_from_flax(jax.device_get(grads))


def _assert_grads_close(got, want):
    """rtol 5e-5 with atol 5e-5 of each gradient's largest value. The
    gradient of each block's k bias is 0 in exact arithmetic (it adds the
    same q . b to every score of a row, which softmax ignores), so both
    sides hold only rounding there: each is held within 1e-6 of the
    model's largest gradient entry of 0 instead."""
    assert set(got) == set(want)
    largest = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for name, g in got.items():
        w = want[name].numpy()
        if name.endswith(".k.bias"):
            for x in (g.numpy(), w):
                assert np.abs(x).max() <= 1e-6 * largest, name
            continue
        np.testing.assert_allclose(g.numpy(), w, rtol=5e-5,
                                   atol=5e-5 * np.abs(w).max(), err_msg=name)


def case_f32_logits_loss_and_grads(p):
    batch = _batch(1)
    want = np.asarray(p.jt.predict_step(p.js, batch))
    got = p.tt.predict_step(p.ts, batch).numpy()
    assert got.shape == (B, T, V) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=5e-5,
                               atol=5e-5 * np.abs(want).max())
    jl, jg = p.reference_grads(batch)
    tl, tg = p.tt.compute_grads(p.ts, batch)
    np.testing.assert_allclose(float(tl), jl, rtol=5e-5)
    _assert_grads_close(tg, jg)


def case_f32_three_adamw_steps_then_eval(p):
    jlosses, tlosses = [], []
    for i in range(3):
        batch = _batch(10 + i)
        p.js, jlogs = p.jt.train_step(p.js, batch)
        p.ts, tlogs = p.tt.train_step(p.ts, batch)
        jlosses.append(float(jlogs["loss"]))
        tlosses.append(float(tlogs["loss"]))
    assert p.ts.step == p.ts.model_version == 3
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)

    batch = _batch(20)
    jstates = p.jt.eval_step(p.js, batch, p.jt.new_metric_states())
    tstates = p.tt.eval_step(p.ts, batch, p.tt.new_metric_states())
    assert set(tstates) == set(jstates) == {"token_accuracy", "_loss"}
    np.testing.assert_array_equal(tstates["token_accuracy"],
                                  np.asarray(jstates["token_accuracy"]))
    np.testing.assert_allclose(tstates["_loss"], np.asarray(jstates["_loss"]),
                               rtol=5e-5)
    jres, tres = p.jt.metric_results(jstates), p.tt.metric_results(tstates)
    assert tres["token_accuracy"] == jres["token_accuracy"]


def case_bf16_logits_loss_and_grads():
    p = Pair("bfloat16")
    batch = _batch(3)
    want = np.asarray(p.jt.predict_step(p.js, batch), np.float32)
    got = p.tt.predict_step(p.ts, batch).numpy()
    assert got.shape == (B, T, V) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-2 * np.abs(want).max())
    jl, jg = p.reference_grads(batch)
    tl, tg = p.tt.compute_grads(p.ts, batch)
    np.testing.assert_allclose(float(tl), jl, rtol=1e-3)
    assert set(tg) == set(jg)
    for name, g in tg.items():
        if not name.endswith(".k.bias"):
            w = jg[name].to(torch.float32)
            err = float((g.to(torch.float32) - w).norm() / w.norm())
            assert err <= 5e-2, (name, err)


def case_f32_grads_against_the_pallas_kernels(p):
    """The reference's attention through its Pallas kernels (interpret
    mode); a spy on `_flash_fwd` proves it took that path."""
    calls = []
    real = jflash._flash_fwd

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)

    batch = _batch(4)
    with pytest.MonkeyPatch.context() as mp, jflash.interpret_mode():
        mp.setenv("EDL_FLASH", "1")
        mp.setattr(jflash, "_flash_fwd", spy)
        jl, jg = p.reference_grads(batch)
    assert calls and all(c["interpret"] for c in calls)
    tl, tg = p.tt.compute_grads(p.ts, batch)
    np.testing.assert_allclose(float(tl), jl, rtol=5e-5)
    _assert_grads_close(tg, jg)


def case_convert_rejects_stray_and_missing_keys(p):
    params = jax.device_get(p.js.params)
    bad = dict(params, stray={"kernel": np.zeros((2, 2))})
    with pytest.raises(ValueError, match="stray"):
        convert.params_from_flax(bad)
    bad = {k: v for k, v in params.items() if k != "block_1"}
    bad["block_2"] = params["block_1"]
    with pytest.raises(ValueError, match="block"):
        convert.params_from_flax(bad)
    bad = dict(params, block_0=dict(params["block_0"]))
    del bad["block_0"]["LayerNorm_1"]
    with pytest.raises(ValueError, match="missing"):
        convert.params_from_flax(bad)
    bad = dict(params, pos_embed=np.zeros((32, 64), np.float32))
    with pytest.raises(ValueError, match="shape"):
        convert.params_from_flax(bad, p.tt.model)


def case_unported_parallel_options_raise():
    from elasticdl_tpu_torch.model_zoo.transformer import transformer_lm as lm

    with pytest.raises(ValueError, match="mutually exclusive"):
        lm.custom_model(tp_axis="model", pp_axis="pp")
    for kw in ({"tp_axis": "model"}, {"moe_experts": 4},
               {"pp_axis": "pp", "seq_parallel": "none"}):
        with pytest.raises(NotImplementedError, match="17 and 23"):
            lm.custom_model(**kw)


def test_transformer_lm_against_the_reference():
    """Every case above, in one collected test (ROADMAP.md, conventions:
    one collected test per port test file)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("EDL_FLASH", raising=False)
        p = Pair()
        case_f32_logits_loss_and_grads(p)
        case_f32_grads_against_the_pallas_kernels(p)
        case_convert_rejects_stray_and_missing_keys(p)
        case_f32_three_adamw_steps_then_eval(p)
        case_bf16_logits_loss_and_grads()
    case_unported_parallel_options_raise()
