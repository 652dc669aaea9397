"""The port's trainer knobs against the reference's, on the CPU: gradient
accumulation, remat policies and grouped steps (`train_many`,
`eval_many`, `predict_many`).

Each case starts both packages from one state: the reference's initial
params, carried across by `convert.params_from_flax`. Inputs come from
numpy with fixed seeds. The reference runs on a one-device mesh with the
exact embedding backward (`EDL_EMB_SCATTER=sorted`).

- Accumulation (twin of `tests/test_trainer.py::test_grad_accum_matches_
  full_batch`): DeepFM in float32 with SGD 0.1, batch 32 with its last 8
  rows masked (all the padding in the last of 4 micro-batches). The port's
  K=4 step against the reference's K=4 step and against its own K=1
  step: params rtol 2e-5, atol 2e-6 (the reference's own bound; with SGD
  the parameter delta is -0.1 x the gradient, so this holds the
  gradients), loss rel 1e-5. K=0 raises at construction and K=5 (which
  does not divide 32) at the step; a scalar loss warns once
  (`test_scalar_loss_with_grad_accum_warns_once`).
- Remat policies (twin of `test_remat_policies`): the matmuls dispatched
  in one forward and backward, counted with a TorchDispatchMode: `nothing`
  recomputes the forward's, so more than the plain step; `dots` saves
  them, so fewer than `nothing`. Loss and gradients equal the plain
  step's bit for bit (the recompute runs the same CPU ops on the same
  inputs), which `tests/test_torch_deepfm.py` holds to the reference's.
  An unknown name raises.
- Remat with dropout: the small LM with dropout 0.1, two steps. Remat's
  gradients and losses equal the plain step's bit for bit, which holds
  only if the recompute draws the forward's dropout masks again from the
  trainer's generator, and the generator ends each step where the plain
  step leaves it. The flash forward runs twice a layer (forward and
  recompute) and the backward reads the recompute's out and lse. A tiny
  model with generator noise after its last saved tensor (which a
  recompute that stops early never redraws) keeps equal losses over 3
  steps only if the generator is put back after the backward.
- Remat with accumulation through the flash path (twin of
  `tests/test_transformer_lm.py::test_remat_accum_with_flash_kernel`):
  the small LM, `dots` + accumulation 2 against the plain step, first
  loss rel 1e-4, with the flash forward run in each micro-batch's
  forward and again in its recompute. Against the reference's `dots` +
  accumulation 2 step: loss rel 1e-4, params rtol 1e-4 with atol 1e-5
  after one AdamW step, the k biases (gradient 0 in exact arithmetic)
  within the learning rate of 0. The reference runs its materialized attention
  there: its Pallas kernels run on the CPU only in interpret mode, and
  `jax.checkpoint` refuses interpret mode's callbacks on this jax.
- Grouped steps (twins of `test_train_many_matches_stepwise`,
  `test_eval_many_matches_stepwise`, `test_predict_many_matches_
  stepwise`): DeepFM with the zoo's Adam. `train_many`, `eval_many` and
  `predict_many` equal K single steps of the port bit for bit (params,
  Adam's slots, losses, metric states, outputs). Against the reference's
  `*_many`: params and losses rtol 1e-4, atol 1e-5 after 3 Adam steps
  (the DeepFM step test's bound: Adam's m / (sqrt(v) + eps) magnifies
  rounding in gradients near 0 up to the learning rate), metric results
  rtol 1e-5, outputs rtol 1e-5 with atol 1e-6 (forward parity).
"""

import contextlib
import logging
import os
import sys

import jax
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from elasticdl_tpu.common.config import JobConfig as JJobConfig
from elasticdl_tpu.common.model_utils import load_module as jload_module
from elasticdl_tpu.parallel.mesh import build_mesh, shard_batch_stack
from elasticdl_tpu.training.model_spec import ModelSpec as JModelSpec
from elasticdl_tpu.training.trainer import Trainer as JTrainer
from elasticdl_tpu_torch import convert
from elasticdl_tpu_torch.common.config import JobConfig
from elasticdl_tpu_torch.common.model_utils import load_module
from elasticdl_tpu_torch.ops import flash_attention as fa
from elasticdl_tpu_torch.training import trainer as trainer_mod
from elasticdl_tpu_torch.training.model_spec import ModelSpec
from elasticdl_tpu_torch.training.trainer import Trainer, stack_batches

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JZOO = os.path.join(REPO, "model_zoo")
TZOO = os.path.join(REPO, "elasticdl_tpu_torch", "model_zoo")
DEEPFM = "field_vocab=1000;hidden=32,32"
LM = "vocab=64;num_layers=2;dim=64;heads=4;max_len=64"
LM1 = "vocab=64;num_layers=1;dim=64;heads=4;max_len=64"
MATMULS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
           torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default}


@contextlib.contextmanager
def zoo(root, package):
    """Both zoos name their modules `deepfm.deepfm` and
    `transformer.transformer_lm`: load with `root` first on sys.path and
    the other zoo's cached modules set aside."""
    def ours(k):
        return k == package or k.startswith(package + ".")

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


def _specs(model_def, params, dtype="float32", roots=(JZOO, TZOO)):
    """ModelSpecs from the zoo defaults: (the reference's, the port's) by
    default. Each spec holds a model of its own: trainers built on one
    spec share its parameters."""
    package = model_def.split(".")[0]
    out = []
    for root, cfg_cls, spec_cls in ((r, *{JZOO: (JJobConfig, JModelSpec),
                                          TZOO: (JobConfig, ModelSpec)}[r])
                                    for r in roots):
        with zoo(root, package):
            out.append(spec_cls.from_config(cfg_cls.from_argv([
                "--model_zoo", root, "--model_def", model_def,
                "--model_params", params, "--compute_dtype", dtype])))
    return out


def _sgd_specs():
    """DeepFM in float32 with SGD 0.1 in both packages."""
    out = []
    for root, load, spec_cls, opt in (
            (JZOO, jload_module, JModelSpec, optax.sgd(0.1)),
            (TZOO, load_module, ModelSpec,
             lambda params: torch.optim.SGD(params, lr=0.1))):
        with zoo(root, "deepfm"):
            mod, _ = load(root, "deepfm.deepfm.custom_model")
            out.append(spec_cls(
                model=mod.custom_model(field_vocab=1000, hidden="32,32",
                                       compute_dtype="float32"),
                loss=mod.loss, optimizer=opt, dataset_fn=None,
                eval_metrics_fn=mod.eval_metrics_fn,
                module_name="deepfm.deepfm"))
    return out


def _mesh():
    return build_mesh(devices=jax.devices()[:1])


def _pair(jspec, tspec, example, **knobs):
    """A reference trainer and state and a port trainer and state, the
    port's params the reference's."""
    jt = JTrainer(jspec, _mesh(), seed=0, **knobs)
    js = jt.init_state(example)
    tt = Trainer(tspec, device="cpu", seed=0, **knobs)
    ts = tt.init_state(example)
    tt.model.load_state_dict(convert.params_from_flax(
        jax.device_get(js.params), tt.model))
    return jt, js, tt, ts


def _deepfm_batch(seed, b):
    r = np.random.RandomState(seed)
    return {
        "features": {
            "dense": (r.rand(b, 13) * 20).astype(np.float32),
            "cat": r.randint(0, 1 << 30, (b, 26)).astype(np.int32),
        },
        "labels": r.randint(0, 2, (b,)).astype(np.int32),
        "mask": (r.rand(b) > 0.1).astype(np.float32),
    }


def _lm_batch(seed, b=8, t=32):
    r = np.random.RandomState(seed)
    toks = r.randint(0, 64, (b, t + 1)).astype(np.int32)
    mask = np.ones((b,), np.float32)
    mask[[1, 6]] = 0.0
    return {"features": toks[:, :-1], "labels": toks[:, 1:], "mask": mask}


def _close(got, want, rtol, atol, what="", lr=None):
    """Port params (by name) against the reference's flax params. With
    `lr` (the LM), each block's k bias is held apart: its gradient is 0
    in exact arithmetic (it adds the same q . b to every score of a row,
    which softmax ignores), so each side's Adam step there normalizes
    rounding noise, moving it by up to `lr` a step in a direction of its
    own; both sides are held within `lr` of its initial 0."""
    want = convert.params_from_flax(jax.device_get(want))
    assert set(got) == set(want)
    for name, p in got.items():
        if lr is not None and name.endswith(".k.bias"):
            for x in (p.detach().numpy(), want[name].numpy()):
                assert np.abs(x).max() <= lr, (what, name)
            continue
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=rtol, atol=atol,
                                   err_msg=f"{what} {name}")


def _snapshot(state):
    return {n: p.detach().clone() for n, p in state.params.items()}


def _equal_states(a, b):
    assert a.step == b.step
    for n in a.params:
        assert torch.equal(a.params[n], b.params[n]), n
    sa, sb = (s.optimizer.state_dict()["state"] for s in (a, b))
    assert sa.keys() == sb.keys()
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)


class _Matmuls(TorchDispatchMode):
    """Counts the matmul ops dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in MATMULS
        return func(*args, **(kwargs or {}))


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


# ---------------------------------------------------------------- cases


def case_accumulation_matches_full_batch(monkeypatch):
    jspec, tspec = _sgd_specs()
    batch = _deepfm_batch(3, 32)
    batch["mask"] = np.ones((32,), np.float32)
    batch["mask"][24:] = 0.0    # all padding in the last micro-batch

    def port_step(accum, params):
        t = Trainer(tspec, device="cpu", grad_accum=accum)
        s = t.init_state(batch)
        t.model.load_state_dict(params)
        s, logs = t.train_step(s, batch)
        return _snapshot(s), float(logs["loss"])

    jt = JTrainer(jspec, _mesh(), grad_accum=4, seed=0)
    js = jt.init_state(batch)
    params = convert.params_from_flax(jax.device_get(js.params))
    js, jlogs = jt.train_step(js, batch)
    p4, l4 = port_step(4, params)
    p1, l1 = port_step(1, params)
    assert l4 == pytest.approx(float(jlogs["loss"]), rel=1e-5)
    assert l4 == pytest.approx(l1, rel=1e-5)
    _close(p4, js.params, 2e-5, 2e-6, "K=4 against the reference's K=4")
    for name in p1:
        np.testing.assert_allclose(p4[name].numpy(), p1[name].numpy(),
                                   rtol=2e-5, atol=2e-6, err_msg=name)

    with pytest.raises(ValueError, match="grad_accum"):
        Trainer(tspec, device="cpu", grad_accum=0)
    t5 = Trainer(tspec, device="cpu", grad_accum=5)   # 5 does not divide 32
    with pytest.raises(ValueError, match="divide"):
        t5.train_step(t5.init_state(batch), batch)

    # a pre-reduced scalar loss weighs micro-batches equally: warn once
    records = _Records()
    logging.getLogger(trainer_mod.__name__).addHandler(records)
    try:
        monkeypatch.setattr(trainer_mod, "_warned_scalar_accum", False)

        def run(loss_fn, accum):
            spec = ModelSpec(model=tspec.model, loss=loss_fn,
                             optimizer=tspec.optimizer, dataset_fn=None,
                             eval_metrics_fn=None)
            t = Trainer(spec, device="cpu", grad_accum=accum)
            t.train_step(t.init_state(batch), batch)

        def scalar_loss(labels, out):
            return torch.mean(tspec.loss(labels, out))

        run(tspec.loss, 2)              # per-example loss: exact, silent
        assert trainer_mod._warned_scalar_accum is False
        run(scalar_loss, 1)             # no accumulation: silent
        assert trainer_mod._warned_scalar_accum is False
        run(scalar_loss, 2)
        run(scalar_loss, 4)
        assert trainer_mod._warned_scalar_accum is True
        warned = [m for m in records.messages if "pre-reduced" in m]
        assert len(warned) == 1, records.messages
    finally:
        logging.getLogger(trainer_mod.__name__).removeHandler(records)


def case_remat_policies():
    (tspec,) = _specs("deepfm.deepfm.custom_model", DEEPFM, roots=(TZOO,))
    batch = _deepfm_batch(4, 64)
    params = None

    def run(**knobs):
        nonlocal params
        t = Trainer(tspec, device="cpu", **knobs)
        s = t.init_state(batch)
        if params is None:
            params = {n: p.detach().clone()
                      for n, p in t.model.state_dict().items()}
        t.model.load_state_dict(params)
        with _Matmuls() as count:
            loss, grads = t.compute_grads(s, batch)
        return count.n, float(loss), {n: g.clone() for n, g in grads.items()}

    base_n, base_loss, base_grads = run()
    results = {policy: run(remat_policy=policy)
               for policy in ("nothing", "dots", "dots_no_batch")}
    results["full"] = run(remat=True)
    assert results["nothing"][0] > base_n, (results["nothing"][0], base_n)
    assert results["dots"][0] < results["nothing"][0]
    assert results["full"][0] == results["nothing"][0]
    for policy, (_, loss, grads) in results.items():
        assert loss == base_loss, policy
        for n, g in grads.items():
            assert torch.equal(g, base_grads[n]), (policy, n)

    with pytest.raises(ValueError, match="unknown remat policy"):
        trainer_mod.resolve_remat_policy("bogus")
    with pytest.raises(ValueError, match="unknown remat policy"):
        Trainer(tspec, device="cpu", remat_policy="bogus")


def case_remat_with_dropout_is_bit_exact(monkeypatch):
    _, tspec = _specs("transformer.transformer_lm.custom_model",
                      LM + ";dropout=0.1")
    batch = _lm_batch(5)
    fwd, bwd = [], []
    real_fwd, real_bwd = fa.flash_fwd, fa.flash_bwd

    def spy_fwd(*args, **kwargs):
        out = real_fwd(*args, **kwargs)
        fwd.append(out)         # held, so no address is reused
        return out

    def spy_bwd(q, k, v, out, dout, lse, *args, **kwargs):
        bwd.append((out, lse))
        return real_bwd(q, k, v, out, dout, lse, *args, **kwargs)

    monkeypatch.setattr(fa, "flash_fwd", spy_fwd)
    monkeypatch.setattr(fa, "flash_bwd", spy_bwd)
    params = None
    runs = {}
    for name, knobs in (("plain", {}), ("full", {"remat": True}),
                        ("dots", {"remat_policy": "dots"})):
        t = Trainer(tspec, device="cpu", seed=7, **knobs)
        s = t.init_state(batch)
        if params is None:
            params = {n: p.detach().clone()
                      for n, p in t.model.state_dict().items()}
        t.model.load_state_dict(params)
        steps = []
        for i in range(2):
            del fwd[:], bwd[:]
            loss, grads = t.compute_grads(s, batch)
            steps.append((float(loss),
                          {n: g.clone() for n, g in grads.items()}))
            s.optimizer.step()
            layers = 2
            assert len(bwd) == layers
            if name == "plain":
                assert len(fwd) == layers
                continue
            # forward, then the recompute in the backward (last layer
            # first); the backward reads the recompute's out and lse
            assert len(fwd) == 2 * layers, (name, len(fwd))
            recomputed = {(o.data_ptr(), l.data_ptr()) for o, l in
                          fwd[layers:]}
            first = {(o.data_ptr(), l.data_ptr()) for o, l in fwd[:layers]}
            for o, l in bwd:
                assert (o.data_ptr(), l.data_ptr()) in recomputed, name
                assert (o.data_ptr(), l.data_ptr()) not in first, name
        runs[name] = (steps, s.generator.get_state())
    plain_steps, plain_gen = runs.pop("plain")
    for name, (steps, gen) in runs.items():
        assert torch.equal(gen, plain_gen), name
        for (loss, grads), (want_loss, want_grads) in zip(steps,
                                                         plain_steps):
            assert loss == want_loss, name
            for n, g in grads.items():
                assert torch.equal(g, want_grads[n]), (name, n)


class _NoisyHead(torch.nn.Module):
    """A linear head whose output gets generator noise after the last op
    that saves a tensor: a recompute that stops early never redraws it."""

    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(4, 1)

    def forward(self, x, training=False, generator=None):
        y = self.lin(x).reshape(-1)
        if training:
            y = y + 0.1 * torch.randn(y.shape, generator=generator)
        return y


def case_remat_puts_the_generator_back():
    """Under remat the recompute stops at the last saved tensor, before
    the noise draw: the generator must still end each step where the
    plain step leaves it, or the next step draws other noise."""
    r = np.random.RandomState(7)
    batch = {"features": r.rand(16, 4).astype(np.float32),
             "labels": r.rand(16).astype(np.float32)}
    runs = []
    for knobs in ({}, {"remat": True}):
        torch.manual_seed(0)
        spec = ModelSpec(
            model=_NoisyHead(),
            loss=lambda labels, out: (out - labels) ** 2,
            optimizer=lambda params: torch.optim.SGD(params, lr=0.1),
            dataset_fn=None, eval_metrics_fn=None)
        t = Trainer(spec, device="cpu", **knobs)
        s = t.init_state(batch)
        losses = [float(t.train_step(s, batch)[1]["loss"]) for _ in range(3)]
        runs.append((losses, s.generator.get_state()))
    assert runs[0][0] == runs[1][0]
    assert torch.equal(runs[0][1], runs[1][1])


def case_remat_and_accumulation_through_flash():
    jspec, tspec = _specs("transformer.transformer_lm.custom_model", LM1)
    batch = _lm_batch(6)
    jt, js, tt, ts = _pair(jspec, tspec, batch, remat_policy="dots",
                           grad_accum=2)
    (plain_spec,) = _specs("transformer.transformer_lm.custom_model", LM1,
                           roots=(TZOO,))
    plain = Trainer(plain_spec, device="cpu")
    ps = plain.init_state(batch)
    plain.model.load_state_dict(tt.model.state_dict())
    fa_calls = []
    real = fa.flash_fwd

    def spy(*args, **kwargs):
        fa_calls.append(1)
        return real(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fa, "flash_fwd", spy)
        _, plain_logs = plain.train_step(ps, batch)
        assert len(fa_calls) == 1               # the layer's
        _, tlogs = tt.train_step(ts, batch)
        assert len(fa_calls) == 1 + 2 * 2       # a micro-batch and run
    assert float(tlogs["loss"]) == pytest.approx(float(plain_logs["loss"]),
                                                 rel=1e-4)
    # the reference's Pallas kernels run on the CPU only in interpret
    # mode, whose callbacks jax.checkpoint refuses on this jax
    # ("Effects not supported in partial-eval of checkpoint/remat"): its
    # dots + accumulation step runs the materialized attention, which the
    # port's plain flash versions match in float32
    # (`tests/test_torch_transformer.py`)
    js, jlogs = jt.train_step(js, batch)
    assert float(tlogs["loss"]) == pytest.approx(float(jlogs["loss"]),
                                                 rel=1e-4)
    _close(ts.params, js.params, 1e-4, 1e-5, "dots + accumulation 2",
           lr=3e-4)


def case_grouped_steps_match_single_steps():
    jspec, tspec = _specs("deepfm.deepfm.custom_model", DEEPFM)
    batches = [_deepfm_batch(10 + i, 64) for i in range(3)]
    jt, js, tt, ts = _pair(jspec, tspec, batches[0])
    (single_spec,) = _specs("deepfm.deepfm.custom_model", DEEPFM,
                            roots=(TZOO,))
    single = Trainer(single_spec, device="cpu")
    ss = single.init_state(batches[0])
    single.model.load_state_dict(tt.model.state_dict())

    # eval and predict first, on the shared initial params
    stacked = stack_batches(batches, "cpu")
    assert stacked["features"]["cat"].shape == (3, 64, 26)
    ms = tt.eval_many(ts, stacked, tt.new_metric_states())
    want = single.new_metric_states()
    for b in batches:
        want = single.eval_step(ss, b, want)
    assert ms.keys() == want.keys()
    for k in ms:
        np.testing.assert_array_equal(ms[k], want[k], err_msg=k)
    jstack = shard_batch_stack(jt.mesh, batches)
    jms = jt.eval_many(js, jstack, jt.new_metric_states())
    got, ref = tt.metric_results(ms), jt.metric_results(jms)
    assert sorted(got) == sorted(ref) == ["accuracy", "auc", "loss"]
    for k in got:
        assert got[k] == pytest.approx(ref[k], rel=1e-5), k

    outs = tt.predict_many(ts, stacked)
    assert outs.shape == (3, 64)
    for i, b in enumerate(batches):
        assert torch.equal(outs[i], single.predict_step(ss, b)), i
    np.testing.assert_allclose(
        outs.numpy(), np.asarray(jt.predict_many(js, jstack)), rtol=1e-5,
        atol=1e-6)

    ts, logs = tt.train_many(ts, stacked)
    assert logs["loss"].shape == (3,) and logs["loss"].dtype == torch.float32
    losses = []
    for b in batches:
        ss, one = single.train_step(ss, b)
        losses.append(one["loss"])
    assert torch.equal(logs["loss"], torch.stack(losses))
    _equal_states(ts, ss)
    assert ts.model_version == 3
    js, jlogs = jt.train_many(js, jstack)
    np.testing.assert_allclose(logs["loss"].numpy(),
                               np.asarray(jlogs["loss"]), rtol=1e-4,
                               atol=1e-5)
    _close(ts.params, js.params, 1e-4, 1e-5, "train_many")


def test_trainer_knobs_against_the_reference(monkeypatch):
    """Every case above, in one collected test (ROADMAP.md, conventions:
    one collected test per port test file)."""
    monkeypatch.setenv("EDL_EMB_SCATTER", "sorted")
    monkeypatch.delenv("EDL_FLASH", raising=False)
    case_accumulation_matches_full_batch(monkeypatch)
    case_remat_policies()
    case_remat_with_dropout_is_bit_exact(monkeypatch)
    case_remat_puts_the_generator_back()
    case_remat_and_accumulation_through_flash()
    case_grouped_steps_match_single_steps()
