"""The port's compiled-step layer against the reference's, on the CPU:
the step programs resolved through `CompileCache` (`Trainer._ensure`,
`aot_compile_*`, `compile_stats`), and what keeps a captured
program's memory valid.

On the CPU a program runs its step's eager body (`training/step_graph.py`
captures CUDA graphs only on the card), so what is held here is the
cache, its keys and counters, the dispatch, and the state handling that a
graph depends on:

- Counters: DeepFM (field_vocab=1000, hidden 32,32, float32) on both
  sides, each with a fresh `CompileCache` and its package's
  `job_cache_token`. After every call of one sequence the port's
  `compile_stats()` equals the reference's dict exactly: trainer A's
  init, two train steps, an eval and a predict step; trainer B (the same
  token) init and a train step; B's `aot_compile_train_step` at a new
  batch shape and a train step there (which must run the graph captured
  ahead of it); a `speculative=True` `aot_compile_eval_step`; and trainer
  C (the same token, a state of its own) at that shape, which captures a
  graph of its own in the program it shares with B and leaves B's as it
  was. `abstract=True` raises.
- Results through the cache: a trainer's train steps, `train_many` of 2,
  eval and predict steps equal the port's eager step bodies bit for bit
  (losses, parameters, Adam's slots, metric states, outputs), and stay
  within the bounds the reference parity tests state
  (`tests/test_torch_trainer.py`: losses and parameters rtol 1e-4, atol
  1e-5 after Adam steps; metric results rel 1e-5; outputs rtol 1e-5,
  atol 1e-6).
- Held tensors: `train_step_cost` (whose `StateCopy` puts the state
  back) and a checkpoint save and restore keep the storage of every
  tensor a program reads (parameters, gradients, Adam's slots, the
  tensor learning rate; compared by `data_ptr()`), and the restored
  values are the saved ones bit for bit. A capture's warm-up
  (`StateCopy.restore(new_slots="zero")`) leaves a fresh state whose
  next step equals a fresh twin's bit for bit, for Adam and for SGD with
  momentum.
- A tensor learning rate set after the first step reaches the next:
  `set_learning_rate` writes it in place (the same tensor), and a step
  at rate 0 moves no parameter.
- The configurations the card captures (DeepFM, xDeepFM, Wide & Deep,
  ResNet-20, MNIST, the LM with dropout) run their forward and backward
  and their eval and predict bodies with no host read of a tensor
  (`aten._local_scalar_dense`) and no data-dependent shape
  (`aten.nonzero`); the configurations left eager say why
  (`Trainer._graph_blocker`): the MoE LM, ResNet-50's schedule, an
  optimizer that is not `lr_modulation.modulated`; remat captures.
"""

import contextlib
import os
import sys
import tempfile

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from elasticdl_tpu.common.config import JobConfig as JJobConfig
from elasticdl_tpu.parallel.mesh import build_mesh
from elasticdl_tpu.training import compile_cache as jcc
from elasticdl_tpu.training.model_spec import ModelSpec as JModelSpec
from elasticdl_tpu.training.trainer import Trainer as JTrainer
from elasticdl_tpu_torch import convert
from elasticdl_tpu_torch.common.config import JobConfig
from elasticdl_tpu_torch.training import checkpoint as ckpt_lib
from elasticdl_tpu_torch.training import compile_cache as cc
from elasticdl_tpu_torch.training import lr_modulation, step_graph
from elasticdl_tpu_torch.training.model_spec import ModelSpec
from elasticdl_tpu_torch.training.trainer import Trainer, stack_batches

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JZOO = os.path.join(REPO, "model_zoo")
TZOO = os.path.join(REPO, "elasticdl_tpu_torch", "model_zoo")
ZOO_PACKAGES = ("deepfm", "mnist", "cifar10", "resnet50", "census",
                "transformer")
DEEPFM = ("deepfm.deepfm.custom_model", "field_vocab=1000;hidden=32,32")
COHORT_ENV = ("EDL_PROCESS_ID", "EDL_NUM_PROCESSES",
              "EDL_PROCESS_ID_FROM_HOSTNAME", "EDL_COORDINATOR_ADDR")
# the ops that read a tensor on the host, or shape one by its data: a
# capture refuses both on the card
HOST_SYNCS = {torch.ops.aten._local_scalar_dense.default,
              torch.ops.aten.nonzero.default}


@contextlib.contextmanager
def zoo(root):
    """Both zoos name their modules alike: import with `root` first on
    sys.path and the other zoo's cached modules set aside."""
    def ours(k):
        return k.split(".")[0] in ZOO_PACKAGES

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


def _config(root, model_def, params, dtype="float32"):
    cls = JJobConfig if root == JZOO else JobConfig
    return cls.from_argv(["--model_zoo", root, "--model_def", model_def,
                          "--model_params", params, "--compute_dtype", dtype])


def _spec(root, model_def, params, dtype="float32"):
    with zoo(root):
        cls = JModelSpec if root == JZOO else ModelSpec
        return cls.from_config(_config(root, model_def, params, dtype))


def _batch(seed, b):
    r = np.random.RandomState(seed)
    return {
        "features": {
            "dense": (r.rand(b, 13) * 20).astype(np.float32),
            "cat": r.randint(0, 1 << 30, (b, 26)).astype(np.int32),
        },
        "labels": r.randint(0, 2, (b,)).astype(np.int32),
        "mask": (r.rand(b) > 0.1).astype(np.float32),
    }


def _mesh():
    return build_mesh(devices=jax.devices()[:1])


def _port_trainer(cache=None, token="", **knobs):
    return Trainer(_spec(TZOO, *DEEPFM), device="cpu", seed=0,
                   cache_token=token, cache=cache, **knobs)


def _tensors(state):
    """Every tensor a step program reads, by name."""
    out = {f"param:{n}": p for n, p in state.params.items()}
    out.update({f"grad:{n}": p.grad for n, p in state.params.items()
                if p.grad is not None})
    out.update({f"buffer:{n}": b for n, b in state.buffers.items()})
    names = {p: n for n, p in state.params.items()}
    for p, slots in state.optimizer.state.items():
        out.update({f"slot:{names[p]}.{k}": v for k, v in slots.items()
                    if isinstance(v, torch.Tensor)})
    for i, g in enumerate(state.optimizer.param_groups):
        out.update({f"group{i}:{k}": v for k, v in g.items()
                    if isinstance(v, torch.Tensor)})
    return out


def _assert_equal_states(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k
    assert a.step == b.step


# ---------------------------------------------------------------- cases


def case_counters_against_the_reference():
    jcfg = _config(JZOO, *DEEPFM)
    tcfg = _config(TZOO, *DEEPFM)
    jcache, tcache = jcc.CompileCache(), cc.CompileCache()
    jtok, ttok = jcc.job_cache_token(jcfg), cc.job_cache_token(tcfg)
    batch, other = _batch(1, 64), _batch(2, 48)

    def trainers():
        return (JTrainer(_spec(JZOO, *DEEPFM), _mesh(), seed=0,
                         cache_token=jtok, cache=jcache),
                Trainer(_spec(TZOO, *DEEPFM), device="cpu", seed=0,
                        cache_token=ttok, cache=tcache))

    def same(what):
        assert tcache.stats() == jcache.stats(), (what, tcache.stats(),
                                                  jcache.stats())

    ja, ta = trainers()
    jsa, tsa = ja.init_state(batch), ta.init_state(batch)
    same("A init")
    for i in range(2):
        jsa, _ = ja.train_step(jsa, batch)
        tsa, _ = ta.train_step(tsa, batch)
        same(f"A train_step {i}")
    ja.eval_step(jsa, batch, ja.new_metric_states())
    ta.eval_step(tsa, batch, ta.new_metric_states())
    same("A eval_step")
    ja.predict_step(jsa, batch)
    ta.predict_step(tsa, batch)
    same("A predict_step")

    jb, tb = trainers()
    jsb, tsb = jb.init_state(batch), tb.init_state(batch)
    same("B init")
    jsb, _ = jb.train_step(jsb, batch)
    tsb, _ = tb.train_step(tsb, batch)
    same("B train_step")
    assert tb._train_step is ta._train_step     # the program A built

    jb.aot_compile_train_step(jsb, other)
    graph = tb.aot_compile_train_step(tsb, other)
    same("B aot_compile_train_step")
    assert tcache.aot_generation == jcache.aot_generation == 1
    assert tb.aot_compile_train_step(tsb, other) is graph
    step = tsb.step
    jsb, _ = jb.train_step(jsb, other)
    tsb, _ = tb.train_step(tsb, other)
    same("B train_step at the AOT shape")
    assert tsb.step == step + 1
    assert tb._train_step.graph_for(
        tb, tsb, None, step_graph.batch_signature(
            tb._device_args(other))) is graph

    jb.aot_compile_eval_step(jsb, batch, speculative=True)
    tb.aot_compile_eval_step(tsb, batch, speculative=True)
    same("B speculative aot_compile_eval_step")
    assert tcache.stats()["speculative_compiles"] == 1
    with pytest.raises(NotImplementedError, match="item 19"):
        tb.aot_compile_train_step(tsb, other, abstract=True)

    # C holds a state of its own: its step at the AOT shape captures C's
    # graph in the program B's AOT compile used (the reference's
    # executable takes any state of the signature)
    jc, tc = trainers()
    jsc, tsc = jc.init_state(batch), tc.init_state(batch)
    jsc, _ = jc.train_step(jsc, other)
    tsc, _ = tc.train_step(tsc, other)
    same("C train_step at the AOT shape")
    assert tc._train_step is tb._train_step
    bound = [g for g in tc._train_step.graphs() if g.sig == graph.sig]
    assert {(g.bound_to(tb, tsb), g.bound_to(tc, tsc)) for g in bound} == {
        (True, False), (False, True)}
    del jsa, jsb, jsc


def case_steps_through_the_cache_equal_eager():
    batches = [_batch(10 + i, 64) for i in range(3)]
    jt = JTrainer(_spec(JZOO, *DEEPFM), _mesh(), seed=0)
    js = jt.init_state(batches[0])
    weights = convert.params_from_flax(jax.device_get(js.params))
    tt, eager = _port_trainer(), _port_trainer()
    ts, es = tt.init_state(batches[0]), eager.init_state(batches[0])
    for t in (tt, eager):
        t.model.load_state_dict(weights)

    got = tt.predict_step(ts, batches[0])
    want = eager._predict_body(es, eager._device_args(batches[0]))
    assert torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jt.predict_step(js, batches[0])),
                               rtol=1e-5, atol=1e-6)
    ms = tt.eval_step(ts, batches[0], tt.new_metric_states())
    outputs, pair = eager._eval_body(es, eager._device_args(batches[0]))
    assert torch.equal(pair, tt._eval_body(ts, tt._device_args(
        batches[0]))[1])
    jms = jt.eval_step(js, batches[0], jt.new_metric_states())
    got, ref = tt.metric_results(ms), jt.metric_results(jms)
    assert sorted(got) == sorted(ref)
    for k in got:
        assert got[k] == pytest.approx(ref[k], rel=1e-5), k
    del outputs

    losses, want = [], []
    for b in batches[:2]:
        ts, logs = tt.train_step(ts, b)
        losses.append(logs["loss"])
        want.append(eager._train_body(es, eager._device_args(b)))
        es.step += 1
        js, jlogs = jt.train_step(js, b)
        assert float(logs["loss"]) == pytest.approx(float(jlogs["loss"]),
                                                    rel=1e-4, abs=1e-5)
    assert torch.equal(torch.stack(losses), torch.stack(want))
    _assert_equal_states(ts, es)
    ts, logs = tt.train_many(ts, stack_batches(batches[1:], "cpu"))
    for i, b in enumerate(batches[1:]):
        loss = eager._train_body(es, eager._device_args(b))
        es.step += 1
        assert torch.equal(logs["loss"][i], loss), i
    _assert_equal_states(ts, es)
    for b in batches[1:]:
        js, _ = jt.train_step(js, b)
    ref = convert.params_from_flax(jax.device_get(js.params))
    for n, p in ts.params.items():
        np.testing.assert_allclose(p.detach().numpy(), ref[n].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=n)


def _tensor_lr_spec(lr=1e-3):
    spec = _spec(TZOO, *DEEPFM)
    spec.optimizer = lambda params: torch.optim.Adam(
        params, lr=torch.tensor(lr), foreach=False)
    return spec


def case_restores_keep_the_held_tensors():
    batch = _batch(20, 64)
    t = Trainer(_tensor_lr_spec(), device="cpu", seed=0)
    state = t.init_state(batch)
    for _ in range(2):
        state, _ = t.train_step(state, batch)
    held = _tensors(state)
    before = {k: v.clone() for k, v in held.items()}
    t.train_step_cost(state, _batch(21, 64))
    after = _tensors(state)
    assert after.keys() == held.keys()
    for k, v in after.items():
        assert v.data_ptr() == held[k].data_ptr(), k
        assert torch.equal(v, before[k]), k

    with tempfile.TemporaryDirectory() as d:
        mngr = ckpt_lib.CheckpointManager(d)
        mngr.save(state, wait=True)
        saved_step = state.step
        state, _ = t.train_step(state, batch)
        state.optimizer.param_groups[0]["lr"].fill_(0.5)
        assert mngr.restore(state) is state
    assert state.step == saved_step
    after = _tensors(state)
    for k, v in after.items():
        if k.startswith("grad:"):
            continue        # a checkpoint carries no gradient
        assert v.data_ptr() == held[k].data_ptr(), k
        assert torch.equal(v, before[k]), k

    # a capture's warm-up puts a fresh state back with the slots it made
    # zeroed: the next step equals a fresh twin's
    for spec_of in (lambda: _spec(TZOO, *DEEPFM), lambda: _sgd_spec()):
        a = Trainer(spec_of(), device="cpu", seed=0)
        b = Trainer(spec_of(), device="cpu", seed=0)
        sa, sb = a.init_state(batch), b.init_state(batch)
        copy = step_graph.StateCopy(sa)
        a._train_body(sa, a._device_args(_batch(22, 64)))
        copy.restore(sa, new_slots="zero")
        assert sa.optimizer.state            # the slots stay, zeroed
        for _ in range(2):
            sa, la = a.train_step(sa, batch)
            sb, lb = b.train_step(sb, batch)
            assert torch.equal(la["loss"], lb["loss"])
        for n in sa.params:
            assert torch.equal(sa.params[n], sb.params[n]), n


def _sgd_spec():
    spec = _spec(TZOO, *DEEPFM)
    spec.optimizer = lr_modulation.modulated(
        torch.optim.SGD, learning_rate=0.1, momentum=0.9, nesterov=True,
        weight_decay=1e-4)
    return spec


def case_tensor_lr_reaches_the_next_step():
    batch = _batch(30, 64)
    t = Trainer(_tensor_lr_spec(), device="cpu", seed=0)
    state = t.init_state(batch)
    state, _ = t.train_step(state, batch)
    lr = state.optimizer.param_groups[0]["lr"]
    t.set_learning_rate(state, 0.0)
    assert state.optimizer.param_groups[0]["lr"] is lr
    assert float(lr) == 0.0
    assert lr_modulation.get_learning_rate(state.optimizer) == 0.0
    params = {n: p.detach().clone() for n, p in state.params.items()}
    state, _ = t.train_step(state, batch)
    for n, p in state.params.items():
        assert torch.equal(p, params[n]), n
    t.set_learning_rate(state, 1e-3)
    state, _ = t.train_step(state, batch)
    assert any(not torch.equal(p, params[n])
               for n, p in state.params.items())


class _HostSyncs(TorchDispatchMode):
    """Records every op of HOST_SYNCS dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in HOST_SYNCS:
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


def _zoo_batch(name, b=8, seed=0):
    r = np.random.RandomState(seed)
    mask = np.ones((b,), np.float32)
    if name == "lm":
        toks = r.randint(0, 64, (b, 17)).astype(np.int32)
        return {"features": toks[:, :-1], "labels": toks[:, 1:],
                "mask": mask}
    if name == "mnist":
        feats = r.rand(b, 28, 28, 1).astype(np.float32)
    elif name == "resnet20":
        feats = r.rand(b, 32, 32, 3).astype(np.float32)
    elif name == "wide_deep":
        feats = {"dense": r.randn(b, 5).astype(np.float32),
                 "cat": r.randint(0, 200, (b, 9)).astype(np.int32)}
    else:
        feats = {"dense": (r.rand(b, 13) * 20).astype(np.float32),
                 "cat": r.randint(0, 1 << 30, (b, 26)).astype(np.int32)}
    classes = 10 if name in ("mnist", "resnet20") else 2
    return {"features": feats,
            "labels": r.randint(0, classes, (b,)).astype(np.int32),
            "mask": mask}


CAPTURED = {
    "deepfm": DEEPFM,
    "xdeepfm": ("deepfm.xdeepfm.custom_model",
                "field_vocab=1000;hidden=32,16;cin_sizes=16,16"),
    "wide_deep": ("census.wide_deep.custom_model", "hidden=32,16"),
    "resnet20": ("cifar10.resnet.custom_model", "depth=8"),
    "mnist": ("mnist.mnist_cnn.custom_model", ""),
    "lm": ("transformer.transformer_lm.custom_model",
           "vocab=64;num_layers=2;dim=64;heads=4;max_len=16;dropout=0.1"),
}


def case_captured_bodies_make_no_host_sync():
    for name, (model_def, params) in CAPTURED.items():
        t = Trainer(_spec(TZOO, model_def, params), device="cpu", seed=0)
        assert t._graph_blocker() is None, (name, t._graph_blocker())
        assert t.capture_reason is not None        # the CPU runs the body
        batch = _zoo_batch(name)
        state = t.init_state(batch)
        args = t._device_args(batch)
        t._train_body(state, args)      # the optimizer's slots, as a warm-up
        with _HostSyncs() as mode:
            # the forward and backward: the optimizer's step on the card is
            # the capturable flavour, which the CPU does not build
            t.compute_grads(state, args)
            t._eval_body(state, args)
            t._predict_body(state, args)
        assert mode.seen == [], (name, mode.seen)

    blocked = {
        "moe": (("transformer.transformer_lm.custom_model",
                 "vocab=64;num_layers=2;dim=64;heads=4;max_len=16;"
                 "moe_experts=4"), {}, "switch_moe"),
        "resnet50": (("resnet50.resnet50.custom_model", "num_classes=10"),
                     {}, "WarmupCosineSGD"),
    }
    for name, ((model_def, params), knobs, says) in blocked.items():
        t = Trainer(_spec(TZOO, model_def, params), device="cpu", **knobs)
        reason = t._graph_blocker()
        assert reason is not None and says in reason, (name, reason)
    plain = _spec(TZOO, *DEEPFM)
    plain.optimizer = lambda params: torch.optim.Adam(params, lr=1e-3)
    assert "modulated" in Trainer(plain, device="cpu")._graph_blocker()
    remat = Trainer(_spec(TZOO, *DEEPFM), device="cpu", remat_policy="dots")
    assert remat._graph_blocker() is None


def test_compiled_step_layer_against_the_reference(monkeypatch):
    """Every case above, in one collected test (ROADMAP.md, conventions:
    one collected test per port test file)."""
    monkeypatch.setenv("EDL_EMB_SCATTER", "sorted")
    monkeypatch.delenv("EDL_FLASH", raising=False)
    for var in COHORT_ENV:
        monkeypatch.delenv(var, raising=False)
    case_counters_against_the_reference()
    case_steps_through_the_cache_equal_eager()
    case_restores_keep_the_held_tensors()
    case_tensor_lr_reaches_the_next_step()
    case_captured_bodies_make_no_host_sync()
