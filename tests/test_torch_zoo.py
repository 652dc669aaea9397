"""The port's five zoo models (xDeepFM, Census Wide & Deep, the MNIST CNN,
CIFAR-10 ResNet-20 and ResNet-50) against the reference, on the CPU.

Both packages build each model through their own `JobConfig -> ModelSpec
-> Trainer`; the reference runs its jitted steps on a one-device mesh
(with the exact embedding backward, `EDL_EMB_SCATTER=sorted`), and the
port starts from the reference's initial state, carried across by
`convert.train_state_from_flax` (params, Adam's moments or SGD's trace,
BatchNorm's `batch_stats`, the update count) and
`convert.load_train_state`. Sizes are small: MNIST batch 8; ResNet-20
depth 8 at batch 8; ResNet-50 at 32x32 with 10 classes and batch 8;
Wide & Deep (hidden 32,16) and xDeepFM (field_vocab 1000, hidden 32,16,
CIN 16,16) at batch 16, with masked rows. ResNet-50 takes batch 8, not
2: its last stage is 1x1, so each BatchNorm there normalizes B values a
channel, and with 2 the fast variance's cancellation magnifies the
libraries' 1e-7 differences in its input to 5e-2 of the output
(measured); with 4, to 1.4e-3 of its first conv's gradient, with 8 to
6e-5. Where the reference runs it, ResNet-50's bottleneck stages are
cut to (1, 1, 1, 1) blocks, which keeps every kind of block, so the
reference's compiles fit the test's budget; the port's checkpoint and
export case runs the full (3, 4, 6, 3). The MNIST CNN's dropout draws from each
library's own generator, so the step cases run both models with dropout
replaced by the identity (the port's dropout is the DeepFM tests').

Tolerances, in float32 compute: outputs and losses rtol 1e-5 with atol
1e-6 of the outputs' largest magnitude (rounding in another summation
order), 5e-5 for a training forward (BatchNorm's fast variance, E[x^2] -
E[x]^2, magnifies its input's rounding: 2.4e-6 measured on ResNet-20,
9.9e-6 on ResNet-50). After steps, params and BatchNorm statistics rtol
1e-5 with atol 1e-5 of the largest magnitude over all arrays of their
kind (all params, all statistics), and the optimizer's slots atol 1e-4
so (each slot's arrays): BatchNorm's backward through the fast variance
magnifies rounding in the gradients (measured: 1.3e-5 on ResNet-20's,
5.9e-5 on ResNet-50's), which SGD's momentum holds; rtol 1e-4 after
Adam steps (`tests/test_torch_deepfm.py`'s: Adam's m / (sqrt(v) + eps)
magnifies rounding in gradients near 0).
Eval metric states are equal but for the loss pair (rtol 1e-5). In
bfloat16 compute (one case a family: xDeepFM and ResNet-20), outputs
within 2e-2 of the logits' largest magnitude: every layer rounds to 8
mantissa bits (~4e-3 relative) and the two libraries may round a product
to neighbouring bf16 values. Remat must equal the port's step without it
bit for bit; remat with `grad_accum=2` is held to the reference's same
knobs at the step tolerances. Parsing (Census CSV, MNIST, CIFAR-10 and
ImageNet records) and the feature spec's ids are bit-equal (its device
half's dense values, log1p in two libraries, rtol 1e-6); the SGD
equivalences rtol 1e-6; SAME padding and BatchNorm against flax's
layers rtol 1e-6 (BatchNorm's gradient 1e-5).
"""

import contextlib
import copy
import dataclasses
import os
import sys
import tempfile

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from elasticdl_tpu.common.config import JobConfig as JJobConfig
from elasticdl_tpu.parallel.mesh import build_mesh
from elasticdl_tpu.training.model_spec import ModelSpec as JModelSpec
from elasticdl_tpu.training.trainer import Trainer as JTrainer
from elasticdl_tpu_torch import convert
from elasticdl_tpu_torch.common.config import JobConfig
from elasticdl_tpu_torch.training.model_spec import ModelSpec
from elasticdl_tpu_torch.training.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JZOO = os.path.join(REPO, "model_zoo")
TZOO = os.path.join(REPO, "elasticdl_tpu_torch", "model_zoo")
ZOO_PACKAGES = ("deepfm", "mnist", "cifar10", "resnet50", "census")

# name: (model_def, model_params, batch size, optimizer kind)
MODELS = {
    "mnist": ("mnist.mnist_cnn.custom_model", "", 8, "sgd"),
    "resnet20": ("cifar10.resnet.custom_model", "depth=8", 8, "sgd"),
    "resnet50": ("resnet50.resnet50.custom_model", "num_classes=10", 8,
                 "sgd"),
    "wide_deep": ("census.wide_deep.custom_model", "hidden=32,16", 16,
                  "adam"),
    "xdeepfm": ("deepfm.xdeepfm.custom_model",
                "field_vocab=1000;hidden=32,16;cin_sizes=16,16", 16, "adam"),
}
# ResNet-50's depth where the reference runs it (see the docstring)
STAGES = {"resnet50": (1, 1, 1, 1)}


@contextlib.contextmanager
def zoo(root):
    """Both zoos name their modules alike (`deepfm.xdeepfm`,
    `cifar10.resnet`, ...): import with `root` first on sys.path and the
    other zoo's cached modules set aside."""
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


def specs(name, dtype="float32", stages=None):
    """(reference ModelSpec, port ModelSpec) of model `name`; `stages`
    sets ResNet-50's stage_sizes in both."""
    model_def, params, _, _ = MODELS[name]
    out = []
    for root, cfg_cls, spec_cls in ((JZOO, JJobConfig, JModelSpec),
                                    (TZOO, JobConfig, ModelSpec)):
        with zoo(root):
            spec = spec_cls.from_config(cfg_cls.from_argv([
                "--model_zoo", root, "--model_def", model_def,
                "--model_params", params, "--compute_dtype", dtype]))
        if stages is not None:
            spec = dataclasses.replace(
                spec, model=(spec.model.clone(stage_sizes=stages)
                             if root == JZOO else
                             type(spec.model)(num_classes=10,
                                              compute_dtype=torch.float32,
                                              stage_sizes=stages)))
        out.append(spec)
    return out


def batch(name, seed):
    r = np.random.RandomState(seed)
    b = MODELS[name][2]
    mask = (r.rand(b) > 0.2).astype(np.float32)
    if name == "mnist":
        feats = r.rand(b, 28, 28, 1).astype(np.float32)
    elif name in ("resnet20", "resnet50"):
        feats = r.rand(b, 32, 32, 3).astype(np.float32)
    elif name == "wide_deep":
        feats = {"dense": r.randn(b, 5).astype(np.float32),
                 "cat": r.randint(0, 200, (b, 9)).astype(np.int32)}
    else:
        feats = {"dense": (r.rand(b, 13) * 20).astype(np.float32),
                 "cat": r.randint(0, 1 << 30, (b, 26)).astype(np.int32)}
    classes = 2 if name in ("wide_deep", "xdeepfm") else 10
    return {"features": feats,
            "labels": r.randint(0, classes, (b,)).astype(np.int32),
            "mask": mask}


def find_states(opt_state):
    """The optax states an opt_state holds, by type name."""
    kinds = (optax.TraceState, optax.ScaleByAdamState,
             optax.ScaleByScheduleState)
    leaves = jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda n: isinstance(n, kinds))
    return {type(n).__name__: n for n in leaves if isinstance(n, kinds)}


def reference_state(js):
    """A reference TrainState in the port's terms: (converted for
    `load_train_state`, params, slots, buffers as numpy by port name)."""
    params, opt, extra, step = jax.device_get(
        (js.params, js.opt_state, js.extra_vars, js.step))
    found = find_states(opt)
    kw = {}
    if "ScaleByAdamState" in found:
        adam = found["ScaleByAdamState"]
        kw.update(mu=adam.mu, nu=adam.nu, count=adam.count)
    if "TraceState" in found:
        kw["trace"] = found["TraceState"].trace
        sched = found.get("ScaleByScheduleState")
        kw["count"] = sched.count if sched is not None else 0
    if extra.get("batch_stats"):
        kw["batch_stats"] = extra["batch_stats"]
    return convert.train_state_from_flax(params, step=step, **kw)


def port_arrays(ts):
    """The port state's params, optimizer slots and buffers as numpy by
    name, and its schedule count (None without one)."""
    names = list(ts.params)
    sd = ts.optimizer.state_dict()
    slots = {}
    for i, slot in sd["state"].items():
        for key, v in slot.items():
            if v.dim():
                slots.setdefault(key, {})[names[i]] = v.numpy().copy()
    count = sd["param_groups"][0].get("count")
    return ({k: p.detach().numpy().copy() for k, p in ts.params.items()},
            slots, {k: b.numpy().copy() for k, b in ts.buffers.items()},
            count)


def assert_close(got, want, rtol, atol_of_max, what):
    """`got` within rtol, with atol `atol_of_max` of the largest magnitude
    over all of `want`'s arrays."""
    assert set(got) == set(want), (what, set(got) ^ set(want))
    scale = max([float(np.abs(np.asarray(w)).max()) for w in want.values()
                 if np.size(w)] + [1e-30])
    for k, w in want.items():
        np.testing.assert_allclose(got[k], np.asarray(w), rtol=rtol,
                                   atol=atol_of_max * scale,
                                   err_msg=f"{what} {k}")


def assert_state_close(jstate, ts, kind):
    want = reference_state(jstate)
    got_params, got_slots, got_buffers, _ = port_arrays(ts)
    rtol = 1e-4 if kind == "adam" else 1e-5
    np_of = lambda d: {k: v.numpy() for k, v in d.items()}  # noqa: E731
    assert_close(got_params, np_of(want["params"]), rtol, 1e-5, "param")
    for key in ("exp_avg", "exp_avg_sq", "momentum_buffer"):
        if key in want:
            assert_close(got_slots[key], np_of(want[key]), rtol, 1e-4, key)
    assert_close(got_buffers, np_of(want.get("buffers", {})), rtol, 1e-5,
                 "buffer")


@contextlib.contextmanager
def no_dropout(tspec):
    """Dropout as the identity in both MNIST CNNs (see the docstring): in
    the port's model module and in `api.layers`, which a model built
    inside the context imports it from."""
    from elasticdl_tpu_torch.api import layers

    module = type(tspec.model).forward.__globals__
    saved = module["dropout"], layers.dropout, fnn.Dropout.__call__
    module["dropout"] = layers.dropout = lambda x, rate, generator: x
    fnn.Dropout.__call__ = lambda self, x, *a, **k: x
    try:
        yield
    finally:
        module["dropout"], layers.dropout, fnn.Dropout.__call__ = saved


class Pair:
    """The reference's and the port's trainers of one model from one
    initial state."""

    def __init__(self, name, dtype="float32", stages=None, **knobs):
        self.name = name
        self.jspec, self.tspec = specs(name, dtype, stages)
        mesh = build_mesh(devices=jax.devices()[:1])
        self.jt = JTrainer(self.jspec, mesh, **knobs)
        self.tt = Trainer(self.tspec, device="cpu", **knobs)
        self.js = self.jt.init_state(batch(name, 0))
        self.ts = self.tt.init_state(None)
        convert.load_train_state(self.ts, reference_state(self.js))

    def port_twin(self, **knobs):
        """A port trainer and state of this model with other knobs, from
        the port's current state."""
        _, tspec = specs(self.name, "float32", self.stages())
        tt = Trainer(tspec, device="cpu", **knobs)
        ts = tt.init_state(None)
        with torch.no_grad():
            for k, p in ts.params.items():
                p.copy_(self.ts.params[k])
            for k, b in ts.buffers.items():
                b.copy_(self.ts.buffers[k])
        # a deep copy: load_state_dict keeps the slot tensors it is given
        ts.optimizer.load_state_dict(
            copy.deepcopy(self.ts.optimizer.state_dict()))
        ts.step = self.ts.step
        return tt, ts

    def stages(self):
        return (tuple(self.tspec.model.stage_sizes)
                if hasattr(self.tspec.model, "stage_sizes") else None)


# ------------------------------------------------------------- per model


def case_forward(p):
    """Eval and train-mode outputs, and the train forward's new batch
    statistics; then the port's state is put back to the reference's."""
    name = p.name
    b = batch(name, 1)
    want = np.asarray(p.jt.predict_step(p.js, b))
    got = p.tt.predict_step(p.ts, b).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * scale,
                               err_msg=name)
    if not p.ts.buffers:
        return
    variables = {"params": p.js.params, **p.js.extra_vars}
    out, new_vars = jax.jit(lambda v, x: p.jspec.model.apply(
        v, x, training=True, mutable=["batch_stats"]))(variables,
                                                       b["features"])
    feats = torch.from_numpy(b["features"])
    got = p.tt.model(feats, training=True).detach().numpy()
    want = np.asarray(out)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=5e-5 * np.abs(want).max(), err_msg=name)
    from elasticdl_tpu_torch.api.layers import update_batch_stats

    update_batch_stats(p.tt.model)
    want = {k: v.numpy() for k, v in convert.buffers_from_flax(
        jax.device_get(new_vars["batch_stats"])).items()}
    assert_close({k: b.numpy() for k, b in p.ts.buffers.items()}, want,
                 1e-5, 1e-5, f"{name} batch_stats")
    convert.load_train_state(p.ts, reference_state(p.js))


def case_steps_eval_and_remat(p):
    """One step (params, slots, statistics), two more (ResNet-50's first
    step trains at LR 0), the eval metric states, remat against the
    port's plain step and remat + grad_accum=2 against the reference's
    same knobs."""
    name = p.name
    kind = MODELS[name][3]
    guard = no_dropout(p.tspec) if name == "mnist" else contextlib.nullcontext()
    with guard:
        init_params, _, _, _ = port_arrays(p.ts)
        for i in range(3):
            b = batch(name, 10 + i)
            if i == 1:
                tt, ts = p.port_twin(remat=True)
                base_tt, base_ts = p.port_twin()
                _, remat_logs = tt.train_step(ts, b)
                _, base_logs = base_tt.train_step(base_ts, b)
                assert float(remat_logs["loss"]) == float(base_logs["loss"])
                remat, base = port_arrays(ts), port_arrays(base_ts)
                for got, want in zip(remat[:3], base[:3]):
                    for k in want:
                        if isinstance(want[k], dict):
                            for n in want[k]:
                                np.testing.assert_array_equal(
                                    got[k][n], want[k][n], err_msg=n)
                        else:
                            np.testing.assert_array_equal(got[k], want[k],
                                                          err_msg=k)
            p.js, jlogs = p.jt.train_step(p.js, b)
            p.ts, tlogs = p.tt.train_step(p.ts, b)
            np.testing.assert_allclose(float(tlogs["loss"]),
                                       float(jlogs["loss"]), rtol=1e-5,
                                       err_msg=f"{name} step {i}")
            assert_state_close(p.js, p.ts, kind)
            if name == "resnet50" and i == 0:
                # LR 0 on the schedule's first step: the params stay
                after, _, _, count = port_arrays(p.ts)
                for k, v in init_params.items():
                    np.testing.assert_array_equal(after[k], v, err_msg=k)
                assert count == 1
        if name == "resnet50":
            assert port_arrays(p.ts)[3] == 3
        b = batch(name, 20)
        want = p.jt.eval_step(p.js, b, p.jt.new_metric_states())
        got = p.tt.eval_step(p.ts, b, p.tt.new_metric_states())
        assert set(got) == set(want)
        for k in want:
            if k == "_loss":
                np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                           rtol=1e-5)
            else:
                np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                              err_msg=k)
        # remat + accumulation 2 against the reference's same knobs
        knobs = dict(remat=True, grad_accum=2)
        jt = JTrainer(p.jspec, build_mesh(devices=jax.devices()[:1]), **knobs)
        tt, ts = p.port_twin(**knobs)
        js, _ = jt.train_step(p.js, batch(name, 30))
        ts, _ = tt.train_step(ts, batch(name, 30))
        assert_state_close(js, ts, kind)


def case_checkpoint_and_export(name):
    """A checkpoint restores bit for bit (params, optimizer slots and
    schedule count, buffers, step) into a fresh state, and the export
    predicts as the state does."""
    from elasticdl_tpu_torch.training import export
    from elasticdl_tpu_torch.training.checkpoint import CheckpointManager

    _, tspec = specs(name)
    tt = Trainer(tspec, device="cpu")
    ts = tt.init_state(None)
    guard = no_dropout(tspec) if name == "mnist" else contextlib.nullcontext()
    with guard:
        for i in range(2):
            tt.train_step(ts, batch(name, 40 + i))
    with tempfile.TemporaryDirectory() as d:
        CheckpointManager(os.path.join(d, "ckpt")).save(ts, wait=True)
        _, fresh_spec = specs(name)
        ft = Trainer(fresh_spec, device="cpu")
        fs = ft.init_state(None)
        CheckpointManager(os.path.join(d, "ckpt")).restore(fs)
        assert fs.step == ts.step == 2
        for got, want in zip(port_arrays(fs), port_arrays(ts)):
            if isinstance(want, dict):
                for k, v in want.items():
                    if isinstance(v, dict):
                        for n in v:
                            np.testing.assert_array_equal(got[k][n], v[n])
                    else:
                        np.testing.assert_array_equal(got[k], v, err_msg=k)
            else:
                assert got == want
        out = export.export_model(ts, os.path.join(d, "export"),
                                  model_def=MODELS[name][0],
                                  model_params=tspec.model_params)
        with zoo(TZOO):
            model, _ = export.load_model(out, TZOO, device="cpu")
        b = batch(name, 50)
        feats = ({k: torch.from_numpy(v) for k, v in b["features"].items()}
                 if isinstance(b["features"], dict)
                 else torch.from_numpy(b["features"]))
        with torch.no_grad():
            np.testing.assert_array_equal(
                model(feats, training=False).numpy(),
                tt.predict_step(ts, b).numpy())


def case_forward_bf16(name):
    p = Pair(name, "bfloat16")
    assert p.tt.model.compute_dtype == torch.bfloat16
    b = batch(name, 2)
    want = np.asarray(p.jt.predict_step(p.js, b))
    got = p.tt.predict_step(p.ts, b).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-2,
                               err_msg=name)


# ------------------------------------------------------------- parsing


def case_parsers_bit_equal():
    """Census CSV, MNIST, CIFAR-10 and ImageNet records through each
    package's `dataset_fn`: the same arrays bit for bit."""
    from elasticdl_tpu_torch.data import parsing
    from elasticdl_tpu_torch.data.reader import SyntheticDataReader

    for kind, model_def, meta in (
            ("census", "census.wide_deep", None),
            ("mnist", "mnist.mnist_cnn", None),
            ("cifar10", "cifar10.resnet", None),
            ("imagenet224", "resnet50.resnet50", {"image_size": 32})):
        reader = SyntheticDataReader(kind=kind, num_records=24)
        records = list(reader.read_records(f"synthetic-{kind}-0", 0, 24))
        outs = []
        for root in (JZOO, TZOO):
            with zoo(root):
                import importlib

                module = importlib.import_module(model_def)
                fn = module.dataset_fn("training", meta)
            outs.append(parsing.as_batch_parser(fn)(records))
        (jf, jl), (tf, tl) = outs
        np.testing.assert_array_equal(tl, jl, err_msg=kind)
        if isinstance(jf, dict):
            assert set(tf) == set(jf) == {"dense", "cat"}
            for k in jf:
                assert tf[k].dtype == jf[k].dtype, (kind, k)
                np.testing.assert_array_equal(tf[k], jf[k], err_msg=kind)
        else:
            assert tf.dtype == jf.dtype and tf.shape == jf.shape, kind
            np.testing.assert_array_equal(tf, jf, err_msg=kind)


def case_feature_spec_kinds_bit_equal():
    """Every feature kind (numeric, bucketized, hashed and lookup from
    strings and integers, bags) through the host half, the numpy
    composition and the device half: the reference's ids and values."""
    from elasticdl_tpu.api import feature_spec as jfs
    from elasticdl_tpu_torch.api import feature_spec as tfs

    def spec(fs):
        return fs.FeatureSpec([
            fs.numeric("x", standardize=(1.5, 2.0)),
            fs.numeric("y", log1p=True),
            fs.bucketized("xb", (0.0, 1.0, 2.5), source="x"),
            fs.hashed("s", 50, strings=True),
            fs.hashed("i", 64),
            fs.lookup("w", ["a", "b", "c"], num_oov=2),
            fs.lookup("n", [7, 3, 11], num_oov=1),
            fs.hashed_bag("hb", 32, 3, strings=True),
            fs.lookup_bag("lb", ["p", "q"], 2),
        ])

    js, ts = spec(jfs), spec(tfs)
    r = np.random.RandomState(3)
    cols = {"x": r.randn(12).astype(np.float32) * 3,
            "y": r.rand(12).astype(np.float32) * 9,
            "s": np.array([f"v{k}" for k in r.randint(0, 30, 12)]),
            "i": r.randint(-1000, 1000, 12).astype(np.int32),
            "w": np.array(list("abcdxyabcdzz")),
            "n": np.array([7, 3, 11, 5, 7, 0, 3, 11, 2, 7, 7, 9], np.int32),
            "hb": np.array(["a|b", "c", "", "d|e|f|g"] * 3, dtype=object),
            "lb": np.array(["p", "q|p", "z", ""] * 3, dtype=object)}
    assert ts.total_vocab == js.total_vocab and ts.offsets == js.offsets
    want, got = js.transform(cols), ts.transform(cols)
    for k in ("dense", "cat"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in want["bags"]:
        np.testing.assert_array_equal(got["bags"][k], want["bags"][k])
    inter = js.host_transform(cols)
    dev = ts.device_transform({k: torch.from_numpy(np.asarray(v))
                               for k, v in ts.host_transform(cols).items()})
    jdev = js.device_transform(inter)
    np.testing.assert_array_equal(dev["cat"].numpy(), np.asarray(jdev["cat"]))
    # log1p in two libraries (tests/test_torch_preprocessing.py's bound)
    np.testing.assert_allclose(dev["dense"].numpy(), np.asarray(jdev["dense"]),
                               rtol=1e-6)
    row = {k: v[0] for k, v in cols.items()}
    trow, jrow = ts.transform_row(row), js.transform_row(row)
    for k in ("dense", "cat"):
        np.testing.assert_array_equal(trow[k], jrow[k])


def case_host_preprocessing_bit_equal():
    """The rest of `api/preprocessing.py` against the reference's:
    `hash_strings`, `StringLookup`, `pad_to_dense`, `fit_discretization`,
    `vocab_from_file`, and `concat_with_offset` and `int_lookup` on
    tensors."""
    from elasticdl_tpu.api import preprocessing as jpp
    from elasticdl_tpu_torch.api import preprocessing as tpp

    words = ["a", "b", "Bachelors", "", "x y", "b", "ünï"]
    for bins in (1, 7, 1000):
        np.testing.assert_array_equal(tpp.hash_strings(words, bins),
                                      jpp.hash_strings(words, bins))
    vocab = ["b", "a", "c"]
    np.testing.assert_array_equal(tpp.StringLookup(vocab, 2)(words),
                                  jpp.StringLookup(vocab, 2)(words))
    rows = [[1, 2, 3], [], [4], [5, 6, 7, 8]]
    np.testing.assert_array_equal(tpp.pad_to_dense(rows, 3),
                                  jpp.pad_to_dense(rows, 3))
    values = np.random.RandomState(9).randn(500) * 3
    values[::50] = np.nan
    for bins in (1, 2, 10):
        got = tpp.fit_discretization(values, bins)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jpp.fit_discretization(values, bins))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "vocab.txt")
        with open(path, "w", encoding="utf-8") as f:
            f.write("x\n\ny\nx\nz\nw\n")
        for size in (None, 2):
            assert (tpp.vocab_from_file(path, max_size=size)
                    == jpp.vocab_from_file(path, max_size=size))
    groups = [np.array([[0, 3], [-1, 2]], np.int32),
              np.array([[1], [4]], np.int32)]
    got = tpp.concat_with_offset([torch.from_numpy(g) for g in groups], (5, 9))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jpp.concat_with_offset(groups, (5, 9))))
    ids = np.array([7, 3, 11, 5, -2, 0, 3], np.int32)
    for oov in (0, 1, 3):
        np.testing.assert_array_equal(
            tpp.int_lookup(torch.from_numpy(ids), [7, 3, 11], oov).numpy(),
            np.asarray(jpp.int_lookup(ids, [7, 3, 11], oov)))


# ------------------------------------------------------------- layers, optimizers


def case_sgd_nesterov_decay_equivalence():
    """optax.chain(add_decayed_weights(1e-4), sgd(0.1, momentum 0.9,
    nesterov)) and the port's ResNet-20 optimizer (torch's SGD with
    weight_decay, momentum and nesterov) over 4 steps; then optax's
    warmup-cosine schedule from 0 (warmup 2, 6 steps) and the port's
    ResNet-50 `WarmupCosineSGD` over 7 steps (LR 0 on the first)."""
    r = np.random.RandomState(5)
    p0 = r.randn(17).astype(np.float32)
    grads = [r.randn(17).astype(np.float32) for _ in range(7)]
    with zoo(TZOO):
        import importlib

        resnet = importlib.import_module("cifar10.resnet")
        resnet50 = importlib.import_module("resnet50.resnet50")
        cases = (
            (optax.chain(optax.add_decayed_weights(1e-4),
                         optax.sgd(0.1, momentum=0.9, nesterov=True)),
             resnet.optimizer(learning_rate=0.1, weight_decay=1e-4), 4),
            (optax.chain(optax.add_decayed_weights(1e-4), optax.sgd(
                optax.warmup_cosine_decay_schedule(0.0, 0.1, 2, 6),
                momentum=0.9, nesterov=True)),
             resnet50.optimizer(learning_rate=0.1, warmup_steps=2,
                                total_steps=6, weight_decay=1e-4), 7))
    for tx, make, steps in cases:
        jp, state = jnp.asarray(p0), None
        state = tx.init(jp)
        tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
        opt = make([tp])
        for g in grads[:steps]:
            upd, state = tx.update(jnp.asarray(g), state, jp)
            jp = optax.apply_updates(jp, upd)
            tp.grad = torch.from_numpy(g.copy())
            opt.step()
            np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                                       rtol=1e-6, atol=1e-7)
        trace = find_states(state)["TraceState"].trace
        np.testing.assert_allclose(opt.state[tp]["momentum_buffer"].numpy(),
                                   np.asarray(trace), rtol=1e-6, atol=1e-7)


def case_same_padding():
    """A 3x3 stride-2 conv over an even side: flax's SAME pads (0, 1);
    the port's Conv gives flax's numbers, torch's padding=1 does not."""
    from elasticdl_tpu_torch.api.layers import Conv

    r = np.random.RandomState(6)
    x = r.randn(2, 8, 8, 3).astype(np.float32)
    flax_conv = fnn.Conv(4, (3, 3), (2, 2), use_bias=False)
    v = flax_conv.init(jax.random.PRNGKey(0), x)
    want = np.asarray(flax_conv.apply(v, x)).transpose(0, 3, 1, 2)
    conv = Conv(3, 4, (3, 3), (2, 2), use_bias=False)
    conv.load_state_dict(convert.params_from_flax(v["params"], conv))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = conv(xt).numpy()
        naive = torch.nn.functional.conv2d(xt, conv.weight, stride=2,
                                           padding=1).numpy()
    assert got.shape == want.shape == naive.shape == (2, 4, 4, 4)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert not np.allclose(naive, want, atol=1e-3)


def case_batchnorm_matches_flax(dtype):
    """The port's BatchNorm against flax's: train output, the updated
    running averages, eval output, and the gradients of the input, scale
    and bias."""
    from elasticdl_tpu_torch.api.layers import BatchNorm, update_batch_stats

    r = np.random.RandomState(7)
    x = (r.randn(6, 5, 5, 4) * 2 + 3).astype(np.float32)
    jdt = getattr(jnp, dtype)
    bn = fnn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=jdt)
    v = {"params": {"scale": jnp.asarray(r.rand(4) + 0.5, jnp.float32),
                    "bias": jnp.asarray(r.randn(4), jnp.float32)},
         "batch_stats": {"mean": jnp.asarray(r.randn(4), jnp.float32),
                         "var": jnp.asarray(r.rand(4) + 0.5, jnp.float32)}}
    w = r.randn(6, 5, 5, 4).astype(np.float32)

    def loss(params, xx):
        y, new = bn.apply({"params": params,
                           "batch_stats": v["batch_stats"]}, xx,
                          use_running_average=False, mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * w), (y, new)

    (_, (y, new)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(v["params"], jnp.asarray(x))
    tbn = BatchNorm(4, dtype=getattr(torch, dtype))
    tbn.load_state_dict({**convert.params_from_flax(v["params"]),
                         **convert.buffers_from_flax(v["batch_stats"])})
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().requires_grad_()
    yt = tbn(xt, training=True)
    (yt.float() * torch.from_numpy(w).permute(0, 3, 1, 2)).sum().backward()
    update_batch_stats(tbn)
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else dict(
        rtol=2 ** -7, atol=2 ** -7)
    np.testing.assert_allclose(
        yt.detach().float().numpy().transpose(0, 2, 3, 1),
        np.asarray(y, np.float32), **tol)
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(tbn, k).numpy(),
                                   np.asarray(new["batch_stats"][k]),
                                   rtol=1e-6, atol=1e-6)
    if dtype == "float32":
        np.testing.assert_allclose(xt.grad.numpy().transpose(0, 2, 3, 1),
                                   np.asarray(gx), rtol=1e-5, atol=1e-5)
        for k in ("scale", "bias"):
            np.testing.assert_allclose(getattr(tbn, k).grad.numpy(),
                                       np.asarray(gp[k]), rtol=1e-5,
                                       atol=1e-5)
    y_eval = bn.apply({"params": v["params"],
                       "batch_stats": new["batch_stats"]}, x,
                      use_running_average=True)
    with torch.no_grad():
        np.testing.assert_allclose(
            tbn(xt, training=False).float().numpy().transpose(0, 2, 3, 1),
            np.asarray(y_eval, np.float32), **tol)


def test_zoo_models_against_the_reference(monkeypatch):
    """Every case above, in one collected test (ROADMAP.md, conventions:
    one collected test per port test file)."""
    monkeypatch.setenv("EDL_EMB_SCATTER", "sorted")
    case_same_padding()
    for dtype in ("float32", "bfloat16"):
        case_batchnorm_matches_flax(dtype)
    case_sgd_nesterov_decay_equivalence()
    case_feature_spec_kinds_bit_equal()
    case_host_preprocessing_bit_equal()
    case_parsers_bit_equal()
    for name in MODELS:
        pair = Pair(name, stages=STAGES.get(name))
        case_forward(pair)
        case_steps_eval_and_remat(pair)
        case_checkpoint_and_export(name)
    for name in ("xdeepfm", "resnet20"):
        case_forward_bf16(name)
