"""The port's serving export (`training/export.export_saved_model`,
`load_saved_model`) against the reference's, on the CPU.

- DeepFM (`field_vocab=1000`, `hidden=32,32`, float32): the reference
  trains one step on a one-device mesh (exact embedding backward), its
  params cross over with `convert.params_from_flax`, and each side
  exports its own serving artifact: the reference's jax2tf SavedModel
  (`tf.saved_model.load(path).serve`) and the port's `torch.export`
  program. The same seeded batch served through both agrees at rtol 1e-4
  with atol 1e-4, the reference's own test tolerance
  (`tests/test_export.py`), and 3 rows serve with shape (3,): the batch
  dimension is symbolic on both sides.
- The transformer LM (`vocab=64;num_layers=2;dim=32;heads=4`, float32,
  T 16) from the reference's initial params, exported at batch 4: the
  port's served logits on 9 rows and on 3 against the reference's
  `model.apply(..., training=False)` on the 9 with its
  materialized attention (its CPU default), at
  `tests/test_torch_transformer.py`'s float32 tolerance (rtol 5e-5 with
  atol 5e-5 of the largest logit: only the summation order differs); the
  exported graph calls `edl::flash_fwd` once a layer.

`tests/test_torch_serving_zoo.py` holds the other zoo models and LM
configurations to the port's own eager `load_model`, and checks the op
and the refusals. The two files are one test each; together they would
run well past a file's budget (TensorFlow's import alone is ~10 s).
"""

import contextlib
import os
import sys

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from elasticdl_tpu.common.config import JobConfig as JJobConfig
from elasticdl_tpu.parallel.mesh import build_mesh
from elasticdl_tpu.training import export as jexport
from elasticdl_tpu.training.model_spec import ModelSpec as JModelSpec
from elasticdl_tpu.training.trainer import Trainer as JTrainer
from elasticdl_tpu_torch import convert
from elasticdl_tpu_torch.common.config import JobConfig
from elasticdl_tpu_torch.training import export
from elasticdl_tpu_torch.training.model_spec import ModelSpec
from elasticdl_tpu_torch.training.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JZOO = os.path.join(REPO, "model_zoo")
TZOO = os.path.join(REPO, "elasticdl_tpu_torch", "model_zoo")
DEEPFM = ("deepfm.deepfm.custom_model", "field_vocab=1000;hidden=32,32")
LM = ("transformer.transformer_lm.custom_model",
      "vocab=64;num_layers=2;dim=32;heads=4;max_len=32;seq_parallel=none")
LAYERS, VOCAB, T = 2, 64, 16


@contextlib.contextmanager
def zoo(root):
    """Both zoos name their modules `deepfm.deepfm` and
    `transformer.transformer_lm`: import with `root` first on sys.path
    and the other zoo's cached modules set aside."""
    def ours(k):
        return k.split(".")[0] in ("deepfm", "transformer")

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


def _specs(model_def, params):
    """(reference ModelSpec, port ModelSpec), float32 compute."""
    out = []
    for root, cfg_cls, spec_cls in ((JZOO, JJobConfig, JModelSpec),
                                    (TZOO, JobConfig, ModelSpec)):
        with zoo(root):
            out.append(spec_cls.from_config(cfg_cls.from_argv([
                "--model_zoo", root, "--model_def", model_def,
                "--model_params", params, "--compute_dtype", "float32"])))
    return out


def _deepfm_batch(b, seed):
    r = np.random.RandomState(seed)
    return {
        "features": {"dense": (r.rand(b, 13) * 20).astype(np.float32),
                     "cat": r.randint(0, 1 << 30, (b, 26)).astype(np.int32)},
        "labels": r.randint(0, 2, (b,)).astype(np.int32),
        "mask": np.ones((b,), np.float32),
    }


def _lm_batch(b, seed):
    r = np.random.RandomState(seed)
    return {"features": r.randint(0, VOCAB, (b, T)).astype(np.int32),
            "labels": r.randint(0, VOCAB, (b, T)).astype(np.int32),
            "mask": np.ones((b,), np.float32)}


def _torch(features):
    if isinstance(features, dict):
        return {k: torch.from_numpy(v) for k, v in features.items()}
    return torch.from_numpy(features)


def _port_export(params, tspec, model_def, example, out):
    """The port's export of the reference's `params` and its serving
    program's directory."""
    tt = Trainer(tspec, device="cpu")
    ts = tt.init_state(example)
    tt.model.load_state_dict(convert.params_from_flax(
        jax.device_get(params), tt.model))
    with zoo(TZOO):
        export.export_model(ts, out, model_def=model_def,
                            model_params=tspec.model_params,
                            module_name=tspec.module_name)
        return export.export_saved_model(out, TZOO, example["features"],
                                         device="cpu")


def case_deepfm_against_the_reference_saved_model(tmp):
    tf = pytest.importorskip("tensorflow")
    jspec, tspec = _specs(*DEEPFM)
    jt = JTrainer(jspec, build_mesh(devices=jax.devices()[:1]), seed=0)
    example = _deepfm_batch(16, 0)
    js = jt.init_state(example)
    js, _ = jt.train_step(js, _deepfm_batch(16, 1))
    with zoo(JZOO):
        jexport.export_model(js, os.path.join(tmp, "ref"),
                             model_def=DEEPFM[0],
                             model_params=jspec.model_params)
        jpath = jexport.export_saved_model(os.path.join(tmp, "ref"), JZOO,
                                           example["features"])
    assert jpath is not None, "jax2tf/TF unavailable"
    jserve = tf.saved_model.load(jpath).serve
    tpath = _port_export(js.params, tspec, DEEPFM[0], example,
                         os.path.join(tmp, "port"))
    assert tpath == os.path.join(tmp, "port", "saved_model")
    serve = export.load_saved_model(tpath, device="cpu")
    batch = _deepfm_batch(16, 11)
    want = np.asarray(jserve(batch["features"]))
    with torch.no_grad():
        got = serve(_torch(batch["features"])).numpy()
    assert got.dtype == np.float32 and got.shape == (16,)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    small = {k: v[:3] for k, v in batch["features"].items()}
    with torch.no_grad():
        got3 = serve(_torch(small)).numpy()
    assert got3.shape == (3,) == np.asarray(jserve(small)).shape
    np.testing.assert_allclose(got3, want[:3], rtol=1e-4, atol=1e-4)


def case_lm_against_the_reference_apply(tmp):
    jspec, tspec = _specs(*LM)
    example = _lm_batch(4, 0)
    init = jax.jit(lambda key, x: jspec.model.init(key, x, training=False))
    params = fnn.meta.unbox(init(jax.random.PRNGKey(0),
                                 example["features"])["params"])
    tpath = _port_export(params, tspec, LM[0], example,
                         os.path.join(tmp, "lm"))
    serve = export.load_saved_model(tpath, device="cpu")
    calls = [n for n in serve.graph.nodes
             if n.target is torch.ops.edl.flash_fwd.default]
    assert len(calls) == LAYERS, serve.graph
    # one reference program, on 9 rows; the port serves them, and 3
    tokens = _lm_batch(9, 5)["features"]
    want = np.asarray(jspec.model.apply({"params": params}, tokens,
                                        training=False))
    for b in (9, 3):
        with torch.no_grad():
            got = serve(torch.from_numpy(tokens[:b])).numpy()
        assert got.shape == (b, T, VOCAB)
        np.testing.assert_allclose(got, want[:b], rtol=5e-5,
                                   atol=5e-5 * np.abs(want).max())


def test_serving_export_against_the_reference(tmp_path):
    """Every case above, in one collected test (ROADMAP.md, conventions:
    one collected test per port test file). The reference runs the exact
    sorted embedding backward and its materialized attention."""
    tmp = str(tmp_path)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("EDL_EMB_SCATTER", "sorted")
        mp.delenv("EDL_FLASH", raising=False)
        case_deepfm_against_the_reference_saved_model(tmp)
        case_lm_against_the_reference_apply(tmp)
