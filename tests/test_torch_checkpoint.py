"""The port's checkpoint manager, export and state conversion, on the CPU.

A small DeepFM (`field_vocab=1000`, `hidden=32,32`, float32) trains a few
steps with the port's Trainer. Cases:

- save, restore into a fresh state and keep-max: the restored params,
  Adam slots, generator state and step equal the saved state's exactly
  (a checkpoint is a byte copy of host tensors);
- a corrupted newest step is walked past to the previous one;
- restoring into a model of another geometry raises
  `CheckpointGeometryError` and leaves the state untouched;
- export, `read_info` and `load_model` round-trip: the loaded model's
  outputs equal the trained state's exactly; `export_saved_model` raises;
- `convert.train_state_from_flax` raises on a missing key or a wrong
  shape in the params or in Adam's moments.
"""

import contextlib
import json
import os
import sys

import numpy as np
import pytest
import torch

from elasticdl_tpu_torch import convert
from elasticdl_tpu_torch.common.config import JobConfig
from elasticdl_tpu_torch.training import export
from elasticdl_tpu_torch.training.checkpoint import (
    CheckpointGeometryError, CheckpointManager)
from elasticdl_tpu_torch.training.model_spec import ModelSpec
from elasticdl_tpu_torch.training.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZOO = os.path.join(REPO, "elasticdl_tpu_torch", "model_zoo")
B = 64


@contextlib.contextmanager
def zoo(root):
    """Both zoos name their module `deepfm.deepfm`, and ModelSpec and
    load_model import it by that name: run with `root` first on sys.path
    and any cached `deepfm` modules (the reference zoo's, from another
    test in this process) set aside."""
    names = [k for k in sys.modules if k == "deepfm" or k.startswith("deepfm.")]
    saved = {k: sys.modules.pop(k) for k in names}
    path = list(sys.path)
    try:
        sys.path.insert(0, root)
        yield
    finally:
        for k in [k for k in sys.modules
                  if k == "deepfm" or k.startswith("deepfm.")]:
            del sys.modules[k]
        sys.modules.update(saved)
        sys.path[:] = path


def _trainer(params="field_vocab=1000;hidden=32,32", seed=0):
    cfg = JobConfig.from_argv([
        "--model_zoo", ZOO, "--model_def", "deepfm.deepfm.custom_model",
        "--model_params", params, "--compute_dtype", "float32"])
    return Trainer(ModelSpec.from_config(cfg), device="cpu", seed=seed)


def _batch(seed):
    r = np.random.RandomState(seed)
    return {
        "features": {"dense": (r.rand(B, 13) * 20).astype(np.float32),
                     "cat": r.randint(0, 1 << 30, (B, 26)).astype(np.int32)},
        "labels": r.randint(0, 2, (B,)).astype(np.int32),
        "mask": np.ones((B,), np.float32),
    }


def _snapshot(state):
    return ({k: p.detach().clone() for k, p in state.params.items()},
            {i: {k: v.clone() for k, v in s.items()}
             for i, s in state.optimizer.state_dict()["state"].items()},
            state.generator.get_state().clone(), state.step)


def _assert_state_equals(state, snap):
    params, slots, gen, step = snap
    assert state.step == step
    for k, p in state.params.items():
        assert torch.equal(p.detach(), params[k]), k
    got = state.optimizer.state_dict()["state"]
    assert set(got) == set(slots)
    for i, s in got.items():
        for k, v in s.items():
            assert torch.equal(v, slots[i][k]), (i, k)
    assert torch.equal(state.generator.get_state(), gen)


def _train(tr, state, steps, seed=1):
    for i in range(steps):
        state, _ = tr.train_step(state, _batch(seed + i))
    return state


def case_save_restore_and_keep_max(tmp):
    tr = _trainer()
    state = tr.init_state(_batch(0))
    mngr = CheckpointManager(tmp, keep=2)
    assert mngr.latest_step() is None and mngr.restore(state) is None
    snaps = {}
    for _ in range(3):
        state = _train(tr, state, 1, seed=state.step + 1)
        mngr.save(state)
        snaps[state.step] = _snapshot(state)
    mngr.wait()
    assert mngr.all_steps() == [2, 3] and mngr.latest_step(refresh=True) == 3
    assert json.load(open(os.path.join(tmp, "embedding_geometry.json")))[
        "geometry_version"] == 2
    assert not [n for n in os.listdir(tmp) if n.startswith(".tmp")]

    fresh_tr = _trainer(seed=5)
    fresh = fresh_tr.init_state(_batch(0))
    assert mngr.restore(fresh) is fresh and mngr.last_restored_step == 3
    _assert_state_equals(fresh, snaps[3])
    # a restored state trains on exactly as the saved one does
    a = _train(tr, state, 1, seed=9)
    b = _train(fresh_tr, fresh, 1, seed=9)
    for k in a.params:
        assert torch.equal(a.params[k].detach(), b.params[k].detach()), k
    # an explicit step, and a save at a step already on disk keeps it
    other = _trainer().init_state(_batch(0))
    mngr.restore(other, step=2)
    _assert_state_equals(other, snaps[2])
    assert mngr.save(other) == 2
    mngr.close()
    return snaps


def case_walk_back_past_a_corrupt_newest_step(tmp, snaps):
    path = os.path.join(tmp, "3", "state.pt")
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 3)
    mngr = CheckpointManager(tmp, keep=2)
    state = _trainer().init_state(_batch(0))
    assert mngr.restore(state) is state and mngr.last_restored_step == 2
    _assert_state_equals(state, snaps[2])
    with pytest.raises(RuntimeError, match="failed to restore"):
        mngr.restore(state, step=3)
    mngr.delete(3)
    assert mngr.all_steps() == [2]


def case_geometry_mismatch_raises(tmp):
    tr = _trainer("field_vocab=2000;hidden=32,32")
    state = tr.init_state(_batch(0))
    before = _snapshot(state)
    with pytest.raises(CheckpointGeometryError,
                       match="fm_embedding.table: model wants"):
        CheckpointManager(tmp).restore(state)
    _assert_state_equals(state, before)


def case_export_round_trip(tmp):
    tr = _trainer()
    state = _train(tr, tr.init_state(_batch(0)), 2)
    out = export.export_model(
        state, tmp, model_def="deepfm.deepfm.custom_model",
        model_params=tr.spec.model_params, module_name=tr.spec.module_name)
    info = export.read_info(out)
    assert info["step"] == 2 and info["model_def"] == "deepfm.deepfm.custom_model"
    assert info["num_params"] == sum(p.numel() for p in state.params.values())
    assert sorted(os.listdir(out)) == ["model_info.json", "params.pt"]
    model, variables = export.load_model(out, ZOO, device="cpu")
    assert set(variables["params"]) == set(state.params)
    batch = _batch(3)
    with torch.no_grad():
        got = model({k: torch.from_numpy(v)
                     for k, v in batch["features"].items()}, training=False)
    want = tr.predict_step(state, batch)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    with pytest.raises(NotImplementedError, match="jax2tf"):
        export.export_saved_model(out, ZOO, batch["features"])


def case_convert_rejects_bad_state():
    model = _trainer().spec.model
    r = np.random.RandomState(0)

    def tree():
        # 26 fields x 1000 ids, padded to a multiple of 256 rows
        out = {"fm_embedding": {"table": r.rand(26112, 17)},
               "dense_linear": {"kernel": r.rand(13, 1), "bias": r.rand(1)},
               "dnn_0": {"kernel": r.rand(429, 32), "bias": r.rand(32)},
               "dnn_1": {"kernel": r.rand(32, 32), "bias": r.rand(32)},
               "dnn_out": {"kernel": r.rand(32, 1), "bias": r.rand(1)},
               "bias": r.rand(1)}
        return out

    good = convert.train_state_from_flax(tree(), tree(), tree(), 3, 7, model)
    assert good["count"] == 3 and good["step"] == 7
    assert set(good["exp_avg"]) == set(good["exp_avg_sq"]) == set(
        model.state_dict())
    missing = tree()
    del missing["dnn_out"]
    with pytest.raises(ValueError, match="dnn_out"):
        convert.train_state_from_flax(tree(), missing, tree(), 3, 7, model)
    wrong = tree()
    wrong["dnn_1"]["kernel"] = r.rand(32, 33)
    with pytest.raises(ValueError):
        convert.train_state_from_flax(tree(), tree(), wrong, 3, 7, model)
    with pytest.raises(ValueError):
        convert.train_state_from_flax(wrong, tree(), tree(), 3, 7, model)


def test_checkpoint_and_export(tmp_path):
    """Every case above, in one collected test (ROADMAP.md, conventions:
    one collected test per port test file)."""
    ckpt = str(tmp_path / "ckpt")
    with zoo(ZOO):
        snaps = case_save_restore_and_keep_max(ckpt)
        case_walk_back_past_a_corrupt_newest_step(ckpt, snaps)
        case_geometry_mismatch_raises(ckpt)
        case_export_round_trip(str(tmp_path / "export"))
        case_convert_rejects_bad_state()
