"""The port's serving export for every other zoo model and LM
configuration, and `edl::flash_fwd` itself, on the CPU.

Each model trains one step with the port's Trainer, is exported
(`export_model`), traced into a serving program (`export_saved_model`,
example batch 4) and loaded back (`load_saved_model`); the program's
outputs on 7, 3 and 1 rows must equal the eager `load_model` model's on
the same rows bit for bit: the program runs the same aten ops in the
same order, and only the batch dimension is symbolic. The models:
xDeepFM, Census Wide & Deep, the MNIST CNN, ResNet-20 (depth 8) and
ResNet-50 (32x32, 10 classes) at the widths of `tests/test_torch_zoo.py`,
float32; the transformer LM's Switch-MoE configuration (float32: the
MoE's index route, whose `torch.nonzero` count is data-dependent, traces
with a symbolic capacity), its pipelined configuration (no `pp` axis:
the stacked stages folded in turn) and its tensor-parallel one (no mesh:
the split Dense whole), both in bfloat16. Each LM program calls
`edl::flash_fwd` once a layer.

`edl::flash_fwd`: `torch.library.opcheck` (schema, fake rule, autograd
registration, AOT dispatch with dynamic shapes) in float32 and bfloat16,
with its outputs bit-equal to `flash_fwd_plain`'s. Refusals: a program
exported on the CPU does not load for another device, and an example
batch under 2 does not export.
"""

import contextlib
import os
import sys

import numpy as np
import pytest
import torch

from elasticdl_tpu_torch.common.config import JobConfig
from elasticdl_tpu_torch.ops import flash_attention as fa
from elasticdl_tpu_torch.training import export
from elasticdl_tpu_torch.training.model_spec import ModelSpec
from elasticdl_tpu_torch.training.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZOO = os.path.join(REPO, "elasticdl_tpu_torch", "model_zoo")
ZOO_PACKAGES = ("deepfm", "mnist", "cifar10", "resnet50", "census",
                "transformer")
LM = ("transformer.transformer_lm.custom_model",
      "vocab=64;num_layers=2;dim=32;heads=4;max_len=32;seq_parallel=none")
# name: (model_def, model_params, compute dtype, LM layers or 0)
MODELS = {
    "xdeepfm": ("deepfm.xdeepfm.custom_model",
                "field_vocab=1000;hidden=32,16;cin_sizes=16,16", "float32",
                0),
    "wide_deep": ("census.wide_deep.custom_model", "hidden=32,16",
                  "float32", 0),
    "mnist": ("mnist.mnist_cnn.custom_model", "", "float32", 0),
    "resnet20": ("cifar10.resnet.custom_model", "depth=8", "float32", 0),
    "resnet50": ("resnet50.resnet50.custom_model", "num_classes=10",
                 "float32", 0),
    "lm_moe": (LM[0], LM[1] + ";moe_experts=4", "float32", 2),
    "lm_pp": (LM[0], LM[1] + ";pp_axis=pp;pp_microbatches=2", "bfloat16",
              2),
    "lm_tp": (LM[0], LM[1] + ";tp_axis=model", "bfloat16", 2),
}


@contextlib.contextmanager
def zoo():
    """The reference's zoo names its modules alike (`deepfm.xdeepfm`,
    `cifar10.resnet`, ...), and another test file in this process may
    have imported them: import with the port's zoo first on sys.path and
    any cached zoo modules set aside."""
    def ours(k):
        return k.split(".")[0] in ZOO_PACKAGES

    saved = {k: sys.modules.pop(k) for k in [k for k in sys.modules
                                             if ours(k)]}
    path = list(sys.path)
    try:
        sys.path.insert(0, ZOO)
        yield
    finally:
        for k in [k for k in sys.modules if ours(k)]:
            del sys.modules[k]
        sys.modules.update(saved)
        sys.path[:] = path


def _batch(name, b, seed):
    r = np.random.RandomState(seed)
    if name == "mnist":
        feats = r.rand(b, 28, 28, 1).astype(np.float32)
    elif name in ("resnet20", "resnet50"):
        feats = r.rand(b, 32, 32, 3).astype(np.float32)
    elif name == "wide_deep":
        feats = {"dense": r.randn(b, 5).astype(np.float32),
                 "cat": r.randint(0, 200, (b, 9)).astype(np.int32)}
    elif name == "xdeepfm":
        feats = {"dense": (r.rand(b, 13) * 20).astype(np.float32),
                 "cat": r.randint(0, 1 << 30, (b, 26)).astype(np.int32)}
    else:
        tokens = r.randint(0, 64, (b, 17)).astype(np.int32)
        return {"features": tokens[:, :-1], "labels": tokens[:, 1:],
                "mask": np.ones((b,), np.float32)}
    classes = 2 if name in ("wide_deep", "xdeepfm") else 10
    return {"features": feats,
            "labels": r.randint(0, classes, (b,)).astype(np.int32),
            "mask": np.ones((b,), np.float32)}


def _torch(features):
    if isinstance(features, dict):
        return {k: torch.from_numpy(v) for k, v in features.items()}
    return torch.from_numpy(features)


def case_served_equals_eager(name, tmp):
    model_def, params, dtype, layers = MODELS[name]
    out = os.path.join(tmp, name)
    with zoo():
        spec = ModelSpec.from_config(JobConfig.from_argv([
            "--model_zoo", ZOO, "--model_def", model_def,
            "--model_params", params, "--compute_dtype", dtype]))
        trainer = Trainer(spec, device="cpu", seed=0)
        state = trainer.init_state(_batch(name, 4, 0))
        state, _ = trainer.train_step(state, _batch(name, 4, 1))
        export.export_model(state, out, model_def=model_def,
                            model_params=spec.model_params,
                            module_name=spec.module_name)
        path = export.export_saved_model(out, ZOO,
                                         _batch(name, 4, 0)["features"],
                                         device="cpu")
        model, _ = export.load_model(out, ZOO, device="cpu")
    serve = export.load_saved_model(path, device="cpu")
    calls = [n for n in serve.graph.nodes
             if n.target is torch.ops.edl.flash_fwd.default]
    assert len(calls) == layers, (name, len(calls))
    features = _batch(name, 7, 2)["features"]
    with torch.no_grad():
        for b in (7, 3, 1):
            part = _torch({k: v[:b] for k, v in features.items()}
                          if isinstance(features, dict) else features[:b])
            want = model(part, training=False)
            got = serve(part)
            assert got.shape == want.shape and got.shape[0] == b, name
            assert torch.equal(got, want), (name, b)
    return path


def case_flash_op(dtype):
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 24, 3, 16, generator=g).to(dtype)
               for _ in range(3))
    for args in ((True, 0, 0), (True, 16, 4), (False, 0, 0)):
        torch.library.opcheck(torch.ops.edl.flash_fwd.default,
                              (q, k, v, *args))
        out, lse = torch.ops.edl.flash_fwd(q, k, v, *args)
        want_out, want_lse = fa.flash_fwd_plain(q, k, v, *args)
        assert out.is_contiguous() and out.dtype == dtype
        assert torch.equal(out, want_out) and torch.equal(lse, want_lse)


def case_refusals(program, tmp):
    with pytest.raises(ValueError, match="exported on cpu"):
        export.load_saved_model(program, device="meta")
    if not torch.cuda.is_available():
        # None means the card, as for every entry point of the port
        with pytest.raises(RuntimeError, match="no CUDA device"):
            export.load_saved_model(program)
    one = _batch("wide_deep", 1, 0)["features"]
    with zoo(), pytest.raises(ValueError, match="at least 2"):
        export.export_saved_model(os.path.dirname(program), ZOO, one,
                                  device="cpu",
                                  out_dir=os.path.join(tmp, "one"))


def test_serving_export_of_the_zoo(tmp_path):
    """Every case above, in one collected test (ROADMAP.md, conventions:
    one collected test per port test file)."""
    tmp = str(tmp_path)
    programs = {name: case_served_equals_eager(name, tmp)
                for name in MODELS}
    for dtype in (torch.float32, torch.bfloat16):
        case_flash_op(dtype)
    case_refusals(programs["wide_deep"], tmp)
