"""The port stands alone: it imports no JAX stack and nothing of the
reference package, and it never falls back to the CPU on its own."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "elasticdl_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "elasticdl_tpu")

_PROBE = r"""
import json, sys
before = set(sys.modules)
from elasticdl_tpu_torch.common.config import JobConfig
from elasticdl_tpu_torch.training.model_spec import ModelSpec
from elasticdl_tpu_torch.training.trainer import Trainer
from elasticdl_tpu_torch.ops import embedding, native, placement
from elasticdl_tpu_torch import convert
spec = ModelSpec.from_config(JobConfig.from_argv([
    "--model_zoo", sys.argv[1], "--model_def", "deepfm.deepfm.custom_model",
    "--model_params", "field_vocab=100;hidden=8"]))
print(json.dumps(sorted(set(sys.modules) - before)))
"""


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in FORBIDDEN


def case_port_loads_no_jax_or_reference_module():
    """A subprocess, because this process already imported jax
    (tests/conftest.py)."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", _PROBE, str(PORT / "model_zoo")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "deepfm.deepfm" in loaded and "torch" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def case_no_source_file_of_the_port_imports_them():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) >= 15
    bad = {str(f.relative_to(REPO)): m for f in files for m in _imports(f)
           if _forbidden(m)}
    assert bad == {}


def case_chip_smoke_imports_no_jax():
    bad = [m for m in _imports(REPO / "chip_smoke.py") if _forbidden(m)]
    assert bad == []


def case_trainer_without_device_raises_where_cuda_is_absent():
    from elasticdl_tpu_torch.common import runtime
    from elasticdl_tpu_torch.training.model_spec import ModelSpec
    from elasticdl_tpu_torch.training.trainer import Trainer

    spec = ModelSpec(model=torch.nn.Linear(2, 1), loss=None, optimizer=None,
                     dataset_fn=None, eval_metrics_fn=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(spec)
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        runtime.resolve_device("cuda")
    assert Trainer(spec, device="cpu").device.type == "cpu"


def test_port_stands_alone():
    """Every case above, in one collected test (ROADMAP.md, conventions:
    one collected test per port test file)."""
    case_port_loads_no_jax_or_reference_module()
    case_no_source_file_of_the_port_imports_them()
    case_chip_smoke_imports_no_jax()
    if not torch.cuda.is_available():
        # where a card is present, Trainer(spec) runs there instead
        case_trainer_without_device_raises_where_cuda_is_absent()
