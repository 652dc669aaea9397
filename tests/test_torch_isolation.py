"""The port stands alone: it imports no JAX stack and nothing of the
reference package (the train step, the job path's worker, cohort, mesh,
master, launcher, Kubernetes renderer and pod manager, the model-zoo
verbs, data path, checkpoint and export, the embedding tier,
its layout controller and the program cache, and every zoo model
included), and it never falls back to the CPU on its own: without a card
a worker, a trainer and a default embedding-tier store raise."""

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
from elasticdl_tpu_torch.ops import (
    attention, embedding, flash_attention, moe, native, placement)
from elasticdl_tpu_torch import convert
from elasticdl_tpu_torch.client import api, k8s, local, main as client_main, zoo
from elasticdl_tpu_torch.data import nativelib, parsing, prefetch, reader, recordio
from elasticdl_tpu_torch.master import (
    autoscaler, k8s_instance_manager, layout_controller, main as master_main,
    process_manager)
from elasticdl_tpu_torch.api import callbacks
from elasticdl_tpu_torch.parallel import elastic, mesh, pipeline
from elasticdl_tpu_torch.training import checkpoint, compile_cache, export
from elasticdl_tpu_torch.embedding import (
    cache, data_plane, reshard, sharding, shm, sketch, store, tier, transport)
from elasticdl_tpu_torch.api.layers import TierEmbedding, tier_table_spec
from elasticdl_tpu_torch.analysis import __main__ as lint_main
from elasticdl_tpu_torch.analysis.core import all_rules
from elasticdl_tpu_torch.data import convert as data_convert
from elasticdl_tpu_torch.fleetsim import __main__ as fleetsim_main
from elasticdl_tpu_torch.observability import analyze, incident
all_rules()
from elasticdl_tpu_torch.worker import (
    cohort, main as worker_main, prediction_outputs_processor,
    task_data_service, worker)
spec = ModelSpec.from_config(JobConfig.from_argv([
    "--model_zoo", sys.argv[1], "--model_def", "deepfm.deepfm.custom_model",
    "--model_params", "field_vocab=100;hidden=8"]))
lm = ModelSpec.from_config(JobConfig.from_argv([
    "--model_zoo", sys.argv[1], "--model_def",
    "transformer.transformer_lm.custom_model",
    "--model_params", "vocab=64;num_layers=1;dim=32;heads=2;max_len=16"]))
for params in ("moe_experts=2", "tp_axis=model",
               "pp_axis=pp;seq_parallel=none"):
    ModelSpec.from_config(JobConfig.from_argv([
        "--model_zoo", sys.argv[1], "--model_def",
        "transformer.transformer_lm.custom_model", "--model_params",
        "vocab=64;num_layers=1;dim=32;heads=2;max_len=16;" + params]))
for model_def, params in (
        ("deepfm.xdeepfm", "field_vocab=100;hidden=8;cin_sizes=4"),
        ("census.wide_deep", "hidden=8"),
        ("mnist.mnist_cnn", ""),
        ("cifar10.resnet", "depth=8"),
        ("resnet50.resnet50", "num_classes=10")):
    ModelSpec.from_config(JobConfig.from_argv([
        "--model_zoo", sys.argv[1], "--model_def",
        model_def + ".custom_model", "--model_params", params]))
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
    for name in ("deepfm.deepfm", "transformer.transformer_lm",
                 "deepfm.xdeepfm", "census.wide_deep", "mnist.mnist_cnn",
                 "cifar10.resnet", "resnet50.resnet50", "torch",
                 "elasticdl_tpu_torch.ops.flash_attention",
                 "elasticdl_tpu_torch.ops.moe",
                 "elasticdl_tpu_torch.parallel.pipeline",
                 "elasticdl_tpu_torch.worker.worker",
                 "elasticdl_tpu_torch.worker.cohort",
                 "elasticdl_tpu_torch.parallel.mesh",
                 "elasticdl_tpu_torch.parallel.elastic",
                 "elasticdl_tpu_torch.master.main",
                 "elasticdl_tpu_torch.client.local",
                 "elasticdl_tpu_torch.client.k8s",
                 "elasticdl_tpu_torch.client.zoo",
                 "elasticdl_tpu_torch.master.k8s_instance_manager",
                 "elasticdl_tpu_torch.data.prefetch",
                 "elasticdl_tpu_torch.training.checkpoint",
                 "elasticdl_tpu_torch.proto.service",
                 "elasticdl_tpu_torch.embedding.store",
                 "elasticdl_tpu_torch.embedding.tier",
                 "elasticdl_tpu_torch.embedding.data_plane",
                 "elasticdl_tpu_torch.embedding.reshard",
                 "elasticdl_tpu_torch.master.layout_controller",
                 "elasticdl_tpu_torch.training.compile_cache",
                 "elasticdl_tpu_torch.analysis.torch_rules",
                 "elasticdl_tpu_torch.analysis.concurrency",
                 "elasticdl_tpu_torch.fleetsim.sim",
                 "elasticdl_tpu_torch.data.convert",
                 "elasticdl_tpu_torch.observability.incident",
                 "elasticdl_tpu_torch.observability.analyzer"):
        assert name in loaded, name
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
    assert len(files) >= 60
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


def case_tier_store_without_device_raises_where_cuda_is_absent(monkeypatch):
    """A tier store in device mode (the default) needs the card; host
    mode and the CPU are asked for explicitly."""
    from elasticdl_tpu_torch.embedding.store import EmbeddingShardStore

    monkeypatch.delenv("EDL_EMB_TIER_DEVICE", raising=False)
    for device in (None, True, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            EmbeddingShardStore(0, device=device)
    monkeypatch.setenv("EDL_EMB_TIER_DEVICE", "1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EmbeddingShardStore(0)
    monkeypatch.setenv("EDL_EMB_TIER_DEVICE", "0")
    assert EmbeddingShardStore(0).device is None
    assert EmbeddingShardStore(0, device=False).device is None
    assert EmbeddingShardStore(0, device="cpu").device.type == "cpu"


def start_worker_without_device():
    """The job path's worker with no device request, started on its own:
    a subprocess that runs while the other cases do. The master address is
    a port nothing listens on. The cohort variables are cleared too: a
    test earlier in this process may have left them set (ROADMAP queue 3),
    and they would make the worker a cohort member."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("EDL_TORCH_DEVICE", "EDL_PROCESS_ID",
                        "EDL_NUM_PROCESSES", "EDL_PROCESS_ID_FROM_HOSTNAME",
                        "EDL_COORDINATOR_ADDR")}
    env["PYTHONPATH"] = str(REPO)
    return subprocess.Popen(
        [sys.executable, "-m", "elasticdl_tpu_torch.worker.main",
         "--model_zoo", str(PORT / "model_zoo"),
         "--model_def", "deepfm.deepfm.custom_model",
         "--training_data", "synthetic://criteo?n=64",
         "--master_addr", "localhost:9", "--master_unreachable_timeout_s",
         "5"], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def case_worker_without_device_exits_where_cuda_is_absent(proc):
    """No card and no explicit request for another device is an error
    before the worker registers, never a CPU run."""
    _, stderr = proc.communicate(timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device is available" in stderr
    assert "registered as worker" not in stderr


def test_port_stands_alone(monkeypatch):
    """Every case above, in one collected test (ROADMAP.md, conventions:
    one collected test per port test file)."""
    no_device = (None if torch.cuda.is_available()
                 else start_worker_without_device())
    case_port_loads_no_jax_or_reference_module()
    case_no_source_file_of_the_port_imports_them()
    case_chip_smoke_imports_no_jax()
    if not torch.cuda.is_available():
        # where a card is present, Trainer(spec) runs there instead
        case_trainer_without_device_raises_where_cuda_is_absent()
        case_tier_store_without_device_raises_where_cuda_is_absent(
            monkeypatch)
        case_worker_without_device_exits_where_cuda_is_absent(no_device)
