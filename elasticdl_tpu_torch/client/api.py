"""Client verb implementations.

Counterpart of `elasticdl_tpu/client/api.py`: train/evaluate/predict
submit a job; zoo manages the model-zoo artifact. Two launch targets:
- local (default when no --image_name): the port's master in-process,
  subprocess workers on the card;
- k8s: render the job's manifests for GPU nodes (client/k8s.py) and
  submit them with kubectl (printed where kubectl is absent).
"""

from __future__ import annotations

from typing import List

from elasticdl_tpu_torch.common.config import JobConfig
from elasticdl_tpu_torch.common.constants import JobType
from elasticdl_tpu_torch.common.log_utils import default_logger

logger = default_logger(__name__)


def _launch(cfg: JobConfig) -> int:
    cfg.validate()
    if cfg.image_name:
        from elasticdl_tpu_torch.client import k8s

        return k8s.submit(cfg)
    from elasticdl_tpu_torch.client.local import run_local

    return run_local(cfg)


def _require_data(cfg: JobConfig, field: str, verb: str) -> None:
    """Verb-specific data-flag validation: fail at the verb boundary with
    the flag name instead of deep in the master."""
    if not getattr(cfg, field):
        raise ValueError(f"`{verb}` requires --{field}")


def train(cfg: JobConfig) -> int:
    _require_data(cfg, "training_data", "train")
    return _launch(cfg)


def evaluate(cfg: JobConfig) -> int:
    _require_data(cfg, "validation_data", "evaluate")
    return _launch(cfg.replace(job_type=JobType.EVALUATION_ONLY))


def predict(cfg: JobConfig) -> int:
    _require_data(cfg, "prediction_data", "predict")
    return _launch(cfg.replace(job_type=JobType.PREDICTION_ONLY))


def zoo(argv: List[str]) -> int:
    """zoo init/build/push — model-zoo image management."""
    from elasticdl_tpu_torch.client import zoo as zoo_mod

    return zoo_mod.main(argv)
