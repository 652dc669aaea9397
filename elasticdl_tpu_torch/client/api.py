"""Client verb implementations.

Counterpart of `elasticdl_tpu/client/api.py`: train/evaluate/predict
submit a job to the local launcher (the port's master in-process,
subprocess workers on the card). The Kubernetes target (`--image_name`)
and `zoo` wait for ROADMAP item 25 and raise.
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
        raise NotImplementedError(
            "Kubernetes submission (--image_name) is ROADMAP item 25")
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
    raise NotImplementedError(
        "zoo init/build/push (a torch model-zoo template and image) is "
        "ROADMAP item 25")
