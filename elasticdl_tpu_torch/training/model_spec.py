"""The model-zoo contract, resolved into one object.

Counterpart of `elasticdl_tpu/training/model_spec.py`, with the same zoo
contract in torch terms:
- `custom_model(**model_params)` returns a `torch.nn.Module` whose
  `forward(features, training=False, generator=None)` returns the outputs
  (the generator draws dropout masks) and whose optional
  `reset_parameters(generator)` draws the initial parameters,
- `loss(labels, outputs)` returns a per-example loss (masked mean taken by
  the trainer) or a scalar,
- `optimizer(**model_params)` returns a factory `params -> optimizer`
  (see `lr_modulation.modulated`),
- `dataset_fn`, `eval_metrics_fn` (`{name: Metric}` from
  `elasticdl_tpu_torch.training.metrics`), `callbacks` and
  `prediction_outputs_processor` as in the reference,
- an optional `batch_partition()`: {top-level batch key: a tuple of mesh
  axis names, one a dimension (None for none)}, the counterpart of the
  reference's PartitionSpecs,
- an optional module-level `aux_loss_weight` float: the weight of the
  auxiliary losses (the MoE layers' load balance) in training.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from torch import nn

from elasticdl_tpu_torch.common.config import JobConfig
from elasticdl_tpu_torch.common.model_utils import get_module_attr, load_module


@dataclass
class ModelSpec:
    model: nn.Module
    loss: Callable[..., Any]
    optimizer: Any                       # params -> torch.optim.Optimizer
    dataset_fn: Optional[Callable[..., Any]]
    eval_metrics_fn: Optional[Callable[[], Dict[str, Any]]]
    callbacks: List[Any] = field(default_factory=list)
    prediction_outputs_processor: Optional[Any] = None
    module_name: str = ""
    # the params the model was actually built with (cfg.model_params plus
    # injected defaults like compute_dtype)
    model_params: Dict[str, Any] = field(default_factory=dict)
    # per-top-level-key axis names of the input batches (zoo module-level
    # `batch_partition()`); the leading one must be the data axis
    batch_partition: Optional[Dict[str, Tuple[Optional[str], ...]]] = None
    # weight of the auxiliary losses (api.layers.MoE's Switch
    # load-balance penalty), which the trainer adds inside the
    # differentiated loss; 0 = ignored
    aux_loss_weight: float = 0.0

    @classmethod
    def from_config(cls, cfg: JobConfig) -> "ModelSpec":
        module, func_name = load_module(cfg.model_zoo, cfg.model_def)
        model_fn = getattr(module, func_name, None)
        if model_fn is None:
            raise ValueError(f"{cfg.model_def!r}: no {func_name} in {module.__name__}")
        # the job-level compute_dtype reaches user models through
        # model_params unless the user already set one explicitly
        model_params = dict(cfg.model_params)
        model_params.setdefault("compute_dtype", cfg.compute_dtype)
        model = model_fn(**model_params)
        if not isinstance(model, nn.Module):
            raise TypeError(
                f"{cfg.model_def} must return a torch.nn.Module, got {type(model)}"
            )

        loss = get_module_attr(module, "loss", cfg.loss, required=True)
        opt_fn = get_module_attr(module, "optimizer", cfg.optimizer, required=True)
        dataset_fn = get_module_attr(module, "dataset_fn", cfg.dataset_fn, required=False)
        metrics_fn = get_module_attr(
            module, "eval_metrics_fn", cfg.eval_metrics_fn, required=False
        )
        callbacks_fn = get_module_attr(module, "callbacks", "", required=False)
        batch_partition_fn = get_module_attr(
            module, "batch_partition", "", required=False)
        pop_fn = get_module_attr(
            module,
            "prediction_outputs_processor",
            cfg.prediction_outputs_processor,
            required=False,
        )

        return cls(
            model=model,
            loss=loss,
            optimizer=opt_fn(**cfg.model_params) if opt_fn else None,
            dataset_fn=dataset_fn,
            eval_metrics_fn=metrics_fn,
            callbacks=list(callbacks_fn()) if callbacks_fn else [],
            prediction_outputs_processor=pop_fn() if pop_fn else None,
            module_name=module.__name__,
            model_params=model_params,
            batch_partition=(
                dict(batch_partition_fn()) if batch_partition_fn else None),
            aux_loss_weight=float(
                getattr(module, "aux_loss_weight", 0.0) or 0.0),
        )
