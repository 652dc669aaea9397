"""Runtime learning-rate control.

Counterpart of `elasticdl_tpu/training/lr_modulation.py`. There the
learning rate is lifted into optax's optimizer state so a jitted step can
change it without retracing. PyTorch optimizers already hold it as data,
in `param_groups`, so `modulated` only fixes the hyperparameters and the
setters write the groups. Zoo modules opt in the same way:

    def optimizer(**kw):
        return lr_modulation.modulated(torch.optim.Adam, learning_rate=1e-3)

On the card the trainer captures its steps as CUDA graphs, and a graph
bakes in a Python float it read while capturing. So over parameters on
the card `modulated` builds Adam and AdamW `capturable=True` and SGD
`fused=True`, each with its learning rate as a one-element device tensor,
and `set_hyperparam` writes such a tensor in place: a captured step reads
the new rate at its next replay. The card's eager steps use the same
flavour, so captured and eager steps round alike. On the CPU the
optimizer is built as asked, with a float rate.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Iterable, Optional

import torch

from elasticdl_tpu_torch.common.log_utils import default_logger

# optax's hyperparameter names -> torch's
_TORCH_NAMES = {"learning_rate": "lr"}

# the flavour each optimizer takes on the card: one whose step a CUDA
# graph can capture with a tensor learning rate
_CARD_FLAVOURS = {torch.optim.Adam: {"capturable": True},
                  torch.optim.AdamW: {"capturable": True},
                  torch.optim.SGD: {"fused": True}}


def modulated(factory: Callable[..., torch.optim.Optimizer],
              **hyperparams) -> Callable[[Iterable[Any]], torch.optim.Optimizer]:
    """`factory` with its hyperparameters fixed (optax's names mapped to
    torch's); call the result with the parameters to get the optimizer.
    Over parameters on the card, Adam, AdamW and SGD take their card
    flavour and a device tensor learning rate (module docstring)."""
    return functools.partial(
        _build, factory,
        **{_TORCH_NAMES.get(k, k): v for k, v in hyperparams.items()})


def _build(factory, params: Iterable[Any], **hyperparams):
    params = list(params)
    device = params[0].device if params else torch.device("cpu")
    if device.type == "cuda" and factory in _CARD_FLAVOURS:
        hyperparams.update(_CARD_FLAVOURS[factory])
        if "lr" in hyperparams:
            hyperparams["lr"] = torch.tensor(float(hyperparams["lr"]),
                                             device=device)
    return factory(params, **hyperparams)


def capture_blocker(factory) -> Optional[str]:
    """Why a step over the optimizer `factory` builds cannot be captured
    as a CUDA graph, or None: a factory that is not `modulated` over
    Adam, AdamW or SGD keeps a float learning rate that a graph would
    bake in, and an optimizer class may declare a `host_sync` reason of
    its own."""
    func = getattr(factory, "func", factory)
    optim = factory.args[0] if func is _build else func
    reason = getattr(optim, "host_sync", None)
    if reason:
        return f"{getattr(optim, '__name__', optim)}: {reason}"
    if func is not _build or optim not in _CARD_FLAVOURS:
        return (f"the optimizer {getattr(optim, '__name__', optim)!r} is not "
                "lr_modulation.modulated over Adam, AdamW or SGD, so its "
                "learning rate is a host float a graph would bake in")
    return None


def set_hyperparam(optimizer: torch.optim.Optimizer, name: str,
                   value) -> torch.optim.Optimizer:
    """Set hyperparameter `name` (optax or torch spelling) in every param
    group, in place where the group holds it as a tensor (a captured step
    reads that tensor); raises KeyError if no group carries it."""
    key = _TORCH_NAMES.get(name, name)
    groups = [g for g in optimizer.param_groups if key in g]
    if not groups:
        raise KeyError(f"optimizer has no hyperparameter {name!r}")
    for g in groups:
        if isinstance(g[key], torch.Tensor):
            g[key].fill_(float(value))
        else:
            g[key] = value
    return optimizer


def get_hyperparam(optimizer: torch.optim.Optimizer,
                   name: str) -> Optional[float]:
    key = _TORCH_NAMES.get(name, name)
    for g in optimizer.param_groups:
        if key in g:
            return float(g[key])
    return None


def set_learning_rate(optimizer: torch.optim.Optimizer,
                      lr: float) -> torch.optim.Optimizer:
    return set_hyperparam(optimizer, "learning_rate", float(lr))


def get_learning_rate(optimizer: torch.optim.Optimizer) -> Optional[float]:
    return get_hyperparam(optimizer, "learning_rate")


def apply_learning_rate(trainer, state, lr: float):
    """Set `lr` on `state` via the trainer, tolerating an optimizer that
    has no learning rate — a pushed LR reaching such a job is a config
    mismatch that must log, not kill the worker. Returns the state."""
    try:
        return trainer.set_learning_rate(state, lr)
    except KeyError:
        default_logger(__name__).warning(
            "ignoring LR %.6g: optimizer has no learning rate", lr)
        return state


def linear_scale(base_lr: float, alive_workers: int,
                 base_workers: int) -> float:
    """Linear-scaling rule for elastic membership changes: LR tracks the
    live worker count, i.e. the effective global batch size."""
    return base_lr * max(1, alive_workers) / max(1, base_workers)


def staleness_modulation(base_lr: float, staleness: int,
                         factor: float = 1.0) -> float:
    """Damp the LR for a gradient computed `staleness` versions behind."""
    return base_lr / (1.0 + factor * max(0, staleness))
