"""Per-process PyTorch runtime setup: where the port runs, and the float
rules that keep it comparable with the reference.

Counterpart of `elasticdl_tpu/common/runtime.py`. That module configures
JAX's persistent compilation cache; PyTorch runs eagerly, so there is no
compile cache here.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: the GPU unless the caller asks
    for something else. Never falls back to the CPU on its own — a job
    that meant to run on the card and silently ran on the host would
    report host numbers as the card's."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU explicitly")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    return dev


def cohort_device(process_id: int,
                  device: DeviceLike = None) -> torch.device:
    """The device of cohort member `process_id`: `device` where the caller
    names one (the CPU tests ask for "cpu"), else the card
    `cuda:<process_id>` of this host. Raises, before the member forms its
    world, where the host has no such card: NCCL refuses two ranks on one
    card, and a silent share would report one card's numbers as two."""
    if device is not None:
        return resolve_device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU explicitly")
    count = torch.cuda.device_count()
    if process_id >= count:
        raise RuntimeError(
            f"cohort member {process_id} needs card cuda:{process_id}, but "
            f"this host has {count}: a card takes one rank")
    return torch.device("cuda", process_id)


def configure_torch_runtime() -> None:
    """Apply the process-wide numeric settings (idempotent).

    TF32 off for both matmuls and cuDNN: a float32 product in TF32 keeps
    about three decimal digits, so a float32 model would no longer agree
    with the reference (or with its own CPU run) to the stated
    tolerances. PyTorch leaves `cudnn.allow_tf32` on by default; both are
    set here so the choice is explicit."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
