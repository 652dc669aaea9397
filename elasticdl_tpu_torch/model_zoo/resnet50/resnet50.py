"""ResNet-50 — the port's twin of `model_zoo/resnet50/resnet50.py`.

A 7x7 stride-2 conv (pads (3, 3)) and BatchNorm, a 3x3 stride-2 max pool
(pads (1, 1), read as -inf), 4 stages of bottleneck blocks ((3, 4, 6, 3)
blocks of 64, 128, 256, 512 filters; 1x1, 3x3 with the stage's stride,
1x1 to 4x filters, the last BN with scale 0; a 1x1 conv + BN shortcut
where the shape changes), a global mean and a float32 Dense. Convs have
no bias and flax's SAME padding; convs and BN compute in `compute_dtype`,
BN's statistics and parameters are float32 (`api.layers`). The running
averages are buffers; under a data-parallel mesh the statistics are the
global batch's.

Input: "features" (B, H, W, 3) float32 NHWC, normalized; the model runs
NCHW. Labels: (B,) int. Output: (B, num_classes) logits. Names follow
the flax module's (`conv_init`, `bn_init`, `BottleneckBlock_i.{Conv_0..2,
BatchNorm_0..2, shortcut, shortcut_bn}`, `Dense_0`).

The optimizer is the reference's unmodulated chain: decayed weights and
SGD (momentum 0.9, nesterov) under optax's `warmup_cosine_decay_schedule`
from 0 (`WarmupCosineSGD`): the first step trains at learning rate 0,
and the schedule's count lives in the optimizer's state.
"""

import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from elasticdl_tpu_torch.api.layers import (
    BatchNorm, Conv, Dense, max_pool, reset_tree)
from elasticdl_tpu_torch.training import metrics as metrics_lib


class BottleneckBlock(nn.Module):
    def __init__(self, in_features: int, filters: int, strides,
                 dtype: torch.dtype):
        super().__init__()
        out = filters * 4
        self.Conv_0 = Conv(in_features, filters, (1, 1), use_bias=False,
                           dtype=dtype)
        self.BatchNorm_0 = BatchNorm(filters, dtype=dtype)
        self.Conv_1 = Conv(filters, filters, (3, 3), strides, use_bias=False,
                           dtype=dtype)
        self.BatchNorm_1 = BatchNorm(filters, dtype=dtype)
        self.Conv_2 = Conv(filters, out, (1, 1), use_bias=False, dtype=dtype)
        self.BatchNorm_2 = BatchNorm(out, dtype=dtype, zero_scale=True)
        if in_features != out or tuple(strides) != (1, 1):
            self.shortcut = Conv(in_features, out, (1, 1), strides,
                                 use_bias=False, dtype=dtype)
            self.shortcut_bn = BatchNorm(out, dtype=dtype)
        else:
            self.shortcut = None

    def forward(self, x, training: bool):
        y = torch.relu(self.BatchNorm_0(self.Conv_0(x), training))
        y = torch.relu(self.BatchNorm_1(self.Conv_1(y), training))
        y = self.BatchNorm_2(self.Conv_2(y), training)
        residual = x
        if self.shortcut is not None:
            residual = self.shortcut_bn(self.shortcut(x), training)
        return torch.relu(residual + y)


class ResNet50(nn.Module):
    def __init__(self, num_classes: int = 1000,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.num_classes = int(num_classes)
        self.compute_dtype = compute_dtype
        self.stage_sizes = tuple(int(n) for n in stage_sizes)
        self.conv_init = Conv(3, 64, (7, 7), (2, 2), padding=((3, 3), (3, 3)),
                              use_bias=False, dtype=compute_dtype)
        self.bn_init = BatchNorm(64, dtype=compute_dtype)
        width, i = 64, 0
        for stage, (n_blocks, filters) in enumerate(
                zip(self.stage_sizes, (64, 128, 256, 512))):
            for block in range(n_blocks):
                strides = (2, 2) if stage > 0 and block == 0 else (1, 1)
                setattr(self, f"BottleneckBlock_{i}",
                        BottleneckBlock(width, filters, strides,
                                        compute_dtype))
                width, i = filters * 4, i + 1
        self.num_blocks = i
        self.Dense_0 = Dense(width, self.num_classes, dtype=torch.float32)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_tree(self, generator)

    def forward(self, x, training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        del generator
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        x = torch.relu(self.bn_init(self.conv_init(x), training))
        x = max_pool(x, (3, 3), (2, 2), ((1, 1), (1, 1)))
        for i in range(self.num_blocks):
            x = getattr(self, f"BottleneckBlock_{i}")(x, training)
        return self.Dense_0(x.mean(dim=(2, 3)))


def custom_model(**kwargs):
    dtype = kwargs.get("compute_dtype", "bfloat16")
    return ResNet50(
        num_classes=int(kwargs.get("num_classes", 1000)),
        compute_dtype=(dtype if isinstance(dtype, torch.dtype)
                       else getattr(torch, str(dtype))),
    )


def loss(labels, outputs):
    """Per-example softmax cross entropy over integer labels."""
    return F.cross_entropy(outputs.to(torch.float32),
                           labels.reshape(-1).to(torch.int64),
                           reduction="none")


def warmup_cosine(count: int, peak: float, warmup: int, decay: int) -> float:
    """optax's `warmup_cosine_decay_schedule(init_value=0, peak_value=peak,
    warmup_steps=warmup, decay_steps=decay)` at `count`: linear from 0 to
    `peak` over `warmup` steps, then a cosine to 0 over the remaining
    `decay - warmup`."""
    if count < warmup:
        return peak * count / warmup
    t = min(count - warmup, decay - warmup)
    return peak * 0.5 * (1.0 + math.cos(math.pi * t / (decay - warmup)))


class WarmupCosineSGD(torch.optim.Optimizer):
    """optax.chain(add_decayed_weights(weight_decay), sgd(warmup_cosine,
    momentum, nesterov)): g' = g + weight_decay * p; trace = g' + momentum
    * trace (`momentum_buffer`, which starts at g'); p -= lr(count) *
    (g' + momentum * trace) with nesterov, else lr(count) * trace; then
    count += 1. `count` is a param-group entry, so the optimizer's
    state_dict (and a checkpoint) carries it. The groups hold no `lr`: a
    learning rate pushed by the master is refused (KeyError), and the
    worker logs and ignores it, as the reference does with an optimizer
    that is not `modulated`."""

    # read by the trainer, which then runs the steps eagerly on the card
    host_sync = ("computes lr(count) on the host from a param-group count, "
                 "which a captured step would freeze")

    def __init__(self, params, peak_lr: float, warmup_steps: int,
                 decay_steps: int, momentum: float = 0.9,
                 nesterov: bool = True, weight_decay: float = 0.0):
        super().__init__(params, dict(
            peak_lr=float(peak_lr), warmup_steps=int(warmup_steps),
            decay_steps=int(decay_steps), momentum=float(momentum),
            nesterov=bool(nesterov), weight_decay=float(weight_decay),
            count=0))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("WarmupCosineSGD takes no closure")
        for group in self.param_groups:
            lr = warmup_cosine(group["count"], group["peak_lr"],
                               group["warmup_steps"], group["decay_steps"])
            m = group["momentum"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"]:
                    g = g + group["weight_decay"] * p
                state = self.state[p]
                buf = state.get("momentum_buffer")
                if buf is None:
                    buf = state["momentum_buffer"] = g.clone()
                else:
                    buf.mul_(m).add_(g)
                update = g + m * buf if group["nesterov"] else buf
                p.add_(update, alpha=-lr)
            group["count"] += 1


def optimizer(**kwargs):
    import functools

    return functools.partial(
        WarmupCosineSGD,
        peak_lr=float(kwargs.get("learning_rate", 0.1)),
        warmup_steps=int(kwargs.get("warmup_steps", 500)),
        decay_steps=int(kwargs.get("total_steps", 50_000)),
        momentum=0.9, nesterov=True,
        weight_decay=float(kwargs.get("weight_decay", 1e-4)))


def dataset_fn(mode, metadata):
    """Parse one record: a 2-byte little-endian label, then either the
    whole HxWx3 uint8 image or a shorter seed block tiled up to size (the
    synthetic `imagenet224` reader's 64-byte blocks), normalized with
    ImageNet's mean and std. The side defaults to 224
    (metadata['image_size'] overrides it)."""

    side = int((metadata or {}).get("image_size", 224))
    nbytes = side * side * 3

    def parse(record: bytes):
        if len(record) < 3:
            raise ValueError(
                f"imagenet record too short ({len(record)} bytes): need a "
                f"2-byte label plus at least one image byte"
            )
        label = np.int32(int.from_bytes(record[:2], "little"))
        raw = np.frombuffer(record[2:], dtype=np.uint8)
        if raw.size < nbytes:
            raw = np.tile(raw, nbytes // raw.size + 1)
        image = raw[:nbytes].reshape(side, side, 3).astype(np.float32) / 255.0
        mean = np.array([0.485, 0.456, 0.406], np.float32)
        std = np.array([0.229, 0.224, 0.225], np.float32)
        return (image - mean) / std, label

    return parse


def eval_metrics_fn():
    return {"accuracy": metrics_lib.Accuracy()}
