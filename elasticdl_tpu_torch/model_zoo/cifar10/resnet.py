"""CIFAR-10 ResNet — the port's twin of `model_zoo/cifar10/resnet.py`.

ResNet-20/32/44/56 for 32x32 inputs (depth = 6n + 2): a 3x3 conv and
BatchNorm, 3 stages of n basic blocks (16, 32, 64 channels; the first
block of stages 2 and 3 strides 2 and takes a 1x1 conv + BN shortcut),
a global mean and a float32 Dense to the logits. Convs have no bias and
flax's SAME padding (a stride-2 3x3 conv pads (0, 1): `api.layers.Conv`).
Convs and BatchNorm compute in `compute_dtype`; BN's statistics and
parameters are float32, and the last BN of each block starts with scale
0 (`api.layers.BatchNorm`).

BatchNorm's statistics are the global batch's: under a data-parallel
mesh the per-rank sums are all-reduced, as the reference's one jitted
step over the logically sharded batch computes them. The running
averages are buffers beside the parameters (the reference's
`batch_stats`, carried by its TrainState's `extra_vars`).

Input: "features" (B, 32, 32, 3) float32 NHWC (the parser transposes the
channel-major records); the model runs NCHW. Labels: (B,) int. Output:
(B, num_classes) logits. Names follow the flax module's (`conv_init`,
`bn_init`, `BasicBlock_i.{Conv_0, BatchNorm_0, Conv_1, BatchNorm_1,
shortcut, shortcut_bn}`, `Dense_0`).
"""

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from elasticdl_tpu_torch.api.layers import BatchNorm, Conv, Dense, reset_tree
from elasticdl_tpu_torch.training import lr_modulation
from elasticdl_tpu_torch.training import metrics as metrics_lib


class BasicBlock(nn.Module):
    def __init__(self, in_features: int, filters: int, strides,
                 dtype: torch.dtype):
        super().__init__()
        self.Conv_0 = Conv(in_features, filters, (3, 3), strides,
                           use_bias=False, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(filters, dtype=dtype)
        self.Conv_1 = Conv(filters, filters, (3, 3), use_bias=False,
                           dtype=dtype)
        self.BatchNorm_1 = BatchNorm(filters, dtype=dtype, zero_scale=True)
        if in_features != filters or tuple(strides) != (1, 1):
            self.shortcut = Conv(in_features, filters, (1, 1), strides,
                                 use_bias=False, dtype=dtype)
            self.shortcut_bn = BatchNorm(filters, dtype=dtype)
        else:
            self.shortcut = None

    def forward(self, x, training: bool):
        y = torch.relu(self.BatchNorm_0(self.Conv_0(x), training))
        y = self.BatchNorm_1(self.Conv_1(y), training)
        residual = x
        if self.shortcut is not None:
            residual = self.shortcut_bn(self.shortcut(x), training)
        return torch.relu(residual + y)


class CifarResNet(nn.Module):
    def __init__(self, depth: int = 20, num_classes: int = 10,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if (depth - 2) % 6:
            raise ValueError(f"CIFAR ResNet depth must be 6n+2, got {depth}")
        self.depth = int(depth)
        self.num_classes = int(num_classes)
        self.compute_dtype = compute_dtype
        n = (depth - 2) // 6
        self.conv_init = Conv(3, 16, (3, 3), use_bias=False,
                              dtype=compute_dtype)
        self.bn_init = BatchNorm(16, dtype=compute_dtype)
        width, i = 16, 0
        for stage, filters in enumerate((16, 32, 64)):
            for block in range(n):
                strides = (2, 2) if stage > 0 and block == 0 else (1, 1)
                setattr(self, f"BasicBlock_{i}",
                        BasicBlock(width, filters, strides, compute_dtype))
                width, i = filters, i + 1
        self.num_blocks = i
        self.Dense_0 = Dense(width, self.num_classes, dtype=torch.float32)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_tree(self, generator)

    def forward(self, x, training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        del generator
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        x = torch.relu(self.bn_init(self.conv_init(x), training))
        for i in range(self.num_blocks):
            x = getattr(self, f"BasicBlock_{i}")(x, training)
        return self.Dense_0(x.mean(dim=(2, 3)))


def custom_model(**kwargs):
    dtype = kwargs.get("compute_dtype", "bfloat16")
    return CifarResNet(
        depth=int(kwargs.get("depth", 20)),
        num_classes=int(kwargs.get("num_classes", 10)),
        compute_dtype=(dtype if isinstance(dtype, torch.dtype)
                       else getattr(torch, str(dtype))),
    )


def loss(labels, outputs):
    """Per-example softmax cross entropy over integer labels."""
    return F.cross_entropy(outputs.to(torch.float32),
                           labels.reshape(-1).to(torch.int64),
                           reduction="none")


def optimizer(**kwargs):
    # optax.chain(add_decayed_weights(wd), sgd(lr, momentum=0.9,
    # nesterov=True)): g + wd * p, trace = g' + 0.9 trace, p -= lr * (g' +
    # 0.9 trace), which is torch's SGD with weight_decay, momentum 0.9 and
    # nesterov (dampening 0); tests/test_torch_zoo.py holds the two equal
    return lr_modulation.modulated(
        torch.optim.SGD,
        learning_rate=float(kwargs.get("learning_rate", 0.1)),
        momentum=0.9, nesterov=True,
        weight_decay=float(kwargs.get("weight_decay", 1e-4)))


def dataset_fn(mode, metadata):
    """Batch-parse CIFAR-10-binary records (1 label byte + 3072 pixel
    bytes, 3x32x32 channel-major) with the port's u8-image parser, then
    transpose to NHWC."""
    from elasticdl_tpu_torch.data import parsing

    base = parsing.u8_image_batch_parser(3072)

    @parsing.batch_parser
    def parse_batch(records):
        imgs, labels = base(records)
        return imgs.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1), labels

    return parse_batch


def eval_metrics_fn():
    return {"accuracy": metrics_lib.Accuracy()}
