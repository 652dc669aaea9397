"""MNIST CNN — the port's twin of `model_zoo/mnist/mnist_cnn.py`.

Two 3x3 convs (32, 64; flax's SAME padding, with bias) with ReLU, a 2x2
VALID max pool, dropout 0.25, Dense 128 + ReLU, dropout 0.5 and a float32
Dense to the logits. The convs and the first Dense compute in
`compute_dtype` (see `api.layers.Conv`, `Dense`).

Input: "features" (B, 28, 28, 1) float32 in [0, 1], NHWC as the parser
gives it; the model runs NCHW (the permuted view is channels-last in
memory) and flattens the pooled map in flax's (H, W, C) order, so
`Dense_0`'s rows need no permutation. Dropout draws from the trainer's
generator. Labels: (B,) int class ids. Output: (B, num_classes) logits.

Parameter names follow the flax module's (`Conv_0`, `Conv_1`, `Dense_0`,
`Dense_1`), so `convert.py` maps one onto the other by name.
"""

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from elasticdl_tpu_torch.api.layers import (
    Conv, Dense, dropout, max_pool, reset_tree)
from elasticdl_tpu_torch.training import lr_modulation
from elasticdl_tpu_torch.training import metrics as metrics_lib


class MnistCNN(nn.Module):
    def __init__(self, num_classes: int = 10,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_classes = int(num_classes)
        self.compute_dtype = compute_dtype
        self.Conv_0 = Conv(1, 32, (3, 3), dtype=compute_dtype)
        self.Conv_1 = Conv(32, 64, (3, 3), dtype=compute_dtype)
        self.Dense_0 = Dense(14 * 14 * 64, 128, dtype=compute_dtype)
        self.Dense_1 = Dense(128, self.num_classes, dtype=torch.float32)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_tree(self, generator)

    def forward(self, x, training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        x = torch.relu(self.Conv_0(x))
        x = torch.relu(self.Conv_1(x))
        x = max_pool(x, (2, 2), (2, 2))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)    # flax's order
        if training:
            x = dropout(x, 0.25, generator)
        x = torch.relu(self.Dense_0(x))
        if training:
            x = dropout(x, 0.5, generator)
        return self.Dense_1(x)


def custom_model(**kwargs):
    dtype = kwargs.get("compute_dtype", "bfloat16")
    return MnistCNN(
        num_classes=int(kwargs.get("num_classes", 10)),
        compute_dtype=(dtype if isinstance(dtype, torch.dtype)
                       else getattr(torch, str(dtype))),
    )


def loss(labels, outputs):
    """Per-example softmax cross entropy over integer labels (optax's
    `softmax_cross_entropy_with_integer_labels`)."""
    return F.cross_entropy(outputs.to(torch.float32),
                           labels.reshape(-1).to(torch.int64),
                           reduction="none")


def optimizer(**kwargs):
    # optax.sgd(lr, momentum=0.9): trace = g + 0.9 trace, p -= lr * trace,
    # which is torch's SGD with momentum 0.9 (dampening 0)
    return lr_modulation.modulated(
        torch.optim.SGD,
        learning_rate=float(kwargs.get("learning_rate", 0.01)),
        momentum=0.9)


def dataset_fn(mode, metadata):
    """Batch-parse raw records (1 label byte + 784 pixel bytes) into
    (n, 28, 28, 1) float32 images with the port's u8-image parser."""
    from elasticdl_tpu_torch.data import parsing

    return parsing.u8_image_batch_parser(784, shape=(28, 28, 1))


def eval_metrics_fn():
    return {"accuracy": metrics_lib.Accuracy()}
