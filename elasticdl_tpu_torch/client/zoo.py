"""`zoo` verbs: scaffold, build and push the model-zoo image.

Counterpart of `elasticdl_tpu/client/zoo.py`, with its verbs and text:
the model zoo is a directory of model modules baked into a Docker image
the job pods run. Two things are the port's own:

- the template (`my_model.py`) follows the port's zoo contract
  (`model_zoo/mnist/mnist_cnn.py`): `custom_model` returns an
  `nn.Module` built from `elasticdl_tpu_torch.api.layers`, `loss` is
  per-example softmax cross entropy on integer labels, `optimizer` returns
  a factory of `torch.optim.Adam` at `learning_rate` (default 1e-3), and
  `eval_metrics_fn` returns the port's `metrics.Accuracy`. It imports no
  JAX;
- the default base image, `pytorch/pytorch:2.7.0-cuda12.8-cudnn9-devel`,
  a public PyTorch image with CUDA's toolkit: the port builds its kernels
  with `nvcc` at first use, which a runtime or slim Python image lacks.
  The image a job runs must also hold the port (`elasticdl_tpu_torch`)
  and its Python dependencies (grpcio, protobuf, numpy, PyYAML): pass
  `--base_image` naming one built on this base with them installed.

Without `docker` on PATH, `build` writes the Dockerfile and returns 1,
and `push` returns 1.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
from typing import List

from elasticdl_tpu_torch.common.log_utils import default_logger

logger = default_logger(__name__)

BASE_IMAGE = "pytorch/pytorch:2.7.0-cuda12.8-cudnn9-devel"

_DOCKERFILE = """\
FROM {base_image}
COPY . /model_zoo
ENV PYTHONPATH=/model_zoo:$PYTHONPATH
"""

_TEMPLATE_MODEL = '''\
"""Model-zoo template. Contract: custom_model/loss/optimizer/dataset_fn/
eval_metrics_fn module-level functions (see model_zoo/mnist/mnist_cnn.py
for a complete example)."""

import torch
from torch import nn
from torch.nn import functional as F

from elasticdl_tpu_torch.api.layers import Dense, reset_tree
from elasticdl_tpu_torch.training import lr_modulation
from elasticdl_tpu_torch.training import metrics as metrics_lib

# the width of "features": flax infers a Dense's input width from the
# first batch, a torch layer is built with it
INPUT_DIM = 8


class MyModel(nn.Module):
    def __init__(self, input_dim: int = INPUT_DIM):
        super().__init__()
        self.Dense_0 = Dense(input_dim, 2)

    def reset_parameters(self, generator=None):
        reset_tree(self, generator)

    def forward(self, x, training: bool = False, generator=None):
        return self.Dense_0(x)


def custom_model(**kwargs):
    return MyModel(int(kwargs.get("input_dim", INPUT_DIM)))


def loss(labels, outputs):
    return F.cross_entropy(outputs.to(torch.float32),
                           labels.reshape(-1).to(torch.int64),
                           reduction="none")


def optimizer(**kwargs):
    return lr_modulation.modulated(
        torch.optim.Adam,
        learning_rate=float(kwargs.get("learning_rate", 1e-3)))


def dataset_fn(mode, metadata):
    raise NotImplementedError


def eval_metrics_fn():
    return {"accuracy": metrics_lib.Accuracy()}
'''


def init(model_zoo_dir: str) -> int:
    os.makedirs(model_zoo_dir, exist_ok=True)
    template = os.path.join(model_zoo_dir, "my_model.py")
    if not os.path.exists(template):
        with open(template, "w") as f:
            f.write(_TEMPLATE_MODEL)
    docker = os.path.join(model_zoo_dir, "Dockerfile")
    if not os.path.exists(docker):
        with open(docker, "w") as f:
            f.write(_DOCKERFILE.format(base_image=BASE_IMAGE))
    logger.info("initialized model zoo at %s", model_zoo_dir)
    return 0


def build(model_zoo_dir: str, image: str, base_image: str) -> int:
    docker = shutil.which("docker")
    dockerfile = os.path.join(model_zoo_dir, "Dockerfile")
    if not os.path.exists(dockerfile):
        with open(dockerfile, "w") as f:
            f.write(_DOCKERFILE.format(base_image=base_image))
    if docker is None:
        logger.error("docker not found; wrote %s — build it where docker runs", dockerfile)
        return 1
    return subprocess.call([docker, "build", "-t", image, model_zoo_dir])


def push(image: str) -> int:
    docker = shutil.which("docker")
    if docker is None:
        logger.error("docker not found")
        return 1
    return subprocess.call([docker, "push", image])


def main(argv: List[str]) -> int:
    parser = argparse.ArgumentParser("elasticdl-tpu-torch zoo")
    sub = parser.add_subparsers(dest="verb", required=True)
    p_init = sub.add_parser("init")
    p_init.add_argument("--model_zoo", default="model_zoo")
    p_build = sub.add_parser("build")
    p_build.add_argument("--model_zoo", default="model_zoo")
    p_build.add_argument("--image", required=True)
    p_build.add_argument("--base_image", default=BASE_IMAGE)
    p_push = sub.add_parser("push")
    p_push.add_argument("--image", required=True)
    ns = parser.parse_args(argv)
    if ns.verb == "init":
        return init(ns.model_zoo)
    if ns.verb == "build":
        return build(ns.model_zoo, ns.image, ns.base_image)
    if ns.verb == "push":
        return push(ns.image)
    return 2


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
