"""elasticdl_tpu_torch — the PyTorch/CUDA port of `elasticdl_tpu`.

The JAX package beside it stays the reference. This package mirrors its
module layout and names (`common/`, `api/`, `ops/`, `training/`,
`model_zoo/`, and the job path's `client/`, `master/`, `worker/`,
`data/`, `proto/`, `observability/`) so each module's counterpart is easy
to find, and holds the same contracts: the model-zoo module contract, the
`{"features", "labels", "mask"}` batch, additive metric states, the
master/worker wire format.

It imports torch, numpy and grpc/protobuf only — never jax, flax, optax,
orbax or any module of `elasticdl_tpu`; where it needs a jax-free module
from there it keeps its own copy (`tests/test_torch_copies.py` lists them
and holds each to the reference's text). Every Pallas kernel of the reference on the ported path has a
hand-written CUDA counterpart under `csrc/`, built at first use (see
`ops/native.py`); entry points run on the GPU unless the caller asks for
the CPU, where each kernel's wrapper runs its plain PyTorch version.
"""
