"""elasticdl_tpu_torch — the PyTorch/CUDA port of `elasticdl_tpu`.

The JAX package beside it stays the reference. This package mirrors its
module layout and names (`common/`, `api/`, `ops/`, `training/`,
`model_zoo/`) so each module's counterpart is easy to find, and holds the
same contracts: the model-zoo module contract, the
`{"features", "labels", "mask"}` batch, additive metric states.

It imports torch and numpy only — never jax, flax, optax, orbax or any
module of `elasticdl_tpu`; where it needs a helper from there it keeps its
own copy. Every Pallas kernel of the reference on the ported path has a
hand-written CUDA counterpart under `csrc/`, built at first use (see
`ops/native.py`); entry points run on the GPU unless the caller asks for
the CPU, where each kernel's wrapper runs its plain PyTorch version.
"""
