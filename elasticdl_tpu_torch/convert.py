"""Carry the reference's DeepFM weights across to the port.

`params_from_flax(params)` maps the flax params tree of
`model_zoo/deepfm/deepfm.py` (a nested dict of arrays) onto the
`state_dict` of `elasticdl_tpu_torch/model_zoo/deepfm/deepfm.py`:

  fm_embedding/table          -> fm_embedding.table (as is, padded rows too)
  <dense>/kernel (in, out)    -> <dense>.weight (out, in), transposed
  <dense>/bias                -> <dense>.bias
  bias                        -> bias

for <dense> in dense_linear, dnn_0 ... dnn_{k-1}, dnn_out. Adam's slots
start at zero on both sides, so only parameters cross. Any array type
that numpy can read (flax's jax arrays included) is accepted.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

_DENSE = re.compile(r"^(dense_linear|dnn_out|dnn_\d+)$")


def params_from_flax(
    params: Mapping[str, Any],
    expected: Optional[Mapping[str, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """The port's state_dict for a flax DeepFM params tree.

    Raises ValueError on a missing or extra key or a shape mismatch:
    within the tree (a kernel that disagrees with its bias, a table that
    is not 2-D, a gap in the dnn_i sequence), and, when `expected` (a
    state_dict or module of the port) is given, against its keys and
    shapes."""
    if "params" in params and len(params) == 1:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    for name, node in params.items():
        if name == "bias":
            out["bias"] = _array(node, "bias", ndim=1)
        elif name == "fm_embedding":
            _keys(node, {"table"}, name)
            out["fm_embedding.table"] = _array(node["table"], name, ndim=2)
        elif _DENSE.match(name):
            _keys(node, {"kernel", "bias"}, name)
            kernel = _array(node["kernel"], f"{name}/kernel", ndim=2)
            bias = _array(node["bias"], f"{name}/bias", ndim=1)
            if kernel.shape[1] != bias.shape[0]:
                raise ValueError(
                    f"{name}: kernel {tuple(kernel.shape)} does not match "
                    f"bias {tuple(bias.shape)}")
            out[f"{name}.weight"] = kernel.T.contiguous()
            out[f"{name}.bias"] = bias
        else:
            raise ValueError(f"unexpected flax param {name!r}")
    for name in ("fm_embedding.table", "dense_linear.weight",
                 "dnn_out.weight", "bias"):
        if name not in out:
            raise ValueError(f"flax params lack {name!r}")
    hidden = sorted(int(k[4:-7]) for k in out
                    if re.match(r"^dnn_\d+\.weight$", k))
    if hidden != list(range(len(hidden))):
        raise ValueError(f"dnn layers are not dnn_0..dnn_k: {hidden}")
    if expected is not None:
        _check_against(out, expected)
    return out


def _keys(node: Mapping[str, Any], want: set, where: str) -> None:
    got = set(node)
    if got != want:
        raise ValueError(
            f"{where}: missing {sorted(want - got)}, extra {sorted(got - want)}")


def _array(x: Any, where: str, ndim: int) -> torch.Tensor:
    a = np.asarray(x, dtype=np.float32)
    if a.ndim != ndim:
        raise ValueError(f"{where}: want {ndim}-D, got shape {a.shape}")
    return torch.from_numpy(a.copy())


def _check_against(out: Mapping[str, torch.Tensor],
                   expected: Any) -> None:
    if isinstance(expected, torch.nn.Module):
        expected = expected.state_dict()
    missing = sorted(set(expected) - set(out))
    extra = sorted(set(out) - set(expected))
    if missing or extra:
        raise ValueError(f"state_dict keys: missing {missing}, extra {extra}")
    for k, v in out.items():
        if tuple(v.shape) != tuple(expected[k].shape):
            raise ValueError(
                f"{k}: converted shape {tuple(v.shape)} != model's "
                f"{tuple(expected[k].shape)}")
