"""Carry the reference's weights across to the port.

`params_from_flax(params)` maps a flax params tree (a nested dict of
arrays) onto the `state_dict` of the port's twin of the model, chosen by
the tree's top-level keys. For DeepFM (`model_zoo/deepfm/deepfm.py`):

  fm_embedding/table          -> fm_embedding.table (as is, padded rows too)
  <dense>/kernel (in, out)    -> <dense>.weight (out, in), transposed
  <dense>/bias                -> <dense>.bias
  bias                        -> bias

for <dense> in dense_linear, dnn_0 ... dnn_{k-1}, dnn_out. For the
transformer LM (`model_zoo/transformer/transformer_lm.py`, a tree with
`tok_embed`):

  tok_embed/embedding, pos_embed          -> the same names, as they are
  block_i/<dense>/{kernel,bias}           -> block_i.<dense>.{weight,bias}
  block_i/LayerNorm_{0,1}/{scale,bias}    -> block_i.LayerNorm_{0,1}.*
  LayerNorm_0/{scale,bias}, lm_head/...   -> the same names

for <dense> in q, k, v, proj, mlp_in, mlp_out, kernels transposed. The
optimizer's slots start at zero on both sides, so only parameters cross.
Any array type that numpy can read (flax's jax arrays included) is
accepted.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

_DENSE = re.compile(r"^(dense_linear|dnn_out|dnn_\d+)$")
_BLOCK = re.compile(r"^block_(\d+)$")
_BLOCK_DENSES = ("q", "k", "v", "proj", "mlp_in", "mlp_out")
_BLOCK_NORMS = ("LayerNorm_0", "LayerNorm_1")


def params_from_flax(
    params: Mapping[str, Any],
    expected: Optional[Mapping[str, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """The port's state_dict for a flax params tree of DeepFM or of the
    transformer LM.

    Raises ValueError on a missing or extra key or a shape mismatch:
    within the tree (a kernel that disagrees with its bias, a table that
    is not 2-D, a gap in the dnn_i or block_i sequence), and, when
    `expected` (a state_dict or module of the port) is given, against its
    keys and shapes."""
    if "params" in params and len(params) == 1:
        params = params["params"]
    convert = _lm_params if "tok_embed" in params else _deepfm_params
    out = convert(params)
    if expected is not None:
        _check_against(out, expected)
    return out


def _deepfm_params(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for name, node in params.items():
        if name == "bias":
            out["bias"] = _array(node, "bias", ndim=1)
        elif name == "fm_embedding":
            _keys(node, {"table"}, name)
            out["fm_embedding.table"] = _array(node["table"], name, ndim=2)
        elif _DENSE.match(name):
            out.update(_dense(node, name))
        else:
            raise ValueError(f"unexpected flax param {name!r}")
    _require(out, ("fm_embedding.table", "dense_linear.weight",
                   "dnn_out.weight", "bias"))
    _consecutive(out, r"^dnn_(\d+)\.weight$", "dnn")
    return out


def _lm_params(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for name, node in params.items():
        if name == "tok_embed":
            _keys(node, {"embedding"}, name)
            out["tok_embed.embedding"] = _array(node["embedding"], name,
                                                ndim=2)
        elif name == "pos_embed":
            out["pos_embed"] = _array(node, name, ndim=2)
        elif name == "lm_head":
            out.update(_dense(node, name))
        elif name == "LayerNorm_0":
            out.update(_norm(node, name))
        elif _BLOCK.match(name):
            _keys(node, set(_BLOCK_DENSES + _BLOCK_NORMS), name)
            for sub in _BLOCK_DENSES:
                out.update(_dense(node[sub], f"{name}.{sub}"))
            for sub in _BLOCK_NORMS:
                out.update(_norm(node[sub], f"{name}.{sub}"))
        else:
            raise ValueError(f"unexpected flax param {name!r}")
    _require(out, ("tok_embed.embedding", "pos_embed", "LayerNorm_0.scale",
                   "lm_head.weight"))
    _consecutive(out, r"^block_(\d+)\.q\.weight$", "block")
    return out


def _dense(node: Mapping[str, Any], name: str) -> Dict[str, torch.Tensor]:
    """flax Dense {kernel (in, out), bias} -> {name.weight (out, in),
    name.bias}."""
    _keys(node, {"kernel", "bias"}, name)
    kernel = _array(node["kernel"], f"{name}/kernel", ndim=2)
    bias = _array(node["bias"], f"{name}/bias", ndim=1)
    if kernel.shape[1] != bias.shape[0]:
        raise ValueError(
            f"{name}: kernel {tuple(kernel.shape)} does not match "
            f"bias {tuple(bias.shape)}")
    return {f"{name}.weight": kernel.T.contiguous(), f"{name}.bias": bias}


def _norm(node: Mapping[str, Any], name: str) -> Dict[str, torch.Tensor]:
    _keys(node, {"scale", "bias"}, name)
    scale = _array(node["scale"], f"{name}/scale", ndim=1)
    bias = _array(node["bias"], f"{name}/bias", ndim=1)
    if scale.shape != bias.shape:
        raise ValueError(f"{name}: scale {tuple(scale.shape)} does not "
                         f"match bias {tuple(bias.shape)}")
    return {f"{name}.scale": scale, f"{name}.bias": bias}


def _require(out: Mapping[str, torch.Tensor], names) -> None:
    for name in names:
        if name not in out:
            raise ValueError(f"flax params lack {name!r}")


def _consecutive(out: Mapping[str, torch.Tensor], pattern: str,
                 what: str) -> None:
    """The numbered layers matching `pattern` are 0..k-1, no gap."""
    found = sorted(int(m.group(1)) for m in map(re.compile(pattern).match, out)
                   if m)
    if found != list(range(len(found))):
        raise ValueError(f"{what} layers are not {what}_0..{what}_k: {found}")


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
