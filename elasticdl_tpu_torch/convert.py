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

for <dense> in q, k, v, proj, mlp_in, mlp_out, kernels transposed.

Every other tree (xDeepFM, Wide & Deep, the MNIST CNN and the ResNets) is
mapped by name: the path's keys joined with dots, a Dense `kernel`
(in, out) -> `weight` (out, in), a Conv `kernel` HWIO -> `weight` OIHW,
every other leaf (`bias`, `table`, BatchNorm's `scale`, the CIN's `w{i}`)
as it is. The port's modules carry the flax names, so the by-name check
against the model (`expected`) finds every converted name used. A
`batch_stats` tree (BatchNorm's `mean` and `var`) maps the same way onto
the model's buffers.

`train_state_from_flax(params, mu, nu, count, step)` carries a whole
reference TrainState across: the params as above, Adam's first and second
moments (`mu`, `nu`: trees shaped like the params, mapped the same way),
or SGD's momentum `trace`, the `batch_stats`, the optimizer's update
count and the global step. `load_train_state(state, converted)` installs
the result in a port TrainState built by `Trainer.init_state` (its
params, its buffers, the optimizer's `exp_avg`, `exp_avg_sq` and `step`
slots or its `momentum_buffer`s, a schedule's `count`, and its step), so
a reference job and a port job can start from one state. Any array type
that numpy can read (flax's jax arrays included) is accepted; the caller
hands the trees over as numpy. Given the `row_shards` of a TrainState
under a mesh, each sharded table and its moments are cut to this rank's
row range, as that state holds them.

The embedding tier's tables need no conversion: a tier shard's weights
are its seed-made numpy rows (`embedding/store._init_shard_rows`), which
both packages build bit for bit, and the shard files
(`<checkpoint_dir>/emb/`) that carry anything pushed since have one
format that either package reads.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from elasticdl_tpu_torch.parallel import mesh as mesh_lib

_DENSE = re.compile(r"^(dense_linear|dnn_out|dnn_\d+)$")
_BLOCK = re.compile(r"^block_(\d+)$")
_BLOCK_DENSES = ("q", "k", "v", "proj", "mlp_in", "mlp_out")
_BLOCK_NORMS = ("LayerNorm_0", "LayerNorm_1")


def params_from_flax(
    params: Mapping[str, Any],
    expected: Optional[Mapping[str, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """The port's parameters for a flax params tree: DeepFM's, the
    transformer LM's, or by name (module docstring).

    Raises ValueError on a missing or extra key or a shape mismatch:
    within the tree (for DeepFM and the LM: a kernel that disagrees with
    its bias, a table that is not 2-D, a gap in the dnn_i or block_i
    sequence), and, when `expected` (a state_dict, or a module, whose
    parameters are then compared) is given, against its keys and
    shapes."""
    if "params" in params and len(params) == 1:
        params = params["params"]
    if "tok_embed" in params:
        out = _lm_params(params)
    elif "fm_embedding" in params:
        out = _deepfm_params(params)
    else:
        out = _by_name(params)
    if expected is not None:
        _check_against(out, expected)
    return out


def buffers_from_flax(batch_stats: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's buffers for a flax `batch_stats` tree (by name)."""
    if "batch_stats" in batch_stats and len(batch_stats) == 1:
        batch_stats = batch_stats["batch_stats"]
    return _by_name(batch_stats)


def train_state_from_flax(
    params: Mapping[str, Any],
    mu: Optional[Mapping[str, Any]] = None,
    nu: Optional[Mapping[str, Any]] = None,
    count: Any = 0,
    step: Any = 0,
    expected: Optional[Mapping[str, torch.Tensor]] = None,
    row_shards: Optional[Mapping[str, mesh_lib.RowShard]] = None,
    trace: Optional[Mapping[str, Any]] = None,
    batch_stats: Optional[Mapping[str, Any]] = None,
) -> Dict[str, Any]:
    """The port's counterpart of a reference TrainState: {"params",
    "exp_avg", "exp_avg_sq" (Adam's moments `mu`, `nu`) or
    "momentum_buffer" (SGD's `trace`), "buffers" (`batch_stats`): name ->
    tensor; "count" (the optimizer's update count), "step": ints}. Raises
    ValueError on a missing or extra key or a shape mismatch, in the
    params and in the slots (against the params). `row_shards` (a
    TrainState's) cuts the tables it names to their rows; `expected` is
    checked after that cut."""
    out_params = params_from_flax(params)
    slots = {}
    for what, tree in (("exp_avg", mu), ("exp_avg_sq", nu),
                       ("momentum_buffer", trace)):
        if tree is None:
            continue
        try:
            slots[what] = params_from_flax(tree, out_params)
        except ValueError as e:
            raise ValueError(f"optimizer {what}: {e}") from e
    for tree in (out_params, *slots.values()):
        for name, rows in (row_shards or {}).items():
            tree[name] = tree[name][rows.start:rows.stop].clone()
    if expected is not None:
        _check_against(out_params, expected)
    out = {"params": out_params, **slots,
           "count": int(np.asarray(count)), "step": int(np.asarray(step))}
    if batch_stats is not None:
        out["buffers"] = buffers_from_flax(batch_stats)
    return out


def load_train_state(state: Any, converted: Mapping[str, Any]) -> Any:
    """Install `train_state_from_flax`'s output in the port TrainState
    `state` (in place; returned): parameters and buffers copied into the
    live tensors; each parameter's Adam slots set to the reference's
    moments with its update count, or its SGD momentum to the
    reference's trace; a param group's schedule `count` to the update
    count; and the global step."""
    names = list(state.params)
    _check_against(converted["params"], {k: p for k, p in state.params.items()})
    _check_against(converted.get("buffers", {}), state.buffers)
    with torch.no_grad():
        for name in names:
            state.params[name].copy_(converted["params"][name])
        for name, b in state.buffers.items():
            b.copy_(converted["buffers"][name])
    sd = state.optimizer.state_dict()
    if len(sd["state"]) and set(sd["state"]) != set(range(len(names))):
        raise ValueError("optimizer slots do not match the parameters")
    if "exp_avg" in converted:
        sd["state"] = {
            i: {"step": torch.tensor(float(converted["count"])),
                "exp_avg": converted["exp_avg"][name].clone(),
                "exp_avg_sq": converted["exp_avg_sq"][name].clone()}
            for i, name in enumerate(names)}
    elif "momentum_buffer" in converted:
        sd["state"] = {
            i: {"momentum_buffer": converted["momentum_buffer"][name].clone()}
            for i, name in enumerate(names)}
    for group in sd["param_groups"]:
        if "count" in group:
            group["count"] = int(converted["count"])
    state.optimizer.load_state_dict(sd)
    state.step = int(converted["step"])
    return state


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


def _by_name(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """A flax tree mapped by name: Dense kernels transposed, Conv kernels
    HWIO -> OIHW, every other leaf as it is."""
    out: Dict[str, torch.Tensor] = {}
    for key, node in tree.items():
        if isinstance(node, Mapping):
            out.update(_by_name(node, f"{prefix}{key}."))
            continue
        a = np.asarray(node, dtype=np.float32)
        if key == "kernel" and a.ndim == 2:
            out[f"{prefix}weight"] = torch.from_numpy(a.T.copy())
        elif key == "kernel" and a.ndim == 4:
            out[f"{prefix}weight"] = torch.from_numpy(
                a.transpose(3, 2, 0, 1).copy())
        elif key == "kernel":
            raise ValueError(f"{prefix}kernel: want 2-D or 4-D, got {a.shape}")
        else:
            out[f"{prefix}{key}"] = torch.from_numpy(a.copy())
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
        expected = dict(expected.named_parameters())
    missing = sorted(set(expected) - set(out))
    extra = sorted(set(out) - set(expected))
    if missing or extra:
        raise ValueError(f"state_dict keys: missing {missing}, extra {extra}")
    for k, v in out.items():
        if tuple(v.shape) != tuple(expected[k].shape):
            raise ValueError(
                f"{k}: converted shape {tuple(v.shape)} != model's "
                f"{tuple(expected[k].shape)}")
