"""Model export for serving.

Counterpart of `elasticdl_tpu/training/export.py`. After training, the
worker writes the trained parameters and a manifest:

  <export_dir>/params.pt        torch.save of {"params": {name: tensor},
                                "buffers": {name: tensor}} (host tensors:
                                the model's state_dict, BatchNorm's
                                running averages in the buffers)
  <export_dir>/model_info.json  model_def, model_params, step, framework info

`load_model()` rebuilds the model from the port's zoo and loads the
parameters, on the device the caller names. The reference's
`export_saved_model` converts an export to a TF SavedModel through
jax2tf; the port has no counterpart (it would take `torch.export` and a
serving runtime), so it raises.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from elasticdl_tpu_torch.common import runtime
from elasticdl_tpu_torch.common.log_utils import default_logger
from elasticdl_tpu_torch.parallel import mesh as mesh_lib
from elasticdl_tpu_torch.version import __version__

logger = default_logger(__name__)

PARAMS_FILE = "params.pt"
INFO_FILE = "model_info.json"


def export_model(
    state: Any,
    export_dir: str,
    model_def: str = "",
    model_params: Optional[Dict[str, Any]] = None,
    module_name: str = "",
    write_files: bool = True,
) -> str:
    """Write a serving export of a trained TrainState. Returns export_dir.
    Under a mesh every rank calls it: each sharded table is gathered whole
    to the mesh's leader, which writes the files. `write_files=False`
    only resolves the directory (after joining the gather)."""
    export_dir = os.path.abspath(export_dir)
    params = {k: p.detach() for k, p in state.params.items()}
    if state.mesh is not None:
        for name, rows in state.row_shards.items():
            params[name] = mesh_lib.gather_rows(state.mesh, params[name], rows)
        write_files = write_files and state.mesh.is_leader
    if not write_files:
        return export_dir
    params = {k: p.to("cpu", copy=True) for k, p in params.items()}
    buffers = {k: b.detach().to("cpu", copy=True)
               for k, b in state.buffers.items()}
    os.makedirs(export_dir, exist_ok=True)
    params_path = os.path.join(export_dir, PARAMS_FILE)
    tmp = params_path + ".tmp"
    with open(tmp, "wb") as f:
        torch.save({"params": params, "buffers": buffers}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, params_path)
    n_params = sum(t.numel() for t in params.values())
    info = {
        "format": "elasticdl-tpu-torch-export-v1",
        "model_def": model_def,
        "module_name": module_name,
        "model_params": {k: v for k, v in (model_params or {}).items()},
        "step": int(state.model_version),
        "num_params": int(n_params),
        "framework_version": __version__,
        "torch_version": torch.__version__,
    }
    # the manifest is what read_info/load_model trust to decode
    # PARAMS_FILE — land it atomically, after the parameters
    info_path = os.path.join(export_dir, INFO_FILE)
    tmp = info_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(info, f, indent=2, default=str)
    os.replace(tmp, info_path)
    logger.info(
        "exported model (%.3fM params, step %d) -> %s",
        n_params / 1e6, info["step"], export_dir,
    )
    return export_dir


def read_info(export_dir: str) -> Dict[str, Any]:
    with open(os.path.join(export_dir, INFO_FILE)) as f:
        return json.load(f)


def load_variables(export_dir: str) -> Dict[str, Any]:
    """The exported variables {"params": {name: host tensor},
    "buffers": {name: host tensor}}."""
    return torch.load(os.path.join(export_dir, PARAMS_FILE),
                      map_location="cpu", weights_only=True)


def load_model(
    export_dir: str,
    model_zoo: str,
    model_def: str = "",
    model_params: Optional[Dict[str, Any]] = None,
    device: runtime.DeviceLike = None,
) -> Tuple[Any, Dict[str, Any]]:
    """Rebuild (model, variables) for serving from an export directory:
    the zoo model, built with the recorded model_params (overridable),
    holding the exported parameters on `device` (None: the GPU, raising
    where there is none), in eval mode. `model(features, training=False)`
    is the serving call; model_def/model_params default to the values
    recorded at export time."""
    from elasticdl_tpu_torch.common.model_utils import load_module

    info = read_info(export_dir)
    model_def = model_def or info["model_def"]
    params = dict(info.get("model_params", {}))
    params.update(model_params or {})
    module, func_name = load_module(model_zoo, model_def)
    model = getattr(module, func_name)(**params)
    variables = load_variables(export_dir)
    model.load_state_dict({**variables["params"],
                           **variables.get("buffers", {})})
    model.to(runtime.resolve_device(device)).eval()
    return model, variables


def export_saved_model(
    export_dir: str,
    model_zoo: str,
    example_features: Any,
    out_dir: Optional[str] = None,
) -> Optional[str]:
    raise NotImplementedError(
        "export_saved_model converts through jax2tf to a TF SavedModel; "
        "the port has no counterpart (see README: out of scope)")
