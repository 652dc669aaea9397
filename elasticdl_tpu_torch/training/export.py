"""Model export for serving.

Counterpart of `elasticdl_tpu/training/export.py`. After training, the
worker writes the trained parameters and a manifest:

  <export_dir>/params.pt        torch.save of {"params": {name: tensor},
                                "buffers": {name: tensor}} (host tensors:
                                the model's state_dict, BatchNorm's
                                running averages in the buffers)
  <export_dir>/model_info.json  model_def, model_params, step, framework info

`load_model()` rebuilds the model from the port's zoo and loads the
parameters, on the device the caller names.

`export_saved_model()` is the serving artifact, the counterpart of the
reference's jax2tf SavedModel: `torch.export` of the loaded model's
`model(features, training=False)` with one symbolic batch dimension on
every feature leaf, saved as

  <out_dir>/model.pt2           torch.export.save of the ExportedProgram
                                (graph and weights; its extra file
                                `serving.json` names the device)

and `load_saved_model()` loads it back as a callable. The flash forward
is the dispatcher op `edl::flash_fwd` (`ops/flash_attention.py`), so an
exported LM launches K2' (K2) on the card; loading needs that op
registered, which importing this module does.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from elasticdl_tpu_torch.common import runtime
from elasticdl_tpu_torch.common.log_utils import default_logger
from elasticdl_tpu_torch.data.prefetch import tree_map
# registers edl::flash_fwd, which an exported LM's program calls
from elasticdl_tpu_torch.ops import flash_attention
from elasticdl_tpu_torch.parallel import mesh as mesh_lib
from elasticdl_tpu_torch.version import __version__

logger = default_logger(__name__)

PARAMS_FILE = "params.pt"
INFO_FILE = "model_info.json"
SAVED_MODEL_FILE = "model.pt2"
SERVING_INFO = "serving.json"


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


class _Serve(torch.nn.Module):
    """The serving call `model(features, training=False)` as a module's
    forward, for `torch.export`."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, features):
        return self.model(features, training=False)


def _device_name(device: torch.device) -> str:
    """`device` with its index: `cuda` is the current card."""
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return str(device)


def _max_serving_batch(model: torch.nn.Module) -> Optional[int]:
    """The largest batch the exported program may serve: the flash
    kernels put B x heads on the grid's y dimension (`MAX_GRID_Y`), so a
    model with attention caps B at MAX_GRID_Y // heads; None (no cap)
    for a model without it."""
    heads = [int(m.heads) for m in model.modules()
             if isinstance(getattr(m, "heads", None), int)]
    return flash_attention.MAX_GRID_Y // max(heads) if heads else None


def export_saved_model(
    export_dir: str,
    model_zoo: str,
    example_features: Any,
    out_dir: Optional[str] = None,
    device: runtime.DeviceLike = None,
) -> str:
    """Export the served model of an export directory with `torch.export`:
    `model(features, training=False)` on `device` (None: the GPU, raising
    where there is none), traced on `example_features` (numpy arrays or
    tensors, a dict of them or one) with the leading dimension of every
    leaf one symbolic `Dim("batch")`, so one program serves any batch (a
    model with attention up to `MAX_GRID_Y // heads`: the flash kernels'
    grid). The example batch must be at least 2 (`torch.export`
    specializes sizes 0 and 1). Saves `model.pt2` under `out_dir`
    (default `<export_dir>/saved_model`) and returns that directory, as
    the reference returns its SavedModel's. A trace that fails raises."""
    from torch.export import Dim

    dev = runtime.resolve_device(device)
    features = tree_map(lambda x: torch.as_tensor(x).to(dev),
                        example_features)
    sizes = set()
    tree_map(lambda x: sizes.add(int(x.shape[0])), features)
    if len(sizes) != 1 or min(sizes) < 2:
        raise ValueError(f"example_features need one leading batch size of "
                         f"at least 2 on every leaf, got {sorted(sizes)}")
    model, _ = load_model(export_dir, model_zoo, device=dev)
    cap = _max_serving_batch(model)
    batch = Dim("batch", min=1, max=cap)
    dynamic = tree_map(lambda _: {0: batch}, features)
    with torch.no_grad():
        program = torch.export.export(_Serve(model), (features,),
                                      dynamic_shapes=(dynamic,))
    out_dir = os.path.abspath(out_dir or os.path.join(export_dir,
                                                      "saved_model"))
    os.makedirs(out_dir, exist_ok=True)
    info = {"device": _device_name(dev)}
    path = os.path.join(out_dir, SAVED_MODEL_FILE)
    torch.export.save(program, path,
                      extra_files={SERVING_INFO: json.dumps(info)})
    logger.info("exported serving program (%s, batch <= %s) -> %s",
                info["device"], cap, path)
    return out_dir


def load_saved_model(path: str,
                     device: runtime.DeviceLike = None) -> Callable:
    """Load `export_saved_model`'s program (its directory or the `.pt2`)
    as a callable `serve(features)`, the counterpart of
    `tf.saved_model.load(path).serve`. The program runs on the device it
    was exported on; `device` (None: the GPU) must be that device, or
    this raises: it does not move a program. The port's op registration
    (`ops/flash_attention.py`, imported with this module) comes first, so
    the program's `edl::flash_fwd` nodes resolve."""
    want = _device_name(runtime.resolve_device(device))
    if os.path.isdir(path):
        path = os.path.join(path, SAVED_MODEL_FILE)
    extra = {SERVING_INFO: ""}
    program = torch.export.load(path, extra_files=extra)
    info = json.loads(extra[SERVING_INFO])
    if info["device"] != want:
        raise ValueError(f"{path} was exported on {info['device']} and "
                         f"serves there only, not on {want}")
    return program.module()
