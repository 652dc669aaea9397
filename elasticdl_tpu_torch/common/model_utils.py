"""Model-zoo module loading.

Reference parity: elasticdl/python/common/model_utils.py — resolve the user's
model by dotted path (`--model_def=mnist.mnist_cnn.custom_model`), add the
model-zoo root to sys.path, and find the companion functions
(`loss`, `optimizer`, `dataset_fn`, `eval_metrics_fn`, `callbacks`) in the
same module, each overridable by its own flag.
"""

from __future__ import annotations

import importlib
import os
import sys
from types import ModuleType
from typing import Any, Callable, Optional


def load_module(model_zoo: str, dotted: str) -> tuple[ModuleType, str]:
    """Load `pkg.module` of `pkg.module.func` under the model_zoo root.

    Returns (module, func_name).
    """
    if not dotted:
        raise ValueError("empty model_def")
    root = os.path.abspath(model_zoo)
    if root not in sys.path:
        sys.path.insert(0, root)
    module_path, _, func_name = dotted.rpartition(".")
    if not module_path:
        raise ValueError(
            f"model_def must be 'package.module.function', got {dotted!r}"
        )
    module = importlib.import_module(module_path)
    return module, func_name


def get_module_attr(
    module: ModuleType, name: str, override: str = "", required: bool = True
) -> Optional[Callable[..., Any]]:
    """Fetch a contract function from the model module.

    `override` is a flag like the reference's `--loss=my_loss`: either a bare
    name looked up in the same module, or a fully dotted path to elsewhere.
    """
    if override:
        if "." in override:
            mod_path, _, fn = override.rpartition(".")
            other = importlib.import_module(mod_path)
            attr = getattr(other, fn, None)
        else:
            attr = getattr(module, override, None)
        if attr is None:
            # an explicit override that resolves to nothing is always an
            # error, even for optional contract functions — fail fast
            raise ValueError(f"override {override!r} not found for {name}")
        return attr
    attr = getattr(module, name, None)
    if attr is None and required:
        raise ValueError(
            f"model module {module.__name__!r} defines no {name}() and no override given"
        )
    return attr
