"""Typed job configuration — the fields the ported train step reads.

Counterpart of `elasticdl_tpu/common/config.py` (`JobConfig`,
`from_argv`). The flag names, defaults and the `key=value;...` parsing of
`--model_params` are the reference's, so one argv drives either package.
The fields of the job path (data, checkpointing, master, mesh) join when
the port takes that path over.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass, field, fields
from typing import Any, Dict, List


def parse_kv_params(s: str) -> Dict[str, Any]:
    """Parse 'a=1;b=hello;c=0.5' into a dict with literal-ish coercion."""
    out: Dict[str, Any] = {}
    if not s:
        return out
    for item in s.split(";"):
        item = item.strip()
        if not item:
            continue
        if "=" not in item:
            raise ValueError(f"Malformed key=value item: {item!r}")
        k, v = item.split("=", 1)
        k, v = k.strip(), v.strip()
        for caster in (int, float):
            try:
                out[k] = caster(v)
                break
            except ValueError:
                continue
        else:
            if v.lower() in ("true", "false"):
                out[k] = v.lower() == "true"
            else:
                out[k] = v
    return out


@dataclass
class JobConfig:
    """The model-zoo contract of a job and its compute dtype."""

    model_zoo: str = "model_zoo"
    model_def: str = ""           # dotted path: "deepfm.deepfm.custom_model"
    model_params: Dict[str, Any] = field(default_factory=dict)
    # Optional per-function overrides (--loss=..., --optimizer=...)
    loss: str = ""
    optimizer: str = ""
    dataset_fn: str = ""
    eval_metrics_fn: str = ""
    prediction_outputs_processor: str = ""
    compute_dtype: str = "bfloat16"

    _DICT_FIELDS = ("model_params",)

    @classmethod
    def from_argv(cls, argv: List[str]) -> "JobConfig":
        parser = argparse.ArgumentParser("elasticdl-tpu-torch")
        defaults = cls()
        for f in fields(cls):
            default = getattr(defaults, f.name)
            if f.name in cls._DICT_FIELDS:
                parser.add_argument("--" + f.name, type=str, default="")
            else:
                parser.add_argument("--" + f.name, type=type(default),
                                    default=default)
        ns, unknown = parser.parse_known_args(argv)
        if unknown:
            raise ValueError(f"Unknown flags: {unknown}")
        kwargs: Dict[str, Any] = {}
        for f in fields(cls):
            v = getattr(ns, f.name)
            if f.name in cls._DICT_FIELDS and isinstance(v, str):
                v = parse_kv_params(v)
            kwargs[f.name] = v
        return cls(**kwargs)
