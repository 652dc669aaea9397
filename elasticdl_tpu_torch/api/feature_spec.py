"""Declarative feature specs — the device half on tensors.

Counterpart of `elasticdl_tpu/api/feature_spec.py` for the features the
DeepFM path declares: `Numeric` (raw, log1p or standardized) and integer
`Hashed` columns sharing one offset id space. A `FeatureSpec` computes the
same per-feature offsets and `total_vocab` as the reference, so ids and
table shapes agree row for row. Bag features, bucketized and lookup
columns, and the host half (string hashing) join with the data path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

from elasticdl_tpu_torch.api import preprocessing as pp

# A feature reads from a named 1-D column ("age") or a column of a packed
# 2-D array (("cat", 3) = cols["cat"][:, 3]).
Source = Union[str, Tuple[str, int]]


def _col(cols: Dict[str, Any], source: Source):
    if isinstance(source, tuple):
        key, idx = source
        return cols[key][:, idx]
    return cols[source]


@dataclass(frozen=True)
class Numeric:
    """Dense float feature. transform: None | 'log1p' | ('standard', mean,
    std)."""

    name: str
    transform: Any = None
    source: Optional[Source] = None

    @property
    def src(self) -> Source:
        return self.name if self.source is None else self.source

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        v = x.to(torch.float32)
        if self.transform is None:
            return v
        if self.transform == "log1p":
            return pp.log_normalize(v)
        kind, mean, std = self.transform
        if kind != "standard":
            raise ValueError(f"unknown numeric transform {self.transform!r}")
        # mean and std rounded to float32 first, as the reference does
        mean32 = torch.tensor(mean, dtype=torch.float32, device=v.device)
        std32 = torch.tensor(max(std, 1e-12), dtype=torch.float32,
                             device=v.device)
        return (v - mean32) / std32


@dataclass(frozen=True)
class Hashed:
    """Value -> [0, num_bins) by deterministic hash. Integer sources hash
    on the device; strings=True sources arrive already hashed by the host
    half, keyed by the feature's name."""

    name: str
    num_bins: int
    strings: bool = False
    source: Optional[Source] = None

    size = property(lambda self: self.num_bins)
    src = property(lambda self: self.name if self.source is None else self.source)


FeatureDef = Union[Numeric, Hashed]


def numeric(name: str, *, standardize: Optional[Tuple[float, float]] = None,
            log1p: bool = False, source: Optional[Source] = None) -> Numeric:
    if standardize is not None and log1p:
        raise ValueError("choose standardize OR log1p, not both")
    t = ("standard", *standardize) if standardize is not None else (
        "log1p" if log1p else None)
    return Numeric(name, t, source)


def hashed(name: str, num_bins: int, *, strings: bool = False,
           source: Optional[Source] = None) -> Hashed:
    return Hashed(name, int(num_bins), strings, source)


class FeatureSpec:
    """An ordered feature list compiled into the device transform.

    Output contract:
      {"dense": (B, dense_dim) float32,
       "cat":   (B, cat_dim)   int32 in ONE shared id space of
                `total_vocab` rows (per-feature offsets applied)}
    """

    def __init__(self, features: Sequence[FeatureDef]):
        if not features:
            raise ValueError("FeatureSpec needs at least one feature")
        names = [f.name for f in features]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate feature names in {names}")
        for f in features:
            if not isinstance(f, (Numeric, Hashed)):
                raise TypeError(
                    f"feature {f!r}: only Numeric and Hashed features are "
                    "ported so far")
        self.features = tuple(features)
        self.dense_features = tuple(
            f for f in features if isinstance(f, Numeric))
        self.cat_features = tuple(
            f for f in features if isinstance(f, Hashed))
        self.dense_dim = len(self.dense_features)
        self.cat_dim = len(self.cat_features)
        self.offsets: Dict[str, int] = {}
        off = 0
        for f in self.cat_features:
            self.offsets[f.name] = off
            off += f.size
        self.total_vocab = off

    def device_transform(
        self, inter: Dict[str, torch.Tensor]
    ) -> Dict[str, torch.Tensor]:
        """Columns -> {"dense", "cat"} on the columns' device.

        `inter` is keyed by feature name (host-resolved ids) OR by raw
        source columns, so a model whose inputs are packed arrays (Criteo
        "dense"/"cat") applies the whole spec inside its forward."""

        def col(f):
            return inter[f.name] if f.name in inter else _col(inter, f.src)

        dense = [f.apply(col(f)) for f in self.dense_features]
        cat = []
        for f in self.cat_features:
            if f.strings:
                if f.name not in inter:
                    raise ValueError(
                        f"string feature {f.name!r} needs host_transform "
                        "before device_transform")
                ids = inter[f.name].to(torch.int32)
            else:
                ids = pp.hash_bucket(col(f), f.num_bins)
            cat.append(ids + self.offsets[f.name])
        out = {}
        if dense:
            out["dense"] = torch.stack(dense, dim=-1)
        if cat:
            out["cat"] = torch.stack(cat, dim=-1).to(torch.int32)
        return out
