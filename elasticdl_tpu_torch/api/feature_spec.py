"""Declarative feature specs: a host half in numpy and a device half on
tensors.

Counterpart of `elasticdl_tpu/api/feature_spec.py`. A `FeatureSpec` is an
ordered list of feature declarations that compiles into two halves:

- the host half (`host_transform`, numpy): string hashing (crc32),
  string-vocabulary lookup and ragged bags to padded rows; every other
  feature passes through raw under its feature name;
- the device half (`device_transform`, torch, on the columns' device):
  integer hashing, bucketization, normalization, integer lookup and the
  shared id space's offsets.

`transform` is the numpy composition of both, for per-record parsers
(`csv_parser`, the census model's) and host-only pipelines. Both halves
give the reference's ids bit for bit and the same per-feature offsets and
`total_vocab`, so ids and table shapes agree row for row.

Bag features (`hashed_bag`, `lookup_bag`) resolve on the host to a
(B, max_len) int32 bag with -1 pads, which `Embedding`'s combiners read;
each bag keeps its own id space rather than joining the shared offsets.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
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
        mean, std = self._standard()
        # mean and std rounded to float32 first, as the reference does
        mean32 = torch.tensor(mean, dtype=torch.float32, device=v.device)
        std32 = torch.tensor(std, dtype=torch.float32, device=v.device)
        return (v - mean32) / std32

    def apply_np(self, x) -> np.ndarray:
        v = np.asarray(x, np.float32)
        if self.transform is None:
            return v
        if self.transform == "log1p":
            return np.log1p(np.maximum(v, np.float32(0.0)))
        mean, std = self._standard()
        return (v - np.float32(mean)) / np.float32(std)

    def _standard(self) -> Tuple[float, float]:
        kind, mean, std = self.transform
        if kind != "standard":
            raise ValueError(f"unknown numeric transform {self.transform!r}")
        return mean, max(std, 1e-12)


@dataclass(frozen=True)
class Bucketized:
    """Continuous -> bucket id in [0, len(boundaries)]."""

    name: str
    boundaries: Tuple[float, ...]
    source: Optional[Source] = None

    size = property(lambda self: len(self.boundaries) + 1)
    src = property(lambda self: self.name if self.source is None else self.source)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return pp.bucketize(x, self.boundaries)

    def apply_np(self, x) -> np.ndarray:
        b = np.asarray(self.boundaries, np.float32)
        return np.searchsorted(
            b, np.asarray(x, np.float32), side="right").astype(np.int32)


@dataclass(frozen=True)
class Hashed:
    """Value -> [0, num_bins) by deterministic hash. strings=True sources
    hash on the host (crc32); integer sources on the device (the murmur3
    finalizer)."""

    name: str
    num_bins: int
    strings: bool = False
    source: Optional[Source] = None

    size = property(lambda self: self.num_bins)
    src = property(lambda self: self.name if self.source is None else self.source)


@dataclass(frozen=True)
class Lookup:
    """Static-vocabulary lookup: vocab[i] -> num_oov + i, unknown -> hash
    into [0, num_oov). A string vocab runs on the host, an integer vocab
    on the device."""

    name: str
    vocab: Tuple[Any, ...]
    num_oov: int = 1
    source: Optional[Source] = None

    size = property(lambda self: len(self.vocab) + self.num_oov)
    src = property(lambda self: self.name if self.source is None else self.source)

    @property
    def strings(self) -> bool:
        return bool(self.vocab) and isinstance(self.vocab[0], (str, bytes))


@dataclass(frozen=True)
class HashedBag:
    """Multi-valued (ragged) categorical -> a (B, max_len) int32 bag with
    -1 pads, in its own id space [0, num_bins). Resolved on the host."""

    name: str
    num_bins: int
    max_len: int
    strings: bool = False
    delimiter: str = "|"
    source: Optional[Source] = None

    size = property(lambda self: self.num_bins)
    src = property(lambda self: self.name if self.source is None else self.source)

    def elem_ids(self, elems) -> np.ndarray:
        if not len(elems):
            return np.empty((0,), np.int32)
        if self.strings:
            return pp.hash_strings(list(elems), self.num_bins)
        return _np_hash_bucket(
            np.asarray(list(elems)).astype(np.int32), self.num_bins)


@dataclass(frozen=True)
class LookupBag:
    """HashedBag's vocabulary twin: elements map vocab[i] -> num_oov + i in
    declaration order, unknowns hash into [0, num_oov)."""

    name: str
    vocab: Tuple[Any, ...]
    max_len: int
    num_oov: int = 1
    delimiter: str = "|"
    source: Optional[Source] = None

    size = property(lambda self: len(self.vocab) + self.num_oov)
    src = property(lambda self: self.name if self.source is None else self.source)

    @property
    def strings(self) -> bool:
        return bool(self.vocab) and isinstance(self.vocab[0], (str, bytes))

    def _table(self) -> "pp.StringLookup":
        """The instance's StringLookup, built once (a frozen dataclass, so
        cached through object.__setattr__)."""
        t = getattr(self, "_cached_table", None)
        if t is None:
            t = pp.StringLookup(
                [v if isinstance(v, str) else v.decode("utf-8")
                 for v in self.vocab], self.num_oov)
            object.__setattr__(self, "_cached_table", t)
        return t

    def elem_ids(self, elems) -> np.ndarray:
        if not len(elems):
            return np.empty((0,), np.int32)
        if self.strings:
            return self._table()(list(elems))
        return _np_int_lookup(
            np.asarray(list(elems)).astype(np.int32), self.vocab, self.num_oov)


BagFeature = Union[HashedBag, LookupBag]
FeatureDef = Union[Numeric, Bucketized, Hashed, Lookup, HashedBag, LookupBag]
_BAGS = (HashedBag, LookupBag)
FEATURE_KINDS = (Numeric, Bucketized, Hashed, Lookup, HashedBag, LookupBag)


def numeric(name: str, *, standardize: Optional[Tuple[float, float]] = None,
            log1p: bool = False, source: Optional[Source] = None) -> Numeric:
    if standardize is not None and log1p:
        raise ValueError("choose standardize OR log1p, not both")
    t = ("standard", *standardize) if standardize is not None else (
        "log1p" if log1p else None)
    return Numeric(name, t, source)


def bucketized(name: str, boundaries: Sequence[float], *,
               source: Optional[Source] = None) -> Bucketized:
    return Bucketized(name, tuple(float(b) for b in boundaries), source)


def hashed(name: str, num_bins: int, *, strings: bool = False,
           source: Optional[Source] = None) -> Hashed:
    return Hashed(name, int(num_bins), strings, source)


def lookup(name: str, vocab: Sequence[Any], *, num_oov: int = 1,
           source: Optional[Source] = None) -> Lookup:
    return Lookup(name, tuple(vocab), int(num_oov), source)


def hashed_bag(name: str, num_bins: int, max_len: int, *,
               strings: bool = False, delimiter: str = "|",
               source: Optional[Source] = None) -> HashedBag:
    return HashedBag(name, int(num_bins), int(max_len), strings, delimiter,
                     source)


def lookup_bag(name: str, vocab: Sequence[Any], max_len: int, *,
               num_oov: int = 1, delimiter: str = "|",
               source: Optional[Source] = None) -> LookupBag:
    return LookupBag(name, tuple(vocab), int(max_len), int(num_oov),
                     delimiter, source)


def _np_hash_bucket(ids, num_bins: int) -> np.ndarray:
    """Numpy twin of `pp.hash_bucket` (bit-identical)."""
    x = np.asarray(ids).astype(np.uint32)
    x = x ^ (x >> np.uint32(16))
    x = (x * np.uint32(0x85EBCA6B)).astype(np.uint32)
    x = x ^ (x >> np.uint32(13))
    x = (x * np.uint32(0xC2B2AE35)).astype(np.uint32)
    x = x ^ (x >> np.uint32(16))
    return (x % np.uint32(num_bins)).astype(np.int32)


def _np_int_lookup(values, vocab, num_oov: int) -> np.ndarray:
    """Numpy twin of `pp.int_lookup`."""
    v = np.asarray(vocab, np.int32)
    order = np.argsort(v, kind="stable")
    sv, decl_idx = v[order], order.astype(np.int32)
    x = np.asarray(values, np.int32)
    pos = np.searchsorted(sv, x)
    pos_c = np.clip(pos, 0, len(v) - 1)
    found = sv[pos_c] == x
    oov = (_np_hash_bucket(x, num_oov) if num_oov > 0
           else np.zeros_like(pos_c, np.int32))
    return np.where(found, decl_idx[pos_c] + num_oov, oov)


def _host_resolved(f: FeatureDef) -> bool:
    """A categorical the host half turns into final ids."""
    return isinstance(f, (Hashed, Lookup)) and f.strings


class FeatureSpec:
    """An ordered feature list compiled into (host, device) transforms.

    Output contract:
      {"dense": (B, dense_dim) float32,
       "cat":   (B, cat_dim)   int32 in ONE shared id space of
                `total_vocab` rows (per-feature offsets applied),
       "bags":  {name: (B, max_len) int32, pad -1}, only when bag
                features are declared, each in its own id space}
    """

    def __init__(self, features: Sequence[FeatureDef]):
        if not features:
            raise ValueError("FeatureSpec needs at least one feature")
        names = [f.name for f in features]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate feature names in {names}")
        for f in features:
            if not isinstance(f, FEATURE_KINDS):
                raise TypeError(
                    f"feature {f!r} is not one of the port's feature kinds "
                    f"({', '.join(k.__name__ for k in FEATURE_KINDS)}): "
                    "declare it with the ported constructors")
        self.features = tuple(features)
        self.dense_features = tuple(
            f for f in features if isinstance(f, Numeric))
        self.bag_features = tuple(f for f in features if isinstance(f, _BAGS))
        self.cat_features = tuple(
            f for f in features if not isinstance(f, (Numeric,) + _BAGS))
        self.dense_dim = len(self.dense_features)
        self.cat_dim = len(self.cat_features)
        self.offsets: Dict[str, int] = {}
        off = 0
        for f in self.cat_features:
            self.offsets[f.name] = off
            off += f.size
        self.total_vocab = off
        self._host_lookups = {
            f.name: pp.StringLookup(
                [v if isinstance(v, str) else v.decode("utf-8")
                 for v in f.vocab], f.num_oov)
            for f in self.cat_features
            if isinstance(f, Lookup) and f.strings
        }

    @staticmethod
    def _resolve_bag(f: BagFeature, x) -> np.ndarray:
        """Ragged column -> (B, max_len) padded ids. Rows may be sequences,
        delimiter-joined strings or bare scalars (a one-element bag);
        None, NaN or empty -> an all-pad row."""
        rows = []
        for r in np.asarray(x, dtype=object).reshape(-1):
            if r is None or (isinstance(r, (float, np.floating))
                             and np.isnan(r)):
                elems = []
            elif isinstance(r, (str, bytes)):
                s = r.decode("utf-8") if isinstance(r, bytes) else r
                elems = [e.strip() for e in s.split(f.delimiter) if e.strip()]
            elif np.isscalar(r):
                elems = [r]
            else:
                elems = list(r)
            rows.append(f.elem_ids(elems))
        return pp.pad_to_dense(rows, f.max_len)

    # ------------------------------------------------------------------ #
    # host half

    def host_transform(self, cols: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """Resolve what only the host can: string hashes and string
        lookups become final ids in [0, size), bags padded rows; every
        other feature passes through raw under its feature name. The
        output feeds `device_transform`."""
        out: Dict[str, np.ndarray] = {}
        for f in self.features:
            x = _col(cols, f.src)
            if isinstance(f, _BAGS):
                out[f.name] = self._resolve_bag(f, x)
            elif isinstance(f, Hashed) and f.strings:
                out[f.name] = pp.hash_strings(x, f.num_bins)
            elif isinstance(f, Lookup) and f.strings:
                out[f.name] = self._host_lookups[f.name](x)
            elif isinstance(f, (Numeric, Bucketized)):
                out[f.name] = np.asarray(x, np.float32)
            else:
                out[f.name] = np.asarray(x, np.int32)
        return out

    # ------------------------------------------------------------------ #
    # device half

    def device_transform(
        self, inter: Dict[str, torch.Tensor]
    ) -> Dict[str, torch.Tensor]:
        """Columns -> {"dense", "cat"} (+ "bags") on the columns' device.

        `inter` is keyed by feature name (host_transform's output, as
        tensors) OR by raw source columns, so a model whose inputs are
        packed arrays (Criteo "dense"/"cat") applies the whole spec inside
        its forward."""

        def col(f):
            return inter[f.name] if f.name in inter else _col(inter, f.src)

        dense = [f.apply(col(f)) for f in self.dense_features]
        cat = []
        for f in self.cat_features:
            if _host_resolved(f) and f.name not in inter:
                raise ValueError(
                    f"string feature {f.name!r} needs host_transform "
                    "before device_transform")
            x = col(f)
            if isinstance(f, Bucketized):
                ids = f.apply(x)
            elif isinstance(f, Hashed) and not f.strings:
                ids = pp.hash_bucket(x, f.num_bins)
            elif isinstance(f, Lookup) and not f.strings:
                ids = pp.int_lookup(x, f.vocab, f.num_oov)
            else:   # host-resolved string feature: already final ids
                ids = x.to(torch.int32)
            cat.append(ids + self.offsets[f.name])
        out = {}
        if dense:
            out["dense"] = torch.stack(dense, dim=-1)
        if cat:
            out["cat"] = torch.stack(cat, dim=-1).to(torch.int32)
        if self.bag_features:
            for f in self.bag_features:
                if f.name not in inter:
                    raise ValueError(
                        f"bag feature {f.name!r} needs host_transform "
                        "before device_transform")
            out["bags"] = {f.name: inter[f.name].to(torch.int32)
                           for f in self.bag_features}
        return out

    # ------------------------------------------------------------------ #
    # numpy composition (per-record parsers, host-only pipelines, tests)

    def transform(self, cols: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """host_transform, then the device half in numpy: the same ids as
        `device_transform`, bit for bit."""
        inter = self.host_transform(cols)
        dense = [f.apply_np(inter[f.name]) for f in self.dense_features]
        cat = []
        for f in self.cat_features:
            x = inter[f.name]
            if isinstance(f, Bucketized):
                ids = f.apply_np(x)
            elif isinstance(f, Hashed) and not f.strings:
                ids = _np_hash_bucket(x, f.num_bins)
            elif isinstance(f, Lookup) and not f.strings:
                ids = _np_int_lookup(x, f.vocab, f.num_oov)
            else:
                ids = np.asarray(x, np.int32)
            cat.append(ids + np.int32(self.offsets[f.name]))
        out: Dict[str, np.ndarray] = {}
        if dense:
            out["dense"] = np.stack(dense, axis=-1).astype(np.float32)
        if cat:
            out["cat"] = np.stack(cat, axis=-1).astype(np.int32)
        if self.bag_features:
            out["bags"] = {f.name: inter[f.name] for f in self.bag_features}
        return out

    def transform_row(self, row: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """One record (a dict of scalars; bag cells may be lists or
        delimiter-joined strings; a packed source takes the whole row
        sequence) -> {"dense": (n,), "cat": (m,)} (+ "bags":
        {name: (max_len,)})."""
        bag_srcs = {f.src for f in self.bag_features
                    if isinstance(f.src, str)}

        def one(k, v):
            if k in bag_srcs:
                # a one-slot object array keeps a list or string bag cell
                # whole (np.asarray([list]) would make it a 2-D row)
                a = np.empty((1,), dtype=object)
                a[0] = v
                return a
            return np.asarray([v])

        out = self.transform({k: one(k, v) for k, v in row.items()})
        return {
            k: ({n: b[0] for n, b in v.items()} if k == "bags" else v[0])
            for k, v in out.items()
        }

    # ------------------------------------------------------------------ #
    # CSV: spec + column order -> the reader's parse function

    def csv_parser(
        self,
        columns: Sequence[str],
        label_fn: Callable[[Dict[str, str]], Any],
        delimiter: str = ",",
    ):
        """parse(record: bytes) -> (features, label) for CSV readers: the
        row's cells by `columns`, strings for host-resolved features and
        bags, floats (empty -> 0) for the rest."""
        columns = tuple(columns)

        def parse(record: bytes):
            parts = [p.strip() for p in
                     record.decode("utf-8").rstrip("\n").split(delimiter)]
            row = dict(zip(columns, parts))
            typed: Dict[str, Any] = {}
            for f in self.features:
                src = f.src
                if isinstance(src, tuple):
                    raise ValueError(
                        "csv_parser needs named-column sources; "
                        f"{f.name} reads {src}")
                raw = row.get(src, "")
                needs_string = isinstance(f, _BAGS) or _host_resolved(f)
                typed[src] = raw if needs_string else float(raw or 0)
            return self.transform_row(typed), label_fn(row)

        return parse
