"""Feature preprocessing: a device half on tensors and a host half in
numpy.

Counterpart of `elasticdl_tpu/api/preprocessing.py`. The device half
(integer hashing, bucketization, normalization, integer lookup, the
id-space concatenation with offsets) runs on whatever device the batch
lives on. The host half (string hashing and lookups, ragged bags to
padded rows, fitting bucket boundaries, vocabulary files) runs in the
data pipeline.
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

_U32 = 0xFFFFFFFF


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) held in int64. The constant is
    split into 16-bit halves so no partial product passes 2^48: a full
    32x32-bit product can pass 2^63, and int64 overflow is not a
    wraparound torch promises on every device."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _U32


def hash_bucket(ids: torch.Tensor, num_bins: int) -> torch.Tensor:
    """Deterministic integer hash -> int32 in [0, num_bins): the murmur3
    32-bit finalizer, bit-equal to the reference's uint32 `hash_bucket`.
    Runs in int64 with an explicit 32-bit mask, since torch has no uint32
    arithmetic on every device; negative int32 ids take their two's
    complement value, as the reference's cast to uint32 does."""
    x = ids.to(torch.int64) & _U32
    x = x ^ (x >> 16)
    x = _mul_u32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul_u32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return (x % int(num_bins)).to(torch.int32)


def bucketize(values: torch.Tensor, boundaries: Sequence[float]) -> torch.Tensor:
    """Discretization: continuous -> bucket id in [0, len(boundaries)]."""
    v = values.to(torch.float32)
    b = torch.as_tensor(
        np.asarray(boundaries, np.float32), device=v.device)
    return torch.bucketize(v, b, right=True).to(torch.int32)


def normalize(values: torch.Tensor, mean, std) -> torch.Tensor:
    """Standard-score normalization with fixed statistics."""
    return (values.to(torch.float32) - mean) / max(float(std), 1e-12)


def log_normalize(values: torch.Tensor) -> torch.Tensor:
    """log(1+x) squashing of max(x, 0) — the Criteo dense transform."""
    return torch.log1p(torch.clamp_min(values.to(torch.float32), 0.0))


def concat_with_offset(id_groups: Sequence[torch.Tensor],
                       sizes: Sequence[int]) -> torch.Tensor:
    """Concatenate per-feature id spaces into one shared table's id space:
    feature f's ids shift by sum(sizes[:f]); negative (padding) ids stay
    negative. Returns int32 ids shaped (B, sum of the groups' widths)."""
    if len(id_groups) != len(sizes):
        raise ValueError("id_groups and sizes must align")
    out = []
    offset = 0
    for ids, size in zip(id_groups, sizes):
        ids = ids.to(torch.int32)
        out.append(torch.where(ids >= 0, ids + offset, ids))
        offset += int(size)
    return torch.cat([o.reshape(o.shape[0], -1) for o in out], dim=-1)


def int_lookup(values: torch.Tensor, vocab: Sequence[int],
               num_oov: int = 1) -> torch.Tensor:
    """Lookup over a static integer vocabulary: vocab[i] -> num_oov + i in
    declaration order; every other value hashes into [0, num_oov) (0 when
    num_oov is 0). The search runs over a sorted copy, with the position
    -> declaration-index permutation applied after."""
    v = np.asarray(vocab, np.int32)
    order = np.argsort(v, kind="stable")
    x = values.to(torch.int32)
    sorted_vocab = torch.as_tensor(v[order], device=x.device)
    decl_idx = torch.as_tensor(order.astype(np.int32), device=x.device)
    pos = torch.searchsorted(sorted_vocab, x)
    pos_c = torch.clamp(pos, 0, len(v) - 1)
    found = sorted_vocab[pos_c] == x
    oov = (hash_bucket(x, num_oov) if num_oov > 0
           else torch.zeros_like(x))
    return torch.where(found, decl_idx[pos_c] + num_oov, oov).to(torch.int32)


# ---------------------------------------------------------------------- #
# Host side (numpy, in the data pipeline)


def hash_strings(values, num_bins: int) -> np.ndarray:
    """Deterministic string -> bucket hashing: crc32 of the UTF-8 bytes,
    stable across processes (unlike Python's salted `hash`)."""
    flat = np.asarray(values).reshape(-1)
    out = np.empty(flat.shape[0], np.int32)
    for i, s in enumerate(flat):
        b = s if isinstance(s, bytes) else str(s).encode("utf-8")
        out[i] = zlib.crc32(b) % num_bins
    return out.reshape(np.asarray(values).shape)


class StringLookup:
    """Lookup over a string vocabulary: vocab[i] -> num_oov + i; unknown
    strings hash (crc32) into [0, num_oov)."""

    def __init__(self, vocab: Sequence[str], num_oov: int = 1):
        self.num_oov = num_oov
        self.table: Dict[str, int] = {
            (v if isinstance(v, str) else v.decode("utf-8")): i + num_oov
            for i, v in enumerate(vocab)
        }
        self.vocab_size = len(self.table) + num_oov

    def __call__(self, values) -> np.ndarray:
        flat = np.asarray(values).reshape(-1)
        out = np.empty(flat.shape[0], np.int32)
        for i, s in enumerate(flat):
            key = s.decode("utf-8") if isinstance(s, bytes) else str(s)
            hit = self.table.get(key)
            if hit is None:
                hit = (zlib.crc32(key.encode("utf-8")) % self.num_oov
                       if self.num_oov > 0 else 0)
            out[i] = hit
        return out.reshape(np.asarray(values).shape)


def pad_to_dense(rows: List[Sequence[int]], max_len: int,
                 pad_value: int = -1) -> np.ndarray:
    """Ragged id lists -> (N, max_len) int32, cut at max_len and padded
    with `pad_value` (negative ids are padding to `Embedding`'s
    combiners)."""
    out = np.full((len(rows), max_len), pad_value, np.int32)
    for i, r in enumerate(rows):
        r = list(r)[:max_len]
        out[i, : len(r)] = r
    return out


def fit_discretization(values, num_bins: int) -> np.ndarray:
    """num_bins - 1 quantile boundaries splitting `values` into buckets of
    near-equal mass, for `bucketize`: float32, deduplicated after the
    cast (quantiles distinct in float64 can collapse in float32). Empty
    when there are no finite values or fewer than 2 bins."""
    flat = np.asarray(values, np.float64).reshape(-1)
    flat = flat[np.isfinite(flat)]
    if flat.size == 0 or num_bins < 2:
        return np.zeros((0,), np.float32)
    qs = np.linspace(0.0, 1.0, num_bins + 1)[1:-1]
    return np.unique(np.quantile(flat, qs).astype(np.float32))


def vocab_from_file(path: str, *, max_size: Optional[int] = None) -> List[str]:
    """A one-token-per-line vocabulary file -> the ordered token list:
    blank lines skipped, duplicates keep their first occurrence, at most
    `max_size` tokens."""
    seen: Dict[str, None] = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            tok = line.rstrip("\n")
            if not tok or tok in seen:
                continue
            seen[tok] = None
            if max_size is not None and len(seen) >= max_size:
                break
    return list(seen)
