"""Device-side feature preprocessing on tensors.

Counterpart of the device half of `elasticdl_tpu/api/preprocessing.py`:
integer hashing, bucketization and normalization, run on whatever device
the batch lives on. The host half (string hashing and lookups) joins with
the data path.
"""

from __future__ import annotations

from typing import Sequence

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
