"""The program cache the embedding tier keys its programs through.

Counterpart of `elasticdl_tpu/training/compile_cache.py`. There, a cache
entry is a jitted callable or an AOT executable, and a hit is a resize
that did not re-trace. PyTorch runs eagerly and compiles nothing here, so
an entry is the built callable itself (the tier store's pull and push
programs, the tier session's gradient function). Hits and misses still
count: a shard that migrates onto a new owner in this process finds its
programs already built, and the count is what shows it (the reference's
"no new compiles during recovery" check reads `stats()["misses"]`).

`job_cache_token`, `mesh_fingerprint` (over the port's
`parallel.mesh.Mesh`) and `aval_signature` (over tensors and ndarrays:
shape, dtype and device) keep the reference's meaning.

Not ported, by design: `SpeculativeCompiler`, the neighbor-world
precompiler of the in-place rescale, and the AOT entries it stores
(`store_aot`). The port has no compiled program to warm until a step is
captured as a CUDA graph, and its rescale re-forms a cohort (ROADMAP items
32 and 19, under "Differences of design"); `SpeculativeCompiler` raises
`NotImplementedError`.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Tuple

from elasticdl_tpu_torch.common.log_utils import default_logger
from elasticdl_tpu_torch.observability.registry import default_registry

logger = default_logger(__name__)

#: default LRU capacity; an evicted entry is rebuilt on next use
DEFAULT_MAX_ENTRIES = 128


def job_cache_token(cfg) -> str:
    """Program-identity token from a JobConfig: every field that changes
    the program, nothing world- or membership-scoped."""
    return "|".join(
        str(part)
        for part in (
            cfg.model_zoo,
            cfg.model_def,
            sorted(cfg.model_params.items()),
            cfg.loss,
            cfg.optimizer,
            cfg.eval_metrics_fn,
            cfg.param_dtype,
            cfg.compute_dtype,
        )
    )


def mesh_fingerprint(mesh) -> Tuple:
    """World-version-independent mesh identity: axis layout plus the
    world ranks in mesh order (a `parallel.mesh.Mesh`; None for no mesh,
    which is one device)."""
    if mesh is None:
        return ((), (), ())
    return (
        tuple(str(a) for a in mesh.axis_names),
        tuple(int(s) for s in mesh.shape.values()),
        tuple(int(r) for r in mesh.ranks),
    )


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif hasattr(tree, "shape") and hasattr(tree, "dtype"):
        yield tree


def aval_signature(tree: Any) -> Tuple:
    """Hashable (shape, dtype, device) signature of the tensor and ndarray
    leaves of nested dicts, lists and tuples (an ndarray's device is
    "cpu")."""
    return tuple(
        (tuple(leaf.shape), str(leaf.dtype),
         str(getattr(leaf, "device", "cpu")))
        for leaf in _leaves(tree)
    )


class CompileCache:
    """Thread-safe LRU of built programs: `get_or_build` counts a hit or a
    miss, `peek` and `contains` look up without counting."""

    def __init__(self, max_entries: int = DEFAULT_MAX_ENTRIES):
        self.max_entries = max(1, int(max_entries))
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Tuple, Any]" = OrderedDict()  # guarded_by: _lock
        self._hits = 0          # guarded_by: _lock
        self._misses = 0        # guarded_by: _lock

    def get_or_build(self, key: Tuple, build: Callable[[], Any]) -> Any:
        """Return the cached value for `key`, building (outside the lock)
        on a miss. A lost build race keeps the first value."""
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                self._hits += 1
                return self._entries[key]
        value = build()
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                return self._entries[key]
            self._entries[key] = value
            self._misses += 1
            while len(self._entries) > self.max_entries:
                evicted, _ = self._entries.popitem(last=False)
                logger.info("compile cache evicted %r (LRU)", evicted[:2])
            return value

    def peek(self, key: Tuple) -> Optional[Any]:
        """Uncounted lookup; refreshes LRU position on a find."""
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                return self._entries[key]
            return None

    def contains(self, key: Tuple) -> bool:
        """Whether `key` has an entry; uncounted, the LRU order kept."""
        with self._lock:
            return key in self._entries

    def stats(self) -> Dict[str, float]:
        with self._lock:
            lookups = self._hits + self._misses
            return {
                "hits": self._hits,
                "misses": self._misses,
                "entries": len(self._entries),
                "hit_rate": (self._hits / lookups) if lookups else 0.0,
            }

    def reset_stats(self) -> None:
        with self._lock:
            self._hits = self._misses = 0

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._hits = self._misses = 0


_GLOBAL_CACHE = CompileCache()


def global_cache() -> CompileCache:
    """The process-wide cache the tier's stores and sessions share."""
    return _GLOBAL_CACHE


_reg = default_registry()
for _stat, _help in (
    ("hits", "program-cache hits (a program found already built)"),
    ("misses", "program-cache misses (programs built)"),
    ("entries", "live cache entries"),
    ("hit_rate", "hits / (hits + misses)"),
):
    _reg.gauge(
        f"edl_compile_cache_{_stat}", _help
    ).set_fn(lambda s=_stat: _GLOBAL_CACHE.stats()[s])


class SpeculativeCompiler:
    """Neighbor-world precompilation for the in-place rescale."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "SpeculativeCompiler (neighbor-world precompilation for the "
            "in-place rescale) is not ported: the port has no compiled "
            "program to warm until a step is captured as a CUDA graph "
            "(ROADMAP item 19, under 'Differences of design')")
