"""The program cache: the trainer's step programs and the embedding
tier's programs, keyed by program identity.

Counterpart of `elasticdl_tpu/training/compile_cache.py`. There, an entry
is a jitted callable or an AOT executable, and a hit is a resize that did
not re-trace. Here an entry is one of:
- a trainer's step program (`training/step_graph.Program`): the step's
  body, which on the card captures a CUDA graph for each state and batch
  signature it is called with, and on the CPU runs eagerly;
- an ahead-of-time entry (`store_aot`, under the program's key and a
  batch signature): the step program again, whose graph for that
  signature `aot_compile_*` captured ahead of the first step; the entry
  counts as the reference's executable does;
- the tier store's pull and push programs and the tier session's gradient
  function (built callables).

Hits and misses count as the reference's do: a trainer rebuilt in this
process at the same shape finds its programs already built, and a shard
that migrates onto a new owner finds its programs too (the reference's
"no new compiles during recovery" check reads `stats()["misses"]`). A
graph is bound to the memory of the state it was captured over, so a hit
by a trainer over another state captures that state's graph inside the
program it found, as the reference's jitted callable re-traces for a new
shape without a counted miss.

`job_cache_token`, `instance_token`, `mesh_fingerprint` (over the port's
`parallel.mesh.Mesh`) and `aval_signature` (over tensors and ndarrays:
shape, dtype and device) keep the reference's meaning.

Not ported, by design: `SpeculativeCompiler`, the neighbour-world
precompiler of the in-place rescale. A CUDA graph is bound to the memory
of a world this process runs, and an NCCL step's graph to that world's
communicator, so a neighbour world size cannot be captured before that
world exists; the port's rescale re-forms a cohort (ROADMAP items 32 and
19, under "Differences of design"). `SpeculativeCompiler` raises
`NotImplementedError`.
"""

from __future__ import annotations

import itertools
import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Tuple

from elasticdl_tpu_torch.common.log_utils import default_logger
from elasticdl_tpu_torch.observability.registry import default_registry

logger = default_logger(__name__)

_instance_tokens = itertools.count()

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


def instance_token() -> str:
    """Fallback token for trainers built outside a job config: unique per
    call, so entries are private to that trainer."""
    return f"~instance-{next(_instance_tokens)}"


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
    """Thread-safe LRU of built programs.

    Two entry classes share the store, as in the reference:
    - step programs and built callables (`get_or_build`): counted, a hit
      is a program found already built; `stats()["hit_rate"]`;
    - ahead-of-time entries (`store_aot` / `peek`): uncounted lookups
      (they sit beside a program that was counted once), tallied only as
      `speculative_compiles` when marked so.
    """

    def __init__(self, max_entries: int = DEFAULT_MAX_ENTRIES):
        self.max_entries = max(1, int(max_entries))
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Tuple, Any]" = OrderedDict()  # guarded_by: _lock
        self._hits = 0          # guarded_by: _lock
        self._misses = 0        # guarded_by: _lock
        self._speculative = 0   # guarded_by: _lock
        # bumped on every store_aot, as in the reference
        self._aot_generation = 0  # guarded_by: _lock

    def get_or_build(self, key: Tuple, build: Callable[[], Any], *,
                     speculative: bool = False) -> Any:
        """Return the cached value for `key`, building (outside the lock)
        on a miss. A lost build race keeps the first value.
        `speculative=True` marks an ahead-of-time build: a hit is not
        counted, and an insert counts as speculative, not as a miss."""
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                if not speculative:
                    self._hits += 1
                return self._entries[key]
        value = build()
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                return self._entries[key]
            self._entries[key] = value
            if speculative:
                self._speculative += 1
            else:
                self._misses += 1
            self._evict()
            return value

    def _evict(self) -> None:  # holds: _lock
        while len(self._entries) > self.max_entries:
            evicted, _ = self._entries.popitem(last=False)
            logger.info("compile cache evicted %r (LRU)", evicted[:2])

    def peek(self, key: Tuple) -> Optional[Any]:
        """Uncounted lookup; refreshes LRU position on a find."""
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                return self._entries[key]
            return None

    def store_aot(self, key: Tuple, value: Any, *,
                  speculative: bool = False) -> Any:
        """Insert an ahead-of-time program; the first writer wins."""
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                return self._entries[key]
            self._entries[key] = value
            self._aot_generation += 1
            if speculative:
                self._speculative += 1
            self._evict()
            return value

    @property
    def aot_generation(self) -> int:
        with self._lock:
            return self._aot_generation

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
                "speculative_compiles": self._speculative,
                "entries": len(self._entries),
                "hit_rate": (self._hits / lookups) if lookups else 0.0,
            }

    def reset_stats(self) -> None:
        with self._lock:
            self._hits = self._misses = self._speculative = 0

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._hits = self._misses = self._speculative = 0


_GLOBAL_CACHE = CompileCache()


def global_cache() -> CompileCache:
    """The process-wide cache the tier's stores and sessions share."""
    return _GLOBAL_CACHE


_reg = default_registry()
for _stat, _help in (
    ("hits", "program-cache hits (a program found already built)"),
    ("misses", "program-cache misses (programs built)"),
    ("speculative_compiles", "ahead-of-time programs built speculatively"),
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
            "in-place rescale) is not ported: a CUDA graph is bound to the "
            "memory of a world this process runs (and an NCCL step's to "
            "its communicator), so a neighbour world size cannot be "
            "captured before that world exists (ROADMAP item 19, under "
            "'Differences of design')")
