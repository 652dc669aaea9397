"""Async host→device batch prefetching with optional wire compression.

Counterpart of `elasticdl_tpu/data/prefetch.py`. The reference relies on
JAX's async `device_put`; here the lookahead is explicit CUDA streams:
each host batch is staged in pinned host memory and copied to the card
with `non_blocking=True` on a side stream, so up to `depth` copies ride
behind the step running on the compute stream. Before a batch is handed
to the consumer, the compute stream waits for that batch's copy (an
event recorded on the side stream right after it), and every tensor of
the batch is `record_stream`-ed on the compute stream: the tensors were
allocated on the side stream, and without that record the caching
allocator could hand their memory to the next copy while the step still
reads it. On the CPU (`device="cpu"`) the prefetcher is a plain lookahead
queue of tensors that share the numpy batches' memory.

Wire compression (`cast="bfloat16"`): float32/float64 leaves are cast to
bfloat16 on the host before the copy, halving the float bytes on the
wire. The "mask" leaf stays float32: the worker sums it for record
accounting.

Elasticity: each pending slot keeps the HOST batch beside the device
batch, and `drain()` hands the pending host batches back, so a caller
that must drop the lookahead (a re-formation) requeues them instead of
losing them from the task's span.

`depth` and `cast` resolve from the environment when not given:
`EDL_PREFETCH_DEPTH` (default 2) and `EDL_PREFETCH_CAST` (default "").
The prefetcher attributes its time to the step profiler's `data_wait`
(blocking on the reader/parser) and `h2d` (cast, staging and issuing the
copy) phases (`observability/profile.py`).
"""

from __future__ import annotations

import os
import time
from collections import deque
from typing import Any, Iterable, Iterator, List, Optional

import numpy as np
import torch

from elasticdl_tpu_torch.common import runtime
from elasticdl_tpu_torch.observability import profile as profile_lib
from elasticdl_tpu_torch.observability import tracing
from elasticdl_tpu_torch.observability.registry import default_registry

DEFAULT_DEPTH = 2

_reg = default_registry()
_PF_BATCHES = _reg.counter(
    "edl_prefetch_batches_total", "device batches served to the step loop")
_PF_DRAINS = _reg.counter(
    "edl_prefetch_drains_total", "drain() calls (reform/rescale requeues)")
_PF_DRAINED_BATCHES = _reg.counter(
    "edl_prefetch_drained_batches_total",
    "pending host batches handed back by drains")
_PF_DEPTH = _reg.gauge(
    "edl_prefetch_depth", "configured lookahead of the latest prefetcher")


def resolve_depth(depth: Optional[int]) -> int:
    """None -> EDL_PREFETCH_DEPTH -> default; explicit values win."""
    if depth is not None:
        return int(depth)
    try:
        return int(os.environ.get("EDL_PREFETCH_DEPTH", DEFAULT_DEPTH))
    except ValueError:
        return DEFAULT_DEPTH


def resolve_cast(cast: Optional[str]) -> str:
    """None -> EDL_PREFETCH_CAST -> no cast; explicit values win."""
    if cast is not None:
        return cast
    return os.environ.get("EDL_PREFETCH_CAST", "")


def tree_map(fn, tree):
    """`fn` over the leaves of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> List[Any]:
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def _as_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def _wire_cast(batch: Any, cast: str) -> Any:
    """Every leaf as a host tensor; float32/float64 leaves in `cast`
    except "mask" (bfloat16 addition is exact only up to 256, so a cast
    mask would corrupt the record count of the exactly-once protocol)."""
    wire = getattr(torch, cast) if cast else None

    def conv(x):
        t = _as_tensor(x)
        if wire is not None and t.dtype in (torch.float32, torch.float64):
            return t.to(wire)
        return t

    return {k: (tree_map(_as_tensor, v) if k == "mask" else
                tree_map(conv, v)) for k, v in batch.items()}


class DevicePrefetcher:
    """Iterator of device-resident batches keeping up to `depth` copies in
    flight ahead of the consumer, with an explicit `drain()`. depth<=0
    disables lookahead but still copies (and wire-casts) each batch.

    Each pending slot holds (host_batch, device_batch, copy event)."""

    def __init__(
        self,
        device: runtime.DeviceLike,
        batches: Iterable[Any],
        depth: Optional[int] = None,
        cast: Optional[str] = None,
    ):
        self.device = runtime.resolve_device(device)
        self.source: Iterator[Any] = iter(batches)
        self.depth = resolve_depth(depth)
        self.cast = resolve_cast(cast)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._buf: deque = deque()   # (host_batch, device_batch, event)
        self._exhausted = False
        self._drained = False
        _PF_DEPTH.set(self.depth)

    def _put(self, host_batch):
        """Cast, stage and issue the copy of one batch; returns (device
        batch, the event that marks its copy done, or None on the CPU)."""
        t0 = time.perf_counter()
        try:
            host = _wire_cast(host_batch, self.cast)
            if self._stream is None:
                return tree_map(lambda t: t.to(self.device), host), None
            with torch.cuda.stream(self._stream):
                dev = tree_map(
                    lambda t: t.pin_memory().to(self.device, non_blocking=True),
                    host)
                event = torch.cuda.Event()
                event.record(self._stream)
            return dev, event
        finally:
            profile_lib.get_profiler().add("h2d", time.perf_counter() - t0)

    def _ready(self, device_batch, event):
        """Hand a batch to the compute stream: wait for its copy, and
        record every tensor's use there for the caching allocator."""
        if event is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(event)
            for t in _leaves(device_batch):
                t.record_stream(compute)
        _PF_BATCHES.inc()
        return device_batch

    def _fill(self) -> None:
        prof = profile_lib.get_profiler()
        while not self._exhausted and len(self._buf) < max(1, self.depth):
            t0 = time.perf_counter()
            try:
                host = next(self.source)
            except StopIteration:
                self._exhausted = True
                return
            finally:
                # blocking on the reader/parse pipeline IS the data wait
                prof.add("data_wait", time.perf_counter() - t0)
            self._buf.append((host, *self._put(host)))

    def __iter__(self) -> "DevicePrefetcher":
        return self

    def __next__(self):
        if self._drained:
            raise StopIteration
        if self.depth <= 0:
            t0 = time.perf_counter()
            host = next(self.source)
            profile_lib.get_profiler().add(
                "data_wait", time.perf_counter() - t0)
            return self._ready(*self._put(host))
        self._fill()
        if not self._buf:
            raise StopIteration
        _, device_batch, event = self._buf.popleft()
        return self._ready(device_batch, event)

    def drain(self) -> List[Any]:
        """Invalidate the lookahead window: return the pending HOST batches
        (oldest first) and stop this prefetcher. The un-consumed source
        remains available as `self.source`."""
        with tracing.span("prefetch.drain") as sp:
            pending = [host for host, _, _ in self._buf]
            self._buf.clear()
            self._drained = True
            sp.set(pending_batches=len(pending))
        _PF_DRAINS.inc()
        _PF_DRAINED_BATCHES.inc(len(pending))
        return pending

    def close(self) -> None:
        """Release the source (generator-based sources stop cleanly)."""
        self._buf.clear()
        self._drained = True
        close = getattr(self.source, "close", None)
        if close is not None:
            close()


def prefetch_to_device(
    device: runtime.DeviceLike, batches: Iterable[Any],
    depth: Optional[int] = None, cast: Optional[str] = None,
) -> DevicePrefetcher:
    """Yield device-resident batches, keeping up to `depth` copies in
    flight ahead of the consumer (see DevicePrefetcher)."""
    return DevicePrefetcher(device, batches, depth=depth, cast=cast)
