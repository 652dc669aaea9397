"""Turn leased tasks into fixed-shape device batches.

Reference parity: elasticdl/python/worker/task_data_service.py — converts the
task stream into a continuous data pipeline and attributes records to tasks
so completion is reported exactly when a task's records are consumed. Here a
task is processed as a unit (batches of one task never mix with another's),
which keeps exactly-once accounting trivial; the last partial batch is padded
to static shape with mask=0 rows because XLA recompiles on shape changes.

Pipeline design (round 3; SURVEY §7 hard-part 4): records move in batch-sized
spans, not one at a time. Each span is fetched with the reader's `read_span`
(one contiguous read + vectorized split for file-backed readers) and parsed
with a batch parser (data/parsing.py; C++ kernels that release the GIL). A
small thread pool parses up to `lookahead` spans ahead of the consumer —
order-preserving, so task accounting and determinism are unchanged. With the
GIL released inside the native parse, parser threads scale across cores the
way the reference's tf.data C++ op kernels did.
"""

from __future__ import annotations

import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, Optional

import numpy as np

from elasticdl_tpu_torch.data import parsing
from elasticdl_tpu_torch.data.reader import AbstractDataReader


def _pad_batch(feats, labels, count: int, batch_size: int):
    """Pad a short batch to `batch_size` by repeating row 0, mask marks real
    rows. Keeps every compiled step shape static."""

    def pad(x):
        if isinstance(x, dict):
            return {k: pad(v) for k, v in x.items()}
        reps = np.repeat(x[:1], batch_size - count, axis=0)
        return np.concatenate([x, reps], axis=0)

    mask = np.zeros((batch_size,), np.float32)
    mask[:count] = 1.0
    return pad(feats), pad(labels), mask


class TaskDataService:
    def __init__(
        self,
        reader: AbstractDataReader,
        parse_fn,
        batch_size: int,
        batch_multiple: int = 1,
        num_parallel: int = 0,
    ):
        self._reader = reader
        # Per-record parsers are upgraded to the batch interface; batch
        # parsers (parsing.is_batch_parser) are used as-is.
        self._parse_batch = parsing.as_batch_parser(parse_fn)
        # batch must stay divisible by the mesh's data-axis size
        self._batch_size = max(batch_size, batch_multiple)
        if self._batch_size % batch_multiple:
            self._batch_size += batch_multiple - self._batch_size % batch_multiple
        if num_parallel <= 0:
            num_parallel = min(4, os.cpu_count() or 1)
        if not getattr(reader, "THREAD_SAFE_SPANS", False):
            # stateful readers (RecordIO's shared per-shard handles + LRU)
            # must not serve concurrent span reads — parse serially for them
            num_parallel = 1
        self._num_parallel = num_parallel
        self._pool: Optional[ThreadPoolExecutor] = None

    @property
    def batch_size(self) -> int:
        return self._batch_size

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    def _make_batch(self, shard_name: str, start: int, end: int) -> Dict[str, Any]:
        records = None
        if getattr(self._parse_batch, "accepts_blob", False):
            # fixed-width fast path: one contiguous read, no record splitting
            records = self._reader.read_block(shard_name, start, end)
        if records is None:
            records = self._reader.read_span(shard_name, start, end)
        feats, labels = self._parse_batch(records)
        count = len(labels)
        if count == self._batch_size:
            mask = np.ones((self._batch_size,), np.float32)
        else:
            feats, labels, mask = _pad_batch(feats, labels, count, self._batch_size)
        return {"features": feats, "labels": labels, "mask": mask}

    def batches(
        self, shard_name: str, start: int, end: int
    ) -> Iterator[Dict[str, Any]]:
        spans = [
            (s, min(s + self._batch_size, end))
            for s in range(start, end, self._batch_size)
        ]
        if self._num_parallel <= 1 or len(spans) <= 1:
            for s, e in spans:
                yield self._make_batch(shard_name, s, e)
            return
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self._num_parallel,
                thread_name_prefix="edl-parse",
            )
        # Bounded in-flight window, yielded in submission order: lookahead
        # overlaps read+parse of the next spans with the consumer's step, and
        # bounding it caps host memory at ~window batches.
        lookahead = self._num_parallel + 1
        inflight: deque = deque()
        it = iter(spans)
        try:
            for s, e in it:
                inflight.append(self._pool.submit(self._make_batch, shard_name, s, e))
                if len(inflight) >= lookahead:
                    yield inflight.popleft().result()
            while inflight:
                yield inflight.popleft().result()
        finally:
            # Consumer abandoned the generator (task drained/worker exiting):
            # drop queued work so the pool doesn't parse spans nobody reads.
            for fut in inflight:
                fut.cancel()
