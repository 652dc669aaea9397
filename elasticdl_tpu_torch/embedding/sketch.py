"""Space-Saving heavy-hitter sketch: bounded top-K over an id stream.

The embedding tier's whole economics ride the id distribution — the
bench's zipf(1.3) stream dedupes to 0.11 of its raw traffic, which means
a small head of hot ids absorbs most pulls. The hot-row cache and read
replicas (ROADMAP 1) need that skew MEASURED, not assumed: which ids are
hot, and what share of traffic they carry, at bounded memory.

This is Metwally et al.'s Space-Saving algorithm (the same structure the
Google ads training-infra paper's hot-id caching presupposes): k
counters; a hit increments its counter; a miss on a full sketch evicts
the minimum counter and inherits its count as the new entry's ERROR
bound. Guarantees, for any stream of total weight N:

- every id with true count > N/k is in the sketch;
- each tracked count overestimates by at most its recorded `error`
  (so `count - error` is a guaranteed lower bound on the true count).

`hot_share()` therefore reports a LOWER bound on the share of traffic
the top-K ids carry — the conservative number to size a cache from.

Implementation notes: updates are O(1) amortized via a lazy min-heap
(stale entries skipped at eviction, compacted when the heap outgrows
4x the sketch); `update_batch` takes the (unique ids, counts) arrays the
tier's pull path already computes, so the per-pull cost is one dict op
per UNIQUE id — off the jit path, and gated by `bench.py obs_overhead`.
Thread-safe under one leaf lock.
"""

from __future__ import annotations

import heapq
import threading
from typing import Dict, List, Tuple

#: default tracked heads — enough to cover the zipf head that matters
#: for caching, small enough that the sketch is a few KB
K_DEFAULT = 128


class SpaceSaving:
    """Bounded top-K counter sketch with guaranteed error bounds."""

    def __init__(self, k: int = K_DEFAULT):
        self.k = max(1, int(k))
        self._lock = threading.Lock()
        self._counts: Dict[int, int] = {}   # id -> count   guarded_by: _lock
        self._errors: Dict[int, int] = {}   # id -> error   guarded_by: _lock
        self._heap: List[Tuple[int, int]] = []  # (count, id) lazy min-heap
        self.total = 0                       # stream weight  guarded_by: _lock

    def __len__(self) -> int:
        with self._lock:
            return len(self._counts)

    # ------------------------------------------------------------------ #

    def update(self, key: int, inc: int = 1) -> None:
        if inc <= 0:
            return
        with self._lock:
            self._update_locked(int(key), int(inc))

    def update_batch(self, ids, counts=None) -> None:
        """Feed (unique) ids with optional per-id counts — the shapes the
        tier's `np.unique(..., return_counts=True)` already produces.
        `.tolist()` converts the whole array to native ints in C (a
        per-element int() would triple the loop's cost — this path runs
        once per pull and is gated by bench.py obs_overhead)."""
        if hasattr(ids, "tolist"):
            ids = ids.tolist()
        if counts is not None and hasattr(counts, "tolist"):
            counts = counts.tolist()
        with self._lock:
            # the HIT path is inlined: on a skewed stream most weight
            # lands on already-tracked heads, and a per-id method call
            # would dominate the loop (obs_overhead-gated)
            counts_d = self._counts
            total = 0
            if counts is None:
                for key in ids:
                    cur = counts_d.get(key)
                    if cur is not None:
                        counts_d[key] = cur + 1
                        total += 1
                    else:
                        self._update_locked(key, 1)
            else:
                for key, inc in zip(ids, counts):
                    if inc <= 0:
                        continue
                    cur = counts_d.get(key)
                    if cur is not None:
                        counts_d[key] = cur + inc
                        total += inc
                    else:
                        self._update_locked(key, inc)
            self.total += total

    def _update_locked(self, key: int, inc: int) -> None:
        """O(1) dict bump on a HIT (the common case on a skewed stream —
        the heap entry goes stale and now under-states the true count, a
        lower bound eviction repairs lazily); O(log k) on insert/evict.
        The heap never exceeds k entries: hits push nothing, inserts
        push one, evictions pop one and push one, refreshes are
        heapreplace (size-neutral)."""
        self.total += inc
        cur = self._counts.get(key)
        if cur is not None:
            self._counts[key] = cur + inc
        elif len(self._counts) < self.k:
            self._counts[key] = inc
            self._errors[key] = 0
            heapq.heappush(self._heap, (inc, key))
        else:
            # find the true minimum: every heap entry is a LOWER bound on
            # its key's current count, so a top entry matching its live
            # count IS the global min (all other keys' counts >= their
            # own heap entries >= this one)
            heap = self._heap
            while True:
                c, k2 = heap[0]
                live = self._counts.get(k2)
                if live == c:
                    break
                # stale bound: refresh in place and re-examine the top
                heapq.heapreplace(heap, (live, k2))
            heapq.heappop(heap)
            del self._counts[k2]
            del self._errors[k2]
            self._counts[key] = c + inc
            self._errors[key] = c
            heapq.heappush(heap, (c + inc, key))

    # ------------------------------------------------------------------ #

    def top(self, n: int = 0) -> List[Tuple[int, int, int]]:
        """[(id, count, error)] sorted by count descending; n=0 = all
        tracked. `count` overestimates by at most `error`."""
        with self._lock:
            items = sorted(
                ((i, c, self._errors[i]) for i, c in self._counts.items()),
                key=lambda t: (-t[1], t[0]),
            )
        return items[:n] if n else items

    def hot_share(self, n: int = 0) -> float:
        """Guaranteed LOWER bound on the share of stream weight carried
        by the top-n tracked ids (n=0 = all k): sum(count - error) /
        total. 0.0 on an empty stream."""
        with self._lock:
            if self.total <= 0:
                return 0.0
            guaranteed = sorted(
                (c - self._errors[i] for i, c in self._counts.items()),
                reverse=True,
            )
            take = guaranteed[:n] if n else guaranteed
            return max(0.0, min(1.0, sum(take) / self.total))

    def decay(self, factor: float) -> None:
        """Scale every tracked count (and error bound, and the stream
        total) by ``factor`` in [0, 1) — the exponential-decay variant a
        POPULARITY FLIP needs (ISSUE 20): a job-lifetime cumulative
        sketch lets yesterday's head dominate `hot_share` for hours
        after the distribution moved, and a layout controller chasing
        that ghost would replicate cold shards. Halving preserves both
        guarantees on the decayed stream: counts and errors scale
        together, so `count - error` stays a lower bound on the decayed
        true count, and the share ratio is scale-invariant. Entries
        decayed to zero are dropped (they carry no information and would
        pin heap slots)."""
        with self._lock:
            self._decay_locked(min(0.999, max(0.0, float(factor))))

    def _decay_locked(self, factor: float) -> None:  # holds: _lock
        dead = []
        for key, c in self._counts.items():
            nc = int(c * factor)
            if nc <= 0:
                dead.append(key)
            else:
                self._counts[key] = nc
                self._errors[key] = int(self._errors[key] * factor)
        for key in dead:
            del self._counts[key]
            del self._errors[key]
        # every heap bound went stale at once: rebuild instead of paying
        # k lazy repairs on the next k evictions
        self._heap = [(c, i) for i, c in self._counts.items()]
        heapq.heapify(self._heap)
        self.total = int(self.total * factor)

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()
            self._errors.clear()
            self._heap = []
            self.total = 0


class DecayingSpaceSaving(SpaceSaving):
    """A SpaceSaving sketch that halves itself every `window` stream
    weight — the RECENT view of the hot set (ISSUE 20). With the stream
    total capped near ``2 * window``, an id that stops appearing loses
    half its tracked weight per window of new traffic: after a
    popularity flip the new head overtakes the old one within a couple
    of windows instead of hours (pinned by the flip-then-converge test).
    The decayed sketch keeps the Space-Saving guarantees relative to the
    decayed stream, so `hot_share()` stays a conservative cache-sizing
    bound — now of recent traffic rather than the job's whole life."""

    def __init__(self, k: int = K_DEFAULT, window: int = 1 << 16):
        super().__init__(k)
        self.window = max(1, int(window))

    def _update_locked(self, key: int, inc: int) -> None:
        super()._update_locked(key, inc)
        if self.total > 2 * self.window:
            self._decay_locked(0.5)

    def update_batch(self, ids, counts=None) -> None:
        super().update_batch(ids, counts)
        with self._lock:
            if self.total > 2 * self.window:
                self._decay_locked(0.5)
