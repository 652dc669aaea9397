"""Process-local metrics registry: counters, gauges, histograms.

Design constraints:

- stdlib-only, jax-free: this is imported by modules on the client submit
  path and by the analysis package; it must cost nothing but a dict and a
  lock.
- thread-safe: every metric mutation is under the metric's own lock, and
  the registry's create-or-get is under the registry lock. Metric locks
  are LEAF locks — nothing inside them acquires any other lock — so
  incrementing a counter while holding a subsystem lock (dispatcher,
  membership) can never participate in a lock-order cycle.
- bounded memory: histograms keep a fixed-size reservoir (uniform
  reservoir sampling), so an unbounded stream of observations costs O(1).
- idempotent registration: `registry.counter(name, ...)` returns the
  existing metric when `name` is already registered (modules declare
  their metrics at import time; re-imports and multiple instances share
  one series). Re-registering under a different KIND is a hard error.
- naming: every name must match `edl_<subsystem>_<name>`
  (`_NAME_RE`) — enforced here at runtime and by edl-lint EDL401
  statically, so the scrape surface stays grep-able and collision-free.
"""

from __future__ import annotations

import random
import re
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

#: the project metric naming pattern (edl-lint EDL401 mirrors this)
_NAME_RE = re.compile(r"^edl_[a-z][a-z0-9]*_[a-z0-9_]*[a-z0-9]$")

#: default histogram reservoir size — big enough for stable p99 on
#: control-plane event rates, small enough to never matter in RAM
DEFAULT_RESERVOIR = 512

_QUANTILES = (0.5, 0.9, 0.99)


def validate_metric_name(name: str) -> str:
    if not _NAME_RE.match(name):
        raise ValueError(
            f"metric name {name!r} does not match the project pattern "
            "edl_<subsystem>_<name> (lowercase, underscore-separated; "
            "see docs/observability.md and edl-lint EDL401)"
        )
    return name


def _escape_label(value: str) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace("\n", "\\n")
        .replace('"', '\\"')
    )


def _render_labels(names: Tuple[str, ...], values: Tuple[str, ...],
                   extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    pairs = list(zip(names, values)) + list(extra)
    if not pairs:
        return ""
    body = ",".join(f'{k}="{_escape_label(v)}"' for k, v in pairs)
    return "{" + body + "}"


def quantile_sorted(sorted_vals, q: float) -> float:
    """Linear-interpolation quantile over an ASCENDING-sorted sequence
    (0.0 when empty) — the one implementation `_Reservoir` and the worker
    health stats share (observability/health.py)."""
    if not sorted_vals:
        return 0.0
    idx = q * (len(sorted_vals) - 1)
    lo = int(idx)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = idx - lo
    return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac


def _fmt(value: float) -> str:
    # integers print as integers (Prometheus accepts both; humans diff this)
    if float(value).is_integer():
        return str(int(value))
    return repr(float(value))


class Metric:
    """Base: one named series family (labelled children share the name)."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labels: Iterable[str] = ()):
        self.name = validate_metric_name(name)
        self.help = help
        self.label_names: Tuple[str, ...] = tuple(labels)
        self._lock = threading.Lock()

    def _label_key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {tuple(labels)}"
            )
        return tuple(str(labels[k]) for k in self.label_names)

    def render(self) -> List[str]:
        raise NotImplementedError

    def snapshot(self) -> Dict[str, float]:
        raise NotImplementedError

    def _series_name(self, key: Tuple[str, ...]) -> str:
        return self.name + _render_labels(self.label_names, key)


class Counter(Metric):
    """Monotonic counter; `inc(n, **labels)`."""

    kind = "counter"

    def __init__(self, name: str, help: str = "",
                 labels: Iterable[str] = ()):
        super().__init__(name, help, labels)
        self._values: Dict[Tuple[str, ...], float] = {}

    def inc(self, n: float = 1.0, **labels: str) -> None:
        if n < 0:
            raise ValueError(f"{self.name}: counters only go up (n={n})")
        key = self._label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + n

    def value(self, **labels: str) -> float:
        key = self._label_key(labels)
        with self._lock:
            return self._values.get(key, 0.0)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            items = sorted(self._values.items())
        if not self.label_names and not items:
            items = [((), 0.0)]
        return {self._series_name(k): v for k, v in items}

    def render(self) -> List[str]:
        return [f"{n} {_fmt(v)}" for n, v in self.snapshot().items()]


class Gauge(Metric):
    """Point-in-time value: `set()`/`add()`, or a `set_fn` callback read at
    scrape/snapshot time (for values another subsystem already owns, e.g.
    the compile cache's hit rate — no double bookkeeping)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 labels: Iterable[str] = ()):
        super().__init__(name, help, labels)
        self._values: Dict[Tuple[str, ...], float] = {}
        self._fn: Optional[Callable[[], float]] = None

    def set(self, value: float, **labels: str) -> None:
        key = self._label_key(labels)
        with self._lock:
            self._values[key] = float(value)

    def add(self, n: float = 1.0, **labels: str) -> None:
        key = self._label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + n

    def set_fn(self, fn: Callable[[], float]) -> "Gauge":
        """Compute the (unlabelled) value at read time. The callback runs
        OUTSIDE the metric lock and must not raise for long — a failing
        callback reads as 0 rather than breaking the whole scrape."""
        if self.label_names:
            raise ValueError(f"{self.name}: set_fn is unlabelled-only")
        self._fn = fn
        return self

    def value(self, **labels: str) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:
                # a failing callback reads as 0 — the scrape (and with it
                # the hot path behind it) must never inherit a subsystem's
                # exception: edl-lint: disable=EDL303
                return 0.0
        key = self._label_key(labels)
        with self._lock:
            return self._values.get(key, 0.0)

    def snapshot(self) -> Dict[str, float]:
        if self._fn is not None:
            return {self.name: self.value()}
        with self._lock:
            items = sorted(self._values.items())
        if not self.label_names and not items:
            items = [((), 0.0)]
        return {self._series_name(k): v for k, v in items}

    def render(self) -> List[str]:
        return [f"{n} {_fmt(v)}" for n, v in self.snapshot().items()]


class _Reservoir:
    """Uniform (Vitter algorithm R) bounded sample + exact count/sum/max."""

    __slots__ = ("sample", "count", "sum", "max", "capacity", "_rng")

    def __init__(self, capacity: int, rng: random.Random):
        self.sample: List[float] = []
        self.count = 0
        self.sum = 0.0
        self.max = 0.0
        self.capacity = capacity
        self._rng = rng

    def observe(self, v: float) -> None:
        self.count += 1
        self.sum += v
        if self.count == 1 or v > self.max:
            self.max = v
        if len(self.sample) < self.capacity:
            self.sample.append(v)
        else:
            i = self._rng.randrange(self.count)
            if i < self.capacity:
                self.sample[i] = v

    def quantile(self, q: float) -> float:
        return quantile_sorted(sorted(self.sample), q)


class Histogram(Metric):
    """Sampled distribution rendered as a Prometheus SUMMARY (quantile
    series + _sum/_count). The reservoir bounds memory; quantiles are
    estimates over the sample, exact until `count > reservoir`."""

    kind = "summary"

    def __init__(self, name: str, help: str = "",
                 labels: Iterable[str] = (),
                 reservoir: int = DEFAULT_RESERVOIR):
        super().__init__(name, help, labels)
        self._reservoir_size = max(1, int(reservoir))
        # seeded per metric name: deterministic sampling for tests, and no
        # dependence on global random state
        self._rng = random.Random(name)
        self._children: Dict[Tuple[str, ...], _Reservoir] = {}

    def observe(self, value: float, **labels: str) -> None:
        key = self._label_key(labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = _Reservoir(self._reservoir_size, self._rng)
                self._children[key] = child
            child.observe(float(value))

    def count(self, **labels: str) -> int:
        key = self._label_key(labels)
        with self._lock:
            child = self._children.get(key)
            return child.count if child else 0

    def quantile(self, q: float, **labels: str) -> float:
        key = self._label_key(labels)
        with self._lock:
            child = self._children.get(key)
            return child.quantile(q) if child else 0.0

    def snapshot(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        with self._lock:
            items = sorted(self._children.items())
            for key, child in items:
                suffix = _render_labels(self.label_names, key)
                out[self.name + "_count" + suffix] = float(child.count)
                out[self.name + "_sum" + suffix] = child.sum
                # sort the reservoir ONCE for all quantiles — snapshot
                # runs on the summary-stream/time-series cadence, and
                # per-quantile sorts triple its dominant cost
                s = sorted(child.sample)
                for q in _QUANTILES:
                    out[f"{self.name}_p{int(q * 100)}{suffix}"] = (
                        quantile_sorted(s, q)
                    )
        return out

    def render(self) -> List[str]:
        lines: List[str] = []
        with self._lock:
            items = sorted(self._children.items())
            for key, child in items:
                for q in _QUANTILES:
                    labels = _render_labels(
                        self.label_names, key, (("quantile", str(q)),)
                    )
                    lines.append(
                        f"{self.name}{labels} {_fmt(child.quantile(q))}"
                    )
                suffix = _render_labels(self.label_names, key)
                lines.append(f"{self.name}_sum{suffix} {_fmt(child.sum)}")
                lines.append(
                    f"{self.name}_count{suffix} {_fmt(child.count)}"
                )
        return lines


class MetricsRegistry:
    """Create-or-get metric store; renders Prometheus text format."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Metric] = {}
        self.created_at = time.time()

    def _get_or_create(self, cls, name: str, help: str,
                       labels: Iterable[str], **kw) -> Metric:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind}, not {cls.kind}"
                    )
                return existing
            metric = cls(name, help, labels, **kw)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str = "",
                labels: Iterable[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Iterable[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Iterable[str] = (),
                  reservoir: int = DEFAULT_RESERVOIR) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labels, reservoir=reservoir
        )

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def metrics(self) -> List[Metric]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def snapshot(self) -> Dict[str, float]:
        """Flat {series_name: value} — the summary-service stream and the
        bench both consume this. Callback gauges are evaluated here."""
        out: Dict[str, float] = {}
        for metric in self.metrics():
            try:
                out.update(metric.snapshot())
            except Exception:
                # one broken metric must not take the whole snapshot down:
                # edl-lint: disable=EDL303
                continue
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4)."""
        lines: List[str] = []
        for metric in self.metrics():
            if metric.help:
                lines.append(f"# HELP {metric.name} {metric.help}")
            lines.append(f"# TYPE {metric.name} {metric.kind}")
            try:
                lines.extend(metric.render())
            except Exception:
                # scrape keeps serving the healthy series:
                # edl-lint: disable=EDL303
                continue
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------- #
# the process-global default registry every wired subsystem shares

_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _DEFAULT
