"""Always-on step profiler: per-step phase attribution + memory watermarks.

The health layer (PR 6) can say a worker is slow; nothing says WHY. This
module attributes each train step's wall time to phases —

    data_wait   blocking on the input pipeline (reader/parse/shard fill;
                the prefetcher times its source pulls here)
    h2d         host->device transfer dispatch (prefetcher `device_put` /
                cohort global-batch assembly)
    compute     the step dispatch + device compute (the worker's timed
                region, which ends in the scalar readback)
    handoff     rescale/reform work landing on the step path (live state
                handoff, drained-batch requeues)

— and tracks host/device memory watermarks. Always on: the cost per step
is a few perf_counter reads and float adds under a leaf lock (bench.py's
`obs_overhead` leg gates it at <= 2% median step time).

Exports:

- gauges `edl_step_phase_seconds{phase=...}` (rolling per-step mean over
  the window) and `edl_mem_host_rss_mb` / `edl_mem_device_peak_mb`
  (watermarks, refreshed at snapshot time — never per step);
- `snapshot()`: the compact dict that rides the existing heartbeat stats
  payload (observability/health.py), so the master's ClusterHealth sees
  *why* a straggler is slow, not just that it is;
- flight-bundle integration: FlightRecorder.bundle() embeds the snapshot.

Stdlib-only at import; the device-memory probe lazily asks jax (guarded —
absence degrades to host-only watermarks).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, Iterable, Iterator, Optional

from elasticdl_tpu_torch.observability.registry import default_registry

#: the phase vocabulary (snapshot keys are phase_<name>_ms)
PHASES = ("data_wait", "h2d", "compute", "handoff")

#: rolling window (steps) the per-phase means are computed over
WINDOW_DEFAULT = 128

_reg = default_registry()
_PHASE_S = _reg.gauge(
    "edl_step_phase_seconds",
    "rolling per-step mean wall time attributed to each step phase",
    labels=("phase",))
_MEM_HOST = _reg.gauge(
    "edl_mem_host_rss_mb", "host RSS high-water mark (MB)")
_MEM_DEV = _reg.gauge(
    "edl_mem_device_peak_mb",
    "device memory high-water mark (MB; 0 when the backend exposes none)")


#: profiler phase -> goodput-ledger category (observability/goodput.py).
#: `handoff` is deliberately ABSENT: rescale seconds are attributed at
#: the rescale sites themselves (with settle/handoff/compile sub-buckets)
#: and teeing the profiler's handoff too would double-bill them.
PHASE_TO_GOODPUT = {
    "data_wait": "data_wait",
    "h2d": "h2d",
    "compute": "train_compute",
}


class StepProfiler:
    """Accumulate phase seconds into the CURRENT step, roll them into the
    window at `step_done()`. Thread-safe (heartbeat threads snapshot while
    the train loop observes); the lock is a LEAF lock.

    `ledger` (a goodput.GoodputLedger) receives a tee of every phase add
    through PHASE_TO_GOODPUT — the goodput ledger's train/data/h2d
    attribution costs no second timer on the hot path. The process
    singleton (`get_profiler`) wires the process ledger; direct
    constructions opt in explicitly (bench.py's obs_overhead ON leg
    does, so the tee's cost stays inside the measured <=2% gate)."""

    def __init__(self, window: int = WINDOW_DEFAULT, ledger=None):
        self._ledger = ledger
        self._lock = threading.Lock()
        self._acc: Dict[str, float] = {}                 # guarded_by: _lock
        # per-phase rolling windows with maintained sums (mean is O(1))
        self._win: Dict[str, "deque[float]"] = {         # guarded_by: _lock
            p: deque(maxlen=window) for p in PHASES
        }
        self._sums: Dict[str, float] = {p: 0.0 for p in PHASES}  # guarded_by: _lock
        self._steps = 0                                  # guarded_by: _lock
        self._host_peak_mb = 0.0                         # guarded_by: _lock
        self._dev_peak_mb = 0.0                          # guarded_by: _lock

    # ------------------------------------------------------------------ #
    # hot path

    def add(self, phase: str, seconds: float) -> None:
        """Accumulate `seconds` into the current step's `phase` bucket
        (phases outside PHASES are accepted but dropped at step_done —
        bounded keys keep the heartbeat payload inside its size budget)."""
        if seconds <= 0:
            return
        with self._lock:
            self._acc[phase] = self._acc.get(phase, 0.0) + seconds
        if self._ledger is not None:
            category = PHASE_TO_GOODPUT.get(phase)
            if category is not None:
                self._ledger.add(category, seconds)

    @contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def step_done(self, steps: int = 1) -> None:
        """Close the current step (or group of `steps` steps — grouped
        dispatch normalizes to per-step values so grouped and single-step
        workers report comparably) into the rolling windows."""
        n = max(1, int(steps))
        with self._lock:
            acc, self._acc = self._acc, {}
            self._steps += n
            for phase in PHASES:
                v = acc.pop(phase, 0.0) / n
                win = self._win[phase]
                if len(win) == win.maxlen:
                    self._sums[phase] -= win[0]
                win.append(v)
                self._sums[phase] += v
            # leftovers under non-standard keys are dropped (see add())
        for phase in PHASES:
            _PHASE_S.set(self._mean(phase), phase=phase)

    def _mean(self, phase: str) -> float:
        with self._lock:
            win = self._win[phase]
            return self._sums[phase] / len(win) if win else 0.0

    # ------------------------------------------------------------------ #
    # watermarks (snapshot cadence, never per step)

    def update_memory(self) -> None:
        """Refresh host/device memory watermarks. Best-effort: the host
        side is stdlib `resource` (ru_maxrss), the device side asks jax's
        per-device `memory_stats()` when the backend exposes it."""
        host_mb = 0.0
        try:
            import resource

            ru = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            # linux reports KB, macOS bytes; normalize to MB
            host_mb = ru / 1024.0 if os.uname().sysname != "Darwin" \
                else ru / (1024.0 * 1024.0)
        except Exception:
            # no resource module / exotic platform — host watermark stays 0:
            # edl-lint: disable=EDL303
            pass
        dev_mb = 0.0
        try:
            import sys

            jax = sys.modules.get("jax")   # never IMPORT jax from here —
            if jax is not None:            # only read it if the process did
                for d in jax.local_devices():
                    stats = getattr(d, "memory_stats", lambda: None)()
                    if stats:
                        dev_mb += float(
                            stats.get("peak_bytes_in_use",
                                      stats.get("bytes_in_use", 0))
                        ) / (1024.0 * 1024.0)
        except Exception:
            # a backend without memory_stats degrades to host-only:
            # edl-lint: disable=EDL303
            dev_mb = 0.0
        with self._lock:
            self._host_peak_mb = max(self._host_peak_mb, host_mb)
            self._dev_peak_mb = max(self._dev_peak_mb, dev_mb)
            host_peak, dev_peak = self._host_peak_mb, self._dev_peak_mb
        _MEM_HOST.set(host_peak)
        _MEM_DEV.set(dev_peak)

    # ------------------------------------------------------------------ #

    def snapshot(self, update_memory: bool = True) -> Dict[str, Any]:
        """The compact per-process profile row the heartbeat payload (and
        the flight bundle) carries: per-step phase means (ms) for phases
        with data, plus the memory watermarks."""
        if update_memory:
            self.update_memory()
        out: Dict[str, Any] = {}
        with self._lock:
            steps = self._steps
            for phase in PHASES:
                win = self._win[phase]
                if win and self._sums[phase] > 0:
                    out[f"phase_{phase}_ms"] = round(
                        1e3 * self._sums[phase] / len(win), 3
                    )
            host_peak, dev_peak = self._host_peak_mb, self._dev_peak_mb
        if steps:
            out["profiled_steps"] = steps
        if host_peak:
            out["mem_host_mb"] = round(host_peak, 1)
        if dev_peak:
            out["mem_dev_mb"] = round(dev_peak, 1)
        return out

    def reset(self) -> None:
        with self._lock:
            self._acc = {}
            for p in PHASES:
                self._win[p].clear()
                self._sums[p] = 0.0
            self._steps = 0
            self._host_peak_mb = self._dev_peak_mb = 0.0


def timed_iter(iterable: Iterable, profiler: "StepProfiler",
               phase: str = "data_wait") -> Iterator:
    """Yield from `iterable`, attributing each next() wait to `phase` —
    the grouped-dispatch paths' data-wait instrumentation (the prefetcher
    self-times on the k == 1 paths)."""
    it = iter(iterable)
    while True:
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            return
        finally:
            profiler.add(phase, time.perf_counter() - t0)
        yield item


# ---------------------------------------------------------------------- #
# process singleton (worker/cohort/prefetcher all feed the same profile)

_PROFILER: Optional[StepProfiler] = None
_PROFILER_LOCK = threading.Lock()


def get_profiler() -> StepProfiler:
    global _PROFILER
    with _PROFILER_LOCK:
        if _PROFILER is None:
            from elasticdl_tpu_torch.observability import goodput

            # the process profiler tees phase adds into the process
            # goodput ledger: one instrumentation site, two consumers
            _PROFILER = StepProfiler(ledger=goodput.get_ledger())
        return _PROFILER


def reset_for_tests() -> None:
    global _PROFILER
    with _PROFILER_LOCK:
        _PROFILER = None
