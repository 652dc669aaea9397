"""Kubernetes instance manager: master-created worker pods + event watch.

Reference parity: elasticdl/python/master/k8s_instance_manager.py (SURVEY
§2.1) — the master creates worker pods via the k8s API, watches the pod event
stream, relaunches failures up to the budget, and tells membership (and
through it the task dispatcher) when a worker dies. k8s is the failure
detector here, not heartbeats: a FAILED/DELETED event drives task recovery
immediately, while the heartbeat reaper stays as the backstop for pods that
hang without dying.

The process twin is master/process_manager.py — same state machine over
subprocesses; this module is the pod flavor the reference actually shipped.
The k8s API surface is injected (`K8sApi`) so the state machine is unit-
testable against a scripted watch stream (SURVEY §4's in-process-fake
pattern); the shipped implementation, `KubectlApi`, shells to kubectl with
JSON watch-event output — this sandbox has no `kubernetes` Python client, and
kubectl's `--output-watch-events` stream carries the same ADDED/MODIFIED/
DELETED triples the client's watch would.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import yaml

from elasticdl_tpu_torch.common.config import JobConfig
from elasticdl_tpu_torch.common.constants import PodStatus
from elasticdl_tpu_torch.common.log_utils import default_logger
from elasticdl_tpu_torch.master.membership import Membership

logger = default_logger(__name__)


@dataclass
class PodEvent:
    """One pod lifecycle event, normalized from the watch stream."""

    type: str        # ADDED | MODIFIED | DELETED
    name: str        # pod name
    phase: str       # Pending | Running | Succeeded | Failed | Unknown


class K8sApi:
    """The slice of the k8s API the instance manager needs. Injectable so
    tests script the watch; KubectlApi is the production implementation."""

    def create_pod(self, manifest: Dict) -> None:
        raise NotImplementedError

    def delete_pod(self, name: str) -> None:
        raise NotImplementedError

    def watch_pods(self, label_selector: str, stop: threading.Event
                   ) -> Iterator[PodEvent]:
        raise NotImplementedError


class KubectlApi(K8sApi):
    """kubectl-backed implementation (no `kubernetes` package needed)."""

    def __init__(self, namespace: str = "default"):
        self._ns = namespace
        self._kubectl = shutil.which("kubectl")
        self._watch_procs: List[subprocess.Popen] = []
        if self._kubectl is None:
            raise RuntimeError(
                "kubectl not found on PATH; the k8s instance manager needs "
                "it (or inject a K8sApi)"
            )

    def create_pod(self, manifest: Dict) -> None:
        proc = subprocess.run(
            [self._kubectl, "-n", self._ns, "apply", "-f", "-"],
            input=yaml.safe_dump(manifest).encode(),
            capture_output=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"pod create failed: {proc.stderr.decode()}")

    def delete_pod(self, name: str) -> None:
        subprocess.run(
            [self._kubectl, "-n", self._ns, "delete", "pod", name,
             "--ignore-not-found", "--wait=false"],
            capture_output=True,
        )

    def watch_pods(self, label_selector: str, stop: threading.Event
                   ) -> Iterator[PodEvent]:
        """`kubectl get pods --watch --output-watch-events -o json` emits one
        JSON document per event: {"type": ..., "object": <Pod>}. The read
        loop selects with a short timeout so `stop` is observed within
        ~0.5 s even when no events arrive (a blocking read1 would pin the
        watcher thread until the next pod event); close() kills any
        outstanding kubectl child."""
        import codecs
        import select

        proc = subprocess.Popen(
            [
                self._kubectl, "-n", self._ns, "get", "pods",
                "-l", label_selector, "--watch", "--output-watch-events",
                "-o", "json",
            ],
            stdout=subprocess.PIPE,
        )
        self._watch_procs.append(proc)
        decoder = json.JSONDecoder()
        # incremental decode: a multi-byte UTF-8 sequence (pod annotations,
        # event messages) split across a read boundary must not raise and
        # tear the watch stream down
        utf8 = codecs.getincrementaldecoder("utf-8")(errors="replace")
        buf = ""
        try:
            while not stop.is_set():
                ready, _, _ = select.select([proc.stdout], [], [], 0.5)
                if not ready:
                    if proc.poll() is not None:
                        break  # kubectl exited with nothing buffered
                    continue
                raw = proc.stdout.read1(65536)
                if not raw:
                    break
                buf += utf8.decode(raw)
                while True:
                    buf = buf.lstrip()
                    if not buf:
                        break
                    try:
                        obj, idx = decoder.raw_decode(buf)
                    except json.JSONDecodeError:
                        break  # partial document; read more
                    buf = buf[idx:]
                    pod = obj.get("object", {})
                    yield PodEvent(
                        type=obj.get("type", ""),
                        name=pod.get("metadata", {}).get("name", ""),
                        phase=pod.get("status", {}).get("phase", "Unknown"),
                    )
        finally:
            proc.kill()
            if proc in self._watch_procs:
                self._watch_procs.remove(proc)

    def close(self) -> None:
        """Kill outstanding kubectl --watch children (the generator's
        finally may never run if its thread is parked on a dead stream)."""
        for proc in list(self._watch_procs):
            try:
                proc.kill()
            except OSError:
                pass


class K8sInstanceManager:
    """Create/watch/relaunch worker pods; drive task recovery on pod death.

    Same interface shape as ProcessManager (start_workers/add_worker/stop/
    statuses/all_exited/all_failed) so master wiring and tests treat the two
    flavors interchangeably.
    """

    def __init__(
        self,
        cfg: JobConfig,
        membership: Optional[Membership] = None,
        api: Optional[K8sApi] = None,
        job_finished_fn=None,
    ):
        from elasticdl_tpu_torch.client.k8s import JOB_LABEL

        self.cfg = cfg
        self._membership = membership
        self._api = api if api is not None else KubectlApi(cfg.namespace)
        self._job_finished_fn = job_finished_fn or (lambda: False)
        self._label = f"{JOB_LABEL}={cfg.job_name}"
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._watcher: Optional[threading.Thread] = None
        self._status: Dict[int, str] = {}            # guarded_by: _lock
        self._relaunches: Dict[int, int] = {}        # guarded_by: _lock
        # Pod names carry a per-worker GENERATION suffix (worker-<id>-g<N>):
        # a relaunch under the SAME name would `kubectl apply` onto the dead
        # Failed pod object and no-op (no new container), and late DELETED
        # events for old pods would be misattributed to the healthy
        # replacement. Fresh names make relaunches real and stale events
        # distinguishable.
        self._gen: Dict[int, int] = {}               # guarded_by: _lock
        # deliberately removed workers terminate as DELETED, not FAILED
        self._removed: set = set()                   # guarded_by: _lock
        self._next_worker_id = 0                     # guarded_by: _lock

    # ------------------------------------------------------------------ #

    def _pod_name(self, worker_id: int, gen: Optional[int] = None) -> str:  # holds: _lock
        g = self._gen.get(worker_id, 0) if gen is None else gen
        return f"{self.cfg.job_name}-worker-{worker_id}-g{g}"

    def _parse_pod(self, pod_name: str) -> Optional[Tuple[int, int]]:
        """pod name -> (worker_id, generation), or None for foreign pods."""
        prefix = f"{self.cfg.job_name}-worker-"
        if not pod_name.startswith(prefix):
            return None
        rest = pod_name[len(prefix):]
        wid_s, sep, gen_s = rest.rpartition("-g")
        if not sep:
            return None
        try:
            return int(wid_s), int(gen_s)
        except ValueError:
            return None

    def _create(self, worker_id: int, name: str) -> None:
        """API call only — callers reserve status/name under the lock first;
        kubectl I/O (up to its ~30 s request timeout) must never run under
        self._lock or it freezes status polls and event handling."""
        from elasticdl_tpu_torch.client.k8s import render_worker_pod

        self._api.create_pod(render_worker_pod(self.cfg, worker_id, pod_name=name))
        logger.info("created worker pod %s", name)

    def start_workers(self) -> None:
        with self._lock:
            names = []
            for _ in range(self.cfg.num_workers):
                wid = self._next_worker_id
                self._next_worker_id += 1
                self._status[wid] = PodStatus.PENDING
                names.append((wid, self._pod_name(wid)))
        for wid, name in names:
            try:
                self._create(wid, name)
            except Exception:
                logger.exception("initial create of worker %d failed", wid)
                with self._lock:
                    self._status[wid] = PodStatus.FAILED
        self._watcher = threading.Thread(target=self._watch_loop, daemon=True)
        self._watcher.start()

    def add_worker(self) -> int:
        """Elastic scale-out: one more worker pod (reference parity: the pod
        manager growing the worker set; membership version bumps when the new
        pod registers). Training jobs are rejected — plain pods have no
        gradient exchange (see process_manager's runtime guard)."""
        from elasticdl_tpu_torch.master.process_manager import (
            _reject_plain_training_scale_out,
        )

        _reject_plain_training_scale_out(self.cfg)
        with self._lock:
            wid = self._next_worker_id
            self._next_worker_id += 1
            self._status[wid] = PodStatus.PENDING
            name = self._pod_name(wid)
        self._create(wid, name)
        return wid

    def remove_worker(self, worker_id: int) -> None:
        """Deliberate scale-in: delete the pod; the DELETED event (not this
        call) drives lease recovery so the path is identical to eviction —
        but the worker terminates as DELETED, not FAILED (a scale-in is not
        a failure and must not trip all_failed())."""
        with self._lock:
            self._removed.add(worker_id)
            name = self._pod_name(worker_id)
        self._api.delete_pod(name)

    # ------------------------------------------------------------------ #

    def _watch_loop(self) -> None:
        while not self._stop.is_set():
            try:
                for event in self._api.watch_pods(self._label, self._stop):
                    if self._stop.is_set():
                        break
                    self._handle_event(event)
            except Exception:
                if self._stop.is_set():
                    break
                logger.exception("pod watch stream failed; reconnecting")
            # the watch stream ended (kubectl restart, apiserver hiccup):
            # reconnect unless stopping
            self._stop.wait(1.0)

    def _handle_event(self, event: PodEvent) -> None:
        parsed = self._parse_pod(event.name)
        if parsed is None:
            return
        wid, gen = parsed
        with self._lock:
            if gen != self._gen.get(wid, 0):
                # stale event from a previous generation's pod (e.g. the GC
                # deleting a Failed pod we already replaced): ignore — acting
                # on it would kill the healthy replacement's leases
                return
        if event.type in ("ADDED", "MODIFIED"):
            if event.phase == "Running":
                with self._lock:
                    self._status[wid] = PodStatus.RUNNING
            elif event.phase == "Succeeded":
                with self._lock:
                    self._status[wid] = PodStatus.SUCCEEDED
            elif event.phase == "Failed":
                with self._lock:
                    # same terminal guard as DELETED: a budget-exhausted
                    # worker's Failed pod lingers in the cluster (no relaunch
                    # deletes it), and every watch reconnect re-lists it as
                    # ADDED/Failed for the same generation — without this,
                    # each reconnect re-fires _on_pod_death (repeat
                    # mark_dead; status corruption once the job finishes)
                    terminal = self._status.get(wid) in (
                        PodStatus.SUCCEEDED, PodStatus.FAILED,
                        PodStatus.DELETED,
                    )
                if not terminal:
                    self._on_pod_death(wid, f"pod {event.name} Failed")
        elif event.type == "DELETED":
            with self._lock:
                terminal = self._status.get(wid) in (
                    PodStatus.SUCCEEDED, PodStatus.FAILED, PodStatus.DELETED,
                )
            if not terminal:
                self._on_pod_death(wid, f"pod {event.name} deleted")

    def _on_pod_death(self, wid: int, reason: str) -> None:
        """Pod death IS the failure signal (no heartbeat lapse needed):
        recover the worker's leased tasks now, then relaunch within budget."""
        if self._job_finished_fn():
            with self._lock:
                self._status[wid] = PodStatus.SUCCEEDED
            return
        if self._membership is not None:
            # mark_dead fires the dispatcher's recover_tasks callback —
            # this is what makes recovery watch-driven, not timeout-driven
            self._membership.mark_dead(wid, reason=reason)
        # decide under the lock, perform kubectl I/O outside it
        with self._lock:
            if wid in self._removed:
                # deliberate scale-in completing: terminal, not a failure
                self._status[wid] = PodStatus.DELETED
                logger.info("%s; worker %d removed (scale-in)", reason, wid)
                return
            relaunches = self._relaunches.get(wid, 0)
            if relaunches >= self.cfg.relaunch_max:
                self._status[wid] = PodStatus.FAILED
                logger.error("%s; relaunch budget exhausted", reason)
                return
            self._relaunches[wid] = relaunches + 1
            old_name = self._pod_name(wid)
            self._gen[wid] = self._gen.get(wid, 0) + 1
            new_name = self._pod_name(wid)
            self._status[wid] = PodStatus.PENDING
        logger.warning(
            "%s; relaunch %d/%d as %s", reason,
            relaunches + 1, self.cfg.relaunch_max, new_name,
        )
        try:
            # clean up the dead object (ignore-not-found), then create the
            # next generation under its fresh name
            self._api.delete_pod(old_name)
            self._create(wid, new_name)
        except Exception:
            logger.exception("relaunch of worker %d failed", wid)
            with self._lock:
                self._status[wid] = PodStatus.FAILED

    # ------------------------------------------------------------------ #

    def stop(self, grace_s: float = 10.0) -> None:
        self._stop.set()
        close = getattr(self._api, "close", None)
        if close is not None:
            close()  # unblocks a watcher parked on the kubectl stream
        if self._watcher is not None:
            self._watcher.join(timeout=grace_s)
        with self._lock:
            names = [self._pod_name(wid) for wid in self._status]
        for name in names:
            try:
                self._api.delete_pod(name)
            except Exception:
                logger.exception("delete of %s failed", name)

    def statuses(self) -> Dict[int, str]:
        with self._lock:
            return dict(self._status)

    def all_exited(self) -> bool:
        with self._lock:
            return bool(self._status) and all(
                s in (PodStatus.SUCCEEDED, PodStatus.FAILED, PodStatus.DELETED)
                for s in self._status.values()
            )

    def all_failed(self) -> bool:
        # DELETED (deliberately removed/evicted — K8sInstanceTarget's
        # eviction path lands here) and SUCCEEDED pods are retirements,
        # not failures: excluded, or one eviction pins this False while
        # the rest of the fleet dies (process_manager.all_failed's twin)
        with self._lock:
            tracked = [
                s for s in self._status.values()
                if s not in (PodStatus.DELETED, PodStatus.SUCCEEDED)
            ]
            return bool(tracked) and all(
                s == PodStatus.FAILED for s in tracked
            )
