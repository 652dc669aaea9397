"""Kubernetes on GPU nodes: the port's manifests, its copy of the pod
manager, the master that owns the pods, and the model-zoo verbs, against
the reference's.

- Manifests: over one grid of configs (a plain job, a job with a GPU in
  its worker request, master-managed pods with generation names, an
  evaluation job of 2 workers, cohorts of 2 and 4 processes, the master
  pod and its service), the port's `render_job_manifests` and
  `render_worker_pod` equal the reference's as dicts after exactly the
  two differences `elasticdl_tpu_torch/client/k8s.py` names (`as_port`):
  the module each pod runs, and the accelerator block (one
  `nvidia.com/gpu` requested and limited a worker pod, and for a
  StatefulSet cohort member its card, `EDL_TORCH_DEVICE=cuda:0`). A
  `--tpu_type` and `nvidia.com/gpu=2` are refused.
- The manager (`master/k8s_instance_manager.py`, a copy): the scripted
  event sequences of `tests/test_k8s_instance_manager.py` (start, a pod
  failure without heartbeat, budget exhaustion, DELETED and Succeeded,
  stale generations, add and remove, stop, a stream that dies and
  reconnects, a relist, the refusal to grow a plain training fleet, and
  the adversarial stand-in `kubectl` stream through `KubectlApi`) run
  through the reference's manager and the port's; the created and deleted
  pods, `statuses()` and the dispatcher's counts must be equal.
- The master (reference `test_master_owns_k8s_instance_manager`): the
  port's `Master(cfg, k8s_api=...)` creates the pods, recovers a dead
  pod's lease and relaunches it as the next generation, deletes the pods
  at shutdown, and under `--autoscale` binds `K8sInstanceTarget`.
- The StatefulSet's hostname ordinal becomes the port's cohort process id
  (`parallel/elastic.context_from_env`), with the cohort variables
  restored after; a pod's named card is a request, never a CPU fallback.
- The CLI: `client.main train --image_name ...` without kubectl prints
  YAML that parses to the renderer's dicts.
- The zoo: `zoo init` writes a template that imports no JAX; from one
  seeded batch and the reference template's flax weights, the port's
  template gives the reference's outputs and loss, and one Adam step its
  parameters (rtol 1e-6, atol 1e-6); `zoo build` without docker writes
  the Dockerfile and returns 1, as the reference's does.
"""

import ast
import contextlib
import copy
import importlib
import importlib.util
import io
import os
import queue
import socket
import stat
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

REPO = Path(__file__).resolve().parent.parent
TZOO = str(REPO / "elasticdl_tpu_torch" / "model_zoo")
COHORT_ENV = ("EDL_PROCESS_ID", "EDL_NUM_PROCESSES",
              "EDL_PROCESS_ID_FROM_HOSTNAME", "EDL_COORDINATOR_ADDR")
TOL = dict(rtol=1e-6, atol=1e-6)


def modules(root):
    """The modules a case uses, from `root` ("elasticdl_tpu" or
    "elasticdl_tpu_torch")."""
    names = {
        "kim": "master.k8s_instance_manager", "k8s": "client.k8s",
        "config": "common.config", "constants": "common.constants",
        "membership": "master.membership",
        "dispatcher": "master.task_dispatcher", "zoo": "client.zoo",
    }
    return types.SimpleNamespace(**{
        k: importlib.import_module(f"{root}.{v}") for k, v in names.items()})


# ---------------------------------------------------------------- manifests

# the differences of the port's manifests from the reference's
MODULES = {"elasticdl_tpu.master.main": "elasticdl_tpu_torch.master.main",
           "elasticdl_tpu.worker.main": "elasticdl_tpu_torch.worker.main"}
GPU = {"nvidia.com/gpu": "1"}


def as_port(manifest):
    """A reference manifest with the port's two differences applied: the
    module its containers run, and the accelerator block of a worker
    container."""
    m = copy.deepcopy(manifest)
    if m["kind"] == "StatefulSet":
        pod = m["spec"]["template"]["spec"]
    elif m["kind"] == "Pod":
        pod = m["spec"]
    else:
        return m
    for c in pod["containers"]:
        c["command"] = [MODULES.get(x, x) for x in c["command"]]
        if c["name"] != "worker":
            continue
        # without a tpu_type the reference limits nothing
        assert c["resources"]["limits"] == {}, c["resources"]
        c["resources"]["requests"].update(GPU)
        c["resources"]["limits"] = dict(GPU)
        if any(e["name"] == "EDL_PROCESS_ID_FROM_HOSTNAME" for e in c["env"]):
            c["env"].append({"name": "EDL_TORCH_DEVICE", "value": "cuda:0"})
    return m


BASE = ["--job_name", "kj", "--image_name", "img:latest",
        "--model_zoo", "/zoo", "--model_def", "mnist.mnist_cnn.custom_model",
        "--training_data", "synthetic://mnist?n=64", "--envs", "A=1;B=two"]
GRID = {
    "plain": BASE,
    "gpu_in_request": BASE + [
        "--worker_resource_request", "cpu=8,memory=16Gi,nvidia.com/gpu=1",
        "--master_resource_request", "cpu=2,memory=4Gi"],
    "k8s_pods": BASE + ["--instance_manager", "k8s",
                        "--master_addr", "localhost:50123",
                        "--relaunch_max", "2"],
    "evaluation_2_workers": BASE + [
        "--job_type", "evaluation_only", "--num_workers", "2",
        "--validation_data", "synthetic://mnist?n=64"],
    "cohort_2": BASE + ["--num_processes", "2"],
    "cohort_4": BASE + ["--num_processes", "4", "--namespace", "ml",
                        "--image_pull_policy", "IfNotPresent"],
}


def case_manifests_equal_the_reference_but_as_named(ref, port):
    for name, argv in GRID.items():
        rcfg = ref.config.JobConfig.from_argv(argv)
        pcfg = port.config.JobConfig.from_argv(argv)
        rcfg.validate()
        pcfg.validate()
        want = [as_port(m) for m in ref.k8s.render_job_manifests(rcfg)]
        got = port.k8s.render_job_manifests(pcfg)
        assert got == want, name
        kinds = [m["kind"] for m in got]
        assert kinds == (["Pod", "Service"] if name == "k8s_pods"
                         else ["Pod", "Service", "Service", "StatefulSet"])
        # the master stays a CPU pod; the workers carry one card
        master = got[0]["spec"]["containers"][0]
        assert "nvidia.com/gpu" not in master["resources"]["requests"]
        assert "limits" not in master["resources"]
        for m in got[2:]:
            if m["kind"] == "StatefulSet":
                c = m["spec"]["template"]["spec"]["containers"][0]
                assert c["resources"]["limits"] == GPU
                assert m["spec"]["replicas"] == max(pcfg.num_processes,
                                                    pcfg.num_workers)
        # a master-managed pod under a generation name
        for wid, pod_name in ((0, ""), (1, "kj-worker-1-g2")):
            want = as_port(ref.k8s.render_worker_pod(rcfg, wid, pod_name))
            got = port.k8s.render_worker_pod(pcfg, wid, pod_name)
            assert got == want, (name, wid)
            assert got["metadata"]["name"] == (pod_name or f"kj-worker-{wid}")
        assert port.k8s.JOB_LABEL == ref.k8s.JOB_LABEL


def case_tpu_type_and_several_cards_are_refused(port):
    for extra, match in ((["--tpu_type", "v5e-4"], "TPU slice"),
                         (["--worker_resource_request",
                           "cpu=4,nvidia.com/gpu=2"], "one card")):
        for flavor in ([], ["--instance_manager", "k8s"]):
            cfg = port.config.JobConfig.from_argv(BASE + flavor + extra)
            with pytest.raises(ValueError, match=match):
                port.k8s.render_job_manifests(cfg)
            with pytest.raises(ValueError, match=match):
                port.k8s.render_worker_pod(cfg, 0)
            with pytest.raises(ValueError, match=match):
                port.k8s.render_worker_statefulset(cfg)


# ---------------------------------------------------------------- manager


def fake_api(m, fail_times=0):
    """Scripted k8s over `m`'s K8sApi: records create/delete calls and
    serves queued events; a stream that dies after each of its first
    `fail_times` events (an apiserver hiccup) when asked."""

    class FakeApi(m.kim.K8sApi):
        def __init__(self):
            self.created, self.deleted = [], []
            self.events = queue.Queue()
            self.fail_times, self.connects = fail_times, 0

        def create_pod(self, manifest):
            self.created.append(manifest)

        def delete_pod(self, name):
            self.deleted.append(name)

        def watch_pods(self, label_selector, stop):
            self.connects += 1
            while not stop.is_set():
                try:
                    ev = self.events.get(timeout=0.05)
                except queue.Empty:
                    continue
                yield ev
                if self.fail_times > 0:
                    self.fail_times -= 1
                    raise RuntimeError("watch stream torn down")

        def push(self, name, phase, type_="MODIFIED"):
            self.events.put(m.kim.PodEvent(type=type_, name=name, phase=phase))

        def created_names(self):
            return [x["metadata"]["name"] for x in self.created]

    return FakeApi()


def wait_for(cond, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return False


def make_cfg(m, **overrides):
    base = dict(job_name="kj", model_def="mnist.mnist_cnn.custom_model",
                num_workers=2, relaunch_max=2, image_name="img:latest",
                job_type="evaluation_only")
    base.update(overrides)
    return m.config.JobConfig(**base)


def setup(m, api=None, **overrides):
    membership = m.membership.Membership(heartbeat_timeout_s=3600)
    dispatcher = m.dispatcher.TaskDispatcher(
        training_shards=[("s", 0, 100)], evaluation_shards=[],
        prediction_shards=[], records_per_task=25, num_epochs=1)
    membership.add_death_callback(dispatcher.recover_tasks)
    cfg = make_cfg(m, **overrides)
    api = api or fake_api(m)
    mgr = m.kim.K8sInstanceManager(cfg, membership=membership, api=api)
    return types.SimpleNamespace(m=m, cfg=cfg, api=api, membership=membership,
                                 dispatcher=dispatcher, mgr=mgr,
                                 PodStatus=m.constants.PodStatus)


def outcome(s, **extra):
    s.mgr._stop.set()
    return {"created": s.api.created, "deleted": list(s.api.deleted),
            "statuses": s.mgr.statuses(), "counts": s.dispatcher.counts(),
            **extra}


def count(api, wid):
    return sum(1 for n in api.created_names()
               if n.startswith(f"kj-worker-{wid}-g"))


def sc_start(m):
    s = setup(m)
    s.mgr.start_workers()
    assert s.api.created_names() == ["kj-worker-0-g0", "kj-worker-1-g0"]
    assert all(x["spec"]["restartPolicy"] == "Never" for x in s.api.created)
    assert all(x["metadata"]["labels"]["role"] == "worker"
               for x in s.api.created)
    return outcome(s)


def sc_pod_failure_without_heartbeat(m):
    s = setup(m)
    s.mgr.start_workers()
    s.membership.register("pod-1", preferred_id=1)
    assert s.dispatcher.get(worker_id=1) is not None
    s.api.push("kj-worker-1-g0", "Failed")
    assert wait_for(lambda: s.dispatcher.counts()["doing"] == 0)
    assert s.dispatcher.counts()["todo"] == 4
    assert wait_for(lambda: "kj-worker-1-g1" in s.api.created_names())
    assert "kj-worker-1-g0" in s.api.deleted
    return outcome(s)


def sc_budget_exhaustion(m):
    s = setup(m)
    s.mgr.start_workers()
    for gen in range(s.cfg.relaunch_max + 1):
        s.api.push(f"kj-worker-0-g{gen}", "Failed")
        wait_for(lambda: f"kj-worker-0-g{gen + 1}" in s.api.created_names()
                 or s.mgr.statuses().get(0) == s.PodStatus.FAILED)
    assert wait_for(lambda: s.mgr.statuses().get(0) == s.PodStatus.FAILED)
    assert count(s.api, 0) == 1 + s.cfg.relaunch_max
    # the lingering Failed pod re-listed on reconnect stays terminal once
    # the job is finished
    while (t := s.dispatcher.get(worker_id=1)) is not None:
        s.dispatcher.report(t.task_id, 1, True)
    assert s.dispatcher.finished()
    s.mgr._job_finished_fn = s.dispatcher.finished
    last = f"kj-worker-0-g{s.cfg.relaunch_max}"
    s.api.push(last, "Failed", type_="ADDED")
    s.api.push(last, "Failed", type_="ADDED")
    time.sleep(0.3)
    assert s.mgr.statuses().get(0) == s.PodStatus.FAILED
    assert count(s.api, 0) == 1 + s.cfg.relaunch_max
    return outcome(s)


def sc_deleted_and_succeeded_are_terminal(m):
    s = setup(m)
    s.mgr.start_workers()
    s.api.push("kj-worker-0-g0", "Running")
    assert wait_for(lambda: s.mgr.statuses().get(0) == s.PodStatus.RUNNING)
    s.api.push("kj-worker-0-g0", "Running", type_="DELETED")
    assert wait_for(lambda: "kj-worker-0-g1" in s.api.created_names())
    s.api.push("kj-worker-1-g0", "Succeeded")
    assert wait_for(lambda: s.mgr.statuses().get(1) == s.PodStatus.SUCCEEDED)
    s.api.push("kj-worker-1-g0", "Succeeded", type_="DELETED")
    time.sleep(0.2)
    assert count(s.api, 1) == 1
    return outcome(s)


def sc_stale_generation_ignored(m):
    s = setup(m)
    s.mgr.start_workers()
    s.api.push("kj-worker-0-g0", "Failed")
    assert wait_for(lambda: "kj-worker-0-g1" in s.api.created_names())
    s.api.push("kj-worker-0-g1", "Running")
    assert wait_for(lambda: s.mgr.statuses().get(0) == s.PodStatus.RUNNING)
    s.api.push("kj-worker-0-g0", "Failed", type_="DELETED")
    time.sleep(0.3)
    assert s.mgr.statuses()[0] == s.PodStatus.RUNNING
    assert "kj-worker-0-g2" not in s.api.created_names()
    return outcome(s)


def sc_add_and_remove(m):
    s = setup(m)
    s.mgr.start_workers()
    wid = s.mgr.add_worker()
    assert wid == 2 and "kj-worker-2-g0" in s.api.created_names()
    s.mgr.remove_worker(2)
    assert "kj-worker-2-g0" in s.api.deleted
    s.api.push("kj-worker-2-g0", "Running", type_="DELETED")
    assert wait_for(lambda: s.mgr.statuses().get(2) == s.PodStatus.DELETED)
    assert count(s.api, 2) == 1 and not s.mgr.all_failed()
    return outcome(s)


def sc_stop_deletes_pods(m):
    s = setup(m)
    s.mgr.start_workers()
    s.mgr.stop(grace_s=1)
    assert set(s.api.deleted) >= {"kj-worker-0-g0", "kj-worker-1-g0"}
    return outcome(s)


def sc_stream_reconnects(m):
    s = setup(m, api=fake_api(m, fail_times=1))
    s.mgr.start_workers()
    s.membership.register("pod-w1", preferred_id=1)
    assert s.dispatcher.get(worker_id=1) is not None
    s.api.push("kj-worker-0-g0", "Running")      # served, then the stream dies
    assert wait_for(lambda: s.api.connects >= 2)
    s.api.push("kj-worker-1-g0", "Failed")       # on the reconnected stream
    assert wait_for(lambda: count(s.api, 1) == 2)
    assert wait_for(lambda: s.dispatcher.counts()["doing"] == 0)
    return outcome(s, connects=s.api.connects)


def sc_relist_is_idempotent(m):
    s = setup(m)
    s.mgr.start_workers()
    for _ in range(3):
        s.api.push("kj-worker-0-g0", "Running", type_="ADDED")
        s.api.push("kj-worker-1-g0", "Running", type_="ADDED")
    assert wait_for(lambda: s.mgr.statuses() == {
        0: s.PodStatus.RUNNING, 1: s.PodStatus.RUNNING})
    time.sleep(0.3)
    assert count(s.api, 0) == 1 and count(s.api, 1) == 1
    assert not s.api.deleted
    return outcome(s)


def sc_plain_training_fleet_cannot_grow(m):
    s = setup(m, job_type="training_with_evaluation", num_workers=1)
    with pytest.raises(RuntimeError, match="cohort"):
        s.mgr.add_worker()
    return outcome(s)


STANDIN_KUBECTL = r'''#!{python}
"""A stand-in kubectl: a watch stream with adversarial segmentation (a
document split mid-way, a multi-byte UTF-8 character split across
writes, two documents in one write)."""
import json, sys, time

w = sys.stdout.buffer


def doc(tp, name, phase, note=None):
    meta = {{"name": name}}
    if note is not None:
        meta["annotations"] = {{"note": note}}
    return json.dumps(
        {{"type": tp, "object": {{"metadata": meta, "status": {{"phase": phase}}}}}},
        ensure_ascii=False).encode("utf-8")


d1 = doc("ADDED", "kj-worker-0-g0", "Pending")
w.write(d1[:10]); w.flush(); time.sleep(0.15)
w.write(d1[10:]); w.flush()
d2 = doc("MODIFIED", "kj-worker-0-g0", "Running", note="héllo")
cut = d2.index("é".encode("utf-8")) + 1
w.write(d2[:cut]); w.flush(); time.sleep(0.15)
w.write(d2[cut:]); w.flush()
w.write(doc("MODIFIED", "kj-worker-1-g0", "Failed")
        + doc("DELETED", "kj-worker-1-g0", "Failed"))
w.flush()
time.sleep(5)
'''


def kubectl_stream(m, script):
    """`KubectlApi.watch_pods` of `m` over the stand-in at `script`."""
    api = m.kim.KubectlApi.__new__(m.kim.KubectlApi)
    api._ns, api._kubectl, api._watch_procs = "default", str(script), []
    stop = threading.Event()
    events = []
    for ev in api.watch_pods("app=kj", stop):
        events.append((ev.type, ev.name, ev.phase))
        if len(events) == 4:
            stop.set()
    api.close()
    assert not api._watch_procs
    return events


SCENARIOS = (
    sc_start, sc_pod_failure_without_heartbeat, sc_budget_exhaustion,
    sc_deleted_and_succeeded_are_terminal, sc_stale_generation_ignored,
    sc_add_and_remove, sc_stop_deletes_pods, sc_stream_reconnects,
    sc_relist_is_idempotent, sc_plain_training_fleet_cannot_grow,
)


def case_manager_copy_runs_as_the_reference(ref, port, tmp):
    """Each scenario once a package, both at once (two threads: the
    watch-driven waits overlap)."""
    results, errors = {}, []

    def run(side, m):
        try:
            results[side] = [scenario(m) for scenario in SCENARIOS]
        except BaseException as e:
            errors.append((side, e))

    threads = [threading.Thread(target=run, args=a)
               for a in (("ref", ref), ("port", port))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    if errors:
        raise errors[0][1]
    assert set(results) == {"ref", "port"}, results.keys()
    for scenario, want, got in zip(SCENARIOS, results["ref"],
                                   results["port"]):
        want = dict(want, created=[as_port(x) for x in want["created"]])
        assert got == want, scenario.__name__
    script = tmp / "kubectl"
    script.write_text(STANDIN_KUBECTL.format(python=sys.executable))
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    want = kubectl_stream(ref, script)
    assert want == [("ADDED", "kj-worker-0-g0", "Pending"),
                    ("MODIFIED", "kj-worker-0-g0", "Running"),
                    ("MODIFIED", "kj-worker-1-g0", "Failed"),
                    ("DELETED", "kj-worker-1-g0", "Failed")]
    assert kubectl_stream(port, script) == want


# ---------------------------------------------------------------- master

MNIST_PACKAGES = ("mnist",)


@contextlib.contextmanager
def zoo(root):
    """Both zoos name the module `mnist.mnist_cnn`: the port's master
    loads it with `root` first on sys.path and the other zoo's cached
    modules set aside."""
    def ours(k):
        return k.split(".")[0] in MNIST_PACKAGES

    saved = {k: sys.modules.pop(k) for k in [k for k in sys.modules
                                             if ours(k)]}
    path = list(sys.path)
    try:
        sys.path.insert(0, root)
        yield
    finally:
        for k in [k for k in sys.modules if ours(k)]:
            del sys.modules[k]
        sys.modules.update(saved)
        sys.path[:] = path


def case_master_owns_the_pods(port, tmp):
    from elasticdl_tpu_torch.common.net import free_port
    from elasticdl_tpu_torch.master.autoscaler import K8sInstanceTarget
    from elasticdl_tpu_torch.master.main import Master

    def cfg(**kw):
        return make_cfg(
            port, instance_manager="k8s", job_name="kmj", model_zoo=TZOO,
            validation_data="synthetic://mnist?n=100&shards=1",
            records_per_task=25, master_addr=f"localhost:{free_port()}",
            **kw)

    c = cfg()
    kinds = [(m["kind"], m["metadata"]["name"])
             for m in port.k8s.render_job_manifests(c)]
    assert kinds == [("Pod", "kmj-master"), ("Service", "kmj-master")]
    args = port.k8s.render_job_manifests(c)[0]["spec"]["containers"][0]["args"]
    assert args[args.index("--instance_manager") + 1] == "k8s"

    api = fake_api(port)
    with zoo(TZOO):
        master = Master(c, k8s_api=api)
    master.start()
    try:
        assert master.instance_manager is not None
        assert master.autoscaler is None
        assert api.created_names() == ["kmj-worker-0-g0", "kmj-worker-1-g0"]
        master.membership.register("pod-1", preferred_id=1)
        assert master.dispatcher.get(worker_id=1) is not None
        api.push("kmj-worker-1-g0", "Failed")
        assert wait_for(lambda: master.dispatcher.counts()["doing"] == 0)
        assert wait_for(lambda: "kmj-worker-1-g1" in api.created_names())
    finally:
        master.shutdown(grace_s=0.2)
        master.server.stop(0)
    assert any(n.startswith("kmj-worker-0") for n in api.deleted)
    # the manager's pods are the port's
    assert all(x["spec"]["containers"][0]["command"][-1]
               == "elasticdl_tpu_torch.worker.main" for x in api.created)

    api = fake_api(port)
    with zoo(TZOO):
        # the autoscaler journals its decisions under the checkpoint dir
        master = Master(cfg(autoscale=True,
                            checkpoint_dir=str(tmp / "autoscale")),
                        k8s_api=api)
    master.start()
    try:
        assert isinstance(master.autoscaler._target, K8sInstanceTarget)
        assert master.autoscaler._target._manager is master.instance_manager
    finally:
        master.shutdown(grace_s=0.2)
        master.server.stop(0)


# ---------------------------------------------------------------- cohort


def case_hostname_ordinal_is_the_process_id(port):
    from elasticdl_tpu_torch.common import runtime
    from elasticdl_tpu_torch.parallel.elastic import context_from_env

    saved = {k: os.environ.get(k) for k in COHORT_ENV}
    hostname = socket.gethostname
    try:
        for k in COHORT_ENV:
            os.environ.pop(k, None)
        os.environ["EDL_PROCESS_ID_FROM_HOSTNAME"] = "1"
        os.environ["EDL_COORDINATOR_ADDR"] = "kj-worker-0.kj-worker:8471"
        socket.gethostname = lambda: "kj-worker-2"
        ctx = context_from_env(make_cfg(port, num_processes=4))
        assert (ctx.process_id, ctx.num_processes) == (2, 4)
        assert ctx.coordinator_addr == "kj-worker-0.kj-worker:8471"
        os.environ.pop("EDL_PROCESS_ID")
        socket.gethostname = lambda: "nodigit"
        with pytest.raises(RuntimeError, match="no trailing ordinal"):
            context_from_env(make_cfg(port, num_processes=4))
    finally:
        socket.gethostname = hostname
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    assert {k: os.environ.get(k) for k in COHORT_ENV} == saved
    # the card a StatefulSet pod names is a request: a pod without its
    # card fails, it never trains on the CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is unavailable"):
            runtime.cohort_device(2, "cuda:0")


# ---------------------------------------------------------------- the CLI


@contextlib.contextmanager
def bare_path(tmp):
    """PATH holding one empty directory: no kubectl, no docker."""
    empty = tmp / "empty-path"
    empty.mkdir(exist_ok=True)
    saved = os.environ.get("PATH", "")
    os.environ["PATH"] = str(empty)
    try:
        yield
    finally:
        os.environ["PATH"] = saved


def case_cli_prints_the_manifests_without_kubectl(port, tmp):
    from elasticdl_tpu_torch.client import main as client_main

    for argv in (GRID["plain"], GRID["k8s_pods"], GRID["cohort_2"]):
        out = io.StringIO()
        with bare_path(tmp), contextlib.redirect_stdout(out):
            assert client_main.main(["train", *argv]) == 0
        docs = list(yaml.safe_load_all(out.getvalue()))
        assert docs == port.k8s.render_job_manifests(
            port.config.JobConfig.from_argv(argv))


# ---------------------------------------------------------------- the zoo

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "elasticdl_tpu")


def load_file(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def case_zoo_template_matches_the_reference(ref, port, tmp):
    import jax
    import jax.numpy as jnp
    import optax

    from elasticdl_tpu_torch.client import main as client_main
    from elasticdl_tpu_torch.training import metrics

    rdir, pdir = tmp / "ref_zoo", tmp / "port_zoo"
    assert ref.zoo.init(str(rdir)) == 0
    assert client_main.main(["zoo", "init", "--model_zoo", str(pdir)]) == 0
    template = pdir / "my_model.py"
    tree = ast.parse(template.read_text())
    imported = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names] + [
        n.module for n in ast.walk(tree)
        if isinstance(n, ast.ImportFrom) and n.module]
    assert imported and not [i for i in imported
                             if i.split(".")[0] in FORBIDDEN], imported
    assert (pdir / "Dockerfile").read_text().startswith(
        f"FROM {port.zoo.BASE_IMAGE}\n")
    rmod = load_file(rdir / "my_model.py", "ref_zoo_my_model")
    pmod = load_file(template, "port_zoo_my_model")

    rng = np.random.RandomState(0)
    d = 8
    x = rng.randn(16, d).astype(np.float32)
    labels = rng.randint(0, 2, size=(16,)).astype(np.int32)

    rmodel = rmod.custom_model()
    variables = jax.jit(rmodel.init)(jax.random.PRNGKey(0), jnp.asarray(x))

    def ref_loss(variables):
        out = rmodel.apply(variables, jnp.asarray(x))
        return jnp.mean(rmod.loss(labels, out)), out

    tx = rmod.optimizer()

    @jax.jit
    def ref_step(variables):
        # one program: eager JAX on the CPU compiles op by op
        (loss, out), grads = jax.value_and_grad(ref_loss, has_aux=True)(
            variables)
        updates, _ = tx.update(grads, tx.init(variables), variables)
        return loss, out, optax.apply_updates(variables, updates)

    rloss, rout, rnew = ref_step(variables)
    rnew = rnew["params"]["Dense_0"]

    kernel = np.asarray(variables["params"]["Dense_0"]["kernel"])
    bias = np.asarray(variables["params"]["Dense_0"]["bias"])
    pmodel = pmod.custom_model(input_dim=d)
    with torch.no_grad():
        pmodel.Dense_0.weight.copy_(torch.from_numpy(kernel.T.copy()))
        pmodel.Dense_0.bias.copy_(torch.from_numpy(bias.copy()))
    pout = pmodel(torch.from_numpy(x), training=True)
    ploss = pmod.loss(torch.from_numpy(labels), pout).mean()
    np.testing.assert_allclose(pout.detach().numpy(), np.asarray(rout), **TOL)
    np.testing.assert_allclose(float(ploss.detach()), float(rloss), **TOL)
    opt = pmod.optimizer()(list(pmodel.parameters()))
    ploss.backward()
    opt.step()
    assert isinstance(opt, torch.optim.Adam)
    assert opt.param_groups[0]["lr"] == 1e-3
    np.testing.assert_allclose(pmodel.Dense_0.weight.detach().numpy().T,
                               np.asarray(rnew["kernel"]), **TOL)
    np.testing.assert_allclose(pmodel.Dense_0.bias.detach().numpy(),
                               np.asarray(rnew["bias"]), **TOL)
    assert isinstance(pmod.eval_metrics_fn()["accuracy"], metrics.Accuracy)
    for mod in (rmod, pmod):
        with pytest.raises(NotImplementedError):
            mod.dataset_fn("training", None)


def case_zoo_build_without_docker(ref, port, tmp):
    rcs = {}
    with bare_path(tmp):
        for side, m in (("ref", ref), ("port", port)):
            d = tmp / f"{side}_build"
            d.mkdir()
            rcs[side] = (m.zoo.build(str(d), "img:1", "base:1"),
                         (d / "Dockerfile").read_text(),
                         m.zoo.push("img:1"))
        d = tmp / "port_build_default"
        d.mkdir()
        assert port.zoo.main(["build", "--model_zoo", str(d),
                              "--image", "img:1"]) == 1
    assert rcs["port"] == rcs["ref"]
    assert rcs["port"][0] == 1 and rcs["port"][2] == 1
    assert (d / "Dockerfile").read_text().startswith(
        f"FROM {port.zoo.BASE_IMAGE}\n")


def test_k8s_and_zoo_against_the_reference(tmp_path):
    """Every case above, in one collected test (ROADMAP.md, conventions:
    one collected test per port test file)."""
    ref, port = modules("elasticdl_tpu"), modules("elasticdl_tpu_torch")
    case_manifests_equal_the_reference_but_as_named(ref, port)
    case_tpu_type_and_several_cards_are_refused(port)
    case_manager_copy_runs_as_the_reference(ref, port, tmp_path)
    case_master_owns_the_pods(port, tmp_path)
    case_hostname_ordinal_is_the_process_id(port)
    case_cli_prints_the_manifests_without_kubectl(port, tmp_path)
    case_zoo_template_matches_the_reference(ref, port, tmp_path)
    case_zoo_build_without_docker(ref, port, tmp_path)
