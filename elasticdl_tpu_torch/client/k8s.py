"""Kubernetes submission: render and submit the job for GPU nodes.

Counterpart of `elasticdl_tpu/client/k8s.py`, with its functions, names,
labels, ports, environment, restart policies and argv re-serialisation
(`JobConfig.to_argv`), so that a label selector or `delete_job` works the
same on both. Two things differ:

- the module each pod runs: `elasticdl_tpu_torch.master.main` and
  `elasticdl_tpu_torch.worker.main`;
- the accelerator block. A port worker drives one card
  (`common/runtime.cohort_device`), so every worker pod, master-managed
  or in the StatefulSet, requests and limits `nvidia.com/gpu: "1"` beside
  `--worker_resource_request`; a request naming `nvidia.com/gpu` at any
  other count raises `ValueError`, and so does a `--tpu_type` (a TPU
  slice names no GPU node, and the manifests carry no
  `cloud.google.com/gke-tpu-*` selector). A cohort member of the
  StatefulSet finds its one card at `cuda:0` whatever its ordinal, so its
  pod names that card (`EDL_TORCH_DEVICE=cuda:0`), where a host that runs
  every member would give member i the card `cuda:<i>`.

The master stays a plain CPU pod serving the task queue, as in the
reference. The default flavour renders the workers as one headless-service
StatefulSet; `--instance_manager k8s` renders only the master, which then
creates, watches and relaunches worker pods itself
(`master/k8s_instance_manager.py`).

`submit` applies the manifests (YAML, as the reference writes them) with
kubectl when it is on PATH, else prints them.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from typing import Any, Dict, List

import yaml

from elasticdl_tpu_torch.common.config import JobConfig
from elasticdl_tpu_torch.common.constants import DEFAULT_MASTER_PORT, WorkerEnv
from elasticdl_tpu_torch.common.log_utils import default_logger

logger = default_logger(__name__)

JOB_LABEL = "elasticdl-tpu-job-name"
# the extended resource the NVIDIA device plugin advertises; one a worker
GPU_RESOURCE = "nvidia.com/gpu"
# the device a cohort member of the StatefulSet names, its pod's one card
# (worker/main.DEVICE_ENV; that module imports torch, this one need not)
DEVICE_ENV = "EDL_TORCH_DEVICE"


def _parse_resources(spec: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for item in spec.split(","):
        if "=" in item:
            k, v = item.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def _env_list(cfg: JobConfig, extra: Dict[str, str]) -> List[Dict[str, str]]:
    env = {str(k): str(v) for k, v in cfg.envs.items()}
    env.update(extra)
    return [{"name": k, "value": v} for k, v in env.items()]


def render_master_pod(cfg: JobConfig) -> Dict[str, Any]:
    port = int(cfg.master_addr.rsplit(":", 1)[1]) if ":" in cfg.master_addr else DEFAULT_MASTER_PORT
    master_name = f"{cfg.job_name}-master"
    args = cfg.replace(master_addr=f"0.0.0.0:{port}").to_argv()
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "name": master_name,
            "namespace": cfg.namespace,
            "labels": {JOB_LABEL: cfg.job_name, "app": "elasticdl-tpu", "role": "master"},
        },
        "spec": {
            "restartPolicy": cfg.restart_policy,
            "containers": [
                {
                    "name": "master",
                    "image": cfg.image_name,
                    "imagePullPolicy": cfg.image_pull_policy,
                    "command": ["python", "-m", "elasticdl_tpu_torch.master.main"],
                    "args": args,
                    "ports": [{"containerPort": port, "name": "grpc"}],
                    "resources": {
                        "requests": _parse_resources(cfg.master_resource_request)
                    },
                    "env": _env_list(cfg, {}),
                }
            ],
        },
    }


def render_master_service(cfg: JobConfig) -> Dict[str, Any]:
    port = int(cfg.master_addr.rsplit(":", 1)[1]) if ":" in cfg.master_addr else DEFAULT_MASTER_PORT
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {
            "name": f"{cfg.job_name}-master",
            "namespace": cfg.namespace,
            "labels": {JOB_LABEL: cfg.job_name},
        },
        "spec": {
            "selector": {JOB_LABEL: cfg.job_name, "role": "master"},
            "ports": [{"port": port, "targetPort": port, "name": "grpc"}],
        },
    }


def _gpu_resources(cfg: JobConfig) -> Dict[str, str]:
    """The worker pods' resources, for both flavors: the request plus one
    card, the device a port worker drives. No node selector: the device
    plugin's resource places the pod."""
    if cfg.tpu_type:
        raise ValueError(
            f"tpu_type={cfg.tpu_type!r} names a TPU slice; the port's "
            f"worker pods run on GPU nodes ({GPU_RESOURCE}: 1 each)"
        )
    resources = _parse_resources(cfg.worker_resource_request)
    if resources.get(GPU_RESOURCE, "1") != "1":
        raise ValueError(
            f"a worker drives one card: {GPU_RESOURCE}="
            f"{resources[GPU_RESOURCE]} in --worker_resource_request, "
            "expected 1 (scale out with --num_processes or --num_workers)"
        )
    resources[GPU_RESOURCE] = "1"
    return resources


def render_worker_statefulset(cfg: JobConfig) -> List[Dict[str, Any]]:
    """Workers as a StatefulSet over GPU nodes, one card a pod."""
    name = f"{cfg.job_name}-worker"
    master_svc = f"{cfg.job_name}-master"
    port = int(cfg.master_addr.rsplit(":", 1)[1]) if ":" in cfg.master_addr else DEFAULT_MASTER_PORT
    worker_cfg = cfg.replace(master_addr=f"{master_svc}:{port}")
    args = worker_cfg.to_argv()

    resources = _gpu_resources(cfg)
    replicas = cfg.num_workers
    extra_env = {"EDL_COORDINATOR_ADDR": f"{name}-0.{name}:8471"}
    if cfg.num_processes > 1:
        # a multi-process cohort: one replica per cohort process, ids from
        # StatefulSet ordinals — without this the world has no process ids
        # and never forms. Each pod's one card is its cuda:0.
        replicas = cfg.num_processes
        extra_env["EDL_PROCESS_ID_FROM_HOSTNAME"] = "1"
        extra_env[DEVICE_ENV] = "cuda:0"

    headless = {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {
            "name": name,
            "namespace": cfg.namespace,
            "labels": {JOB_LABEL: cfg.job_name},
        },
        "spec": {
            "clusterIP": "None",
            "selector": {JOB_LABEL: cfg.job_name, "role": "worker"},
            "ports": [{"port": 8471, "name": "coordinator"}],
        },
    }
    sts = {
        "apiVersion": "apps/v1",
        "kind": "StatefulSet",
        "metadata": {
            "name": name,
            "namespace": cfg.namespace,
            "labels": {JOB_LABEL: cfg.job_name},
        },
        "spec": {
            "serviceName": name,
            "replicas": replicas,
            "selector": {
                "matchLabels": {JOB_LABEL: cfg.job_name, "role": "worker"}
            },
            "template": {
                "metadata": {
                    "labels": {
                        JOB_LABEL: cfg.job_name,
                        "app": "elasticdl-tpu",
                        "role": "worker",
                    }
                },
                "spec": {
                    "nodeSelector": {},
                    "containers": [
                        {
                            "name": "worker",
                            "image": cfg.image_name,
                            "imagePullPolicy": cfg.image_pull_policy,
                            "command": ["python", "-m", "elasticdl_tpu_torch.worker.main"],
                            "args": args,
                            "resources": {"requests": resources, "limits": {
                                k: v for k, v in resources.items()
                                if k == GPU_RESOURCE
                            }},
                            "env": _env_list(worker_cfg, extra_env),
                        }
                    ],
                },
            },
        },
    }
    return [headless, sts]


def render_worker_pod(
    cfg: JobConfig, worker_id: int, pod_name: str = "",
) -> Dict[str, Any]:
    """One master-managed worker pod (the instance manager's create_worker:
    pods created/relaunched one by one by the master, unlike the
    StatefulSet flavor where k8s owns replacement). Used by
    master/k8s_instance_manager.py, which passes generation-suffixed
    `pod_name`s so relaunches are new pod objects; restartPolicy=Never
    because relaunch accounting lives in the manager's budget, not the
    kubelet."""
    master_svc = f"{cfg.job_name}-master"
    port = int(cfg.master_addr.rsplit(":", 1)[1]) if ":" in cfg.master_addr else DEFAULT_MASTER_PORT
    worker_cfg = cfg.replace(master_addr=f"{master_svc}:{port}")
    resources = _gpu_resources(cfg)
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "name": pod_name or f"{cfg.job_name}-worker-{worker_id}",
            "namespace": cfg.namespace,
            "labels": {
                JOB_LABEL: cfg.job_name,
                "app": "elasticdl-tpu",
                "role": "worker",
            },
        },
        "spec": {
            "restartPolicy": "Never",
            "nodeSelector": {},
            "containers": [
                {
                    "name": "worker",
                    "image": cfg.image_name,
                    "imagePullPolicy": cfg.image_pull_policy,
                    "command": ["python", "-m", "elasticdl_tpu_torch.worker.main"],
                    "args": worker_cfg.to_argv(),
                    "resources": {"requests": resources, "limits": {
                        k: v for k, v in resources.items()
                        if k == GPU_RESOURCE
                    }},
                    "env": _env_list(
                        worker_cfg, {WorkerEnv.WORKER_ID: str(worker_id)}
                    ),
                }
            ],
        },
    }


def render_job_manifests(cfg: JobConfig) -> List[Dict[str, Any]]:
    """Two worker-deployment flavors: the default renders workers as a
    StatefulSet (k8s owns replacement); --instance_manager=k8s renders
    ONLY the master, which then creates/watches/relaunches worker pods
    itself through master/k8s_instance_manager.py (the flag rides to the
    master through the pod args via to_argv). Either flavor refuses a
    TPU slice or a worker request of several cards here, at submission,
    not when the master first creates a pod."""
    _gpu_resources(cfg)
    manifests = [render_master_pod(cfg), render_master_service(cfg)]
    if cfg.instance_manager != "k8s":
        manifests += render_worker_statefulset(cfg)
    return manifests


def submit(cfg: JobConfig) -> int:
    manifests = render_job_manifests(cfg)
    doc = yaml.safe_dump_all(manifests, sort_keys=False)
    kubectl = shutil.which("kubectl")
    if kubectl is None:
        logger.warning("kubectl not found; printing manifests to stdout")
        sys.stdout.write(doc)
        return 0
    proc = subprocess.run(
        [kubectl, "-n", cfg.namespace, "apply", "-f", "-"],
        input=doc.encode(),
        capture_output=True,
    )
    sys.stdout.write(proc.stdout.decode())
    sys.stderr.write(proc.stderr.decode())
    return proc.returncode


def delete_job(cfg: JobConfig) -> int:
    kubectl = shutil.which("kubectl")
    if kubectl is None:
        logger.error("kubectl not found")
        return 1
    proc = subprocess.run(
        [
            kubectl, "-n", cfg.namespace, "delete",
            "pod,service,statefulset", "-l", f"{JOB_LABEL}={cfg.job_name}",
        ],
        capture_output=True,
    )
    sys.stdout.write(proc.stdout.decode())
    return proc.returncode
