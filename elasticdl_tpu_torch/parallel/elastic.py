"""Multi-process distributed context: one `torch.distributed` world across
worker processes, with re-formation as the unit of elastic recovery.

Counterpart of `elasticdl_tpu/parallel/elastic.py`. The reference forms a
`jax.distributed` world and one global mesh over every process's devices;
here each member process drives one device and joins a process group
(NCCL on the card, gloo on the CPU), and `parallel/mesh.py` lays the ranks
out on named axes. The world is static once formed, so elasticity is
re-formation: the process manager tears the world down, relaunches it,
and the new world restores from the latest checkpoint at a task boundary.

The cohort's control protocol (the leader's control vector, the member
stats) runs over a second, gloo group on host tensors, so it never waits
on the card. Torch carries int64 end to end, so the reference's int32
halving of the wire is not needed.

Every member holds the whole global host batch (readers are
deterministic), and the trainer takes the rank's block of it
(`mesh.shard_batch`): the reference's `make_global_batch` and
`make_global_batch_stack`, which assemble a global array from the same
slices, have no counterpart.

`stage_leaf` and `reshard_state` are the staged lane of a handoff, which
the embedding tier's shard migrations ride (`embedding/reshard.py`): a
leaf is pulled to host numpy, then laid onto the new mesh's device. The
port's mesh has no sharded layout for such a leaf, so it is replicated on
the rank's device.

Not ported, by design: `neighbor_world_sizes` and `LiveStateHandoff`,
the in-place rescale's handoff (ROADMAP item 32, under "Differences of
design": a port process drives one card, and a cohort re-forms through
the instance manager).
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from elasticdl_tpu_torch.common.log_utils import default_logger

logger = default_logger(__name__)

# How long a member waits for the rest of the world to form and, after
# that, for a peer in a collective. A member that never joins ends the
# others in an error, not a hang; a dead peer's survivors are killed by
# the process manager long before.
FORM_TIMEOUT_S = 300.0


class CohortContext:
    """The per-process handle on the distributed world.

    `device` is the member's device: NCCL for a CUDA device, gloo for the
    CPU (None: the CPU)."""

    def __init__(self, coordinator_addr: str, num_processes: int,
                 process_id: int, world_version: int = 0,
                 device: Optional[torch.device] = None):
        self.coordinator_addr = coordinator_addr
        self.num_processes = num_processes
        self.process_id = process_id
        self.world_version = world_version
        self.device = torch.device(device or "cpu")
        self._ctrl = None
        self._initialized = False

    # ------------------------------------------------------------------ #

    def initialize(self, timeout_s: float = FORM_TIMEOUT_S) -> None:
        """`init_process_group` at tcp://<coordinator>, collective: blocks
        until every process of the world has joined, or raises after
        `timeout_s`. Then the gloo group the control protocol rides."""
        kwargs = {}
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
            kwargs["device_id"] = self.device
        dist.init_process_group(
            self.backend, init_method=f"tcp://{self.coordinator_addr}",
            world_size=self.num_processes, rank=self.process_id,
            timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
        self._initialized = True
        self._ctrl = (dist.group.WORLD if self.backend == "gloo"
                      else dist.new_group(backend="gloo"))
        logger.info(
            "distributed world v%d up: process %d/%d, %d global devices "
            "(backend %s, device %s)",
            self.world_version, self.process_id, self.num_processes,
            dist.get_world_size(), self.backend, self.device,
        )

    def shutdown(self) -> None:
        if self._initialized:
            dist.destroy_process_group()
            self._ctrl = None
            self._initialized = False

    @property
    def is_leader(self) -> bool:
        return self.process_id == 0

    @property
    def backend(self) -> str:
        return "nccl" if self.device.type == "cuda" else "gloo"

    # ------------------------------------------------------------------ #

    def broadcast_ints(self, values: Sequence[int]) -> np.ndarray:
        """Leader -> all: a small int64 control vector (the cohort's task,
        checkpoint and LR protocol rides it), over the gloo group."""
        arr = torch.as_tensor(np.asarray(values, np.int64))
        if self._ctrl is not None and self.num_processes > 1:
            dist.broadcast(arr, src=0, group=self._ctrl)
        return arr.numpy()

    def allgather_ints(self, values: Sequence[int]) -> np.ndarray:
        """All -> all: every process contributes an int64 row of one
        length, every process gets the (num_processes, len) stack — the
        follower -> leader telemetry channel. COLLECTIVE."""
        arr = torch.as_tensor(np.asarray(values, np.int64))
        if self._ctrl is None or self.num_processes == 1:
            return arr.numpy()[None, :]
        out = torch.empty((self.num_processes, arr.numel()), dtype=torch.int64)
        dist.all_gather_into_tensor(out, arr[None, :], group=self._ctrl)
        return out.numpy()

    def barrier(self) -> None:
        if self._ctrl is not None and self.num_processes > 1:
            dist.barrier(group=self._ctrl)


def context_from_env(cfg) -> Optional[CohortContext]:
    """Build the context for this process from config + env (the process
    manager exports EDL_PROCESS_ID per spawned cohort member).

    `EDL_NUM_PROCESSES` overrides `cfg.num_processes`: dynamic world
    resizing re-forms the cohort at a DIFFERENT size than the config's
    original — the manager tells each member the new world size through the
    environment so the argv (which is the job's immutable config) stays
    untouched. `EDL_WORLD_VERSION` carries the generation counter for logs
    and LR-rescale decisions. A resized-to-1 cohort is still a cohort
    (EDL_PROCESS_ID present), so the override may legitimately be 1.
    """
    n = int(os.environ.get("EDL_NUM_PROCESSES", "0") or 0) or cfg.num_processes
    if n <= 1 and "EDL_PROCESS_ID" not in os.environ:
        return None
    if (
        "EDL_PROCESS_ID" not in os.environ
        and os.environ.get("EDL_PROCESS_ID_FROM_HOSTNAME") == "1"
    ):
        # k8s StatefulSet flavor: pods are <name>-<ordinal>; the ordinal IS
        # the cohort process id (stable across pod restarts)
        import socket

        host = socket.gethostname()
        ordinal = host.rsplit("-", 1)[-1]
        if ordinal.isdigit():
            os.environ["EDL_PROCESS_ID"] = ordinal
        else:
            raise RuntimeError(
                f"EDL_PROCESS_ID_FROM_HOSTNAME=1 but hostname {host!r} has "
                "no trailing ordinal"
            )
    pid = int(os.environ.get("EDL_PROCESS_ID", "0"))
    addr = (
        os.environ.get("EDL_COORDINATOR_ADDR")
        or cfg.coordinator_addr
        or "localhost:29400"
    )
    version = int(os.environ.get("EDL_WORLD_VERSION", "0") or 0)
    return CohortContext(addr, n, pid, world_version=version)


# ---------------------------------------------------------------------- #
# the staged lane of a state handoff


class _HostStaged:
    """A leaf pulled to host numpy, with the layout it had (`spec`; the
    port lays every staged leaf out replicated)."""

    __slots__ = ("array", "spec")

    def __init__(self, array, spec):
        self.array = array
        self.spec = spec


def stage_leaf(x, spec=None) -> _HostStaged:
    """Pull one tensor or ndarray to host numpy for the staged half of a
    handoff. `spec` defaults to replicated, `()`."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return _HostStaged(np.asarray(x), spec if spec is not None else ())


def _mesh_device(mesh) -> torch.device:
    """The device a leaf lands on under `mesh`: a device or device name
    as given; for a `parallel.mesh.Mesh`, this rank's card where the
    world runs NCCL, else the CPU."""
    if isinstance(mesh, (str, torch.device)):
        return torch.device(mesh)
    if (dist.is_available() and dist.is_initialized()
            and dist.get_backend() == "nccl"):
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def reshard_state(state: Any, new_mesh) -> Any:
    """Lay a staged leaf, or a tree (dicts, lists, tuples) of tensors and
    staged leaves, onto `new_mesh`'s device (`_mesh_device`), replicated.
    A tensor already there passes through; other leaves are untouched."""
    device = _mesh_device(new_mesh)

    def move(x):
        if isinstance(x, _HostStaged):
            return torch.from_numpy(np.array(x.array, copy=True)).to(device)
        if isinstance(x, torch.Tensor):
            return x if x.device == device else x.to(device)
        if isinstance(x, dict):
            return {k: move(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(move(v) for v in x)
        return x

    return move(state)
