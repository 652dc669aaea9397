"""Framework-wide constants.

Reference parity: elasticdl/python/common/constants.py (GRPC message sizes,
pod/label names, checkpoint dir layout).
"""


class GRPC:
    # Embedding pulls and dense model pushes can be large; match the
    # reference's practice of raising the default 4 MB gRPC cap.
    MAX_SEND_MESSAGE_LENGTH = 256 * 1024 * 1024
    MAX_RECEIVE_MESSAGE_LENGTH = 256 * 1024 * 1024
    OPTIONS = [
        ("grpc.max_send_message_length", MAX_SEND_MESSAGE_LENGTH),
        ("grpc.max_receive_message_length", MAX_RECEIVE_MESSAGE_LENGTH),
    ]


class TaskType:
    """Task types leased by the master to workers.

    Reference parity: elasticdl.proto's TaskType enum
    (TRAINING / EVALUATION / PREDICTION / SAVE_MODEL / WAIT).
    """

    TRAINING = "training"
    EVALUATION = "evaluation"
    PREDICTION = "prediction"
    SAVE_MODEL = "save_model"
    WAIT = "wait"


class JobType:
    TRAINING_ONLY = "training_only"
    TRAINING_WITH_EVALUATION = "training_with_evaluation"
    EVALUATION_ONLY = "evaluation_only"
    PREDICTION_ONLY = "prediction_only"


class PodStatus:
    """Lifecycle states of a managed worker instance.

    Mirrors the k8s pod phases the reference's instance manager watches
    (reference: elasticdl/python/master/k8s_instance_manager.py).
    """

    PENDING = "pending"
    RUNNING = "running"
    SUCCEEDED = "succeeded"
    FAILED = "failed"
    DELETED = "deleted"


class WorkerEnv:
    """Environment variables the launcher sets on each worker process."""

    WORKER_ID = "EDL_WORKER_ID"
    MASTER_ADDR = "EDL_MASTER_ADDR"
    NUM_WORKERS = "EDL_NUM_WORKERS"
    COORDINATOR_ADDR = "EDL_COORDINATOR_ADDR"


class ExitCode:
    """Worker exit codes the process manager keys recovery decisions on."""

    OK = 0
    # EX_TEMPFAIL: evicted/preempted mid-job — relaunch me
    COHORT_EVICTED = 75
    # jax.distributed world never formed (e.g. coordinator-port TOCTOU);
    # an infrastructure failure that must not consume the relaunch budget
    WORLD_FORM_FAILED = 76


class MeshAxis:
    """Canonical mesh axis names for every sharding in the framework."""

    DATA = "data"   # batch dimension; DP gradient psum rides this axis
    MODEL = "model"  # embedding-table rows / any model-parallel dim
    SEQ = "seq"     # sequence/context parallelism (ring / Ulysses attention)
    PIPE = "pp"     # pipeline parallelism (GPipe microbatch streaming)
    EXPERT = "expert"  # expert parallelism (MoE all_to_all dispatch)


DEFAULT_MASTER_PORT = 50001

# TPU accelerator type → (gke accelerator label, topology, hosts, chips/host).
# Lives here (not client/k8s.py) so config validation can reason about slice
# shape without importing the client layer.
TPU_TYPES = {
    "v5e-4": ("tpu-v5-lite-podslice", "2x2", 1, 4),
    "v5e-8": ("tpu-v5-lite-podslice", "2x4", 2, 4),
    "v5e-16": ("tpu-v5-lite-podslice", "4x4", 4, 4),
    "v5e-32": ("tpu-v5-lite-podslice", "4x8", 8, 4),
    "v5e-64": ("tpu-v5-lite-podslice", "8x8", 16, 4),
    "v5p-8": ("tpu-v5p-slice", "2x2x1", 2, 4),
    "v4-8": ("tpu-v4-podslice", "2x2x1", 2, 4),
}
