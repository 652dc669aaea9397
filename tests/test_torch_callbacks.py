"""Zoo callbacks in the port against the reference's: the twins of
`tests/test_callbacks.py:96, 116, 175`, and a small job in which the
callbacks' pushes land in the worker's optimizer.

`api/callbacks.py` is a copy (`tests/test_torch_copies.py`); what is the
port's is the optimizer that carries the pushed learning rate, the master
that wires a zoo's `callbacks()`, and the worker that applies the push.

- Runtime LR (reference 96): every port zoo optimizer but ResNet-50's
  `WarmupCosineSGD` carries a learning rate that
  `lr_modulation.get/set_learning_rate` read and write in its param
  groups, equal to the reference optax state's (rtol 1e-7: the reference
  stores it in float32); ResNet-50's has none, on both sides.
- `JobContext.stop_training` (reference 116) drops the queued training
  tasks of the port's dispatcher as of the reference's: equal counts
  before and after, and the job finishes once the leased task reports.
- The master's wiring (reference 175): a zoo module written to a temp
  directory (flax for the reference, torch for the port) whose
  `callbacks()` returns `EarlyStopping(monitor="accuracy", patience=1)`
  and `ReduceLROnPlateau(initial_lr=0.1, monitor="accuracy",
  patience=1)`; two non-improving eval jobs reported through each
  master's evaluation service stop training (no training task left
  queued) and push 0.05, which a registered worker's heartbeat carries,
  on both sides alike.
- The job: the port's Master and Worker (a thread, on the CPU) run DeepFM
  (`field_vocab=64;hidden=16,16`) through a zoo module that takes the
  port's DeepFM and adds `ReduceLROnPlateau(initial_lr=1e-3,
  monitor="auc", patience=1, min_delta=1.0, min_lr=5e-4)` and
  `EarlyStopping(monitor="auc", patience=3, min_delta=1.0)` (no eval can
  improve the AUC by 1, so the plateau is certain, and the floor makes
  the one reduction the last), with an eval job every 2 steps: the
  second eval pushes 5e-4, which lands in every param group of the
  worker's Adam at its next task boundary (heartbeats every 0.05 s, two
  more evals before the stop); the fourth stops training with
  EarlyStopping's reason in the dispatcher's stop line; fewer training
  tasks finish than the data holds, and none fails.
"""

import dataclasses
import importlib
import logging
import os
import sys
import textwrap
import threading

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TZOO = os.path.join(REPO, "elasticdl_tpu_torch", "model_zoo")
COHORT_ENV = ("EDL_PROCESS_ID", "EDL_NUM_PROCESSES",
              "EDL_PROCESS_ID_FROM_HOSTNAME", "EDL_COORDINATOR_ADDR")
ZOO_NAMES = ("mnist.mnist_cnn", "deepfm.deepfm", "deepfm.xdeepfm",
             "census.wide_deep", "cifar10.resnet",
             "transformer.transformer_lm")

CALLBACKS = """

def callbacks():
    return [EarlyStopping(monitor="accuracy", patience=1),
            ReduceLROnPlateau(initial_lr=0.1, monitor="accuracy",
                              patience=1)]
"""

REF_TINY = textwrap.dedent("""
    import flax.linen as nn
    import numpy as np
    import optax

    from elasticdl_tpu.api.callbacks import EarlyStopping, ReduceLROnPlateau
    from elasticdl_tpu.training import metrics as metrics_lib


    class Tiny(nn.Module):
        @nn.compact
        def __call__(self, x, training=False):
            return nn.Dense(2)(x)


    def custom_model(**kw):
        return Tiny()


    def loss(labels, outputs):
        return optax.softmax_cross_entropy_with_integer_labels(outputs, labels)


    def optimizer(**kw):
        return optax.sgd(0.1)


    def dataset_fn(mode, metadata):
        def parse(record):
            buf = np.frombuffer(record, np.uint8)
            return (buf[1:3] / 255.0).astype(np.float32), np.int32(buf[0] % 2)
        return parse


    def eval_metrics_fn():
        return {"accuracy": metrics_lib.Accuracy()}
""") + CALLBACKS

PORT_TINY = textwrap.dedent("""
    import numpy as np
    import torch
    from torch.nn import functional as F

    from elasticdl_tpu_torch.api.callbacks import (
        EarlyStopping, ReduceLROnPlateau)
    from elasticdl_tpu_torch.api.layers import Dense
    from elasticdl_tpu_torch.training import lr_modulation
    from elasticdl_tpu_torch.training import metrics as metrics_lib


    def custom_model(**kw):
        return Dense(2, 2, dtype=torch.float32)


    def loss(labels, outputs):
        return F.cross_entropy(outputs, labels.reshape(-1).to(torch.int64),
                               reduction="none")


    def optimizer(**kw):
        return lr_modulation.modulated(torch.optim.SGD, learning_rate=0.1)


    def dataset_fn(mode, metadata):
        def parse(record):
            buf = np.frombuffer(record, np.uint8)
            return (buf[1:3] / 255.0).astype(np.float32), np.int32(buf[0] % 2)
        return parse


    def eval_metrics_fn():
        return {"accuracy": metrics_lib.Accuracy()}
""") + CALLBACKS

# the port's DeepFM with a plateau schedule and early stopping on its AUC
PORT_DEEPFM = textwrap.dedent("""
    from elasticdl_tpu_torch.api.callbacks import (
        EarlyStopping, ReduceLROnPlateau)
    from elasticdl_tpu_torch.model_zoo.deepfm.deepfm import *  # noqa: F403


    def callbacks():
        return [ReduceLROnPlateau(initial_lr=1e-3, monitor="auc",
                                  patience=1, min_delta=1.0, min_lr=5e-4),
                EarlyStopping(monitor="auc", patience=3, min_delta=1.0)]
""")


def write_zoo(root, package, text):
    os.makedirs(os.path.join(root, package))
    open(os.path.join(root, package, "__init__.py"), "w").close()
    with open(os.path.join(root, package, "model.py"), "w") as f:
        f.write(text)
    importlib.invalidate_caches()


# ---------------------------------------------------------------- cases


def case_zoo_optimizers_carry_a_runtime_lr():
    import torch

    from elasticdl_tpu.training import lr_modulation as jlr
    from elasticdl_tpu_torch.training import lr_modulation as tlr

    def pair(name):
        ref = importlib.import_module("model_zoo." + name).optimizer()
        ref_state = ref.init({"w": np.zeros((2,), np.float32)})
        port = importlib.import_module(
            "elasticdl_tpu_torch.model_zoo." + name).optimizer()(
            [torch.nn.Parameter(torch.zeros(2))])
        return ref_state, port

    for name in ZOO_NAMES:
        ref_state, port = pair(name)
        want = jlr.get_learning_rate(ref_state)
        got = tlr.get_learning_rate(port)
        assert got is not None and want is not None, name
        np.testing.assert_allclose(got, float(want), rtol=1e-7, err_msg=name)
        tlr.set_learning_rate(port, 0.123)
        assert all(g["lr"] == 0.123 for g in port.param_groups), name
        assert tlr.get_learning_rate(port) == 0.123
        got_ref = jlr.get_learning_rate(jlr.set_learning_rate(ref_state, 0.123))
        assert abs(float(got_ref) - 0.123) < 1e-6, name
    # ResNet-50's warmup-cosine schedule takes no runtime LR on either side
    ref_state, port = pair("resnet50.resnet50")
    assert jlr.get_learning_rate(ref_state) is None
    assert tlr.get_learning_rate(port) is None


def case_stop_training_hits_the_dispatcher():
    from elasticdl_tpu.api.callbacks import JobContext as JJobContext
    from elasticdl_tpu.master.task_dispatcher import TaskDispatcher as JDisp
    from elasticdl_tpu_torch.api.callbacks import JobContext
    from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher

    def run(dispatcher_cls, context_cls):
        d = dispatcher_cls(training_shards=[("s", 0, 100)],
                           records_per_task=10, num_epochs=3, shuffle=False)
        leased = d.get(0)
        counts = [d.counts()]
        context_cls(d).stop_training("unit test")
        counts.append(d.counts())
        assert d.counts()["todo"] == 0
        assert d.report(leased.task_id, 0, True)
        assert d.get(0) is None and d.finished()
        counts.append(d.counts())
        return counts

    assert run(TaskDispatcher, JobContext) == run(JDisp, JJobContext)


def case_master_wires_zoo_callbacks(tmp):
    from elasticdl_tpu.api.callbacks import EarlyStopping as JEarly
    from elasticdl_tpu.common.config import JobConfig as JJobConfig
    from elasticdl_tpu.master.main import Master as JMaster
    from elasticdl_tpu.proto import elasticdl_tpu_pb2 as jpb
    from elasticdl_tpu_torch.api.callbacks import EarlyStopping
    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.common.net import free_port
    from elasticdl_tpu_torch.master.main import Master
    from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb

    def drive(master_cls, config_cls, pb_mod, early_cls, package):
        cfg = config_cls(
            job_name="cbtest", model_zoo=os.path.join(tmp, "zoo"),
            model_def=f"{package}.model.custom_model",
            training_data="synthetic://mnist?n=40&shards=1",
            validation_data="synthetic://mnist?n=8&shards=1",
            records_per_task=10, num_epochs=10,
            master_addr=f"localhost:{free_port()}", shuffle=False)
        master = master_cls(cfg)
        try:
            es, plateau = master.callbacks
            assert isinstance(es, early_cls) and es.ctx is not None
            wid = master.membership.register("w0").worker_id
            lrs = []
            for version in (1, 2):
                job_id = master.evaluation.trigger(version)
                assert job_id is not None
                n = master.dispatcher.num_evaluation_tasks()
                tasks = [master.dispatcher.get(wid) for _ in range(n)]
                for t in tasks:
                    assert t.type == pb_mod.EVALUATION
                    master.evaluation.report_metrics(
                        job_id, t.task_id,
                        {"accuracy": np.array([5.0, 10.0], np.float32)})
                    master.dispatcher.report(t.task_id, wid, True)
                lrs.append(master.servicer.Heartbeat(
                    pb_mod.HeartbeatRequest(worker_id=wid), None
                ).learning_rate)
            assert es.stopped
            assert all(t.type != pb_mod.TRAINING
                       for t in list(master.dispatcher._todo))
            return (lrs, plateau.lr, es.wait, master.dispatcher.counts(),
                    sorted(master.evaluation.latest_results()))
        finally:
            master.server.stop(0)

    write_zoo(os.path.join(tmp, "zoo"), "tinyref", REF_TINY)
    write_zoo(os.path.join(tmp, "zoo"), "tinyport", PORT_TINY)
    want = drive(JMaster, JJobConfig, jpb, JEarly, "tinyref")
    got = drive(Master, JobConfig, pb, EarlyStopping, "tinyport")
    assert got == want, (got, want)
    assert got[0] == [0.0, 0.05] and got[1] == 0.05


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def case_the_push_lands_in_the_workers_optimizer(tmp):
    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.common.net import free_port
    from elasticdl_tpu_torch.master.main import Master
    from elasticdl_tpu_torch.worker.worker import Worker

    write_zoo(os.path.join(tmp, "job_zoo"), "deepfm_cb", PORT_DEEPFM)
    cfg = JobConfig.from_argv([
        "--model_zoo", os.path.join(tmp, "job_zoo"),
        "--model_def", "deepfm_cb.model.custom_model",
        "--model_params", "field_vocab=64;hidden=16,16",
        "--compute_dtype", "float32", "--minibatch_size", "64",
        "--training_data", "synthetic://criteo?n=4096&shards=4",
        "--records_per_task", "128",
        "--validation_data", "synthetic://criteo?n=128&shards=1",
        "--evaluation_steps", "2",
        "--master_addr", f"localhost:{free_port()}",
        "--worker_heartbeat_s", "0.05"])
    lines = _Lines()
    root = logging.getLogger("elasticdl_tpu_torch")
    root.addHandler(lines)
    # The worker beats every 0.05 s, so that the master's LR push reaches
    # Adam at a task boundary before EarlyStopping ends the job. The
    # master declares a worker dead after 3 of its own beats: with the
    # same 0.05 s, a 0.15 s stall of the worker's thread under a loaded
    # host killed it, and `wait` then ran to its timeout with every task
    # queued. The master's config keeps a 10 s beat (30 s to a death).
    master = Master(dataclasses.replace(cfg, worker_heartbeat_s=10.0))
    master.start()
    worker = Worker(cfg, device="cpu")
    rc = []
    thread = threading.Thread(target=lambda: rc.append(worker.run()))
    thread.start()
    try:
        assert master.wait(poll_s=0.1, timeout_s=90)
        counts = master.dispatcher.counts()
        plateau, es = master.callbacks
    finally:
        master.shutdown(grace_s=0.5)
        thread.join(30)
        root.removeHandler(lines)
    assert rc == [0]
    assert plateau.lr == 5e-4 and es.stopped
    groups = worker._state.optimizer.param_groups
    assert [g["lr"] for g in groups] == [5e-4] * len(groups)
    stops = [m for m in lines.messages
             if m.startswith("training stop requested")]
    assert len(stops) == 1 and "auc did not improve" in stops[0], stops
    assert "runtime LR set to 0.0005" in lines.messages
    # 32 tasks of data: EarlyStopping ended training before the last
    assert 4 <= counts["finished_training"] < 32, counts
    assert counts["failed_permanently"] == 0, counts


def test_callbacks_against_the_reference(tmp_path, monkeypatch):
    """Every case above, in one collected test (ROADMAP.md, conventions:
    one collected test per port test file)."""
    for k in COHORT_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.syspath_prepend(str(tmp_path / "zoo"))
    monkeypatch.syspath_prepend(str(tmp_path / "job_zoo"))
    case_zoo_optimizers_carry_a_runtime_lr()
    case_stop_training_hits_the_dispatcher()
    case_master_wires_zoo_callbacks(str(tmp_path))
    case_the_push_lands_in_the_workers_optimizer(str(tmp_path))
    for k in [k for k in sys.modules if k.split(".")[0] in (
            "tinyref", "tinyport", "deepfm_cb")]:
        del sys.modules[k]
