"""The port's data path and wire format against the reference, on the CPU.

- DeepFM's `dataset_fn` in both zoos, through both packages'
  `TaskDataService` over the same `synthetic://criteo` spans, gives
  byte-equal numpy batches (features, labels, padding mask); the port's
  native parser is built from its own copy of `batch_parse.cc` into the
  git-ignored build directory.
- A `Task` (and a lease response carrying tasks) serialized by one
  package's `proto` parses in the other's into equal messages.
- One argv gives equal `JobConfig` field dicts and the same re-serialized
  argv in both packages.
- The prefetcher on `cpu` yields the batches in order as tensors, and a
  drain plus requeue through a new prefetcher loses and duplicates none;
  the bfloat16 wire cast leaves the mask float32.

Every comparison here is exact: the parsers, the wire format and the
queue are integer or byte-level code.
"""

import contextlib
import dataclasses
import itertools
import os
import sys

import numpy as np
import torch

from elasticdl_tpu.common.config import JobConfig as JJobConfig
from elasticdl_tpu.data.reader import create_data_reader as j_reader
from elasticdl_tpu.proto import elasticdl_tpu_pb2 as jpb
from elasticdl_tpu.worker.task_data_service import (
    TaskDataService as JTaskDataService)
from elasticdl_tpu_torch.common.config import JobConfig
from elasticdl_tpu_torch.data import nativelib, parsing, prefetch
from elasticdl_tpu_torch.data.reader import create_data_reader
from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as tpb
from elasticdl_tpu_torch.worker.task_data_service import TaskDataService

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JZOO = os.path.join(REPO, "model_zoo")
TZOO = os.path.join(REPO, "elasticdl_tpu_torch", "model_zoo")


@contextlib.contextmanager
def zoo(root):
    """Both zoos name their module `deepfm.deepfm`: import it with `root`
    first on sys.path and the other zoo's cached modules set aside."""
    names = [k for k in sys.modules if k == "deepfm" or k.startswith("deepfm.")]
    saved = {k: sys.modules.pop(k) for k in names}
    path = list(sys.path)
    try:
        sys.path.insert(0, root)
        import deepfm.deepfm as module
        yield module
    finally:
        for k in [k for k in sys.modules
                  if k == "deepfm" or k.startswith("deepfm.")]:
            del sys.modules[k]
        sys.modules.update(saved)
        sys.path[:] = path


def _batches(module, reader_fn, service_cls, span, batch_size):
    reader = reader_fn("synthetic://criteo?n=3000&shards=3")
    parse = module.dataset_fn("training", reader.metadata)
    svc = service_cls(reader, parse, batch_size, batch_multiple=1)
    shard = reader.create_shards()[1]
    return list(svc.batches(shard[0], shard[1] + span[0], shard[1] + span[1]))


def _flat(batch, prefix=""):
    for k, v in sorted(batch.items()):
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield prefix + k, np.asarray(v)


def case_dataset_fn_batches_are_byte_equal():
    # a span that ends in a partial (padded) batch
    span, bs = (7, 7 + 600), 256
    with zoo(JZOO) as jmod:
        want = _batches(jmod, j_reader, JTaskDataService, span, bs)
    with zoo(TZOO) as tmod:
        got = _batches(tmod, create_data_reader, TaskDataService, span, bs)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        g, w = dict(_flat(g)), dict(_flat(w))
        assert sorted(g) == sorted(w) == [
            "features.cat", "features.dense", "labels", "mask"]
        for k in g:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            assert g[k].tobytes() == w[k].tobytes(), k
    assert float(got[-1]["mask"].sum()) == 600 - 2 * bs
    # the native parser ran, built from the port's copy of the source
    lib = parsing._load()
    assert lib is not None
    assert os.path.dirname(lib._name) == nativelib.BUILD_DIR
    assert nativelib.NATIVE_DIR.startswith(
        os.path.join(REPO, "elasticdl_tpu_torch"))


def case_proto_messages_cross_between_packages():
    task = dict(task_id=7, type=jpb.EVALUATION, shard_name="synthetic-criteo-1",
                start=16, end=4112, epoch=2, eval_job_id=3)
    for src, dst in ((jpb, tpb), (tpb, jpb)):
        msg = src.Task(**task)
        back = dst.Task.FromString(msg.SerializeToString())
        assert back == dst.Task(**task)
        resp = src.GetTaskResponse(tasks=[msg, msg], backoff_seconds=0.5)
        back = dst.GetTaskResponse.FromString(resp.SerializeToString())
        assert [t.task_id for t in back.tasks] == [7, 7]
        assert back.backoff_seconds == 0.5
    assert tpb.SAVE_MODEL == jpb.SAVE_MODEL and tpb.WAIT == jpb.WAIT


def case_job_config_parses_one_argv_alike():
    argv = ["--model_zoo", TZOO, "--model_def", "deepfm.deepfm.custom_model",
            "--model_params", "field_vocab=1000;hidden=32,32",
            "--training_data", "synthetic://criteo?n=2048&shards=4",
            "--validation_data", "synthetic://criteo?n=512&shards=2",
            "--records_per_task", "512", "--minibatch_size", "256",
            "--checkpoint_steps", "4", "--keep_checkpoint_max", "2",
            "--shuffle", "false", "--num_epochs", "2",
            "--data_reader_params", "a=1;b=x", "--compute_dtype", "float32"]
    j, t = JJobConfig.from_argv(argv), JobConfig.from_argv(argv)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.to_argv() == j.to_argv()
    assert JobConfig.from_argv(t.to_argv()) == t
    t.validate()


def _numbered(n, b=4):
    for i in range(n):
        yield {"features": {"x": np.full((b, 3), i, np.float32)},
               "labels": np.full((b,), i, np.int32),
               "mask": np.ones((b,), np.float32)}


def _ids(batches):
    return [int(b["labels"][0]) for b in batches]


def case_prefetch_order_drain_and_requeue():
    for depth in (0, 1, 3):
        out = list(prefetch.prefetch_to_device("cpu", _numbered(7), depth))
        assert _ids(out) == list(range(7)), depth
        assert all(isinstance(b["features"]["x"], torch.Tensor) for b in out)
    pf = prefetch.prefetch_to_device("cpu", _numbered(10), depth=3)
    first = [next(pf) for _ in range(4)]
    pending = pf.drain()
    # each next() tops the window up to 3 and then hands one out
    assert _ids(pending) == [4, 5]
    assert list(pf) == []
    rest = list(prefetch.prefetch_to_device(
        "cpu", itertools.chain(pending, pf.source), depth=2))
    assert _ids(first) + _ids(rest) == list(range(10))

    cast = prefetch._wire_cast(next(_numbered(1)), "bfloat16")
    assert cast["features"]["x"].dtype == torch.bfloat16
    assert cast["mask"].dtype == torch.float32
    assert cast["labels"].dtype == torch.int32
    assert prefetch.resolve_depth(None) == int(
        os.environ.get("EDL_PREFETCH_DEPTH", prefetch.DEFAULT_DEPTH))
    assert prefetch.resolve_depth(5) == 5 and prefetch.resolve_cast("x") == "x"


def test_data_path_matches_reference():
    """Every case above, in one collected test (ROADMAP.md, conventions:
    one collected test per port test file)."""
    case_dataset_fn_batches_are_byte_equal()
    case_proto_messages_cross_between_packages()
    case_job_config_parses_one_argv_alike()
    case_prefetch_order_drain_and_requeue()
