"""The embedding tier through the port's job path, on the CPU.

- `case_master_reshard`: the port's `Master` with `--embedding_shards 8`
  behind real gRPC (the twin of `tests/test_embedding_tier.py::
  test_shard_map_rpcs_and_runtime_reshard`, through the port's own
  master rather than the bench harness). Three `WorkerTierRuntime`s in
  device mode on `device="cpu"` join over one LocalTransport; one is
  drained, deregistered and marked dead; the master's death callback
  plans the moves, the survivors' `on_world_change` installs them from
  the drain checkpoint and confirms, and the map commits at version 2
  without the victim. Every shard is bit-exact against the pre-kill
  tables, a re-sent acknowledged push dedupes at its shard's new owner,
  and the recovery builds no new program (the process-global
  `CompileCache` counts no miss).
- `case_deepfm_job_in_the_tier`: an in-process DeepFM job (master and a
  `Worker(device="cpu")` on a thread, `--embedding_shards 4`,
  `--embedding_transport grpc`) finishes its tasks with the worker
  resident in the tier (all 4 shards, its data-plane endpoint up, the
  tier's stats on its heartbeat); a master-requested checkpoint drains
  the shards into `<checkpoint_dir>/emb/`, whose files hold the shards'
  seed-made rows bit for bit (nothing pushes to them), made from the
  table spec as the map's response carries it (the proto's `init_scale`
  is a float32).
- `case_cohort_leader_alone_joins`: a two-member gloo cohort job through
  the port's Master and ProcessManager with `--embedding_shards 2`: only
  the leader joins the tier, and its teardown drain writes both shards.

The cohort variables a polluted environment can carry are cleared first
(ROADMAP queue 3). All in one collected test (ROADMAP.md, conventions).
"""

import contextlib
import glob
import os
import sys
import threading
import time

import numpy as np

from elasticdl_tpu_torch.api.layers import tier_table_spec
from elasticdl_tpu_torch.common.config import JobConfig
from elasticdl_tpu_torch.common.net import free_port
from elasticdl_tpu_torch.embedding import store as store_lib
from elasticdl_tpu_torch.embedding import tier
from elasticdl_tpu_torch.embedding.transport import LocalTransport
from elasticdl_tpu_torch.master.main import Master
from elasticdl_tpu_torch.master.process_manager import ProcessManager
from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb
from elasticdl_tpu_torch.proto.service import MasterStub, make_channel
from elasticdl_tpu_torch.training import compile_cache as cc
from elasticdl_tpu_torch.worker.worker import Worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TZOO = os.path.join(REPO, "elasticdl_tpu_torch", "model_zoo")
COHORT_ENV = ("EDL_PROCESS_ID", "EDL_NUM_PROCESSES",
              "EDL_PROCESS_ID_FROM_HOSTNAME", "EDL_COORDINATOR_ADDR",
              "EDL_WORLD_VERSION")
SPEC = tier_table_spec("users", 1000, 8, seed=3)     # 1024 rows


@contextlib.contextmanager
def port_zoo():
    """Masters and workers import the zoo's `deepfm.deepfm` by name: run
    with the port's zoo first on sys.path and any other cached `deepfm`
    modules set aside."""
    names = [k for k in sys.modules if k == "deepfm" or k.startswith("deepfm.")]
    saved = {k: sys.modules.pop(k) for k in names}
    path = list(sys.path)
    try:
        sys.path.insert(0, TZOO)
        yield
    finally:
        for k in [k for k in sys.modules
                  if k == "deepfm" or k.startswith("deepfm.")]:
            del sys.modules[k]
        sys.modules.update(saved)
        sys.path[:] = path


def argv(out, *extra):
    return [
        "--model_zoo", TZOO, "--model_def", "deepfm.deepfm.custom_model",
        "--model_params", "field_vocab=64;hidden=16,16",
        "--compute_dtype", "float32", "--minibatch_size", "64",
        "--checkpoint_dir", os.path.join(out, "ckpt"),
        "--master_addr", f"localhost:{free_port()}",
        "--worker_heartbeat_s", "1", *extra]


def full_table(view, tr):
    out = np.zeros((SPEC.vocab, SPEC.dim), np.float32)
    for s in range(view.num_shards):
        rows = tr.store_of(view.owners[s]).extract_shard("users", s)["rows"]
        out[np.arange(s, SPEC.vocab, view.num_shards)] = rows
    return out


def case_master_reshard(tmp):
    cfg = JobConfig.from_argv(argv(tmp, "--embedding_shards", "8"))
    with port_zoo():
        master = Master(cfg)
    master.embedding.register_table(SPEC)
    master.start()
    channel = make_channel(cfg.master_addr)
    stub = MasterStub(channel)
    runtimes = {}
    try:
        # no workers yet: no map to serve
        assert stub.GetEmbeddingShardMap(
            pb.GetEmbeddingShardMapRequest(worker_id=0)).version == 0
        wids = [stub.RegisterWorker(pb.RegisterWorkerRequest(
            worker_name=f"w{i}")).worker_id for i in range(3)]
        shared = LocalTransport()
        for w in wids:
            runtimes[w] = tier.WorkerTierRuntime(
                stub, w, checkpoint_dir=cfg.checkpoint_dir,
                transport=shared, device="cpu")
            assert runtimes[w].store.device.type == "cpu"
        view = runtimes[wids[0]].client.view
        assert view.version == 1 and view.num_shards == 8
        client = runtimes[wids[0]].client
        r = np.random.RandomState(4)
        ids = np.unique(r.randint(0, SPEC.vocab, 300))
        # warm: every shard's pull and push programs are built here
        client.pull_unique("users", ids)
        client.push("users", ids, r.rand(len(ids), 8).astype(np.float32),
                    scale=-0.5)
        before = full_table(view, shared)
        misses = cc.global_cache().stats()["misses"]

        victim = wids[-1]
        moved = [s for s, o in enumerate(view.owners) if o == victim]
        last_seq = shared.store_of(victim).extract_shard(
            "users", moved[0])["applied"][client.client_id]
        t0 = time.perf_counter()
        runtimes[victim].drain()
        shared.deregister(victim)
        master.membership.mark_dead(victim, reason="test")
        assert master.embedding.view().resharding
        for w in wids[:-1]:
            runtimes[w].on_world_change()
        recovery_s = time.perf_counter() - t0
        final = master.embedding.view()
        assert not final.resharding and final.version == 2
        assert victim not in set(final.owners)
        assert np.array_equal(full_table(final, shared), before)
        # the acknowledged push, re-sent to the shard's new owner, dedupes
        new_owner = final.owners[moved[0]]
        assert shared.push(
            new_owner, "users", moved[0], np.array([0], np.int32),
            np.ones((1, 8), np.float32), client_id=client.client_id,
            seq=last_seq, map_version=final.version) is False
        # the tier serves again; recovery built no new program
        post = client.push("users", ids, np.ones((len(ids), 8), np.float32),
                           scale=0.5)
        assert post["ids_sent"] == len(ids)
        client.pull_unique("users", ids)
        assert cc.global_cache().stats()["misses"] == misses
        assert recovery_s < 30
    finally:
        for rt in runtimes.values():
            rt.close()
        channel.close()
        master.shutdown(grace_s=0.1)


def case_deepfm_job_in_the_tier(tmp):
    cfg = JobConfig.from_argv(argv(
        tmp, "--training_data", "synthetic://criteo?n=1024&shards=4",
        "--records_per_task", "256", "--embedding_shards", "4",
        "--embedding_transport", "grpc"))
    with port_zoo():
        master = Master(cfg)
        master.embedding.register_table(SPEC)
        master.start()
        worker = Worker(cfg, device="cpu")
        # a forced save at a task boundary drains the tier's shards
        master.servicer.request_checkpoint(0)
        rc, stats = [], []

        def run():
            rc.append(worker.run())

        thread = threading.Thread(target=run)
        thread.start()
        try:
            assert master.wait(poll_s=0.1, timeout_s=90)
            stats.append(worker._stats_payload())
            counts = master.dispatcher.counts()
        finally:
            master.shutdown(grace_s=0.5)
            thread.join(30)
    assert rc == [0]
    assert counts["finished_training"] == 4
    assert counts["failed_permanently"] == 0
    assert worker._tier is not None and worker._data_server is not None
    assert worker._tier.store.device.type == "cpu"
    assert sorted(worker._tier.store.resident_shards()) == [
        ("users", s) for s in range(4)]
    assert "emb_hot_id_share" in stats[0]
    # the worker's spec came over the wire (its init_scale a float32)
    spec = worker._tier.client.view.tables[0]
    for s in range(4):
        payload = store_lib.load_shard_file(cfg.checkpoint_dir, "users", s)
        assert payload is not None, s
        assert np.array_equal(payload["rows"],
                              store_lib._init_shard_rows(spec, s, 4))


def case_cohort_leader_alone_joins(tmp):
    cfg = JobConfig.from_argv(argv(
        tmp, "--training_data", "synthetic://criteo?n=512&shards=2",
        "--records_per_task", "256", "--num_processes", "2",
        "--embedding_shards", "2"))
    with port_zoo():
        master = Master(cfg)
    master.embedding.register_table(SPEC)
    manager = ProcessManager(
        cfg, membership=master.membership,
        extra_env={"EDL_TORCH_DEVICE": "cpu", "PYTHONPATH": REPO,
                   "OMP_NUM_THREADS": "1"},
        log_dir=os.path.join(tmp, "logs"),
        job_finished_fn=master.dispatcher.finished)
    master.start()
    manager.start_workers()
    try:
        deadline = time.time() + 90
        while not master.dispatcher.finished() and time.time() < deadline:
            master.membership.reap()
            master.dispatcher.poke()
            time.sleep(0.2)
        counts = master.dispatcher.counts()
    finally:
        master.shutdown()
        manager.stop()
    logs = {os.path.basename(f): open(f, errors="replace").read()
            for f in sorted(glob.glob(os.path.join(tmp, "logs", "*.log")))}
    joined = [name for name, text in logs.items()
              if "joined embedding tier: map v1, 2 shard(s) resident on cpu"
              in text]
    assert counts["finished_training"] == 2, (counts, logs)
    assert joined == ["worker-0-p0.log"], (joined, list(logs))
    for s in range(2):
        assert store_lib.load_shard_file(
            cfg.checkpoint_dir, "users", s) is not None, s


def test_tier_job_paths(tmp_path, monkeypatch):
    """Every case above, in one collected test (ROADMAP.md, conventions:
    one collected test per port test file)."""
    for k in COHORT_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.delenv("EDL_EMB_TIER_DEVICE", raising=False)
    case_master_reshard(str(tmp_path / "reshard"))
    case_deepfm_job_in_the_tier(str(tmp_path / "job"))
    case_cohort_leader_alone_joins(str(tmp_path / "cohort"))
