"""The port's mesh, manual embedding schedule and cohort context against
the reference, on the CPU.

The port's ranks are gloo processes: four of them, each
`python tests/test_torch_mesh_embedding.py ranks <rank> ...`, form one
world through `parallel.elastic.CohortContext` (`EDL_TORCH_DEVICE`
plays no part: the context is given the CPU) and run every case below
on meshes over some or all of them (`parallel.mesh.build_mesh(sizes,
ranks)`). The reference runs in-process on the conftest's 8-device CPU
mesh with the exact embedding backward (`EDL_EMB_SCATTER=sorted`).

- The manual lookup's forward and table gradient (the VJP of
  sum(lookup * w)) against the reference's `embedding_lookup(mode=
  "manual")` under `jax.set_mesh`, on meshes {data 2}, {data 4} and
  {data 2, model 2}, over a 1,024 x 8 table and 12 x 26 ids that include
  negative and out-of-range ones. The forward is a gather in both, so it
  must match bit for bit; the gradient sums the same rows in the same
  order (stable-sorted ids), held to rtol 1e-6 with atol 1e-6 of its
  largest value.
- An uneven table, 1,000 rows over 3 ranks: the port keeps its manual
  schedule with a short last shard, the reference falls back to its auto
  partitioner; same tolerances.
- `context_from_env` over the reference's environment cases, against the
  reference's function.
- 64-bit `broadcast_ints` and `allgather_ints` (values past 2**31, an LR
  bit pattern) in the 4-rank world and in a process with no world, and
  the LR bits round trip, twins of `tests/test_elastic_ctrl.py:12,19`.
- What is left out raises: a plain worker's `--mesh_shape` of more than
  one device (pointing to `--num_processes`), `--dcn_mesh_shape`, the
  cohort's `--speculative_compile`, and a member's card where there is
  none.
"""

import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

from elasticdl_tpu_torch.parallel import elastic, mesh as mesh_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COHORT_ENV = ("EDL_PROCESS_ID", "EDL_NUM_PROCESSES",
              "EDL_PROCESS_ID_FROM_HOSTNAME", "EDL_COORDINATOR_ADDR",
              "EDL_WORLD_VERSION")
V, D, B, L = 1024, 8, 12, 26
MESHES = (("data2", {"data": 2}, V), ("data4", {"data": 4}, V),
          ("data2_model2", {"data": 2, "model": 2}, V),
          ("uneven3", {"data": 3}, 1000))
BIG = [1, 0, 2, 7, 4_370_000_000, 4_380_000_000, 0, -1]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_ranks(script: str, world: int, workdir: str):
    """Start `python <script> ranks <rank> <world> <port> <workdir>` for
    every rank, to form a gloo world at a free port. The cohort variables
    are left out of their environment."""
    env = {k: v for k, v in os.environ.items() if k not in COHORT_ENV}
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    port = str(free_port())
    return [subprocess.Popen(
        [sys.executable, script, "ranks", str(r), str(world), port, workdir],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]


def wait_ranks(procs, timeout_s: float = 90) -> None:
    """Wait for every rank, at most `timeout_s` in all; each must exit 0
    (its output's tail is shown where one does not)."""
    deadline = time.time() + timeout_s
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.time()))
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    assert not bad, (bad, "\n".join(log[-3000:] for log in logs))


def rank_context(rank: int, world: int, port: str) -> elastic.CohortContext:
    """A rank's world: one gloo process on the CPU."""
    torch.set_num_threads(1)
    ctx = elastic.CohortContext(f"localhost:{port}", world, rank)
    ctx.initialize(timeout_s=60)
    return ctx


# ---------------------------------------------------------------- ranks


def run_ranks(rank: int, world: int, port: str, workdir: str) -> None:
    from elasticdl_tpu_torch.ops import embedding as emb
    from elasticdl_tpu_torch.worker.cohort import _bits_to_lr, _lr_to_bits

    ctx = rank_context(rank, world, port)
    inputs = np.load(os.path.join(workdir, "inputs.npz"))
    ids = torch.from_numpy(inputs["ids"])
    w = torch.from_numpy(inputs["w"])
    out = {}
    for name, sizes, rows in MESHES:
        n = int(np.prod(list(sizes.values())))
        mesh = mesh_lib.build_mesh(sizes, list(range(n)))
        if mesh is None:
            continue
        shard_rows = mesh_lib.table_rows(mesh, rows)
        table = torch.from_numpy(inputs["table"][:rows])
        shard = table[shard_rows.start:shard_rows.stop].clone()
        shard.requires_grad_(True)
        start, stop = mesh_lib.batch_block(mesh, B)
        vec = emb.embedding_lookup(shard, ids[start:stop], mesh=mesh,
                                   rows=shard_rows)
        (vec * w[start:stop]).sum().backward()
        out[f"{name}.out"] = vec.detach().numpy()
        out[f"{name}.start"] = np.array([start, shard_rows.start])
        out[f"{name}.grad"] = shard.grad.numpy()
    lr = 0.05
    vec = ctx.broadcast_ints(BIG + [_lr_to_bits(lr)] if rank == 0
                             else [0] * (len(BIG) + 1))
    assert vec.dtype == np.int64 and list(vec[:-1]) == BIG, vec
    assert _bits_to_lr(int(vec[-1])) == lr
    rows = ctx.allgather_ints([rank, 2**40 + rank, -rank])
    assert rows.dtype == np.int64 and rows.tolist() == [
        [r, 2**40 + r, -r] for r in range(world)], rows
    ctx.barrier()
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    ctx.shutdown()


# ---------------------------------------------------------------- cases


def reference_lookups(table, ids, w):
    """{case: (out, table grad)} from the reference's manual lookup."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from elasticdl_tpu.ops import embedding as jemb
    from elasticdl_tpu.parallel.mesh import build_mesh

    want = {}
    for name, sizes, rows in MESHES:
        n = int(np.prod(list(sizes.values())))
        mesh = build_mesh(sizes, jax.devices()[:n])
        # shard_map needs even shards: an uneven table is placed
        # replicated, and the lookup falls back to auto (as the
        # reference's own test of the fallback places it)
        spec = P() if rows % n else P(tuple(mesh.axis_names), None)
        t = jax.device_put(table[:rows], NamedSharding(mesh, spec))
        i = jax.device_put(ids, NamedSharding(mesh, P("data", None)))

        def f(t, i):
            out, vjp = jax.vjp(
                lambda t: jemb.embedding_lookup(t, i, mode="manual"), t)
            return out, vjp(jnp.asarray(w))[0]

        with jax.set_mesh(mesh):
            out, grad = jax.jit(f)(t, i)
        want[name] = (np.asarray(out), np.asarray(grad))
    return want


def case_manual_lookup_matches_reference(workdir, want):
    parts = [dict(np.load(os.path.join(workdir, f"rank{r}.npz")))
             for r in range(4)]
    for name, sizes, rows in MESHES:
        n = int(np.prod(list(sizes.values())))
        got_out = np.zeros((B, L, D), np.float32)
        got_grad = np.zeros((rows, D), np.float32)
        for part in parts[:n]:
            start, row_start = part[f"{name}.start"]
            block = part[f"{name}.out"]
            got_out[start:start + len(block)] = block
            grad = part[f"{name}.grad"]
            got_grad[row_start:row_start + len(grad)] = grad
        out, grad = want[name]
        np.testing.assert_array_equal(got_out, out, err_msg=name)
        np.testing.assert_allclose(got_grad, grad, rtol=1e-6,
                                   atol=1e-6 * np.abs(grad).max(),
                                   err_msg=name)
        # negative and out-of-range ids read zeros and place nothing
        assert not np.abs(got_out[(np.asarray(IDS) < 0)
                                  | (np.asarray(IDS) >= rows)]).any()


def case_context_from_env_matches_reference(monkeypatch):
    from types import SimpleNamespace

    from elasticdl_tpu.parallel import elastic as jelastic

    cases = [
        (1, "", {}),
        (3, "", {}),
        (4, "", {"EDL_PROCESS_ID": "2", "EDL_NUM_PROCESSES": "1"}),
        (4, "cfg:1", {"EDL_PROCESS_ID": "1", "EDL_COORDINATOR_ADDR": "h:2",
                      "EDL_WORLD_VERSION": "5"}),
        (2, "cfg:1", {"EDL_PROCESS_ID": "1"}),
        (4, "", {"EDL_PROCESS_ID_FROM_HOSTNAME": "1"}),
    ]
    monkeypatch.setattr(socket, "gethostname", lambda: "edl-worker-3")
    saved = {k: os.environ.get(k) for k in COHORT_ENV}
    try:
        for n, addr, env in cases:
            cfg = SimpleNamespace(num_processes=n, coordinator_addr=addr)
            got = []
            for fn in (jelastic.context_from_env, elastic.context_from_env):
                for k in COHORT_ENV:
                    os.environ.pop(k, None)
                os.environ.update(env)
                ctx = fn(cfg)
                got.append(None if ctx is None else (
                    ctx.coordinator_addr, ctx.num_processes,
                    ctx.process_id, ctx.world_version))
            assert got[0] == got[1], (n, addr, env, got)
        monkeypatch.setattr(socket, "gethostname", lambda: "edlworker")
        for fn in (jelastic.context_from_env, elastic.context_from_env):
            for k in COHORT_ENV:
                os.environ.pop(k, None)
            os.environ["EDL_PROCESS_ID_FROM_HOSTNAME"] = "1"
            with pytest.raises(RuntimeError, match="no trailing ordinal"):
                fn(SimpleNamespace(num_processes=2, coordinator_addr=""))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def case_ctrl_round_trips_without_a_world():
    from elasticdl_tpu.worker import cohort as jcohort
    from elasticdl_tpu_torch.worker import cohort

    for lr in (1e-8, 3e-4, 0.05, 0.1, 1.0, 123.456):
        assert cohort._lr_to_bits(lr) == jcohort._lr_to_bits(lr)
        assert cohort._bits_to_lr(cohort._lr_to_bits(lr)) == lr
    assert cohort._lr_to_bits(0.0) == 0 and cohort._bits_to_lr(0) == 0.0
    ctx = elastic.CohortContext("localhost:0", num_processes=1, process_id=0)
    vec = BIG + [cohort._lr_to_bits(0.05)]
    out = ctx.broadcast_ints(vec)
    assert out.dtype == np.int64 and [int(x) for x in out] == vec
    assert ctx.allgather_ints(vec).tolist() == [vec]


_rng = np.random.RandomState(7)
TABLE = _rng.randn(V, D).astype(np.float32)
IDS = _rng.randint(-3, V + 40, (B, L)).astype(np.int32)
W = _rng.randn(B, L, D).astype(np.float32)


def case_options_left_out_raise():
    """A plain worker given a mesh of more devices than its one and the
    cohort's speculative compiler raise, naming where to go; a hybrid
    mesh of more slices than the world has ranks raises the reference's
    error, and one slice of one rank is a mesh of one; the member of a
    world needs its own card."""
    from elasticdl_tpu_torch.common import runtime
    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.worker.cohort import CohortWorker
    from elasticdl_tpu_torch.worker.worker import Worker

    base = ["--model_zoo", os.path.join(REPO, "elasticdl_tpu_torch",
                                        "model_zoo"),
            "--model_def", "deepfm.deepfm.custom_model"]
    with pytest.raises(ValueError, match="--num_processes"):
        Worker(JobConfig.from_argv(base + ["--mesh_shape", "4,2"]),
               device="cpu")
    with pytest.raises(ValueError, match="implies 2 slices, which does "
                       "not divide 1 devices"):
        Worker(JobConfig.from_argv(base + ["--dcn_mesh_shape", "data=2"]),
               device="cpu")
    assert Worker(JobConfig.from_argv(base + ["--dcn_mesh_shape", "data=1"]),
                  device="cpu")._mesh.size == 1
    assert Worker(JobConfig.from_argv(base + ["--mesh_shape", "1"]),
                  device="cpu")._mesh.size == 1
    ctx = elastic.CohortContext("localhost:0", 2, 1)
    with pytest.raises(NotImplementedError, match="item 19"):
        CohortWorker(JobConfig.from_argv(base + ["--speculative_compile", "true"]),
                     ctx=ctx, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            runtime.cohort_device(0)


def test_mesh_embedding_against_the_reference(monkeypatch):
    """Every case above, in one collected test (ROADMAP.md, conventions:
    one collected test per port test file)."""
    for k in COHORT_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("EDL_EMB_SCATTER", "sorted")
    with tempfile.TemporaryDirectory() as workdir:
        np.savez(os.path.join(workdir, "inputs.npz"), table=TABLE, ids=IDS,
                 w=W)
        ranks = start_ranks(os.path.abspath(__file__), 4, workdir)
        want = reference_lookups(TABLE, IDS, W)
        wait_ranks(ranks)
        case_manual_lookup_matches_reference(workdir, want)
    case_context_from_env_matches_reference(monkeypatch)
    case_ctrl_round_trips_without_a_world()
    case_options_left_out_raise()


if __name__ == "__main__" and sys.argv[1] == "ranks":
    run_ranks(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
