"""The port's data-parallel step for models beyond DeepFM, against the
reference's mesh, on the CPU.

Four gloo ranks (`python tests/test_torch_zoo_parallel.py ranks ...`, the
harness of `tests/test_torch_mesh_embedding.py`) run ResNet-20 (depth 8,
BatchNorm over the global batch, every parameter replicated) and Wide &
Deep (hidden 32,16; its table sharded by rows) at {data 2} and {data 4},
float32, batches of 16 with masked rows, each from the reference's
initial state on that mesh (converted with
`convert.train_state_from_flax(..., row_shards=)`). The reference runs
its `Trainer` in-process on the same meshes of the conftest's 8-device
CPU mesh, where GSPMD computes BatchNorm's statistics over the whole
logically sharded batch.

- Two steps at each mesh: losses rtol 1e-5; BatchNorm's running
  averages rtol 1e-5 with atol 1e-5 of the largest over all of them
  (`tests/test_torch_zoo.py`'s step tolerance); params and the
  optimizer's slots rtol 1e-5 (1e-4 after Adam) with atol 1e-4 and 2e-3
  of the largest over all arrays of their kind: the reference's own
  {data 2} run of these two steps differs from its one-device run by
  3.3e-5 of the largest param and 8.2e-4 of the largest momentum
  (measured): BatchNorm's backward through the fast variance magnifies
  the summation order, which the data axis changes.
- ResNet-20's first-step gradients at {data 2} and {data 4} (all-reduced
  over data) against the reference's gradient of the same global batch:
  rtol 1e-5 with atol 1e-4 of the largest gradient (the step tolerance
  of the slots, which hold these gradients).
- Every rank's replicated params and buffers bit-identical (an allgather
  of a checksum of their bits), so the running statistics of a global
  BatchNorm stay the same on every replica.
"""

import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tests.test_torch_mesh_embedding import (  # noqa: E402
    COHORT_ENV,
    rank_context,
    start_ranks,
    wait_ranks,
)

TZOO = os.path.join(REPO, "elasticdl_tpu_torch", "model_zoo")
B, STEPS = 16, 2
# (run, model, mesh axes)
RUNS = (("resnet20_data2", "resnet20", {"data": 2}),
        ("resnet20_data4", "resnet20", {"data": 4}),
        ("wide_deep_data2", "wide_deep", {"data": 2}),
        ("wide_deep_data4", "wide_deep", {"data": 4}))
TABLE = "deep.table"


def batch(model, seed):
    r = np.random.RandomState(seed)
    if model == "resnet20":
        feats = {"x": r.rand(B, 32, 32, 3).astype(np.float32)}
        labels = r.randint(0, 10, B)
    else:
        feats = {"dense": r.randn(B, 5).astype(np.float32),
                 "cat": r.randint(0, 200, (B, 9)).astype(np.int32)}
        labels = r.randint(0, 2, B)
    return {"features": feats, "labels": labels.astype(np.int32),
            "mask": (r.rand(B) > 0.2).astype(np.float32)}


def features(model, b):
    """The model's features (ResNet-20 takes the image array itself)."""
    return b["features"]["x"] if model == "resnet20" else b["features"]


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def unflat(d):
    out = {}
    for k, v in d.items():
        node = out
        *head, last = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def _batches(inputs, model):
    return [{k: v for k, v in unflat({
        key[len(f"{model}.batch{i}/"):]: val for key, val in inputs.items()
        if key.startswith(f"{model}.batch{i}/")}).items()}
        for i in range(STEPS)]


# ---------------------------------------------------------------- ranks


def run_ranks(rank: int, world: int, port: str, workdir: str) -> None:
    import torch

    from elasticdl_tpu_torch import convert
    from elasticdl_tpu_torch.parallel import mesh as mesh_lib
    from tests.test_torch_zoo import specs

    ctx = rank_context(rank, world, port)
    inputs = dict(np.load(os.path.join(workdir, "inputs.npz")))
    out = {}

    def checksum(state):
        """Two int64 sums over the bits of the replicated params and the
        buffers."""
        parts = [p.detach().reshape(-1) for k, p in state.params.items()
                 if k not in state.row_shards]
        parts += [b.reshape(-1) for b in state.buffers.values()]
        bits = torch.cat(parts).view(torch.int32).to(torch.int64)
        pos = torch.arange(bits.numel(), dtype=torch.int64)
        return [int(bits.sum()), int((bits * pos).sum())]

    for run, model, sizes in RUNS:
        n = int(np.prod(list(sizes.values())))
        mesh = mesh_lib.build_mesh(sizes, list(range(n)))
        sums = [0, 0]
        if mesh is not None:
            from elasticdl_tpu_torch.training.trainer import Trainer

            _, tspec = specs(model)
            tr = Trainer(tspec, device="cpu", mesh=mesh)
            state = tr.init_state(None)
            init = {w: unflat({k[len(f"{run}.{w}/"):]: v
                               for k, v in inputs.items()
                               if k.startswith(f"{run}.{w}/")})
                    for w in ("params", "mu", "nu", "trace", "batch_stats")}
            converted = convert.train_state_from_flax(
                init["params"], init["mu"] or None, init["nu"] or None,
                inputs[f"{run}.count"], inputs[f"{run}.step"],
                row_shards=state.row_shards, trace=init["trace"] or None,
                batch_stats=init["batch_stats"] or None)
            convert.load_train_state(state, converted)
            batches = [{**b, "features": features(model, b)}
                       for b in _batches(inputs, model)]
            if model == "resnet20":
                _, grads = tr.compute_grads(state, batches[0])
                for k, g in grads.items():
                    out[f"{run}.grad.{k}"] = g.numpy().copy()
                # the training forward moved the running averages
                convert.load_train_state(state, converted)
            losses = [float(tr.train_step(state, b)[1]["loss"])
                      for b in batches]
            out[f"{run}.losses"] = np.array(losses)
            names = list(state.params)
            for k, p in state.params.items():
                out[f"{run}.param.{k}"] = p.detach().numpy().copy()
            for k, b in state.buffers.items():
                out[f"{run}.buffer.{k}"] = b.numpy().copy()
            for i, slot in state.optimizer.state_dict()["state"].items():
                for key, v in slot.items():
                    if v.dim():
                        out[f"{run}.{key}.{names[i]}"] = v.numpy().copy()
            rows = state.row_shards.get(TABLE)
            out[f"{run}.row_start"] = np.array(rows.start if rows else 0)
            sums = checksum(state)
        out[f"{run}.checksums"] = ctx.allgather_ints(sums)
    ctx.barrier()
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    ctx.shutdown()


# ---------------------------------------------------------------- cases


def reference_runs(workdir):
    """The reference's inits on each mesh (saved for the ranks), its
    first-step gradients of ResNet-20's global batch, then its runs."""
    import jax

    from elasticdl_tpu.parallel.mesh import build_mesh
    from elasticdl_tpu.training.trainer import (
        Trainer as JTrainer, _masked_scalar_loss)
    from tests.test_torch_zoo import find_states, specs

    inputs = {}
    for model in ("resnet20", "wide_deep"):
        for i in range(STEPS):
            b = batch(model, 100 + i)
            inputs.update({f"{model}.batch{i}/{k}": v
                           for k, v in flat(b).items()})
    runs, grads = {}, {}
    for run, model, sizes in RUNS:
        n = int(np.prod(list(sizes.values())))
        jspec, _ = specs(model)
        jt = JTrainer(jspec, build_mesh(sizes, jax.devices()[:n]))
        first = batch(model, 100)
        first = {**first, "features": features(model, first)}
        js = jt.init_state(first)
        params, opt, extra, step = jax.device_get(
            (js.params, js.opt_state, js.extra_vars, js.step))
        found = find_states(opt)
        trees = {"params": params, "batch_stats": extra.get("batch_stats",
                                                            {})}
        count = 0
        if "ScaleByAdamState" in found:
            adam = found["ScaleByAdamState"]
            trees.update(mu=adam.mu, nu=adam.nu)
            count = adam.count
        if "TraceState" in found:
            trees["trace"] = found["TraceState"].trace
        for what, tree in trees.items():
            inputs.update({f"{run}.{what}/{k}": v
                           for k, v in flat(tree).items()})
        inputs[f"{run}.count"] = np.asarray(count)
        inputs[f"{run}.step"] = np.asarray(step)
        if model == "resnet20":
            def loss(p):
                out, _ = jspec.model.apply(
                    {"params": p, "batch_stats": extra["batch_stats"]},
                    first["features"], training=True,
                    mutable=["batch_stats"])
                return _masked_scalar_loss(jspec.loss, first["labels"], out,
                                           first["mask"])
            grads[run] = jax.device_get(jax.jit(jax.grad(loss))(params))
        runs[run] = (model, jt, js)
    np.savez(os.path.join(workdir, "inputs.npz"), **inputs)
    ranks = start_ranks(os.path.abspath(__file__), 4, workdir)
    want = {}
    for run, (model, jt, js) in runs.items():
        losses = []
        for i in range(STEPS):
            b = batch(model, 100 + i)
            js, logs = jt.train_step(js, {**b, "features": features(model, b)})
            losses.append(float(logs["loss"]))
        want[run] = (np.array(losses), js)
    return ranks, want, grads


def _whole(parts, run, n, what):
    """`what` ("param", "exp_avg", ...) of a run over ranks [0, n), by
    name: the table's row ranges concatenated, the rest from rank 0."""
    prefix = f"{run}.{what}."
    out = {k[len(prefix):]: v for k, v in parts[0].items()
           if k.startswith(prefix)}
    if TABLE in out:
        shards = sorted((int(p[f"{run}.row_start"]), p[prefix + TABLE])
                        for p in parts[:n])
        out[TABLE] = np.concatenate([s for _, s in shards])
    return out


def case_steps_match_reference(parts, want):
    from tests.test_torch_zoo import assert_close, reference_state

    for run, model, sizes in RUNS:
        n = int(np.prod(list(sizes.values())))
        losses, js = want[run]
        np.testing.assert_allclose(parts[0][f"{run}.losses"], losses,
                                   rtol=1e-5, err_msg=run)
        ref = reference_state(js)
        rtol = 1e-4 if "exp_avg" in ref else 1e-5
        np_of = lambda d: {k: v.numpy() for k, v in d.items()}  # noqa: E731
        assert_close(_whole(parts, run, n, "param"), np_of(ref["params"]),
                     rtol, 1e-4, f"{run} param")
        assert_close(_whole(parts, run, n, "buffer"),
                     np_of(ref.get("buffers", {})), rtol, 1e-5,
                     f"{run} buffer")
        for key in ("exp_avg", "exp_avg_sq", "momentum_buffer"):
            if key in ref:
                assert_close(_whole(parts, run, n, key), np_of(ref[key]),
                             rtol, 2e-3, f"{run} {key}")
        sums = parts[0][f"{run}.checksums"][:n]
        assert (sums == sums[0]).all(), (run, sums)


def case_global_batchnorm_gradients(parts, grads):
    from elasticdl_tpu_torch import convert

    for run, want in grads.items():
        want = {k: v.numpy() for k, v in convert.params_from_flax(want).items()}
        scale = max(np.abs(v).max() for v in want.values())
        for r in range(2 if run.endswith("data2") else 4):
            for k, w in want.items():
                np.testing.assert_allclose(
                    parts[r][f"{run}.grad.{k}"], w, rtol=1e-5,
                    atol=1e-4 * scale, err_msg=f"{run} rank {r} {k}")


def test_zoo_data_parallel_against_the_reference(monkeypatch):
    """Every case above, in one collected test (ROADMAP.md, conventions:
    one collected test per port test file)."""
    for k in COHORT_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("EDL_EMB_SCATTER", "sorted")
    with tempfile.TemporaryDirectory() as workdir:
        ranks, want, grads = reference_runs(workdir)
        wait_ranks(ranks, timeout_s=180)
        parts = [dict(np.load(os.path.join(workdir, f"rank{r}.npz")))
                 for r in range(4)]
        case_global_batchnorm_gradients(parts, grads)
        case_steps_match_reference(parts, want)


if __name__ == "__main__" and sys.argv[1] == "ranks":
    run_ranks(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
