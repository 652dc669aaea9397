"""The port's sequence parallelism (`ops/attention.py`'s ring and Ulysses
over a `seq` mesh axis, and the LM trained on a `seq` mesh) against the
reference, on the CPU.

Four gloo ranks run a plan (`tests/test_torch_lm_parallel.py`'s
harness, `run_ranks`); the reference runs in-process on the conftest's
8-device CPU mesh, where its ring is the XLA recurrence (its `can_flash`
is false off the TPU) and the port's takes the flash kernels' plain
versions.

- Attention on {seq 4} and {data 2, seq 2} at the reference test's shape
  (B 2, T 32, H 4, D 8, float32), each rank holding its rows and columns:
  ring and Ulysses, causal and not, and the ring's gradients of
  sum(out ** 2), against the reference's `sequence_parallel_attention`
  on the same meshes and its `full_attention` (forward atol 2e-5,
  gradients atol 5e-4: `tests/test_attention.py:42,61`); the ring again
  with EDL_FLASH=0, where it takes the float32 recurrence.
- Communication: the ring's forward and backward call no all-gather
  (neither the mesh's nor torch.distributed's) and make n - 1
  point-to-point exchanges each way.
- Fallbacks and errors: with no block, and on {data 2} with no columns,
  `sequence_parallel_attention` is `full_attention` bit for bit; Ulysses
  refuses 3 heads over 4 shards and an unknown mode raises.
- The LM (`vocab=64;num_layers=2;dim=64;heads=4;max_len=64`, float32,
  ring) on {data 2, seq 2} from the reference's converted initial
  params, against the reference `Trainer` on the same mesh: three AdamW
  steps' losses rtol 1e-4, the params after the first and the third step
  by `assert_params_close`, eval's token accuracy equal, its loss pair
  and the predictions rtol 5e-5, every replica bit-equal.
- Ulysses on {seq 2}: the first step's loss equals the reference's
  (rtol 1e-4).
- `remat_policy="dots"` with `grad_accum=2` on {data 2, seq 2}: the first
  loss equals the plain first loss (rel 1e-4, `tests/test_transformer_lm
  .py:114-135`).
- Dropout 0.1 on {data 2, seq 2}: each rank draws the global mask and
  keeps its rows and columns, so the first loss equals the one-process
  port's from the same state (rtol 1e-5).
"""

import os
import sys
import tempfile

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tests.test_torch_cohort_step import unflat  # noqa: E402
from tests.test_torch_lm_parallel import (  # noqa: E402
    COHORT_ENV,
    STEPS,
    TZOO,
    assert_params_close,
    batch_inputs,
    init_inputs,
    lm_spec,
    port_state,
    rank_parts,
    reference_run,
    run_ranks,
    start_plan,
    wait_ranks,
    whole,
)

B, T, H, D = 2, 32, 4, 8
LM = "vocab=64;num_layers=2;dim=64;heads=4;max_len=64"
SEQ = {"data": 2, "seq": 2}
ATTN_MESHES = {"attn_seq4": {"seq": 4}, "attn_d2s2": SEQ}
MODES = [(mode, causal) for mode in ("ring", "ulysses")
         for causal in (False, True)]
PLAN = [
    {"name": name, "sizes": sizes, "probe": "attention"}
    for name, sizes in ATTN_MESHES.items()] + [
    {"name": "attn_data2", "sizes": {"data": 2}, "probe": "fallback"},
    {"name": "ring", "params": LM, "sizes": SEQ, "init": "seq",
     "steps": STEPS, "eval": STEPS},
    {"name": "ulysses", "params": LM + ";seq_parallel=ulysses",
     "sizes": {"seq": 2}, "init": "seq", "steps": 1},
    {"name": "knobs", "params": LM, "sizes": SEQ, "init": "seq",
     "steps": 1, "accum": 2, "remat_policy": "dots"},
    {"name": "dropout", "params": LM + ";dropout=0.1", "sizes": SEQ,
     "init": "seq", "steps": 1},
]


def qkv_inputs():
    r = np.random.RandomState(0)
    return {f"qkv/{n}": r.randn(B, T, H, D).astype(np.float32)
            for n in "qkv"}


# ---------------------------------------------------------------- ranks


class _Calls:
    """Counts the all-gathers and point-to-point batches made while it is
    entered."""

    def __init__(self):
        import torch.distributed as dist

        from elasticdl_tpu_torch.parallel import mesh as mesh_lib

        self.spots = [(mesh_lib, "all_gather"), (dist, "all_gather"),
                      (dist, "all_gather_into_tensor"),
                      (dist, "batch_isend_irecv")]
        self.counts = {}

    def __enter__(self):
        self.saved = [getattr(m, f) for m, f in self.spots]
        for (module, fn), real in zip(self.spots, self.saved):
            def spy(*args, _real=real, _fn=fn, **kwargs):
                self.counts[_fn] = self.counts.get(_fn, 0) + 1
                return _real(*args, **kwargs)
            setattr(module, fn, spy)
        return self

    def __exit__(self, *exc):
        for (module, fn), real in zip(self.spots, self.saved):
            setattr(module, fn, real)


def probe_attention(mesh, tr, state, tree, name):
    """Each rank's blocks of ring and Ulysses (and the ring's gradients),
    the ring's collectives, the recurrence, and the errors."""
    from elasticdl_tpu_torch.ops.attention import sequence_parallel_attention
    from elasticdl_tpu_torch.parallel import mesh as mesh_lib

    qkv = tree("qkv/")
    r0, r1 = mesh_lib.batch_block(mesh, B)
    cols = (T, *mesh_lib.seq_block(mesh, T))

    def local(x, heads=None):
        x = x[r0:r1, cols[1]:cols[2]]
        return torch.tensor(x if heads is None else x[:, :, :heads],
                            requires_grad=True)

    out = {}
    with mesh_lib.batch_block_of(B, r0, r1, mesh, cols):
        for mode, causal in MODES:
            q, k, v = (local(qkv[c]) for c in "qkv")
            with _Calls() as calls:
                o = sequence_parallel_attention(q, k, v, causal, mode)
                if mode == "ring":
                    (o ** 2).sum().backward()
            key = f"{name}.{mode}.{causal}"
            out[f"{key}.out"] = o.detach().numpy()
            if mode == "ring":
                for c, x in zip("qkv", (q, k, v)):
                    out[f"{key}.d{c}"] = x.grad.numpy()
                out[f"{key}.p2p"] = np.array(
                    calls.counts.get("batch_isend_irecv", 0))
                out[f"{key}.gathers"] = np.array(sum(
                    v for f, v in calls.counts.items()
                    if f.startswith("all_gather")))
        os.environ["EDL_FLASH"] = "0"
        try:
            o = sequence_parallel_attention(
                *(local(qkv[c]) for c in "qkv"), True, "ring")
        finally:
            del os.environ["EDL_FLASH"]
        out[f"{name}.recurrence.out"] = o.detach().numpy()
        three = [local(qkv[c], heads=3) for c in "qkv"]
        for label, mode, args in (("ulysses_3_heads", "ulysses", three),
                                  ("unknown_mode", "rings", three)):
            try:
                sequence_parallel_attention(*args, True, mode)
                out[f"{name}.{label}"] = np.array(False)
            except ValueError as e:
                out[f"{name}.{label}"] = np.array(
                    "divisible" in str(e) or "unknown" in str(e))
    return out


def probe_fallback(mesh, tr, state, tree, name):
    """On {data 2}, with the rank's rows and no columns, the attention is
    `full_attention`."""
    from elasticdl_tpu_torch.ops.attention import (
        full_attention, sequence_parallel_attention)
    from elasticdl_tpu_torch.parallel import mesh as mesh_lib

    qkv = tree("qkv/")
    r0, r1 = mesh_lib.batch_block(mesh, B)
    q, k, v = (torch.tensor(qkv[c][r0:r1]) for c in "qkv")
    with mesh_lib.batch_block_of(B, r0, r1, mesh):
        got = sequence_parallel_attention(q, k, v, True, "ring")
    return {f"{name}.equal": np.array(torch.equal(
        got, full_attention(q, k, v, causal=True)))}


PROBES = {"attention": probe_attention, "fallback": probe_fallback}


# ---------------------------------------------------------------- reference


def reference_attention(inputs):
    """The reference's ring and Ulysses on both meshes, the ring's
    gradients, and `full_attention` with its gradients: one jitted
    program a mesh."""
    import jax
    import jax.numpy as jnp

    from elasticdl_tpu.ops.attention import (
        full_attention, sequence_parallel_attention)
    from elasticdl_tpu.parallel.mesh import build_mesh

    q, k, v = (jnp.asarray(inputs[f"qkv/{c}"]) for c in "qkv")

    def grads(fn, causal):
        return jax.grad(lambda q, k, v: (fn(q, k, v, causal=causal) ** 2
                                         ).sum(), argnums=(0, 1, 2))(q, k, v)

    def sharded(q, k, v):
        outs = {(m, c): sequence_parallel_attention(q, k, v, causal=c,
                                                    mode=m)
                for m, c in MODES}
        ring = lambda q, k, v, causal: sequence_parallel_attention(
            q, k, v, causal=causal, mode="ring")
        return outs, {c: grads(ring, c) for c in (False, True)}

    want = {}
    for name, sizes in ATTN_MESHES.items():
        with jax.set_mesh(build_mesh(sizes, jax.devices()[:4])):
            want[name] = jax.device_get(jax.jit(sharded)(q, k, v))
    want["full"] = jax.device_get(jax.jit(lambda q, k, v: (
        {c: full_attention(q, k, v, causal=c) for c in (False, True)},
        {c: grads(full_attention, c) for c in (False, True)}))(q, k, v))
    return want


def assemble(parts, key, sizes):
    """The global (B, T, ...) tensor from every rank's block of `key`."""
    n = int(np.prod(list(sizes.values())))
    data, seq = sizes.get("data", 1), sizes.get("seq", 1)
    rows = [np.concatenate([parts[d * seq + s][key] for s in range(seq)],
                           axis=1) for d in range(data)]
    assert n == data * seq
    return np.concatenate(rows, axis=0)


# ---------------------------------------------------------------- cases


def case_attention_matches_reference(parts, want):
    full_out, full_grads = want["full"]
    for name, sizes in ATTN_MESHES.items():
        outs, ring_grads = want[name]
        n = sizes["seq"]
        for mode, causal in MODES:
            key = f"{name}.{mode}.{causal}"
            got = assemble(parts, f"{key}.out", sizes)
            for ref in (outs[(mode, causal)], full_out[causal]):
                np.testing.assert_allclose(got, np.asarray(ref), atol=2e-5,
                                           err_msg=key)
            if mode != "ring":
                continue
            for i, c in enumerate("qkv"):
                g = assemble(parts, f"{key}.d{c}", sizes)
                for ref in (ring_grads[causal][i], full_grads[causal][i]):
                    np.testing.assert_allclose(g, np.asarray(ref),
                                               atol=5e-4, err_msg=key + c)
            for p in parts:
                assert int(p[f"{key}.gathers"]) == 0, key
                assert int(p[f"{key}.p2p"]) == 2 * (n - 1), key
        np.testing.assert_allclose(
            assemble(parts, f"{name}.recurrence.out", sizes),
            np.asarray(outs[("ring", True)]), atol=2e-5, err_msg=name)
        for p in parts:
            assert bool(p[f"{name}.ulysses_3_heads"]), name
            assert bool(p[f"{name}.unknown_mode"]), name


def case_fallbacks(parts, inputs):
    from elasticdl_tpu_torch.ops.attention import (
        full_attention, sequence_parallel_attention)

    for p in parts[:2]:
        assert bool(p["attn_data2.equal"])
    q, k, v = (torch.tensor(inputs[f"qkv/{c}"]) for c in "qkv")
    for mode in ("ring", "ulysses"):
        assert torch.equal(sequence_parallel_attention(q, k, v, True, mode),
                           full_attention(q, k, v, causal=True))


def case_lm_matches_reference(parts, want):
    states, pred = want["states"], want["pred"]
    np.testing.assert_allclose(parts[0]["ring.losses"], want["losses"],
                               rtol=1e-4)
    assert_params_close(whole(parts, "ring", 4, "param1"), want["first"],
                        "ring", 1)
    assert_params_close(whole(parts, "ring", 4), want["params"], "ring",
                        STEPS)
    for p in parts:
        np.testing.assert_array_equal(p["ring.eval.token_accuracy"],
                                      np.asarray(states["token_accuracy"]))
        np.testing.assert_allclose(p["ring.eval._loss"],
                                   np.asarray(states["_loss"]), rtol=5e-5)
        np.testing.assert_allclose(p["ring.pred"], pred, rtol=5e-5,
                                   atol=5e-5 * np.abs(pred).max())
    first = want["losses"][0]
    np.testing.assert_allclose(parts[0]["ulysses.losses"][0], first,
                               rtol=1e-4)
    whole(parts, "ulysses", 2)
    assert parts[0]["knobs.losses"][0] == pytest.approx(
        parts[0]["ring.losses"][0], rel=1e-4)
    whole(parts, "knobs", 4)


def case_dropout_is_the_one_process_draw(parts, batches, inputs):
    """The {data 2, seq 2} dropout step's loss against the one-process
    port's from the same state and generator."""
    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.training.model_spec import ModelSpec
    from elasticdl_tpu_torch.training.trainer import Trainer

    tr = Trainer(lm_spec(TZOO, JobConfig, ModelSpec, LM + ";dropout=0.1"),
                 device="cpu")
    state = port_state(tr, *(
        unflat({k[len(p):]: v for k, v in inputs.items() if k.startswith(p)})
        for p in ("seq/params/", "seq/losses/")))
    loss = float(tr.train_step(state, batches[0])[1]["loss"])
    np.testing.assert_allclose(parts[0]["dropout.losses"][0], loss,
                               rtol=1e-5)
    whole(parts, "dropout", 4)
    assert abs(loss - parts[0]["ring.losses"][0]) > 1e-3


def test_sequence_parallel_against_the_reference(monkeypatch):
    """Every case above, in one collected test (ROADMAP.md, conventions:
    one collected test per port test file)."""
    for k in COHORT_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.delenv("EDL_FLASH", raising=False)
    with tempfile.TemporaryDirectory() as workdir:
        batches, inputs = batch_inputs(STEPS + 1)
        inputs.update(qkv_inputs())
        want = reference_run(LM, SEQ, batches, STEPS,
                             eval_batch=batches[STEPS])
        inputs.update(init_inputs("seq", want))
        ranks = start_plan(workdir, PLAN, inputs, os.path.abspath(__file__))
        try:
            want_attn = reference_attention(inputs)
        finally:
            wait_ranks(ranks, timeout_s=120)
        parts = rank_parts(workdir)
        case_attention_matches_reference(parts, want_attn)
        case_fallbacks(parts, inputs)
        case_lm_matches_reference(parts, want)
        case_dropout_is_the_one_process_draw(parts, batches, inputs)


if __name__ == "__main__" and sys.argv[1] == "ranks":
    run_ranks(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5],
              probes=PROBES)
