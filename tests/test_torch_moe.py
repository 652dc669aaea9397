"""The port's Switch-MoE (`ops/moe.py`, `api.layers.MoE`) and the MoE LM
against the reference, on the CPU.

- `switch_moe` against `tests/test_moe.py`'s per-token twin with ample
  capacity (rtol 1e-4, atol 1e-5, as there), and its capacity-drop
  case: a router forced onto expert 0 keeps exactly Cap tokens.
- The index route against the dense plain route (the reference's
  one-hot dispatch), at three capacity factors: outputs and aux bit for
  bit, the expert kernels' gradients bit for bit, the tokens', router's
  and last bias's gradients (sums in another order) rtol 1e-6 with atol
  1e-6 of each one's largest value.
- The `MoE` layer against the reference's layer from the same params
  (converted): output and aux atol 1e-6.
- The trainer's aux loss: one SGD step of a small MoE model with weight
  0.5 reports loss_0 + 0.5 x aux (rel 1e-4, as `tests/test_moe.py:168`)
  and changes the update.
- The float32 MoE LM (vocab 64, 2 layers, dim 64, 4 heads, 4 experts,
  aux weight 0.01) from the reference's initial params: three AdamW
  steps, plain, with `grad_accum=2` and with remat, against the
  reference's same runs (with remat its materialized attention: its
  Pallas kernels do not run under `jax.checkpoint` in interpret mode):
  losses rtol 1e-4, params after the first and the third step as
  `tests/test_torch_lm_parallel.assert_params_close` holds them, each
  block's `moe_aux` rtol 1e-5.
- The same LM on {data 2, expert 2} in four gloo ranks (the harness of
  `tests/test_torch_lm_parallel.py`) against the reference's same mesh,
  the same way, replicas equal bit for bit; and one MoE layer's forward
  and backward there moves only token-sized tensors between ranks, never
  expert-weight-sized ones (the twin of `tests/test_moe.py:134`).
"""

import os
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tests.test_torch_lm_parallel import (  # noqa: E402
    COHORT_ENV,
    LM,
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

MOE_LM = LM + ";moe_experts=4"
MESH = {"data": 2, "expert": 2}
PLAN = [{"name": "moe", "params": MOE_LM, "sizes": MESH, "init": "moe",
         "steps": STEPS, "probe": "collectives"}]


def _t(a, grad=False):
    return torch.tensor(np.asarray(a, np.float32), requires_grad=grad)


def case_switch_moe_matches_per_token_twin():
    from tests.test_moe import C, E, N, make_weights, reference_moe

    from elasticdl_tpu_torch.ops import moe

    w = make_weights()
    x = np.random.RandomState(1).randn(N, C).astype(np.float32)
    names = ("wg", "w1", "b1", "w2", "b2")
    out, aux = moe.switch_moe(_t(x), *(_t(w[k]) for k in names),
                              capacity_factor=float(E))
    np.testing.assert_allclose(out.numpy(), reference_moe(x, w), rtol=1e-4,
                               atol=1e-5)
    assert float(aux) > 0.0
    # the router forced onto expert 0: only its first Cap tokens pass
    w["wg"] = np.zeros((C, E), np.float32)
    w["wg"][:, 0] = 10.0
    x = np.abs(np.random.RandomState(2).randn(N, C)).astype(np.float32) + 0.1
    out, _ = moe.switch_moe(_t(x), *(_t(w[k]) for k in names),
                            capacity_factor=0.25)
    rows = np.any(np.abs(out.numpy()) > 1e-9, axis=-1)
    cap = max(1, int(0.25 * N / E))
    assert rows.sum() == cap and rows[:cap].all(), rows


def case_index_route_equals_dense_route():
    from elasticdl_tpu_torch.ops import moe

    r = np.random.RandomState(5)
    n, c, e, h = 96, 16, 4, 32
    for cf in (0.5, 1.25, 4.0):
        x = r.randn(n, c).astype(np.float32)
        ws = [r.randn(c, e), r.randn(e, c, h) * 0.1, r.randn(e, h) * 0.1,
              r.randn(e, h, c) * 0.1, r.randn(e, c) * 0.1]
        g = _t(r.randn(n, c))
        results = []
        for fn in (moe.switch_moe, moe.switch_moe_plain):
            args = [_t(x, True)] + [_t(w, True) for w in ws]
            out, aux = fn(*args, capacity_factor=cf)
            grads = torch.autograd.grad((out * g).sum() + aux, args)
            results.append((out, aux, grads))
        (o1, a1, g1), (o2, a2, g2) = results
        assert torch.equal(o1, o2) and torch.equal(a1, a2), cf
        for name, p, q in zip(("x", "wg", "w1", "b1", "w2", "b2"), g1, g2):
            if name in ("w1", "b1", "w2"):
                assert torch.equal(p, q), (cf, name)
            else:
                np.testing.assert_allclose(
                    p.numpy(), q.numpy(), rtol=1e-6,
                    atol=1e-6 * float(q.abs().max()), err_msg=name)


def case_layer_matches_reference_layer():
    import flax.linen as nn
    import jax

    from elasticdl_tpu.api.layers import MoE as JMoE
    from elasticdl_tpu_torch import convert
    from elasticdl_tpu_torch.api.layers import MoE

    c, e, h = 8, 4, 16
    x = np.random.RandomState(3).randn(4, 8, c).astype(np.float32)
    layer = JMoE(num_experts=e, hidden_dim=h)
    variables = nn.meta.unbox(layer.init(jax.random.PRNGKey(0), x))
    want, sown = layer.apply(variables, x, mutable=["losses"])
    port = MoE(c, e, h)
    port.load_state_dict({**convert.params_from_flax(
        jax.device_get(variables["params"])), "moe_aux": torch.zeros(())})
    got = port(_t(x), training=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-6)
    np.testing.assert_allclose(float(port.pending.detach()),
                               float(sown["losses"]["moe_aux"]), atol=1e-6)


def case_aux_loss_enters_training_loss():
    from elasticdl_tpu_torch.api.layers import Dense, MoE, reset_tree
    from elasticdl_tpu_torch.training.model_spec import ModelSpec
    from elasticdl_tpu_torch.training.trainer import Trainer

    c, e, h = 8, 4, 16

    class M(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.inp, self.moe, self.out = (Dense(c, c), MoE(c, e, h),
                                            Dense(c, 1))

        def reset_parameters(self, generator=None):
            reset_tree(self, generator)

        def forward(self, feats, training=False, generator=None):
            return self.out(self.moe(self.inp(feats), training)).reshape(-1)

    r = np.random.RandomState(0)
    feats = r.randn(32, c).astype(np.float32)
    batch = {"features": feats, "labels": (feats[:, 0] > 0).astype(
        np.float32), "mask": np.ones((32,), np.float32)}

    def one_step(weight):
        spec = ModelSpec(
            model=M(),
            loss=lambda l, o: torch.nn.functional.
            binary_cross_entropy_with_logits(o, l.float(), reduction="none"),
            optimizer=lambda params: torch.optim.SGD(params, lr=0.1),
            dataset_fn=None, eval_metrics_fn=None, aux_loss_weight=weight)
        t = Trainer(spec, device="cpu", seed=0)
        state = t.init_state(batch)
        state, logs = t.train_step(state, batch)
        return state, float(logs["loss"])

    state0, loss0 = one_step(0.0)
    state_w, loss_w = one_step(0.5)
    aux = float(state_w.buffers["moe.moe_aux"])
    assert abs(loss_w - (loss0 + 0.5 * aux)) <= 1e-4 * abs(loss_w), (
        loss_w, loss0, aux)
    assert not torch.allclose(state0.params["moe.router"],
                              state_w.params["moe.router"])


def _aux_of(extra_vars):
    losses = extra_vars["losses"]
    return {f"{blk}.moe.moe_aux": float(np.asarray(v["moe"]["moe_aux"]))
            for blk, v in losses.items()}


def case_moe_lm_matches_reference(batches):
    """The one-process MoE LM: plain, accumulation 2 and remat."""
    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.training.model_spec import ModelSpec
    from elasticdl_tpu_torch.training.trainer import Trainer

    for knobs in ({}, {"accum": 2}, {"remat": True}):
        want = reference_run(MOE_LM, {"data": 1}, batches, STEPS, **knobs)
        first, params = want["first"], want["params"]
        spec = lm_spec(TZOO, JobConfig, ModelSpec, MOE_LM)
        assert spec.aux_loss_weight == 0.01
        tr = Trainer(spec, device="cpu", grad_accum=knobs.get("accum", 1),
                     remat=knobs.get("remat", False))
        state = port_state(tr, want["init"], want["init_losses"])
        got = []
        for i, b in enumerate(batches[:STEPS]):
            got.append(float(tr.train_step(state, b)[1]["loss"]))
            snap = {k: p.detach().numpy().copy()
                    for k, p in state.params.items()}
            if i == 0:
                assert_params_close(snap, first, str(knobs), 1)
        np.testing.assert_allclose(got, want["losses"], rtol=1e-4,
                                   err_msg=str(knobs))
        assert_params_close(snap, params, str(knobs), STEPS)
        for k, v in _aux_of(want["extra"]).items():
            np.testing.assert_allclose(float(state.buffers[k]), v, rtol=1e-5,
                                       err_msg=k)


def case_expert_mesh_matches_reference(parts, want):
    np.testing.assert_allclose(parts[0]["moe.losses"], want["losses"],
                               rtol=1e-4)
    assert_params_close(whole(parts, "moe", 4, "param1"), want["first"],
                        "moe", 1)
    assert_params_close(whole(parts, "moe", 4), want["params"], "moe", STEPS)
    d, start, stop = parts[1]["moe.shard.block_0.moe.w1"]
    assert (d, stop - start) == (0, 2), (d, start, stop)
    for k, v in _aux_of(want["extra"]).items():
        for p in parts:
            np.testing.assert_allclose(p[f"moe.buffer.{k}"], v, rtol=1e-5,
                                       err_msg=k)
    sizes = parts[0]["moe.collective_sizes"]
    assert len(sizes) and sizes.max() < parts[0]["moe.weight_elems"], sizes


def probe_collectives(mesh, tr, state, tree, name):
    """The element counts of every collective one MoE layer's forward and
    backward makes on this mesh, under the trainer's data block."""
    import torch.distributed as dist

    from elasticdl_tpu_torch.parallel import mesh as mesh_lib

    layer = tr.model.block_0.moe
    b = tree("batch0/")["features"].shape[0]
    start, stop = mesh_lib.batch_block(mesh, b)
    x = torch.randn((stop - start) * 32, 64, requires_grad=True,
                    generator=torch.Generator().manual_seed(0))
    sizes, real = [], {}
    for fn in ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
               "broadcast", "send", "recv"):
        real[fn] = getattr(dist, fn)

        def spy(t, *a, _fn=real[fn], **k):
            sizes.append(t.numel())
            return _fn(t, *a, **k)
        setattr(dist, fn, spy)
    try:
        with mesh_lib.batch_block_of(b, start, stop, mesh):
            out = layer(x, training=False)
            out.square().sum().backward()
    finally:
        for fn, f in real.items():
            setattr(dist, fn, f)
    return {f"{name}.collective_sizes": np.array(sizes),
            f"{name}.weight_elems": np.array(4 * 64 * 256)}


def test_moe_against_the_reference(monkeypatch):
    """Every case above, in one collected test (ROADMAP.md, conventions:
    one collected test per port test file)."""
    for k in COHORT_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.delenv("EDL_FLASH", raising=False)
    with tempfile.TemporaryDirectory() as workdir:
        batches, inputs = batch_inputs(STEPS + 1)
        want = reference_run(MOE_LM, MESH, batches, STEPS)
        inputs.update(init_inputs("moe", want))
        ranks = start_plan(workdir, PLAN, inputs, os.path.abspath(__file__))
        try:
            case_switch_moe_matches_per_token_twin()
            case_index_route_equals_dense_route()
            case_layer_matches_reference_layer()
            case_aux_loss_enters_training_loss()
            case_moe_lm_matches_reference(batches)
        finally:
            wait_ranks(ranks, timeout_s=120)
        case_expert_mesh_matches_reference(rank_parts(workdir), want)


if __name__ == "__main__" and sys.argv[1] == "ranks":
    run_ranks(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5],
              probes={"collectives": probe_collectives})
