"""`Trainer.train_step_cost` against the reference's cost of its step, on
the CPU.

- Products: DeepFM (field_vocab 1000, hidden 32,32), the LM (2 layers,
  dim 64, 4 heads, T 64) and MNIST's CNN at batch 8, all float32, each
  pair of trainers from the reference's initial params (converted) and
  one numpy batch. The port's 'flops' equals, exactly, the dot_general
  and conv_general_dilated FLOPs of the reference's jitted step, counted
  from `jax.make_jaxpr` with every sub-jaxpr visited (`products`; a
  convolution counts the multiply-adds that read real input positions,
  as `training/step_cost.conv_flops` does). The reference's LM is traced
  with EDL_FLASH=0, its materialized attention; the port's goes through
  `edl::flash_fwd` and `edl::flash_bwd`, counted by formula, and its
  materialized body (EDL_FLASH=0) counts the same. The port's 'flops' is
  at most the reference's `train_step_cost` (XLA's, which adds the
  elementwise ops), and its 'bytes accessed' within BYTES_BAND of
  XLA's (0.34-0.46 measured: XLA's pre-fusion count also moves every
  broadcast and convert).
- The MoE LM (4 experts, capacity factor 1.25) at the same width: the
  reference's count exceeds the port's by the dense dispatch's one-hot
  products, 10 N E Cap C a layer, which the port's index route does not
  compute.
- State: the LM with dropout 0.1 after one AdamW step; a cost call
  leaves params, gradients, Adam's slots, the step and the generator
  bit-equal, and the next step equals the step of a twin that made no
  cost call. The result is memoized by the (state, batch) signature; a
  batch of another size is costed anew, and accumulation 2 counts the
  products of accumulation 1.
- The ring: `ops/attention.ring_attention_local` over 2 causal blocks,
  forward and backward, counts the FLOPs of one unsplit
  `flash_attention`, 12 B H T^2 D.

Nothing is compiled: the reference's steps are traced and lowered only.
"""

import contextlib
import os
import sys

import jax
import numpy as np
import pytest
import torch
from jax.extend import core as jcore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from elasticdl_tpu.parallel import mesh as jmesh  # noqa: E402
from elasticdl_tpu.parallel.mesh import build_mesh  # noqa: E402
from elasticdl_tpu.training.trainer import Trainer as JTrainer  # noqa: E402
from elasticdl_tpu_torch.ops import attention  # noqa: E402
from elasticdl_tpu_torch.ops import flash_attention as fa  # noqa: E402
from elasticdl_tpu_torch.training import step_cost  # noqa: E402
from elasticdl_tpu_torch.training.trainer import Trainer  # noqa: E402
from tests.test_torch_trainer import (  # noqa: E402
    TZOO, _deepfm_batch, _lm_batch, _pair, _specs)

DEEPFM = ("deepfm.deepfm.custom_model", "field_vocab=1000;hidden=32,32")
LM = ("transformer.transformer_lm.custom_model",
      "vocab=64;num_layers=2;dim=64;heads=4;max_len=64")
MNIST = ("mnist.mnist_cnn.custom_model", "")
MOE_EXPERTS, MOE_CAPACITY = 4, 1.25
BYTES_BAND = (0.25, 0.75)


@contextlib.contextmanager
def flash_off():
    """EDL_FLASH=0 within: both packages take their materialized
    attention."""
    old = os.environ.get("EDL_FLASH")
    os.environ["EDL_FLASH"] = "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["EDL_FLASH"]
        else:
            os.environ["EDL_FLASH"] = old


def _jaxprs(value):
    if isinstance(value, jcore.ClosedJaxpr):
        yield value.jaxpr
    elif isinstance(value, jcore.Jaxpr):
        yield value
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _jaxprs(v)


def _conv_taps(size_in, size_out, kernel, stride, pad, lhs_dil, rhs_dil):
    """(output position, tap) pairs that read a real input position of a
    dilated, padded input."""
    n = 0
    for o in range(size_out):
        for t in range(kernel):
            pos = o * stride + t * rhs_dil - pad
            n += 0 <= pos <= (size_in - 1) * lhs_dil and pos % lhs_dil == 0
    return n


def products(jaxpr) -> int:
    """dot_general and conv_general_dilated FLOPs of `jaxpr` and every
    sub-jaxpr in its equations' params."""
    total = 0
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        shapes = [v.aval.shape for v in (*eqn.invars[:2], eqn.outvars[0])]
        if name == "dot_general":
            (contract, _), _ = eqn.params["dimension_numbers"]
            lhs, _, out = shapes
            total += 2 * int(np.prod(out)) * int(
                np.prod([lhs[i] for i in contract]))
        elif name == "conv_general_dilated":
            p, dn = eqn.params, eqn.params["dimension_numbers"]
            lhs, rhs, out = shapes
            flops = 2 * out[dn.out_spec[0]] * out[dn.out_spec[1]] * rhs[
                dn.rhs_spec[1]]
            for i in range(len(dn.lhs_spec) - 2):
                flops *= _conv_taps(
                    lhs[dn.lhs_spec[2 + i]], out[dn.out_spec[2 + i]],
                    rhs[dn.rhs_spec[2 + i]], p["window_strides"][i],
                    p["padding"][i][0], p["lhs_dilation"][i],
                    p["rhs_dilation"][i])
            total += flops
        for value in eqn.params.values():
            for sub in _jaxprs(value):
                total += products(sub)
    return total


def reference_cost(jt, js, batch):
    """(the products of the reference's jitted step, its
    `train_step_cost`), traced and lowered with EDL_FLASH=0."""
    with flash_off():
        fn = jt._ensure("_train_step", "train_step", jt._build_train_step)
        sharded = jmesh.shard_batch(jt.mesh, batch, jt.spec.batch_partition)
        with jax.set_mesh(jt.mesh):
            jaxpr = jax.make_jaxpr(fn)(js, sharded)
        return products(jaxpr.jaxpr), jt.train_step_cost(js, batch)


def _mnist_batch(seed, b=8):
    r = np.random.RandomState(seed)
    return {"features": r.rand(b, 28, 28, 1).astype(np.float32),
            "labels": r.randint(0, 10, (b,)).astype(np.int32)}


# ---------------------------------------------------------------- cases


def case_products_match_reference():
    ratios = {}
    for (model_def, params), batch in ((DEEPFM, _deepfm_batch(1, 64)),
                                       (LM, _lm_batch(1, 8, 64)),
                                       (MNIST, _mnist_batch(2))):
        jspec, tspec = _specs(model_def, params)
        jt, js, tt, ts = _pair(jspec, tspec, batch)
        want, xla = reference_cost(jt, js, batch)
        got = tt.train_step_cost(ts, batch)
        assert set(got) == {"flops", "bytes accessed"}
        assert got["flops"] == want, (model_def, got, want)
        assert 0 < got["flops"] <= xla["flops"], (model_def, got, xla)
        ratios[model_def] = got["bytes accessed"] / xla["bytes accessed"]
        if model_def == LM[0]:
            with flash_off():
                plain = Trainer(tspec, device="cpu").train_step_cost(
                    ts, batch)
            assert plain["flops"] == want
    for model_def, ratio in ratios.items():
        assert BYTES_BAND[0] <= ratio <= BYTES_BAND[1], ratios


def case_moe_gap_is_the_dense_dispatch():
    jspec, tspec = _specs(LM[0], f"{LM[1]};moe_experts={MOE_EXPERTS}")
    b, t = 8, 64
    batch = _lm_batch(3, b, t)
    # the products do not depend on the weights: each side draws its own
    jt = JTrainer(jspec, build_mesh(devices=jax.devices()[:1]), seed=0)
    want, _ = reference_cost(jt, jt.init_state(batch), batch)
    tt = Trainer(tspec, device="cpu")
    got = tt.train_step_cost(tt.init_state(batch), batch)
    n, c, layers = b * t, 64, 2
    cap = int(MOE_CAPACITY * n / MOE_EXPERTS)
    moe_gap = 10 * n * MOE_EXPERTS * cap * c * layers
    assert want - got["flops"] == moe_gap, (want, got, moe_gap)


def case_state_is_left_alone():
    (spec_a,) = _specs(LM[0], LM[1] + ";dropout=0.1", roots=(TZOO,))
    (spec_b,) = _specs(LM[0], LM[1] + ";dropout=0.1", roots=(TZOO,))
    batch = _lm_batch(4, 8, 64)
    a, b = Trainer(spec_a, device="cpu"), Trainer(spec_b, device="cpu")
    sa, sb = a.init_state(batch), b.init_state(batch)
    b.model.load_state_dict(a.model.state_dict())
    for tr, s in ((a, sa), (b, sb)):
        tr.train_step(s, batch)
    params = {n: p.detach().clone() for n, p in sa.params.items()}
    grads = {n: p.grad.clone() for n, p in sa.params.items()}
    slots = {n: {k: v.clone() for k, v in sa.optimizer.state[p].items()}
             for n, p in sa.params.items()}
    generator = sa.generator.get_state()

    cost = a.train_step_cost(sa, batch)
    assert sa.step == 1
    assert torch.equal(sa.generator.get_state(), generator)
    for n, p in sa.params.items():
        assert torch.equal(p, params[n]) and torch.equal(p.grad, grads[n]), n
        state = sa.optimizer.state[p]
        assert state.keys() == slots[n].keys(), n
        for k, v in slots[n].items():
            assert torch.equal(state[k], v), (n, k)
    (_, la), (_, lb) = (tr.train_step(s, batch) for tr, s in ((a, sa),
                                                            (b, sb)))
    assert torch.equal(la["loss"], lb["loss"])
    for n, p in sa.params.items():
        assert torch.equal(p, sb.params[n]), n

    # memoized by signature; another batch size is another program
    assert a.train_step_cost(sa, batch) == cost and len(a._cost_cache) == 1
    half = {k: v[:4] for k, v in batch.items()}
    assert a.train_step_cost(sa, half)["flops"] < cost["flops"]
    assert len(a._cost_cache) == 2

    # accumulation splits the batch, not its products
    (one,) = _specs(*DEEPFM, roots=(TZOO,))
    (two,) = _specs(*DEEPFM, roots=(TZOO,))
    fm_batch = _deepfm_batch(5, 32)
    t1, t2 = Trainer(one, device="cpu"), Trainer(two, device="cpu",
                                                 grad_accum=2)
    assert (t1.train_step_cost(t1.init_state(fm_batch), fm_batch)["flops"]
            == t2.train_step_cost(t2.init_state(fm_batch),
                                  fm_batch)["flops"])


def case_ring_counts_as_unsplit():
    gen = torch.Generator().manual_seed(6)
    b, t, h, d = 2, 32, 2, 16
    q, k, v, dout = (torch.randn((b, t, h, d), generator=gen)
                     for _ in range(4))

    def fwd_bwd(fn):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        with step_cost.StepCost() as cost:
            torch.autograd.grad(fn(*leaves), leaves, dout)
        return cost.flops

    ring = fwd_bwd(lambda *x: attention.ring_attention_local(*x, 2))
    unsplit = fwd_bwd(fa.flash_attention)
    assert ring == unsplit == 12 * b * h * t * t * d, (ring, unsplit)


def test_step_cost_against_the_reference():
    """The cases in turn: one collected test keeps the xdist loadfile
    schedule of the reference's test files as it was."""
    case_products_match_reference()
    case_moe_gap_is_the_dense_dispatch()
    case_state_is_left_alone()
    case_ring_counts_as_unsplit()


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
