"""The port's layers (`Embedding`, and `LayerNorm` and `Embed` against
flax's) and streaming metrics against the reference, on the CPU.

Metric states must be identical float32 arrays (the master merges raw
states from any worker); the inputs are chosen so every sum is exact in
float32, which makes "identical" a fair demand of two libraries.
LayerNorm is held to rtol 1e-6 in float32 (the same float32 statistics
and one rounding, in another summation order) and to one bf16 ulp (rtol
2**-8) when it casts to bfloat16 at the end.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.api.layers import Embedding as JEmbedding
from elasticdl_tpu.training import metrics as jm
from elasticdl_tpu_torch.api.layers import Dense, Embed, Embedding, LayerNorm
from elasticdl_tpu_torch.training import metrics as tm


def case_embedding_forward_matches_with_converted_table(combiner):
    r = np.random.RandomState(0)
    vocab, d = 1000, 8
    ids = r.randint(-1, vocab, (16, 6)).astype(np.int32)
    jlayer = JEmbedding(vocab, d, combiner=combiner, mode="auto")
    params = jlayer.init(jax.random.PRNGKey(0), jnp.asarray(ids))
    table = np.array(jax.tree_util.tree_leaves(params)[0])
    tlayer = Embedding(vocab, d, combiner=combiner, mode="auto")
    assert tuple(tlayer.table.shape) == table.shape == (1024, d)
    tlayer.load_state_dict({"table": torch.from_numpy(table)})
    want = np.asarray(jlayer.apply(params, jnp.asarray(ids)))
    got = tlayer(torch.from_numpy(ids)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def case_initializers_follow_flax_distributions():
    """U[0, 0.05) for the table (flax's uniform is one-sided); truncated
    lecun_normal (std sqrt(1/fan_in), within 2 stds of the untruncated
    scale) and zero bias for Dense."""
    g = torch.Generator().manual_seed(0)
    emb = Embedding(70_000, 4)
    emb.reset_parameters(g)
    t = emb.table.detach()
    assert t.shape == (73_728, 4)            # 8192-aligned above 64k rows
    assert 0.0 <= t.min() and t.max() < 0.05
    assert abs(t.mean().item() - 0.025) < 1e-3
    dense = Dense(400, 300)
    dense.reset_parameters(g)
    w = dense.weight.detach()
    assert abs(w.std().item() - (1 / 400) ** 0.5) < 2e-3
    assert w.abs().max().item() <= 2 * (1 / 400) ** 0.5 / 0.8796256610342398
    assert not dense.bias.detach().any()
    embed = Embed(5000, 64)
    embed.reset_parameters(g)
    e = embed.embedding.detach()
    assert abs(e.mean().item()) < 2e-3
    assert abs(e.std().item() - (1 / 64) ** 0.5) < 2e-3   # N(0, 1/features)
    norm = LayerNorm(64)
    norm.reset_parameters(g)
    assert bool((norm.scale == 1).all()) and not norm.bias.detach().any()


def case_layernorm_and_embed_match_flax(dtype):
    r = np.random.RandomState(1)
    x = (r.randn(4, 7, 64) * 3 + 1.5).astype(np.float32)
    scale = r.randn(64).astype(np.float32)
    bias = r.randn(64).astype(np.float32)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jx = jnp.asarray(x, jdt)
    want = nn.LayerNorm(dtype=jdt).apply(
        {"params": {"scale": scale, "bias": bias}}, jx)
    layer = LayerNorm(64, dtype=tdt)
    layer.load_state_dict({"scale": torch.from_numpy(scale),
                           "bias": torch.from_numpy(bias)})
    got = layer(torch.from_numpy(np.array(jx, np.float32)).to(tdt))
    assert got.dtype == tdt
    rtol = 1e-6 if dtype == "float32" else 2.0 ** -8
    np.testing.assert_allclose(got.to(torch.float32).detach().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=rtol * np.abs(np.asarray(want)).max())
    table = r.randn(50, 8).astype(np.float32)
    ids = r.randint(0, 50, (3, 5)).astype(np.int32)
    want = nn.Embed(50, 8).apply({"params": {"embedding": table}}, ids)
    embed = Embed(50, 8)
    embed.load_state_dict({"embedding": torch.from_numpy(table)})
    np.testing.assert_array_equal(
        embed(torch.from_numpy(ids)).detach().numpy(), np.asarray(want))


def _metric_batches():
    r = np.random.RandomState(7)
    for b in range(3):
        labels = r.randint(0, 2, (256,)).astype(np.int32)
        # logits on a 1/8 grid: sums of these and of 0/1 masks are exact
        outputs = (r.randint(-40, 40, (256,)) / 8.0).astype(np.float32)
        mask = (r.rand(256) > 0.2).astype(np.float32) if b else None
        yield labels, outputs, mask


def case_metric_states_identical(name):
    make = {
        "mean": lambda m: m.Mean(),
        "accuracy": lambda m: m.Accuracy(),
        "accuracy_probs": lambda m: m.Accuracy(from_logits=False),
        "auc": lambda m: m.AUC(),
    }[name]
    jmetric, tmetric = make(jm), make(tm)
    js, ts = jmetric.init_state(), tmetric.init_state()
    assert js.shape == ts.shape and ts.dtype == np.float32
    for labels, outputs, mask in _metric_batches():
        js = np.asarray(jmetric.update(
            js, jnp.asarray(labels), jnp.asarray(outputs),
            None if mask is None else jnp.asarray(mask)))
        ts = tmetric.update(
            ts, torch.from_numpy(labels), torch.from_numpy(outputs),
            None if mask is None else torch.from_numpy(mask))
        assert isinstance(ts, np.ndarray) and ts.dtype == np.float32
        np.testing.assert_array_equal(ts, js)
    assert tmetric.result(ts) == jmetric.result(js)
    assert tm.results({"m": tmetric}, {"m": ts}) == jm.results(
        {"m": jmetric}, {"m": js})


def case_accuracy_multiclass_state_identical():
    r = np.random.RandomState(8)
    labels = r.randint(0, 5, (128,)).astype(np.int32)
    logits = r.randn(128, 5).astype(np.float32)
    js = np.asarray(jm.Accuracy().update(
        jm.Accuracy().init_state(), jnp.asarray(labels), jnp.asarray(logits)))
    ts = tm.Accuracy().update(
        tm.Accuracy().init_state(), torch.from_numpy(labels),
        torch.from_numpy(logits))
    np.testing.assert_array_equal(ts, js)


def test_layers_and_metrics_against_the_reference():
    """Every case above, in one collected test (ROADMAP.md, conventions:
    one collected test per port test file)."""
    for combiner in (None, "sum", "mean", "sqrtn"):
        case_embedding_forward_matches_with_converted_table(combiner)
    case_initializers_follow_flax_distributions()
    for dtype in ("float32", "bfloat16"):
        case_layernorm_and_embed_match_flax(dtype)
    for name in ("mean", "accuracy", "accuracy_probs", "auc"):
        case_metric_states_identical(name)
    case_accuracy_multiclass_state_identical()
