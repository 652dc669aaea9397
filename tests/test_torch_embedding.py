"""The port's embedding ops and K1's plain version against the reference,
on the CPU.

K1 (`place_sorted_grads`) is a CUDA kernel in the port; on a CPU tensor
its wrapper runs the plain version, which these tests hold against (a)
the reference's real Pallas kernel run in interpret mode — with the
reference's own normalized atol 2e-5, because that kernel splits f32 into
a bf16 hi+lo pair (~4e-6 rel) — and (b) the reference's exact sorted
segment-sum backward (`EDL_EMB_SCATTER=sorted`), within rtol 1e-5 /
atol 1e-6 (both sum in f32 in stream order; only rounding can differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.ops import embedding as jemb
from elasticdl_tpu_torch.ops import embedding as temb
from elasticdl_tpu_torch.ops import placement


def _ids_and_weights(d, ids_kind, seed=31, V=2048):
    r = np.random.RandomState(seed)
    ids = r.randint(0, V, (64, 81)).astype(np.int32)
    if ids_kind == "skewed":
        ids[:, :60] = 7
    elif ids_kind == "with_padding":
        ids[:, 60:] = -1
    elif ids_kind == "boundary":
        ids[:, :4] = np.array([0, V - 1, V, temb.OOB_ID], np.int32)
    w = r.randn(64, 81, d).astype(np.float32)
    return ids, w


def _jax_table_grad(V, d, ids, w):
    t = jnp.asarray(np.zeros((V, d), np.float32))
    return np.asarray(jax.jit(jax.grad(
        lambda t: jnp.sum(
            jemb.embedding_lookup(t, jnp.asarray(ids), mode="auto") * w)
    ))(t))


def _torch_table_grad(V, d, ids, w):
    t = torch.zeros((V, d), dtype=torch.float32, requires_grad=True)
    out = temb.embedding_lookup(t, torch.from_numpy(ids), mode="auto")
    (g,) = torch.autograd.grad(torch.sum(out * torch.from_numpy(w)), t)
    return g.numpy()


def case_plain_k1_matches_pallas_interpret(monkeypatch, d, ids_kind):
    """The plain version against the reference's Mosaic kernel, run in
    interpret mode with small blocks (several grid steps, ragged
    windows), as tests/test_embedding.py runs it."""
    from elasticdl_tpu.ops.pallas_attention import interpret_mode

    monkeypatch.setenv("EDL_EMB_SCATTER", "pallas")
    monkeypatch.setenv("EDL_EMB_PALLAS_BS", "256")
    V = 2048
    ids, w = _ids_and_weights(d, ids_kind)
    with interpret_mode():
        want = _jax_table_grad(V, d, ids, w)
    got = _torch_table_grad(V, d, ids, w)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-5)


def case_plain_k1_matches_sorted_reference(monkeypatch, d, ids_kind):
    monkeypatch.setenv("EDL_EMB_SCATTER", "sorted")
    V = 2048
    ids, w = _ids_and_weights(d, ids_kind)
    want = _jax_table_grad(V, d, ids, w)
    got = _torch_table_grad(V, d, ids, w)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _scatter_ref(ids, rows, V):
    out = np.zeros((V, rows.shape[-1]), np.float32)
    m = (ids >= 0) & (ids < V)
    np.add.at(out, ids[m], rows[m])
    return out


def _both_scatter(monkeypatch, ids, rows, V):
    monkeypatch.setenv("EDL_EMB_SCATTER", "sorted")
    want = np.asarray(jemb.scatter_add_dense(
        jnp.asarray(ids), jnp.asarray(rows), V))
    got = temb.scatter_add_dense(
        torch.from_numpy(ids), torch.from_numpy(rows), V).numpy()
    return got, want


def case_scatter_add_dense_empty_batch(monkeypatch):
    got, want = _both_scatter(
        monkeypatch, np.zeros((0,), np.int32), np.zeros((0, 8), np.float32),
        256)
    assert got.shape == want.shape == (256, 8)
    assert not got.any() and not want.any()


def case_scatter_add_dense_all_duplicate_ids(monkeypatch):
    V, n, d = 2048, 4096, 16
    ids = np.full((n,), 513, np.int32)
    rows = np.random.RandomState(0).randn(n, d).astype(np.float32)
    got, want = _both_scatter(monkeypatch, ids, rows, V)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, _scatter_ref(ids, rows, V),
                               rtol=1e-4, atol=1e-4)


def case_scatter_add_dense_vocab_boundary_and_sentinel(monkeypatch):
    V, d = 512, 8
    ids = np.array([0, 0, V - 1, V, V + 7, -1, -5, 3, temb.OOB_ID,
                    2**31 - 1], np.int32)
    rows = np.arange(ids.size * d, dtype=np.float32).reshape(-1, d) + 1.0
    got, want = _both_scatter(monkeypatch, ids, rows, V)
    ref = _scatter_ref(ids, rows, V)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    assert got.sum() == pytest.approx(ref.sum(), rel=1e-6)


def case_scatter_add_dense_skewed_stream(monkeypatch):
    V, n, d = 2048, 4096, 17
    r = np.random.RandomState(1)
    ids = r.randint(0, V, n).astype(np.int32)
    ids[: n // 3] = 77
    rows = r.randn(n, d).astype(np.float32)
    got, want = _both_scatter(monkeypatch, ids, rows, V)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def case_padded_vocab_matches(vocab, align):
    assert temb.padded_vocab(vocab, align) == jemb.padded_vocab(vocab, align)


def case_geometry_descriptor_matches():
    assert temb.geometry_descriptor() == jemb.geometry_descriptor()
    assert temb.padded_vocab(26 * 100_000) == 2_605_056


def case_lookup_forward_matches_and_zeroes_out_of_range():
    r = np.random.RandomState(5)
    V, d = 300, 17
    table = r.randn(V, d).astype(np.float32)
    ids = r.randint(-3, V + 3, (16, 9)).astype(np.int32)
    ids[0, :3] = [-1, V, temb.OOB_ID]
    want = np.asarray(jemb.embedding_lookup(
        jnp.asarray(table), jnp.asarray(ids), mode="auto"))
    got = temb.embedding_lookup(
        torch.from_numpy(table), torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[0, :3].any()
    with pytest.raises(ValueError, match="mode"):
        temb.embedding_lookup(torch.from_numpy(table),
                              torch.from_numpy(ids), mode="tiled")


def case_combine_matches(combiner):
    r = np.random.RandomState(6)
    vec = r.randn(8, 5, 4).astype(np.float32)
    ids = r.randint(-1, 10, (8, 5)).astype(np.int32)
    ids[0] = -1                              # an all-pad bag
    w = r.rand(8, 5).astype(np.float32)
    for weights in (None, w):
        want = np.asarray(jemb.combine(
            jnp.asarray(vec), combiner, jnp.asarray(ids),
            None if weights is None else jnp.asarray(weights)))
        got = temb.combine(
            torch.from_numpy(vec), combiner, torch.from_numpy(ids),
            None if weights is None else torch.from_numpy(weights)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def case_plain_placement_contract():
    """Rows with no id are 0, out-of-range ids drop, N = 0 and any D work,
    and the wrapper takes the plain version on CPU tensors only."""
    ids = torch.tensor([-4, 0, 0, 3, 3, 3, 5, temb.OOB_ID], dtype=torch.int32)
    rows = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    before = placement.launches
    out = placement.place_sorted_grads(ids, rows, 5)
    assert placement.launches == before      # the plain version launches nothing
    r = rows.numpy()
    want = np.zeros((5, 3), np.float32)
    want[0] = r[1] + r[2]
    want[3] = r[3] + r[4] + r[5]
    np.testing.assert_array_equal(out.numpy(), want)
    empty = placement.place_sorted_grads(
        torch.zeros((0,), dtype=torch.int32), torch.zeros((0, 1)), 4)
    assert empty.shape == (4, 1) and not empty.any()


def case_placement_rejects_bad_inputs(bad):
    ids = torch.zeros((4,), dtype=torch.int32)
    rows = torch.zeros((4, 3), dtype=torch.float32)
    if bad == "ids_dtype":
        ids = ids.long()
    elif bad == "rows_dtype":
        rows = rows.double()
    elif bad == "shape":
        rows = rows[:3]
    else:
        rows = rows[:, :0]
    with pytest.raises((TypeError, ValueError)):
        placement.place_sorted_grads(ids, rows, 8)


def _cases():
    for d in (16, 17):
        for kind in ("uniform", "skewed", "with_padding"):
            yield case_plain_k1_matches_pallas_interpret, (d, kind)
        for kind in ("uniform", "skewed", "with_padding", "boundary"):
            yield case_plain_k1_matches_sorted_reference, (d, kind)
    yield case_scatter_add_dense_empty_batch, ()
    yield case_scatter_add_dense_all_duplicate_ids, ()
    yield case_scatter_add_dense_vocab_boundary_and_sentinel, ()
    yield case_scatter_add_dense_skewed_stream, ()


def _plain_cases():
    for vocab in (1, 255, 256, 257, 26_000, 65_535, 65_536, 2_600_000,
                  2_605_056):
        for align in (None, 256, 8192):
            yield case_padded_vocab_matches, (vocab, align)
    yield case_geometry_descriptor_matches, ()
    yield case_lookup_forward_matches_and_zeroes_out_of_range, ()
    for combiner in (None, "sum", "mean", "sqrtn"):
        yield case_combine_matches, (combiner,)
    yield case_plain_placement_contract, ()
    for bad in ("ids_dtype", "rows_dtype", "shape", "depth"):
        yield case_placement_rejects_bad_inputs, (bad,)


def test_embedding_against_the_reference():
    """Every case above, in one collected test: each port test file
    collects exactly one, so the loadfile scheduler of pytest-xdist, which
    dispatches files with more tests first, runs it after every reference
    file (ROADMAP.md, conventions)."""
    for case, args in _cases():
        with pytest.MonkeyPatch.context() as mp:
            case(mp, *args)
    for case, args in _plain_cases():
        case(*args)
