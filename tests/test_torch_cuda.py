"""Tests of the port that need the card: the hand-written CUDA kernels
against their plain versions, and the train step on the GPU against the
same step on the CPU. They skip where no CUDA device is present.

This file imports torch and the port only, so it also runs on a GPU
machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance for K1 against its plain version: the two sum the same f32
values in different orders (the kernel in stream order, `index_add_` with
atomics), so each entry is held to 1e-6 + 1e-5 x the sum of the
magnitudes of its terms — the scale that summation rounding grows with.
"""

import os

import numpy as np
import pytest
import torch

from elasticdl_tpu_torch.ops import embedding as emb
from elasticdl_tpu_torch.ops import placement

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 is a CUDA kernel with no "
                    "interpret mode")
    return torch.device("cuda")


def _stream(kind, n, d, num_rows, seed=0):
    r = np.random.RandomState(seed)
    ids = r.randint(0, num_rows, n).astype(np.int64)
    if kind == "skewed":
        ids[: (3 * n) // 10] = num_rows // 3
    elif kind == "oob":
        ids[::7] = emb.OOB_ID
        ids[1::11] = -1
        ids[2::13] = num_rows
    ids = np.sort(ids).astype(np.int32)
    rows = r.randn(n, d).astype(np.float32)
    return torch.from_numpy(ids), torch.from_numpy(rows)


def _assert_matches_plain(ids, rows, num_rows):
    got = placement.place_sorted_grads(ids, rows, num_rows)
    torch.cuda.synchronize()
    want = placement.place_sorted_grads_plain(ids, rows, num_rows)
    mag = placement.place_sorted_grads_plain(ids, rows.abs(), num_rows)
    err = (got - want).abs()
    assert bool((err <= 1e-6 + 1e-5 * mag).all()), float(err.max())
    return got


def case_k1_matches_plain(cuda, kind, d):
    ids, rows = _stream(kind, 20_000, d, 50_001)
    _assert_matches_plain(ids.to(cuda), rows.to(cuda), 50_001)


def case_k1_empty_stream_and_empty_table(cuda):
    ids = torch.zeros((0,), dtype=torch.int32, device=cuda)
    rows = torch.zeros((0, 17), device=cuda)
    out = placement.place_sorted_grads(ids, rows, 1000)
    assert out.shape == (1000, 17) and not out.any()
    assert placement.place_sorted_grads(ids, rows, 0).shape == (0, 17)


def case_k1_is_deterministic_and_counts_launches(cuda):
    ids, rows = _stream("skewed", 50_000, 17, 10_000, seed=3)
    ids, rows = ids.to(cuda), rows.to(cuda)
    before = placement.launches
    a = placement.place_sorted_grads(ids, rows, 10_000)
    b = placement.place_sorted_grads(ids, rows, 10_000)
    assert placement.launches == before + 2
    assert torch.equal(a, b)


def case_k1_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    ids, rows = _stream("uniform", 64, 8, 100)
    with pytest.raises(ValueError, match="contiguous"):
        placement.place_sorted_grads(
            ids.to(cuda), rows.to(cuda).t().contiguous().t(), 100)
    with pytest.raises(ValueError, match="rows on"):
        placement.place_sorted_grads(ids, rows.to(cuda), 100)


def case_lookup_backward_on_the_card_matches_cpu(cuda):
    r = np.random.RandomState(4)
    V, d = 3000, 17
    table = torch.from_numpy(r.randn(V, d).astype(np.float32))
    ids = torch.from_numpy(r.randint(-2, V + 2, (256, 26)).astype(np.int32))
    ids[0, 0] = emb.OOB_ID
    w = torch.from_numpy(r.randn(256, 26, d).astype(np.float32))
    grads = []
    for dev in ("cpu", cuda):
        t = table.to(dev).requires_grad_(True)
        out = emb.embedding_lookup(t, ids.to(dev))
        (g,) = torch.autograd.grad(torch.sum(out * w.to(dev)), t)
        grads.append(g.cpu())
    np.testing.assert_allclose(grads[1].numpy(), grads[0].numpy(),
                               rtol=1e-5, atol=1e-6)


def case_deepfm_grads_on_the_card_match_cpu(cuda):
    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.training.model_spec import ModelSpec
    from elasticdl_tpu_torch.training.trainer import Trainer

    cfg = JobConfig.from_argv([
        "--model_zoo", os.path.join(REPO, "elasticdl_tpu_torch", "model_zoo"),
        "--model_def", "deepfm.deepfm.custom_model",
        "--model_params", "field_vocab=1000;hidden=32,32",
        "--compute_dtype", "float32"])
    r = np.random.RandomState(5)
    batch = {
        "features": {"dense": r.rand(512, 13).astype(np.float32),
                     "cat": r.randint(0, 1 << 30, (512, 26)).astype(np.int32)},
        "labels": r.randint(0, 2, 512).astype(np.int32),
    }
    results = []
    weights = None
    for dev in ("cpu", None):
        tr = Trainer(ModelSpec.from_config(cfg), device=dev)
        state = tr.init_state(batch)
        if weights is None:
            weights = {k: v.detach().clone() for k, v in
                       tr.model.state_dict().items()}
        tr.model.load_state_dict(weights)
        loss, grads = tr.compute_grads(state, batch)
        results.append((float(loss), {k: g.cpu() for k, g in grads.items()}))
    assert results[1][0] == pytest.approx(results[0][0], rel=1e-5)
    for k, g_cpu in results[0][1].items():
        g = results[1][1][k].numpy()
        w = g_cpu.numpy()
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-6 * np.abs(w).max(), err_msg=k)


def test_kernels_on_the_card(cuda):
    """Every case above, in one collected test (ROADMAP.md, conventions:
    one collected test per port test file)."""
    for d in (1, 16, 17, 33):
        for kind in ("uniform", "skewed", "oob"):
            case_k1_matches_plain(cuda, kind, d)
    case_k1_empty_stream_and_empty_table(cuda)
    case_k1_is_deterministic_and_counts_launches(cuda)
    case_k1_wrapper_rejects_what_the_kernel_does_not_take(cuda)
    case_lookup_backward_on_the_card_matches_cpu(cuda)
    case_deepfm_grads_on_the_card_match_cpu(cuda)
