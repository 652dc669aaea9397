"""Tests of the port that need the card: the hand-written CUDA kernels
against their plain versions, the train steps on the GPU against the
same steps on the CPU, the trainer's knobs (remat, accumulation, grouped
steps) through K1-K4', the DeepFM job path (master, worker,
checkpoint, export), the manual schedule's per-rank compute (K1 on a
shard), a one-rank NCCL cohort context, K1 on Wide & Deep's census
stream, the MoE, pipelined and tensor-parallel LMs and the MoE's index
and dense routes, the sequence-parallel ring in one process against
unsplit attention (also over tensor-parallel head groups, each launch
against its plain version), a ResNet-20 step (convolutions, BatchNorm), a device-mode
embedding-tier store (K1 on every push), zoo callbacks whose pushed
learning rate lands in the worker's optimizer on the card, an LM's
serving export, whose program launches K2' or K2, `train_step_cost`,
whose FLOPs on the card equal the CPU's, and the trainer's captured
steps (CUDA graphs: DeepFM, the LM with dropout, also under remat, and
MNIST with dropout under deterministic cuDNN, equal to the eager body
bit for bit over 5 steps and a group of 4, an LR set after capture
reaching the next replay, the generator rewind that remat records
inside a capture, and the card flavours of the zoo's optimizers, two
captured steps and an LR change, against the CPU's plain flavour). They
skip where no CUDA device is present.

This file imports torch and the port only, so it also runs on a GPU
machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance for K1 against its plain version: the two sum the same f32
values in different orders (the kernel in a fixed order of its own,
`index_add_` with atomics), so each entry is held to 1e-6 + 1e-5 x the
sum of the magnitudes of its terms — the scale that summation rounding
grows with.

Tolerances for the flash kernels (K2-K4, for bfloat16 the Hopper
kernels K2', K3' and K4' at D 16, 32, 64 and 128, for float32 K2-tf32,
K3-tf32 and K4-tf32 at the same D, and the delta pass) against
their plain versions, the reference's own for its kernel against its
naive path:
float32 out, lse and delta 2e-5, gradients 5e-5 with atol 5e-5 of the
largest value (the kernels sum tile by tile, the plain versions whole
rows). In bfloat16 both sides compute in float32 from the same inputs
(K2', K3' and K4' split the float32 p and ds into bf16 hi + lo, which carries
them to ~2**-17) and round each output once, so they differ by at most one
bf16 ulp (2**-7 of the value) plus float32 noise: rtol 2**-7 with atol
1e-2 of the output's rms.
"""

import os

import numpy as np
import pytest
import torch

from elasticdl_tpu_torch.ops import embedding as emb
from elasticdl_tpu_torch.ops import flash_attention as fa
from elasticdl_tpu_torch.ops import placement

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16 = (2 ** -7, 0.0, 1e-2)     # rtol, atol of max, atol of rms


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1-K4 are CUDA kernels with no "
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
    """K1 against its plain version, and against itself: a second call
    must give the same bits."""
    got = placement.place_sorted_grads(ids, rows, num_rows)
    again = placement.place_sorted_grads(ids, rows, num_rows)
    torch.cuda.synchronize()
    want = placement.place_sorted_grads_plain(ids, rows, num_rows)
    mag = placement.place_sorted_grads_plain(ids, rows.abs(), num_rows)
    err = (got - want).abs()
    assert bool((err <= 1e-6 + 1e-5 * mag).all()), float(err.max())
    assert torch.equal(got, again)
    return got


def case_k1_matches_plain(cuda, kind, d):
    ids, rows = _stream(kind, 20_000, d, 50_001)
    _assert_matches_plain(ids.to(cuda), rows.to(cuda), 50_001)


def case_k1_hot_segments(cuda, d):
    """Segments around the length at which a block sums them together
    (SPLIT_ROWS) and around the zero pass's chunks (CHUNK_ROWS); one id
    holding every slot; a hot id at the first and at the last row; a long
    run of sentinels; tables whose rows are no multiple of a block's."""
    r = np.random.RandomState(d)
    split, chunk = placement.SPLIT_ROWS, placement.CHUNK_ROWS
    num_rows = 9_973
    streams = []
    for length in (split - 1, split, split + 1, chunk - 1, chunk, chunk + 1,
                   2 * chunk - 1, 2 * chunk, 2 * chunk + 1):
        streams.append((np.r_[r.randint(0, num_rows, 3_000),
                              np.full(length, 4_321)], num_rows))
    for hot in (0, num_rows - 1):
        streams.append((np.r_[r.randint(0, num_rows, 2_000),
                              np.full(3 * chunk + 7, hot)], num_rows))
    streams.append((np.full(5_000, 77), num_rows))
    streams.append((np.r_[r.randint(0, num_rows, 2_000),
                          np.full(4 * chunk + 3, emb.OOB_ID),
                          np.full(2 * chunk + 5, -1)], num_rows))
    for rows_in_table in (1, 3, 4_801, 100_003):
        streams.append((r.randint(0, rows_in_table, 6_000), rows_in_table))
    for ids, rows_in_table in streams:
        ids = torch.from_numpy(np.sort(ids).astype(np.int32))
        rows = torch.from_numpy(r.randn(ids.numel(), d).astype(np.float32))
        _assert_matches_plain(ids.to(cuda), rows.to(cuda), rows_in_table)


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
    assert placement.launches == before + 2 * placement.PASSES
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


def case_shard_part_on_the_card_matches_plain(cuda):
    """The manual schedule's per-rank compute with K1 on each shard of a
    table that 3 ranks do not divide (a short last shard), against its
    plain version on the CPU: the forward parts sum to the one-device
    gather bit for bit, each shard's gradient is held to K1's bound, and
    the shards launch K1 once each."""
    from elasticdl_tpu_torch.parallel import mesh as mesh_lib

    r = np.random.RandomState(5)
    V, d, n = 10_000, 17, 3
    table = torch.from_numpy(r.rand(V, d).astype(np.float32))
    ids = torch.from_numpy(r.randint(0, V, (512, 26)).astype(np.int32))
    ids[0, :3] = torch.tensor([-1, V, emb.OOB_ID], dtype=torch.int32)
    safe = torch.where((ids >= 0) & (ids < V), ids, emb.OOB_ID)
    ct = torch.from_numpy(r.randn(512, 26, d).astype(np.float32))
    parts, before = [], placement.launches
    for i in range(n):
        rows = mesh_lib.shard_rows(i, n, V)
        shard = table[rows.start:rows.stop]
        part = emb.shard_part(shard.to(cuda), safe.to(cuda), rows.start)
        assert torch.equal(part.cpu(), emb.shard_part(shard, safe, rows.start))
        parts.append(part.cpu())
        got = emb.shard_part_grad(safe.to(cuda), ct.to(cuda), rows.start,
                                  rows.size).cpu()
        local, _ = emb.shard_ids(safe, rows.start, rows.size)
        sid, srows = emb.sorted_stream(local, ct)
        want = placement.place_sorted_grads_plain(sid, srows, rows.size)
        mag = placement.place_sorted_grads_plain(sid, srows.abs(), rows.size)
        assert rows.size == (V + n - 1) // n or i == n - 1
        assert bool(((got - want).abs() <= 1e-6 + 1e-5 * mag).all())
    assert placement.launches == before + n * placement.PASSES
    whole = emb.embedding_lookup(table, ids)
    assert torch.equal(torch.stack(parts).sum(0), whole)


def case_one_rank_nccl_cohort(cuda):
    """A one-rank NCCL world forms, carries int64 values past 2**31 over
    its control group, gives a mesh of one, and shuts down; a member whose
    card this host lacks is refused before any world forms."""
    import socket

    from elasticdl_tpu_torch.common import runtime
    from elasticdl_tpu_torch.parallel import elastic, mesh as mesh_lib

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = elastic.CohortContext(f"localhost:{port}", 1, 0,
                                device=runtime.cohort_device(0))
    ctx.initialize(timeout_s=60)
    try:
        assert ctx.backend == "nccl"
        vec = [4_370_000_000, -1, 2**62 + 3]
        assert ctx.broadcast_ints(vec).tolist() == vec
        assert ctx.allgather_ints(vec).tolist() == [vec]
        ctx.barrier()
        assert mesh_lib.build_mesh().size == 1
    finally:
        ctx.shutdown()
    with pytest.raises(RuntimeError, match="a card takes one rank"):
        runtime.cohort_device(torch.cuda.device_count())


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


def _attn_inputs(cuda, b, tq, tk, h, d, dtype, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(dtype)

    return (rand(b, tq, h, d), rand(b, tk, h, d), rand(b, tk, h, d),
            rand(b, tq, h, d), torch.randn((b, h, tq), generator=g,
                                           device=cuda))


def _close(got, want, what, rtol, atol_of_max=0.0, atol_of_rms=0.0):
    got, want = got.float(), want.float()
    atol = 0.0
    if want.numel():
        atol = atol_of_max * float(want.abs().max())
        if atol_of_rms:                 # the rms of -1e30 entries is inf
            atol += atol_of_rms * float(want.square().mean().sqrt())
    err = (got - want).abs()
    assert bool((err <= atol + rtol * want.abs()).all()), \
        (what, float(err.max()))


def _route(dtype, d):
    """The launches one forward and one whole backward (`flash_bwd`)
    should add, by `route`: K2', K3', K4' and the delta pass once (read
    by K3' and K4') on the bf16 Hopper route, K2-tf32, K3-tf32, K4-tf32
    and the delta pass for float32 at the same D, K2-K4 elsewhere."""
    fwd, bwd = fa.route(dtype, d)
    return {n: int(n == fwd or n in bwd) for n in fa.launches}


def case_flash_kernels_match_plain(cuda, dtype, d, tq, tk, causal, q_off,
                                   kv_off, with_glse, views=False):
    """Each kernel the route picks against its plain version; with
    `views`, q, k and v are slices of one (B, T, 3, H, D) tensor."""
    if views:
        assert tq == tk
        g = torch.Generator(device=cuda).manual_seed(2)
        qkv = torch.randn((2, tq, 3, 3, d), generator=g,
                          device=cuda).to(dtype)
        q, k, v = qkv.unbind(2)
        _, _, _, dout, glse = _attn_inputs(cuda, 2, tq, tk, 3, d, dtype)
    else:
        q, k, v, dout, glse = _attn_inputs(cuda, 2, tq, tk, 3, d, dtype)
    glse = glse if with_glse else None
    args = (causal, q_off, kv_off)
    before = dict(fa.launches)
    out, lse = fa.flash_fwd(q, k, v, *args)
    want_out, want_lse = fa.flash_fwd_plain(q, k, v, *args)
    dq, dk, dv = fa.flash_bwd(q, k, v, out, dout, lse, glse, *args)
    torch.cuda.synchronize()
    assert {n: fa.launches[n] - before[n] for n in before} == \
        _route(dtype, d)
    # the single-gradient wrappers take the same kernels
    assert torch.equal(fa.flash_bwd_dq(q, k, v, out, dout, lse, glse, *args),
                       dq)
    assert all(torch.equal(a, b) for a, b in zip(
        fa.flash_bwd_dkv(q, k, v, out, dout, lse, glse, *args), (dk, dv)))
    if fa.BWD_DELTA_SM90 in fa.route(dtype, d)[1]:
        _close(fa.flash_bwd_delta(out, dout, glse),
               fa.flash_bwd_delta_plain(out, dout, glse), "delta", 2e-5,
               2e-5)
    want_dq = fa.flash_bwd_dq_plain(q, k, v, out, dout, lse, glse, *args)
    want_dk, want_dv = fa.flash_bwd_dkv_plain(q, k, v, out, dout, lse, glse,
                                              *args)
    assert out.dtype == dtype and dq.dtype == dk.dtype == dv.dtype == dtype
    f32 = dtype == torch.float32
    _close(out, want_out, "out", *((2e-5, 2e-5) if f32 else BF16))
    # rows that see no key have lse ~ NEG_BIG; the others are held to
    # 2e-5 of their own largest value
    masked = want_lse <= -1e29
    assert bool((lse[masked] <= -1e29).all())
    _close(lse[~masked], want_lse[~masked], "lse", 2e-5, 2e-5)
    for name, g, w in (("dq", dq, want_dq), ("dk", dk, want_dk),
                       ("dv", dv, want_dv)):
        _close(g, w, name, *((5e-5, 5e-5) if f32 else BF16))


def case_full_attention_takes_the_kernels_at_any_length(cuda):
    """Lengths with no power-of-two block (24, 100, 1000) launch K2 on
    the card, as every length does; EDL_FLASH=0 and a head dim past 256
    raise there, since the card has only the kernels."""
    from elasticdl_tpu_torch.ops import attention

    for t in (24, 100, 1000):
        q, k, v, _, _ = _attn_inputs(cuda, 1, t, t, 2, 64, torch.bfloat16)
        before = fa.launches[fa.FWD_SM90]
        out = attention.full_attention(q, k, v)
        assert fa.launches[fa.FWD_SM90] == before + 1
        _close(out, fa.flash_fwd_plain(q, k, v)[0], f"out T={t}", *BF16)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("EDL_FLASH", "0")
        with pytest.raises(ValueError, match="no attention kernel"):
            attention.full_attention(q, k, v)
    wide = torch.zeros((1, 8, 1, 257), device=cuda)
    with pytest.raises(ValueError, match="no attention kernel"):
        attention.full_attention(wide, wide, wide)


def case_flash_fully_masked_is_zero(cuda):
    """q before every kv position: every tile is skipped; and a row fully
    masked inside a live tile (kv_offset 8) is 0 too."""
    q, k, v, dout, _ = _attn_inputs(cuda, 2, 64, 64, 2, 64, torch.float32)
    for kv_off, rows in ((1024, 64), (8, 8)):
        out, lse = fa.flash_fwd(q, k, v, True, 0, kv_off)
        dq = fa.flash_bwd_dq(q, k, v, out, dout, lse, None, True, 0, kv_off)
        dk, dv = fa.flash_bwd_dkv(q, k, v, out, dout, lse, None, True, 0,
                                  kv_off)
        assert bool((out[:, :rows] == 0).all())
        assert bool((lse[:, :, :rows] <= -1e29).all())
        assert bool((dq[:, :rows] == 0).all())
        for g in (dq, dk, dv):
            assert bool(torch.isfinite(g).all())
            if kv_off == 1024:
                assert bool((g == 0).all())


def case_flash_is_deterministic_and_counts_launches(cuda, d):
    q, k, v, dout, glse = _attn_inputs(cuda, 2, 256, 256, 4, d,
                                       torch.bfloat16, seed=1)
    before = dict(fa.launches)
    outs = []
    for _ in range(2):
        out, lse = fa.flash_fwd(q, k, v)
        outs.append((out, lse,
                     *fa.flash_bwd(q, k, v, out, dout, lse, glse)))
    route = _route(torch.bfloat16, d)
    assert route[fa.FWD_SM90] and route[fa.BWD_DKV_SM90]
    assert route[fa.BWD_DELTA_SM90] == 1
    # dQ on K3' at every Hopper width
    assert route[fa.BWD_DQ_SM90] == 1 and route[fa.BWD_DQ] == 0
    assert fa.launches == {n: before[n] + 2 * route[n] for n in before}
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def case_k4_prime_at_d128_matches_k4_and_plain(cuda):
    """K4' at D 128 (one consumer warpgroup a block) against K4, the
    CUDA-core kernel it replaces there, and against the plain version, on
    the same inputs (causal with the lse cotangent, and at offsets with
    tails): each within the bf16 tolerance of the plain version and of
    each other."""
    for tq, tk, q_off, kv_off, with_glse in ((256, 256, 0, 0, True),
                                             (200, 130, 70, 0, False)):
        q, k, v, dout, glse = _attn_inputs(cuda, 2, tq, tk, 3, 128,
                                           torch.bfloat16, seed=4)
        glse = glse if with_glse else None
        args = (True, q_off, kv_off)
        out, lse = fa.flash_fwd(q, k, v, *args)
        before = dict(fa.launches)
        new = fa.launch_bwd_dkv(q, k, v, out, dout, lse, glse, *args,
                                fa.BWD_DKV_SM90)
        old = fa.launch_bwd_dkv(q, k, v, out, dout, lse, glse, *args,
                                fa.BWD_DKV)
        torch.cuda.synchronize()
        assert {n: fa.launches[n] - before[n] for n in before
                if fa.launches[n] != before[n]} == {
            fa.BWD_DELTA_SM90: 1, fa.BWD_DKV_SM90: 1, fa.BWD_DKV: 1}
        want = fa.flash_bwd_dkv_plain(q, k, v, out, dout, lse, glse, *args)
        for name, a, b, w in zip(("dk", "dv"), new, old, want):
            _close(a, w, f"K4' {name}", *BF16)
            _close(b, w, f"K4 {name}", *BF16)
            _close(a, b, f"K4' against K4, {name}", *BF16)


def case_narrow_hopper_kernels_match_k2_k3_k4_and_plain(cuda, d):
    """K2', K3' and K4' at D 16 or 32 against K2, K3 and K4, the CUDA-core
    kernels they replace there, through their launchers, and against the
    plain versions, on the same inputs: causal with the lse cotangent, at
    offsets with tails, not causal with tails, and the fully masked
    geometry (out, lse, dQ and dK/dV 0 or NEG_BIG and finite); each within
    the bf16 tolerance of the plain version and of each other, and a
    rerun bit-identical."""
    for tq, tk, causal, q_off, kv_off, with_glse in (
            (256, 256, True, 0, 0, True), (200, 130, True, 70, 0, False),
            (130, 200, True, 64, 32, True), (100, 230, False, 0, 0, True),
            (100, 100, True, 0, 1024, False)):
        q, k, v, dout, glse = _attn_inputs(cuda, 2, tq, tk, 3, d,
                                           torch.bfloat16, seed=d + tq)
        glse = glse if with_glse else None
        args = (causal, q_off, kv_off)
        before = dict(fa.launches)
        out, lse = fa.launch_fwd(q, k, v, *args, fa.FWD_SM90)
        old_out, old_lse = fa.launch_fwd(q, k, v, *args, fa.FWD)
        new = fa.launch_bwd_dkv(q, k, v, out, dout, lse, glse, *args,
                                fa.BWD_DKV_SM90)
        again = fa.launch_bwd_dkv(q, k, v, out, dout, lse, glse, *args,
                                  fa.BWD_DKV_SM90)
        old = fa.launch_bwd_dkv(q, k, v, out, dout, lse, glse, *args,
                                fa.BWD_DKV)
        dq, dq_again, old_dq = (
            fa.launch_bwd_dq(q, k, v, out, dout, lse, glse, *args, kernel)
            for kernel in (fa.BWD_DQ_SM90, fa.BWD_DQ_SM90, fa.BWD_DQ))
        torch.cuda.synchronize()
        assert {n: fa.launches[n] - before[n] for n in before
                if fa.launches[n] != before[n]} == {
            fa.FWD_SM90: 1, fa.FWD: 1, fa.BWD_DELTA_SM90: 4,
            fa.BWD_DKV_SM90: 2, fa.BWD_DKV: 1, fa.BWD_DQ_SM90: 2,
            fa.BWD_DQ: 1}
        assert all(torch.equal(a, b) for a, b in zip(new, again))
        assert torch.equal(dq, dq_again)
        want_out, want_lse = fa.flash_fwd_plain(q, k, v, *args)
        _close(out, want_out, f"K2' out D {d}", *BF16)
        _close(old_out, want_out, f"K2 out D {d}", *BF16)
        _close(out, old_out, f"K2' against K2, D {d}", *BF16)
        masked = want_lse <= -1e29
        assert bool((lse[masked] <= -1e29).all())
        _close(lse[~masked], want_lse[~masked], f"lse D {d}", 2e-5, 2e-5)
        _close(old_lse[~masked], want_lse[~masked], f"K2 lse D {d}", 2e-5,
               2e-5)
        want = fa.flash_bwd_dkv_plain(q, k, v, out, dout, lse, glse, *args)
        for name, a, b, w in zip(("dk", "dv"), new, old, want):
            _close(a, w, f"K4' {name} D {d}", *BF16)
            _close(b, w, f"K4 {name} D {d}", *BF16)
            _close(a, b, f"K4' against K4, {name} D {d}", *BF16)
        want_dq = fa.flash_bwd_dq_plain(q, k, v, out, dout, lse, glse, *args)
        _close(dq, want_dq, f"K3' dq D {d}", *BF16)
        _close(old_dq, want_dq, f"K3 dq D {d}", *BF16)
        _close(dq, old_dq, f"K3' against K3, dq D {d}", *BF16)
        if kv_off >= tq + q_off:            # every row fully masked
            for x in (out, dq, *new):
                assert bool((x == 0).all()) and bool(torch.isfinite(x).all())
            assert bool((lse <= -1e29).all())


def case_tf32_forward_matches_k2_and_plain(cuda, d):
    """K2-tf32 at D 16, 32, 64 or 128 against K2, the CUDA-core kernel it
    replaces there, through their launchers, and against the plain
    version, on the same float32 inputs: causal, at offsets with tails,
    not causal with tails, and the fully masked geometry (out 0, lse
    <= -1e29); out and lse within 2e-5 of the plain version and of K2, a
    rerun bit-identical."""
    for tq, tk, causal, q_off, kv_off in (
            (256, 256, True, 0, 0), (200, 130, True, 70, 0),
            (130, 200, True, 64, 32), (100, 230, False, 0, 0),
            (100, 100, True, 0, 1024)):
        q, k, v, _, _ = _attn_inputs(cuda, 2, tq, tk, 3, d, torch.float32,
                                     seed=d + tq)
        args = (causal, q_off, kv_off)
        before = dict(fa.launches)
        out, lse = fa.launch_fwd(q, k, v, *args, fa.FWD_TF32)
        again = fa.launch_fwd(q, k, v, *args, fa.FWD_TF32)
        old_out, old_lse = fa.launch_fwd(q, k, v, *args, fa.FWD)
        torch.cuda.synchronize()
        assert {n: fa.launches[n] - before[n] for n in before
                if fa.launches[n] != before[n]} == {fa.FWD_TF32: 2,
                                                    fa.FWD: 1}
        assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
        want_out, want_lse = fa.flash_fwd_plain(q, k, v, *args)
        _close(out, want_out, f"K2-tf32 out D {d}", 2e-5, 2e-5)
        _close(old_out, want_out, f"K2 out D {d}", 2e-5, 2e-5)
        _close(out, old_out, f"K2-tf32 against K2, D {d}", 2e-5, 2e-5)
        masked = want_lse <= -1e29
        assert bool((lse[masked] <= -1e29).all())
        _close(lse[~masked], want_lse[~masked], f"lse D {d}", 2e-5, 2e-5)
        _close(lse[~masked], old_lse[~masked], f"K2 lse D {d}", 2e-5, 2e-5)
        if kv_off >= tq + q_off:            # every row fully masked
            assert bool((out == 0).all()) and bool((lse <= -1e29).all())


def case_tf32_forward_rejects_strides_tma_cannot_take(cuda, d):
    """A float32 view whose h stride is d + 1 elements (4 d + 4 bytes, not
    a multiple of 16) is on K2-tf32's route, which raises before any
    launch rather than falling back to K2."""
    wide = torch.randn((1, 32, 2, d + 1), device=cuda)
    q = wide[..., :d]
    before = dict(fa.launches)
    with pytest.raises(ValueError, match="TMA"):
        fa.flash_fwd(q, q, q)
    assert fa.launches == before


def case_tf32_backward_matches_k3_k4_and_plain(cuda, d):
    """K3-tf32 and K4-tf32 at D 16, 32, 64 or 128 against K3 and K4, the
    CUDA-core kernels they replace, through their launchers, and against
    the plain versions, on the same float32 inputs: causal with the lse
    cotangent, at offsets with tails, not causal with tails, and the
    fully masked geometry (every gradient 0 and finite); gradients within
    5e-5 (atol 5e-5 of the largest value) of the plain version and of K3
    and K4, the float32 delta pass within 2e-5 of its plain version, and
    a rerun bit-identical."""
    for tq, tk, causal, q_off, kv_off, with_glse in (
            (256, 256, True, 0, 0, True), (200, 130, True, 70, 0, False),
            (130, 200, True, 64, 32, True), (100, 230, False, 0, 0, True),
            (100, 100, True, 0, 1024, False)):
        q, k, v, dout, glse = _attn_inputs(cuda, 2, tq, tk, 3, d,
                                           torch.float32, seed=d + tq)
        glse = glse if with_glse else None
        args = (causal, q_off, kv_off)
        out, lse = fa.flash_fwd(q, k, v, *args)
        before = dict(fa.launches)
        new, again, old = (
            fa.launch_bwd_dkv(q, k, v, out, dout, lse, glse, *args, kernel)
            for kernel in (fa.BWD_DKV_TF32, fa.BWD_DKV_TF32, fa.BWD_DKV))
        dq, dq_again, old_dq = (
            fa.launch_bwd_dq(q, k, v, out, dout, lse, glse, *args, kernel)
            for kernel in (fa.BWD_DQ_TF32, fa.BWD_DQ_TF32, fa.BWD_DQ))
        torch.cuda.synchronize()
        assert {n: fa.launches[n] - before[n] for n in before
                if fa.launches[n] != before[n]} == {
            fa.BWD_DELTA_SM90: 4, fa.BWD_DKV_TF32: 2, fa.BWD_DKV: 1,
            fa.BWD_DQ_TF32: 2, fa.BWD_DQ: 1}
        assert all(torch.equal(a, b) for a, b in zip(new, again))
        assert torch.equal(dq, dq_again)
        _close(fa.flash_bwd_delta(out, dout, glse),
               fa.flash_bwd_delta_plain(out, dout, glse),
               f"float32 delta D {d}", 2e-5, 2e-5)
        want = fa.flash_bwd_dkv_plain(q, k, v, out, dout, lse, glse, *args)
        for name, a, b, w in zip(("dk", "dv"), new, old, want):
            _close(a, w, f"K4-tf32 {name} D {d}", 5e-5, 5e-5)
            _close(b, w, f"K4 {name} D {d}", 5e-5, 5e-5)
            _close(a, b, f"K4-tf32 against K4, {name} D {d}", 5e-5, 5e-5)
        want_dq = fa.flash_bwd_dq_plain(q, k, v, out, dout, lse, glse, *args)
        _close(dq, want_dq, f"K3-tf32 dq D {d}", 5e-5, 5e-5)
        _close(old_dq, want_dq, f"K3 dq D {d}", 5e-5, 5e-5)
        _close(dq, old_dq, f"K3-tf32 against K3, dq D {d}", 5e-5, 5e-5)
        if kv_off >= tq + q_off:            # every row fully masked
            for x in (dq, *new):
                assert bool((x == 0).all()) and bool(torch.isfinite(x).all())


def case_tf32_backward_rejects_strides_tma_cannot_take(cuda, d):
    """A float32 view whose h stride is d + 1 elements (not a multiple of
    16 bytes) is on K3-tf32's and K4-tf32's route, which raises before
    any launch (the delta pass included) rather than falling back to K3
    and K4: each single-gradient wrapper and the whole backward."""
    wide = torch.randn((1, 32, 2, d + 1), device=cuda)
    q = wide[..., :d]
    out, lse = fa.flash_fwd(*(q.contiguous() for _ in range(3)))
    before = dict(fa.launches)
    for backward in (fa.flash_bwd_dq, fa.flash_bwd_dkv, fa.flash_bwd):
        with pytest.raises(ValueError, match="TMA"):
            backward(q, q, q, out, out, lse)
    assert fa.launches == before


def case_tensor_core_route_at_float32_d128(cuda):
    """Float32 at D 128 runs on the tensor cores alone: the forward
    launches K2-tf32 once, and `flash_bwd` the delta pass, K3-tf32 and
    K4-tf32 once each and no K3 (nor anything else), at offsets with
    tails and a live g_lse; its dQ, dK and dV equal, bit for bit, those
    of K3-tf32's and K4-tf32's launchers over the delta pass's output."""
    q, k, v, dout, glse = _attn_inputs(cuda, 2, 200, 130, 3, 128,
                                       torch.float32, seed=7)
    args = (True, 70, 0)
    before = dict(fa.launches)
    out, lse = fa.flash_fwd(q, k, v, *args)
    torch.cuda.synchronize()
    assert {n: fa.launches[n] - before[n] for n in before
            if fa.launches[n] != before[n]} == {fa.FWD_TF32: 1}
    before = dict(fa.launches)
    dq, dk, dv = fa.flash_bwd(q, k, v, out, dout, lse, glse, *args)
    torch.cuda.synchronize()
    assert {n: fa.launches[n] - before[n] for n in before
            if fa.launches[n] != before[n]} == {
        fa.BWD_DELTA_SM90: 1, fa.BWD_DQ_TF32: 1, fa.BWD_DKV_TF32: 1}
    delta = fa.flash_bwd_delta(out, dout, glse)
    want_dq = fa.launch_dq_sm90(q, k, v, dout, lse, delta, *args,
                                fa.BWD_DQ_TF32)
    want_dk, want_dv = fa.launch_dkv_sm90(q, k, v, dout, lse, delta, *args,
                                          fa.BWD_DKV_TF32)
    torch.cuda.synchronize()
    assert torch.equal(dq, want_dq)
    assert torch.equal(dk, want_dk) and torch.equal(dv, want_dv)


def case_bf16_lm_with_16_wide_heads_runs_the_hopper_kernels(cuda):
    """A bf16 LM step with 16-wide heads (dim 64, 4 heads: the zoo LM's
    default head width) on the card: K2', K3', K4' and the delta pass once
    a layer, and K2, K3 and K4 never, with a finite loss and finite
    gradients."""
    r = np.random.RandomState(11)
    toks = r.randint(0, 64, (4, 65)).astype(np.int32)
    batch = {"features": toks[:, :-1], "labels": toks[:, 1:],
             "mask": np.ones((4,), np.float32)}
    tr = _card_trainer("transformer.transformer_lm.custom_model",
                       "vocab=64;num_layers=2;dim=64;heads=4;max_len=64",
                       "bfloat16")
    state = tr.init_state(batch)
    before = dict(fa.launches)
    loss, grads = tr.compute_grads(state, batch)
    torch.cuda.synchronize()
    layers = 2
    assert {n: fa.launches[n] - before[n] for n in before} == {
        **{n: 0 for n in before}, fa.FWD_SM90: layers,
        fa.BWD_DQ_SM90: layers, fa.BWD_DKV_SM90: layers,
        fa.BWD_DELTA_SM90: layers}
    assert np.isfinite(float(loss))
    for n, g in grads.items():
        assert bool(torch.isfinite(g).all()), n


def case_bf16_lm_with_128_wide_heads_runs_k4_prime(cuda):
    """A bf16 LM step with 128-wide heads (dim 256, 2 heads) on the card:
    K2', K3', K4' and the delta pass once a layer and K2-K4 never, with a
    finite loss and finite gradients."""
    r = np.random.RandomState(10)
    toks = r.randint(0, 64, (4, 65)).astype(np.int32)
    batch = {"features": toks[:, :-1], "labels": toks[:, 1:],
             "mask": np.ones((4,), np.float32)}
    tr = _card_trainer("transformer.transformer_lm.custom_model",
                       "vocab=64;num_layers=2;dim=256;heads=2;max_len=64",
                       "bfloat16")
    state = tr.init_state(batch)
    before = dict(fa.launches)
    loss, grads = tr.compute_grads(state, batch)
    torch.cuda.synchronize()
    layers = 2
    assert {n: fa.launches[n] - before[n] for n in before} == {
        **{n: 0 for n in before}, fa.FWD_SM90: layers,
        fa.BWD_DQ_SM90: layers, fa.BWD_DKV_SM90: layers,
        fa.BWD_DELTA_SM90: layers}
    assert np.isfinite(float(loss))
    for n, g in grads.items():
        assert bool(torch.isfinite(g).all()), n


def case_flash_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q, k, v, _, _ = _attn_inputs(cuda, 1, 32, 32, 2, 16, torch.float32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_fwd(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="on cuda"):
        fa.flash_fwd(q, k.cpu(), v)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd(q, k.transpose(1, 3).contiguous().transpose(1, 3), v)
    big = torch.zeros((1, 8, 1, 257), device=cuda)
    with pytest.raises(ValueError, match="D <= 256"):
        fa.flash_fwd(big, big, big)


def case_hopper_wrapper_rejects_strides_tma_cannot_take(cuda, d=64):
    """A bf16 view whose h stride is d + 4 elements (2d + 8 bytes, not a
    multiple of 16) is on the Hopper route (K2', K3' and K4' at every
    Hopper width), which raises before any launch rather than falling back
    to the CUDA-core kernels: the forward, each single-gradient wrapper
    and the whole backward."""
    wide = torch.randn((1, 32, 2, d + 4), device=cuda).to(torch.bfloat16)
    q = wide[..., :d]
    before = dict(fa.launches)
    with pytest.raises(ValueError, match="TMA"):
        fa.flash_fwd(q, q, q)
    out, lse = fa.flash_fwd(*(q.contiguous() for _ in range(3)))
    for backward in (fa.flash_bwd_dkv, fa.flash_bwd_dq, fa.flash_bwd):
        with pytest.raises(ValueError, match="TMA"):
            backward(q, q, q, out, out, lse)
    assert {n: fa.launches[n] - before[n] for n in before
            if fa.launches[n] != before[n]} == {fa.FWD_SM90: 1}


def case_lm_grads_on_the_card_match_cpu(cuda, extra=""):
    """The float32 LM's loss and gradients on the card against the CPU;
    `extra` adds model_params (the MoE, pipelined and tensor-parallel
    configurations, with no mesh)."""
    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.training.model_spec import ModelSpec
    from elasticdl_tpu_torch.training.trainer import Trainer

    cfg = JobConfig.from_argv([
        "--model_zoo", os.path.join(REPO, "elasticdl_tpu_torch", "model_zoo"),
        "--model_def", "transformer.transformer_lm.custom_model",
        "--model_params",
        "vocab=64;num_layers=2;dim=64;heads=4;max_len=64" + extra,
        "--compute_dtype", "float32"])
    r = np.random.RandomState(6)
    toks = r.randint(0, 64, (8, 33)).astype(np.int32)
    batch = {"features": toks[:, :-1], "labels": toks[:, 1:],
             "mask": np.ones((8,), np.float32)}
    results, weights = [], None
    for dev in ("cpu", None):
        tr = Trainer(ModelSpec.from_config(cfg), device=dev)
        state = tr.init_state(batch)
        if weights is None:
            weights = {n: t.detach().clone()
                       for n, t in tr.model.state_dict().items()}
        tr.model.load_state_dict(weights)
        before = dict(fa.launches)
        loss, grads = tr.compute_grads(state, batch)
        results.append((float(loss), {n: g.cpu() for n, g in grads.items()}))
    torch.cuda.synchronize()
    if not extra:       # D 16, 2 layers: K2-tf32, K3-tf32, K4-tf32, delta
        assert {n: fa.launches[n] - before[n] for n in before
                if fa.launches[n] != before[n]} == {
            fa.FWD_TF32: 2, fa.BWD_DQ_TF32: 2, fa.BWD_DKV_TF32: 2,
            fa.BWD_DELTA_SM90: 2}
    assert results[1][0] == pytest.approx(results[0][0], rel=5e-5)
    for n, want in results[0][1].items():
        got = results[1][1][n]
        if n.endswith(".k.bias"):       # 0 in exact arithmetic
            continue
        _close(got, want, n, 5e-5, 5e-5)


def case_moe_routes_on_the_card(cuda):
    """The index and the dense plain MoE routes on the card: outputs, aux
    and the expert kernels' gradients bit for bit, the rest rtol 1e-6 with
    atol 1e-6 of the largest (`tests/test_torch_moe.py` holds them so on
    the CPU)."""
    from elasticdl_tpu_torch.common import runtime
    from elasticdl_tpu_torch.ops import moe

    runtime.configure_torch_runtime()
    r = np.random.RandomState(5)
    n, c, e, h = 512, 64, 8, 256
    arrays = [r.randn(n, c), r.randn(c, e), r.randn(e, c, h) * 0.1,
              r.randn(e, h) * 0.1, r.randn(e, h, c) * 0.1, r.randn(e, c) * 0.1]
    g = torch.tensor(r.randn(n, c), dtype=torch.float32, device=cuda)
    results = []
    for fn in (moe.switch_moe, moe.switch_moe_plain):
        args = [torch.tensor(a, dtype=torch.float32, device=cuda,
                             requires_grad=True) for a in arrays]
        out, aux = fn(*args, capacity_factor=1.25)
        results.append((out, aux, torch.autograd.grad(
            (out * g).sum() + aux, args)))
    (o1, a1, g1), (o2, a2, g2) = results
    assert torch.equal(o1, o2) and torch.equal(a1, a2)
    for name, p, q in zip(("x", "wg", "w1", "b1", "w2", "b2"), g1, g2):
        if name in ("w1", "b1", "w2"):
            assert torch.equal(p, q), name
        else:
            _close(p, q, name, 1e-6, 1e-6)


def case_k1_on_the_census_stream(cuda):
    """K1 on Wide & Deep's stream: synthetic census rows hashed by the
    port's spec, a table of 512 rows with nearly every segment hot."""
    from elasticdl_tpu_torch.data import parsing
    from elasticdl_tpu_torch.data.reader import SyntheticDataReader
    from elasticdl_tpu_torch.model_zoo.census import wide_deep

    reader = SyntheticDataReader(kind="census", num_records=2048)
    records = list(reader.read_records("synthetic-census-0", 0, 2048))
    feats, _ = parsing.as_batch_parser(wide_deep.dataset_fn("training", None))(
        records)
    ids = torch.sort(torch.from_numpy(feats["cat"]).reshape(-1).to(
        cuda, torch.int32), stable=True)[0].contiguous()
    rows = torch.randn((ids.numel(), 9), device=cuda)
    _assert_matches_plain(ids, rows, emb.padded_vocab(wide_deep.TOTAL_VOCAB))


def case_resnet20_step_on_the_card_matches_cpu(cuda):
    """One ResNet-20 (depth 8, float32) train step on the card against
    the port's CPU step from the same state: loss rtol 1e-5; params and
    BatchNorm's running averages rtol 1e-5 with atol 1e-5 of the largest
    magnitude over all of them (tests/test_torch_zoo.py's step tolerance:
    cuDNN and the CPU sum in other orders, and BatchNorm's fast variance
    magnifies that)."""
    r = np.random.RandomState(6)
    batch = {"features": r.rand(16, 32, 32, 3).astype(np.float32),
             "labels": r.randint(0, 10, 16).astype(np.int32)}
    results, weights = [], None
    for dev in ("cpu", None):
        tr = _card_trainer("cifar10.resnet.custom_model", "depth=8",
                           "float32", device=dev)
        state = tr.init_state(None)
        if weights is None:
            weights = {k: v.detach().clone() for k, v in
                       tr.model.state_dict().items()}
        tr.model.load_state_dict(weights)
        state, logs = tr.train_step(state, batch)
        results.append((float(logs["loss"]),
                        {k: v.detach().cpu().numpy() for k, v in
                         tr.model.state_dict().items()}))
    (cpu_loss, want), (card_loss, got) = results
    assert card_loss == pytest.approx(cpu_loss, rel=1e-5)
    for names in ([k for k in want if k.endswith(("mean", "var"))],
                  [k for k in want if not k.endswith(("mean", "var"))]):
        scale = max(np.abs(want[k]).max() for k in names)
        for k in names:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-5 * scale, err_msg=k)


def case_ring_on_the_card(cuda):
    """The ring of `ops/attention.py` in one process (`ring_attention_local`,
    4 blocks of 64 over B 2, T 256, H 2, D 64, bf16, causal) against one
    unsplit `full_attention` on the card: K2' once a (q block, kv block)
    pair (16, the wholly masked pairs included) and K3', K4' and the delta
    pass as often in the backward. The ring merges four bf16 partials in
    float32 and sums four bf16 gradient partials in bf16, where the unsplit
    call rounds once: out within 2**-7 of its largest magnitude, gradients
    within 2**-6 (both plus rtol 2**-8; `chip_smoke.py`'s RING_OUT_TOL and
    RING_GRAD_TOL say why)."""
    from elasticdl_tpu_torch.ops import attention

    q, k, v, dout, _ = _attn_inputs(cuda, 2, 256, 256, 2, 64, torch.bfloat16,
                                    seed=11)

    def fwd_bwd(fn):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = fn(*leaves)
        return [out.detach(), *torch.autograd.grad(out, leaves, dout)]

    for name in fa.launches:
        fa.launches[name] = 0
    ring = fwd_bwd(lambda q, k, v: attention.ring_attention_local(q, k, v, 4))
    torch.cuda.synchronize()
    assert fa.launches == {**{n: 0 for n in fa.launches}, fa.FWD_SM90: 16,
                           fa.BWD_DQ_SM90: 16, fa.BWD_DKV_SM90: 16,
                           fa.BWD_DELTA_SM90: 16}, fa.launches
    whole = fwd_bwd(attention.full_attention)
    for what, got, want in zip(("out", "dq", "dk", "dv"), ring, whole):
        assert bool(torch.isfinite(got).all()), what
        _close(got, want, what, 2 ** -8,
               atol_of_max=2 ** -7 if what == "out" else 2 ** -6)


def case_ring_over_head_groups_on_the_card(cuda):
    """The ring as a rank of a {seq, model} mesh runs it on its H/tp heads:
    B 2, T 256, H 4, D 64 bf16 cut into tp = 2 head groups of 2 heads,
    each ringed over 4 blocks of 64 (`ring_attention_local`). K2', K3',
    K4' and the delta pass 2 x 16 times; every launch against its plain
    version on the same inputs (BF16; lse 2e-5), and the joined output and
    gradients against one unsplit call as `case_ring_on_the_card` holds
    them."""
    from elasticdl_tpu_torch.ops import attention

    q, k, v, dout, _ = _attn_inputs(cuda, 2, 256, 256, 4, 64, torch.bfloat16,
                                    seed=13)
    fwd, bwd = [], []
    real_fwd, real_bwd = fa.flash_fwd, fa.flash_bwd

    def record_fwd(*args):
        out = real_fwd(*args)
        fwd.append((args, out))
        return out

    def record_bwd(*args):
        out = real_bwd(*args)
        bwd.append((args, out))
        return out

    def groups(q, k, v):
        return torch.cat([attention.ring_attention_local(
            *(x[:, :, g * 2:(g + 1) * 2].contiguous() for x in (q, k, v)),
            4) for g in range(2)], dim=2)

    def fwd_bwd(fn):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = fn(*leaves)
        return [out.detach(), *torch.autograd.grad(out, leaves, dout)]

    for name in fa.launches:
        fa.launches[name] = 0
    fa.flash_fwd, fa.flash_bwd = record_fwd, record_bwd
    try:
        split = fwd_bwd(groups)
    finally:
        fa.flash_fwd, fa.flash_bwd = real_fwd, real_bwd
    torch.cuda.synchronize()
    assert fa.launches == {**{n: 0 for n in fa.launches}, fa.FWD_SM90: 32,
                           fa.BWD_DQ_SM90: 32, fa.BWD_DKV_SM90: 32,
                           fa.BWD_DELTA_SM90: 32}, fa.launches
    assert (len(fwd), len(bwd)) == (32, 32)
    with torch.no_grad():
        for args, (out, lse) in fwd:
            want_out, want_lse = fa.flash_fwd_plain(*args)
            _close(out, want_out, "out", *BF16)
            _close(lse, want_lse, "lse", 2e-5, 2e-5)
        for args, (dq, dk, dv) in bwd:
            _close(dq, fa.flash_bwd_dq_plain(*args), "dq", *BF16)
            want_dk, want_dv = fa.flash_bwd_dkv_plain(*args)
            _close(dk, want_dk, "dk", *BF16)
            _close(dv, want_dv, "dv", *BF16)
    whole = fwd_bwd(attention.full_attention)
    for what, got, want in zip(("out", "dq", "dk", "dv"), split, whole):
        assert bool(torch.isfinite(got).all()), what
        _close(got, want, what, 2 ** -8,
               atol_of_max=2 ** -7 if what == "out" else 2 ** -6)


def _card_trainer(model_def, params, dtype, **knobs):
    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.training.model_spec import ModelSpec
    from elasticdl_tpu_torch.training.trainer import Trainer

    cfg = JobConfig.from_argv([
        "--model_zoo", os.path.join(REPO, "elasticdl_tpu_torch", "model_zoo"),
        "--model_def", model_def, "--model_params", params,
        "--compute_dtype", dtype])
    return Trainer(ModelSpec.from_config(cfg), **knobs)  # device: the card


def case_step_cost_on_the_card_matches_cpu(cuda):
    """`Trainer.train_step_cost` on the card counts the FLOPs the CPU
    counts for the same model and batch: the bf16 LM at D 64 (K2', K3',
    K4' and the delta pass behind `edl::flash_fwd` and `edl::flash_bwd`)
    and DeepFM (K1 behind `edl::place_sorted_grads`), under remat and
    accumulation too. The call launches one step's kernels and leaves the
    state bit-equal."""
    r = np.random.RandomState(9)
    toks = r.randint(0, 64, (4, 65)).astype(np.int32)
    lm_batch = {"features": toks[:, :-1], "labels": toks[:, 1:],
                "mask": np.ones((4,), np.float32)}
    fm_batch = {"features": {
        "dense": (r.rand(64, 13) * 20).astype(np.float32),
        "cat": r.randint(0, 1 << 30, (64, 26)).astype(np.int32)},
        "labels": r.randint(0, 2, (64,)).astype(np.int32)}
    lm = ("transformer.transformer_lm.custom_model",
          "vocab=64;num_layers=2;dim=128;heads=2;max_len=64")
    fm = ("deepfm.deepfm.custom_model", "field_vocab=1000;hidden=32,32")
    for (model_def, params), batch, knobs, launched in (
            (lm, lm_batch, {}, {fa.FWD_SM90: 2, fa.BWD_DQ_SM90: 2,
                                fa.BWD_DKV_SM90: 2, fa.BWD_DELTA_SM90: 2}),
            (lm, lm_batch, {"remat": True, "grad_accum": 2},
             {fa.FWD_SM90: 8, fa.BWD_DQ_SM90: 4, fa.BWD_DKV_SM90: 4,
              fa.BWD_DELTA_SM90: 4}),
            (fm, fm_batch, {}, {})):
        counts = {}
        for device in ("cuda", "cpu"):
            tr = _card_trainer(model_def, params, "bfloat16",
                               device=device, **knobs)
            state = tr.init_state(batch)
            tr.train_step(state, batch)
            before = {n: p.detach().clone() for n, p in state.params.items()}
            slots = {n: {k: v.clone() for k, v in state.optimizer.state[
                p].items()} for n, p in state.params.items()}
            flash, k1 = dict(fa.launches), placement.launches
            counts[device] = tr.train_step_cost(state, batch)["flops"]
            if device == "cuda":
                torch.cuda.synchronize()
                assert {k: n - flash[k] for k, n in fa.launches.items()
                        if n != flash[k]} == launched, fa.launches
                assert placement.launches - k1 == (
                    0 if launched else placement.PASSES)
            assert state.step == 1
            for n, p in state.params.items():
                assert torch.equal(p, before[n]), n
                for k, v in slots[n].items():
                    assert torch.equal(state.optimizer.state[p][k], v), n
        assert counts["cuda"] == counts["cpu"] > 0, (model_def, counts)


def case_lm_knobs_on_the_card(cuda):
    """The bf16 LM at D 64 on the card (K2', K3', K4', the delta pass):
    remat (`dots`, `nothing`) takes the same kernels on the same inputs,
    so its step equals the plain step's bit for bit, with K2' launched
    twice a layer (forward and recompute); accumulation 2 runs each
    micro-batch's forward and backward (K2' and K3' twice a layer) and
    its loss is the plain step's within rel 1e-4."""
    r = np.random.RandomState(8)
    toks = r.randint(0, 64, (4, 65)).astype(np.int32)
    batch = {"features": toks[:, :-1], "labels": toks[:, 1:],
             "mask": np.array([1, 1, 0, 1], np.float32)}
    params = "vocab=64;num_layers=2;dim=128;heads=2;max_len=64"
    weights, runs = None, {}
    for name, knobs in (("plain", {}), ("dots", {"remat_policy": "dots"}),
                        ("nothing", {"remat_policy": "nothing"}),
                        ("accum", {"grad_accum": 2})):
        tr = _card_trainer("transformer.transformer_lm.custom_model",
                           params, "bfloat16", **knobs)
        state = tr.init_state(batch)
        if weights is None:
            weights = {n: t.detach().clone()
                       for n, t in tr.model.state_dict().items()}
        tr.model.load_state_dict(weights)
        before = dict(fa.launches)
        loss, grads = tr.compute_grads(state, batch)
        torch.cuda.synchronize()
        runs[name] = (float(loss), {n: g.clone() for n, g in grads.items()},
                      {k: fa.launches[k] - before[k] for k in before})
    layers = 2
    want = {"plain": (1, 1), "dots": (2, 1), "nothing": (2, 1),
            "accum": (2, 2)}
    for name, (fwd, bwd) in want.items():
        got = runs[name][2]
        assert got[fa.FWD_SM90] == fwd * layers, (name, got)
        for k in (fa.BWD_DQ_SM90, fa.BWD_DKV_SM90, fa.BWD_DELTA_SM90):
            assert got[k] == bwd * layers, (name, k, got)
        assert got[fa.FWD] == got[fa.BWD_DQ] == got[fa.BWD_DKV] == 0
    plain_loss, plain_grads, _ = runs["plain"]
    for name in ("dots", "nothing"):
        assert runs[name][0] == plain_loss, name
        for n, g in runs[name][1].items():
            assert torch.equal(g, plain_grads[n]), (name, n)
    assert runs["accum"][0] == pytest.approx(plain_loss, rel=1e-4)


def case_grouped_deepfm_on_the_card(cuda):
    """`train_many` on the card equals the same steps one by one bit for
    bit, with K1 launched twice a step in both."""
    from elasticdl_tpu_torch.training.trainer import stack_batches

    r = np.random.RandomState(9)
    batches = [{
        "features": {"dense": r.rand(256, 13).astype(np.float32),
                     "cat": r.randint(0, 1 << 30, (256, 26)).astype(np.int32)},
        "labels": r.randint(0, 2, 256).astype(np.int32),
        "mask": np.ones((256,), np.float32)} for _ in range(4)]
    states, weights, launches = [], None, []
    for grouped in (False, True):
        tr = _card_trainer("deepfm.deepfm.custom_model",
                           "field_vocab=1000;hidden=32,32", "bfloat16")
        state = tr.init_state(batches[0])
        if weights is None:
            weights = {n: t.detach().clone()
                       for n, t in tr.model.state_dict().items()}
        tr.model.load_state_dict(weights)
        placement.launches = 0
        if grouped:
            state, logs = tr.train_many(state,
                                        stack_batches(batches, cuda))
            losses = logs["loss"]
        else:
            losses = []
            for b in batches:
                state, logs = tr.train_step(state, b)
                losses.append(logs["loss"])
            losses = torch.stack(losses)
        torch.cuda.synchronize()
        launches.append(placement.launches)
        states.append((state, losses))
    assert launches == [placement.PASSES * 4] * 2
    (a, la), (b, lb) = states
    assert torch.equal(la, lb) and a.step == b.step == 4
    for n in a.params:
        assert torch.equal(a.params[n], b.params[n]), n


def _captured_and_eager(model_def, params, dtype, batch, **knobs):
    """A trainer that captures its steps and an eager twin from the same
    weights and seed, on the card."""
    graph = _card_trainer(model_def, params, dtype, **knobs)
    eager = _card_trainer(model_def, params, dtype, **knobs)
    assert graph.capture_reason is None, graph.capture_reason
    gs, es = graph.init_state(batch), eager.init_state(batch)
    eager.model.load_state_dict(graph.model.state_dict())
    return graph, gs, eager, es


def case_captured_steps_equal_eager(cuda, model_def, params, dtype, batch,
                                    kernels, **knobs):
    """A captured `train_step` and a `train_many` of 4 on the card equal
    the eager body bit for bit over 5 steps and a group (losses,
    parameters, optimizer slots, the generator), with one replay a step
    and one a group, and each replay credits the launches its capture
    recorded of `kernels` (the kernels' counters count none in the
    capture or its warm-up)."""
    from elasticdl_tpu_torch.training import step_graph
    from elasticdl_tpu_torch.training.trainer import stack_batches

    graph, gs, eager, es = _captured_and_eager(model_def, params, dtype,
                                               batch, **knobs)
    args = graph._device_args(batch)
    before = step_graph.launch_counts()
    losses = [graph.train_step(gs, args)[1]["loss"] for _ in range(5)]
    torch.cuda.synchronize()
    (g,) = [x for x in graph._train_step.graphs() if x.bound_to(graph, gs)]
    assert isinstance(g, step_graph.CapturedGraph) and g.replays == 5
    counted = step_graph.launch_counts()
    for name in kernels:
        assert g.launches.get(name, 0) > 0, (name, g.launches)
        assert counted[name] - before[name] == 5 * g.launches[name], name
    assert g.pool_bytes > 0 and g.capture_s > 0
    want = []
    for _ in range(5):
        want.append(eager._train_body(es, args))
        es.step += 1
    group = graph.train_many(gs, stack_batches([batch] * 4, cuda))[1]
    (gm,) = [x for x in graph._train_many.graphs()
             if x.bound_to(graph, gs)]
    assert gm.replays == 1
    for _ in range(4):
        want.append(eager._train_body(es, args))
        es.step += 1
    got = torch.cat([torch.stack(losses), group["loss"]])
    assert torch.equal(got, torch.stack(want)), (got, want)
    assert gs.step == es.step == 9
    for n, p in gs.params.items():
        assert torch.equal(p, es.params[n]), n
        for k, v in gs.optimizer.state[p].items():
            assert torch.equal(v, es.optimizer.state[es.params[n]][k]), (n, k)
    assert torch.equal(gs.generator.get_state(), es.generator.get_state())


def case_captured_lr_change_reaches_the_replay(cuda):
    """An LR set after capture reaches the next replay: the zoo's Adam on
    the card holds its rate as a device tensor (`capturable`), which
    `set_learning_rate` writes in place; at rate 0 a replay moves no
    parameter, and the eager twin at the same rates agrees bit for bit."""
    r = np.random.RandomState(13)
    batch = {
        "features": {"dense": r.rand(64, 13).astype(np.float32),
                     "cat": r.randint(0, 1 << 30, (64, 26)).astype(np.int32)},
        "labels": r.randint(0, 2, 64).astype(np.int32),
        "mask": np.ones((64,), np.float32)}
    graph, gs, eager, es = _captured_and_eager(
        "deepfm.deepfm.custom_model", "field_vocab=1000;hidden=32,32",
        "float32", batch)
    (group,) = gs.optimizer.param_groups
    assert group["capturable"] and isinstance(group["lr"], torch.Tensor)
    assert group["lr"].device.type == "cuda"
    graph.train_step(gs, batch)
    eager._train_body(es, eager._device_args(batch))
    lr = group["lr"]
    for t, s in ((graph, gs), (eager, es)):
        t.set_learning_rate(s, 0.0)
    assert group["lr"] is lr
    before = {n: p.detach().clone() for n, p in gs.params.items()}
    graph.train_step(gs, batch)
    eager._train_body(es, eager._device_args(batch))
    for n, p in gs.params.items():
        assert torch.equal(p, before[n]), n
        assert torch.equal(p, es.params[n]), n
    for t, s in ((graph, gs), (eager, es)):
        t.set_learning_rate(s, 1e-2)
    graph.train_step(gs, batch)
    eager._train_body(es, eager._device_args(batch))
    assert any(not torch.equal(p, before[n]) for n, p in gs.params.items())
    for n, p in gs.params.items():
        assert torch.equal(p, es.params[n]), n


def case_capture_rewinds_the_generator(cuda):
    """What lets remat capture: it rewinds the step's generator on the
    host (`get_state`, then `set_state` before the recompute) so that the
    recompute draws the forward's masks again. Inside a capture the
    rewind is recorded too: a replay draws the same values twice, and
    the next replay draws new ones, as the eager calls do."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graph.capture_begin()
        entry = gen.get_state()
        a = torch.rand(64, generator=gen, device=cuda)
        gen.set_state(entry)
        b = torch.rand(64, generator=gen, device=cuda)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    twin = torch.Generator(device=cuda)
    twin.manual_seed(0)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        entry = twin.get_state()
        want = torch.rand(64, generator=twin, device=cuda)
        twin.set_state(entry)
        torch.rand(64, generator=twin, device=cuda)
        assert torch.equal(a, want) and torch.equal(b, want)
    assert torch.equal(gen.get_state(), twin.get_state())


def case_card_update_matches_cpu(cuda, model_def, params, batch, lr2,
                                 loss_rtol):
    """The card's optimizer update against the CPU's plain one: two train
    steps of `model_def` in float32 on the card (the captured step over
    the zoo optimizer's card flavour: capturable Adam or AdamW with a
    device learning rate, or fused SGD) and on the CPU (the flavour the
    CPU tests hold against optax), from the same weights and batch, the
    second after `set_learning_rate(lr2)` on both. Losses within
    `loss_rtol` (the card-against-CPU gradient tests' loss bound);
    parameters and the optimizer's slots (Adam's step, moments and
    momentum buffers) rtol 1e-4, atol 1e-5, tests/test_torch_trainer.py's
    bound after Adam steps. An LM's k biases are held apart as there:
    their gradient is 0 in exact arithmetic, so each side's Adam step
    normalizes rounding noise and moves them by up to the learning rate,
    and both sides stay within the two steps' rates of their initial 0."""
    from elasticdl_tpu_torch.training import lr_modulation, step_graph

    runs, weights = [], None
    for dev in ("cpu", None):
        tr = _card_trainer(model_def, params, "float32", device=dev)
        state = tr.init_state(batch)
        if weights is None:
            weights = {k: v.detach().clone()
                       for k, v in tr.model.state_dict().items()}
        tr.model.load_state_dict(weights)
        lr1 = lr_modulation.get_learning_rate(state.optimizer)
        losses = []
        for i in range(2):
            if i:
                tr.set_learning_rate(state, lr2)
            state, logs = tr.train_step(state, batch)
            losses.append(float(logs["loss"]))
        runs.append((tr, state, losses))
    (_, cs, cpu_losses), (card, gs, card_losses) = runs
    assert card.capture_reason is None, card.capture_reason
    (graph,) = [g for g in card._train_step.graphs() if g.bound_to(card, gs)]
    assert isinstance(graph, step_graph.CapturedGraph) and graph.replays == 2
    flavour = {k: gs.optimizer.defaults.get(k) for k in ("capturable",
                                                          "fused")}
    assert True in flavour.values(), flavour
    assert isinstance(gs.optimizer.param_groups[0]["lr"], torch.Tensor)
    assert not any(cs.optimizer.defaults.get(k) for k in flavour)
    np.testing.assert_allclose(card_losses, cpu_losses, rtol=loss_rtol)
    for n, p in cs.params.items():
        q = gs.params[n]
        if n.endswith(".k.bias"):
            for x in (p, q):
                assert float(x.detach().abs().max()) <= lr1 + lr2, n
            continue
        np.testing.assert_allclose(q.detach().cpu().numpy(),
                                   p.detach().numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=n)
        slots, card_slots = cs.optimizer.state[p], gs.optimizer.state[q]
        assert slots.keys() == card_slots.keys(), n
        for k, v in slots.items():
            np.testing.assert_allclose(
                card_slots[k].detach().cpu().numpy(), v.detach().numpy(),
                rtol=1e-4, atol=1e-5, err_msg=f"{n} {k}")


def _lm_batch(b=4, t=64, vocab=64, seed=17):
    r = np.random.RandomState(seed)
    toks = r.randint(0, vocab, (b, t + 1)).astype(np.int32)
    return {"features": toks[:, :-1], "labels": toks[:, 1:],
            "mask": np.ones((b,), np.float32)}


def case_job_on_the_card(cuda, tmp):
    """The job path at a small width: the port's master and worker in this
    process (the worker on a thread, device defaulted: the card), K1
    launched twice a train step, the newest checkpoint restoring the final
    state exactly on the card, and the export loading on the card and
    predicting as the final state does (atol 1e-6, float32 logits)."""
    import threading

    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.common.net import free_port
    from elasticdl_tpu_torch.master.main import Master
    from elasticdl_tpu_torch.training import export
    from elasticdl_tpu_torch.training.checkpoint import CheckpointManager
    from elasticdl_tpu_torch.training.model_spec import ModelSpec
    from elasticdl_tpu_torch.training.trainer import Trainer
    from elasticdl_tpu_torch.worker.worker import Worker

    zoo = os.path.join(REPO, "elasticdl_tpu_torch", "model_zoo")
    cfg = JobConfig.from_argv([
        "--model_zoo", zoo, "--model_def", "deepfm.deepfm.custom_model",
        "--model_params", "field_vocab=1000;hidden=32,32",
        "--minibatch_size", "256", "--records_per_task", "512",
        "--training_data", "synthetic://criteo?n=2048&shards=4",
        "--validation_data", "synthetic://criteo?n=512&shards=2",
        "--checkpoint_dir", os.path.join(tmp, "ckpt"),
        "--checkpoint_steps", "4", "--keep_checkpoint_max", "2",
        "--output", os.path.join(tmp, "export"),
        "--master_addr", f"localhost:{free_port()}",
        "--worker_heartbeat_s", "1"])
    master = Master(cfg)
    master.start()
    worker = Worker(cfg)
    assert worker.device.type == "cuda"
    rc = []
    thread = threading.Thread(target=lambda: rc.append(worker.run()))
    placement.launches = 0
    thread.start()
    try:
        assert master.wait(poll_s=0.1, timeout_s=120)
        counts = master.dispatcher.counts()
        results = master.evaluation.latest_results()
    finally:
        master.shutdown(grace_s=0.5)
        thread.join(60)
    assert rc == [0]
    assert counts["finished_training"] == 4 and not counts["failed_permanently"]
    assert np.isfinite(results["auc"]) and np.isfinite(results["loss"])
    assert worker._global_step == 8
    assert placement.launches == placement.PASSES * 8

    final = worker._state
    mngr = CheckpointManager(cfg.checkpoint_dir)
    assert mngr.all_steps() == [4, 8]
    fresh = Trainer(ModelSpec.from_config(cfg)).init_state(None)
    assert mngr.restore(fresh) is fresh and fresh.step == final.step
    for name, p in final.params.items():
        assert fresh.params[name].device.type == "cuda"
        assert torch.equal(fresh.params[name], p), name
    for i, slots in final.optimizer.state_dict()["state"].items():
        got = fresh.optimizer.state_dict()["state"][i]
        for k, v in slots.items():
            assert torch.equal(got[k].cpu(), v.cpu()), (i, k)

    model, _ = export.load_model(cfg.output, zoo)
    r = np.random.RandomState(3)
    batch = {"features": {
        "dense": r.rand(256, 13).astype(np.float32),
        "cat": r.randint(0, 1 << 30, (256, 26)).astype(np.int32)}}
    with torch.no_grad():
        got = model({k: torch.from_numpy(v).to(cuda)
                     for k, v in batch["features"].items()})
    want = worker._trainer.predict_step(final, batch)
    assert got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 1e-6


def case_callbacks_lr_lands_on_the_card(cuda, tmp):
    """Zoo callbacks with the worker on the card: `tests/test_torch_callbacks.py`'s
    job (the port's DeepFM with `ReduceLROnPlateau` down to 5e-4 and
    `EarlyStopping` on a certain plateau, an eval job every 2 steps), the
    worker's device defaulted. The pushed LR lands in every param group of
    the worker's Adam, whose moments live on the card; EarlyStopping ends
    training; K1 launches twice a train step."""
    import threading

    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.common.net import free_port
    from elasticdl_tpu_torch.master.main import Master
    from elasticdl_tpu_torch.worker.worker import Worker
    from tests.test_torch_callbacks import PORT_DEEPFM, write_zoo

    zoo = os.path.join(tmp, "cb_zoo")
    write_zoo(zoo, "deepfm_cb_card", PORT_DEEPFM)
    cfg = JobConfig.from_argv([
        "--model_zoo", zoo, "--model_def", "deepfm_cb_card.model.custom_model",
        "--model_params", "field_vocab=1000;hidden=32,32",
        "--minibatch_size", "256", "--records_per_task", "512",
        "--training_data", "synthetic://criteo?n=16384&shards=4",
        "--validation_data", "synthetic://criteo?n=512&shards=1",
        "--evaluation_steps", "2",
        "--master_addr", f"localhost:{free_port()}",
        "--worker_heartbeat_s", "0.05"])
    master = Master(cfg)
    master.start()
    worker = Worker(cfg)
    assert worker.device.type == "cuda"
    rc = []
    thread = threading.Thread(target=lambda: rc.append(worker.run()))
    placement.launches = 0
    thread.start()
    try:
        assert master.wait(poll_s=0.1, timeout_s=120)
        counts = master.dispatcher.counts()
        plateau, es = master.callbacks
    finally:
        master.shutdown(grace_s=0.5)
        thread.join(60)
    assert rc == [0]
    assert plateau.lr == 5e-4 and es.stopped
    optimizer = worker._state.optimizer
    assert [g["lr"] for g in optimizer.param_groups] == \
        [5e-4] * len(optimizer.param_groups)
    assert all(s["exp_avg"].device.type == "cuda"
               for s in optimizer.state.values())
    assert 4 <= counts["finished_training"] < 32, counts
    assert not counts["failed_permanently"]
    assert placement.launches == placement.PASSES * worker._global_step


def case_tier_store_on_the_card(cuda):
    """A device-mode tier store on the card and a host-mode store take the
    same deduped pushes (sorted unique ids: one term a row) and end with
    bit-equal shards; every push launches K1 (2 kernels), and pulls read
    the same rows."""
    from elasticdl_tpu_torch.embedding import sharding, store
    from elasticdl_tpu_torch.training import compile_cache as cc

    spec = sharding.TableSpec("users", vocab=8192, dim=32, seed=3)
    view = sharding.ShardMapView(version=1, num_shards=2, owners=(0, 0),
                                 tables=(spec,))
    card = store.EmbeddingShardStore(0, compile_cache=cc.CompileCache(),
                                     device=True)
    host = store.EmbeddingShardStore(0, device=False)
    assert card.device.type == cuda.type
    for st in (card, host):
        st.attach(view)
    r = np.random.RandomState(0)
    placement.launches = 0
    pushes = 0
    for seq in range(1, 5):
        for shard in (0, 1):
            uniq = np.unique(r.randint(0, 4096, 700)).astype(np.int32)
            ids = np.full((1024,), -1, np.int32)
            ids[:uniq.size] = uniq
            vals = r.randn(1024, 32).astype(np.float32)
            for st in (card, host):
                assert st.push("users", shard, ids, vals, client_id="c",
                               seq=seq, scale=-0.01 * seq)
            pushes += 1
    assert placement.launches == placement.PASSES * pushes
    for shard in (0, 1):
        assert isinstance(card._shards[("users", shard)].rows, torch.Tensor)
        assert np.array_equal(card.extract_shard("users", shard)["rows"],
                              host.extract_shard("users", shard)["rows"])
        ids = np.array([-1, 0, 5, 4095, 10 ** 6], np.int32)
        assert np.array_equal(card.pull("users", shard, ids),
                              host.pull("users", shard, ids))


def case_serving_export_on_the_card(cuda, tmp):
    """`export_saved_model` on the card: a small LM exported at batch 4
    serves 4 and 3 rows bit-equal to the eager `load_model` model, its
    program launching K2' (bf16, D 128) or K2-tf32 (float32, D 16) once a
    layer and nothing else; the program refuses to load for the CPU."""
    from elasticdl_tpu_torch.training import export

    zoo = os.path.join(REPO, "elasticdl_tpu_torch", "model_zoo")
    r = np.random.RandomState(9)
    tokens = r.randint(0, 64, (4, 33)).astype(np.int32)
    batch = {"features": tokens[:, :-1], "labels": tokens[:, 1:],
             "mask": np.ones((4,), np.float32)}
    for dtype, dim, heads, kernel in (("bfloat16", 128, 2, fa.FWD_SM90),
                                      ("float32", 64, 4, fa.FWD_TF32)):
        params = (f"vocab=64;num_layers=2;dim={dim};heads={heads};"
                  "max_len=64")
        tr = _card_trainer("transformer.transformer_lm.custom_model",
                           params, dtype)
        out = os.path.join(tmp, f"serve-{dtype}")
        export.export_model(tr.init_state(batch), out,
                            model_def="transformer.transformer_lm."
                            "custom_model", model_params=tr.spec.model_params)
        path = export.export_saved_model(out, zoo, batch["features"])
        serve = export.load_saved_model(path)
        model, _ = export.load_model(out, zoo)
        with pytest.raises(ValueError, match="serves there only"):
            export.load_saved_model(path, device="cpu")
        for rows in (4, 3):
            x = torch.from_numpy(batch["features"][:rows]).to(cuda)
            with torch.no_grad():
                want = model(x, training=False)
                for name in fa.launches:
                    fa.launches[name] = 0
                got = serve(x)
            torch.cuda.synchronize()
            assert fa.launches == {**{n: 0 for n in fa.launches},
                                   kernel: 2}, (dtype, fa.launches)
            assert got.shape == (rows, 32, 64) and torch.equal(got, want)


def test_kernels_on_the_card(cuda, tmp_path):
    """Every case above, in one collected test (ROADMAP.md, conventions:
    one collected test per port test file)."""
    for d in (1, 16, 17, 33):
        for kind in ("uniform", "skewed", "oob"):
            case_k1_matches_plain(cuda, kind, d)
        case_k1_hot_segments(cuda, d)
    case_k1_empty_stream_and_empty_table(cuda)
    case_k1_is_deterministic_and_counts_launches(cuda)
    case_k1_wrapper_rejects_what_the_kernel_does_not_take(cuda)
    case_lookup_backward_on_the_card_matches_cpu(cuda)
    case_shard_part_on_the_card_matches_plain(cuda)
    case_one_rank_nccl_cohort(cuda)
    case_deepfm_grads_on_the_card_match_cpu(cuda)
    case_k1_on_the_census_stream(cuda)
    case_resnet20_step_on_the_card_matches_cpu(cuda)
    for dtype in (torch.float32, torch.bfloat16):
        for d in (16, 32, 64, 96, 128, 256):
            case_flash_kernels_match_plain(cuda, dtype, d, 100, 100, True, 0,
                                           0, False)
        for tq, tk, causal, q_off, kv_off, glse in (
                (64, 64, True, 32, 0, False), (64, 64, True, 16, 0, True),
                (64, 64, True, 64, 32, False), (32, 96, False, 0, 0, True),
                (200, 130, True, 70, 0, True)):
            case_flash_kernels_match_plain(cuda, dtype, 64, tq, tk, causal,
                                           q_off, kv_off, glse)
    for d in (16, 32, 64, 128):  # the Hopper route's tails, offsets, g_lse
        for tq, tk, causal, q_off, kv_off, glse in (
                (130, 130, True, 0, 0, True), (200, 200, True, 0, 0, False),
                (100, 230, False, 0, 0, True), (130, 200, True, 70, 0, True),
                (200, 130, True, 0, 64, False), (100, 100, True, 0, 1024,
                                                 False)):
            case_flash_kernels_match_plain(cuda, torch.bfloat16, d, tq, tk,
                                           causal, q_off, kv_off, glse)
        case_flash_kernels_match_plain(cuda, torch.bfloat16, d, 200, 200,
                                       True, 0, 0, True, views=True)
    case_full_attention_takes_the_kernels_at_any_length(cuda)
    case_flash_fully_masked_is_zero(cuda)
    for d in (16, 32, 64, 128):
        case_flash_is_deterministic_and_counts_launches(cuda, d)
    for d in (16, 32):
        case_narrow_hopper_kernels_match_k2_k3_k4_and_plain(cuda, d)
    for d in (16, 32, 64, 128):
        case_tf32_forward_matches_k2_and_plain(cuda, d)
        case_tf32_forward_rejects_strides_tma_cannot_take(cuda, d)
        case_tf32_backward_matches_k3_k4_and_plain(cuda, d)
        case_tf32_backward_rejects_strides_tma_cannot_take(cuda, d)
    case_tensor_core_route_at_float32_d128(cuda)
    case_k4_prime_at_d128_matches_k4_and_plain(cuda)
    case_bf16_lm_with_16_wide_heads_runs_the_hopper_kernels(cuda)
    case_bf16_lm_with_128_wide_heads_runs_k4_prime(cuda)
    case_flash_wrapper_rejects_what_the_kernel_does_not_take(cuda)
    for d in (64, 16, 32):
        case_hopper_wrapper_rejects_strides_tma_cannot_take(cuda, d)
    case_lm_grads_on_the_card_match_cpu(cuda)
    for extra in (";moe_experts=4", ";pp_axis=pp;seq_parallel=none",
                  ";tp_axis=model"):
        case_lm_grads_on_the_card_match_cpu(cuda, extra)
    case_moe_routes_on_the_card(cuda)
    case_ring_on_the_card(cuda)
    case_ring_over_head_groups_on_the_card(cuda)
    case_lm_knobs_on_the_card(cuda)
    case_step_cost_on_the_card_matches_cpu(cuda)
    case_grouped_deepfm_on_the_card(cuda)
    r = np.random.RandomState(11)
    deepfm_batch = {
        "features": {"dense": r.rand(256, 13).astype(np.float32),
                     "cat": r.randint(0, 1 << 30, (256, 26)).astype(np.int32)},
        "labels": r.randint(0, 2, 256).astype(np.int32),
        "mask": np.ones((256,), np.float32)}
    case_captured_steps_equal_eager(
        cuda, "deepfm.deepfm.custom_model", "field_vocab=1000;hidden=32,32",
        "bfloat16", deepfm_batch, (placement.KERNEL,))
    case_captured_steps_equal_eager(
        cuda, "transformer.transformer_lm.custom_model",
        "vocab=64;num_layers=2;dim=128;heads=8;max_len=64;dropout=0.1",
        "bfloat16", _lm_batch(),
        (fa.FWD_SM90, fa.BWD_DQ_SM90, fa.BWD_DKV_SM90, fa.BWD_DELTA_SM90))
    for knobs in ({"remat_policy": "dots"}, {"remat": True, "grad_accum": 2}):
        case_captured_steps_equal_eager(
            cuda, "transformer.transformer_lm.custom_model",
            "vocab=64;num_layers=2;dim=128;heads=8;max_len=64;dropout=0.1",
            "bfloat16", _lm_batch(),
            (fa.FWD_SM90, fa.BWD_DQ_SM90, fa.BWD_DKV_SM90,
             fa.BWD_DELTA_SM90), **knobs)
    # cuDNN's default convolution backward sums in no fixed order, so two
    # eager runs differ in the last bits too: deterministic cuDNN, as
    # chip_smoke's remat_equal runs ResNet-50
    cudnn = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        case_captured_steps_equal_eager(
            cuda, "mnist.mnist_cnn.custom_model", "", "float32", {
                "features": r.rand(16, 28, 28, 1).astype(np.float32),
                "labels": r.randint(0, 10, 16).astype(np.int32),
                "mask": np.ones((16,), np.float32)}, ())
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = cudnn
    case_captured_lr_change_reaches_the_replay(cuda)
    case_capture_rewinds_the_generator(cuda)
    case_card_update_matches_cpu(
        cuda, "deepfm.deepfm.custom_model", "field_vocab=1000;hidden=32,32",
        deepfm_batch, 5e-4, 1e-5)
    case_card_update_matches_cpu(
        cuda, "transformer.transformer_lm.custom_model",
        "vocab=64;num_layers=2;dim=64;heads=4;max_len=64", _lm_batch(),
        1e-4, 5e-5)
    case_card_update_matches_cpu(
        cuda, "cifar10.resnet.custom_model", "depth=20", {
            "features": r.rand(16, 32, 32, 3).astype(np.float32),
            "labels": r.randint(0, 10, 16).astype(np.int32)}, 0.05, 1e-5)
    case_job_on_the_card(cuda, str(tmp_path))
    case_callbacks_lr_lands_on_the_card(cuda, str(tmp_path))
    case_tier_store_on_the_card(cuda)
    case_serving_export_on_the_card(cuda, str(tmp_path))
