"""Tests of the port that need the card: the hand-written CUDA kernels
against their plain versions, the train steps on the GPU against the
same steps on the CPU, and the DeepFM job path (master, worker,
checkpoint, export) on the card. They skip where no CUDA device is
present.

This file imports torch and the port only, so it also runs on a GPU
machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance for K1 against its plain version: the two sum the same f32
values in different orders (the kernel in a fixed order of its own,
`index_add_` with atomics), so each entry is held to 1e-6 + 1e-5 x the
sum of the magnitudes of its terms — the scale that summation rounding
grows with.

Tolerances for the flash kernels (K2-K4, and for bfloat16 at D 64 / 128
the Hopper kernels K2', K3', K4' and the delta pass) against their plain
versions, the reference's own for its kernel against its naive path:
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
    should add, by `_sm90`: on the Hopper route the delta pass once, read
    by K3' and K4'."""
    fwd = fa.FWD_SM90 if fa._sm90(dtype, d) else fa.FWD
    dq = fa.BWD_DQ_SM90 if fa._sm90(dtype, d, fa.BWD_DQ_SM90) else fa.BWD_DQ
    dkv = (fa.BWD_DKV_SM90 if fa._sm90(dtype, d, fa.BWD_DKV_SM90)
           else fa.BWD_DKV)
    bwd = [dq, dkv]
    if fa.BWD_DQ_SM90 in bwd or fa.BWD_DKV_SM90 in bwd:
        bwd.append(fa.BWD_DELTA_SM90)
    return {n: int(n in [fwd] + bwd) for n in fa.launches}


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
    if fa._sm90(dtype, d, fa.BWD_DQ_SM90):
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


def case_flash_is_deterministic_and_counts_launches(cuda):
    q, k, v, dout, glse = _attn_inputs(cuda, 2, 256, 256, 4, 64,
                                       torch.bfloat16, seed=1)
    before = dict(fa.launches)
    outs = []
    for _ in range(2):
        out, lse = fa.flash_fwd(q, k, v)
        outs.append((out, lse,
                     *fa.flash_bwd(q, k, v, out, dout, lse, glse)))
    route = _route(torch.bfloat16, 64)
    assert route[fa.FWD_SM90] and route[fa.BWD_DQ_SM90]
    assert route[fa.BWD_DKV_SM90] and route[fa.BWD_DELTA_SM90] == 1
    assert fa.launches == {n: before[n] + 2 * route[n] for n in before}
    for a, b in zip(*outs):
        assert torch.equal(a, b)


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


def case_hopper_wrapper_rejects_strides_tma_cannot_take(cuda):
    """A bf16 D 64 view whose h stride is 68 elements (136 bytes, not a
    multiple of 16) is on the Hopper route (K2', K3', K4'), which raises
    before any launch rather than falling back to the CUDA-core kernels."""
    wide = torch.randn((1, 32, 2, 68), device=cuda).to(torch.bfloat16)
    q = wide[..., :64]
    before = dict(fa.launches)
    with pytest.raises(ValueError, match="TMA"):
        fa.flash_fwd(q, q, q)
    out, lse = fa.flash_fwd(*(q.contiguous() for _ in range(3)))
    for backward in (fa.flash_bwd_dkv, fa.flash_bwd_dq, fa.flash_bwd):
        with pytest.raises(ValueError, match="TMA"):
            backward(q, q, q, out, out, lse)
    assert fa.launches[fa.FWD] == before[fa.FWD]
    assert fa.launches[fa.BWD_DQ] == before[fa.BWD_DQ]
    assert fa.launches[fa.BWD_DKV] == before[fa.BWD_DKV]
    assert fa.launches[fa.BWD_DELTA_SM90] == before[fa.BWD_DELTA_SM90]


def case_lm_grads_on_the_card_match_cpu(cuda):
    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.training.model_spec import ModelSpec
    from elasticdl_tpu_torch.training.trainer import Trainer

    cfg = JobConfig.from_argv([
        "--model_zoo", os.path.join(REPO, "elasticdl_tpu_torch", "model_zoo"),
        "--model_def", "transformer.transformer_lm.custom_model",
        "--model_params", "vocab=64;num_layers=2;dim=64;heads=4;max_len=64",
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
        loss, grads = tr.compute_grads(state, batch)
        results.append((float(loss), {n: g.cpu() for n, g in grads.items()}))
    assert results[1][0] == pytest.approx(results[0][0], rel=5e-5)
    for n, want in results[0][1].items():
        got = results[1][1][n]
        if n.endswith(".k.bias"):       # 0 in exact arithmetic
            continue
        _close(got, want, n, 5e-5, 5e-5)


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
    case_deepfm_grads_on_the_card_match_cpu(cuda)
    for dtype in (torch.float32, torch.bfloat16):
        for d in (16, 64, 96, 128, 256):
            case_flash_kernels_match_plain(cuda, dtype, d, 100, 100, True, 0,
                                           0, False)
        for tq, tk, causal, q_off, kv_off, glse in (
                (64, 64, True, 32, 0, False), (64, 64, True, 16, 0, True),
                (64, 64, True, 64, 32, False), (32, 96, False, 0, 0, True),
                (200, 130, True, 70, 0, True)):
            case_flash_kernels_match_plain(cuda, dtype, 64, tq, tk, causal,
                                           q_off, kv_off, glse)
    for d in (64, 128):         # the Hopper route's tails, offsets, g_lse
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
    case_flash_is_deterministic_and_counts_launches(cuda)
    case_flash_wrapper_rejects_what_the_kernel_does_not_take(cuda)
    case_hopper_wrapper_rejects_strides_tma_cannot_take(cuda)
    case_lm_grads_on_the_card_match_cpu(cuda)
    case_job_on_the_card(cuda, str(tmp_path))
