"""The port's flash attention (`ops/flash_attention.py`, on the CPU its plain
versions of K2-K4) against the reference's Pallas kernels, run in interpret
mode on the CPU (`interpret=True`), at B2 T64 H2 D16 with 16-row blocks.

Tolerances are the reference's own (`tests/test_pallas_attention.py`):
float32 outputs and lse 2e-5, gradients 5e-5 (the two sum in different
orders: the Pallas kernel block by block, the plain version over the whole
row), bfloat16 outputs 3e-2 (one bf16 rounding of each).

Each interpret-mode case runs its forward and backward in one call (the
backward is what costs: ~3 s here), and cases the materialized reference
proves as well run against that instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.ops import attention as jatt
from elasticdl_tpu.ops import pallas_attention as jflash
from elasticdl_tpu_torch.ops import attention as tatt
from elasticdl_tpu_torch.ops import flash_attention as tflash

B, T, H, D = 2, 64, 2, 16
F32 = dict(atol=2e-5, rtol=2e-5)
GRAD = dict(atol=5e-5, rtol=5e-5)


def _qkv(t_q=T, t_k=T, seed=0):
    r = np.random.RandomState(seed)
    return (r.randn(B, t_q, H, D).astype(np.float32),
            r.randn(B, t_k, H, D).astype(np.float32),
            r.randn(B, t_k, H, D).astype(np.float32))


def _torch(*arrays, dtype=torch.float32, grad=False):
    return [torch.from_numpy(a).to(dtype).requires_grad_(grad)
            for a in arrays]


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _port_value_and_grads(q, k, v, causal, q_off=0, kv_off=0, with_lse=False,
                          w_lse=None):
    """Port: out, lse and the grads of sum(out^2) (+ sum(sin(lse) * w))."""
    tq, tk, tv = _torch(q, k, v, grad=True)
    out, lse = tflash.flash_attention_lse(tq, tk, tv, causal=causal,
                                          q_offset=q_off, kv_offset=kv_off)
    loss = torch.sum(out ** 2)
    if with_lse:
        loss = loss + torch.sum(torch.sin(lse) * torch.from_numpy(w_lse))
    loss.backward()
    return (out.detach().numpy(), lse.detach().numpy(),
            [t.grad.numpy() for t in (tq, tk, tv)])


def _ref_value_and_grads(q, k, v, causal, q_off=0, kv_off=0, with_lse=False,
                         w_lse=None, block=16):
    """Reference Pallas kernels in interpret mode, forward and backward in
    one call."""

    def loss(q, k, v):
        if with_lse:
            out, lse = jflash.flash_attention_lse(
                q, k, v, causal=causal, q_offset=q_off, kv_offset=kv_off,
                block_q=block, block_k=block, interpret=True)
            return (jnp.sum(out ** 2) + jnp.sum(jnp.sin(lse) * w_lse),
                    (out, lse))
        out = jflash.flash_attention(
            q, k, v, causal=causal, q_offset=q_off, kv_offset=kv_off,
            block_q=block, block_k=block, interpret=True)
        return jnp.sum(out ** 2), (out, None)

    (_, (out, lse)), grads = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(*_jax(q, k, v))
    return (np.asarray(out), None if lse is None else np.asarray(lse),
            [np.asarray(g) for g in grads])


def case_forward_and_backward_against_the_kernel(causal):
    q, k, v = _qkv(seed=0)
    out, _, grads = _port_value_and_grads(q, k, v, causal)
    want_out, _, want_grads = _ref_value_and_grads(q, k, v, causal)
    np.testing.assert_allclose(out, want_out, **F32)
    for name, g, w in zip("qkv", grads, want_grads):
        np.testing.assert_allclose(g, w, err_msg=f"d{name}", **GRAD)


def case_head_dim_128_backward_against_the_kernel():
    """Head dim 128, the width K4' takes on the card in its one-warpgroup
    layout: the port's forward and all three gradients (on the CPU the
    plain versions the card's kernels are held to) against the
    interpret-mode kernels at B1 T128 H2 D128 with 64-row blocks, causal
    and at offsets (64, 32), with the lse cotangent live. Tolerances as
    at D 16: out and lse 2e-5, gradients 5e-5."""
    r = np.random.RandomState(15)
    q, k, v = (r.randn(1, 128, 2, 128).astype(np.float32) for _ in range(3))
    w = r.randn(1, 2, 128).astype(np.float32)
    for q_off, kv_off in ((0, 0), (64, 32)):
        got = _port_value_and_grads(q, k, v, True, q_off, kv_off,
                                    with_lse=True, w_lse=w)
        want = _ref_value_and_grads(q, k, v, True, q_off, kv_off,
                                    with_lse=True, w_lse=w, block=64)
        np.testing.assert_allclose(got[0], want[0], **F32)
        np.testing.assert_allclose(got[1], want[1], **F32)
        for name, g, wg in zip("qkv", got[2], want[2]):
            np.testing.assert_allclose(g, wg, err_msg=f"d{name}", **GRAD)


def case_offsets_position_the_causal_mask():
    """(16, 0) masks inside blocks; (32, 0) and (64, 32) put the whole kv
    block before the q block. The first runs against the interpret-mode
    kernel with its gradients; the materialized reference proves the
    others (no row is fully masked, so the two reference paths agree)."""
    q, k, v = _qkv(t_q=32, t_k=32, seed=1)
    out, _, grads = _port_value_and_grads(q, k, v, True, 16, 0)
    want_out, _, want_grads = _ref_value_and_grads(q, k, v, True, 16, 0)
    np.testing.assert_allclose(out, want_out, **F32)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g, w, **GRAD)
    for q_off, kv_off in [(32, 0), (16, 0), (64, 32)]:
        want = jatt.full_attention(*_jax(q, k, v), causal=True, q_offset=q_off,
                                   kv_offset=kv_off)
        got = tflash.flash_attention(*_torch(q, k, v), causal=True,
                                     q_offset=q_off, kv_offset=kv_off)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def case_fully_masked_block_is_zero_with_finite_zero_grads():
    """q entirely before every kv position (q_offset 0, kv_offset 1024):
    the kernel skips every block; out 0, lse ~NEG_BIG, gradients 0 and
    finite on both sides."""
    q, k, v = _qkv(t_q=16, t_k=16, seed=2)
    out, lse, grads = _port_value_and_grads(q, k, v, True, 0, 1024)
    want_out, _, want_grads = _ref_value_and_grads(q, k, v, True, 0, 1024)
    assert np.all(out == 0.0) and np.all(want_out == 0.0)
    assert np.all(lse <= -1e29)
    for g, w in zip(grads, want_grads):
        assert np.all(np.isfinite(g))
        np.testing.assert_allclose(g, 0.0, atol=1e-6)
        np.testing.assert_allclose(g, w, atol=1e-6)


def case_row_fully_masked_inside_a_live_tile_is_zero():
    """Port-only contract: T=16, q_offset 0, kv_offset 8, causal. Rows 0-7
    see no key although their tile is live; they return 0 with lse =
    NEG_BIG (the Pallas kernel with one 16-row block returns the mean of
    v there). Rows 8-15 match the materialized reference."""
    q, k, v = _qkv(t_q=16, t_k=16, seed=3)
    tq, tk, tv = _torch(q, k, v, grad=True)
    out, lse = tflash.flash_attention_lse(tq, tk, tv, causal=True,
                                          q_offset=0, kv_offset=8)
    assert torch.all(out[:, :8] == 0.0)
    assert torch.all(lse[:, :, :8] <= -1e29)
    want = jatt.full_attention(*_jax(q, k, v), causal=True, q_offset=0,
                               kv_offset=8)
    np.testing.assert_allclose(out[:, 8:].detach().numpy(),
                               np.asarray(want)[:, 8:], **F32)
    torch.sum(out ** 2).backward()
    assert torch.all(tq.grad[:, :8] == 0.0)
    for t in (tq, tk, tv):
        assert bool(torch.isfinite(t.grad).all())


def case_bfloat16_inputs():
    q, k, v = _qkv(seed=4)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = jflash.flash_attention(jq, jk, jv, causal=True, block_q=16,
                                  block_k=16, interpret=True)
    got = tflash.flash_attention(*_torch(q, k, v, dtype=torch.bfloat16),
                                 causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32),
                               atol=3e-2, rtol=3e-2)


def case_rectangular_not_causal():
    q, k, v = _qkv(t_q=32, t_k=96, seed=5)
    want = jflash.flash_attention(*_jax(q, k, v), causal=False, block_q=256,
                                  block_k=256, interpret=True)
    got = tflash.flash_attention(*_torch(q, k, v), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def case_lse_value_and_gradient():
    """lse, and gradients through it: the lse cotangent folds into delta."""
    q, k, v = _qkv(t_q=32, t_k=32, seed=6)
    w = np.random.RandomState(7).randn(B, H, 32).astype(np.float32)
    out, lse, grads = _port_value_and_grads(q, k, v, True, with_lse=True,
                                            w_lse=w)
    want_out, want_lse, want_grads = _ref_value_and_grads(
        q, k, v, True, with_lse=True, w_lse=w)
    np.testing.assert_allclose(out, want_out, **F32)
    np.testing.assert_allclose(lse, want_lse, **F32)
    for g, wg in zip(grads, want_grads):
        np.testing.assert_allclose(g, wg, **GRAD)


def case_gate_takes_every_shape_the_kernels_take():
    """`can_flash` opens wherever the reference's does, and also where the
    reference finds no power-of-two block (T 24 in bf16, T 100): the
    kernels mask their tails. There `full_attention` takes flash and
    matches the reference's materialized body (no row is fully masked).
    Where the kernels cannot run (D 257, float16, B * H past the grid,
    EDL_FLASH=0) the CPU takes the materialized body and any other device
    raises."""
    shapes = (((B, 64, H, D), (B, 64, H, D)), ((B, 24, H, D), (B, 24, H, D)),
              ((B, 100, H, D), (B, 64, H, D)), ((B, 32, H, D), (B, 96, H, D)))
    with pytest.MonkeyPatch.context() as mp, jflash.interpret_mode():
        # the reference's gate opens on the CPU only in interpret mode
        # with EDL_FLASH=1; the port's needs neither
        mp.setenv("EDL_FLASH", "1")
        for shape_q, shape_k in shapes:
            for dtype in (torch.float32, torch.bfloat16, None):
                assert tflash.can_flash(shape_q, shape_k, dtype=dtype)
        assert jflash.can_flash(*shapes[0], dtype=jnp.bfloat16)
        assert not jflash.can_flash(*shapes[1], dtype=jnp.bfloat16)
        assert not jflash.can_flash(*shapes[2])
        mp.setenv("EDL_FLASH", "0")
        assert not tflash.can_flash((B, T, H, D), (B, T, H, D))
        assert not jflash.can_flash((B, T, H, D), (B, T, H, D))
    assert not tflash.can_flash((B, T, H, 257), (B, T, H, 257))
    assert not tflash.can_flash((B, T, H, D), (B, T, H, D),
                                dtype=torch.float16)
    assert not tflash.can_flash((65536, T, 1, D), (65536, T, 1, D))

    q, k, v = _qkv(t_q=100, t_k=64, seed=9)
    want = np.asarray(jatt.full_attention(*_jax(q, k, v), causal=True))
    before = dict(tflash.launches)
    for got in (tflash.flash_attention(*_torch(q, k, v)),
                tatt.full_attention(*_torch(q, k, v))):
        np.testing.assert_allclose(got.numpy(), want, **F32)
    assert tflash.launches == before      # the CPU ran the plain version

    r = np.random.RandomState(10)
    wide = [r.randn(1, 8, 1, 257).astype(np.float32) for _ in range(3)]
    np.testing.assert_allclose(
        tatt.full_attention(*_torch(*wide)).numpy(),
        np.asarray(jatt.full_attention(*_jax(*wide))), **F32)
    meta = [t.to("meta") for t in _torch(*wide)]
    with pytest.raises(ValueError, match="no attention kernel"):
        tatt.full_attention(*meta)


def case_wrappers_reject_what_no_version_takes():
    before = dict(tflash.launches)
    q, k, v = _torch(*_qkv(), dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tflash.flash_fwd(q, k, v)
    q, k, v = _torch(*_qkv())
    with pytest.raises(TypeError, match="share a dtype"):
        tflash.flash_fwd(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tflash.flash_fwd(*(t.to("meta") for t in (q, k, v)))
    with pytest.raises(ValueError, match="differ"):
        tflash.flash_fwd(q, k[:, :, :1], v[:, :, :1])
    tflash.flash_fwd(q, k, v)       # the CPU's plain version: no launch
    assert tflash.launches == before


def case_materialized_path_matches_the_reference(dtype):
    """EDL_FLASH=0 on both sides: the materialized body, which rounds p to
    v's dtype before the PV product (so bf16 is held to 3e-2)."""
    q, k, v = _qkv(seed=8)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("EDL_FLASH", "0")
        want = jatt.full_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                   causal=True, q_offset=16, kv_offset=0)
        got = tatt.full_attention(*_torch(q, k, v, dtype=tdt), causal=True,
                                  q_offset=16, kv_offset=0)
        # with no mesh, a named seq axis falls back to full attention, as
        # the reference's does where the mesh lacks the axis
        assert torch.equal(
            tatt.sequence_parallel_attention(*_torch(q, k, v),
                                             axis_name="seq"),
            tatt.full_attention(*_torch(q, k, v), causal=True))
    tol = F32 if dtype == "float32" else dict(atol=3e-2, rtol=3e-2)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), **tol)


def case_hopper_route_by_dtype_and_head_dim():
    """`route` decides the kernels before any launch, by dtype and D
    alone: K2', K3' and K4' take bfloat16 at D 16, 32, 64 and 128, with
    the delta pass that K3' and K4' read in the backward's launches;
    K2-tf32, K3-tf32 and K4-tf32 take float32 at D 16, 32 and 64, with
    the delta pass too; everything else (float32 at D 128 among them)
    goes to the CUDA-core kernels K2, K3 and K4."""
    for dtype in (torch.bfloat16, torch.float32):
        for d in (8, 16, 24, 32, 48, 64, 100, 128, 256):
            bf16 = dtype == torch.bfloat16
            hopper = bf16 and d in (16, 32, 64, 128)
            tf32 = not bf16 and d in (16, 32, 64)
            want = ((tflash.FWD_SM90, (tflash.BWD_DQ_SM90,
                                       tflash.BWD_DKV_SM90,
                                       tflash.BWD_DELTA_SM90)) if hopper else
                    (tflash.FWD_TF32, (tflash.BWD_DQ_TF32,
                                       tflash.BWD_DKV_TF32,
                                       tflash.BWD_DELTA_SM90)) if tf32 else
                    (tflash.FWD, (tflash.BWD_DQ, tflash.BWD_DKV)))
            assert tflash.route(dtype, d) == want, (dtype, d)
    for d in (16, 32, 64):
        assert tflash.route(torch.float32, d)[1][:2] == (
            tflash.BWD_DQ_TF32, tflash.BWD_DKV_TF32)
    assert tflash.route(torch.float32, 128) == (
        tflash.FWD, (tflash.BWD_DQ, tflash.BWD_DKV))
    # every kernel the route names is a launcher of one of the libraries
    named = {n for dt in (torch.bfloat16, torch.float32)
             for d in (16, 32, 64, 128, 256)
             for n in (tflash.route(dt, d)[0], *tflash.route(dt, d)[1])}
    assert named == set(tflash.launches) == {
        n for names in tflash._KERNELS.values() for n in names}


def case_whole_backward_is_the_single_wrappers():
    """`flash_bwd`, the autograd backward, gives on the CPU what
    `flash_bwd_dq` and `flash_bwd_dkv` give, launching nothing."""
    q, k, v = _torch(*_qkv(seed=12))
    do = _torch(np.random.RandomState(13).randn(B, T, H, D)
                .astype(np.float32))[0]
    g_lse = torch.from_numpy(np.random.RandomState(14).randn(B, H, T)
                             .astype(np.float32))
    before = dict(tflash.launches)
    out, lse = tflash.flash_fwd(q, k, v, True, 16, 0)
    args = (q, k, v, out, do, lse, g_lse, True, 16, 0)
    dq, dk, dv = tflash.flash_bwd(*args)
    assert torch.equal(dq, tflash.flash_bwd_dq(*args))
    want_dk, want_dv = tflash.flash_bwd_dkv(*args)
    assert torch.equal(dk, want_dk) and torch.equal(dv, want_dv)
    assert tflash.launches == before


def case_hi_lo_split_keeps_float32_p():
    """The hi + lo split of K2', K3' and K4' in plain torch, at the LM's
    tile (64 q rows, 64 kv rows, D 64, bf16 inputs): p and ds from
    `flash_fwd_plain`'s own inputs and lse, split into hi = bf16(x) and
    lo = bf16(x - hi), each product formed in float32 (exact for bf16
    operands, as on wgmma). P.V, P^T.dO, dS^T.Q and dS.K from the split stay
    within 1e-2 of the one-ulp bf16 bound (rtol 2**-7, atol 1e-2 of the
    rms) of the unsplit float32 product. One bf16 rounding of p or ds, for
    contrast, spends far more of that bound."""
    r = np.random.RandomState(11)
    q, k, v, do = (torch.from_numpy(r.randn(1, 64, 1, 64).astype(np.float32))
                   .to(torch.bfloat16) for _ in range(4))
    out, lse = tflash.flash_fwd_plain(q, k, v, causal=True)
    p, ds = tflash._p_and_ds(q, k, v, out, do, lse, None, True, 0, 0)
    p, ds = p[0, 0], ds[0, 0]
    q32, k32, v32, do32 = (t[0, :, 0].to(torch.float32)
                           for t in (q, k, v, do))

    def share_of_bound(got, want):
        tol = 2 ** -7 * want.abs() + 1e-2 * want.square().mean().sqrt()
        return float(((got - want).abs() / tol).max())

    for name, x, b in (("p.v", p, v32), ("p^T.do", p.T, do32),
                       ("ds^T.q", ds.T, q32), ("ds.k", ds, k32)):
        want = x @ b
        hi = x.to(torch.bfloat16).to(torch.float32)
        lo = (x - hi).to(torch.bfloat16).to(torch.float32)
        split = share_of_bound(hi @ b + lo @ b, want)
        single = share_of_bound(hi @ b, want)
        assert split <= 1e-2, (name, split)
        assert single > 10 * split and single > 1e-2, (name, single, split)


def _tf32(x):
    """`cvt.rna.tf32.f32` in plain torch, as K2-tf32 applies it: the
    float32 mantissa rounded to 10 bits, to nearest with ties away from
    zero (a carry into the exponent is the rounding's own), the low 13
    bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def case_tf32_split_keeps_float32_products():
    """K2-tf32's split in plain torch, at its tile (64 q rows, 64 kv rows,
    D 64, float32 inputs): every operand of Q.K^T and P.V (p from
    `flash_fwd_plain`'s own lse) split into hi = tf32(x) and lo =
    tf32(x - hi), and the product summed as lo.hi + hi.lo + hi.hi, each
    term exact in float32 (11-bit significands). Both products stay
    within 5% of the 2e-5 bound chip_smoke.py holds out and lse to
    (rtol 2e-5, atol 2e-5 of the largest entry) of the float64 product;
    one TF32 product, for contrast, does not hold the bound."""
    r = np.random.RandomState(16)
    q, k, v = (torch.from_numpy(r.randn(1, 64, 1, 64).astype(np.float32))
               for _ in range(3))
    _, lse = tflash.flash_fwd_plain(q, k, v, causal=True)
    p = tflash._p_and_ds(q, k, v, q, q, lse, None, True, 0, 0)[0][0, 0]
    q32, k32, v32 = (t[0, :, 0] for t in (q, k, v))

    def share_of_bound(got, want):
        tol = 2e-5 * want.abs() + 2e-5 * want.abs().max()
        return float(((got.double() - want).abs() / tol).max())

    shares = {}
    for name, a, b in (("q.k^T", q32, k32.T), ("p.v", p, v32)):
        want = a.double() @ b.double()
        a_hi, b_hi = _tf32(a), _tf32(b)
        a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
        assert torch.equal(a_hi + (a - a_hi), a)     # x - hi is exact
        split = share_of_bound(a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi, want)
        single = share_of_bound(_tf32(a) @ _tf32(b), want)
        shares[name] = (split, single)
        assert split <= 0.05, (name, split)
        assert single > 1.0, (name, single)
    return shares


def case_tf32_split_keeps_float32_backward():
    """K4-tf32's and K3-tf32's products in plain torch, at their block (64
    kv rows over two 32-row q tiles for dK and dV, 64 q rows over two
    32-row kv tiles for dQ; D 64, causal, float32 inputs): S = Q.K^T,
    dP = dO.V^T, dV = P^T.dO, dK = dS^T.Q and dQ = dS.K, each operand
    split into tf32 hi and lo and each product summed as lo.hi + hi.lo +
    hi.hi, p = exp(s - lse) and ds = p (dp - delta) in float32 between
    them, as the kernels form them. dK, dV and dQ stay within 5% of the
    5e-5 bound chip_smoke.py holds the kernels' gradients to (rtol 5e-5,
    atol 5e-5 of the largest entry) of the same chain in float64; with
    one TF32 product in place of each split one they do not hold it."""
    r = np.random.RandomState(18)
    q, k, v, do = (torch.from_numpy(r.randn(1, 64, 1, 64).astype(np.float32))
                   for _ in range(4))
    out, lse = tflash.flash_fwd_plain(q, k, v, causal=True)
    delta = tflash.flash_bwd_delta_plain(out, do)[0, 0]
    lse = lse[0, 0]
    q, k, v, do = (t[0, :, 0] for t in (q, k, v, do))
    mask = torch.ones(64, 64).tril().bool()
    scale = 64 ** -0.5

    def split(a, b):
        a_hi, b_hi = _tf32(a), _tf32(b)
        a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
        return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi

    def single(a, b):
        return _tf32(a) @ _tf32(b)

    def grads(mm, dt):
        qq, kk, vv, dd = (t.to(dt) for t in (q, k, v, do))
        s = mm(qq, kk.T) * scale
        p = torch.exp(s - lse.to(dt)[:, None]).masked_fill(~mask, 0.0)
        ds = p * (mm(dd, vv.T) - delta.to(dt)[:, None])
        return {"dv": mm(p.T, dd), "dk": mm(ds.T, qq) * scale,
                "dq": mm(ds, kk) * scale}

    def share_of_bound(got, want):
        tol = 5e-5 * want.abs() + 5e-5 * want.abs().max()
        return float(((got.double() - want).abs() / tol).max())

    want = grads(lambda a, b: a @ b, torch.float64)
    shares = {}
    for name, got in grads(split, torch.float32).items():
        shares[name] = (share_of_bound(got, want[name]),
                        share_of_bound(grads(single, torch.float32)[name],
                                       want[name]))
        assert shares[name][0] <= 0.05, (name, shares[name])
        assert shares[name][1] > 1.0, (name, shares[name])
    return shares


def case_float32_forward_at_tf32_widths_against_the_kernel():
    """Float32 at D 32 and 64, widths K2-tf32 takes on the card: the port's
    forward (on the CPU the plain version K2-tf32 is held to there)
    against the interpret-mode kernel at B1 T128 H2 with 64-row blocks,
    causal at offsets (0, 0) and (64, 32), out and lse within 2e-5. (D 16
    is the other cases' width.)"""
    r = np.random.RandomState(17)
    for d in (32, 64):
        q, k, v = (r.randn(1, 128, 2, d).astype(np.float32)
                   for _ in range(3))
        for q_off, kv_off in ((0, 0), (64, 32)):
            out, lse = tflash.flash_attention_lse(
                *_torch(q, k, v), causal=True, q_offset=q_off,
                kv_offset=kv_off)
            want_out, want_lse = jflash.flash_attention_lse(
                *_jax(q, k, v), causal=True, q_offset=q_off,
                kv_offset=kv_off, block_q=64, block_k=64, interpret=True)
            np.testing.assert_allclose(out.detach().numpy(),
                                       np.asarray(want_out), **F32)
            np.testing.assert_allclose(lse.detach().numpy(),
                                       np.asarray(want_lse), **F32)


def test_flash_attention_against_the_reference():
    """Every case above, in one collected test (ROADMAP.md, conventions:
    one collected test per port test file)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("EDL_FLASH", raising=False)
        for causal in (True, False):
            case_forward_and_backward_against_the_kernel(causal)
        case_head_dim_128_backward_against_the_kernel()
        case_offsets_position_the_causal_mask()
        case_fully_masked_block_is_zero_with_finite_zero_grads()
        case_row_fully_masked_inside_a_live_tile_is_zero()
        case_bfloat16_inputs()
        case_rectangular_not_causal()
        case_lse_value_and_gradient()
        case_gate_takes_every_shape_the_kernels_take()
        case_wrappers_reject_what_no_version_takes()
        for dtype in ("float32", "bfloat16"):
            case_materialized_path_matches_the_reference(dtype)
        case_hopper_route_by_dtype_and_head_dim()
        case_whole_backward_is_the_single_wrappers()
        case_hi_lo_split_keeps_float32_p()
        case_tf32_split_keeps_float32_products()
        case_tf32_split_keeps_float32_backward()
        case_float32_forward_at_tf32_widths_against_the_kernel()
