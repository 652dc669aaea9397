"""The port's flash attention at head dims 16 and 32, the widths K2', K3'
and K4' take on the card since they run on Hopper's tensor cores, against
the reference's Pallas kernels run in interpret mode on the CPU.

On the CPU the port's wrappers run their plain versions: the functions the
card's K2', K3' and K4' are held to. Each case takes the forward, the lse
and all three gradients of one loss, sum(out^2) + sum(sin(lse) * w), so
the lse cotangent is live and folds into delta:
- float32: out and lse 2e-5, gradients 5e-5, the reference's own
  tolerances for its kernel against its naive path (the two sum in
  different orders);
- bfloat16: out and gradients 3e-2, the tolerance of
  `test_torch_flash_attention.py`'s `case_bfloat16_inputs` (the reference
  rounds p to bf16 before its products, the port keeps it float32; one
  bf16 rounding of each output); lse 2e-5, as both form it in float32
  from the same bf16 products.
Causal at offsets (64, 32), which mask inside the blocks and put whole kv
blocks before the q block. The non-causal tail (Tq 100, Tk 230) has no
power-of-two block, so the reference's kernel refuses it
(`pallas_attention.pick_block`); there the reference's materialized
attention (`ops/attention.full_attention`) and a logsumexp of its scores
stand in, at the same tolerances. Inputs come from a numpy seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.ops import attention as jatt
from elasticdl_tpu.ops import pallas_attention as jflash
from elasticdl_tpu_torch.ops import flash_attention as tflash

B, H = 2, 2
F32 = (dict(atol=2e-5, rtol=2e-5), dict(atol=5e-5, rtol=5e-5))
BF16 = (dict(atol=3e-2, rtol=3e-2), dict(atol=3e-2, rtol=3e-2))
DTYPES = {"float32": (jnp.float32, torch.float32, F32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16)}


def _inputs(d, tq, tk, seed):
    r = np.random.RandomState(seed)
    q = r.randn(B, tq, H, d).astype(np.float32)
    k, v = (r.randn(B, tk, H, d).astype(np.float32) for _ in range(2))
    return q, k, v, r.randn(B, H, tq).astype(np.float32)


def _port(q, k, v, w, dtype, causal, q_off, kv_off):
    """The port: out, lse and the loss's gradients as float32 numpy."""
    tq, tk, tv = (torch.from_numpy(a).to(dtype).requires_grad_(True)
                  for a in (q, k, v))
    out, lse = tflash.flash_attention_lse(tq, tk, tv, causal=causal,
                                          q_offset=q_off, kv_offset=kv_off)
    assert out.dtype == dtype and lse.dtype == torch.float32
    loss = (torch.sum(out.float() ** 2)
            + torch.sum(torch.sin(lse) * torch.from_numpy(w)))
    loss.backward()
    return [t.detach().float().numpy()
            for t in (out, lse, tq.grad, tk.grad, tv.grad)]


def _kernel_loss(causal, q_off, kv_off, w, block):
    """The reference's interpret-mode kernels under the same loss."""
    def loss(q, k, v):
        out, lse = jflash.flash_attention_lse(
            q, k, v, causal=causal, q_offset=q_off, kv_offset=kv_off,
            block_q=block, block_k=block, interpret=True)
        value = (jnp.sum(out.astype(jnp.float32) ** 2)
                 + jnp.sum(jnp.sin(lse) * w))
        return value, (out, lse)
    return loss


def _materialized_loss(causal, q_off, kv_off, w):
    """The reference's materialized attention, with the lse of its scores,
    for shapes its kernel cannot block."""
    def loss(q, k, v):
        out = jatt.full_attention(q, k, v, causal=causal, q_offset=q_off,
                                  kv_offset=kv_off)
        s = jnp.einsum("bqhd,bkhd->bhqk", q.astype(jnp.float32),
                       k.astype(jnp.float32)) * q.shape[-1] ** -0.5
        if causal:
            q_pos = q_off + jnp.arange(q.shape[1])
            kv_pos = kv_off + jnp.arange(k.shape[1])
            s = jnp.where(kv_pos[None, :] <= q_pos[:, None], s, -1e30)
        lse = jax.nn.logsumexp(s, axis=-1)
        value = (jnp.sum(out.astype(jnp.float32) ** 2)
                 + jnp.sum(jnp.sin(lse) * w))
        return value, (out, lse)
    return loss


def _reference(loss, q, k, v, jdt):
    (_, (out, lse)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
            *(jnp.asarray(a, jdt) for a in (q, k, v)))
    return [np.asarray(x, np.float32) for x in (out, lse, *grads)]


def case_against_the_reference(d, dtype, tq, tk, causal, q_off, kv_off,
                               seed, block=None):
    """One geometry: the kernels with `block` rows, else the materialized
    reference."""
    jdt, tdt, (out_tol, grad_tol) = DTYPES[dtype]
    q, k, v, w = _inputs(d, tq, tk, seed)
    got = _port(q, k, v, w, tdt, causal, q_off, kv_off)
    loss = (_kernel_loss(causal, q_off, kv_off, w, block) if block
            else _materialized_loss(causal, q_off, kv_off, w))
    want = _reference(loss, q, k, v, jdt)
    where = f"D {d} {dtype} Tq {tq} Tk {tk} offsets ({q_off}, {kv_off})"
    np.testing.assert_allclose(got[0], want[0], err_msg=f"out, {where}",
                               **out_tol)
    np.testing.assert_allclose(got[1], want[1], err_msg=f"lse, {where}",
                               **F32[0])
    for name, g, wg in zip(("dq", "dk", "dv"), got[2:], want[2:]):
        assert np.all(np.isfinite(g)), (name, where)
        np.testing.assert_allclose(g, wg, err_msg=f"{name}, {where}",
                                   **grad_tol)


def case_narrow_widths_take_the_hopper_route():
    """On the card these inputs go to K2', K3' and K4' (one delta pass a
    backward, read by K3' and K4'), as D 64 and 128 do; float32 takes
    K2-tf32 forward and the CUDA-core K3 and K4 backward."""
    for d in (16, 32):
        assert tflash.route(torch.bfloat16, d) == (
            tflash.FWD_SM90, (tflash.BWD_DQ_SM90, tflash.BWD_DKV_SM90,
                              tflash.BWD_DELTA_SM90))
        assert tflash.route(torch.float32, d) == (
            tflash.FWD_TF32, (tflash.BWD_DQ, tflash.BWD_DKV))


def test_narrow_head_dims_against_the_reference():
    """Every case above, in one collected test (ROADMAP.md, conventions:
    one collected test per port test file). On the CPU nothing launches."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("EDL_FLASH", raising=False)
        case_narrow_widths_take_the_hopper_route()
        before = dict(tflash.launches)
        for seed, d in enumerate((16, 32)):
            for dtype in ("float32", "bfloat16"):
                case_against_the_reference(d, dtype, 64, 64, True, 64, 32,
                                           seed, block=32)
                case_against_the_reference(d, dtype, 100, 230, False, 0, 0,
                                           seed + 10)
        assert tflash.launches == before
