"""Flash attention: kernels K2-K4's wrappers, their plain versions, and the
autograd Function that joins them.

Counterpart of `elasticdl_tpu/ops/pallas_attention.py`:
- K2 `flash_fwd` replaces `_fwd_kernel` (launched by `_flash_fwd`): out and
  lse (B, H, Tq) float32 from q, k, v in (B, T, H, D);
- K3 `flash_bwd_dq` replaces `_bwd_dq_kernel`: dQ;
- K4 `flash_bwd_dkv` replaces `_bwd_dkv_kernel`: dK and dV.
All three are CUDA C++ in `csrc/flash_attention.cu` (see the notes there).

The contract, shared by kernel and plain version:
- scores s = (q . k) * D**-0.5 in float32, with the causal mask taken in
  GLOBAL positions: kv_offset + j <= q_offset + i;
- out = softmax(s) . v with p kept in float32 and v cast to float32, out
  rounded to q's dtype once; lse = m + log(max(l, 1e-30));
- a masked score gives p = 0. A fully masked row returns 0 with lse ~
  NEG_BIG, whatever the tiling (the Pallas kernel returns the mean of v
  for such a row when it lies in a live block of its tiling);
- the backward recomputes p = exp(s - lse) and folds the lse cotangent
  into delta = rowsum(dO . O) - g_lse; dq, dk, dv, dp are float32 and
  rounded to the inputs' dtype once.

Each wrapper runs its plain version for a tensor on the CPU, launches its
kernel for a CUDA tensor (or raises), and raises for any other device.
`launches` counts kernel launches by kernel name, not plain-version calls.

The reference transposes to (B, H, T, D) and lane-broadcasts lse to 128
only because Mosaic tiles need it; neither is ported, and neither is its
interpret-mode machinery: on the CPU the plain version runs, on the card
the kernel.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from elasticdl_tpu_torch.ops import native

NEG_BIG = -1e30  # finite "-inf", matches ops.attention
LIBRARY = "flash_attention"
FWD, BWD_DQ, BWD_DKV = "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"
launches = {FWD: 0, BWD_DQ: 0, BWD_DKV: 0}

MAX_HEAD_DIM = 256
MAX_GRID_Y = 65535              # B * H rides on the grid's y dimension
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def can_flash(q_shape, k_shape, q_offset=0, kv_offset=0, dtype=None) -> bool:
    """True when the kernels take these shapes and dtype (None -> float32):
    Tq, Tk >= 1, D <= MAX_HEAD_DIM, B * H <= MAX_GRID_Y, float32 or
    bfloat16; any Tq and Tk otherwise, since the kernels mask their tails.
    EDL_FLASH=0 closes it, and `ops.attention.full_attention` then takes
    its materialized body on the CPU and raises on the card. The offsets
    are accepted for the reference's signature and do not matter."""
    del q_offset, kv_offset
    if os.environ.get("EDL_FLASH", "") == "0":
        return False
    if dtype is not None and dtype not in _DTYPES:
        return False
    b, tq, h, d = q_shape
    return (tq >= 1 and k_shape[1] >= 1 and d <= MAX_HEAD_DIM
            and b * h <= MAX_GRID_Y)


# ------------------------------------------------------------ plain versions


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(B, H, Tq, Tk) float32 scores. Products of float32 or bfloat16
    values summed in float32, as the kernels (and the Pallas kernel's
    preferred_element_type=float32) compute them."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     k.to(torch.float32))
    return s * (q.shape[-1] ** -0.5)


def _mask(q: torch.Tensor, k: torch.Tensor, causal: bool, q_offset: int,
          kv_offset: int) -> Optional[torch.Tensor]:
    """(Tq, Tk) bool, True where kv position <= q position; None when not
    causal."""
    if not causal:
        return None
    q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
    kv_pos = kv_offset + torch.arange(k.shape[1], device=q.device)
    return kv_pos[None, :] <= q_pos[:, None]


def flash_fwd_plain(q, k, v, causal=True, q_offset=0, kv_offset=0):
    """K2's function in PyTorch ops: (out in q's dtype, lse (B, H, Tq)
    float32)."""
    s = _scores(q, k)
    mask = _mask(q, k, causal, q_offset, kv_offset)
    if mask is not None:
        s = s.masked_fill(~mask, NEG_BIG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bhqd", p, v.to(torch.float32)) / l
    lse = (m + torch.log(l)).squeeze(-1)
    return out.transpose(1, 2).to(q.dtype), lse


def _p_and_ds(q, k, v, out, dout, lse, g_lse, causal, q_offset, kv_offset):
    """p = exp(s - lse) masked to 0, and ds = p * (dp - delta) with
    delta = rowsum(dO . O) - g_lse; both (B, H, Tq, Tk) float32."""
    p = torch.exp(_scores(q, k) - lse[..., None])
    mask = _mask(q, k, causal, q_offset, kv_offset)
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    dout32 = dout.to(torch.float32)
    delta = (dout32 * out.to(torch.float32)).sum(-1).transpose(1, 2)
    if g_lse is not None:
        delta = delta - g_lse
    dp = torch.einsum("bqhd,bkhd->bhqk", dout32, v.to(torch.float32))
    return p, p * (dp - delta[..., None])


def flash_bwd_dq_plain(q, k, v, out, dout, lse, g_lse=None, causal=True,
                       q_offset=0, kv_offset=0):
    """K3's function: dQ in q's dtype."""
    _, ds = _p_and_ds(q, k, v, out, dout, lse, g_lse, causal, q_offset,
                      kv_offset)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.to(torch.float32))
    return (dq * (q.shape[-1] ** -0.5)).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, out, dout, lse, g_lse=None, causal=True,
                        q_offset=0, kv_offset=0):
    """K4's function: (dK, dV) in k's and v's dtypes."""
    p, ds = _p_and_ds(q, k, v, out, dout, lse, g_lse, causal, q_offset,
                      kv_offset)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout.to(torch.float32))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.to(torch.float32))
    return (dk * (q.shape[-1] ** -0.5)).to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------ wrappers


def _validate(q, k, v, *more) -> None:
    for t in (q, k, v) + more:
        if t.dtype != q.dtype:
            raise TypeError(f"q, k, v, out and dout must share a dtype, got "
                            f"{q.dtype} and {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"tensors on {q.device} and {t.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"want q (B, Tq, H, D) and k, v (B, Tk, H, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, tq, h, d = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d):
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in B, H or D")
    if not (tq >= 1 and k.shape[1] >= 1 and 1 <= d <= MAX_HEAD_DIM):
        raise ValueError(f"need Tq, Tk >= 1 and 1 <= D <= {MAX_HEAD_DIM}, "
                         f"got q {tuple(q.shape)}, k {tuple(k.shape)}")


def _on_card(x: torch.Tensor) -> bool:
    """False for a CPU tensor (plain version), True for a CUDA tensor
    (kernel); raises for any other device."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return True


def _strides(*tensors) -> ctypes.Array:
    """(b, t, h) element strides of each (B, T, H, D) tensor, whose D
    stride must be 1."""
    vals = []
    for t in tensors:
        if t.stride(3) != 1 and t.shape[3] > 1:
            raise ValueError(f"the head dim must be contiguous, got strides "
                             f"{t.stride()}")
        vals += [t.stride(0), t.stride(1), t.stride(2)]
    return (ctypes.c_longlong * len(vals))(*vals)


def _launch(name: str, q: torch.Tensor, *args) -> None:
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = getattr(lib, name)(_DTYPES[q.dtype], *args, stream)
    native.check(lib, code, name)
    launches[name] += 1


def _dims(q, k, causal, q_offset, kv_offset):
    b, tq, h, d = q.shape
    if b * h > MAX_GRID_Y:
        raise ValueError(f"B*H = {b * h} exceeds the kernels' grid")
    return (b, h, tq, k.shape[1], d, int(q_offset), int(kv_offset),
            int(bool(causal)))


def flash_fwd(q, k, v, causal=True, q_offset=0, kv_offset=0):
    """K2: (out in q's dtype, lse (B, H, Tq) float32)."""
    _validate(q, k, v)
    if not _on_card(q):
        return flash_fwd_plain(q, k, v, causal, q_offset, kv_offset)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    b, tq, h, _ = q.shape
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    _launch(FWD, q, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), _strides(q, k, v, out),
            *_dims(q, k, causal, q_offset, kv_offset))
    return out, lse


def _check_residuals(q, lse, g_lse):
    want = (q.shape[0], q.shape[2], q.shape[1])
    for name, t in (("lse", lse), ("g_lse", g_lse)):
        if t is None:
            continue
        if (t.dtype != torch.float32 or tuple(t.shape) != want
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{name} must be contiguous float32 {want} on "
                             f"{q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def flash_bwd_dq(q, k, v, out, dout, lse, g_lse=None, causal=True,
                 q_offset=0, kv_offset=0):
    """K3: dQ in q's dtype. g_lse (B, H, Tq) float32 or None (zero)."""
    _validate(q, k, v, out, dout)
    _check_residuals(q, lse, g_lse)
    if not _on_card(q):
        return flash_bwd_dq_plain(q, k, v, out, dout, lse, g_lse, causal,
                                  q_offset, kv_offset)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    _launch(BWD_DQ, q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            None if g_lse is None else g_lse.data_ptr(), dq.data_ptr(),
            _strides(q, k, v, out, dout, dq),
            *_dims(q, k, causal, q_offset, kv_offset))
    return dq


def flash_bwd_dkv(q, k, v, out, dout, lse, g_lse=None, causal=True,
                  q_offset=0, kv_offset=0):
    """K4: (dK, dV) in k's and v's dtypes."""
    _validate(q, k, v, out, dout)
    _check_residuals(q, lse, g_lse)
    if not _on_card(q):
        return flash_bwd_dkv_plain(q, k, v, out, dout, lse, g_lse, causal,
                                   q_offset, kv_offset)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    _launch(BWD_DKV, q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            None if g_lse is None else g_lse.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), _strides(q, k, v, out, dout, dk, dv),
            *_dims(q, k, causal, q_offset, kv_offset))
    return dk, dv


def _library() -> ctypes.CDLL:
    lib = native.load(LIBRARY)
    if lib.flash_fwd.argtypes is None:
        # c_void_p for every pointer and the stream: without argtypes
        # ctypes passes Python ints as 32-bit C ints and cuts pointers
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        tail = [i32] * 8 + [ptr]     # B H Tq Tk D q_off kv_off causal, stream
        strides = ctypes.POINTER(ctypes.c_longlong)
        for name, n_ptrs in ((FWD, 5), (BWD_DQ, 8), (BWD_DKV, 9)):
            fn = getattr(lib, name)
            fn.argtypes = [i32] + [ptr] * n_ptrs + [strides] + tail
            fn.restype = ctypes.c_int
    return lib


# ------------------------------------------------------------ public


class _FlashAttention(torch.autograd.Function):
    """(out, lse) with K2 forward and K3 + K4 backward. An unused lse
    (the out-only `flash_attention`) reaches the backward as None, which
    the kernels read as g_lse = 0."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, kv_offset):
        out, lse = flash_fwd(q, k, v, causal, q_offset, kv_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, q_offset, kv_offset)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        g_out = (torch.zeros_like(out) if g_out is None
                 else g_out.contiguous())
        if g_lse is not None:
            g_lse = g_lse.to(torch.float32).contiguous()
        dq = flash_bwd_dq(q, k, v, out, g_out, lse, g_lse, *ctx.args)
        dk, dv = flash_bwd_dkv(q, k, v, out, g_out, lse, g_lse, *ctx.args)
        return dq, dk, dv, None, None, None


def flash_attention_lse(q, k, v, causal: bool = True, q_offset: int = 0,
                        kv_offset: int = 0):
    """Flash attention over (B, T, H, D) q/k/v returning (out, lse), lse
    (B, H, Tq) float32; gradients flow through both. The kernels choose
    their own tiles, so the reference's block_q/block_k have no
    counterpart here."""
    return _FlashAttention.apply(q, k, v, bool(causal), int(q_offset),
                                 int(kv_offset))


def flash_attention(q, k, v, causal: bool = True, q_offset: int = 0,
                    kv_offset: int = 0):
    """Same contract as `ops.attention.full_attention` (out only; the
    backward gets no lse cotangent)."""
    return flash_attention_lse(q, k, v, causal, q_offset, kv_offset)[0]
