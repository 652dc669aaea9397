"""Flash attention: kernels K2-K4's wrappers, their plain versions, and the
autograd Function that joins them.

Counterpart of `elasticdl_tpu/ops/pallas_attention.py`:
- K2 `flash_fwd` replaces `_fwd_kernel` (launched by `_flash_fwd`): out and
  lse (B, H, Tq) float32 from q, k, v in (B, T, H, D);
- K3 `flash_bwd_dq` replaces `_bwd_dq_kernel`: dQ;
- K4 `flash_bwd_dkv` replaces `_bwd_dkv_kernel`: dK and dV.

Two CUDA C++ sources hold the kernels (see the notes in each):
- `csrc/flash_attention_sm90.cu`, on Hopper's tensor cores (`wgmma`, TMA):
  K2' `flash_fwd_sm90` for bfloat16 at D 64 and 128, K4'
  `flash_bwd_dkv_sm90` and the delta pass `flash_bwd_delta_sm90` that it
  reads for bfloat16 at D 64 (`_sm90`): the LM's attention;
- `csrc/flash_attention.cu`, float32 FMAs on the CUDA cores: K2 and K4 for
  every other input, and K3 for all.
The route is decided by dtype and D alone, before any launch; a failed
launch raises and is never retried on the other kernels.

The contract, shared by kernel and plain version:
- scores s = (q . k) * D**-0.5 in float32, with the causal mask taken in
  GLOBAL positions: kv_offset + j <= q_offset + i;
- out = softmax(s) . v with p kept in float32 and v cast to float32, out
  rounded to q's dtype once; lse = m + log(max(l, 1e-30)). On the
  tensor cores (K2', K4') the float32 p and ds are split into bf16
  hi + lo, each product exact in float32, so P.V, P^T.dO and dS^T.Q are
  the float32 products to ~2**-17 of p and ds, well under one bf16 ulp of
  the output; q.k and dO.v have bf16 operands on that route and are exact
  as they are;
- a masked score gives p = 0. A fully masked row returns 0 with lse ~
  NEG_BIG, whatever the tiling (the Pallas kernel returns the mean of v
  for such a row when it lies in a live block of its tiling);
- the backward recomputes p = exp(s - lse) and folds the lse cotangent
  into delta = rowsum(dO . O) - g_lse (K3 and K4 compute it themselves,
  K4' reads it from the delta pass); dq, dk, dv, dp are float32 and
  rounded to the inputs' dtype once.

Each wrapper runs its plain version for a tensor on the CPU, launches its
kernel for a CUDA tensor (or raises), and raises for any other device.
`launches` counts kernel launches by kernel name, not plain-version calls.
The split computes the same function, so K2' and K4' share K2's and K4's
plain versions.

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
LIBRARY, LIBRARY_SM90 = "flash_attention", "flash_attention_sm90"
FWD, BWD_DQ, BWD_DKV = "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"
FWD_SM90, BWD_DKV_SM90 = "flash_fwd_sm90", "flash_bwd_dkv_sm90"
BWD_DELTA_SM90 = "flash_bwd_delta_sm90"
launches = {FWD: 0, BWD_DQ: 0, BWD_DKV: 0, FWD_SM90: 0, BWD_DKV_SM90: 0,
            BWD_DELTA_SM90: 0}
_SM90_HEAD_DIMS = {FWD_SM90: (64, 128), BWD_DKV_SM90: (64,)}
_KERNELS = {LIBRARY: (FWD, BWD_DQ, BWD_DKV),
            LIBRARY_SM90: (FWD_SM90, BWD_DKV_SM90, BWD_DELTA_SM90)}
# pointer arguments of each launcher, then the int arguments before the
# stream: B H Tq Tk D q_off kv_off causal (the delta pass: B H Tq D)
_SIGNATURES = {FWD: (5, 8), BWD_DQ: (8, 8), BWD_DKV: (9, 8),
               FWD_SM90: (5, 8), BWD_DKV_SM90: (8, 8),
               BWD_DELTA_SM90: (4, 4)}

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


def flash_bwd_delta_plain(out, dout, g_lse=None):
    """The delta pass's function: rowsum(dO . O) - g_lse, (B, H, Tq)
    float32."""
    delta = (dout.to(torch.float32) * out.to(torch.float32)).sum(-1)
    delta = delta.transpose(1, 2)
    return delta if g_lse is None else delta - g_lse


def _p_and_ds(q, k, v, out, dout, lse, g_lse, causal, q_offset, kv_offset):
    """p = exp(s - lse) masked to 0, and ds = p * (dp - delta) with
    delta = rowsum(dO . O) - g_lse; both (B, H, Tq, Tk) float32."""
    p = torch.exp(_scores(q, k) - lse[..., None])
    mask = _mask(q, k, causal, q_offset, kv_offset)
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    delta = flash_bwd_delta_plain(out, dout, g_lse)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.to(torch.float32),
                      v.to(torch.float32))
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


def _sm90(dtype, d, kernel: str = FWD_SM90) -> bool:
    """True where the Hopper kernel `kernel` takes the inputs: bfloat16
    with head dim 64 or 128 for K2' (`FWD_SM90`), 64 for K4' and its
    delta pass (`BWD_DKV_SM90`): at 128 the dK and dV accumulators of K4'
    (2 x 64 floats a thread) would spill."""
    return dtype == torch.bfloat16 and d in _SM90_HEAD_DIMS[kernel]


def _check_tma(*tensors) -> None:
    """TMA reads a tensor through strides that are multiples of 16 bytes
    from a 16-byte-aligned address (a dim of extent 1 may carry any
    stride); raise for one it cannot take."""
    for t in tensors:
        odd = [s for s, n in zip(t.stride()[:3], t.shape[:3])
               if n > 1 and (s * t.element_size()) % 16]
        if odd or t.data_ptr() % 16:
            raise ValueError(
                f"the Hopper kernels read bfloat16 (B, T, H, D) tensors "
                f"through TMA, which needs (b, t, h) strides that are "
                f"multiples of 16 bytes and a 16-byte-aligned address; got "
                f"strides {t.stride()} at address {t.data_ptr():#x}")


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
    lib = _library(LIBRARY_SM90 if name in _KERNELS[LIBRARY_SM90]
                   else LIBRARY)
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
    """K2 (K2' for bfloat16 at D 64 or 128): (out in q's dtype, lse
    (B, H, Tq) float32)."""
    _validate(q, k, v)
    if not _on_card(q):
        return flash_fwd_plain(q, k, v, causal, q_offset, kv_offset)
    return launch_fwd(q, k, v, causal, q_offset, kv_offset,
                      _sm90(q.dtype, q.shape[3]))


def launch_fwd(q, k, v, causal, q_offset, kv_offset, hopper: bool):
    """Launch K2' (`hopper`) or K2 on validated CUDA tensors. `flash_fwd`
    routes by `_sm90`; a caller that times the two kernels side by side
    names one."""
    if hopper:
        _check_tma(q, k, v)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    b, tq, h, _ = q.shape
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    _launch(FWD_SM90 if hopper else FWD, q, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            _strides(q, k, v, out),
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
    """K4 (the delta pass, then K4', for bfloat16 at D 64 or 128): (dK,
    dV) in k's and v's dtypes."""
    _validate(q, k, v, out, dout)
    _check_residuals(q, lse, g_lse)
    if not _on_card(q):
        return flash_bwd_dkv_plain(q, k, v, out, dout, lse, g_lse, causal,
                                   q_offset, kv_offset)
    return launch_bwd_dkv(q, k, v, out, dout, lse, g_lse, causal, q_offset,
                          kv_offset, _sm90(q.dtype, q.shape[3], BWD_DKV_SM90))


def launch_bwd_dkv(q, k, v, out, dout, lse, g_lse, causal, q_offset,
                   kv_offset, hopper: bool):
    """Launch the delta pass and K4' (`hopper`), or K4, on validated CUDA
    tensors; see `launch_fwd`."""
    if not hopper:
        dk = torch.empty_like(k, memory_format=torch.contiguous_format)
        dv = torch.empty_like(v, memory_format=torch.contiguous_format)
        _launch(BWD_DKV, q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                None if g_lse is None else g_lse.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), _strides(q, k, v, out, dout, dk, dv),
                *_dims(q, k, causal, q_offset, kv_offset))
        return dk, dv
    _check_tma(q, k, v, dout)
    return launch_dkv_sm90(q, k, v, dout, lse, _launch_delta(out, dout, g_lse),
                           causal, q_offset, kv_offset)


def launch_dkv_sm90(q, k, v, dout, lse, delta, causal, q_offset, kv_offset):
    """Launch K4' alone on validated CUDA tensors, with `delta` from the
    delta pass."""
    _check_tma(q, k, v, dout)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    _launch(BWD_DKV_SM90, q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), _strides(q, k, v, dout, dk, dv),
            *_dims(q, k, causal, q_offset, kv_offset))
    return dk, dv


def _launch_delta(out, dout, g_lse):
    _check_tma(out, dout)
    b, tq, h, d = out.shape
    delta = torch.empty((b, h, tq), dtype=torch.float32, device=out.device)
    _launch(BWD_DELTA_SM90, out, out.data_ptr(), dout.data_ptr(),
            None if g_lse is None else g_lse.data_ptr(), delta.data_ptr(),
            _strides(out, dout), b, h, tq, d)
    return delta


def flash_bwd_delta(out, dout, g_lse=None):
    """The delta pass of K4': rowsum(dO . O) - g_lse, (B, H, Tq) float32.
    It serves K4' only, so a CUDA tensor K4' does not take raises."""
    _validate(out, dout, dout)
    _check_residuals(out, g_lse, None)
    if not _on_card(out):
        return flash_bwd_delta_plain(out, dout, g_lse)
    if not _sm90(out.dtype, out.shape[3], BWD_DKV_SM90):
        raise ValueError(f"the delta pass serves K4' only, which takes "
                         f"bfloat16 at D {_SM90_HEAD_DIMS[BWD_DKV_SM90]}; "
                         f"got {out.dtype} D {out.shape[3]}")
    return _launch_delta(out, dout, g_lse)


def _library(name: str) -> ctypes.CDLL:
    lib = native.load(name)
    if getattr(lib, _KERNELS[name][0]).argtypes is None:
        # c_void_p for every pointer and the stream: without argtypes
        # ctypes passes Python ints as 32-bit C ints and cuts pointers
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        strides = ctypes.POINTER(ctypes.c_longlong)
        for fn_name in _KERNELS[name]:
            n_ptrs, n_ints = _SIGNATURES[fn_name]
            fn = getattr(lib, fn_name)
            fn.argtypes = ([i32] + [ptr] * n_ptrs + [strides]
                           + [i32] * n_ints + [ptr])
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
