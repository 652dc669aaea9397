"""Flash attention: kernels K2-K4's wrappers, their plain versions, and the
autograd Function that joins them.

Counterpart of `elasticdl_tpu/ops/pallas_attention.py`:
- K2 `flash_fwd` replaces `_fwd_kernel` (launched by `_flash_fwd`): out and
  lse (B, H, Tq) float32 from q, k, v in (B, T, H, D);
- K3 `flash_bwd_dq` replaces `_bwd_dq_kernel`: dQ;
- K4 `flash_bwd_dkv` replaces `_bwd_dkv_kernel`: dK and dV.

Two CUDA C++ sources hold the kernels (see the notes in each):
- `csrc/flash_attention_sm90.cu`, on Hopper's tensor cores (`wgmma`, TMA):
  K2' `flash_fwd_sm90`, K3' `flash_bwd_dq_sm90` and K4'
  `flash_bwd_dkv_sm90` for bfloat16 at D 16, 32, 64 and 128: the bf16
  LM's attention; K2-tf32 `flash_fwd_tf32_sm90`, K3-tf32
  `flash_bwd_dq_tf32_sm90` and K4-tf32 `flash_bwd_dkv_tf32_sm90` for
  float32 at D 16, 32 and 64 in 3xTF32 products: the float32 LM's
  attention; and the delta pass `flash_bwd_delta_sm90` that K3', K4',
  K3-tf32 and K4-tf32 read;
- `csrc/flash_attention.cu`, float32 FMAs on the CUDA cores: K2, K3 and K4
  for every other input (float32 and bfloat16 at other head dims, float32
  at D 128).
The route (`route`) is decided by dtype and D alone, before any launch; a
failed launch raises and is never retried on the other kernels. The
autograd backward (`flash_bwd`) launches the delta pass once and hands it
to both tensor-core backward kernels.

The contract, shared by kernel and plain version:
- scores s = (q . k) * D**-0.5 in float32, with the causal mask taken in
  GLOBAL positions: kv_offset + j <= q_offset + i;
- out = softmax(s) . v with p kept in float32 and v cast to float32, out
  rounded to q's dtype once; lse = m + log(max(l, 1e-30)). On the
  tensor cores (K2', K3', K4') the float32 p and ds are split into bf16
  hi + lo, each product exact in float32, so P.V, P^T.dO, dS^T.Q and dS.K
  are the float32 products to ~2**-17 of p and ds, well under one bf16 ulp of
  the output; q.k and dO.v have bf16 operands on that route and are exact
  as they are. K2-tf32 splits every float32 operand (q, k, v and p) into
  tf32 hi + lo and sums hi.hi + hi.lo + lo.hi: each product to ~2**-21;
  K3-tf32 and K4-tf32 do the same for q, k, v, dout, p and ds;
- a masked score gives p = 0. A fully masked row returns 0 with lse ~
  NEG_BIG, whatever the tiling (the Pallas kernel returns the mean of v
  for such a row when it lies in a live block of its tiling);
- the backward recomputes p = exp(s - lse) and folds the lse cotangent
  into delta = rowsum(dO . O) - g_lse (K3 and K4 compute it themselves,
  the tensor-core kernels read it from the delta pass); dq, dk, dv, dp
  are float32
  and rounded to the inputs' dtype once.

Each wrapper runs its plain version for a tensor on the CPU, launches its
kernel for a CUDA tensor (or raises), and raises for any other device.
`launches` counts kernel launches by kernel name, not plain-version calls.
The split computes the same function, so the tensor-core kernels share
K2's, K3's and K4's plain versions. The autograd Function's forward calls
`flash_fwd` through the dispatcher op `edl::flash_fwd` (`flash_fwd_op`,
with a fake rule), so `torch.export` traces it into a serving program
that launches K2', K2-tf32 or K2 (`training/export.export_saved_model`);
its backward calls `flash_bwd` through `edl::flash_bwd` (`flash_bwd_op`).
Each op has a FLOP formula (`torch.utils.flop_counter`), so a counter
that sees the op and not its body (`Trainer.train_step_cost`) counts the
same on the CPU, where the plain versions run, as on the card, where the
kernels run behind ctypes (`attention_flops`).

The reference transposes to (B, H, T, D) and lane-broadcasts lse to 128
only because Mosaic tiles need it; neither is ported, and neither is its
interpret-mode machinery: on the CPU the plain version runs, on the card
the kernel.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from elasticdl_tpu_torch.ops import native

NEG_BIG = -1e30  # finite "-inf", matches ops.attention
LIBRARY, LIBRARY_SM90 = "flash_attention", "flash_attention_sm90"
FWD, BWD_DQ, BWD_DKV = "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"
FWD_SM90, BWD_DKV_SM90 = "flash_fwd_sm90", "flash_bwd_dkv_sm90"
BWD_DQ_SM90, BWD_DELTA_SM90 = "flash_bwd_dq_sm90", "flash_bwd_delta_sm90"
FWD_TF32 = "flash_fwd_tf32_sm90"
BWD_DQ_TF32, BWD_DKV_TF32 = "flash_bwd_dq_tf32_sm90", "flash_bwd_dkv_tf32_sm90"
launches = {FWD: 0, BWD_DQ: 0, BWD_DKV: 0, FWD_SM90: 0, BWD_DQ_SM90: 0,
            BWD_DKV_SM90: 0, BWD_DELTA_SM90: 0, FWD_TF32: 0, BWD_DQ_TF32: 0,
            BWD_DKV_TF32: 0}
_SM90_HEAD_DIMS = (16, 32, 64, 128)  # K2', K3', K4' (bfloat16)
_TF32_HEAD_DIMS = (16, 32, 64)       # K2-tf32, K3-tf32, K4-tf32 (float32)
_KERNELS = {LIBRARY: (FWD, BWD_DQ, BWD_DKV),
            LIBRARY_SM90: (FWD_SM90, BWD_DQ_SM90, BWD_DKV_SM90,
                           BWD_DELTA_SM90, FWD_TF32, BWD_DQ_TF32,
                           BWD_DKV_TF32)}
# pointer arguments of each launcher, then the int arguments before the
# stream: B H Tq Tk D q_off kv_off causal (the delta pass: B H Tq D)
_SIGNATURES = {FWD: (5, 8), BWD_DQ: (8, 8), BWD_DKV: (9, 8),
               FWD_SM90: (5, 8), BWD_DQ_SM90: (7, 8), BWD_DKV_SM90: (8, 8),
               BWD_DELTA_SM90: (4, 4), FWD_TF32: (5, 8), BWD_DQ_TF32: (7, 8),
               BWD_DKV_TF32: (8, 8)}
# the tensor-core dQ and dK/dV kernels, which read the delta pass
_DQ_HOPPER, _DKV_HOPPER = (BWD_DQ_SM90, BWD_DQ_TF32), (BWD_DKV_SM90,
                                                        BWD_DKV_TF32)

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
    # contiguous (B, Tq, H, D), as the kernels write it (`flash_fwd_op`)
    return out.transpose(1, 2).contiguous().to(q.dtype), lse


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


def route(dtype, d) -> Tuple[str, Tuple[str, ...]]:
    """The kernels that take inputs of `dtype` and head dim `d` on the
    card, decided before any launch, the one place that decides them:
    (forward, the backward's launches, each once: dQ, dK/dV and, where
    the tensor-core kernels read it, the delta pass):
    - bfloat16 at D 16, 32, 64, 128: K2'; K3', K4' and the delta pass;
    - float32 at D 16, 32, 64: K2-tf32; K3-tf32, K4-tf32 and the delta
      pass;
    - everything else: K2; K3 and K4."""
    if dtype == torch.bfloat16 and d in _SM90_HEAD_DIMS:
        return FWD_SM90, (BWD_DQ_SM90, BWD_DKV_SM90, BWD_DELTA_SM90)
    if dtype == torch.float32 and d in _TF32_HEAD_DIMS:
        return FWD_TF32, (BWD_DQ_TF32, BWD_DKV_TF32, BWD_DELTA_SM90)
    return FWD, (BWD_DQ, BWD_DKV)


def _check_head_dim(t: torch.Tensor) -> None:
    if t.stride(3) != 1 and t.shape[3] > 1:
        raise ValueError(f"the head dim must be contiguous, got strides "
                         f"{t.stride()}")


def _check_tma(*tensors) -> None:
    """TMA reads a tensor with a contiguous head dim through strides that
    are multiples of 16 bytes from a 16-byte-aligned address (a dim of
    extent 1 may carry any stride); raise for one it cannot take."""
    for t in tensors:
        _check_head_dim(t)
        odd = [s for s, n in zip(t.stride()[:3], t.shape[:3])
               if n > 1 and (s * t.element_size()) % 16]
        if odd or t.data_ptr() % 16:
            raise ValueError(
                f"the Hopper kernels read (B, T, H, D) tensors "
                f"through TMA, which needs (b, t, h) strides that are "
                f"multiples of 16 bytes and a 16-byte-aligned address; got "
                f"strides {t.stride()} at address {t.data_ptr():#x}")


def _strides(*tensors) -> ctypes.Array:
    """(b, t, h) element strides of each (B, T, H, D) tensor, whose D
    stride must be 1."""
    vals = []
    for t in tensors:
        _check_head_dim(t)
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
    """The forward by `route`: K2' (bfloat16 at D 16, 32, 64 or 128),
    K2-tf32 (float32 at D 16, 32 or 64) or K2: (out in q's dtype, lse
    (B, H, Tq) float32)."""
    _validate(q, k, v)
    if not _on_card(q):
        return flash_fwd_plain(q, k, v, causal, q_offset, kv_offset)
    return launch_fwd(q, k, v, causal, q_offset, kv_offset,
                      route(q.dtype, q.shape[3])[0])


def launch_fwd(q, k, v, causal, q_offset, kv_offset, kernel: str):
    """Launch the forward kernel `kernel` (FWD_SM90, FWD_TF32 or FWD) on
    validated CUDA tensors. `flash_fwd` names the one `route` gives; a
    caller that times two kernels side by side on the same inputs names
    each. The Hopper kernels read q, k and v through TMA."""
    if kernel not in (FWD, FWD_SM90, FWD_TF32):
        raise ValueError(f"no forward kernel {kernel!r}")
    if kernel != FWD:
        _check_tma(q, k, v)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    b, tq, h, _ = q.shape
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    _launch(kernel, q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(), _strides(q, k, v, out),
            *_dims(q, k, causal, q_offset, kv_offset))
    return out, lse


@torch.library.custom_op("edl::flash_fwd", mutates_args=())
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool, q_offset: int, kv_offset: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`flash_fwd` as the dispatcher op `edl::flash_fwd`, so that a traced
    program (`torch.export`, `training/export.export_saved_model`) holds
    a node that launches K2, K2' or K2-tf32 where a ctypes call on a fake
    tensor could not be traced. Its body is `flash_fwd` itself: on the CPU
    the plain version, on the card K2', K2-tf32 or K2 as `route` names
    them; each returns a contiguous out. `launches` counts real launches
    only: the fake rule below launches nothing."""
    return flash_fwd(q, k, v, causal, q_offset, kv_offset)


@flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, causal, q_offset, kv_offset):
    del k, v, causal, q_offset, kv_offset
    b, tq, h, _ = q.shape
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty((b, h, tq), dtype=torch.float32))


def attention_flops(q_shape, k_shape, backward: bool = False) -> int:
    """The FLOPs of one launch's attention, forward or backward, over q
    (B, Tq, H, D) and k (B, Tk, H, D): the work the reference's program
    describes, whatever implements it. XLA counts its materialized
    attention (EDL_FLASH=0) as 2 B H Tq Tk D a product: q.k^T and p.v
    forward (4), dP = dO.v^T, dS.k, dS^T.q and p^T.dO backward (8); the
    causal mask and the kernels' recompute of p do not count.

    The count is per launch, at the launch's own Tq and Tk: a ring of n
    blocks launches n^2 block pairs of (T/n)^2 that sum to the unsplit
    count, as Ulysses' head groups sum to it over H. A schedule that
    skips wholly masked block pairs (ROADMAP P10) must add the pairs it
    skips, so that its count stays the unsplit one's."""
    b, tq, h, d = q_shape
    return (8 if backward else 4) * b * h * tq * k_shape[1] * d


@register_flop_formula(torch.ops.edl.flash_fwd)
def _flash_fwd_flops(q_shape, k_shape, *args, out_shape=None, **kwargs):
    del args, out_shape, kwargs
    return attention_flops(q_shape, k_shape)


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
    """dQ in q's dtype by `route`: the delta pass, then K3' (bfloat16 at
    D 16, 32, 64 or 128) or K3-tf32 (float32 at D 16, 32 or 64); K3
    elsewhere. g_lse (B, H, Tq) float32 or None (zero)."""
    _validate(q, k, v, out, dout)
    _check_residuals(q, lse, g_lse)
    if not _on_card(q):
        return flash_bwd_dq_plain(q, k, v, out, dout, lse, g_lse, causal,
                                  q_offset, kv_offset)
    return launch_bwd_dq(q, k, v, out, dout, lse, g_lse, causal, q_offset,
                         kv_offset, route(q.dtype, q.shape[3])[1][0])


def launch_bwd_dq(q, k, v, out, dout, lse, g_lse, causal, q_offset,
                  kv_offset, kernel: str):
    """Launch dQ's kernel `kernel` on validated CUDA tensors: K3
    (BWD_DQ), or the delta pass and then K3' (BWD_DQ_SM90) or K3-tf32
    (BWD_DQ_TF32); see `launch_fwd`."""
    if kernel in _DQ_HOPPER:
        _check_tma(q, k, v, dout)
        return launch_dq_sm90(q, k, v, dout, lse,
                              _launch_delta(out, dout, g_lse), causal,
                              q_offset, kv_offset, kernel)
    if kernel != BWD_DQ:
        raise ValueError(f"no dQ kernel {kernel!r}")
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    _launch(BWD_DQ, q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            None if g_lse is None else g_lse.data_ptr(), dq.data_ptr(),
            _strides(q, k, v, out, dout, dq),
            *_dims(q, k, causal, q_offset, kv_offset))
    return dq


def launch_dq_sm90(q, k, v, dout, lse, delta, causal, q_offset, kv_offset,
                   kernel: str = BWD_DQ_SM90):
    """Launch K3' (or, `kernel` BWD_DQ_TF32, K3-tf32) alone on validated
    CUDA tensors, with `delta` from the delta pass."""
    if kernel not in _DQ_HOPPER:
        raise ValueError(f"no tensor-core dQ kernel {kernel!r}")
    _check_tma(q, k, v, dout)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    _launch(kernel, q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            _strides(q, k, v, dout, dq),
            *_dims(q, k, causal, q_offset, kv_offset))
    return dq


def flash_bwd_dkv(q, k, v, out, dout, lse, g_lse=None, causal=True,
                  q_offset=0, kv_offset=0):
    """(dK, dV) in k's and v's dtypes by `route`: the delta pass, then K4'
    (bfloat16 at D 16, 32, 64 or 128) or K4-tf32 (float32 at D 16, 32 or
    64); K4 elsewhere."""
    _validate(q, k, v, out, dout)
    _check_residuals(q, lse, g_lse)
    if not _on_card(q):
        return flash_bwd_dkv_plain(q, k, v, out, dout, lse, g_lse, causal,
                                   q_offset, kv_offset)
    return launch_bwd_dkv(q, k, v, out, dout, lse, g_lse, causal, q_offset,
                          kv_offset, route(q.dtype, q.shape[3])[1][1])


def launch_bwd_dkv(q, k, v, out, dout, lse, g_lse, causal, q_offset,
                   kv_offset, kernel: str):
    """Launch dK/dV's kernel `kernel` on validated CUDA tensors: K4
    (BWD_DKV), or the delta pass and then K4' (BWD_DKV_SM90) or K4-tf32
    (BWD_DKV_TF32); see `launch_fwd`."""
    if kernel in _DKV_HOPPER:
        _check_tma(q, k, v, dout)
        return launch_dkv_sm90(q, k, v, dout, lse,
                               _launch_delta(out, dout, g_lse), causal,
                               q_offset, kv_offset, kernel)
    if kernel != BWD_DKV:
        raise ValueError(f"no dK/dV kernel {kernel!r}")
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    _launch(BWD_DKV, q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            None if g_lse is None else g_lse.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), _strides(q, k, v, out, dout, dk, dv),
            *_dims(q, k, causal, q_offset, kv_offset))
    return dk, dv


def launch_dkv_sm90(q, k, v, dout, lse, delta, causal, q_offset, kv_offset,
                    kernel: str = BWD_DKV_SM90):
    """Launch K4' (or, `kernel` BWD_DKV_TF32, K4-tf32) alone on validated
    CUDA tensors, with `delta` from the delta pass."""
    if kernel not in _DKV_HOPPER:
        raise ValueError(f"no tensor-core dK/dV kernel {kernel!r}")
    _check_tma(q, k, v, dout)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    _launch(kernel, q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
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
    """The delta pass of the tensor-core backward kernels: rowsum(dO . O)
    - g_lse, (B, H, Tq) float32. It serves them only, so a CUDA tensor
    whose route has no delta pass raises."""
    _validate(out, dout, dout)
    _check_residuals(out, g_lse, None)
    if not _on_card(out):
        return flash_bwd_delta_plain(out, dout, g_lse)
    d = out.shape[3]
    if BWD_DELTA_SM90 not in route(out.dtype, d)[1]:
        raise ValueError(f"the delta pass serves the tensor-core backward "
                         f"only, which takes bfloat16 at D "
                         f"{_SM90_HEAD_DIMS} and float32 at D "
                         f"{_TF32_HEAD_DIMS}; got {out.dtype} D {d}")
    return _launch_delta(out, dout, g_lse)


def flash_bwd(q, k, v, out, dout, lse, g_lse=None, causal=True, q_offset=0,
              kv_offset=0):
    """The whole backward: (dQ, dK, dV) by `route`. Where the tensor-core
    kernels take the inputs the delta pass runs once and both read it;
    elsewhere K3 and K4 run, each computing its own delta (on the CPU,
    their plain versions)."""
    _validate(q, k, v, out, dout)
    _check_residuals(q, lse, g_lse)
    args = (causal, q_offset, kv_offset)
    if not _on_card(q):
        return (flash_bwd_dq_plain(q, k, v, out, dout, lse, g_lse, *args),
                *flash_bwd_dkv_plain(q, k, v, out, dout, lse, g_lse, *args))
    dq_kernel, dkv_kernel, *delta_pass = route(q.dtype, q.shape[3])[1]
    if not delta_pass:
        return (launch_bwd_dq(q, k, v, out, dout, lse, g_lse, *args,
                              dq_kernel),
                *launch_bwd_dkv(q, k, v, out, dout, lse, g_lse, *args,
                                dkv_kernel))
    _check_tma(q, k, v, dout)
    delta = _launch_delta(out, dout, g_lse)
    return (launch_dq_sm90(q, k, v, dout, lse, delta, *args, dq_kernel),
            *launch_dkv_sm90(q, k, v, dout, lse, delta, *args, dkv_kernel))


@torch.library.custom_op("edl::flash_bwd", mutates_args=())
def flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor,
                 g_lse: Optional[torch.Tensor], causal: bool, q_offset: int,
                 kv_offset: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`flash_bwd` as the dispatcher op `edl::flash_bwd`, the backward's
    boundary: a counter that sees the op and not its body counts its
    formula, where the plain versions on the CPU would show it their
    einsums (`_p_and_ds` twice) and the kernels on the card nothing.
    Its body is `flash_bwd`, whose dQ, dK and dV come back contiguous,
    as the kernels write them."""
    return tuple(g.contiguous() for g in flash_bwd(
        q, k, v, out, dout, lse, g_lse, causal, q_offset, kv_offset))


@flash_bwd_op.register_fake
def _flash_bwd_fake(q, k, v, out, dout, lse, g_lse, causal, q_offset,
                    kv_offset):
    del out, dout, lse, g_lse, causal, q_offset, kv_offset
    return tuple(torch.empty_like(t, memory_format=torch.contiguous_format)
                 for t in (q, k, v))


@register_flop_formula(torch.ops.edl.flash_bwd)
def _flash_bwd_flops(q_shape, k_shape, *args, out_shape=None, **kwargs):
    del args, out_shape, kwargs
    return attention_flops(q_shape, k_shape, backward=True)


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
    """(out, lse) with the forward kernel and `flash_bwd`'s backward, both
    routed by `route` and each called through its dispatcher op. An
    unused lse (the out-only `flash_attention`) reaches the backward as
    None, which the kernels read as g_lse = 0.

    Under a non-reentrant `torch.utils.checkpoint` (the trainer's remat)
    the saved q, k, v, out and lse are dropped and the forward runs again
    in the backward: the kernel launches once more (and counts in
    `launches`) into freshly allocated out and lse, which the backward
    then reads. A selective policy sees the forward as one op,
    `edl::flash_fwd`, which no policy of the trainer saves."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, kv_offset):
        out, lse = flash_fwd_op(q, k, v, causal, q_offset, kv_offset)
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
        dq, dk, dv = flash_bwd_op(q, k, v, out, g_out, lse, g_lse,
                                  *ctx.args)
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
