"""Attention over (B, T, H, D): the flash kernels, or on the CPU the
materialized softmax where they are switched off.

Counterpart of `elasticdl_tpu/ops/attention.py`, single-device part:
`full_attention` and the one-device branch of
`sequence_parallel_attention`. Ring attention, Ulysses and
`_merge_flash_blocks` shard the sequence over a `seq` mesh axis and wait
for the port's mesh (ROADMAP items 17 and 21).
"""

from __future__ import annotations

from typing import Optional

import torch

from elasticdl_tpu_torch.ops import flash_attention as flash

NEG_BIG = -1e30  # finite "-inf": avoids nan from (-inf) - (-inf) in softmax


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True, q_offset: int = 0,
                   kv_offset: int = 0) -> torch.Tensor:
    """Softmax attention. q, k, v: (B, T, H, D). The offsets position the
    q and kv blocks in the global sequence for causal masking.

    Takes the flash kernels (`ops/flash_attention.py`) wherever `can_flash`
    allows: on the card K2-K4, on the CPU their plain versions. Where it
    does not (EDL_FLASH=0, or a shape or dtype the kernels do not take),
    the materialized body below runs on the CPU, as the reference's
    EDL_FLASH=0 route does, and a CUDA tensor raises: the card has only
    the kernels. The two differ on a fully masked row: flash returns 0,
    the materialized body the uniform softmax over NEG_BIG scores."""
    if flash.can_flash(q.shape, k.shape, q_offset, kv_offset, dtype=q.dtype):
        return flash.flash_attention(q, k, v, causal=causal,
                                     q_offset=q_offset, kv_offset=kv_offset)
    if q.device.type != "cpu":
        raise ValueError(
            f"no attention kernel for q {tuple(q.shape)} {q.dtype} and k "
            f"{tuple(k.shape)} on {q.device} (EDL_FLASH=0, or outside "
            f"float32/bfloat16, D <= {flash.MAX_HEAD_DIM}, B * H <= "
            f"{flash.MAX_GRID_Y})")
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        kv_pos = kv_offset + torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(kv_pos[None, :] > q_pos[:, None], NEG_BIG)
    p = torch.softmax(s, dim=-1)
    # p rounds to v's dtype before the product, as in the reference
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).to(torch.float32),
                       v.to(torch.float32))
    return out.to(q.dtype)


def sequence_parallel_attention(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, causal: bool = True,
                                mode: str = "ring",
                                axis_name: Optional[str] = None
                                ) -> torch.Tensor:
    """Attention over a sequence sharded on mesh axis `axis_name`. With no
    axis (one device) it is `full_attention`; `mode` ("ring" or
    "ulysses") chooses the sharded schedule, which is not ported yet."""
    del mode
    if axis_name is None:
        return full_attention(q, k, v, causal=causal)
    raise NotImplementedError(
        f"sequence-parallel attention over axis {axis_name!r} needs the "
        "port's mesh and the ring/Ulysses schedules (ROADMAP items 17 and "
        "21)")
