"""Attention over (B, T, H, D): the flash kernels, or on the CPU the
materialized softmax where they are switched off; and attention over a
sequence sharded on a `seq` mesh axis.

Counterpart of `elasticdl_tpu/ops/attention.py`. Two schedules shard the
sequence, as the reference's do:

- **ring** (`mode="ring"`): each rank keeps its q block and streams the
  KV blocks past it (`ring_scan`): its own first, then n - 1 rotations,
  each a point-to-point exchange with the ring's neighbours
  (`parallel.mesh.ring_shift`), never a gather of the sequence. Each
  visiting block goes through `flash_attention_lse` (K2', K3' and K4' on
  the card) at its global offsets, and the partials merge by their
  logsumexps in float32 (`_merge_flash_blocks`), so the merge's lse
  cotangent reaches the backward kernels. Where the kernels do not take
  the shard-local shapes (EDL_FLASH=0) the float32 online-softmax
  recurrence runs instead, on the CPU only.
- **Ulysses** (`mode="ulysses"`): an all-to-all re-shards heads against
  the sequence (`parallel.mesh.all_to_all`), each rank runs
  `full_attention` over the whole sequence for H/n heads, and a second
  all-to-all returns its block; the heads must divide by n.

The rotation is passed in, so one process can run the ring over n blocks
it holds itself (`ring_attention_local`, the card's check of the
schedule) with the code the sharded path runs. The sharded path takes
its mesh and the rank's columns from the trainer's
`parallel.mesh.batch_block_of`; outside it, or with no `seq` axis of
more than one rank, attention is `full_attention`.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from elasticdl_tpu_torch.common.constants import MeshAxis
from elasticdl_tpu_torch.ops import flash_attention as flash
from elasticdl_tpu_torch.parallel import mesh as mesh_lib

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


def ring_scan(k: torch.Tensor, v: torch.Tensor, idx: int, n: int,
              rotate: Callable, consume: Callable, carry):
    """The ring's schedule for the rank at ring position `idx` of `n`:
    `consume(carry, kb, vb, kv_block)` the resident block (block `idx`)
    first, then n - 1 times rotate first and consume the visiting block,
    which after j rotations is block (idx - j) % n. `rotate(k, v)` moves
    every rank's blocks one place on and returns the ones that arrive.
    Every rank calls it alike, so the exchanges pair up in one order, in
    the forward, in the backward and in a remat recompute."""
    carry = consume(carry, k, v, idx)
    for j in range(1, n):
        k, v = rotate(k, v)
        carry = consume(carry, k, v, (idx - j) % n)
    return carry


def _ring_attention_recurrence(q, k, v, idx: int, n: int, rotate,
                               causal: bool) -> torch.Tensor:
    """The ring with the float32 online-softmax recurrence as its block
    step (the reference's `_ring_attention_sharded`). q, k, v: the local
    (B, L, H, D) blocks."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    qf = q.to(torch.float32)
    q_pos = idx * lq + torch.arange(lq, device=q.device)

    def accumulate(carry, kb, vb, kv_block):
        o, m, l = carry
        s = torch.einsum("bqhd,bkhd->bhqk", qf,
                         kb.to(torch.float32)) * d ** -0.5
        if causal:
            kv_pos = kv_block * lk + torch.arange(lk, device=q.device)
            s = s.masked_fill(kv_pos[None, :] > q_pos[:, None], NEG_BIG)
        m_new = torch.maximum(m, s.amax(dim=-1))                # (B, H, Lq)
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l_new = l * alpha + p.sum(dim=-1)
        o_new = o * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p, vb.to(torch.float32))
        return o_new, m_new, l_new

    f32 = dict(dtype=torch.float32, device=q.device)
    o, _, l = ring_scan(k, v, idx, n, rotate, accumulate,
                        (torch.zeros((b, h, lq, d), **f32),
                         torch.full((b, h, lq), NEG_BIG, **f32),
                         torch.zeros((b, h, lq), **f32)))
    out = o / l.clamp_min(1e-20)[..., None]                   # (B, H, Lq, D)
    return out.transpose(1, 2).to(q.dtype)


def _merge_flash_blocks(o1, lse1, o2, lse2):
    """Combine two flash partials over the same q rows, weighted by their
    logsumexps (the associative flash merge). o: (B, Lq, H, D) float32;
    lse: (B, H, Lq) float32. A fully masked partial carries lse NEG_BIG
    and weighs 0."""
    lse = torch.logaddexp(lse1, lse2)
    w1 = torch.exp(lse1 - lse).transpose(1, 2)[..., None]      # (B, Lq, H, 1)
    w2 = torch.exp(lse2 - lse).transpose(1, 2)[..., None]
    return o1 * w1 + o2 * w2, lse


def _ring_attention_flash(q, k, v, idx: int, n: int, rotate,
                          causal: bool) -> torch.Tensor:
    """The ring with `flash_attention_lse` as its block step, at the
    block's global offsets (host ints: the rank's position is known on
    the host), its partials merged by logsumexp. Each partial is rounded
    to q's dtype by the kernel and then taken to float32, as the
    reference does. Every block is launched, the wholly masked ones too
    (out 0, lse NEG_BIG), as the reference's scan makes them."""
    b, lq, h, d = q.shape
    lk = k.shape[1]

    def accumulate(carry, kb, vb, kv_block):
        o2, lse2 = flash.flash_attention_lse(
            q, kb, vb, causal=causal, q_offset=idx * lq,
            kv_offset=kv_block * lk)
        return _merge_flash_blocks(*carry, o2.to(torch.float32), lse2)

    # a zero-weight first carry: lse NEG_BIG merges as no contribution
    f32 = dict(dtype=torch.float32, device=q.device)
    o, _ = ring_scan(k, v, idx, n, rotate, accumulate,
                     (torch.zeros((b, lq, h, d), **f32),
                      torch.full((b, h, lq), NEG_BIG, **f32)))
    return o.to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   idx: int, n: int, rotate: Callable,
                   causal: bool = True) -> torch.Tensor:
    """Ring attention for the rank at ring position `idx` of `n`, whose
    local (B, L, H, D) blocks are q, k, v, with the rotation `rotate`
    (`ring_scan`). The flash kernels run where `can_flash` takes the
    shard-local shapes, as the reference decides; elsewhere the
    recurrence, on the CPU only (the card has only the kernels)."""
    if flash.can_flash(q.shape, k.shape, dtype=q.dtype):
        return _ring_attention_flash(q, k, v, idx, n, rotate, causal)
    if q.device.type != "cpu":
        raise ValueError(
            f"no attention kernel for the ring's blocks q {tuple(q.shape)} "
            f"{q.dtype} on {q.device} (EDL_FLASH=0, or outside the shapes "
            "and dtypes `flash_attention.can_flash` takes)")
    return _ring_attention_recurrence(q, k, v, idx, n, rotate, causal)


def _sharded_rotation(kb, vb, mesh, axis):
    """One rotation of the ring over `axis`: k and v in one point-to-point
    message to the next rank."""
    return mesh_lib.ring_shift(torch.stack([kb, vb]), mesh, axis).unbind(0)


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         n: int, causal: bool = True) -> torch.Tensor:
    """The ring over n virtual ranks in this process: the sequence of
    (B, T, H, D) q, k, v cut into n blocks, each virtual rank's ring run
    with a rotation that hands it the blocks it would receive, and the
    outputs put back together along T. The same schedule and block step
    as the sharded ring; differentiable."""
    t = q.shape[1]
    if t % n:
        raise ValueError(f"sequence length {t} is not a multiple of {n}")
    ks, vs = k.chunk(n, dim=1), v.chunk(n, dim=1)
    outs = []
    for idx, qb in enumerate(q.chunk(n, dim=1)):
        held = [idx]

        def rotate(kb, vb, held=held):
            held[0] = (held[0] - 1) % n
            return ks[held[0]], vs[held[0]]

        outs.append(ring_attention(qb, ks[idx], vs[idx], idx, n, rotate,
                                   causal))
    return torch.cat(outs, dim=1)


def _ulysses_sharded(q, k, v, mesh, axis: str, causal: bool) -> torch.Tensor:
    """All-to-all heads against the sequence over `axis`, full attention
    over the whole sequence for this rank's H/n heads, and back."""
    n = mesh.axis_size(axis)
    b, l, h, d = q.shape
    if h % n:
        raise ValueError(
            f"ulysses needs heads ({h}) divisible by seq shards ({n})")

    def to_seq(x):       # (B, L, H, D) -> (B, n*L, H/n, D)
        x = x.reshape(b, l, n, h // n, d).permute(2, 0, 1, 3, 4)
        x = mesh_lib.all_to_all(x, mesh, axis)              # [j]: block j
        return x.permute(1, 0, 2, 3, 4).reshape(b, n * l, h // n, d)

    def to_heads(x):     # the inverse
        x = x.reshape(b, n, l, h // n, d).permute(1, 0, 2, 3, 4)
        x = mesh_lib.all_to_all(x, mesh, axis)              # [j]: heads j
        return x.permute(1, 2, 0, 3, 4).reshape(b, l, h, d)

    return to_heads(full_attention(to_seq(q), to_seq(k), to_seq(v),
                                   causal=causal))


def sequence_parallel_attention(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, causal: bool = True,
                                mode: str = "ring",
                                axis_name: Optional[str] = None
                                ) -> torch.Tensor:
    """Attention over a sequence sharded on mesh axis `axis_name` (default
    `seq`): q, k, v are this rank's (B, T/n, H, D) blocks, inside the
    trainer's `parallel.mesh.batch_block_of` with the rank's columns.
    `mode` is "ring" or "ulysses" (module docstring). Without such a
    block, or where the axis has one rank, it is `full_attention`.
    Collective over the axis: every rank of it calls it alike."""
    block = mesh_lib.data_block()
    axis = axis_name or MeshAxis.SEQ
    if (block is None or mesh_lib.seq_columns() is None
            or block[3].axis_size(axis) == 1):
        return full_attention(q, k, v, causal=causal)
    mesh = block[3]
    if mode == "ring":
        rotate = functools.partial(_sharded_rotation, mesh=mesh, axis=axis)
        return ring_attention(q, k, v, mesh.coords[axis],
                              mesh.axis_size(axis), rotate, causal)
    if mode == "ulysses":
        return _ulysses_sharded(q, k, v, mesh, axis, causal)
    raise ValueError(f"unknown sequence-parallel mode {mode!r}")
