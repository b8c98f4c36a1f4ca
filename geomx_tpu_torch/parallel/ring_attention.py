"""Ring attention over the in-process sp axis (port of
geomx_tpu/parallel/ring_attention.py).

In the JAX package each device of the ``sp`` mesh axis holds one
sequence block of Q/K/V; K/V blocks rotate around the ring with
``ppermute`` while every device folds its Q block's attention into a
streaming softmax.  The port holds one replica's ``S`` shards as dim 0
of ``[S, B, L/S, H, D]`` activations: a hop updates every shard's
carries at once (the shards are extra rows of the batch), and the
rotation is :func:`~geomx_tpu_torch.parallel.collectives.ppermute_sp`.

The hop is the fused kernel of ``parallel/_fused_block.py`` when
:func:`~geomx_tpu_torch.ops.flash_attention.fused_attention_supported`
holds and the shape rule of the reference holds (the hop block
``min(128, L/S)`` tiles the shard and is a multiple of 8, the head dim a
multiple of 8); otherwise the plain :func:`_block` runs.  That rule is
the reference's, not a fallback on error.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from geomx_tpu_torch.parallel.collectives import ppermute_sp


def _block(q, k, v, m, l_acc, o, scale, mask):
    """One streaming-softmax step (the reference's jnp ``_block``).

    q: [B, Lq, H, D]; k, v: [B, Lk, H, D]; m, l_acc: [B, H, Lq]; o like q.
    mask: [Lq, Lk] boolean or None.  ``torch.amax``/``torch.maximum``
    split a tie's gradient evenly, as JAX's max does."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if mask is not None:
        s = torch.where(mask[None, None], s, -math.inf)
    m_new = torch.maximum(m, s.amax(-1))
    # guard fully-masked rows: exp(-inf - -inf) -> use a safe m
    m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
    p = torch.exp(s - m_safe[..., None])
    if mask is not None:
        p = torch.where(mask[None, None], p, 0.0)
    corr = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_safe))
    l_new = l_acc * corr + p.sum(-1)
    o_new = o * corr.transpose(1, 2)[..., None] + \
        torch.einsum("bhqk,bkhd->bqhd", p, v)
    return m_new, l_new, o_new


def fused_hop_aligned(L_local: int, D: int) -> bool:
    """The reference's auto-gate for the fused hop (``:74-86``)."""
    hop_block = min(128, L_local)
    return L_local % hop_block == 0 and hop_block % 8 == 0 and D % 8 == 0


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = False,
                   use_fused: Optional[bool] = None) -> torch.Tensor:
    """Sequence-parallel attention over the in-process sp axis.

    q, k, v: ``[S, B, L_local, H, D]``, shard ``i`` holding sequence
    block ``i``.  Returns ``[S, B, L_local, H, D]`` in q's dtype.  With
    ``causal=True`` positions attend only to earlier global positions:
    at hop ``t`` shard ``i`` holds block ``src = (i - t) mod S`` and
    takes the diagonal mask where ``src == i``, the whole block where
    ``src < i``, and skips it otherwise."""
    S, B, Lq, H, D = q.shape
    hop_block = min(128, Lq)
    if use_fused is None:
        from geomx_tpu_torch.ops.flash_attention import \
            fused_attention_supported
        use_fused = fused_attention_supported() and fused_hop_aligned(Lq, D)
    if use_fused and Lq % hop_block:
        raise ValueError(f"fused ring hop needs L_local ({Lq}) divisible "
                         f"by the hop block ({hop_block})")
    dev = q.device
    n = S * B
    m = torch.full((n, H, Lq), -math.inf, device=dev)
    l_acc = torch.zeros((n, H, Lq), device=dev)
    o = torch.zeros((n, Lq, H, D), device=dev)
    qf = q.float().reshape(n, Lq, H, D)
    kk, vv = k.float(), v.float()

    if use_fused:
        from geomx_tpu_torch.parallel._fused_block import fused_block
        fscale = 1.0 / float(math.sqrt(D))

        def hop(q_, k_, v_, m_, l_, o_, diag):
            return fused_block(q_, k_, v_, m_, l_, o_, fscale, diag,
                               hop_block)
    else:
        # the reference's scale: 1 / sqrt(D) in q's dtype
        scale = float(torch.tensor(D, dtype=q.dtype).sqrt().reciprocal())
        tri = torch.tril(torch.ones((Lq, Lq), dtype=torch.bool, device=dev))

        def hop(q_, k_, v_, m_, l_, o_, diag):
            return _block(q_, k_, v_, m_, l_, o_, scale,
                          tri if diag else None)

    for step in range(S):
        if not causal:
            m, l_acc, o = hop(qf, kk.reshape(n, Lq, H, D),
                              vv.reshape(n, Lq, H, D), m, l_acc, o, False)
        elif step == 0:
            # every shard holds its own block: the diagonal
            m, l_acc, o = hop(qf, kk.reshape(n, Lq, H, D),
                              vv.reshape(n, Lq, H, D), m, l_acc, o, True)
        else:
            # shards i >= step hold an earlier block (full), the others
            # a later one (skipped)
            r = step * B
            mn, ln, on = hop(qf[r:], kk[step:].reshape(n - r, Lq, H, D),
                             vv[step:].reshape(n - r, Lq, H, D), m[r:],
                             l_acc[r:], o[r:], False)
            m = torch.cat([m[:r], mn])
            l_acc = torch.cat([l_acc[:r], ln])
            o = torch.cat([o[:r], on])
        # rotate K/V around the ring
        kk, vv = ppermute_sp(kk), ppermute_sp(vv)
    l_acc = torch.clamp_min(l_acc, 1e-20)
    out = o / l_acc.transpose(1, 2)[..., None]
    return out.to(q.dtype).reshape(S, B, Lq, H, D)


def full_attention_reference(q, k, v, causal: bool = False):
    """Dense O(L^2) attention over ``[B, L, H, D]`` for correctness
    tests and the ``GEOMX_FLASH_ATTN=0`` path."""
    L, D = q.shape[1], q.shape[3]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(D)
    if causal:
        mask = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask[None, None], s, -math.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)
