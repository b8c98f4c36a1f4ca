"""Ulysses all-to-all sequence parallelism over the in-process sp axis
(port of geomx_tpu/parallel/ulysses.py).

One all-to-all re-shards one replica's activations from sequence
sharding to head sharding, each shard attends over the whole sequence
for its ``H/S`` heads, and a second all-to-all re-shards back.  The
port's shards are dim 0 of ``[S, B, L/S, H, D]``
(:func:`~geomx_tpu_torch.parallel.collectives.all_to_all_sp`), so the
per-shard attentions run as ONE call of
:func:`~geomx_tpu_torch.ops.flash_attention.fused_attention` over
``[S * B, L, H/S, D]``: the flash kernels, forward and backward, on the
sp path.  In a slot of a ``[P, W, S]`` mesh dim 0 is the slot's one
shard, each all-to-all meets the other shards' slots, and the slot
attends over the whole sequence for its own ``H/S`` heads.  Where the
reference's gate fails (head dim not a multiple of
8, or a short sequence whose block is not 8-aligned), the plain
:func:`_streaming_attention` runs, as in the reference.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from geomx_tpu_torch.parallel.collectives import (all_to_all_sp,
                                                  sp_axis_size,
                                                  sp_exchange_group)
from geomx_tpu_torch.parallel.ring_attention import _block


def _fused_block_aligned(seq_len: int) -> bool:
    """The reference's gate for the post-all-to-all full sequence: the
    flash kernel's block ``min(128, L)`` must be 8-aligned."""
    return min(128, seq_len) % 8 == 0


def _streaming_attention(q, k, v, causal: bool, block: int = 1024):
    """Full-sequence attention over ``[B, L, H, D]`` with a streaming
    softmax over K/V blocks (the reference's plain path)."""
    B, L, H, D = q.shape
    blk = min(block, L)
    nb = -(-L // blk)
    pad = nb * blk - L
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    scale = float(torch.tensor(D, dtype=torch.float32).sqrt().reciprocal())
    qf, kf, vf = q.float(), k.float(), v.float()
    dev = q.device
    q_pos = torch.arange(L, device=dev)
    m = torch.full((B, H, L), -math.inf, device=dev)
    l_acc = torch.zeros((B, H, L), device=dev)
    o = torch.zeros(q.shape, device=dev)
    for i in range(nb):
        kk, vv = kf[:, i * blk:(i + 1) * blk], vf[:, i * blk:(i + 1) * blk]
        k_pos = i * blk + torch.arange(blk, device=dev)
        mask = k_pos[None, :] < L  # the padded tail is never attended
        if causal:
            mask = mask & (q_pos[:, None] >= k_pos[None, :])
        else:
            mask = mask.expand(L, blk)
        m, l_acc, o = _block(qf, kk, vv, m, l_acc, o, scale, mask)
    l_acc = torch.clamp_min(l_acc, 1e-20)
    return o / l_acc.transpose(1, 2)[..., None]


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = False,
                      use_fused: Optional[bool] = None) -> torch.Tensor:
    """Sequence-parallel attention via the head/sequence all-to-all.

    q, k, v: ``[S, B, L_local, H, D]`` (shard ``i`` holds sequence block
    ``i``; in a mesh slot ``[1, ...]``, the slot's shard); needs ``H % S
    == 0``.  Returns them in q's shape and dtype."""
    shards, B, Lq, H, D = q.shape
    S = sp_axis_size(q)
    if H % S:
        raise ValueError(f"ulysses needs heads ({H}) divisible by the "
                         f"sequence axis size ({S})")
    if use_fused is None:
        from geomx_tpu_torch.ops.flash_attention import \
            fused_attention_supported
        use_fused = (fused_attention_supported() and D % 8 == 0
                     and _fused_block_aligned(Lq * S))
    # sequence shards -> head shards: [S, B, L, H/S, D]
    with sp_exchange_group():
        qa, ka, va = (all_to_all_sp(t, split_dim=-2, concat_dim=-3)
                      for t in (q, k, v))
    L, hs = Lq * S, H // S
    qa, ka, va = (t.reshape(shards * B, L, hs, D) for t in (qa, ka, va))
    if use_fused:
        from geomx_tpu_torch.ops.flash_attention import fused_attention
        out = fused_attention(qa, ka, va, causal)
    else:
        out = _streaming_attention(qa, ka, va, causal)
    # cast before the return trip (pure data movement), then head shards
    # -> sequence shards: [S, B, L_local, H, D]
    out = out.to(q.dtype).reshape(shards, B, L, hs, D)
    return all_to_all_sp(out, split_dim=-3, concat_dim=-2)
