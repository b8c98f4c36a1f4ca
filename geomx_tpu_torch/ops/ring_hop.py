"""One fused ring-attention hop (port of the kernel half of
geomx_tpu/parallel/_fused_block.py).

A ring hop updates the streaming-softmax state ``(m, l_acc, o)`` of the
local Q block with its attention against the K/V block currently held —
``parallel.ring_attention._block`` in PyTorch ops.  :func:`hop` is that
single hop as one launch of the hand-written CUDA kernel of
``csrc/ring_hop.cu`` on CUDA tensors (its plain version :func:`hop_plain`,
which follows the Pallas ``_hop_kernel`` tile by tile, on CPU tensors):
the carries come in and go out updated, ``o`` stays un-normalised, and the
``[Lq, Lk]`` scores never reach device memory.

Mask modes: ``diag=False`` attends to the whole K/V block, ``diag=True``
is the causal diagonal block (lower-triangular, ``-1e30`` masking, tiles
wholly in the future skipped).  A hop seeded with ``m = -inf`` (the
ring's first) gets ``corr = exp(-inf - m_new) = 0``, never NaN: the
running max of a processed tile starts at the ``-1e30`` sentinel.

Layouts as in the JAX package: q/o ``[B, Lq, H, D]``, k/v ``[B, Lk, H,
D]``, m/l_acc ``[B, H, Lq]``; the in-process ring puts its sp shards in
``B``, so one launch covers every shard of a hop.  ``hop.launches``
counts kernel launches.  The differentiable hop is
``parallel._fused_block.fused_block``.
"""

from __future__ import annotations

import torch

from geomx_tpu_torch.ops.bucket import on_cuda
from geomx_tpu_torch.ops.flash_attention import (NEG_INF, kernel_dim,
                                                  kernel_operand)


def _check(q, k, v, m, l_acc, o, block):
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    if k.shape != (B, Lk, H, D) or v.shape != k.shape or o.shape != q.shape:
        raise ValueError("hop operands: q/o [B, Lq, H, D], k/v [B, Lk, H, D]")
    if m.shape != (B, H, Lq) or l_acc.shape != (B, H, Lq):
        raise ValueError("hop carries m, l_acc must be [B, H, Lq]")
    bq, bk = min(block, Lq), min(block, Lk)
    if Lq % bq or Lk % bk:
        raise ValueError(f"ring block sizes must tile L ({Lq}, {Lk}) by "
                         f"{block}")


def hop_plain(q, k, v, m, l_acc, o, scale: float, diag: bool,
              block: int = 128):
    """``_hop_kernel``'s update, one key tile of ``min(block, Lk)`` at a
    time; in ``diag`` mode a query block (``min(block, Lq)`` rows) leaves
    a tile wholly in its future untouched, as the Pallas grid does."""
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    dev = q.device
    bq, bk = min(block, Lq), min(block, Lk)
    qh = q.float().permute(0, 2, 1, 3)
    kh = k.float().permute(0, 2, 1, 3)
    vh = v.float().permute(0, 2, 1, 3)
    m_, l_ = m.float()[..., None], l_acc.float()[..., None]
    acc = o.float().permute(0, 2, 1, 3)
    rows = torch.arange(Lq, device=dev)[:, None]
    for k0 in range(0, Lk, bk):
        kt, vt = kh[:, :, k0:k0 + bk], vh[:, :, k0:k0 + bk]
        s = torch.matmul(qh, kt.transpose(-1, -2)) * scale
        if diag:
            cols = k0 + torch.arange(bk, device=dev)[None, :]
            mask = cols <= rows
            s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m_, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        if diag:
            p = torch.where(mask, p, 0.0)
        corr = torch.exp(m_ - m_new)
        l_new = l_ * corr + p.sum(-1, keepdim=True)
        acc_new = acc * corr + torch.matmul(p, vt)
        if diag:
            # the grid runs this tile for a query block only where some
            # column is at or below the block's last row
            run = k0 <= (rows // bq) * bq + bq - 1
            m_new = torch.where(run, m_new, m_)
            l_new = torch.where(run, l_new, l_)
            acc_new = torch.where(run, acc_new, acc)
        m_, l_, acc = m_new, l_new, acc_new
    return m_[..., 0], l_[..., 0], acc.permute(0, 2, 1, 3)


def hop(q, k, v, m, l_acc, o, scale: float, diag: bool, block: int = 128):
    """One ring hop: the updated ``(m, l_acc, o)``, all fp32.  q/k/v are
    fp32 or bf16 (the ring passes fp32)."""
    _check(q, k, v, m, l_acc, o, block)
    if not on_cuda([q, k, v, m, l_acc, o]):
        return hop_plain(q, k, v, m, l_acc, o, scale, diag, block)
    from geomx_tpu_torch.ops._build import kernels
    D = q.shape[-1]
    m_o, l_o = torch.empty_like(m, dtype=torch.float32), \
        torch.empty_like(l_acc, dtype=torch.float32)
    o_o = torch.empty((*o.shape[:-1], kernel_dim(D)), dtype=torch.float32,
                      device=o.device)
    kernels().ring_hop(kernel_operand(q), kernel_operand(k),
                       kernel_operand(v), m.float().contiguous(),
                       l_acc.float().contiguous(),
                       kernel_operand(o.float()).contiguous(),
                       diag, float(scale), m_o, l_o, o_o)
    hop.launches += 1
    return m_o, l_o, o_o[..., :D]


hop.launches = 0
