"""The differentiable ring hop (port of geomx_tpu/parallel/_fused_block.py).

:func:`fused_block` runs one ring-attention hop through the CUDA kernel
of ``ops/ring_hop.py`` (its plain version on CPU tensors).  Its backward
is the autograd VJP of the plain ``ring_attention._block``, recomputed —
the reference's ``_fused_bwd`` does the same, and there is no backward
kernel.  That VJP materialises the hop's ``[B, H, Lq, Lk]`` scores.
Layouts: q/o ``[B, Lq, H, D]``, k/v ``[B, Lk, H, D]``, m/l_acc ``[B, H,
Lq]``, all carries fp32.
"""

from __future__ import annotations

import torch

from geomx_tpu_torch.ops.ring_hop import hop
from geomx_tpu_torch.parallel.collectives import attributed_to, current_slot
from geomx_tpu_torch.utils.profiler import span


def _plain_block(q, k, v, m, l_acc, o, scale, diag):
    from geomx_tpu_torch.parallel.ring_attention import _block
    mask = torch.tril(torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool,
                                 device=q.device)) if diag else None
    return _block(q, k, v, m, l_acc, o, scale, mask)


class _FusedBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, m, l_acc, o, scale, diag, block):
        ctx.save_for_backward(q, k, v, m, l_acc, o)
        ctx.scale, ctx.diag = scale, diag
        ctx.slot = current_slot()  # the backward's step is its
        return hop(q, k, v, m, l_acc, o, scale, diag, block)

    @staticmethod
    def backward(ctx, gm, gl, go):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with attributed_to(ctx.slot), span("attention/backward"), \
                torch.enable_grad():
            outs = _plain_block(*inputs, ctx.scale, ctx.diag)
            pairs = [(o_, g) for o_, g in zip(outs, (gm, gl, go))
                     if g is not None]
            grads = torch.autograd.grad([o_ for o_, _ in pairs],
                                        inputs, [g for _, g in pairs],
                                        allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for g, x in zip(grads, inputs)]
        return (*grads, None, None, None)


def fused_block(q, k, v, m, l_acc, o, scale: float, diag: bool,
                block: int = 128):
    """The fused hop with the plain ``_block``'s exact gradient."""
    return _FusedBlock.apply(q, k, v, m, l_acc, o, scale, diag, block)
