"""Flash attention forward and backward (port of
geomx_tpu/ops/flash_attention.py).

Three kernels of the attention path, each a hand-written CUDA kernel for
Hopper (``csrc/flash_attention.cu``) on CUDA tensors and a plain PyTorch
version on CPU tensors:

- :func:`flash_attention_with_lse` — the online-softmax forward with
  ``-1e30`` masking (keys past ``kv_len``, the causal triangle), ``l =
  max(l, 1e-20)`` so fully-masked rows give 0, not NaN, and the per-row
  logsumexp ``lse = m + log(l)`` ``[B, H, L]`` fp32 (``with_lse=False``,
  the inference variant :func:`flash_attention`, writes none);
- :func:`flash_dq` — the backward's dq: ``p = exp(s - lse)`` masked,
  ``ds = p * (dO V^T - delta)``, ``dq = sum_k ds K * scale``;
- :func:`flash_dkv` — the backward's dk/dv: ``dk = sum_q ds^T Q *
  scale``, ``dv = sum_q p^T dO``.

:func:`fused_attention` is the differentiable entry point: its forward
writes the logsumexp only when a gradient is needed, and its backward
computes ``delta = rowsum(dO * O)`` in PyTorch ops (the JAX package does
the same) and launches the dq and dk/dv kernels, so the ``[L, L]`` score
matrix never exists in device memory in either direction.
``GEOMX_FLASH_ATTN=0`` (the reference's switch) routes it to the dense
PyTorch reference instead.

The public layout is the JAX package's ``[B, L, H, D]``; the kernels read
it in place through its strides (the head dim contiguous), so the
``q``/``k``/``v`` slices of a fused projection need no copy.  The
lane-replicated ``[BH, L, 128]`` logsumexp of the TPU kernels is a TPU
tiling artifact: the port's ``lse`` and ``delta`` are ``[B, H, L]``
fp32.  Inputs are fp32 or bf16; every sum is fp32; outputs are in q's
dtype (forward) and fp32 (gradients).  The kernels take head dims
:data:`HEAD_DIMS` and any multiple of 128 above them (each block then
owns one 128-wide chunk of its output and streams the scores' depth in
chunks); the wrappers run any other head dim by zero-padding the
operands to the next of those (:func:`kernel_dim`) with the true dim's
scale, and slicing the outputs back: zero columns add nothing to ``q
k^T`` and give zero output columns, so the padding is exact.  The
plain versions follow the Pallas kernels' operations tile by tile over
the key (or query) dim, with the same sentinel and floor; the kernels
sum in another order, so the two agree to fp32 tolerance, not bit for
bit.

Each wrapper counts its kernel launches in ``launches``;
``flash_attention.launches`` counts the no-lse variant among
``flash_attention_with_lse.launches``.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import torch
from torch.profiler import record_function

from geomx_tpu_torch.ops.bucket import on_cuda

NEG_INF = -1e30  # large-but-finite: -inf breaks the m-correction exp
HEAD_DIMS = (8, 16, 32, 64, 128)  # head dims the kernels are built for
WIDE_CHUNK = HEAD_DIMS[-1]  # above it: multiples of it, chunked over the grid
BLOCK = 128  # the Pallas kernels' default tile; the plain versions' tile


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q, k, v must be [B, L, H, D] with k and v alike; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if (q.shape[0], q.shape[2], q.shape[3]) != (k.shape[0], k.shape[2],
                                                k.shape[3]):
        raise ValueError("q and k/v differ in batch, heads or head dim")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
            torch.float32, torch.bfloat16):
        raise ValueError(f"q, k, v must share one dtype, fp32 or bf16; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")


def kernel_dim(D: int) -> int:
    """The head dim the kernels run a ``D``-wide head at: the narrowest
    of :data:`HEAD_DIMS` that holds it, and above the widest the next
    multiple of it (:data:`WIDE_CHUNK`), which the kernels split into
    output chunks over their grid."""
    if D < 1:
        raise ValueError(f"head dim must be positive, got {D}")
    for d in HEAD_DIMS:
        if D <= d:
            return d
    return -(-D // WIDE_CHUNK) * WIDE_CHUNK


def kernel_operand(x: torch.Tensor) -> torch.Tensor:
    """A ``[B, L, H, D]`` CUDA operand as the kernels take it: any
    strides with the head dim contiguous (else a contiguous copy), and
    zero columns up to :func:`kernel_dim` where ``D`` is not built."""
    D = x.shape[-1]
    if D != kernel_dim(D):
        return torch.nn.functional.pad(x, (0, kernel_dim(D) - D))
    return x if x.stride(-1) == 1 else x.contiguous()


def _heads_first(x: torch.Tensor) -> torch.Tensor:
    """[B, L, H, D] -> [B, H, L, D] fp32 (a view for fp32 inputs)."""
    return x.float().permute(0, 2, 1, 3)


def _scale(D: int) -> float:
    return 1.0 / float(math.sqrt(D))


# ---- plain versions ---------------------------------------------------------

def flash_attention_with_lse_plain(q, k, v, causal: bool = False,
                                   with_lse: bool = True,
                                   block_k: int = BLOCK):
    """The forward as ``_fa_kernel`` computes it, one key tile of
    ``min(block_k, Lk)`` at a time (all query rows at once: a tile wholly
    in a row's future leaves its state unchanged, so the Pallas kernel's
    tile skipping changes nothing here)."""
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    scale = _scale(D)
    qh, kh, vh = _heads_first(q), _heads_first(k), _heads_first(v)
    dev = q.device
    bk = max(1, min(block_k, Lk))
    rows = torch.arange(Lq, device=dev)[:, None]
    m = torch.full((B, H, Lq, 1), NEG_INF, device=dev)
    l_acc = torch.zeros((B, H, Lq, 1), device=dev)
    acc = torch.zeros((B, H, Lq, D), device=dev)
    for k0 in range(0, Lk, bk):
        kt, vt = kh[:, :, k0:k0 + bk], vh[:, :, k0:k0 + bk]
        s = torch.matmul(qh, kt.transpose(-1, -2)) * scale
        mask = None
        if causal:
            cols = k0 + torch.arange(kt.shape[2], device=dev)[None, :]
            mask = cols <= rows
            s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        if mask is not None:
            # exp(NEG_INF - m) underflows, but a fully-masked row has
            # m_new = NEG_INF where it would not
            p = torch.where(mask, p, 0.0)
        corr = torch.exp(m - m_new)
        l_acc = l_acc * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.matmul(p, vt)
        m = m_new
    l_sum = torch.clamp_min(l_acc, 1e-20)  # fully-masked rows -> 0 out
    out = (acc / l_sum).to(q.dtype).permute(0, 2, 1, 3)
    lse = (m + torch.log(l_sum)).squeeze(-1) if with_lse else None
    return out, lse


def _bwd_mask(rows, cols, Lq, Lk, causal):
    mask = (rows < Lq) & (cols < Lk)
    return mask & (cols <= rows) if causal else mask


def flash_dq_plain(q, k, v, do, lse, delta, causal: bool = False,
                   block_k: int = BLOCK) -> torch.Tensor:
    """dq as ``_dq_kernel`` computes it, one key tile at a time:
    ``[B, Lq, H, D]`` fp32."""
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    scale = _scale(D)
    qh, kh, vh, doh = (_heads_first(t) for t in (q, k, v, do))
    lse_, delta_ = lse.float()[..., None], delta.float()[..., None]
    dev = q.device
    bk = max(1, min(block_k, Lk))
    rows = torch.arange(Lq, device=dev)[:, None]
    acc = torch.zeros((B, H, Lq, D), device=dev)
    for k0 in range(0, Lk, bk):
        kt, vt = kh[:, :, k0:k0 + bk], vh[:, :, k0:k0 + bk]
        cols = k0 + torch.arange(kt.shape[2], device=dev)[None, :]
        s = torch.matmul(qh, kt.transpose(-1, -2)) * scale
        mask = _bwd_mask(rows, cols, Lq, Lk, causal)
        p = torch.where(mask, torch.exp(s - lse_), 0.0)
        dp = torch.matmul(doh, vt.transpose(-1, -2))
        ds = p * (dp - delta_)
        acc = acc + torch.matmul(ds, kt) * scale
    return acc.permute(0, 2, 1, 3)


def flash_dkv_plain(q, k, v, do, lse, delta, causal: bool = False,
                    block_q: int = BLOCK):
    """(dk, dv) as ``_dkv_kernel`` computes them, one query tile at a
    time: each ``[B, Lk, H, D]`` fp32."""
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    scale = _scale(D)
    qh, kh, vh, doh = (_heads_first(t) for t in (q, k, v, do))
    lse_, delta_ = lse.float()[..., None], delta.float()[..., None]
    dev = q.device
    bq = max(1, min(block_q, Lq))
    cols = torch.arange(Lk, device=dev)[None, :]
    dk = torch.zeros((B, H, Lk, D), device=dev)
    dv = torch.zeros((B, H, Lk, D), device=dev)
    for q0 in range(0, Lq, bq):
        qt, dot = qh[:, :, q0:q0 + bq], doh[:, :, q0:q0 + bq]
        rows = q0 + torch.arange(qt.shape[2], device=dev)[:, None]
        s = torch.matmul(qt, kh.transpose(-1, -2)) * scale
        mask = _bwd_mask(rows, cols, Lq, Lk, causal)
        p = torch.where(mask, torch.exp(s - lse_[:, :, q0:q0 + bq]), 0.0)
        dp = torch.matmul(dot, vh.transpose(-1, -2))
        ds = p * (dp - delta_[:, :, q0:q0 + bq])
        dk = dk + torch.matmul(ds.transpose(-1, -2), qt) * scale
        dv = dv + torch.matmul(p.transpose(-1, -2), dot)
    return dk.permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3)


# ---- kernel wrappers --------------------------------------------------------

def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = False,
                             with_lse: bool = True
                             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Fused attention forward: ``(out [B, Lq, H, D] in q's dtype, lse
    [B, H, Lq] fp32 or None)``.  ``with_lse=False`` (the inference path)
    writes no logsumexp."""
    _check_qkv(q, k, v)
    if not on_cuda([q, k, v]):
        return flash_attention_with_lse_plain(q, k, v, causal, with_lse)
    from geomx_tpu_torch.ops._build import kernels
    B, Lq, H, D = q.shape
    out = torch.empty((B, Lq, H, kernel_dim(D)), dtype=q.dtype,
                      device=q.device)
    lse = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    kernels().flash_fwd(kernel_operand(q), kernel_operand(k),
                        kernel_operand(v), causal, _scale(D), out, lse)
    flash_attention_with_lse.launches += 1
    if not with_lse:
        flash_attention.launches += 1
    return out[..., :D], lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Attention forward without the logsumexp: softmax(QK^T / sqrt(D)) V,
    ``[B, Lq, H, D]`` in q's dtype.  Differentiate
    :func:`fused_attention`, not this."""
    return flash_attention_with_lse(q, k, v, causal, with_lse=False)[0]


def attention_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dO * O)`` as ``[B, H, L]`` fp32 — cheap
    elementwise work, left to PyTorch ops as the JAX package leaves it to
    XLA."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _check_bwd(q, k, v, do, lse, delta):
    _check_qkv(q, k, v)
    B, Lq, H, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError("dO must match q in shape and dtype")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B, H, Lq):
            raise ValueError(f"{name} must be [B, H, Lq] = {(B, H, Lq)}, "
                             f"got {tuple(t.shape)}")


def flash_dq(q, k, v, do, lse, delta, causal: bool = False) -> torch.Tensor:
    """The flash backward's dq, ``[B, Lq, H, D]`` fp32."""
    _check_bwd(q, k, v, do, lse, delta)
    if not on_cuda([q, k, v, do, lse, delta]):
        return flash_dq_plain(q, k, v, do, lse, delta, causal)
    from geomx_tpu_torch.ops._build import kernels
    D = q.shape[-1]
    dq = torch.empty((*q.shape[:-1], kernel_dim(D)), dtype=torch.float32,
                     device=q.device)
    kernels().flash_bwd_dq(
        kernel_operand(q), kernel_operand(k), kernel_operand(v),
        kernel_operand(do), lse.float().contiguous(),
        delta.float().contiguous(), causal, _scale(D), dq)
    flash_dq.launches += 1
    return dq[..., :D]


def flash_dkv(q, k, v, do, lse, delta, causal: bool = False):
    """The flash backward's (dk, dv), each ``[B, Lk, H, D]`` fp32."""
    _check_bwd(q, k, v, do, lse, delta)
    if not on_cuda([q, k, v, do, lse, delta]):
        return flash_dkv_plain(q, k, v, do, lse, delta, causal)
    from geomx_tpu_torch.ops._build import kernels
    D = q.shape[-1]
    shape = (*k.shape[:-1], kernel_dim(D))
    dk = torch.empty(shape, dtype=torch.float32, device=k.device)
    dv = torch.empty(shape, dtype=torch.float32, device=v.device)
    kernels().flash_bwd_dkv(
        kernel_operand(q), kernel_operand(k), kernel_operand(v),
        kernel_operand(do), lse.float().contiguous(),
        delta.float().contiguous(), causal, _scale(D), dk, dv)
    flash_dkv.launches += 1
    return dk[..., :D], dv[..., :D]


def flash_attention_bwd(q, k, v, out, lse, do, causal: bool = False):
    """Flash backward: ``(dq, dk, dv)`` fp32, ``p`` recomputed per tile
    from the forward's logsumexp."""
    delta = attention_delta(out, do)
    dq = flash_dq(q, k, v, do, lse, delta, causal)
    dk, dv = flash_dkv(q, k, v, do, lse, delta, causal)
    return dq, dk, dv


flash_attention_with_lse.launches = 0
flash_attention.launches = 0
flash_dq.launches = 0
flash_dkv.launches = 0


# ---- the differentiable entry point -----------------------------------------

def fused_attention_supported() -> bool:
    """True unless ``GEOMX_FLASH_ATTN=0`` (the reference's switch) forces
    the dense path.  On the kernel path a CUDA tensor launches the
    kernels and a CPU tensor runs their plain versions."""
    return os.environ.get("GEOMX_FLASH_ATTN", "1") != "0"


def _dense(q, k, v, causal):
    """fp32 dense attention through ``full_attention_reference``."""
    from geomx_tpu_torch.parallel.ring_attention import \
        full_attention_reference
    return full_attention_reference(q.float(), k.float(), v.float(),
                                    causal=causal).to(q.dtype)


class _FusedAttention(torch.autograd.Function):
    """Flash in both directions: the forward saves the logsumexp, the
    backward recomputes ``p`` per tile from it."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_attention_with_lse(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        with record_function("attention/backward"):
            dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                             g.contiguous(), ctx.causal)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Differentiable attention over ``[B, L, H, D]``: the flash kernels
    (their plain versions on CPU tensors), or with ``GEOMX_FLASH_ATTN=0``
    the dense reference.  Without a gradient to compute, the forward
    writes no logsumexp."""
    if not fused_attention_supported():
        return _dense(q, k, v, causal)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FusedAttention.apply(q, k, v, causal)
    return flash_attention(q, k, v, causal)
