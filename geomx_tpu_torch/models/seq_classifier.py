"""Long-context sequence classifier with sequence-parallel attention (port
of geomx_tpu/models/seq_classifier.py).

A small pre-LayerNorm transformer encoder whose attention runs, per
``sp_mode``:

- ``None``      — full attention through the flash kernels
                  (``ops.flash_attention.fused_attention``): the un-meshed
                  twin the Trainer evaluates with;
- ``"ring"``    — ring attention over the sp shards
                  (``parallel/ring_attention.py``, the fused hop kernel);
- ``"ulysses"`` — the Ulysses all-to-alls around the flash kernels
                  (``parallel/ulysses.py``).

Parameters keep flax's names and layouts (``qkv`` a ``DenseGeneral``
kernel ``[D, 3, H, hd]`` with ``q, k, v = qkv[:, :, i]``, ``proj``
``[H hd, D]``, dense kernels ``[in, out]``), so ``models.convert.from_flax``
carries flax weights over as a rename.  ``nn.gelu`` is the tanh
approximation; ``LayerNorm`` is flax's (epsilon 1e-6, the variance as
``E[x^2] - E[x]^2`` clipped at 0, statistics and result in fp32); the
head computes in fp32.

Input: int32 tokens ``[B, L]``, or ``[B, L, 2]`` of (token, global
position).  An sp model (``sp_mode`` set) takes one replica's sequence
cut into ``S`` contiguous chunks and stacked on a leading sp dim: ``[S,
B, L/S]`` or ``[S, B, L/S, 2]`` (``train/step.py`` cuts them).  Without
positions each chunk embeds positions ``0 .. L/S - 1``, as each sp
device of the reference does; the Trainer always passes positions.

Sequence parallelism and the gradient.  In the JAX package each sp
device back-propagates its own shard: the pooled mean is completed with
a ``pmean`` over sp, ``_scale_bwd`` scales the replicated head's
cotangent by ``1/n``, and the step ``psum``s the gradients over sp.  In
the port one replica's ``S`` shards run in one autograd graph: the pool
is the mean of the equal-size chunk means (:func:`pmean_sp`), the logits
are computed once from it, and autograd of that graph is already the
true gradient — so the stacked form needs neither ``_scale_bwd`` nor
the psum (``tests/test_torch_seq.py`` holds it against the JAX sp step).
On a ``[P, W, S]`` device mesh each sp slot runs its own shard, as a
JAX sp device does: there the logits pass :class:`_ScaleBwd` (the
counterpart of ``_scale_bwd``, a cotangent scaled by ``1/S``) and the
step psums the gradients over sp (``train/step.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from geomx_tpu_torch.models.resnet import _variance_scaling_
from geomx_tpu_torch.ops.flash_attention import fused_attention
from geomx_tpu_torch.parallel.collectives import current_slot, pmean_sp
from geomx_tpu_torch.parallel.ring_attention import ring_attention
from geomx_tpu_torch.parallel.ulysses import ulysses_attention
from geomx_tpu_torch.tree import leaf_names

SP_MODES = (None, "ring", "ulysses")


class _ScaleBwd(torch.autograd.Function):
    """Identity forward; the backward scales the cotangent by ``s``: in an
    sp mesh slot the head downstream of the pooled ``pmean_sp`` sees the
    whole loss on every sp slot, and ``1/S`` keeps the step's psum over
    sp from counting it ``S`` times (the reference's ``_scale_bwd``)."""

    @staticmethod
    def forward(ctx, x, s: float):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


class Embed(nn.Module):
    """flax ``nn.Embed``: a ``[num, features]`` table (normal init, std
    ``features ** -0.5``), looked up and cast to ``dtype``."""

    def __init__(self, num: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.empty(num, features))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.embedding.normal_(0.0, self.embedding.shape[1] ** -0.5,
                                   generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids.long(), self.embedding).to(self.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm()`` over the last dim, computed in fp32."""

    def __init__(self, features: int, epsilon: float = 1e-6):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return (xf - mean) * mul + self.bias


class Dense(nn.Module):
    """flax ``nn.Dense`` / ``DenseGeneral``: an ``[in, *out]`` kernel
    (LeCun-normal over the flattened ``[in, prod(out)]``), optional zero
    bias, computed in ``dtype``."""

    def __init__(self, in_features: int, features, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.features = tuple(features) if isinstance(features, tuple) \
            else (features,)
        self.kernel = nn.Parameter(torch.empty(in_features, *self.features))
        self.bias = nn.Parameter(torch.empty(*self.features)) \
            if use_bias else None

    def reset_parameters(self, generator=None) -> None:
        _variance_scaling_(self.kernel, 1.0, self.kernel.shape[0], generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.kernel.to(self.dtype).reshape(self.kernel.shape[0], -1)
        y = x.to(self.dtype) @ w
        if self.bias is not None:
            y = y + self.bias.to(self.dtype).reshape(-1)
        return y.unflatten(-1, self.features)


class SPAttention(nn.Module):
    def __init__(self, num_heads: int, dim: int, sp_mode: Optional[str] = None,
                 causal: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        if sp_mode not in SP_MODES:
            raise ValueError(f"unknown sp_mode {sp_mode!r}")
        self.num_heads, self.sp_mode, self.causal = num_heads, sp_mode, causal
        self.head_dim = dim // num_heads
        self.qkv = Dense(dim, (3, num_heads, self.head_dim), use_bias=False,
                         dtype=dtype)
        self.proj = Dense(num_heads * self.head_dim, dim, use_bias=False,
                          dtype=dtype)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        """``h``: ``[B, L, D]``, or ``[S, B, L/S, D]`` on an sp mode."""
        # q, k, v [*, L, H, hd]: strided views of the projection
        q, k, v = self.qkv(h).unbind(-3)
        with record_function("attention/forward"):
            if self.sp_mode == "ring":
                out = ring_attention(q, k, v, causal=self.causal)
            elif self.sp_mode == "ulysses":
                out = ulysses_attention(q, k, v, causal=self.causal)
            else:
                out = fused_attention(q, k, v, self.causal)
        return self.proj(out.flatten(-2))


class SeqClassifier(nn.Module):
    """Tiny encoder for sequence classification at long context."""

    def __init__(self, vocab: int = 256, max_len: int = 4096, dim: int = 64,
                 num_heads: int = 4, num_layers: int = 2,
                 num_classes: int = 10, sp_mode: Optional[str] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.sp_mode = sp_mode
        self.dtype = dtype
        self.num_layers = num_layers
        self.tok_embed = Embed(vocab, dim, dtype)
        self.pos_embed = Embed(max_len, dim, dtype)
        for i in range(num_layers):
            setattr(self, f"ln_a{i}", LayerNorm(dim))
            setattr(self, f"attn{i}", SPAttention(num_heads, dim, sp_mode,
                                                  dtype=dtype))
            setattr(self, f"ln_m{i}", LayerNorm(dim))
            setattr(self, f"mlp_in{i}", Dense(dim, dim * 4, dtype=dtype))
            setattr(self, f"mlp_out{i}", Dense(dim * 4, dim, dtype=dtype))
        self.ln_f = LayerNorm(dim)
        self.head = Dense(dim, num_classes)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        """flax's initializers, drawn from ``generator`` in the JAX
        package's leaf order (the draws differ from ``jax.random``'s:
        tests convert flax weights instead of comparing inits)."""
        modules = dict(self.named_modules())
        owners = sorted({name.rsplit(".", 1)[0]
                         for name, _ in self.named_parameters()},
                        key=lambda s: s.split("."))
        for name in owners:
            modules[name].reset_parameters(generator)

    def param_names(self):
        """Parameter paths in the JAX package's leaf order."""
        return leaf_names(dict(self.named_parameters()))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        sp = self.sp_mode is not None
        if x.dim() == (4 if sp else 3):   # (token, global position)
            tokens, pos = x[..., 0], x[..., 1]
        else:                             # positions 0 .. L - 1 a sequence
            tokens = x
            pos = torch.arange(x.shape[-1], device=x.device).expand(x.shape)
        h = self.tok_embed(tokens) + self.pos_embed(pos)
        for i in range(self.num_layers):
            a = getattr(self, f"ln_a{i}")(h)
            h = h + getattr(self, f"attn{i}")(a)
            m = getattr(self, f"mlp_in{i}")(getattr(self, f"ln_m{i}")(h))
            h = h + getattr(self, f"mlp_out{i}")(
                F.gelu(m, approximate="tanh"))
        pooled = self.ln_f(h).mean(dim=-2)
        if sp:
            # the mean of the equal-size chunk means: the global mean
            pooled = pmean_sp(pooled)[0]
        logits = self.head(pooled.float()).float()
        slot = current_slot() if sp else None
        if slot is not None and torch.is_grad_enabled():
            logits = _ScaleBwd.apply(logits, 1.0 / slot.S)
        return logits

