"""The arithmetic of the reference's products: the precision modes.

- ``"fp32"``: float32 with TF32 off, for matrix products and cuDNN
  convolutions alike: the reference proper.
- ``"tf32"``: every operand of a convolution or matrix product rounded to
  TF32 (10 mantissa bits, to nearest) on the way in, the products summed
  in float32: what the card's TF32 mode does, here on any device; the
  control of a float32 configuration (one step below float32 with TF32
  off).
- ``"fp8"``: every operand of a convolution or matrix product rounded to
  float8 e4m3 (per-tensor scale, amax to 448) on the way in, and the
  gradient of its result rounded to float8 e5m2 (amax to 57,344) on the
  way back; everything else float32: the control of a bfloat16
  configuration (one step below bfloat16).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

MODES = ("fp32", "tf32", "fp8")
E4M3_MAX = 448.0
E5M2_MAX = 57344.0


@contextlib.contextmanager
def arithmetic(mode: str):
    """TF32 off for every mode (the ``tf32`` mode rounds its operands
    itself); the process's settings restored after."""
    if mode not in MODES:
        raise ValueError(f"unknown precision mode {mode!r}")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _round8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return (x / scale).to(dtype).to(x.dtype) * scale


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _OperandTF32(torch.autograd.Function):
    """TF32 forward, the gradient passed straight through (the backward's
    products round their operands through ``_GradTF32``)."""

    @staticmethod
    def forward(ctx, x):
        return _round_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _GradTF32(torch.autograd.Function):
    """Identity forward, the incoming gradient rounded to TF32."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _round_tf32(g)


class _Operand8(torch.autograd.Function):
    """e4m3 forward, the gradient passed straight through."""

    @staticmethod
    def forward(ctx, x):
        return _round8(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return g


class _Grad8(torch.autograd.Function):
    """Identity forward, the incoming gradient rounded to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _round8(g, torch.float8_e5m2, E5M2_MAX)


def conv2d(x, w, mode: str, stride: int = 1, padding=0):
    if mode == "tf32":
        return _GradTF32.apply(F.conv2d(
            _OperandTF32.apply(x), _OperandTF32.apply(w), stride=stride,
            padding=padding))
    if mode == "fp8":
        return _Grad8.apply(F.conv2d(_Operand8.apply(x), _Operand8.apply(w),
                                     stride=stride, padding=padding))
    return F.conv2d(x, w, stride=stride, padding=padding)


def matmul(a, b, mode: str):
    if mode == "tf32":
        return _GradTF32.apply(torch.matmul(_OperandTF32.apply(a),
                                            _OperandTF32.apply(b)))
    if mode == "fp8":
        return _Grad8.apply(torch.matmul(_Operand8.apply(a),
                                         _Operand8.apply(b)))
    return torch.matmul(a, b)
