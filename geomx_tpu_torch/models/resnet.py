"""ResNet family for the flagship CIFAR-10 benchmark (port of
geomx_tpu/models/resnet.py).

CIFAR-style ResNet-20/32/56 (He et al. 2016, section 4.2), the
ResNet-18 widths and ResNet-20's space-to-depth variant
(``get_model("resnet20_s2d")``: the 2x2 space-to-depth stem and
transition shortcuts), computed the way the flax model computes them, so that
converted flax weights give the same logits:

- Parameters keep flax's names and layouts: conv kernels are HWIO,
  dense kernels ``[in, out]``.  ``forward`` permutes per call, so each
  gradient is a contiguous tensor in flax layout — a plain 1-D view for
  the bucket flatten kernel, at the offset the JAX bucketer gives it.
- ``padding="SAME"`` follows XLA: at stride 2 on an even input it pads
  ``(0, 1)``, not ``(1, 1)`` (explicit ``F.pad``).
- BatchNorm is written out (``BatchNorm`` below): fp32 statistics with
  the fast variance ``E[x^2] - E[x]^2`` clipped at 0, the *biased*
  variance stored, running averages with ``momentum=0.9``.  The second
  BN of each block starts at zero scale.
- Mixed precision casts per layer as flax does: with ``dtype=bf16`` the
  convolutions run in bf16 from fp32 parameters, BatchNorm reduces in
  fp32 and returns bf16, the pooled features round to bf16, and the
  dense head computes in fp32.  ``torch.autocast`` has a different
  policy and is not used.

Convolutions stay ``F.conv2d`` (cuDNN): the JAX package leaves them to
XLA, not to Pallas.  Activations are NHWC at the model's boundary and
run as channels-last NCHW views inside.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from geomx_tpu_torch.tree import leaf_names

_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's ``SAME`` padding (low, high) for one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _variance_scaling_(t: torch.Tensor, scale: float, fan_in: int,
                       generator: Optional[torch.Generator]) -> None:
    """flax ``variance_scaling(scale, "fan_in", "truncated_normal")``."""
    std = (scale / fan_in) ** 0.5 / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
        t.mul_(std)


class Conv(nn.Module):
    """flax ``nn.Conv(use_bias=False, padding="SAME")`` with an HWIO
    kernel (He-normal init)."""

    def __init__(self, in_features: int, features: int, kernel: int,
                 stride: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride = stride
        self.dtype = dtype
        self.kernel = nn.Parameter(
            torch.empty(kernel, kernel, in_features, features))

    def reset_parameters(self, generator=None) -> None:
        kh, kw, cin, _ = self.kernel.shape
        _variance_scaling_(self.kernel, 2.0, kh * kw * cin, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel.shape[0]
        x = x.to(self.dtype)
        w = self.kernel.to(self.dtype).permute(3, 2, 0, 1)   # HWIO -> OIHW
        ph = same_padding(x.shape[2], k, self.stride)
        pw = same_padding(x.shape[3], k, self.stride)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            return F.conv2d(x, w, stride=self.stride, padding=(ph[0], pw[0]))
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return F.conv2d(x, w, stride=self.stride)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over NCHW
    channels, statistics in fp32, result in ``dtype``."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32,
                 momentum: float = 0.9, epsilon: float = 1e-5,
                 zero_scale: bool = False):
        super().__init__()
        self.dtype = dtype
        self.momentum = momentum
        self.epsilon = epsilon
        self.zero_scale = zero_scale
        self.scale = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.scale.fill_(0.0 if self.zero_scale else 1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if train:
            xf = x.float()
            dims = (0, 2, 3)
            mean = xf.mean(dim=dims)
            mean2 = (xf * xf).mean(dim=dims)
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            with torch.no_grad():
                # the running averages the train step hands back as the
                # replica's new batch_stats (flax's mutable collection)
                self.mean.copy_(self.momentum * self.mean
                                + (1 - self.momentum) * mean)
                self.var.copy_(self.momentum * self.var
                               + (1 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        shape = (1, -1, 1, 1)
        y = x.float() - mean.view(shape)
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        y = y * mul.view(shape)
        y = y + self.bias.view(shape)
        return y.to(self.dtype)


class Dense(nn.Module):
    """flax ``nn.Dense`` at fp32: ``[in, out]`` kernel (LeCun-normal
    init), zero bias."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.empty(features))

    def reset_parameters(self, generator=None) -> None:
        _variance_scaling_(self.kernel, 1.0, self.kernel.shape[0], generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.float() @ self.kernel + self.bias


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """NHWC space-to-depth, ``[B, H, W, C] -> [B, H/b, W/b, C*b*b]``: the
    JAX package's reshape and transpose order exactly (channel ``(dy *
    b + dx) * C + c``)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // block, block, w // block, block, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(
        b, h // block, w // block, c * block * block)


def _space_to_depth_nchw(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """:func:`space_to_depth` of an NCHW view, as an NCHW view."""
    return space_to_depth(x.permute(0, 2, 3, 1), block).permute(0, 3, 1, 2)


class BasicBlock(nn.Module):
    """flax ``BasicBlock``.  ``s2d_shortcut``: the transition shortcut of
    ``mxu_shortcut`` (stride 2, even H and W) -- space-to-depth and an
    unstrided 1x1 projection over ``4 * in_features`` channels."""

    def __init__(self, in_features: int, filters: int, strides: int = 1,
                 dtype: torch.dtype = torch.float32,
                 s2d_shortcut: bool = False):
        super().__init__()
        self.Conv_0 = Conv(in_features, filters, 3, strides, dtype)
        self.BatchNorm_0 = BatchNorm(filters, dtype)
        self.Conv_1 = Conv(filters, filters, 3, 1, dtype)
        self.BatchNorm_1 = BatchNorm(filters, dtype, zero_scale=True)
        # the projection shortcut exists where the residual's shape
        # changes (flax: ``residual.shape != y.shape``)
        self.project = in_features != filters or strides != 1
        self.s2d_shortcut = self.project and s2d_shortcut
        if self.s2d_shortcut:
            self.Conv_2 = Conv(4 * in_features, filters, 1, 1, dtype)
            self.BatchNorm_2 = BatchNorm(filters, dtype)
        elif self.project:
            self.Conv_2 = Conv(in_features, filters, 1, strides, dtype)
            self.BatchNorm_2 = BatchNorm(filters, dtype)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        residual = x
        y = self.Conv_0(x)
        y = torch.relu(self.BatchNorm_0(y, train))
        y = self.Conv_1(y)
        y = self.BatchNorm_1(y, train)
        if self.s2d_shortcut:
            residual = _space_to_depth_nchw(residual)
        if self.project:
            residual = self.BatchNorm_2(self.Conv_2(residual), train)
        return torch.relu(y + residual)


class ResNet(nn.Module):
    """flax ``ResNet(stage_sizes, stage_filters)``.  ``forward`` takes
    NHWC float images.

    ``stem_space_to_depth`` folds a 2x2 space-to-depth into the 3x3 stem
    (every stage at half resolution); ``mxu_shortcuts`` takes the
    space-to-depth transition shortcuts wherever a stride-2 block's input
    has even H and W.  The stem's input channels, and with
    ``mxu_shortcuts`` the shortcuts' form, depend on the input: the model
    is built for ``(32, 32, in_channels)`` and :meth:`build` re-sizes it
    for another sample shape, as flax's ``init`` sizes it from the
    sample."""

    def __init__(self, stage_sizes: Sequence[int],
                 stage_filters: Sequence[int], num_classes: int = 10,
                 dtype: torch.dtype = torch.float32, in_channels: int = 3,
                 stem_kernel: int = 3, stem_space_to_depth: bool = False,
                 mxu_shortcuts: bool = False):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.stage_filters = tuple(stage_filters)
        self.num_classes = num_classes
        self.dtype = dtype
        self.stem_kernel = stem_kernel
        self.stem_space_to_depth = stem_space_to_depth
        self.mxu_shortcuts = mxu_shortcuts
        self.input_shape = None
        self.build((32, 32, in_channels))

    def _layout(self, input_shape):
        """What the layers depend on: the stem's input channels and the
        blocks that take the space-to-depth shortcut."""
        h, w, c = input_shape
        if self.stem_space_to_depth:
            h, w, c = h // 2, w // 2, 4 * c
        s2d = []
        for stage, num_blocks in enumerate(self.stage_sizes):
            for block in range(num_blocks):
                strides = 2 if stage > 0 and block == 0 else 1
                s2d.append(self.mxu_shortcuts and strides == 2
                           and h % 2 == 0 and w % 2 == 0)
                h, w = -(-h // strides), -(-w // strides)
        return c, tuple(s2d)

    def build(self, input_shape) -> None:
        """Size the layers for one sample's ``(H, W, C)``; a no-op when
        the layers already fit it."""
        input_shape = tuple(int(d) for d in input_shape)
        layout = self._layout(input_shape)
        if self.input_shape is not None and \
                layout == self._layout(self.input_shape):
            self.input_shape = input_shape
            return
        cin, s2d = layout
        filters0 = self.stage_filters[0]
        self.Conv_0 = Conv(cin, filters0, self.stem_kernel, 1, self.dtype)
        self.BatchNorm_0 = BatchNorm(filters0, self.dtype)
        cin = filters0
        i = 0
        for stage, (num_blocks, filters) in enumerate(
                zip(self.stage_sizes, self.stage_filters)):
            for block in range(num_blocks):
                strides = 2 if stage > 0 and block == 0 else 1
                setattr(self, f"BasicBlock_{i}",
                        BasicBlock(cin, filters, strides, self.dtype,
                                   s2d_shortcut=s2d[i]))
                cin = filters
                i += 1
        self.num_blocks = i
        self.Dense_0 = Dense(cin, self.num_classes)
        self.input_shape = input_shape
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
        x = x.to(self.dtype)
        if self.stem_space_to_depth:
            x = space_to_depth(x, 2)
        x = x.permute(0, 3, 1, 2)                      # NHWC -> NCHW view
        x = self.Conv_0(x)
        x = torch.relu(self.BatchNorm_0(x, train))
        for i in range(self.num_blocks):
            x = getattr(self, f"BasicBlock_{i}")(x, train)
        # jnp.mean over H, W reduces in fp32 and rounds to the compute dtype
        x = x.mean(dim=(2, 3), dtype=torch.float32).to(self.dtype)
        return self.Dense_0(x).float()


def ResNet20(num_classes: int = 10, dtype=torch.bfloat16,
             space_to_depth: bool = False,
             mxu_shortcuts: bool = False) -> ResNet:
    return ResNet((3, 3, 3), (16, 32, 64), num_classes, dtype,
                  stem_space_to_depth=space_to_depth,
                  mxu_shortcuts=mxu_shortcuts)


def ResNet32(num_classes: int = 10, dtype=torch.bfloat16) -> ResNet:
    return ResNet((5, 5, 5), (16, 32, 64), num_classes, dtype)


def ResNet56(num_classes: int = 10, dtype=torch.bfloat16) -> ResNet:
    return ResNet((9, 9, 9), (16, 32, 64), num_classes, dtype)


def ResNet18(num_classes: int = 10, dtype=torch.bfloat16) -> ResNet:
    return ResNet((2, 2, 2, 2), (64, 128, 256, 512), num_classes, dtype)
