"""flax layers with bias, as the dense zoo models use them (the port's
counterparts of ``nn.Conv``, ``nn.Dense`` and ``nn.max_pool`` in
geomx_tpu/models/cnn.py and mlp.py).

- Parameters keep flax's names and layouts: ``kernel`` (HWIO for a
  convolution, ``[in, out]`` for a dense layer) and ``bias``, so that
  ``models.convert.from_flax`` carries weights across unchanged.
- Initializers: ``xavier_uniform`` kernels (flax's
  ``variance_scaling(1, "fan_avg", "uniform")``, the receptive field
  counted in both fans) and zero biases.
- ``dtype`` follows flax's ``promote_dtype``: ``None`` computes in the
  input's type promoted with the fp32 parameters; a dtype casts the
  input, the kernel and the bias to it, and the layer computes and
  returns that dtype.
- Convolutions are ``padding="SAME"`` as XLA pads; pooling is flax's
  ``max_pool(window, strides=window)``, VALID.  They run on NCHW views;
  the models keep NHWC at their boundary and flatten in NHWC order (H,
  W, C), as a flax ``reshape`` does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from geomx_tpu_torch.models.resnet import same_padding


def xavier_uniform_(t: torch.Tensor, fan_in: int, fan_out: int,
                    generator: Optional[torch.Generator]) -> None:
    """flax ``xavier_uniform()``: U(-a, a), a = sqrt(6 / (fan_in +
    fan_out))."""
    limit = (6.0 / (fan_in + fan_out)) ** 0.5
    with torch.no_grad():
        t.uniform_(-limit, limit, generator=generator)


def _promote(x: torch.Tensor, dtype: Optional[torch.dtype], *params):
    """flax ``promote_dtype``: everything cast to ``dtype``, or to the
    common type of the input and the parameters when it is None."""
    if dtype is None:
        dtype = torch.promote_types(x.dtype, params[0].dtype)
    return (x.to(dtype),) + tuple(p.to(dtype) for p in params)


class BiasConv(nn.Module):
    """flax ``nn.Conv(features, (k, k), padding="SAME")`` with a bias,
    over NCHW views."""

    def __init__(self, in_features: int, features: int, kernel: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(
            torch.empty(kernel, kernel, in_features, features))
        self.bias = nn.Parameter(torch.empty(features))

    def reset_parameters(self, generator=None) -> None:
        kh, kw, cin, cout = self.kernel.shape
        xavier_uniform_(self.kernel, kh * kw * cin, kh * kw * cout,
                        generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, k, b = _promote(x, self.dtype, self.kernel, self.bias)
        size = k.shape[0]
        ph = same_padding(x.shape[2], size, 1)
        pw = same_padding(x.shape[3], size, 1)
        w = k.permute(3, 2, 0, 1)                      # HWIO -> OIHW
        if ph[0] != ph[1] or pw[0] != pw[1]:
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
            ph, pw = (0, 0), (0, 0)
        y = F.conv2d(x, w, padding=(ph[0], pw[0]))
        return y + b.view(1, -1, 1, 1)


class BiasDense(nn.Module):
    """flax ``nn.Dense(features)``: ``x @ kernel + bias``."""

    def __init__(self, in_features: int, features: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.empty(features))

    def reset_parameters(self, generator=None) -> None:
        fan_in, fan_out = self.kernel.shape
        xavier_uniform_(self.kernel, fan_in, fan_out, generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, k, b = _promote(x, self.dtype, self.kernel, self.bias)
        return x @ k + b


def max_pool(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """flax ``max_pool(x, (w, w), strides=(w, w))`` (VALID) on an NCHW
    view.  The pool runs on a contiguous NCHW copy: PyTorch's CPU
    backward of a channels-last max-pool routes the gradients of many
    windows elsewhere than XLA's does (AlexNet's first-layer gradients
    then part from flax's by 0.2%), and the contiguous form agrees."""
    return F.max_pool2d(x.contiguous(), window, window)


def flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """An NCHW view flattened in flax's NHWC order: ``[b, H * W * C]``."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class LazyZooModel(nn.Module):
    """A zoo model whose layer sizes depend on the input (flax learns
    them from the sample in ``init``): built by :meth:`build` from one
    sample's ``(H, W, C)``, which ``Trainer.init_state`` calls with its
    ``sample_input``."""

    input_shape: Optional[tuple] = None

    @property
    def built(self) -> bool:
        return self.input_shape is not None

    def build(self, input_shape) -> None:
        input_shape = tuple(int(d) for d in input_shape)
        if input_shape == self.input_shape:
            return
        self._make_layers(input_shape)
        self.input_shape = input_shape
        self.reset_parameters()

    def _make_layers(self, input_shape) -> None:
        raise NotImplementedError

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        """flax's initializers, drawn from ``generator`` layer by layer in
        the JAX package's leaf order."""
        if not self.built:
            raise RuntimeError(
                f"{type(self).__name__} sizes its layers from the input: "
                "build it first (Trainer.init_state(sample_input=...))")
        for name in sorted(n for n, _ in self.named_children()):
            getattr(self, name).reset_parameters(generator)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not self.built:
            # the parameters of a functional call name the layers, but the
            # model must own them to run them
            raise RuntimeError(
                f"{type(self).__name__} is not built: pass a sample input "
                "(Trainer.init_state(sample_input=...) or model.build)")
        return self._forward(x)
