"""Small dense models for the MNIST-class workloads (port of
geomx_tpu/models/mlp.py): an MLP and an AlexNet-style net for 32x32
inputs.

``MLP`` flattens and runs its hidden layers at ``dtype`` (fp32 by
default), the head at fp32.  ``AlexNet`` runs its five convolutions at
``dtype`` (bf16 by default) and the flatten and the three dense layers
at fp32.  Both size their first layer from the input (:meth:`build`), as
flax learns it from the sample in ``init``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from geomx_tpu_torch.models.layers import (BiasConv, BiasDense,
                                           LazyZooModel, flatten_nhwc,
                                           max_pool)


class MLP(LazyZooModel):
    """Dense net: flatten -> hidden relu layers -> logits."""

    def __init__(self, num_classes: int = 10,
                 hidden: Sequence[int] = (256, 128),
                 dtype: torch.dtype = torch.float32,
                 input_shape: Optional[tuple] = None):
        super().__init__()
        self.num_classes = num_classes
        self.hidden = tuple(hidden)
        self.dtype = dtype
        if input_shape is not None:
            self.build(input_shape)

    def _make_layers(self, input_shape) -> None:
        width = 1
        for d in input_shape:
            width *= d
        for i, h in enumerate(self.hidden):
            setattr(self, f"Dense_{i}", BiasDense(width, h, self.dtype))
            width = h
        setattr(self, f"Dense_{len(self.hidden)}",
                BiasDense(width, self.num_classes, torch.float32))

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        # a flax reshape of the NHWC batch: H, W, C order
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        for i in range(len(self.hidden)):
            x = torch.relu(getattr(self, f"Dense_{i}")(x))
        return getattr(self, f"Dense_{len(self.hidden)}")(x)


class AlexNet(LazyZooModel):
    """AlexNet-style conv net adapted to 32x32 inputs: 64, 192, 384, 256,
    256 channels of 3x3 convolutions with three 2x2 pools, then 1,024,
    512 and ``num_classes`` dense units (6,976,842 parameters at
    32x32x3)."""

    CHANNELS = (64, 192, 384, 256, 256)
    POOL_AFTER = (0, 1, 4)

    def __init__(self, num_classes: int = 10,
                 dtype: torch.dtype = torch.bfloat16,
                 input_shape: Optional[tuple] = None):
        super().__init__()
        self.num_classes = num_classes
        self.dtype = dtype
        if input_shape is not None:
            self.build(input_shape)

    def _make_layers(self, input_shape) -> None:
        h, w, cin = input_shape
        for i, c in enumerate(self.CHANNELS):
            setattr(self, f"Conv_{i}", BiasConv(cin, c, 3, self.dtype))
            cin = c
            if i in self.POOL_AFTER:
                h, w = h // 2, w // 2
        self.Dense_0 = BiasDense(h * w * cin, 1024)
        self.Dense_1 = BiasDense(1024, 512)
        self.Dense_2 = BiasDense(512, self.num_classes)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)       # NHWC -> NCHW view
        for i in range(len(self.CHANNELS)):
            x = torch.relu(getattr(self, f"Conv_{i}")(x))
            if i in self.POOL_AFTER:
                x = max_pool(x)
        x = flatten_nhwc(x).float()
        x = torch.relu(self.Dense_0(x))
        x = torch.relu(self.Dense_1(x))
        return self.Dense_2(x)
