"""The reference demo CNN (port of geomx_tpu/models/cnn.py).

Conv(16, 5x5, relu) -> MaxPool(2, 2) -> Conv(32, 5x5, relu) ->
MaxPool(2, 2) -> Dense(256, relu) -> Dense(128, relu) -> Dense(10),
Xavier-uniform kernels and zero biases, NHWC inputs.  ``dtype=None``
keeps fp32 (flax's promotion of the fp32 parameters); with ``bf16`` the
body computes in bf16 and the head computes and returns fp32.

The convolutions' input channels and ``Dense_0``'s input width (1,568 at
28x28x1, 2,048 at 32x32x3) come from the input, as flax learns them from
the sample in ``init``: :meth:`build` sizes the layers from one sample's
``(H, W, C)``, or the constructor's ``input_shape``.
"""

from __future__ import annotations

from typing import Optional

import torch

from geomx_tpu_torch.models.layers import (BiasConv, BiasDense,
                                           LazyZooModel, flatten_nhwc,
                                           max_pool)


class GeoCNN(LazyZooModel):
    def __init__(self, num_classes: int = 10,
                 dtype: Optional[torch.dtype] = None,
                 input_shape: Optional[tuple] = None):
        super().__init__()
        self.num_classes = num_classes
        self.dtype = dtype
        if input_shape is not None:
            self.build(input_shape)

    def _make_layers(self, input_shape) -> None:
        h, w, c = input_shape
        dt = self.dtype
        self.Conv_0 = BiasConv(c, 16, 5, dt)
        self.Conv_1 = BiasConv(16, 32, 5, dt)
        flat = (h // 2 // 2) * (w // 2 // 2) * 32
        self.Dense_0 = BiasDense(flat, 256, dt)
        self.Dense_1 = BiasDense(256, 128, dt)
        self.Dense_2 = BiasDense(128, self.num_classes,
                                 None if dt is None else torch.float32)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = x.permute(0, 3, 1, 2)                      # NHWC -> NCHW view
        x = max_pool(torch.relu(self.Conv_0(x)))
        x = max_pool(torch.relu(self.Conv_1(x)))
        x = flatten_nhwc(x)
        x = torch.relu(self.Dense_0(x))
        x = torch.relu(self.Dense_1(x))
        x = self.Dense_2(x)
        return x if self.dtype is None else x.float()
