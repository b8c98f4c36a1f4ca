"""Model zoo (port of geomx_tpu/models/__init__.py): every name the JAX
zoo builds.

The demo CNN, the MLP and AlexNet size their layers from the input, as
flax learns them from the sample in ``init``: ``Trainer.init_state``
builds them from its ``sample_input`` (or call ``model.build((H, W,
C))``).  The ResNets are built for 32x32x3 and re-sized the same way.
"""

import torch

from geomx_tpu_torch.models.cnn import GeoCNN
from geomx_tpu_torch.models.mlp import MLP, AlexNet
from geomx_tpu_torch.models.resnet import (ResNet, ResNet18, ResNet20,
                                           ResNet32, ResNet56)
from geomx_tpu_torch.models.seq_classifier import SeqClassifier

__all__ = ["GeoCNN", "MLP", "AlexNet", "ResNet", "ResNet20", "ResNet32",
           "ResNet56", "ResNet18", "SeqClassifier", "get_model"]

# GEOMX_PRECISION -> the models' compute dtype.  Params always stay fp32.
_PRECISION_DTYPE = {"fp32": torch.float32, "bf16": torch.bfloat16}


def get_model(name: str, num_classes: int = 10, precision: str = None):
    """Build a zoo model.  ``precision`` (``"fp32"``/``"bf16"``) pins
    the compute dtype; ``None`` keeps each model's default (bf16 for
    the ResNets and AlexNet's convolutions, fp32 for the MLP, flax's
    promotion for the CNN), as in the JAX package."""
    name = name.lower()
    dt = {}
    if precision is not None:
        dt = {"dtype": _PRECISION_DTYPE[precision]}
    if name in ("cnn", "geocnn", "lenet"):
        return GeoCNN(num_classes=num_classes, **dt)
    if name == "mlp":
        return MLP(num_classes=num_classes, **dt)
    if name == "alexnet":
        return AlexNet(num_classes=num_classes, **dt)
    if name == "resnet20":
        return ResNet20(num_classes=num_classes, **dt)
    if name in ("resnet20_s2d", "resnet20-s2d"):
        # the space-to-depth stem and transition shortcuts
        return ResNet20(num_classes=num_classes, space_to_depth=True,
                        mxu_shortcuts=True, **dt)
    if name == "resnet32":
        return ResNet32(num_classes=num_classes, **dt)
    if name == "resnet56":
        return ResNet56(num_classes=num_classes, **dt)
    if name == "resnet18":
        return ResNet18(num_classes=num_classes, **dt)
    if name in ("seq", "seq_classifier", "transformer"):
        # the long-context classifier at its defaults (vocab 256, max_len
        # 4096, dim 64, 4 heads, 2 layers), un-meshed attention
        return SeqClassifier(num_classes=num_classes, **dt)
    raise ValueError(f"Unknown model: {name!r}")
