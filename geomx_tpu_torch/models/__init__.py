"""Model zoo (port of geomx_tpu/models/__init__.py).

The ResNet family and the long-context ``SeqClassifier`` are ported;
the other zoo entries raise ``NotImplementedError`` naming their ROADMAP
queue entry.
"""

import torch

from geomx_tpu_torch.models.resnet import (ResNet, ResNet18, ResNet20,
                                           ResNet32, ResNet56)
from geomx_tpu_torch.models.seq_classifier import SeqClassifier

__all__ = ["ResNet", "ResNet20", "ResNet32", "ResNet56", "ResNet18",
           "SeqClassifier", "get_model"]

# GEOMX_PRECISION -> the models' compute dtype.  Params always stay fp32.
_PRECISION_DTYPE = {"fp32": torch.float32, "bf16": torch.bfloat16}

_NOT_PORTED = ("cnn", "geocnn", "lenet", "mlp", "alexnet", "resnet20_s2d",
               "resnet20-s2d")


def get_model(name: str, num_classes: int = 10, precision: str = None):
    """Build a zoo model.  ``precision`` (``"fp32"``/``"bf16"``) pins
    the compute dtype; ``None`` keeps each model's default (bf16 for
    the ResNets, as in the JAX package)."""
    name = name.lower()
    dt = {}
    if precision is not None:
        dt = {"dtype": _PRECISION_DTYPE[precision]}
    if name == "resnet20":
        return ResNet20(num_classes=num_classes, **dt)
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
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ROADMAP.md Queue 1, "
            "item 2 'Models')")
    raise ValueError(f"Unknown model: {name!r}")
