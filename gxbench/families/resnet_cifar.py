"""The port's CIFAR ResNet (``geomx_tpu_torch.models.resnet.ResNet``) at a
configuration's stages and widths."""

from __future__ import annotations

import torch

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def program_model(cfg: dict):
    from geomx_tpu_torch.models.resnet import ResNet
    if cfg["shortcut"] != "projection":
        raise ValueError("the port's ResNet has projection shortcuts only")
    return ResNet(cfg["stage_sizes"], cfg["stage_filters"],
                  cfg["num_classes"], DTYPES[cfg["compute_dtype"]],
                  in_channels=cfg["image_shape"][2])
