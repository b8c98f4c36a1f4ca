"""The port's sequence classifier (``geomx_tpu_torch.models.
seq_classifier.SeqClassifier``, attention on the flash kernels) at a
configuration's sizes."""

from __future__ import annotations

import torch

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def program_model(cfg: dict):
    from geomx_tpu_torch.models.seq_classifier import SeqClassifier
    if cfg["mlp_dim"] != 4 * cfg["dim"]:
        raise ValueError("the port's encoder has an MLP of 4 x dim")
    return SeqClassifier(vocab=cfg["vocab"], max_len=cfg["max_len"],
                         dim=cfg["dim"], num_heads=cfg["num_heads"],
                         num_layers=cfg["num_layers"],
                         num_classes=cfg["num_classes"],
                         dtype=DTYPES[cfg["compute_dtype"]])
