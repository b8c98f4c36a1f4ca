"""Optimizers with optax semantics."""

from geomx_tpu_torch.optim.sgd import SGD, sgd

__all__ = ["SGD", "sgd"]
