"""Optimizers with optax semantics."""

from geomx_tpu_torch.optim.adam import Adam, adam
from geomx_tpu_torch.optim.dcasgd import DCASGD, dcasgd
from geomx_tpu_torch.optim.sgd import SGD, sgd

# the rest of the JAX factory's names (geomx_tpu/optim/__init__.py)
_NOT_PORTED = ("adamw", "nag", "rmsprop", "adagrad", "adadelta", "adamax",
               "nadam", "lamb")


def get_optimizer(name: str, learning_rate=0.01, **kw):
    """The JAX package's optimizer factory over the optimizers the port
    has: ``"adam"``, ``"sgd"``, ``"momentum"`` (sgd with momentum 0.9
    unless given) and ``"dcasgd"``.  Reference demo defaults: Adam lr
    0.01."""
    name = name.lower()
    if name == "adam":
        return adam(learning_rate, **kw)
    if name == "sgd":
        return sgd(learning_rate, **kw)
    if name == "momentum":
        return sgd(learning_rate, momentum=kw.pop("momentum", 0.9), **kw)
    if name == "dcasgd":
        return dcasgd(learning_rate, **kw)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet (ROADMAP.md Queue 1, "
            "item 4 'State, step, optimizer semantics')")
    raise ValueError(f"Unknown optimizer: {name!r}")


__all__ = ["Adam", "DCASGD", "SGD", "adam", "dcasgd", "get_optimizer",
           "sgd"]
