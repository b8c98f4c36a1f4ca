"""Optimizers with optax semantics, and the JAX package's factory over
them (geomx_tpu/optim/__init__.py)."""

from geomx_tpu_torch.optim import alias
from geomx_tpu_torch.optim.adam import Adam, adam
from geomx_tpu_torch.optim.dcasgd import DCASGD, dcasgd
from geomx_tpu_torch.optim.schedules import warmup_cosine_decay_schedule
from geomx_tpu_torch.optim.sgd import SGD, sgd


def get_optimizer(name: str, learning_rate=0.01, **kw):
    """The JAX package's optimizer factory: the reference's optimizer
    suite (sgd, nag, rmsprop, adam, adagrad, adadelta, adamax, nadam,
    dcasgd, ...) with optax's semantics and defaults.  Reference demo
    defaults: Adam lr 0.01.  ``learning_rate`` may be a schedule of the
    update count (``warmup_cosine_decay_schedule``)."""
    name = name.lower()
    if name == "adam":
        return adam(learning_rate, **kw)
    if name == "adamw":
        return alias.adamw(learning_rate, **kw)
    if name == "sgd":
        return sgd(learning_rate, **kw)
    if name == "momentum":
        return sgd(learning_rate, momentum=kw.pop("momentum", 0.9), **kw)
    if name == "nag":
        kw.pop("nesterov", None)  # implied by the name
        return sgd(learning_rate, momentum=kw.pop("momentum", 0.9),
                   nesterov=True, **kw)
    if name == "rmsprop":
        return alias.rmsprop(learning_rate, **kw)
    if name == "adagrad":
        return alias.adagrad(learning_rate, **kw)
    if name == "adadelta":
        return alias.adadelta(learning_rate, **kw)
    if name == "adamax":
        return alias.adamax(learning_rate, **kw)
    if name == "nadam":
        return alias.nadam(learning_rate, **kw)
    if name == "lamb":
        return alias.lamb(learning_rate, **kw)
    if name == "dcasgd":
        return dcasgd(learning_rate, **kw)
    raise ValueError(f"Unknown optimizer: {name!r}")


__all__ = ["Adam", "DCASGD", "SGD", "adam", "alias", "dcasgd",
           "get_optimizer", "sgd", "warmup_cosine_decay_schedule"]
