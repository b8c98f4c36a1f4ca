"""Fused optimizer apply over flat buckets (port of
geomx_tpu/ops/optim_pallas.py).

The unfused path runs the optimizer once per parameter tensor: a handful
of small elementwise ops per leaf.  With ``GeoConfig(fused_optim=True)``
the train step flattens params and synced gradients onto the bucket
layout the dc tier already uses (``BucketedCompressor.zero_bucketer``)
and applies SGD-momentum or Adam in one kernel launch per bucket, over
all ``[P, W]`` replica rows at once.

Contract (as in the JAX package):

- hyperparameters come from the optimizer: it must be built by
  :func:`fused_optimizer`, which wraps the port's per-leaf optimizer of
  the same semantics and carries a :class:`FusedOptimSpec`;
- the optimizer state is the per-leaf optimizer's state over the bucket
  list (``tx.init(buckets)``): ``{"trace": [...]}`` for SGD,
  ``{"count", "mu", "nu"}`` for Adam, one ``[P, W, n]`` tensor a bucket;
- the plain versions (:func:`sgd_momentum_ref`, :func:`adam_ref`) follow
  the kernels' operation order, each op rounded on its own; on CUDA
  tensors the wrappers launch the kernels of ``csrc/optim.cu`` (which
  round the same way) and on CPU tensors they run the plain versions.

Adam's bias corrections ``1 - b ** count`` are host scalars computed
from the host step count as JAX computes them in fp32
(``optim.adam.bias_corrections``).  ``cast_dtype=torch.bfloat16`` adds a
bf16 copy of the new params from the same pass, as the TPU kernel's
``cast_dtype`` does.  ``fused_sgd_momentum.launches`` and
``fused_adam.launches`` count kernel launches.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from geomx_tpu_torch.config import _env_bool
from geomx_tpu_torch.ops._launches import count
from geomx_tpu_torch.ops.bucket import on_cuda
from geomx_tpu_torch.optim.adam import (Adam, adam_direction, adam_moments,
                                        bias_corrections)
from geomx_tpu_torch.optim.sgd import SGD


class FusedOptimSpec(NamedTuple):
    """Hyperparameters of a fused-apply optimizer."""

    kind: str               # "sgd" (momentum SGD) | "adam"
    learning_rate: float
    momentum: float = 0.0   # sgd only
    b1: float = 0.9         # adam only
    b2: float = 0.999
    eps: float = 1e-8


@dataclasses.dataclass(frozen=True)
class FusedOptimizer:
    """An ``init``/``update`` optimizer carrying the spec the fused
    kernels need.  ``init``/``update`` are the per-leaf optimizer's, so
    with ``fused_optim`` off this is exactly the optimizer it wraps."""

    spec: FusedOptimSpec
    tx: object  # the per-leaf SGD or Adam

    def init(self, params):
        return self.tx.init(params)

    def update(self, grads, opt_state, params):
        return self.tx.update(grads, opt_state, params)


def fused_optimizer(kind: str, *, learning_rate: float,
                    momentum: float = 0.9, b1: float = 0.9,
                    b2: float = 0.999, eps: float = 1e-8) -> FusedOptimizer:
    """Build a :class:`FusedOptimizer` ("sgd" with momentum, or "adam")."""
    kind = str(kind).lower()
    if kind == "sgd":
        return FusedOptimizer(
            FusedOptimSpec("sgd", float(learning_rate),
                           momentum=float(momentum)),
            SGD(learning_rate, momentum=momentum))
    if kind == "adam":
        return FusedOptimizer(
            FusedOptimSpec("adam", float(learning_rate), b1=float(b1),
                           b2=float(b2), eps=float(eps)),
            Adam(learning_rate, b1=b1, b2=b2, eps=eps))
    raise ValueError(f"fused_optimizer: unknown kind {kind!r} "
                     "(supported: 'sgd', 'adam')")


def fused_spec_of(tx) -> Optional[FusedOptimSpec]:
    """The spec if ``tx`` was built by :func:`fused_optimizer`."""
    spec = getattr(tx, "spec", None)
    return spec if isinstance(spec, FusedOptimSpec) else None


def fused_optim_enabled(config=None) -> bool:
    """The config field wins; ``GEOMX_FUSED_OPTIM`` covers config-less
    call sites."""
    if config is not None and getattr(config, "fused_optim", False):
        return True
    return _env_bool(["GEOMX_FUSED_OPTIM"], False)


# ---------------------------------------------------------------------------
# plain versions: the kernels' operation order, each op rounded alone
# ---------------------------------------------------------------------------

def _with_cast(p2, outs, cast_dtype):
    return outs + ((p2.to(cast_dtype),) if cast_dtype is not None else ())


def sgd_momentum_ref(p, g, m, *, lr, momentum, cast_dtype=None):
    """``m' = momentum*m + g;  p' = p - lr*m'`` (optax.sgd trace and
    scale).  Returns ``(p', m')`` plus the ``cast_dtype`` copy of
    ``p'``."""
    m2 = m * momentum + g
    p2 = p - m2 * lr
    return _with_cast(p2, (p2, m2), cast_dtype)


def adam_ref(p, g, m, v, bc1: float, bc2: float, *, lr, b1, b2, eps,
             cast_dtype=None):
    """One Adam step with the bias corrections ``bc = 1 - b**t`` given
    (fp32 values as Python floats).  Returns ``(p', m', v')`` plus the
    ``cast_dtype`` copy of ``p'``."""
    m2, v2 = adam_moments(g, m, v, b1, b2)
    t1, t2 = (torch.full((), bc, dtype=torch.float32, device=p.device)
              for bc in (bc1, bc2))
    p2 = p - adam_direction(m2, v2, t1, t2, eps) * lr
    return _with_cast(p2, (p2, m2, v2), cast_dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(cast_dtype, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"expected float32, got {t.dtype}")
        if t.shape != ts[0].shape:
            raise ValueError("optimizer operands differ in shape")
    if cast_dtype is not None and cast_dtype != torch.bfloat16:
        raise ValueError(f"cast_dtype must be None or torch.bfloat16, got "
                         f"{cast_dtype}")


def _outputs(p: torch.Tensor, count: int, cast_dtype):
    """The kernel's fresh contiguous outputs: it updates nothing in
    place, so the caller's params and state stay valid."""
    outs = tuple(torch.empty_like(p, memory_format=torch.contiguous_format)
                 for _ in range(count))
    cast = None if cast_dtype is None else torch.empty(
        p.shape, dtype=cast_dtype, device=p.device)
    return outs, cast


def fused_sgd_momentum(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, *,
                       lr: float, momentum: float, cast_dtype=None):
    """One SGD-momentum step over fp32 ``[*B, n]`` rows in one launch.
    Returns ``(p', m')`` (plus the ``cast_dtype`` copy of ``p'``)."""
    _check(cast_dtype, p, g, m)
    if not on_cuda([p, g, m]):
        return sgd_momentum_ref(p, g, m, lr=lr, momentum=momentum,
                                cast_dtype=cast_dtype)
    from geomx_tpu_torch.ops._build import kernels
    (p2, m2), cast = _outputs(p, 2, cast_dtype)
    kernels().fused_sgd_momentum(p.contiguous(), g.contiguous(),
                                 m.contiguous(), float(lr), float(momentum),
                                 p2, m2, cast)
    count(fused_sgd_momentum)
    return (p2, m2) + ((cast,) if cast is not None else ())


fused_sgd_momentum.launches = 0


def fused_adam(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
               v: torch.Tensor, bc1: float, bc2: float, *, lr: float,
               b1: float, b2: float, eps: float, cast_dtype=None):
    """One Adam step over fp32 ``[*B, n]`` rows in one launch; ``bc1``,
    ``bc2``: the bias corrections (fp32 values).  Returns ``(p', m',
    v')`` (plus the ``cast_dtype`` copy of ``p'``)."""
    _check(cast_dtype, p, g, m, v)
    if not on_cuda([p, g, m, v]):
        return adam_ref(p, g, m, v, bc1, bc2, lr=lr, b1=b1, b2=b2, eps=eps,
                        cast_dtype=cast_dtype)
    from geomx_tpu_torch.ops._build import kernels
    (p2, m2, v2), cast = _outputs(p, 3, cast_dtype)
    kernels().fused_adam(p.contiguous(), g.contiguous(), m.contiguous(),
                         v.contiguous(), float(bc1), float(bc2), float(lr),
                         float(b1), float(b2), float(eps), p2, m2, v2, cast)
    count(fused_adam)
    return (p2, m2, v2) + ((cast,) if cast is not None else ())


fused_adam.launches = 0


# ---------------------------------------------------------------------------
# the bucket-list apply (what the train step calls)
# ---------------------------------------------------------------------------

def _check_buckets(state_buckets: Sequence, params: Sequence, what: str):
    if len(state_buckets) != len(params):
        raise ValueError(
            f"fused_apply: optimizer {what} has {len(state_buckets)} "
            f"buckets but the layout needs {len(params)} — opt_state was "
            "initialized from a different bucket list")


def fused_apply(spec: FusedOptimSpec, params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor],
                opt_state: dict) -> Tuple[List[torch.Tensor], dict]:
    """One optimizer step over flat fp32 buckets in place of
    ``tx.update``: one kernel launch a bucket.  ``opt_state`` is the
    per-leaf optimizer's state over the same bucket list, and keeps that
    structure."""
    params, grads = list(params), list(grads)
    if spec.kind == "sgd":
        _check_buckets(opt_state["trace"], params, "trace")
        outs = [fused_sgd_momentum(p, g, m, lr=spec.learning_rate,
                                   momentum=spec.momentum)
                for p, g, m in zip(params, grads, opt_state["trace"])]
        return [o[0] for o in outs], {"trace": [o[1] for o in outs]}
    if spec.kind == "adam":
        _check_buckets(opt_state["mu"], params, "moments")
        count = opt_state["count"] + 1
        bc1, bc2 = bias_corrections(spec.b1, spec.b2, count)
        outs = [fused_adam(p, g, m, v, bc1, bc2, lr=spec.learning_rate,
                           b1=spec.b1, b2=spec.b2, eps=spec.eps)
                for p, g, m, v in zip(params, grads, opt_state["mu"],
                                      opt_state["nu"])]
        return [o[0] for o in outs], {"count": count,
                                      "mu": [o[1] for o in outs],
                                      "nu": [o[2] for o in outs]}
    raise ValueError(f"fused_apply: unknown spec kind {spec.kind!r}")


def unfused_apply(tx, params: Sequence[torch.Tensor],
                  grads: Sequence[torch.Tensor], opt_state: dict):
    """The per-leaf optimizer over the same bucket list (on CPU tensors
    bit-equal to :func:`fused_apply`: the same ops in the same order)."""
    return tx.update(list(grads), opt_state, list(params))
