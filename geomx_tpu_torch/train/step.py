"""The training step (port of geomx_tpu/train/step.py, FSA branch).

The JAX package runs one ``jit(shard_map(...))`` program over the
``[P, W]`` device mesh.  The port holds all replicas on one card: the
forward and backward run once per replica (a plain loop), the
per-replica gradients are stacked onto the ``[P, W]`` axes, and the
sync algorithm's collectives reduce over those axes.  The step then
follows ``_device_step``: grads -> ``sync.sync_grads`` -> optimizer
update -> ``sync.sync_params`` -> ``sync.sync_model_state``, with the
loss and accuracy meaned over workers, then parties.

With ``GeoConfig(fused_optim=True)`` and an optimizer from
``ops.optim.fused_optimizer`` the update runs over the dc tier's flat
buckets: params and synced grads flatten onto the bucket layout, one
fused kernel a bucket applies the step, and the params unflatten.

With an sp-aware model (one with an ``sp_mode``) on a topology with
``sp_degree = S``, each replica's token batch ``[b, L, 2]`` is cut into
``S`` contiguous sequence chunks stacked as ``[S, b, L/S, 2]`` — the
chunks the JAX step's ``P(dc, worker, None, sp)`` input spec gives each
sp device — and the model runs them in one graph
(``models/seq_classifier.py``), so its gradients are already the true
ones: no psum over sp follows.

Not ported yet: MultiGPS, ZeRO, telemetry probes and control operands.
"""

from __future__ import annotations

import os
from typing import Callable

import torch
import torch.nn.functional as F
from torch.func import functional_call
from torch.profiler import record_function

from geomx_tpu_torch.compression.bucketing import BucketedCompressor
from geomx_tpu_torch.ops.optim import (fused_apply, fused_optim_enabled,
                                       fused_spec_of)
from geomx_tpu_torch.train.state import TrainState
from geomx_tpu_torch.tree import leaf_names


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over integer labels."""
    return F.cross_entropy(logits.float(), labels.long())


def _norm_input(x: torch.Tensor) -> torch.Tensor:
    """uint8 (or float, 0-255 scale) images -> [0, 1] float32 on the
    device; wide integer token ids pass through."""
    if not x.dtype.is_floating_point and x.dtype != torch.uint8:
        return x
    return x.to(torch.float32) / 255.0


def resolve_precision(config=None) -> str:
    """The compute precision: ``"fp32"`` or ``"bf16"`` (config wins,
    then ``GEOMX_PRECISION``).  bf16 means fp32 master weights with bf16
    activations; the loss, gradients and optimizer state stay fp32."""
    if config is not None:
        raw = getattr(config, "precision", "fp32")
    else:
        raw = os.environ.get("GEOMX_PRECISION", "fp32")
    alias = {"fp32": "fp32", "float32": "fp32", "f32": "fp32",
             "bf16": "bf16", "bfloat16": "bf16"}
    key = str(raw).lower()
    if key not in alias:
        raise ValueError(
            f"unknown precision {raw!r}: expected 'fp32' or 'bf16' "
            "(GEOMX_PRECISION / GeoConfig.precision)")
    return alias[key]


def make_loss_fn(model: torch.nn.Module, compute_dtype=None) -> Callable:
    """``loss_fn(params, model_state, x, y) -> (loss, (new_model_state,
    logits))`` for one replica.  ``params``/``model_state`` are flat
    dicts of one replica's tensors; the model's BatchNorm layers write
    their new running statistics into a fresh copy of ``model_state``
    (flax's mutable ``batch_stats``), which is returned."""

    def loss_fn(params, model_state, x, y):
        x = _norm_input(x)
        if compute_dtype is not None and x.dtype.is_floating_point:
            x = x.to(compute_dtype)
        new_state = {k: t.clone() for k, t in model_state.items()}
        logits = functional_call(model, {**params, **new_state}, (x,),
                                 {"train": True})
        return cross_entropy_loss(logits, y), (new_state, logits)

    return loss_fn


def fused_bucketer(sync):
    """The dc tier's bucketed engine, whose layout the fused apply and
    its optimizer state use; raises if the dc tier is not bucketed."""
    dc = getattr(sync, "dc_compressor", None)
    if not isinstance(dc, BucketedCompressor):
        raise ValueError(
            "GEOMX_FUSED_OPTIM requires the bucketed dc-tier engine "
            "(GEOMX_BUCKET_BYTES > 0): the kernels apply the update over "
            "the flat fp32 buckets")
    return dc.zero_bucketer


def _fused_spec(tx, config):
    """The fused-apply spec when ``fused_optim`` is on, else None."""
    if not fused_optim_enabled(config):
        return None
    spec = fused_spec_of(tx)
    if spec is None:
        # fail loudly: silently falling back would report fused numbers
        # from an unfused run
        raise ValueError(
            "GEOMX_FUSED_OPTIM requires an optimizer built by "
            "ops.optim.fused_optimizer (the kernels need the static "
            "hyperparameters a plain optimizer hides)")
    return spec


def sp_chunks(x: torch.Tensor, sp: int) -> torch.Tensor:
    """One replica's ``[b, L, ...]`` token batch as ``sp`` contiguous
    sequence chunks ``[sp, b, L/sp, ...]``."""
    b, L = x.shape[:2]
    if L % sp:
        raise ValueError(f"sequence length {L} does not split into "
                         f"{sp} sp chunks")
    return x.reshape(b, sp, L // sp, *x.shape[2:]).transpose(0, 1) \
        .contiguous()


def build_train_step(loss_fn: Callable, tx, sync, topology, config=None,
                     sp_model: bool = False):
    """Build ``train_step(state, x, y) -> (state, metrics)``.

    - state leaves carry ``[P, W]`` replica axes;
    - ``x``, ``y`` are ``[P, W, local_batch, ...]``;
    - metrics are global means (0-d tensors on the device);
    - ``sp_model``: the model takes its sequence as sp chunks
      (:func:`sp_chunks`, ``topology.sp_degree`` of them).
    """
    sync.bind_topology(topology)
    P, W = topology.replica_shape
    sp = getattr(topology, "sp_degree", 1) if sp_model else None
    fopt_spec = _fused_spec(tx, config)
    fopt_bucketer = fused_bucketer(sync) if fopt_spec is not None else None

    def train_step(state: TrainState, x: torch.Tensor, y: torch.Tensor):
        names = list(state.params)
        step = state.step
        per_grads, per_stats, losses, accs = [], [], [], []
        with record_function("train/forward_backward"):
            for p in range(P):
                for w in range(W):
                    leaves = {k: state.params[k][p, w].detach()
                              .requires_grad_() for k in names}
                    fwd = sync.forward_params(leaves, state.sync_state)
                    ms = {k: t[p, w] for k, t in state.model_state.items()}
                    xb = x[p, w] if sp is None else sp_chunks(x[p, w], sp)
                    loss, (new_ms, logits) = loss_fn(fwd, ms, xb, y[p, w])
                    grads = torch.autograd.grad(loss,
                                                [leaves[k] for k in names])
                    per_grads.append(grads)
                    per_stats.append(new_ms)
                    losses.append(loss.detach())
                    accs.append((logits.detach().argmax(-1) == y[p, w])
                                .to(torch.float32).mean())
            grads = {k: torch.stack([g[i] for g in per_grads])
                     .view((P, W) + tuple(state.params[k].shape[2:]))
                     for i, k in enumerate(names)}
            model_state = {k: torch.stack([s[k] for s in per_stats])
                           .view(state.model_state[k].shape)
                           for k in state.model_state}

        with record_function("train/sync_grads"):
            grads, sync_state = sync.sync_grads(grads, state.params,
                                                state.sync_state, step)
        with record_function("train/optimizer"):
            if fopt_spec is not None:
                # fused apply: params and grads flatten onto the dc tier's
                # bucket layout (opt_state lives there too,
                # Trainer.init_state), one kernel a bucket
                order = leaf_names(state.params)
                bk = fopt_bucketer([state.params[k] for k in order])
                new_pb, opt_state = fused_apply(
                    fopt_spec, bk.flatten([state.params[k] for k in order]),
                    bk.flatten([grads[k] for k in order]), state.opt_state)
                params = dict(zip(order, bk.unflatten(new_pb)))
            else:
                params, opt_state = tx.update(grads, state.opt_state,
                                              state.params)
        with record_function("train/sync_model_state"):
            params, sync_state = sync.sync_params(params, sync_state, step)
            model_state, sync_state = sync.sync_model_state(
                model_state, sync_state, step)

        # global mean over every replica: workers first, then parties
        metrics = {
            "loss": torch.stack(losses).view(P, W).mean(1).mean(0),
            "accuracy": torch.stack(accs).view(P, W).mean(1).mean(0),
        }
        return TrainState(step=step + 1, params=params, opt_state=opt_state,
                          model_state=model_state,
                          sync_state=sync_state), metrics

    return train_step


def build_eval_step(model: torch.nn.Module):
    """``eval_step(params, model_state, x, y) -> (correct, count)`` on
    one replica's weights."""

    @torch.no_grad()
    def eval_step(params, model_state, x, y):
        logits = functional_call(model, {**params, **model_state},
                                 (_norm_input(x),), {"train": False})
        return (logits.argmax(-1) == y).sum(), y.shape[0]

    return eval_step
