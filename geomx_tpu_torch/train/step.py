"""The training step (port of geomx_tpu/train/step.py, its replicated branch).

The JAX package runs one ``jit(shard_map(...))`` program over the
``[P, W]`` device mesh.  The port holds all replicas on one card: the
forward and backward run once per replica (a plain loop), the
per-replica gradients are stacked onto the ``[P, W]`` axes, and the
sync algorithm's collectives reduce over those axes.  The step then
follows ``_device_step``: gradients at ``sync.forward_params`` (the
params themselves, or MixedSync's stale copy) -> ``sync.sync_grads`` ->
optimizer update -> ``sync.sync_params`` -> ``sync.sync_model_state``,
with the loss and accuracy meaned over workers, then parties.

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

With ``GeoConfig(zero=True)`` (``train/zero.py``) the sync and the
update fuse: ``sync.sync_grad_shards`` returns each worker's ``1/W``
shard of every bucket, the optimizer (or the fused kernels) updates the
shards, and one all-gather a bucket rebuilds the params.  With
``GeoConfig(multi_gps=True)`` (``parallel/multigps.py``) the leaves of
at least ``bigarray_bound`` elements take the same route one leaf at a
time, and the dc tier runs per leaf on the mixed tree.  The composition
checks raise or warn with the JAX package's types and messages.

Not ported yet: telemetry probes and control operands.
"""

from __future__ import annotations

import math
import os
import warnings
from typing import Callable

import torch
import torch.nn.functional as F
from torch.func import functional_call
from torch.profiler import record_function

from geomx_tpu_torch.compression.bucketing import BucketedCompressor
from geomx_tpu_torch.ops.optim import (fused_apply, fused_optim_enabled,
                                       fused_spec_of)
from geomx_tpu_torch.topology import DC_AXIS, WORKER_AXIS
from geomx_tpu_torch.train.state import TrainState
from geomx_tpu_torch.tree import leaf_names, tree_map


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
    its optimizer state use (a pipelined sync's inner one); raises if the
    dc tier is not bucketed."""
    from geomx_tpu_torch.sync.pipeline import PipelinedCompressor
    dc = getattr(sync, "dc_compressor",
                 getattr(getattr(sync, "inner", None), "dc_compressor",
                         None))
    if isinstance(dc, PipelinedCompressor):
        dc = dc.inner
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


def _mgps_plan(sync, topology, config):
    """The MultiGPS plan when ``config.multi_gps`` is set (else None),
    after the JAX package's composition checks.  Unwraps a bucketed dc
    tier of ``sync`` in place, as the JAX package does: MultiGPS keeps
    per-leaf dc semantics."""
    if config is None or not getattr(config, "multi_gps", False):
        return None
    from geomx_tpu_torch.compression.base import NoCompressor
    from geomx_tpu_torch.parallel.multigps import MultiGPSPlan
    from geomx_tpu_torch.sync.dgt import DGTCompressor
    from geomx_tpu_torch.sync.fsa import FSA
    from geomx_tpu_torch.sync.pipeline import PipelinedSync
    if isinstance(sync, PipelinedSync):
        # the sharded update needs this step's dc-tier result before the
        # optimizer runs: no next-step slot to double-buffer into
        raise ValueError(
            "GEOMX_MULTI_GPS does not compose with "
            "GEOMX_PIPELINE_DEPTH: the sharded update needs this "
            "step's dc-tier result before the optimizer can run; "
            "disable one of the two")
    if not isinstance(sync, FSA):
        raise ValueError(
            "GEOMX_MULTI_GPS requires sync_mode=fsa: the ZeRO-1 "
            "sharded update lives in gradient space; param-space "
            f"algorithms ({sync.name}) do not compose with it")
    mgps = MultiGPSPlan(config.bigarray_bound, topology.workers_per_party)
    if isinstance(sync.dc_compressor, BucketedCompressor):
        # big leaves cross the dc tier as shards and small ones
        # replicated: fusing both into one bucket would pool their top-k
        # budgets across layouts, so the dc tier runs per leaf
        sync.dc_compressor = sync.dc_compressor.inner
    if isinstance(sync.worker_compressor, DGTCompressor):
        raise ValueError(
            "GEOMX_MULTI_GPS does not compose with DGT as the "
            "worker-tier compressor; configure DGT on the dc tier "
            "(enable_dgt wraps the dc compressor)")
    if not isinstance(sync.worker_compressor, NoCompressor):
        warnings.warn(
            "multi_gps: leaves >= bigarray_bound use the sharded "
            "psum_scatter reduce and BYPASS the worker-tier "
            f"compressor ({sync.worker_compressor.name}); it still "
            "applies to smaller leaves", stacklevel=3)
    return mgps


def _bind_zero_plan(sync, topology, config):
    """``(sync, plan)``: under ``config.zero``, ``sync`` bound to a
    :class:`~geomx_tpu_torch.train.zero.ZeroPlan` (a copy; an already
    bound sync keeps its plan) after the JAX package's checks; else
    ``(sync, None)``."""
    if config is None or not getattr(config, "zero", False):
        return sync, None
    from geomx_tpu_torch.compression.base import NoCompressor
    from geomx_tpu_torch.train.zero import ZeroPlan
    if getattr(config, "multi_gps", False):
        raise ValueError(
            "GEOMX_ZERO does not compose with GEOMX_MULTI_GPS: both "
            "shard the weight update over the worker axis (ZeRO per "
            "fused bucket, MultiGPS per big leaf); pick one")
    zplan = getattr(sync, "zero_plan", None)
    if zplan is None:
        # rejects HFA and a dc tier without bucketing, and re-pads the
        # buckets so each splits into W lane-aligned shards
        zplan = ZeroPlan(topology.workers_per_party)
        sync = sync.bind_zero(zplan)
    wc = getattr(sync, "worker_compressor",
                 getattr(getattr(sync, "inner", None), "worker_compressor",
                         None))
    if wc is not None and not isinstance(wc, NoCompressor):
        warnings.warn(
            "GEOMX_ZERO: the worker-tier reduce is the bucket "
            "psum_scatter; the configured worker compressor "
            f"({wc.name}) is bypassed", stacklevel=3)
    return sync, zplan


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
    mgps = _mgps_plan(sync, topology, config)
    sync, zplan = _bind_zero_plan(sync, topology, config)
    fopt_spec = _fused_spec(tx, config)
    fopt_bucketer = None
    if fopt_spec is not None:
        if mgps is not None:
            raise ValueError(
                "GEOMX_FUSED_OPTIM does not compose with GEOMX_MULTI_GPS: "
                "the mixed shard/replicated per-leaf layout does not "
                "flatten into uniform buckets; use GEOMX_ZERO for a "
                "sharded fused update")
        if zplan is None:
            fopt_bucketer = fused_bucketer(sync)
        else:
            # the shard-local update runs the same kernels over the
            # 1/W bucket shards
            zplan.fused_spec = fopt_spec

    def zero_sync_update(grads, params, opt_state, sync_state, step):
        """ZeRO: the shard-form sync, the shard-local optimizer and the
        all-gather of the params (train/zero.py)."""
        with record_function("train/sync_grads"):
            shard_g, sync_state = sync.sync_grad_shards(grads, params,
                                                        sync_state, step)
        with record_function("train/optimizer"):
            params, opt_state = zplan.apply_shard_update(
                tx, shard_g, params, opt_state, WORKER_AXIS)
        return params, opt_state, sync_state

    def mgps_sync_update(grads, params, opt_state, sync_state):
        """MultiGPS: the hierarchical reduce with the big leaves
        reduce-scattered over the workers, the optimizer on the mixed
        tree, the big leaves all-gathered back."""
        names = leaf_names(params)
        sizes = [math.prod(params[k].shape[2:]) for k in names]
        with record_function("train/sync_grads"):
            mixed_g, new_ws = {}, {}
            ws_all = sync_state["worker_comp"]
            for k, n in zip(names, sizes):
                if mgps.is_big(n):
                    # the scatter is the worker-tier reduce
                    mixed_g[k] = mgps.scatter_grad_leaf(grads[k], WORKER_AXIS)
                    new_ws[k] = ws_all[k]
                else:
                    g, new_ws[k] = sync.worker_compressor.allreduce_leaf(
                        grads[k], ws_all[k], WORKER_AXIS, W)
                    mixed_g[k] = g / W if W > 1 else g
            dc = sync.dc_compressor
            if getattr(dc, "fuses_tree", False):
                # a tree-fusing dc compressor (DGT) runs one schedule a
                # layout group (MultiGPSPlan.split_mixed); the groups are
                # sub-trees in leaf order
                big_names, small_names = mgps.split_mixed(sizes, names)
                dst = sync_state["dc_comp"]
                big_s, small_s = dst["sharded"], dst["replicated"]
                if big_names:
                    out, big_s = dc.allreduce(
                        {k: mixed_g[k] for k in big_names}, big_s, DC_AXIS,
                        P)
                    mixed_g.update(out)
                if small_names:
                    out, small_s = dc.allreduce(
                        {k: mixed_g[k] for k in small_names}, small_s,
                        DC_AXIS, P)
                    mixed_g.update(out)
                dstate = {"sharded": big_s, "replicated": small_s}
            else:
                mixed_g, dstate = dc.allreduce(mixed_g,
                                               sync_state["dc_comp"],
                                               DC_AXIS, P)
            if P > 1:
                mixed_g = tree_map(lambda x: x / P, mixed_g)
        with record_function("train/optimizer"):
            mixed_p = {k: mgps.shard_param_leaf(params[k])
                       if mgps.is_big(n) else params[k]
                       for k, n in zip(names, sizes)}
            new_mixed, opt_state = tx.update(mixed_g, opt_state, mixed_p)
            params = {k: mgps.unshard_param_leaf(new_mixed[k], params[k],
                                                 WORKER_AXIS)
                      if mgps.is_big(n) else new_mixed[k]
                      for k, n in zip(names, sizes)}
        return params, opt_state, {"dc_comp": dstate,
                                   "worker_comp": new_ws}

    def replicated_update(grads, state, step):
        """The replicated branch: sync_grads, then one optimizer step on
        every replica (the fused kernels over the buckets when on)."""
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
        return params, opt_state, sync_state

    def train_step(state: TrainState, x: torch.Tensor, y: torch.Tensor):
        names = list(state.params)
        step = state.step
        per_grads, per_stats, losses, accs = [], [], [], []
        with record_function("train/forward_backward"):
            # the weights each replica computes its gradients at, taken
            # on the whole [P, W] tree (MixedSync: the stale copy)
            fwd = sync.forward_params(state.params, state.sync_state)
            for p in range(P):
                for w in range(W):
                    leaves = {k: fwd[k][p, w].detach().requires_grad_()
                              for k in names}
                    ms = {k: t[p, w] for k, t in state.model_state.items()}
                    xb = x[p, w] if sp is None else sp_chunks(x[p, w], sp)
                    loss, (new_ms, logits) = loss_fn(leaves, ms, xb,
                                                     y[p, w])
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

        if mgps is not None:
            params, opt_state, sync_state = mgps_sync_update(
                grads, state.params, state.opt_state, state.sync_state)
        elif zplan is not None:
            params, opt_state, sync_state = zero_sync_update(
                grads, state.params, state.opt_state, state.sync_state,
                step)
        else:
            params, opt_state, sync_state = replicated_update(
                grads, state, step)
        with record_function("train/sync_model_state"):
            if mgps is None:
                params, sync_state = sync.sync_params(params, sync_state,
                                                      step)
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

    train_step.mgps = mgps  # Trainer.init_state shapes the state by it
    return train_step


def build_logits_fn(model: torch.nn.Module):
    """``logits_fn(params, model_state, x) -> logits``: the evaluation
    forward on one replica's weights."""

    @torch.no_grad()
    def logits_fn(params, model_state, x):
        return functional_call(model, {**params, **model_state},
                               (_norm_input(x),), {"train": False})

    return logits_fn


def build_eval_step(model: torch.nn.Module):
    """``eval_step(params, model_state, x, y) -> (correct, count)`` on
    one replica's weights."""
    logits_fn = build_logits_fn(model)

    def eval_step(params, model_state, x, y):
        logits = logits_fn(params, model_state, x)
        return (logits.argmax(-1) == y).sum(), y.shape[0]

    return eval_step
