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
ones: no psum over sp follows.  On a ``[P, W, S]`` mesh each sp slot
runs one chunk, as a JAX sp device does: its forward's sp exchanges meet
the other shards' slots and are taped, the backward runs segment by
segment in the slot's thread (``collectives.SpTape``), then the
gradients are psummed over sp and floating model state and the metrics
pmeaned over it (``geomx_tpu/train/step.py:434-443``).

With ``GeoConfig(zero=True)`` (``train/zero.py``) the sync and the
update fuse: ``sync.sync_grad_shards`` returns each worker's ``1/W``
shard of every bucket, the optimizer (or the fused kernels) updates the
shards, and one all-gather a bucket rebuilds the params.  With
``GeoConfig(multi_gps=True)`` (``parallel/multigps.py``) the leaves of
at least ``bigarray_bound`` elements take the same route one leaf at a
time, and the dc tier runs per leaf on the mixed tree.  The composition
checks raise or warn with the JAX package's types and messages.

Under a degraded membership mask (``resilience/``, bound through
``Trainer.apply_membership``) the loss and accuracy are the survivors'
mean (a dead party's describe data that never reached the aggregate),
and ``metrics["num_live_parties"]`` reports the live-party count the
step ran with.

With telemetry on (``GEOMX_TELEMETRY``, decided when the step is
built) the step adds ``metrics["telemetry"]``, the step-health probes of
``telemetry/probes.py``: computed from the raw ``[P, W]`` gradients, the
applied gradient (on the fused path the flat buckets the fused apply
already built) and the sync state, and left on the device.  With it off
the step runs exactly the ops it runs without the probe call site.

On a device mesh (``build_train_step(..., mesh=)``, ``topology.
ReplicaMesh``) the same program runs once a replica slot at local leading
dims ``[1, 1]`` (``parallel/collectives.run_on_mesh``), as the JAX
``_device_step`` sees ``[1, 1]`` blocks under ``P(dc, worker)``; its
collectives meet the other slots' and give the stacked path's bits.  The
mesh runs every step the stacked path runs: every sync algorithm, every
dc-tier compressor, a worker-tier compressor, per-leaf or fused
optimizers, ZeRO and MultiGPS, a membership mask, telemetry, control,
and sp on a ``[P, W, S]`` mesh.  The step runs on the mesh its state is
placed on (the audit records a meshed program on a CPU twin of the
mesh, ``train/trainer.py``).

With control on (``GEOMX_CONTROL``, ``control/``, decided when the step
is built) the state's ``sync_state["control"]`` operands are detached
before the sync hooks, opened as a context the dc-tier compressors read
(``control_operands``) and rejoined after; under telemetry the probes
carry ``control_ratio_scale``, a copy of the scale the step ran with.
With it off the step runs exactly the ops of a build whose control hook
raises.

Every call of the step opens a record of the step clock
(``utils/profiler.StepClock``; on a mesh, one a slot) under span
``train/train_step``: the host time of each span inside it, and the
device time between two events on the step's stream.  Spans
``train/forward`` and ``train/backward`` (one a replica), ``train/stack``
and ``train/metrics`` split ``train/forward_backward`` and the tail.
"""

from __future__ import annotations

import contextlib
import copy
import math
import os
import threading
import warnings
from typing import Callable

import torch
import torch.nn.functional as F
from torch.func import functional_call

from geomx_tpu_torch.compression.bucketing import BucketedCompressor
from geomx_tpu_torch.control import actuators as _control
from geomx_tpu_torch.ops.optim import (fused_apply, fused_optim_enabled,
                                       fused_spec_of)
from geomx_tpu_torch.parallel.collectives import (current_slot, pmean_dc,
                                                  pmean_sp, pmean_worker,
                                                  psum_dc, psum_sp,
                                                  run_on_mesh, sp_tape)
from geomx_tpu_torch.telemetry import probes as _probes
from geomx_tpu_torch.topology import DC_AXIS, WORKER_AXIS, PlacedTree
from geomx_tpu_torch.train.state import TrainState
from geomx_tpu_torch.tree import leaf_names, tree_map
from geomx_tpu_torch.utils.profiler import STEP_SPAN, span, step_clock


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

    loss_fn.model, loss_fn.compute_dtype = model, compute_dtype
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
    if sync.live_parties is not None:
        # the big leaves live as worker-axis shards: a masked
        # renormalized mean over them needs a per-shard re-layout the
        # JAX package does not implement either
        raise ValueError(
            "GEOMX_MULTI_GPS does not compose with a degraded "
            "membership mask (resilience/): disable multi_gps or "
            "run with every party live")
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


# (device, live-party count) -> the num_live_parties metric's tensor
_LIVE_COUNTS: dict = {}
_LIVE_COUNTS_LOCK = threading.Lock()

def _locked(loss_fn: Callable) -> Callable:
    """``loss_fn`` called under a lock: the slots of a mesh share the
    model, and ``functional_call`` swaps the module's tensors while the
    forward runs (the backward, outside the call, needs no lock)."""
    lock = threading.Lock()

    def locked(*args):
        with lock:
            return loss_fn(*args)
    return locked


def _per_slot(loss_fn: Callable) -> Callable:
    """``loss_fn`` on a copy of its model a mesh slot: an sp slot's
    forward meets the other slots at its exchanges, so the slots cannot
    take turns on one module under a lock (:func:`_locked`)."""
    model = getattr(loss_fn, "model", None)
    if model is None:
        raise ValueError("an sp step on a device mesh needs a loss_fn made "
                         "by make_loss_fn (it runs a model copy a slot)")
    copies: dict = {}
    lock = threading.Lock()

    def slotted(*args):
        index = current_slot().index
        with lock:
            fn = copies.get(index)
            if fn is None:
                fn = copies[index] = make_loss_fn(copy.deepcopy(model),
                                                  loss_fn.compute_dtype)
        return fn(*args)
    return slotted


def build_train_step(loss_fn: Callable, tx, sync, topology, config=None,
                     sp_model: bool = False, mesh=None):
    """Build ``train_step(state, x, y) -> (state, metrics)``.

    - state leaves carry ``[P, W]`` replica axes;
    - ``x``, ``y`` are ``[P, W, local_batch, ...]``;
    - metrics are global means (0-d tensors on the device);
    - ``sp_model``: the model takes its sequence as sp chunks
      (:func:`sp_chunks`, ``topology.sp_degree`` of them);
    - ``mesh``: a ``topology.ReplicaMesh`` of the topology's shape
      (``[P, W, S]`` with ``sp_degree = S``).  The step then takes a
      placed state (``mesh.place``; a stacked one is placed first) and
      placed or stacked batches (a token batch's sequence split over the
      sp slots), runs the program once a slot at leading dims ``[1,
      1]`` on the mesh the state is placed on, and returns the placed
      state and slot ``(0, 0)``'s metrics (every slot holds the same
      global means).
    """
    sync.bind_topology(topology)
    # the axis sizes the collectives reduce over, and (P, W) the leading
    # dims of the program's own tensors: the same stacked, [1, 1] a slot
    nP, nW = P, W = topology.replica_shape
    sp = getattr(topology, "sp_degree", 1) if sp_model else None
    taped = False
    if mesh is not None:
        S = getattr(topology, "sp_degree", 1)
        if tuple(mesh.shape) != (P, W) or mesh.sp != S:
            raise ValueError(f"mesh {list(mesh.shape)} x sp {mesh.sp} does "
                             f"not match the topology's [P, W] = {[P, W]} x "
                             f"sp {S}")
        # the slot program's own replica dims, as _device_step sees them
        P, W = 1, 1
        if sp_model:
            # a slot runs one sequence chunk and tapes its sp exchanges
            sp, taped = 1, True
            loss_fn = _per_slot(loss_fn)
        else:
            loss_fn = _locked(loss_fn)
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
    # the telemetry gate, static for this step as the JAX gate is at
    # trace time; the probes' static wire accounting is computed once
    telem = _probes.telemetry_enabled(config)
    wire_cache = {}
    # the control gate, static for this step as the telemetry gate is
    ctl_on = _control.control_enabled(config)

    def zero_sync_update(grads, params, opt_state, sync_state, step):
        """ZeRO: the shard-form sync, the shard-local optimizer and the
        all-gather of the params (train/zero.py)."""
        with span("train/sync_grads"):
            shard_g, sync_state = sync.sync_grad_shards(grads, params,
                                                        sync_state, step)
        with span("train/optimizer"):
            params, opt_state = zplan.apply_shard_update(
                tx, shard_g, params, opt_state, WORKER_AXIS)
        return params, opt_state, sync_state

    def mgps_sync_update(grads, params, opt_state, sync_state):
        """MultiGPS: the hierarchical reduce with the big leaves
        reduce-scattered over the workers, the optimizer on the mixed
        tree, the big leaves all-gathered back."""
        names = leaf_names(params)
        sizes = [math.prod(params[k].shape[2:]) for k in names]
        with span("train/sync_grads"):
            mixed_g, new_ws = {}, {}
            ws_all = sync_state["worker_comp"]
            for k, n in zip(names, sizes):
                if mgps.is_big(n):
                    # the scatter is the worker-tier reduce
                    mixed_g[k] = mgps.scatter_grad_leaf(grads[k], WORKER_AXIS)
                    new_ws[k] = ws_all[k]
                else:
                    g, new_ws[k] = sync.worker_compressor.allreduce_leaf(
                        grads[k], ws_all[k], WORKER_AXIS, nW)
                    mixed_g[k] = g / nW if nW > 1 else g
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
                        nP)
                    mixed_g.update(out)
                if small_names:
                    out, small_s = dc.allreduce(
                        {k: mixed_g[k] for k in small_names}, small_s,
                        DC_AXIS, nP)
                    mixed_g.update(out)
                dstate = {"sharded": big_s, "replicated": small_s}
            else:
                mixed_g, dstate = dc.allreduce(mixed_g,
                                               sync_state["dc_comp"],
                                               DC_AXIS, nP)
            if nP > 1:
                mixed_g = tree_map(lambda x: x / nP, mixed_g)
        with span("train/optimizer"):
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

    def replicated_update(grads, state, sync_state, step):
        """The replicated branch: sync_grads, then one optimizer step on
        every replica (the fused kernels over the buckets when on).
        Also returns, with telemetry on and a replicated sync output,
        one replica's applied gradient and its unpadded element count
        for the probes (else None)."""
        with span("train/sync_grads"):
            grads, sync_state = sync.sync_grads(grads, state.params,
                                                sync_state, step)
        applied = None
        with span("train/optimizer"):
            if fopt_spec is not None:
                # fused apply: params and grads flatten onto the dc tier's
                # bucket layout (opt_state lives there too,
                # Trainer.init_state), one kernel a bucket
                order = leaf_names(state.params)
                bk = fopt_bucketer([state.params[k] for k in order])
                pb = bk.flatten([state.params[k] for k in order])
                gb = bk.flatten([grads[k] for k in order])
                new_pb, opt_state = fused_apply(fopt_spec, pb, gb,
                                                state.opt_state)
                params = dict(zip(order, bk.unflatten(new_pb)))
                if telem and sync.grads_replicated_after_sync:
                    # the buckets already hold the applied gradient
                    applied = ([b[0, 0] for b in gb], sum(bk.bucket_fill))
            else:
                params, opt_state = tx.update(grads, state.opt_state,
                                              state.params)
        if telem and applied is None and sync.grads_replicated_after_sync:
            applied = ([grads[k][0, 0] for k in leaf_names(grads)], None)
        return params, opt_state, sync_state, applied

    def global_means(per_replica: dict) -> dict:
        """Each ``[P, W]`` metric's mean over workers, then parties (under
        a membership mask, the survivors' mean), through the collectives
        the JAX step runs on its metric dict: the worker pmean of every
        metric, then the dc one, in sorted key order (the order
        ``jax.tree.leaves`` walks a dict in)."""
        names = sorted(per_replica)
        out = {k: pmean_worker(torch.stack(per_replica[k]).view(P, W))
               for k in names}
        if sync.live_parties is None:
            out = {k: pmean_dc(out[k]) for k in names}
        else:
            out = {k: psum_dc(sync.mask_parties(out[k])) / sync.num_live
                   for k in names}
        return {k: out[k][0, 0] for k in names}

    def num_live_metric(device):
        """The live-party count the step ran with, a 0-d fp32 tensor made
        once a device and count in the process (a step built later, at a
        membership or depth swap, finds it made: its first call makes no
        host-to-device copy)."""
        key = (device, sync.num_live)
        with _LIVE_COUNTS_LOCK:  # a mesh's slots ask from their threads
            if key not in _LIVE_COUNTS:
                _LIVE_COUNTS[key] = torch.tensor(float(sync.num_live),
                                                 device=device)
            return _LIVE_COUNTS[key]

    def step_body(state: TrainState, x: torch.Tensor, y: torch.Tensor):
        names = list(state.params)
        step = state.step
        sync_state = state.sync_state
        ctl = None
        if ctl_on:
            # detach the control operands before the sync hooks (whose
            # state threading rebuilds dicts and would drop foreign keys);
            # they rejoin the output sync_state after them
            sync_state = dict(sync_state)
            ctl = sync_state.pop(_control.CONTROL_KEY, None)
            if ctl is None:
                raise ValueError(
                    "GEOMX_CONTROL is on but sync_state carries no "
                    "control operands: initialize the state with a "
                    "control-enabled Trainer (init_state adds the "
                    f"{_control.CONTROL_KEY!r} subtree)")
        per_grads, per_stats, losses, accs = [], [], [], []
        with span("train/forward_backward"):
            # the weights each replica computes its gradients at, taken
            # on the whole [P, W] tree (MixedSync: the stale copy)
            fwd = sync.forward_params(state.params, sync_state)
            for p in range(P):
                for w in range(W):
                    leaves = {k: fwd[k][p, w].detach().requires_grad_()
                              for k in names}
                    ms = {k: t[p, w] for k, t in state.model_state.items()}
                    xb = x[p, w] if sp is None else sp_chunks(x[p, w], sp)
                    if taped:
                        with sp_tape() as tape:
                            with span("train/forward", annotation=False):
                                loss, (new_ms, logits) = loss_fn(
                                    leaves, ms, xb, y[p, w])
                            with span("train/backward", annotation=False):
                                grads = tape.grad(
                                    loss, [leaves[k] for k in names])
                        # each sp slot back-propagated its own shard: the
                        # replica's gradient is their sum, and the floating
                        # model state and the metrics their mean
                        grads = [psum_sp(g[None])[0] for g in grads]
                        new_ms = {k: pmean_sp(t[None])[0]
                                  if t.is_floating_point() else t
                                  for k, t in new_ms.items()}
                        loss = pmean_sp(loss.detach()[None])[0]
                        logits = logits.detach()
                    else:
                        with span("train/forward", annotation=False):
                            loss, (new_ms, logits) = loss_fn(leaves, ms, xb,
                                                             y[p, w])
                        with span("train/backward", annotation=False):
                            grads = torch.autograd.grad(
                                loss, [leaves[k] for k in names])
                    per_grads.append(grads)
                    per_stats.append(new_ms)
                    losses.append(loss.detach())
                    accs.append((logits.detach().argmax(-1) == y[p, w])
                                .to(torch.float32).mean())
                    if taped:
                        accs[-1] = pmean_sp(accs[-1][None])[0]
            with span("train/stack", annotation=False):
                grads = {k: torch.stack([g[i] for g in per_grads])
                         .view((P, W) + tuple(state.params[k].shape[2:]))
                         for i, k in enumerate(names)}
                model_state = {k: torch.stack([s[k] for s in per_stats])
                               .view(state.model_state[k].shape)
                               for k in state.model_state}

        # kept for the probes: the gradients before any cross-party
        # aggregation (an alias, no op)
        raw_grads = grads
        applied = None
        probe_ctx = _probes.inline_collection() if telem \
            else contextlib.nullcontext(None)
        ctl_ctx = _control.control_operands(ctl) if ctl is not None \
            else contextlib.nullcontext(None)
        with probe_ctx as inline_sink, ctl_ctx:
            if mgps is not None:
                params, opt_state, sync_state = mgps_sync_update(
                    grads, state.params, state.opt_state, sync_state)
            elif zplan is not None:
                # ZeRO: the synced gradient exists only as shards, so the
                # replicated-value probes are skipped, as in the JAX step
                params, opt_state, sync_state = zero_sync_update(
                    grads, state.params, state.opt_state, sync_state,
                    step)
            else:
                params, opt_state, sync_state, applied = replicated_update(
                    grads, state, sync_state, step)
            with span("train/sync_model_state"):
                if mgps is None:
                    params, sync_state = sync.sync_params(params,
                                                          sync_state, step)
                model_state, sync_state = sync.sync_model_state(
                    model_state, sync_state, step)
        if ctl is not None:
            # the operands pass through unchanged (actuation writes them
            # in place between steps)
            sync_state = dict(sync_state, **{_control.CONTROL_KEY: ctl})

        # global mean over every replica: workers first, then parties
        # (under a membership mask, the survivors' mean)
        with span("train/metrics", annotation=False):
            metrics = global_means({"loss": losses, "accuracy": accs})
            metrics["num_live_parties"] = num_live_metric(losses[0].device)
        if telem:
            if "wire" not in wire_cache:
                wire_cache["wire"] = _probes.static_wire_accounting(
                    sync, params)
            with span("train/probes"):
                metrics["telemetry"] = _probes.collect_step_probes(
                    raw_grads, None if applied is None else applied[0],
                    sync, sync_state, inline_sink, params,
                    synced_numel=None if applied is None else applied[1],
                    wire=wire_cache["wire"])
                if ctl is not None:
                    # the scale this step ran with (a copy: an actuation
                    # rewrites the operand in place before a later read)
                    metrics["telemetry"]["control_ratio_scale"] = \
                        ctl["bsc_ratio_scale"].clone()
        return TrainState(step=step + 1, params=params, opt_state=opt_state,
                          model_state=model_state,
                          sync_state=sync_state), metrics

    clock = step_clock()
    clock_fn = clock.new_fn()

    def train_step(state: TrainState, x: torch.Tensor, y: torch.Tensor):
        """One step under its own step-clock record (a mesh slot's own)."""
        rec = clock.open(clock_fn, next(iter(state.params.values())).device)
        try:
            with span(STEP_SPAN, annotation=False):
                return step_body(state, x, y)
        finally:
            clock.close(rec)

    if mesh is not None:
        def mesh_step(state, x, y):
            on = state.mesh if isinstance(state, PlacedTree) else mesh
            state, y = on.place(state), on.place(y)
            x = on.place(x, seq_dim=3 if sp_model else None)
            outs = run_on_mesh(train_step, on,
                               list(zip(state.slots, x.slots, y.slots)))
            return PlacedTree(on, [s for s, _ in outs]), outs[0][1]

        mesh_step.mgps = mgps  # as train_step.mgps: a slot's shards
        mesh_step.clock_fn = clock_fn
        return mesh_step
    train_step.mgps = mgps  # Trainer.init_state shapes the state by it
    train_step.clock_fn = clock_fn  # the fn of its step-clock records
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
