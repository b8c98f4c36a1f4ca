"""High-level Trainer (port of the fit path of geomx_tpu/train/trainer.py).

Wires model + optimizer + sync algorithm + topology into a fit loop with
per-iteration records, as the JAX ``Trainer.init_state``/``make_loader``/
``fit``/``evaluate`` do.  The model is a template ``nn.Module``: the
weights live in the ``TrainState`` with ``[P, W]`` replica axes, and
each replica's forward substitutes its own slice
(``torch.func.functional_call``).

An sp-aware model (``SeqClassifier(sp_mode="ring")``) takes each
replica's sequence as ``topology.sp_degree`` chunks (``train/step.py``);
evaluation runs its ``single_device_model`` twin, which has the
same parameters and no sp axis.

``drain_pipeline`` applies a pipelined sync's last in-flight aggregate
after ``fit`` (under ZeRO, the parked shard aggregates through
``ZeroPlan.apply_shard_update``).

``GeoConfig(zero=True)`` binds a ``ZeroPlan`` into a copy of the sync
algorithm here (the caller's is never changed) and allocates the
optimizer state on the bucket shards; ``GeoConfig(multi_gps=True)``
allocates it on the mixed tree (``MultiGPSPlan.mixed_example``).

Models that size their layers from the input (the demo CNN, the MLP,
AlexNet, the ResNets' stem) are built from ``init_state``'s
``sample_input``, as the JAX ``init_state(rng, sample_input)`` sizes
them.  ``fit`` assembles batches ``config.prefetch`` ahead on a producer
thread (``GEOMX_PREFETCH``); ``fit(scan_epochs=True)`` runs each epoch
from a device-cached loader (``make_loader(device_cache=True)``) with no
host wait inside the epoch.  ``save_checkpoint``/``load_checkpoint``
write and read the JAX package's envelope (``utils/checkpoint.py``),
re-sharding ZeRO state onto another worker count (``train/zero.py``).

Runs on ``cuda`` unless the caller passes ``device="cpu"``; without a GPU
and without that request it raises.  Not ported yet: membership epochs,
the catch-up payload, telemetry, control, capsules and the flight
recorder.
"""

from __future__ import annotations

import json
import math
import warnings
from typing import Callable, Optional

import numpy as np
import torch
from torch.profiler import record_function

from geomx_tpu_torch.config import GeoConfig
from geomx_tpu_torch.data.loader import GeoDataLoader
from geomx_tpu_torch.device import resolve_device
from geomx_tpu_torch.ops.optim import fused_optim_enabled
from geomx_tpu_torch.sync import get_sync_algorithm
from geomx_tpu_torch.topology import HiPSTopology
from geomx_tpu_torch.train.state import (TrainState, replicate_tree,
                                         unreplicate_tree)
from geomx_tpu_torch.train.step import (build_eval_step, build_logits_fn,
                                        build_train_step, fused_bucketer,
                                        make_loss_fn, resolve_precision)
from geomx_tpu_torch.train.zero import (ZeroPlan, reshard_zero_state,
                                        zero_checkpoint_meta)
from geomx_tpu_torch.tree import leaf_names
from geomx_tpu_torch.utils import checkpoint
from geomx_tpu_torch.utils.metrics import Measure


class Trainer:
    def __init__(self, model: torch.nn.Module, topology: HiPSTopology,
                 optimizer, sync=None, config: Optional[GeoConfig] = None,
                 device=None, single_device_model=None):
        """``single_device_model``: a twin of ``model`` with the same
        parameters and no sp axis, for evaluation; required to evaluate
        an sp-aware model."""
        self.device = resolve_device(device)
        self.model = model
        self._sd_model = single_device_model or model
        self.topology = topology
        self.config = config or GeoConfig(
            num_parties=topology.num_parties,
            workers_per_party=topology.workers_per_party)
        self.sync = sync if sync is not None \
            else get_sync_algorithm(self.config)
        self.tx = optimizer
        self._precision = resolve_precision(self.config)
        compute_dtype = torch.bfloat16 if self._precision == "bf16" else None
        if self._precision == "bf16" and \
                getattr(model, "dtype", torch.float32) == torch.float32:
            warnings.warn(
                "GEOMX_PRECISION=bf16 but the model's compute dtype is "
                "float32: its layers will promote back to fp32. Build the "
                "model with get_model(name, precision='bf16')",
                stacklevel=2)
        sp_model = getattr(model, "sp_mode", None) is not None
        if getattr(topology, "sp_degree", 1) > 1 and not sp_model:
            warnings.warn(
                f"topology has sp_degree={topology.sp_degree} but the "
                "model declares no sp_mode: inputs stay replicated over "
                "the sp axis and every sp device computes the same thing "
                "— correct but wasted chips. Use an sp-aware model (e.g. "
                "SeqClassifier(sp_mode='ring')) or sp_degree=1.",
                RuntimeWarning, stacklevel=2)
        self.loss_fn = make_loss_fn(model, compute_dtype=compute_dtype)
        # the ZeRO plan binds here, onto the copy bind_zero returns, so
        # the trainer's own sync carries it (shard-shaped state, the
        # sharded drain); build_train_step reuses it
        if getattr(self.config, "zero", False):
            if getattr(self.sync, "supports_zero", False) \
                    and self.sync.zero_plan is None:
                self.sync = self.sync.bind_zero(
                    ZeroPlan(topology.workers_per_party))
        elif getattr(self.sync, "zero_plan", None) is not None:
            raise ValueError(
                "sync algorithm is ZeRO-bound (zero_plan set) but this "
                "trainer's config has zero=False: the step program would "
                "run the replicated update against shard-shaped sync "
                "state.  Pass a fresh (unbound) sync algorithm, or "
                "enable GEOMX_ZERO/GeoConfig(zero=True) to match")
        self.train_step = build_train_step(self.loss_fn, self.tx, self.sync,
                                           topology, self.config,
                                           sp_model=sp_model)
        self._mgps = self.train_step.mgps
        self._zero_plan = getattr(self.sync, "zero_plan", None)
        # fused apply: init_state puts the optimizer state on the dc
        # tier's bucket layout (build_train_step checked the stack)
        self._fused_optim = fused_optim_enabled(self.config)
        self.eval_step = build_eval_step(self._sd_model)
        self._logits_fn = build_logits_fn(self._sd_model)
        self._prefetch = max(0, int(getattr(self.config, "prefetch", 2)))

    def init_state(self, seed: int = 0,
                   generator: Optional[torch.Generator] = None,
                   params: Optional[dict] = None,
                   model_state: Optional[dict] = None,
                   sample_input=None) -> TrainState:
        """The replicated initial state.

        Weights come either from ``params``/``model_state`` — flat dicts
        of one replica's arrays, e.g. converted JAX weights
        (``models.convert.from_flax``) — or from the model's initializers
        drawn with ``generator`` (default: a CPU generator seeded with
        ``seed``).  ``sample_input`` (one local batch, ``[b, H, W, C]``)
        sizes the layers of a model that takes them from the input, as
        the JAX ``init_state(rng, sample_input)`` does; such a model
        needs it."""
        self._build_models(sample_input)
        if params is None:
            if generator is None:
                generator = torch.Generator().manual_seed(int(seed))
            self.model.reset_parameters(generator)
            params = {k: p.detach() for k, p in
                      self.model.named_parameters()}
            model_state = {k: b.detach() for k, b in
                           self.model.named_buffers()}
        params = {k: torch.as_tensor(params[k], dtype=torch.float32)
                  for k in leaf_names(params)}
        model_state = {k: torch.as_tensor(v, dtype=torch.float32)
                       for k, v in (model_state or {}).items()}
        params = replicate_tree(params, self.topology, self.device)
        model_state = replicate_tree(model_state, self.topology, self.device)
        sync_state = None
        if self._mgps is not None:
            # MultiGPS: the optimizer and dc-tier state of the big leaves
            # are allocated a worker shard each
            mixed = self._mgps.mixed_example(params)
            opt_state = self.tx.init(mixed)
            sync_state = self.sync.init_state(mixed, model_state=model_state)
            dc = getattr(self.sync, "dc_compressor", None)
            if dc is not None and getattr(dc, "fuses_tree", False):
                # a tree-fusing dc compressor (DGT) runs one schedule a
                # layout group (train/step.py splits the same way)
                names = leaf_names(params)
                sizes = [math.prod(params[k].shape[2:]) for k in names]
                big, small = self._mgps.split_mixed(sizes, names)
                sync_state = dict(sync_state, dc_comp={
                    "sharded": dc.init_state({k: mixed[k] for k in big}),
                    "replicated": dc.init_state({k: mixed[k]
                                                 for k in small})})
        elif self._zero_plan is not None:
            # ZeRO: the optimizer runs on [P, W, n/W] bucket shards, so
            # its state is allocated shard-shaped; the sync's init sizes
            # the dc-tier residuals the same way
            opt_state = self.tx.init(self._zero_plan.shard_example(
                params, self._zero_plan.bucketed))
        elif self._fused_optim:
            # one [P, W, n] fp32 tensor a bucket, lane-padded sizes: the
            # layout the dc tier fuses gradients onto
            bk = fused_bucketer(self.sync)([params[k]
                                            for k in leaf_names(params)])
            lead = self.topology.replica_shape
            opt_state = self.tx.init([
                torch.zeros(lead + (n,), dtype=torch.float32,
                            device=self.device) for n in bk.bucket_sizes])
        else:
            opt_state = self.tx.init(params)
        if sync_state is None:
            sync_state = self.sync.init_state(params,
                                              model_state=model_state)
        return TrainState(step=0, params=params, opt_state=opt_state,
                          model_state=model_state, sync_state=sync_state)

    def _build_models(self, sample_input) -> None:
        """Size the models' layers from one sample batch (models with a
        ``build``); without one, a model that needs it raises."""
        models = {id(m): m for m in (self.model, self._sd_model)}.values()
        if sample_input is None:
            for m in models:
                if not getattr(m, "built", True):
                    raise ValueError(
                        f"{type(m).__name__} sizes its layers from the "
                        "input: pass init_state(sample_input=x[:2])")
            return
        shape = tuple(np.shape(sample_input)[1:])
        for m in models:
            if hasattr(m, "build"):
                m.build(shape)

    # ---- checkpointing ---------------------------------------------------

    def checkpoint_meta(self) -> dict:
        """The meta block a checkpoint of this trainer's state carries:
        whether the state is ZeRO-sharded and the topology it was
        sharded over, so :meth:`load_checkpoint` can re-shard onto a
        different worker count and reject a GEOMX_ZERO mismatch."""
        return zero_checkpoint_meta(self._zero_plan, self.topology)

    def save_checkpoint(self, path: str, state: TrainState,
                        step=None) -> str:
        """Save ``state`` with this trainer's layout meta.  The tensors
        keep their full ``[P, W, ...]`` replica axes, so a ZeRO run's
        per-worker shards are all captured (restoring onto the same
        topology is bit-exact, mid-pipeline buffers included)."""
        return checkpoint.save_checkpoint(path, state, step=step,
                                          meta=self.checkpoint_meta())

    def load_checkpoint(self, path: str, template: TrainState) -> TrainState:
        """Restore a checkpoint into this trainer.

        ``template`` is a state with this trainer's structure and
        placement (fresh ``init_state`` output).  Rules, as in the JAX
        package:

        - the checkpoint's ZeRO flag must match this trainer's
          ``GEOMX_ZERO`` (else ``ValueError``);
        - same topology: leaves are placed directly (bit-exact resume,
          mid-pipeline buffers included);
        - another worker count (e.g. saved on 2x4, restored onto 2x2):
          shard-bearing leaves are gathered into full flat buckets and
          re-split (``train/zero.py`` ``reshard_zero_state``)."""
        host, meta = checkpoint.load_checkpoint(path, with_meta=True)
        ck_zero = bool((meta or {}).get("zero", False))
        if ck_zero != (self._zero_plan is not None):
            have = "GEOMX_ZERO=1" if ck_zero else "GEOMX_ZERO=0 (replicated)"
            want = "GEOMX_ZERO=1" if self._zero_plan is not None \
                else "GEOMX_ZERO=0 (replicated)"
            raise ValueError(
                f"checkpoint at {path!r} was saved with {have} but this "
                f"trainer runs {want}: the optimizer-state layouts are "
                "incompatible (sharded flat buckets vs replicated "
                "leaves).  Restore with a matching GEOMX_ZERO setting, "
                "or re-save from a trainer in the target mode")
        topo_meta = (int((meta or {}).get("num_parties",
                                          self.topology.num_parties)),
                     int((meta or {}).get("workers_per_party",
                                          self.topology.workers_per_party)))
        here = (self.topology.num_parties, self.topology.workers_per_party)
        if not ck_zero or topo_meta == here:
            return checkpoint.place_like(host, template)
        return reshard_zero_state(host, template)

    def drain_pipeline(self, state: TrainState) -> TrainState:
        """Apply a pipelined sync's completed in-flight dc-tier aggregate
        without feeding a batch (``sync/pipeline.py``): after the last
        ``fit``, the last launched gradient and its model-state
        (BatchNorm) aggregate have not been applied.  A no-op for
        algorithms without ``drain_grads``.  No collectives run but
        ZeRO's all-gather of the params: the buffers hold reduced values.
        The gradient buffer comes back zeroed (a later ``fit`` warms up
        again); the model-state buffer keeps the applied value.  Under
        ZeRO the parked shard aggregates go through
        ``ZeroPlan.apply_shard_update``, the fused kernels included, as
        in the JAX package."""
        sync = self.sync
        if not hasattr(sync, "drain_grads"):
            return state
        zplan = self._zero_plan
        if zplan is not None:
            with record_function("train/drain"):
                g_sh, sync_state = sync.drain_grad_shards(state.params,
                                                          state.sync_state)
                params, opt_state = zplan.apply_shard_update(
                    self.tx, g_sh, state.params, state.opt_state)
                model_state, sync_state = sync.drain_model_state(
                    state.model_state, sync_state)
            return TrainState(step=state.step, params=params,
                              opt_state=opt_state, model_state=model_state,
                              sync_state=sync_state)
        if self._fused_optim:
            # the JAX package's drain (geomx_tpu/train/trainer.py:789)
            # hands the leaf-tree aggregate to tx.update against the
            # optimizer state on the bucket layout, and raises
            # ValueError for the mismatched trees; so does the port
            raise ValueError(
                "Trainer.drain_pipeline does not compose with "
                "GEOMX_FUSED_OPTIM: the drained aggregate is a leaf tree "
                "and the fused optimizer state lives on the dc tier's "
                "flat buckets (the JAX package's drain raises too)")
        with record_function("train/drain"):
            g, sync_state = sync.drain_grads(state.params, state.sync_state)
            params, opt_state = self.tx.update(g, state.opt_state,
                                               state.params)
            model_state, sync_state = sync.drain_model_state(
                state.model_state, sync_state)
        return TrainState(step=state.step, params=params,
                          opt_state=opt_state, model_state=model_state,
                          sync_state=sync_state)

    def make_loader(self, x, y, batch_size: int, split_by_class: bool = False,
                    seed: int = 0, augment: bool = False,
                    device_cache: bool = False) -> GeoDataLoader:
        """``device_cache=True`` keeps the dataset on this trainer's
        device and gathers each batch there (``data/loader.py``), the
        input of ``fit(scan_epochs=True)``."""
        return GeoDataLoader(x, y, self.topology, batch_size,
                             split_by_class=split_by_class, seed=seed,
                             augment=augment, device=self.device,
                             device_cache=device_cache)

    def predict_logits(self, state: TrainState, x: np.ndarray,
                       batch_size: int = 512) -> np.ndarray:
        """Logits of replica (0, 0) over a host array, as an fp32 numpy
        array (the one evaluation forward ``Module.predict``/``score``
        use)."""
        params = unreplicate_tree(state.params)
        model_state = unreplicate_tree(state.model_state)
        outs = []
        for s in range(0, len(x), batch_size):
            xb = torch.as_tensor(np.ascontiguousarray(x[s:s + batch_size]),
                                 device=self.device)
            logits = self._logits_fn(params, model_state, xb)
            outs.append(logits.float().cpu().numpy())
        return np.concatenate(outs) if outs else np.zeros((0,), np.float32)

    def evaluate(self, state: TrainState, x: np.ndarray, y: np.ndarray,
                 batch_size: int = 512) -> float:
        """Test accuracy of replica (0, 0) over ``(x, y)``."""
        params = unreplicate_tree(state.params)
        model_state = unreplicate_tree(state.model_state)
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        for s in range(0, len(x), batch_size):
            xb = torch.as_tensor(np.ascontiguousarray(x[s:s + batch_size]),
                                 device=self.device)
            yb = torch.as_tensor(np.asarray(y[s:s + batch_size]),
                                 device=self.device).long()
            c, _ = self.eval_step(params, model_state, xb, yb)
            correct += c
        return int(correct) / max(len(x), 1)

    def run_epoch(self, state: TrainState, loader: GeoDataLoader,
                   epoch: int):
        """One epoch from a device-cached loader: the epoch's indices
        uploaded once, each step's batch gathered on the device, the
        metrics kept on the device and stacked at the end, so the host
        never waits inside the epoch.  Returns ``(state, {"loss":
        [steps], "accuracy": [steps]})`` on the device."""
        sel, gen = loader.epoch_indices(epoch)
        sel = torch.as_tensor(sel, device=self.device)
        losses, accs = [], []
        for xb, yb in loader.cached_batches(sel, gen):
            state, metrics = self.train_step(state, xb, yb)
            losses.append(metrics["loss"])
            accs.append(metrics["accuracy"])
        return state, {"loss": torch.stack(losses),
                       "accuracy": torch.stack(accs)}

    def fit(self, state: TrainState, loader: GeoDataLoader, epochs: int = 1,
            eval_data=None, eval_every: int = 0, log_every: int = 0,
            log_fn: Callable[[str], None] = print,
            measure: Optional[Measure] = None, scan_epochs: bool = False):
        """Run the training loop.

        - ``log_every=N``: record/log loss and train accuracy every N
          iterations (the only points where the host waits for the card);
        - ``eval_every=N``: test accuracy every N iterations; 0 = at each
          epoch end;
        - ``scan_epochs=True`` (requires a device-cached loader) runs each
          epoch with no host wait inside it (:meth:`run_epoch`), as the
          JAX package's scanned epoch: logging coarsens to one record an
          epoch (the epoch's mean loss and accuracy), and evaluation runs
          between epochs.  The state is the per-step loop's.

        Returns ``(state, list of record dicts)``."""
        measure = measure if measure is not None else Measure()
        measure.reset_clock()
        if scan_epochs:
            if not getattr(loader, "device_cache", False):
                raise ValueError("scan_epochs requires device_cache=True "
                                 "on the loader")
            it = 0
            for epoch in range(epochs):
                state, ms = self.run_epoch(state, loader, epoch)
                it += loader.steps_per_epoch
                fields = {}
                if log_every:
                    fields.update(loss=float(ms["loss"].mean()),
                                  train_acc=float(ms["accuracy"].mean()))
                if eval_data is not None:
                    fields["test_acc"] = self.evaluate(state, *eval_data)
                if fields:
                    rec = measure.add(epoch=epoch, iteration=it, **fields)
                    log_fn(json.dumps(rec))
            return state, measure.records
        it = 0
        for epoch in range(epochs):
            for xb, yb in loader.epoch(epoch, prefetch=self._prefetch):
                state, metrics = self.train_step(state, xb, yb)
                it += 1
                fields = {}
                if log_every and it % log_every == 0:
                    fields.update(loss=float(metrics["loss"]),
                                  train_acc=float(metrics["accuracy"]))
                if eval_data is not None and eval_every \
                        and it % eval_every == 0:
                    fields["test_acc"] = self.evaluate(state, *eval_data)
                if fields:
                    rec = measure.add(epoch=epoch, iteration=it, **fields)
                    log_fn(json.dumps(rec))
            if eval_data is not None and not eval_every:
                rec = measure.add(epoch=epoch, iteration=it,
                                  test_acc=self.evaluate(state, *eval_data))
                log_fn(json.dumps(rec))
        return state, measure.records
