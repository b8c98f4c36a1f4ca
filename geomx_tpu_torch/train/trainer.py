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

Runs on ``cuda`` unless the caller passes ``device="cpu"``; without a GPU
and without that request it raises.  Not ported yet: membership epochs,
checkpoints, scanned epochs, prefetch, telemetry, control, capsules and
the flight recorder.
"""

from __future__ import annotations

import json
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from geomx_tpu_torch.config import GeoConfig
from geomx_tpu_torch.data.loader import GeoDataLoader
from geomx_tpu_torch.device import resolve_device
from geomx_tpu_torch.ops.optim import fused_optim_enabled
from geomx_tpu_torch.sync import get_sync_algorithm
from geomx_tpu_torch.topology import HiPSTopology
from geomx_tpu_torch.train.state import (TrainState, replicate_tree,
                                         unreplicate_tree)
from geomx_tpu_torch.train.step import (build_eval_step, build_train_step,
                                        fused_bucketer, make_loss_fn,
                                        resolve_precision)
from geomx_tpu_torch.tree import leaf_names
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
        self.train_step = build_train_step(self.loss_fn, self.tx, self.sync,
                                           topology, self.config,
                                           sp_model=sp_model)
        # fused apply: init_state puts the optimizer state on the dc
        # tier's bucket layout (build_train_step checked the stack)
        self._fused_optim = fused_optim_enabled(self.config)
        self.eval_step = build_eval_step(self._sd_model)

    def init_state(self, seed: int = 0,
                   generator: Optional[torch.Generator] = None,
                   params: Optional[dict] = None,
                   model_state: Optional[dict] = None) -> TrainState:
        """The replicated initial state.

        Weights come either from ``params``/``model_state`` — flat dicts
        of one replica's arrays, e.g. converted JAX weights
        (``models.convert.from_flax``) — or from the model's initializers
        drawn with ``generator`` (default: a CPU generator seeded with
        ``seed``)."""
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
        if self._fused_optim:
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
        return TrainState(
            step=0, params=params, opt_state=opt_state,
            model_state=model_state,
            sync_state=self.sync.init_state(params, model_state=model_state))

    def make_loader(self, x, y, batch_size: int, split_by_class: bool = False,
                    seed: int = 0, augment: bool = False) -> GeoDataLoader:
        return GeoDataLoader(x, y, self.topology, batch_size,
                             split_by_class=split_by_class, seed=seed,
                             augment=augment, device=self.device)

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

    def fit(self, state: TrainState, loader: GeoDataLoader, epochs: int = 1,
            eval_data=None, eval_every: int = 0, log_every: int = 0,
            log_fn: Callable[[str], None] = print,
            measure: Optional[Measure] = None):
        """Run the training loop.

        - ``log_every=N``: record/log loss and train accuracy every N
          iterations (the only points where the host waits for the card);
        - ``eval_every=N``: test accuracy every N iterations; 0 = at each
          epoch end.

        Returns ``(state, list of record dicts)``."""
        measure = measure if measure is not None else Measure()
        measure.reset_clock()
        it = 0
        for epoch in range(epochs):
            for xb, yb in loader.epoch(epoch):
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
