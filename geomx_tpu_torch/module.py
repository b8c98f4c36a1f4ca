"""High-level Module API — the ``mx.mod.Module`` surface (port of
geomx_tpu/module.py).

A model + optimizer + sync algorithm bound into one object with
``bind / get_params / fit / predict / score / save_checkpoint /
load_checkpoint`` and epoch callbacks: a thin veneer over ``Trainer``
for users coming from the reference API; new code should use
``Trainer`` directly.  Runs on ``cuda`` unless ``device="cpu"``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple, Union

import numpy as np

from geomx_tpu_torch import metric as metric_mod
from geomx_tpu_torch.config import GeoConfig
from geomx_tpu_torch.topology import HiPSTopology
from geomx_tpu_torch.tree import leaf_names
from geomx_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint


class Module:
    def __init__(self, model: Union[str, Any],
                 topology: Optional[HiPSTopology] = None,
                 config: Optional[GeoConfig] = None,
                 optimizer: Union[str, Any] = "adam",
                 optimizer_params: Optional[dict] = None,
                 sync: Optional[Any] = None,
                 num_classes: int = 10, device=None):
        from geomx_tpu_torch.models import get_model
        from geomx_tpu_torch.optim import get_optimizer
        from geomx_tpu_torch.sync import get_sync_algorithm
        from geomx_tpu_torch.train import Trainer

        self.config = config or GeoConfig.from_env()
        self.topology = topology or HiPSTopology(
            self.config.num_parties, self.config.workers_per_party)
        if isinstance(model, str):
            model = get_model(model, num_classes=num_classes)
        if isinstance(optimizer, str):
            optimizer = get_optimizer(optimizer,
                                      **(optimizer_params or {}))
        if sync is None:
            sync = get_sync_algorithm(self.config)
        self.trainer = Trainer(model, self.topology, optimizer,
                               sync=sync, config=self.config, device=device)
        self.state = None

    # ---- binding / params (reference module.bind / get_params) -----------

    def bind(self, sample_input: np.ndarray, seed: int = 0):
        """Initialize state from one sample batch (the reference's
        bind+init_params collapse into one call here)."""
        self.state = self.trainer.init_state(seed=seed,
                                             sample_input=sample_input)
        return self

    def _require_state(self):
        if self.state is None:
            raise RuntimeError("call bind() (or fit/load_checkpoint) first")

    def get_params(self) -> dict:
        """Replica (0, 0)'s parameters as numpy arrays, by dotted path."""
        self._require_state()
        return {k: self.state.params[k][0, 0].numpy(force=True)
                for k in leaf_names(self.state.params)}

    # ---- training (reference module.fit) ----------------------------------

    def fit(self, train_data: Tuple[np.ndarray, np.ndarray],
            eval_data: Optional[Tuple[np.ndarray, np.ndarray]] = None,
            num_epoch: int = 1, batch_size: int = 32,
            eval_metric: Union[str, Sequence[str]] = "acc",
            split_by_class: bool = False, augment: bool = False,
            epoch_end_callback: Optional[Callable] = None,
            verbose: bool = True):
        x, y = train_data
        if self.state is None:
            self.bind(x[:2])
        loader = self.trainer.make_loader(x, y, batch_size,
                                          split_by_class=split_by_class,
                                          augment=augment)
        for epoch in range(num_epoch):
            for xb, yb in loader.epoch(epoch,
                                       prefetch=self.trainer._prefetch):
                self.state, _ = self.trainer.train_step(self.state, xb, yb)
            if eval_data is not None:
                pairs = self.score(eval_data, eval_metric)
                if verbose:
                    msg = " ".join(f"{n}={v:.4f}" for n, v in pairs)
                    print(f"Epoch[{epoch}] Validation {msg}", flush=True)
            if epoch_end_callback is not None:
                epoch_end_callback(epoch, self)
        return self

    # ---- inference (reference module.predict / score) ---------------------

    def predict(self, x: np.ndarray, batch_size: int = 512) -> np.ndarray:
        """Logits for a host batch (``Trainer.predict_logits``)."""
        self._require_state()
        return self.trainer.predict_logits(self.state, np.asarray(x),
                                           batch_size=batch_size)

    def score(self, eval_data: Tuple[np.ndarray, np.ndarray],
              eval_metric: Union[str, Sequence[str]] = "acc"):
        """(name, value) pairs, like the reference's module.score."""
        self._require_state()
        m = metric_mod.create(list(eval_metric) if isinstance(
            eval_metric, (list, tuple)) else eval_metric)
        x, y = eval_data
        logits = self.predict(x)
        probs = np.exp(logits - logits.max(-1, keepdims=True))
        probs /= probs.sum(-1, keepdims=True)
        m.update(np.asarray(y), probs)
        return m.get_name_value()

    # ---- checkpointing (reference mx.model save/load_checkpoint) ----------

    def save_checkpoint(self, prefix: str, epoch: int) -> str:
        # the epoch names the file, reference-style (prefix-%04d)
        self._require_state()
        return save_checkpoint(f"{prefix}-{epoch:04d}.ckpt", self.state)

    def load_checkpoint(self, prefix: str, epoch: int,
                        sample_input: np.ndarray):
        """Restore a checkpoint into a freshly bound state (shapes come
        from ``sample_input``, values from the file)."""
        self.bind(sample_input)
        self.state = load_checkpoint(f"{prefix}-{epoch:04d}.ckpt",
                                     target=self.state)
        return self
