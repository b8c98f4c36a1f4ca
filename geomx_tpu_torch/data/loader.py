"""Host-side batched loader for the HiPS topology (port of
geomx_tpu/data/loader.py).

Each ``(party, worker)`` replica trains on its own shard, produced by
``SplitSampler`` / ``ClassSplitSampler`` exactly as in the JAX package;
a global step consumes one batch per replica, stacked to

    [num_parties, workers_per_party, local_batch, H, W, C]  (uint8)

and copied to the loader's device, with labels as int64 ``[P, W, b]``.
For the same seed the batches are byte-identical to the JAX loader's
(same shard order, same numpy shuffles and augmentation draws).  The
prefetch thread and the device-cached dataset are not ported yet.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

from geomx_tpu_torch.data.samplers import (ClassSplitSampler, SplitSampler,
                                           class_sorted_indices)
from geomx_tpu_torch.device import resolve_device


class GeoDataLoader:
    def __init__(self, x: np.ndarray, y: np.ndarray, topology,
                 batch_size: int, split_by_class: bool = False,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 augment: bool = False, pad: int = 4, device=None):
        """``batch_size`` is per replica (the reference's -bs flag).
        ``augment=True`` applies the CIFAR recipe on the host: random
        crop from a ``pad``-pixel reflection border + horizontal flip."""
        self.topology = topology
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.augment = augment
        self.pad = int(pad)
        self.device = resolve_device(device)
        n_workers = topology.total_workers
        length = len(x)
        if split_by_class:
            order = class_sorted_indices(y)
            shards = [ClassSplitSampler(order, length, n_workers, i).indices()
                      for i in range(n_workers)]
        else:
            shards = [SplitSampler(length, n_workers, i).indices()
                      for i in range(n_workers)]
        self.x, self.y = x, y
        self.shards = shards
        self.steps_per_epoch = min(len(s) for s in shards) // self.batch_size
        if self.steps_per_epoch < 1:
            raise ValueError(
                f"shard of {min(len(s) for s in shards)} samples cannot fill "
                f"a batch of {self.batch_size}")

    def _epoch_order(self, epoch: int) -> list:
        rng = np.random.RandomState(self.seed + epoch)
        order = []
        for s in self.shards:
            idx = s.copy()
            if self.shuffle:
                rng.shuffle(idx)
            order.append(idx)
        return order

    def host_batches(self, epoch: int = 0
                     ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """The epoch's ``(x, y)`` batches as numpy arrays."""
        topo = self.topology
        order = self._epoch_order(epoch)
        rng = np.random.RandomState(self.seed + epoch + 1)  # augment stream
        b = self.batch_size
        for step in range(self.steps_per_epoch):
            sel = np.stack([idx[step * b:(step + 1) * b] for idx in order])
            xflat = self.x[sel.reshape(-1)]
            if self.augment:
                xflat = self._augment_batch(xflat, rng)
            xb = xflat.reshape(
                (topo.num_parties, topo.workers_per_party, b)
                + self.x.shape[1:])
            yb = self.y[sel.reshape(-1)].reshape(
                (topo.num_parties, topo.workers_per_party, b))
            yield xb, yb

    def epoch(self, epoch: int = 0
              ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        """Yield ``(x, y)`` global batches for one epoch on the device."""
        for xb, yb in self.host_batches(epoch):
            yield (torch.as_tensor(np.ascontiguousarray(xb),
                                   device=self.device),
                   torch.as_tensor(yb.astype(np.int64), device=self.device))

    def _augment_batch(self, x: np.ndarray,
                       rng: np.random.RandomState) -> np.ndarray:
        """Vectorized random crop (reflection pad) + horizontal flip."""
        n, h, w = x.shape[:3]
        p = self.pad
        padded = np.pad(x, ((0, 0), (p, p), (p, p), (0, 0)), mode="reflect")
        dy = rng.randint(0, 2 * p + 1, size=n)
        dx = rng.randint(0, 2 * p + 1, size=n)
        rows = dy[:, None] + np.arange(h)[None, :]
        cols = dx[:, None] + np.arange(w)[None, :]
        out = padded[np.arange(n)[:, None, None],
                     rows[:, :, None], cols[:, None, :]]
        flip = rng.rand(n) < 0.5
        out[flip] = out[flip, :, ::-1]
        return out
