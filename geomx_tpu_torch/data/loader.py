"""Batched loader for the HiPS topology (port of geomx_tpu/data/loader.py).

Each ``(party, worker)`` replica trains on its own shard, produced by
``SplitSampler`` / ``ClassSplitSampler`` exactly as in the JAX package;
a global step consumes one batch per replica, stacked to

    [num_parties, workers_per_party, local_batch, H, W, C]  (uint8)

on the loader's device, with labels as int64 ``[P, W, b]``.  For the
same seed the host batches are byte-identical to the JAX loader's (same
shard order, same numpy shuffles and augmentation draws).

Two overlap mechanisms, as in the JAX package:

- ``epoch(e, prefetch=N)`` (N > 0) assembles batches on a producer
  thread with a bounded queue of N.  On a CUDA device the thread copies
  each batch from pinned host memory on a side stream and hands the
  consumer an event: the consumer's stream waits on it before the step
  reads the batch, and the tensors are recorded on the consumer's
  stream for the allocator.  An exception in the producer is re-raised
  in the consumer; abandoning an epoch stops the thread.
- ``device_cache=True`` keeps the whole dataset on the device; each step
  gathers its batch there from the ``[P, W, b]`` selection indices of
  :meth:`GeoDataLoader.epoch_indices` (one upload an epoch), with the
  crop and flip drawn on the device from an explicit ``torch.Generator``
  seeded by the epoch (:func:`gather_batch`).  The JAX package draws
  them with ``jax.random``, whose bits the port cannot reproduce: without
  augmentation the cached batches are the host loader's bytes.  On a
  device mesh (``mesh=``) each distinct mesh device holds one copy of
  the dataset, as the JAX package replicates it over its mesh; each step
  gathers the rows of a device's slots there (the crop and flip drawn
  once, on the first device, as the stacked loader draws them) and
  yields placed batches, each slot's block on its device.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from geomx_tpu_torch.data.samplers import (ClassSplitSampler, SplitSampler,
                                           class_sorted_indices)
from geomx_tpu_torch.device import resolve_device
from geomx_tpu_torch.topology import PlacedTree


def _reflect(idx: torch.Tensor, n: int) -> torch.Tensor:
    """numpy's ``reflect`` padding as a source index: ``-1 -> 1``, ``n ->
    n - 2`` (the edge is not repeated)."""
    idx = idx.abs()
    return torch.where(idx > n - 1, 2 * (n - 1) - idx, idx)


def _draws(n: int, generator: Optional[torch.Generator], dev, pad: int):
    """The crop offsets and flips of ``n`` images: ``(oy, ox, flip)``."""
    oy = torch.randint(0, 2 * pad + 1, (n,), generator=generator,
                       device=dev)
    ox = torch.randint(0, 2 * pad + 1, (n,), generator=generator,
                       device=dev)
    flip = torch.rand(n, generator=generator, device=dev) < 0.5
    return oy, ox, flip


def _crop(xb: torch.Tensor, oy, ox, flip, pad: int) -> torch.Tensor:
    """``xb`` (``[..., H, W, C]``) cropped and flipped by the draws, one
    gather whose row and column indices carry the offsets, the
    reflection and the flip."""
    lead = xb.shape[:-3]
    h, w, c = xb.shape[-3:]
    flat = xb.reshape((-1, h, w, c))
    dev = flat.device
    rows = _reflect(oy[:, None] + torch.arange(h, device=dev) - pad, h)
    cols = _reflect(ox[:, None] + torch.arange(w, device=dev) - pad, w)
    cols = torch.where(flip[:, None], cols.flip(1), cols)
    crops = flat[torch.arange(flat.shape[0], device=dev)[:, None, None],
                 rows[:, :, None], cols[:, None, :]]
    return crops.reshape(lead + (h, w, c))


def gather_batch(dx: torch.Tensor, dy: torch.Tensor, sel: torch.Tensor,
                 generator: Optional[torch.Generator], augment: bool,
                 pad: int):
    """On-device batch assembly: gather by index, then the CIFAR
    crop/flip recipe (a ``pad``-pixel reflect border, a random window,
    a horizontal flip with probability 1/2).  The draws come from
    ``generator`` (on ``dx``'s device)."""
    xb = dx[sel]                      # [P, W, b, H, W, C]
    yb = dy[sel]
    if augment:
        xb = _crop(xb, *_draws(sel.numel(), generator, xb.device, pad), pad)
    return xb, yb


class GeoDataLoader:
    def __init__(self, x: np.ndarray, y: np.ndarray, topology,
                 batch_size: int, split_by_class: bool = False,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 augment: bool = False, pad: int = 4, device=None,
                 device_cache: bool = False, mesh=None,
                 seq_dim: Optional[int] = None):
        """``batch_size`` is per replica (the reference's -bs flag).
        ``augment=True`` applies the CIFAR recipe: random crop from a
        ``pad``-pixel reflection border + horizontal flip (on the host,
        or on the device with ``device_cache=True``).  ``mesh``: with
        ``device_cache``, a ``topology.ReplicaMesh`` whose slots get
        placed batches (the loader's device is then its first device);
        ``seq_dim``: the batch dim its sp slots split (a token batch's
        sequence, ``mesh.place``)."""
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
        self.device_cache = bool(device_cache)
        self.mesh, self.seq_dim = mesh, seq_dim
        if mesh is not None:
            if not self.device_cache:
                raise ValueError("a loader takes a mesh with device_cache="
                                 "True (the step places host batches "
                                 "itself)")
            self.device = mesh.first_device
        if self.device_cache:
            # one copy of the dataset a distinct device
            self._cache = {
                d: (torch.as_tensor(np.ascontiguousarray(x), device=d),
                    torch.as_tensor(np.asarray(y).astype(np.int64),
                                    device=d))
                for d in ([self.device] if mesh is None
                          else mesh.distinct_devices())}
            self._dev_x, self._dev_y = self._cache[self.device]
        self._copy_stream = None

    def _epoch_order(self, epoch: int) -> list:
        rng = np.random.RandomState(self.seed + epoch)
        order = []
        for s in self.shards:
            idx = s.copy()
            if self.shuffle:
                rng.shuffle(idx)
            order.append(idx)
        return order

    def epoch_indices(self, epoch: int
                      ) -> Tuple[np.ndarray, torch.Generator]:
        """The whole epoch's selection indices at once, ``[steps, P, W,
        b]`` int64, and the epoch's generator on the loader's device (the
        crop and flip draws of :func:`gather_batch`, seeded ``seed +
        epoch``): the input of the scanned epoch
        (``Trainer.fit(scan_epochs=True)``)."""
        topo = self.topology
        order = self._epoch_order(epoch)
        b = self.batch_size
        sel = np.stack([
            np.stack([idx[step * b:(step + 1) * b] for idx in order])
            .reshape((topo.num_parties, topo.workers_per_party, b))
            for step in range(self.steps_per_epoch)]).astype(np.int64)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed + epoch)
        return sel, gen

    def cached_batches(self, sel: torch.Tensor, generator
                       ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        """The device-cached epoch: one on-device gather a step from the
        uploaded ``[steps, P, W, b]`` indices (on a mesh, one a distinct
        device, yielding placed batches)."""
        if self.mesh is not None:
            yield from self._placed_batches(sel, generator)
            return
        for step in range(sel.shape[0]):
            yield gather_batch(self._dev_x, self._dev_y, sel[step],
                               generator, self.augment, self.pad)

    def _placed_batches(self, sel: torch.Tensor, generator
                        ) -> Iterator[Tuple[PlacedTree, PlacedTree]]:
        """:meth:`cached_batches` on a mesh: each distinct device gathers
        the ``(p, w)`` rows of its slots from its own copy of the data
        (their indices uploaded there once an epoch), and each slot takes
        its row's ``[1, 1, b, ...]`` block, its sp chunk of the sequence
        where ``seq_dim`` says so."""
        mesh = self.mesh
        P, W = mesh.shape
        S = mesh.sp
        steps, b = sel.shape[0], sel.shape[-1]
        flat_sel = sel.reshape(steps, P * W, b)
        rows = {}  # device -> the (p, w) rows of its slots, in order
        for p, w, d in mesh.slots():
            rows.setdefault(d, [])
            if p * W + w not in rows[d]:
                rows[d].append(p * W + w)
        dev_sel = {d: flat_sel[:, r].to(d) for d, r in rows.items()}
        for step in range(steps):
            draws = _draws(P * W * b, generator, self.device, self.pad) \
                if self.augment else None
            xs, ys = {}, {}
            for d, r in rows.items():
                dx, dy = self._cache[d]
                idx = dev_sel[d][step]
                xd = dx[idx]                 # [len(r), b, H, W, C]
                if draws is not None:
                    pick = torch.as_tensor(r, device=self.device)
                    xd = _crop(xd, *(t.view(P * W, b)[pick].reshape(-1)
                                     .to(d) for t in draws), self.pad)
                xs[d], ys[d] = xd, dy[idx]
            xslots, yslots = [], []
            for p, w, s, d in mesh.slot_coords():
                j = rows[d].index(p * W + w)
                xb = xs[d][j:j + 1].unsqueeze(0)
                if self.seq_dim is not None and S > 1:
                    n = xb.shape[self.seq_dim] // S
                    xb = xb.narrow(self.seq_dim, s * n, n)
                xslots.append(xb)
                yslots.append(ys[d][j:j + 1].unsqueeze(0))
            yield (PlacedTree(mesh, xslots,
                              self.seq_dim if S > 1 else None),
                   PlacedTree(mesh, yslots))

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

    def _to_device(self, xb: np.ndarray, yb: np.ndarray):
        return (torch.as_tensor(np.ascontiguousarray(xb), device=self.device),
                torch.as_tensor(yb.astype(np.int64), device=self.device))

    def _stage(self, xb: np.ndarray, yb: np.ndarray):
        """A producer thread's copy of one batch: ``(x, y, event)``.  On
        CUDA the copy runs from pinned memory on the loader's side stream
        and ``event`` marks its end; elsewhere ``event`` is None."""
        if self.device.type != "cuda":
            return self._to_device(xb, yb) + (None,)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        with torch.cuda.device(self.device), \
                torch.cuda.stream(self._copy_stream):
            x = torch.from_numpy(np.ascontiguousarray(xb)).pin_memory() \
                .to(self.device, non_blocking=True)
            y = torch.from_numpy(yb.astype(np.int64)).pin_memory() \
                .to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        return x, y, event

    def _handoff(self, item):
        """The consumer's side of :meth:`_stage`: its stream waits for
        the copy, and the tensors are recorded on that stream."""
        x, y, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            x.record_stream(stream)
            y.record_stream(stream)
        return x, y

    def epoch(self, epoch: int = 0, prefetch: int = 2
              ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        """Yield ``(x, y)`` global batches for one epoch on the device.

        ``prefetch`` > 0 assembles and copies batches on a producer
        thread, at most ``prefetch`` ahead; 0 assembles them in the
        caller's thread.  A device-cached loader gathers on the device
        in the caller's thread (its only upload is the epoch's
        indices), whatever ``prefetch`` says."""
        if self.device_cache:
            sel, gen = self.epoch_indices(epoch)
            yield from self.cached_batches(
                torch.as_tensor(sel, device=self.device), gen)
            return
        if prefetch <= 0:
            for xb, yb in self.host_batches(epoch):
                yield self._to_device(xb, yb)
            return
        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            """Put unless the consumer abandoned the epoch; True if put."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for xb, yb in self.host_batches(epoch):
                    if not put_or_stop(self._stage(xb, yb)):
                        return
                put_or_stop(None)
            except BaseException as e:  # surfaced in the consumer
                put_or_stop(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield self._handoff(item)
        finally:
            stop.set()

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
