"""Batched, prefetching iterator over RecordIO datasets (port of
geomx_tpu/data/record_iter.py).

Reference: src/io's ImageRecordIter pipeline — indexed recordio read,
decode, batch, with a background prefetcher thread so the accelerator
never waits on IO (src/io/iter_image_recordio_2.cc, iter_prefetcher.h).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np

from geomx_tpu_torch.data.recordio import (recordio_reader, shard_bounds,
                                     unpack_labelled)


class PrefetchIter:
    """Wrap any iterator with an N-deep background prefetch thread
    (reference PrefetcherIter, src/io/iter_prefetcher.h).

    ``close()`` stops the pump thread promptly — call it (or let the
    owning iterator's close do it) when abandoning an epoch early, or the
    thread would stay blocked on the bounded queue."""

    _END = object()

    def __init__(self, it, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._finished = False

        def pump():
            try:
                for item in it:
                    while not self._stop.is_set():
                        try:
                            self._q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if self._stop.is_set():
                        return
            except BaseException as e:   # surfaced on the consumer side
                self._err = e
            finally:
                while not self._stop.is_set():
                    try:
                        self._q.put(self._END, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        self._t = threading.Thread(target=pump, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._finished:
            raise StopIteration  # stay exhausted; _END arrives only once
        item = self._q.get()
        if item is self._END:
            self._finished = True
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self):
        """Stop the pump thread and drop buffered items."""
        self._stop.set()
        self._finished = True
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._t.join(timeout=5)


class ImageRecordIter:
    """Batches of (images [b,h,w,c] u8, labels [b] i32) from a .rec file,
    with part_index/num_parts sharding and shuffled epochs."""

    def __init__(self, path: str, batch_size: int,
                 part_index: int = 0, num_parts: int = 1,
                 shuffle: bool = True, seed: int = 0,
                 prefetch: int = 2):
        self.reader = recordio_reader(path)
        n = len(self.reader)  # requires the .idx sidecar
        lo, hi = shard_bounds(n, part_index, num_parts)
        self._indices = np.arange(lo, hi)
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = prefetch
        self._live: list = []   # prefetchers to stop on close

    @property
    def steps_per_epoch(self) -> int:
        return len(self._indices) // self.batch_size

    def _epoch_batches(self, epoch: int) -> Iterator[Tuple[np.ndarray,
                                                           np.ndarray]]:
        order = self._indices.copy()
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(order)
        b = self.batch_size
        for s in range(self.steps_per_epoch):
            xs, ys = [], []
            for i in order[s * b:(s + 1) * b]:
                label, img = unpack_labelled(self.reader.read_idx(int(i)))
                xs.append(img)
                ys.append(label)
            yield np.stack(xs), np.asarray(ys, np.int32)

    def epoch(self, epoch: int = 0):
        it = PrefetchIter(self._epoch_batches(epoch), depth=self.prefetch)
        self._live = [p for p in self._live if not p._finished] + [it]
        return it

    def close(self):
        for p in self._live:
            p.close()
        self._live = []
        self.reader.close()
