"""P3 — Priority-based Parameter Propagation (port of
geomx_tpu/transport/p3.py).

Reference semantics: large tensors are sliced into chunks
(src/kvstore/kvstore_dist.h:835-872 — slice size ``bigarray_bound / 2``)
and every chunk is tagged with its layer's priority (the python worker
pushes with ``priority=-idx``, examples/cnn.py:124-125); the send queue is
a priority queue ordered by that tag
(3rdparty/ps-lite/include/ps/internal/threadsafe_queue.h:19-60), so
front-layer parameters win the wire and the next iteration's forward pass
can start before the rest have synced.

TPU mapping: within one jitted step XLA already schedules collectives to
overlap compute, and per-layer ordering is expressed by putting each
layer's collective adjacent to its consumer.  The explicit queue/slicer
here drives the *host-side* async store (``geomx_tpu_torch.store``), which does
move tensors one message at a time and benefits from exactly the
reference's ordering.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import threading
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Chunk:
    key: Any            # tensor key
    index: int          # chunk number within the tensor
    num_chunks: int
    start: int          # flat element offset
    stop: int
    priority: int       # higher = sent earlier


class P3Slicer:
    """Slice flat tensors into priority-tagged chunks.

    ``slice_elems`` mirrors the reference's ``bigarray_bound / 2`` default
    chunking of big tensors (kvstore_dist.h:858-869).
    """

    def __init__(self, slice_elems: int = 500_000):
        if slice_elems < 1:
            raise ValueError("slice_elems must be >= 1")
        self.slice_elems = int(slice_elems)

    def chunks(self, key: Any, size: int, priority: int = 0) -> List[Chunk]:
        num = max(1, -(-size // self.slice_elems))
        out = []
        for i in range(num):
            start = i * self.slice_elems
            stop = min(size, start + self.slice_elems)
            out.append(Chunk(key=key, index=i, num_chunks=num,
                             start=start, stop=stop, priority=priority))
        return out

    @staticmethod
    def reassemble(size: int, pieces: Sequence[Tuple[Chunk, np.ndarray]]) -> np.ndarray:
        out = np.zeros((size,), dtype=pieces[0][1].dtype if pieces else np.float32)
        seen = 0
        for chunk, data in pieces:
            out[chunk.start:chunk.stop] = data
            seen += chunk.stop - chunk.start
        if seen != size:
            raise ValueError(f"reassembled {seen} of {size} elements")
        return out


class ChunkAssembler:
    """Reassemble a chunked tensor stream — the receive half of P3,
    shared by the server's push reassembly and the client's pull-reply
    reassembly so the chunk wire protocol has one source of truth.

    ``feed(meta, piece)`` folds one chunk in and returns the completed
    tensor (reshaped) when the set completes, else None.  The assembly
    signature is (n_total, num_chunks, gen): a sender that re-slices a
    NEWER value (e.g. a retransmit-triggered second reply) bumps ``gen``,
    which resets the assembly — stale and fresh chunks must never blend
    into a torn tensor.

    ``clear_on_complete=False`` keeps the buffer after completion (the
    server's merge path clears explicitly only once the merge really
    happened, so a retransmitted final chunk can retry after a failure).
    """

    def __init__(self, clear_on_complete: bool = True,
                 monotonic_gen: bool = False):
        """``monotonic_gen=True``: generations are ordered (per-key push
        rounds); a chunk from an OLDER generation than the current
        assembly is dropped instead of resetting it — a stale straggler
        block must never destroy a fresh round's arrived chunks."""
        self.clear_on_complete = clear_on_complete
        self.monotonic_gen = monotonic_gen
        self._st: Optional[dict] = None

    @property
    def gen(self):
        """The in-flight assembly's generation (None if empty)."""
        return None if self._st is None else self._st["sig"][2]

    def feed(self, meta: dict, piece: np.ndarray):
        n = int(meta["n_total"])
        num = int(meta["num_chunks"])
        # pushes carry the key round, pull replies a reply generation —
        # either way a chunk from a different transfer resets the set
        sig = (n, num, meta.get("gen", meta.get("round")))
        if self._st is not None and self._st["sig"] != sig:
            if self.monotonic_gen and isinstance(sig[2], int) \
                    and isinstance(self._st["sig"][2], int) \
                    and sig[2] < self._st["sig"][2]:
                return None  # stale straggler: drop, keep the fresh set
            self._st = None
        if self._st is None:
            self._st = {"sig": sig, "buf": np.zeros((n,), np.float32),
                        "got": set(), "shape": tuple(meta["shape"])}
        st = self._st
        flat = np.asarray(piece, np.float32).reshape(-1)
        start = int(meta["start"])
        st["buf"][start:start + flat.size] = flat
        st["got"].add(int(meta["chunk"]))
        if len(st["got"]) < num:
            return None
        out = st["buf"].reshape(st["shape"])
        if self.clear_on_complete:
            self._st = None
        return out

    def force(self):
        """Finalize an INCOMPLETE assembly: the buffer as-is, with
        never-arrived chunks as zeros — the best-effort DGT semantics
        where a lost low-contribution block is simply gone.  Returns
        None if nothing was fed.  Clears the assembly."""
        if self._st is None:
            return None
        out = self._st["buf"].reshape(self._st["shape"])
        self._st = None
        return out


class PrioritySendQueue:
    """Thread-safe max-priority queue with FIFO tie-breaking.

    Functional equivalent of the reference's ThreadsafeQueue whose Pop
    always takes the highest ``meta.priority`` message
    (threadsafe_queue.h:50-58).
    """

    def __init__(self):
        self._heap: list = []
        self._count = itertools.count()
        self._cv = threading.Condition()
        self._closed = False

    def push(self, item: Any, priority: int = 0) -> None:
        with self._cv:
            if self._closed:
                raise RuntimeError("queue closed")
            heapq.heappush(self._heap, (-priority, next(self._count), item))
            self._cv.notify()

    def pop(self, timeout: Optional[float] = None) -> Optional[Any]:
        """Highest-priority item; FIFO among equals. None on close/timeout."""
        with self._cv:
            while not self._heap and not self._closed:
                if not self._cv.wait(timeout=timeout):
                    return None
            if not self._heap:
                return None
            return heapq.heappop(self._heap)[2]

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def __len__(self) -> int:
        with self._cv:
            return len(self._heap)
