"""Launch counters of the kernel wrappers.

A wrapper adds the launches it made through :func:`count`: to its
``launches`` attribute, the process total, and inside a mesh slot
(``parallel/collectives.run_on_mesh``) to that slot's own tally, both
under one lock, since a mesh's slots launch from threads of their own.
A backward node runs on the card's autograd thread, not the slot's: a
differentiable kernel keeps its forward's slot and counts its backward
launches for it (``collectives.attributed_to``).
"""

from __future__ import annotations

import threading

from geomx_tpu_torch.parallel.collectives import owning_slot

_lock = threading.Lock()
_by_slot: dict = {}  # slot coords -> {wrapper: launches}


def count(wrapper, n: int = 1) -> None:
    with _lock:
        wrapper.launches += n
        slot = owning_slot()
        if slot is not None:
            tally = _by_slot.setdefault(slot.coords, {})
            tally[wrapper] = tally.get(wrapper, 0) + n


def reset_slots() -> None:
    with _lock:
        _by_slot.clear()


def by_slot() -> dict:
    """``{(p, w): {wrapper: launches}}`` since the last reset (``(p, w,
    s)`` keys on an sp mesh)."""
    with _lock:
        return {k: dict(v) for k, v in _by_slot.items()}
