"""Geo-distributed serving plane (port of geomx_tpu/serve/).

The training side moves sparse gradient rounds; this package moves the
*result* of those rounds to where inference traffic is.  Four pieces,
layered on the host plane:

- :mod:`~geomx_tpu_torch.serve.registry` — the published-model store: a
  crash-recoverable :class:`~geomx_tpu_torch.resilience.durability.DurableStateStore`
  journal of ONE dense base snapshot per version plus sparse
  pair-format deltas (the sparseagg pair codec), replicated to serving
  parties over the binary wire with P3 early-layer-first refresh and
  generation-token restart detection;
- :mod:`~geomx_tpu_torch.serve.replica` — the per-party serving copy:
  applies O(k) pair deltas with the same (sender, rid)/round dedup the
  training wire uses, swaps params atomically so inference never reads
  a torn refresh, and tracks freshness;
- :mod:`~geomx_tpu_torch.serve.gateway` — the inference front door:
  ``POST /infer`` on the shared HTTP exporter, request coalescing into
  a bounded queue, a continuous-batching worker dispatching the zoo
  model's forward at padded bucket sizes (one captured CUDA graph a
  bucket on the card), and the per-request causal ledger (enqueue ->
  batch -> forward -> reply);
- :mod:`~geomx_tpu_torch.serve.infer_wire` — the native binary
  ``/infer`` lane beside the HTTP door.

Everything at module scope here is host-plane Python — no torch import
(the scheduler process reads :func:`serving_surface` for its
``/healthz`` body; only the gateway's forward path touches torch).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional

# ---------------------------------------------------------------------------
# the serving surface the scheduler's /healthz reports: whichever
# gateway/replica runs in this process registers a zero-arg snapshot
# callable; the scheduler reads it lazily and best-effort
# ---------------------------------------------------------------------------

_surface_lock = threading.Lock()
_surface_fns: Dict[str, Callable[[], Dict[str, Any]]] = {}


def register_serving_surface(name: str,
                             fn: Optional[Callable[[], Dict[str, Any]]]
                             ) -> None:
    """Install (or, with ``fn=None``, remove) a named serving-surface
    snapshot provider.  The scheduler's ``/healthz`` merges every
    registered provider's dict under ``"serving"``."""
    with _surface_lock:
        if fn is None:
            _surface_fns.pop(name, None)
        else:
            _surface_fns[name] = fn


def serving_surface() -> Optional[Dict[str, Any]]:
    """The merged serving snapshot, or None when nothing serves in this
    process.  Provider failures are isolated per name — one broken
    snapshot must not blank the whole health surface."""
    with _surface_lock:
        fns = dict(_surface_fns)
    if not fns:
        return None
    out: Dict[str, Any] = {}
    for name, fn in sorted(fns.items()):
        try:
            out[name] = fn()
        except Exception as e:
            out[name] = {"error": repr(e)}
    return out


def reset_serving_surface() -> None:
    """Drop every registered provider (test isolation)."""
    with _surface_lock:
        _surface_fns.clear()
