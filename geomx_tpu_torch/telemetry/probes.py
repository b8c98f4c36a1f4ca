"""Step-health probes (port of geomx_tpu/telemetry/probes.py).

The probes compute, as cheap tensor reductions inside the training step,
the evidence a run needs in situ: the applied gradient's norm and
finiteness, which party's raw gradient went non-finite, the density the
dc tier really achieved, the error-feedback mass, and the static wire
accounting.  The values stay device tensors in ``metrics["telemetry"]``:
the fit loop reads them at the log boundary it already waits on
(:func:`host_probes`, one copy for the whole dict), never with a host
round trip of their own.

The master switch is ``GEOMX_TELEMETRY`` (or ``GeoConfig(telemetry=
True)``).  The gate is decided when the step is *built*
(``train/step.py``), as the JAX gate is decided at trace time, and it
guards a single call site.  The JAX package pins "the disabled step's
jaxpr is byte-identical to a build without this module"; the port's form
of that guarantee is "the disabled step dispatches the same op sequence
and launches the same kernels as a step whose probe call site is
removed" (``tests/test_torch_telemetry.py`` records the ATen op
sequence; ``chip_smoke.py`` counts the kernels on the card).

Every tensor the port's step holds carries the ``[P, W]`` replica axes,
so a party-local value is a ``[P, W]`` tensor (one value a replica), and
:func:`_replicate` folds it through the collectives the JAX package's
probes run: the ``pmean`` over the worker axis, then the dc ``pmean`` or
the survivors' ``psum`` over ``num_live``.  In a device-mesh slot the
same calls meet the other slots (``parallel/collectives.py``), so a
slot's probes are the stacked probes' bits.  The probe catalog is the
JAX package's:

- ``grad_norm_global``       L2 norm of the applied (post-sync) gradient
- ``grad_all_finite``        1.0 iff the applied gradient has no NaN/Inf
- ``grad_nonfinite_count``   number of non-finite applied-grad elements
- ``party_grad_nonfinite``   per-party 0/1 vector: the party's RAW
                             gradient (before the dc tier) has NaN/Inf
- ``grad_nonfinite_parties`` the sum of that vector
- ``dc_nonzero_fraction``    achieved density of the applied gradient
- ``ef_residual_norm`` (and the algorithm's other scalars)
                             ``sync.telemetry_scalars``, live-party mean
- ``bsc_emitted_fraction``   fraction of the fixed-k wire slots carrying
                             real pairs (recorded inline by BSC)
- ``dc_wire_bytes`` / ``dc_dense_bytes`` / ``dc_compression_ratio`` /
  ``worker_wire_bytes`` / ``pipeline_*`` / ``zero_*``
                             static wire accounting
                             (``sync.wire_accounting``), float32-rounded
                             as the JAX constants are, kept as Python
                             floats (a constant needs no device copy)

On the bucketed fused path the applied gradient is the flat bucket the
fused apply already built (one ``isfinite`` pass and one norm cover the
whole tree); bucket padding is zero, and the density's denominator is
the unpadded element count.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def telemetry_enabled(config: Optional[Any] = None) -> bool:
    """The master telemetry gate: ``config.telemetry`` or
    ``GEOMX_TELEMETRY``, parsed with the numeric-boolean rule of every
    GEOMX_* knob.  Decided when the step is built, so flipping it is a
    rebuild."""
    if config is not None and getattr(config, "telemetry", False):
        return True
    from geomx_tpu_torch.config import _env_bool
    return _env_bool(["GEOMX_TELEMETRY"], False)


# ---------------------------------------------------------------------------
# inline recording: compressors deep inside the sync stack contribute
# probe values without threading a sink through every signature
# ---------------------------------------------------------------------------

_inline = threading.local()


@contextlib.contextmanager
def inline_collection():
    """Open a sink for :func:`record_inline`.  The step opens it only
    when telemetry is on, so the disabled path never evaluates a probe
    expression (``record_inline`` takes a thunk for that reason)."""
    prev = getattr(_inline, "sink", None)
    sink: List[Tuple[str, torch.Tensor]] = []
    _inline.sink = sink
    try:
        yield sink
    finally:
        _inline.sink = prev


def record_inline(name: str, value_fn) -> None:
    """Record ``value_fn()`` (a ``[P, W]`` tensor, one value a replica)
    under ``name`` into the open collection; a no-op that never calls
    the thunk, so no op runs, when none is open."""
    sink = getattr(_inline, "sink", None)
    if sink is not None:
        sink.append((name, value_fn()))


# ---------------------------------------------------------------------------
# tree reductions
# ---------------------------------------------------------------------------

def _leaves(tree) -> List[Any]:
    """Leaves of a state tree (dicts in sorted key order, as
    ``jax.tree.leaves`` walks them; lists and tuples in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [] if tree is None else [tree]


def _float_leaves(tree) -> List[torch.Tensor]:
    return [x for x in _leaves(tree)
            if isinstance(x, torch.Tensor) and x.dtype.is_floating_point]


def tree_norm(tree) -> torch.Tensor:
    """L2 norm over every floating leaf of ``tree`` (0.0 when none)."""
    leaves = _float_leaves(tree)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(sum(leaf.float().square().sum() for leaf in leaves))


def replica_norms(tree, P: int, W: int) -> torch.Tensor:
    """The L2 norm of each replica's part of a ``[P, W, ...]`` state tree
    (every floating leaf carries the replica axes), a ``[P, W]`` fp32
    tensor: :func:`tree_norm` of what one JAX device holds.  In a mesh
    slot the slot's own ``[1, 1]``.  Each replica's sum of squares is
    its own reduction over its flat copy: a CUDA reduction's order
    depends on how many rows it reduces, and a slot holds one."""
    from geomx_tpu_torch.parallel.collectives import current_slot
    if current_slot() is not None:
        P = W = 1
    leaves = _float_leaves(tree)
    if not leaves:
        return torch.zeros((P, W), dtype=torch.float32)
    return torch.sqrt(sum(
        torch.stack([leaf[p, w].float().square().sum()
                     for p in range(P) for w in range(W)]).view(P, W)
        for leaf in leaves))


def _replicate(x: torch.Tensor, sync: Any) -> torch.Tensor:
    """A ``[P, W]`` party-local value -> the mesh mean over LIVE parties:
    the worker pmean, then the parties' pmean, or under a degraded
    membership mask the survivors' psum over ``num_live`` (a dead
    party's replicas still run the step, and a plain mean would dilute
    every probe by dead/total); one replica's copy, 0-d."""
    from geomx_tpu_torch.parallel.collectives import (pmean_dc,
                                                      pmean_worker, psum_dc)
    x = x.float()
    if getattr(sync, "workers_per_party", 1) > 1:
        x = pmean_worker(x)
    if getattr(sync, "num_parties", 1) > 1:
        w = sync.party_weight(x)
        if w is None:
            x = pmean_dc(x)
        else:
            x = psum_dc(x * w) / sync.num_live
    return x[0, 0]


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """One flat vector over the given tensors (the tensor itself when
    there is one)."""
    if len(tensors) == 1:
        return tensors[0].reshape(-1)
    return torch.cat([t.reshape(-1) for t in tensors])


def _f32(v: float) -> float:
    """``v`` rounded to float32, as a JAX float32 constant holds it."""
    return float(np.float32(v))


def collect_step_probes(raw_grads: Any, synced_grads: Optional[Any],
                        sync: Any, sync_state: Any,
                        inline: Optional[List[Tuple[str, torch.Tensor]]],
                        params: Any, synced_numel: Optional[int] = None,
                        wire: Optional[Dict[str, float]] = None
                        ) -> Dict[str, Any]:
    """The probe dict of one step.

    ``raw_grads``: the ``[P, W, ...]`` gradients before any cross-party
    aggregation; ``synced_grads``: ONE replica's applied gradient (it is
    the same in every replica) as a tensor or a list of tensors — the
    fused path's flat buckets — or None on paths that fuse the sync into
    the update (ZeRO, MultiGPS) or keep per-replica gradients (HFA);
    ``synced_numel``: the applied gradient's element count without
    bucket padding (default: every element given); ``inline``: values
    recorded by the compressors during the sync; ``wire``: the static
    wire accounting when the caller cached it (else computed from
    ``params``).  Tensor values are 0-d, ``party_grad_nonfinite`` a
    ``[P]`` vector; the wire accounting is Python floats."""
    from geomx_tpu_torch.parallel.collectives import all_gather, psum
    from geomx_tpu_torch.topology import DC_AXIS, WORKER_AXIS
    raw = _float_leaves(raw_grads)
    P, W = tuple(raw[0].shape[:2])
    out: Dict[str, Any] = {}

    # per-party NaN/Inf flag from the RAW gradients: aggregation (and a
    # mean over healthy parties) can mask one party's poison — the
    # per-party vector points at the culprit.  Each replica's count, the
    # worker psum, the flag, and its all_gather over dc, as in the JAX
    # probes (integer counts: every order sums them exactly)
    local_bad = sum(torch.logical_not(torch.isfinite(g)).reshape(P, W, -1)
                    .sum(-1) for g in raw)
    if getattr(sync, "workers_per_party", 1) > 1:
        local_bad = psum(local_bad, WORKER_AXIS)
    party_flag = (local_bad > 0).to(torch.float32)
    out["party_grad_nonfinite"] = all_gather(party_flag, DC_AXIS)[0, 0]
    out["grad_nonfinite_parties"] = out["party_grad_nonfinite"].sum()

    if synced_grads is not None:
        tensors = synced_grads if isinstance(synced_grads, (list, tuple)) \
            else [synced_grads]
        flat = _flat([t for t in tensors
                      if t.dtype.is_floating_point]).float()
        out["grad_norm_global"] = torch.linalg.vector_norm(flat)
        bad = torch.logical_not(torch.isfinite(flat)).sum() \
            .to(torch.float32)
        out["grad_nonfinite_count"] = bad
        out["grad_all_finite"] = (bad == 0).to(torch.float32)
        total = synced_numel if synced_numel is not None else flat.numel()
        out["dc_nonzero_fraction"] = \
            (flat != 0).sum().to(torch.float32) / max(int(total), 1)

    # sync-algorithm values (EF residual norms, pipeline buffers):
    # party-local, folded to the live-party mean
    for name, val in (sync.telemetry_scalars(sync_state) or {}).items():
        out[name] = _replicate(val, sync)

    # inline recordings (BSC's emitted fraction, one a bucket): the mean
    # over recordings, then over the mesh
    if inline:
        grouped: Dict[str, List[torch.Tensor]] = {}
        for name, val in inline:
            grouped.setdefault(name, []).append(val.to(torch.float32))
        for name, vals in grouped.items():
            out[name] = _replicate(sum(vals) / len(vals), sync)

    # static wire accounting: the host plane reads probe values and wire
    # volume from the same dict
    if wire is None:
        wire = static_wire_accounting(sync, params)
    out.update(wire)
    return out


def static_wire_accounting(sync: Any, params: Any) -> Dict[str, float]:
    """``sync.wire_accounting(params)`` with every value float32-rounded
    (what the JAX step folds in as constants); computed once a step
    build — the accounting is static."""
    return {name: _f32(val)
            for name, val in (sync.wire_accounting(params) or {}).items()}


def host_probes(telem: Dict[str, Any]) -> Dict[str, Any]:
    """A probe dict as host values: the tensors of each device copied in
    one transfer (one ``cat``, one device-to-host copy), 0-d values as
    floats and vectors as lists of floats; Python floats pass through.
    (A value of an empty state, such as a dense dc tier's EF norm, is a
    CPU zero.)"""
    by_device: Dict[Any, List[str]] = {}
    for k, v in telem.items():
        if isinstance(v, torch.Tensor):
            by_device.setdefault(v.device, []).append(k)
    got: Dict[str, Any] = {}
    for names in by_device.values():
        parts = [telem[k].detach().reshape(-1).to(torch.float32)
                 for k in names]
        flat = torch.cat(parts).cpu().numpy()
        i = 0
        for k, p in zip(names, parts):
            vals = flat[i:i + p.numel()]
            i += p.numel()
            got[k] = float(vals[0]) if telem[k].dim() == 0 \
                else [float(v) for v in vals]
    return {k: got[k] if k in got else float(v) for k, v in telem.items()}
