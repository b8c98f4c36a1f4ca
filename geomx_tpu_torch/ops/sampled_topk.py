"""Sampled-boundary top-k selection (port of geomx_tpu/ops/sampled_topk.py).

The reference's BSC scan: estimate the magnitude boundary from a
deterministic ~8k-element probe, then emit exactly ``k`` (value, index)
pairs in one ordered pass — elements strictly above the boundary first,
boundary ties after all of them, ``(0.0, -1)`` sentinels in the slots
nobody fills.  Every function takes ``[*B, n]`` tensors and works on
each row of the leading batch dims independently (the port's replica
axes ride there).

``k`` is a Python int (the static path) or, under the control plane,
a 0-d integer tensor on the device (the effective ``k`` of the ratio
operand, ``compression/bisparse.py``): the boundary position is then a
device index the probe gather consumes without a host round trip, and
no output shape depends on it.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def sample_positions(n: int, sample: int = 8192) -> np.ndarray:
    """Deterministic quasi-random probe positions (Weyl sequence), the
    same int64 numbers the JAX package draws."""
    m = min(n, int(sample))
    return (np.arange(m, dtype=np.int64) * 2654435761) % n


def boundary_position(m: int, k, n: int):
    """Index into the sorted ``m``-element probe for the (1 - k/n)
    quantile.  A Python-int ``k`` resolves statically (Python's round,
    as in the JAX package's static path).  A 0-d integer tensor ``k``
    gives a 0-d int64 tensor on its device, ``clip(round(m * (1 -
    k/n)), 0, m - 1)`` in fp32 as the JAX package's jitted step computes
    it: XLA on the CPU rewrites the division by the constant ``n`` into
    a multiply by ``r = fl(1/n)`` and contracts ``1 - k * r`` into one
    FMA (a single rounding), then multiplies by ``m`` and rounds half to
    even.  The FMA is reproduced exactly in integers: with ``r = M *
    2^E`` (``M`` 24 bits), ``1 - k * r = (2^-E - k * M) * 2^E`` is an
    int64, rounded once on its conversion to fp32.  A plain fp32 ``k /
    n`` differs from it by one position for some ``k``."""
    if isinstance(k, (int, np.integer)):
        return min(max(int(round(m * (1.0 - int(k) / n))), 0), m - 1)
    mant, e = math.frexp(float(np.float32(1.0) / np.float32(n)))
    big_m, exp2 = int(mant * (1 << 24)), e - 24
    # the fp32 value XLA converts k to, then the exact 1 - k * r
    kk = k.to(torch.float32).to(torch.int64)
    t = ((1 << -exp2) - kk * big_m).to(torch.float32) * (2.0 ** exp2)
    return torch.round(t * float(m)).clamp(0, m - 1).to(torch.int64)


def take_position(ssorted: torch.Tensor, pos) -> torch.Tensor:
    """``ssorted[..., pos]`` for an int or a 0-d index tensor (gathered
    on the device: indexing with a 0-d tensor would copy it to the
    host)."""
    if isinstance(pos, int):
        return ssorted[..., pos]
    return ssorted.index_select(-1, pos.reshape(1)).squeeze(-1)


def probe_positions(n: int, sample: int = 8192, device=None) -> torch.Tensor:
    """:func:`sample_positions` as an int64 tensor on ``device``."""
    return torch.as_tensor(sample_positions(n, sample), device=device)


def sampled_boundary(absv: torch.Tensor, k, sample: int = 8192,
                     positions: torch.Tensor = None) -> torch.Tensor:
    """The (1 - k/n) quantile of a sorted probe of each row of ``absv``
    (``[*B, n]`` -> ``[*B]``); ``k`` an int or a 0-d integer tensor
    (:func:`boundary_position`)."""
    n = absv.shape[-1]
    if positions is None:
        positions = probe_positions(n, sample, absv.device)
    ssorted = absv[..., positions].sort(dim=-1).values
    return take_position(ssorted,
                          boundary_position(ssorted.shape[-1], k, n))


def sampled_threshold_select(v: torch.Tensor, absv: torch.Tensor, k: int,
                             sample: int = 8192, thr=None):
    """Select ~top-k of each row of ``absv`` by a sampled boundary.

    Returns ``(vals [*B, k], idx [*B, k] int32 with -1 sentinels,
    keep [*B, n] bool)``, in the JAX package's op order: exclusive
    ranks from cumsums, ties queued after all primaries, kept
    coordinates scattered into their rank slot and everything else into
    the dump slot ``k``."""
    n = absv.shape[-1]
    k = int(k)
    if thr is None:
        thr = sampled_boundary(absv, k, sample)
    thr = torch.as_tensor(thr, dtype=absv.dtype, device=absv.device)
    thr = thr.expand(absv.shape[:-1]).unsqueeze(-1)
    primary = absv > thr
    secondary = absv == thr
    p_i = primary.to(torch.int64)
    s_i = secondary.to(torch.int64)
    p_rank = torch.cumsum(p_i, -1) - p_i
    n_primary = p_i.sum(-1, keepdim=True)
    s_rank = n_primary + torch.cumsum(s_i, -1) - s_i
    rank = torch.where(primary, p_rank, s_rank)
    keep = (primary | secondary) & (rank < k)
    slot = torch.where(keep, rank, k)
    idx_full = torch.full(absv.shape[:-1] + (k + 1,), -1, dtype=torch.int32,
                          device=absv.device)
    arange = torch.arange(n, dtype=torch.int32, device=absv.device)
    idx_full.scatter_(-1, slot, arange.expand(absv.shape).contiguous())
    idx = idx_full[..., :k]
    valid = idx >= 0
    picked = torch.gather(v, -1, torch.where(valid, idx, 0).to(torch.int64))
    vals = torch.where(valid, picked, torch.zeros((), dtype=v.dtype,
                                                  device=v.device))
    return vals, idx, keep
