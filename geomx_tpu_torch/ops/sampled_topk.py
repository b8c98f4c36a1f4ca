"""Sampled-boundary top-k selection (port of geomx_tpu/ops/sampled_topk.py).

The reference's BSC scan: estimate the magnitude boundary from a
deterministic ~8k-element probe, then emit exactly ``k`` (value, index)
pairs in one ordered pass — elements strictly above the boundary first,
boundary ties after all of them, ``(0.0, -1)`` sentinels in the slots
nobody fills.  Every function takes ``[*B, n]`` tensors and works on
each row of the leading batch dims independently (the port's replica
axes ride there).

The control plane's traced ``k`` (``boundary_position`` on a traced
operand) is not ported: ``k`` is a Python int here.
"""

from __future__ import annotations

import numpy as np
import torch


def sample_positions(n: int, sample: int = 8192) -> np.ndarray:
    """Deterministic quasi-random probe positions (Weyl sequence), the
    same int64 numbers the JAX package draws."""
    m = min(n, int(sample))
    return (np.arange(m, dtype=np.int64) * 2654435761) % n


def boundary_position(m: int, k: int, n: int) -> int:
    """Index into the sorted ``m``-element probe for the (1 - k/n)
    quantile (Python's round, as in the JAX package's static path)."""
    return min(max(int(round(m * (1.0 - int(k) / n))), 0), m - 1)


def probe_positions(n: int, sample: int = 8192, device=None) -> torch.Tensor:
    """:func:`sample_positions` as an int64 tensor on ``device``."""
    return torch.as_tensor(sample_positions(n, sample), device=device)


def sampled_boundary(absv: torch.Tensor, k: int, sample: int = 8192,
                     positions: torch.Tensor = None) -> torch.Tensor:
    """The (1 - k/n) quantile of a sorted probe of each row of ``absv``
    (``[*B, n]`` -> ``[*B]``)."""
    n = absv.shape[-1]
    if positions is None:
        positions = probe_positions(n, sample, absv.device)
    ssorted = absv[..., positions].sort(dim=-1).values
    return ssorted[..., boundary_position(ssorted.shape[-1], k, n)]


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
