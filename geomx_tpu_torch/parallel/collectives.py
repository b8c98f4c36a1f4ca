"""Hierarchical collectives over the in-process replica axes (port of
geomx_tpu/parallel/collectives.py:42-98).

In the JAX package each collective runs per device inside
``shard_map`` and reduces over a named mesh axis.  Here every replica
lives in one tensor whose leading dims are ``[P, W]`` (``dc`` = dim 0,
``worker`` = dim 1), and a collective is a reduction over that dim whose
result every replica along it receives — the same value the per-device
collective hands each device.  Results of the sums are broadcast views
(stride 0 over the reduced dim); per-replica slices of them stay
contiguous.

The sequence-parallel axis ``sp`` is not a state axis: an sp-aware model
holds one replica's ``S`` sequence shards as dim 0 of its activations
(``[S, ...]``), and the ``*_sp`` helpers below exchange data over that
dim as the per-device collectives over the ``sp`` mesh axis do.
"""

from __future__ import annotations

import torch

from geomx_tpu_torch.topology import DC_AXIS, WORKER_AXIS

_DIM = {DC_AXIS: 0, WORKER_AXIS: 1}


def axis_dim(axis_name: str) -> int:
    try:
        return _DIM[axis_name]
    except KeyError:
        raise ValueError(f"unknown replica axis {axis_name!r}; expected "
                         f"one of {sorted(_DIM)}") from None


def psum(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Sum over one replica axis, as every replica on it receives it."""
    d = axis_dim(axis_name)
    return x.sum(dim=d, keepdim=True).expand_as(x)


def pmean(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    return psum(x, axis_name) / x.shape[axis_dim(axis_name)]


def psum_worker(x: torch.Tensor) -> torch.Tensor:
    """Intra-party aggregation — the worker -> local-server merge."""
    return psum(x, WORKER_AXIS)


def psum_dc(x: torch.Tensor) -> torch.Tensor:
    """Cross-party aggregation — the local -> global server merge."""
    return psum(x, DC_AXIS)


def pmean_worker(x: torch.Tensor) -> torch.Tensor:
    return pmean(x, WORKER_AXIS)


def pmean_dc(x: torch.Tensor) -> torch.Tensor:
    return pmean(x, DC_AXIS)


def hier_psum(x: torch.Tensor) -> torch.Tensor:
    """Two-tier sum: worker stage first, then dc stage."""
    return psum_dc(psum_worker(x))


def hier_pmean(x: torch.Tensor) -> torch.Tensor:
    return pmean_dc(pmean_worker(x))


def psum_scatter(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Reduce-scatter over one replica axis (``lax.psum_scatter`` with
    ``scatter_dimension=0, tiled=True``): ``x`` is ``[P, W, A * s]``
    with ``A`` the axis size, and slot ``a`` of the axis receives the
    sum over the axis of every replica's chunk ``a`` (of ``A`` along
    the last dim), so the result is ``[P, W, s]``, contiguous.

    The sum is ``torch.sum`` over the axis dim, the reduction
    :func:`psum` runs, so on one device a slot's chunk holds the bits of
    the same chunk of ``psum(x)``.  It is not the order the JAX
    package's CPU reduction folds in: the two agree bit for bit only on
    inputs whose partial sums are exact (the parity tests use signed
    powers of two)."""
    d = axis_dim(axis_name)
    P, W = x.shape[:2]
    A = x.shape[d]
    if x.dim() != 3 or x.shape[-1] % A:
        raise ValueError(f"psum_scatter takes [P, W, {A} * s] rows, got "
                         f"{tuple(x.shape)}")
    s = x.shape[-1] // A
    if d == 1:
        # out[p, w] = sum_q x[p, q, w*s:(w+1)*s]
        return x.view(P, W, W, s).sum(dim=1)
    # out[p, w] = sum_q x[q, w, p*s:(p+1)*s]
    return x.view(P, W, P, s).sum(dim=0).transpose(0, 1).contiguous()


def all_gather(x: torch.Tensor, axis_name: str,
               tiled: bool = False) -> torch.Tensor:
    """Gather every replica's payload along one axis: ``x`` is
    ``[P, W, *s]``; replica ``(p, w)`` of the result holds the stack of
    the payloads along the axis, so the result is ``[P, W, A, *s]``
    with ``A`` the axis size (``lax.all_gather`` with ``axis=0``).
    ``tiled``: the payloads are concatenated along their first dim
    instead, ``[P, W, A * s0, *s[1:]]`` (``tiled=True``): the inverse of
    :func:`psum_scatter`'s layout.  A view where it can be one."""
    P, W = x.shape[:2]
    if axis_dim(axis_name) == 0:
        # out[p, w, q] = x[q, w]
        out = x.transpose(0, 1).unsqueeze(0).expand(P, W, P, *x.shape[2:])
    else:
        # out[p, w, q] = x[p, q]
        out = x.unsqueeze(1).expand(P, W, W, *x.shape[2:])
    return out.flatten(2, 3) if tiled else out


def all_gather_dc(x: torch.Tensor) -> torch.Tensor:
    """The wire transfer of a compressed push across the global tier."""
    return all_gather(x, DC_AXIS)


def pmax(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Maximum over one replica axis, as every replica on it receives it."""
    d = axis_dim(axis_name)
    return x.amax(dim=d, keepdim=True).expand_as(x)


def all_to_all(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Personalised exchange along one axis: ``x`` is ``[P, W, A, *s]``
    with one block a destination along the axis; replica ``(p, w)`` of
    the result holds, at ``q``, the block that replica ``q`` of the axis
    addressed to it (``lax.all_to_all`` with ``split_axis=0,
    concat_axis=0``).  A view."""
    if axis_dim(axis_name) == 0:
        # out[p, w, q] = x[q, w, p]
        return x.transpose(0, 2)
    # out[p, w, q] = x[p, q, w]
    return x.transpose(1, 2)


def party_index(P: int, W: int, device=None) -> torch.Tensor:
    """``[P, W]`` int tensor: each replica's party index."""
    return torch.arange(P, device=device).view(P, 1).expand(P, W)


def worker_index(P: int, W: int, device=None) -> torch.Tensor:
    """``[P, W]`` int tensor: each replica's worker index."""
    return torch.arange(W, device=device).view(1, W).expand(P, W)


def global_worker_rank(P: int, W: int, device=None) -> torch.Tensor:
    """Linear rank over all workers (reference: kvstore rank)."""
    return party_index(P, W, device) * W + worker_index(P, W, device)


# ---- the sp axis: dim 0 of a replica's activations ------------------------

def ppermute_sp(x: torch.Tensor) -> torch.Tensor:
    """The ring step ``lax.ppermute(x, "sp", [(i, (i + 1) % n)])``: shard
    ``i`` receives shard ``i - 1``'s block."""
    return torch.roll(x, 1, dims=0)


def pmean_sp(x: torch.Tensor) -> torch.Tensor:
    """Mean over the sp shards, as every shard receives it."""
    return x.mean(dim=0, keepdim=True).expand_as(x)


def all_to_all_sp(x: torch.Tensor, split_dim: int,
                  concat_dim: int) -> torch.Tensor:
    """``lax.all_to_all(x, "sp", split_axis, concat_axis, tiled=True)``
    over the shards of ``x = [S, *s]``: ``split_dim`` and ``concat_dim``
    index a shard's own dims ``s``.  Shard ``j`` of the result is the
    concatenation, along ``concat_dim`` and in shard order, of chunk
    ``j`` (of ``S`` along ``split_dim``) of every shard.  A copy."""
    S = x.shape[0]
    nd = x.dim() - 1
    split, concat = split_dim % nd + 1, concat_dim % nd + 1
    if x.shape[split] % S:
        raise ValueError(f"dim {split_dim} ({x.shape[split]}) does not "
                         f"split into {S} sp chunks")
    # [src, ..., (dst, chunk) at split, ...]
    y = x.unflatten(split, (S, x.shape[split] // S))
    c = concat + (concat > split)  # concat's index after the unflatten
    y = y.movedim(split, 0)        # [dst, src, ...]
    c += (c < split)               # shifted by the move to the front
    y = y.movedim(1, c - 1)        # src just before the concat dim
    return y.flatten(c - 1, c)
