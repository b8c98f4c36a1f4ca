"""Sorted-index segment-sum merge (port of geomx_tpu/ops/merge_pallas.py).

``merge_sorted_pairs`` merges (value, index) pair streams by index: a
stable sort by index (``-1`` sentinels mapped to ``SENTINEL_KEY`` so
they sort last), the in-segment ranks from an integer cummax, then a
fixed binary combining tree.  Float addition is not associative, so the
merged bits are DEFINED as that tree: ``rounds = ceil(log2
max_duplicates)`` passes, in pass ``r`` (``d = 2^r``) the element at
in-segment rank ``s`` with ``s % 2d == 0`` absorbs its neighbour at
position ``+d`` when that neighbour has the same key and is not a
sentinel.  Each segment's total lands at its head (rank 0), ``(0.0,
-1)`` everywhere else — a sparse stream of the input's length.

Every function takes ``[*B, m]`` rows (the replica axes ride in ``B``).
The sort stays in PyTorch ops on every device, as it stays in XLA in the
JAX package.  On CUDA tensors the tree and the head extraction launch
the hand-written kernel of ``csrc/merge.cu`` (segments of at most
``2^MAX_ROUNDS`` parties; the wrapper raises above that), which finds
the heads from the keys itself (a head is column 0 or a key unlike the
one before, which is ``rank == 0``), so no ranks are computed there; on
CPU tensors the ranks come from :func:`segment_ranks` and the tree runs
as :func:`merge_tree_plain`, which follows the JAX reference tree op for
op.  ``merge_sorted_pairs.launches`` counts kernel calls (made in
:func:`merge_tree`).
"""

from __future__ import annotations

import torch

from geomx_tpu_torch.ops.bucket import on_cuda

# post-sort sentinel key: real indices are < 2**31 - 1 (int32 buckets)
SENTINEL_KEY = 2**31 - 1

# the kernel keeps a head's 2^rounds segment entries in registers
MAX_ROUNDS = 6


def merge_rounds(max_duplicates: int) -> int:
    """Combining-tree depth for segments of at most ``max_duplicates``
    entries (one contribution a party: the dc axis size)."""
    r = 0
    while (1 << r) < max(1, int(max_duplicates)):
        r += 1
    return r


def sort_pairs(vals: torch.Tensor, idx: torch.Tensor):
    """``-1`` sentinels to ``SENTINEL_KEY``, then a stable sort by key
    along the last dim: ``(svals fp32, skey int32)``.  The stable order
    makes the tree's operand order a function of the pairs and their
    party-order presentation alone."""
    key = torch.where(idx >= 0, idx, SENTINEL_KEY).to(torch.int32)
    skey, order = torch.sort(key, dim=-1, stable=True)
    return vals.gather(-1, order), skey


def segment_ranks(skey: torch.Tensor):
    """(rank within the segment, head mask) of a sorted key column —
    integer arithmetic only (an int32 cummax), so it is exact."""
    m = skey.shape[-1]
    pos = torch.arange(m, dtype=torch.int32, device=skey.device) \
        .expand(skey.shape)
    prev = torch.cat([torch.full(skey.shape[:-1] + (1,), -2,
                                 dtype=torch.int32, device=skey.device),
                      skey[..., :-1]], dim=-1)
    head = skey != prev
    zero = torch.zeros((), dtype=torch.int32, device=skey.device)
    seg_start = torch.cummax(torch.where(head, pos, zero), dim=-1).values
    return pos - seg_start, head


def merge_tree_plain(svals: torch.Tensor, skey: torch.Tensor,
                     rank: torch.Tensor, rounds: int):
    """The defining combining tree (``_merge_tree_ref`` op for op)."""
    lead = svals.shape[:-1]
    dev = svals.device
    v = svals
    for r in range(rounds):
        d = 1 << r
        pv = torch.cat([v[..., d:], torch.zeros(lead + (min(d, v.shape[-1]),),
                                                dtype=v.dtype, device=dev)],
                       dim=-1)
        pk = torch.cat([skey[..., d:],
                        torch.full(lead + (min(d, skey.shape[-1]),),
                                   SENTINEL_KEY, dtype=torch.int32,
                                   device=dev)], dim=-1)
        take = (pk == skey) & (skey != SENTINEL_KEY) & (rank % (2 * d) == 0)
        v = torch.where(take, v + pv, v)
    head = (rank == 0) & (skey != SENTINEL_KEY)
    return (torch.where(head, v, torch.zeros((), dtype=v.dtype, device=dev)),
            torch.where(head, skey, -1).to(torch.int32))


def merge_sorted_pairs_plain(vals: torch.Tensor, idx: torch.Tensor,
                             max_duplicates: int):
    """:func:`merge_sorted_pairs` with the plain tree on any device."""
    svals, skey = sort_pairs(vals.to(torch.float32), idx.to(torch.int32))
    rank, _ = segment_ranks(skey)
    return merge_tree_plain(svals, skey, rank, merge_rounds(max_duplicates))


def merge_tree(svals: torch.Tensor, skey: torch.Tensor, rounds: int):
    """The combining tree and head extraction over sorted ``[*B, m]``
    columns (:func:`sort_pairs`): the CUDA kernel on CUDA tensors, which
    finds the heads from the keys and reads no ranks;
    :func:`merge_tree_plain` over ``segment_ranks(skey)`` on CPU
    tensors."""
    if not on_cuda([svals, skey]):
        rank, _ = segment_ranks(skey)
        return merge_tree_plain(svals, skey, rank, rounds)
    if rounds > MAX_ROUNDS:
        raise ValueError(
            f"merge_sorted_pairs on CUDA takes at most {1 << MAX_ROUNDS} "
            f"duplicates of an index ({MAX_ROUNDS} rounds), got {rounds} "
            "rounds")
    from geomx_tpu_torch.ops._build import kernels
    lead, m = tuple(svals.shape[:-1]), svals.shape[-1]
    out_v = torch.empty(lead + (m,), dtype=torch.float32, device=svals.device)
    out_i = torch.empty(lead + (m,), dtype=torch.int32, device=svals.device)
    kernels().merge_sorted_pairs(svals.reshape(-1, m).contiguous(),
                                 skey.reshape(-1, m).contiguous(), rounds,
                                 out_v.view(-1, m), out_i.view(-1, m))
    merge_sorted_pairs.launches += 1
    return out_v, out_i


def merge_sorted_pairs(vals: torch.Tensor, idx: torch.Tensor,
                       max_duplicates: int):
    """Merge ``[*B, m]`` (value, index) rows by index.

    ``vals``/``idx`` need not be sorted.  ``max_duplicates`` bounds how
    many pairs share one index (the dc axis size: each party sends an
    index at most once); a longer segment keeps only its first
    ``2^rounds`` entries, as the tree does.  Returns ``(merged_vals fp32,
    merged_idx int32)`` of the input's shape: segment totals at head
    positions, ``(0.0, -1)`` elsewhere."""
    if vals.shape != idx.shape:
        raise ValueError("vals and idx differ in shape")
    svals, skey = sort_pairs(vals.to(torch.float32), idx.to(torch.int32))
    return merge_tree(svals, skey, merge_rounds(max_duplicates))


merge_sorted_pairs.launches = 0
