"""Compressed-domain aggregation (port of the device half of
geomx_tpu/compression/sparseagg.py).

**Owner-routed sparse all-reduce** (:func:`sparse_allreduce`), the
Ok-Topk shape:

1. *route*: the index space ``[0, n)`` splits into ``P`` contiguous
   owner ranges; each party's ``k`` pairs sort by owner (integer
   arithmetic, exact) into ``slots`` pairs a destination, ``slots =
   min(k, ceil(slack * k / P) + 8)`` (``GEOMX_SPARSE_AGG_SLACK``, default
   2.0), and one ``all_to_all`` delivers every pair to its owner.  Pairs
   past a destination's budget go back into the caller's error-feedback
   velocity before the collectives;
2. *merge*: each owner merges the pairs it received by sorted-index
   segment sum (``ops.merge``, a CUDA kernel on the card);
3. *re-select*: each owner keeps its top ``kr = min(P * slots,
   ceil(pull_slack * k / P) + 8)`` merged pairs by magnitude
   (``GEOMX_SPARSE_AGG_PULL_SLACK``, default 2.0); merged mass past that
   budget is dropped, the reference's pull-side truncation;
4. *return*: one ``all_gather`` of the owners' selections and one
   decompress land the global sum.

**Quantized-lattice all-reduce** (THC): :func:`lattice_allreduce_fp16`
negotiates one scale with a ``pmax``, quantizes every party onto a
shared int16 lattice with ``P``-fold headroom and sums the codes
exactly; :func:`lattice_allreduce_signs` sums 2-bit sign codes as int8.

Every tensor carries the leading ``[P, W]`` replica axes.

**The host half** (numpy, for ``service/server.py``'s round gate):
:func:`merge_pairs_host` merges per-sender (value, index) pushes by
sorted index through the native ``gx_merge_pairs`` (or its numpy
replica), and :func:`encode_pairs_payload` /
:func:`decode_pairs_payload` / :func:`densify_pairs_host` are the pair
wire payload, byte-identical to the JAX package's.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from geomx_tpu_torch.ops.merge import merge_sorted_pairs
from geomx_tpu_torch.ops.topk import top_k
from geomx_tpu_torch.parallel.collectives import (all_gather, all_to_all,
                                                  axis_replicas, pmax, psum)
from geomx_tpu_torch.telemetry.probes import record_inline
from geomx_tpu_torch.utils.profiler import span


def sparse_agg_enabled() -> bool:
    """``GEOMX_SPARSE_AGG=1`` turns compressed-domain aggregation on for
    every compressor that has it (off by default)."""
    return os.environ.get("GEOMX_SPARSE_AGG", "0").strip().lower() in (
        "1", "true", "yes", "on")


def _env_slack(var: str, default: float) -> float:
    raw = os.environ.get(var)
    try:
        return float(raw) if raw else default
    except ValueError:
        return default


def push_slots(k: int, num_parties: int, slack: Optional[float] = None) -> int:
    """Per-destination slot budget of the owner-routing ``all_to_all``."""
    if slack is None:
        slack = _env_slack("GEOMX_SPARSE_AGG_SLACK", 2.0)
    return max(1, min(int(k), int(math.ceil(slack * k / num_parties)) + 8))


def pull_budget(k: int, num_parties: int,
                slack: Optional[float] = None) -> int:
    """Per-owner re-selection budget of the return leg."""
    if slack is None:
        slack = _env_slack("GEOMX_SPARSE_AGG_PULL_SLACK", 2.0)
    return max(1, int(math.ceil(slack * k / num_parties)) + 8)


def owner_shard_size(n: int, num_parties: int) -> int:
    """Party ``p`` owns indices ``[p*S, min((p+1)*S, n))``."""
    return -(-int(n) // int(num_parties))


def owner_route(vals: torch.Tensor, idx: torch.Tensor, n: int,
                num_parties: int, slots: int):
    """Sort each ``[*B, k]`` row's pairs into fixed-slot per-owner
    buffers: ``(buf_vals [*B, P, slots], buf_idx [*B, P, slots], of_vals
    [*B, k], of_idx [*B, k])``.  ``of_*`` are the overflow pairs, with
    every other position at the out-of-range index ``n``."""
    lead, k = tuple(vals.shape[:-1]), vals.shape[-1]
    dev = vals.device
    P = int(num_parties)
    S = owner_shard_size(n, P)
    owner = torch.where(idx >= 0, torch.div(idx, S, rounding_mode="floor"),
                        P).to(torch.int32)
    sowner, order = torch.sort(owner, dim=-1, stable=True)
    svals = vals.gather(-1, order)
    sidx = idx.gather(-1, order)
    pos = torch.arange(k, dtype=torch.int32, device=dev).expand(lead + (k,))
    prev = torch.cat([torch.full(lead + (1,), -1, dtype=torch.int32,
                                 device=dev), sowner[..., :-1]], dim=-1)
    head = sowner != prev
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    seg_start = torch.cummax(torch.where(head, pos, zero_i), dim=-1).values
    segrank = pos - seg_start
    real = sowner < P
    fits = real & (segrank < slots)
    dest = torch.where(fits, sowner * slots + segrank, P * slots).long()
    zero_f = torch.zeros((), dtype=torch.float32, device=dev)
    buf_v = torch.zeros(lead + (P * slots + 1,), dtype=torch.float32,
                        device=dev).scatter_(
        -1, dest, torch.where(fits, svals, zero_f))[..., :-1]
    buf_i = torch.full(lead + (P * slots + 1,), -1, dtype=torch.int32,
                       device=dev).scatter_(
        -1, dest, torch.where(fits, sidx, -1).to(torch.int32))[..., :-1]
    overflow = real & (segrank >= slots)
    of_vals = torch.where(overflow, svals, zero_f)
    of_idx = torch.where(overflow, sidx, n).to(torch.int32)
    return (buf_v.reshape(lead + (P, slots)), buf_i.reshape(lead + (P, slots)),
            of_vals, of_idx)


def reinject(ef: torch.Tensor, of_vals: torch.Tensor,
             of_idx: torch.Tensor) -> torch.Tensor:
    """``ef.at[of_idx].add(of_vals, mode="drop")`` per ``[*B, n]`` row:
    index ``n`` (not overflow) adds nothing.  Contiguous, as the next
    step's select kernel takes it."""
    lead, n = tuple(ef.shape[:-1]), ef.shape[-1]
    padded = torch.cat([ef, torch.zeros(lead + (1,), dtype=ef.dtype,
                                        device=ef.device)], dim=-1)
    padded.scatter_add_(-1, of_idx.long(), of_vals.to(ef.dtype))
    return padded[..., :n].contiguous()


def sparse_allreduce(vals: torch.Tensor, idx: torch.Tensor, n: int,
                     axis_name: str, axis_size: int, decompress: Callable,
                     *, ef_buffer: Optional[torch.Tensor] = None,
                     record: Optional[dict] = None):
    """The owner-routed compressed-domain all-reduce of ``[P, W, k]``
    pairs (module docstring).

    ``decompress(vals, idx, n, run=kr)`` lands the gathered owner
    selections densely, the one dense materialization of the path.
    ``ef_buffer`` (the caller's ``[P, W, n]`` error-feedback velocity)
    absorbs the routing overflow before the collectives; returns
    ``(dense_out [P, W, n], new_ef_buffer)`` (None when no buffer was
    handed in).  ``record``, if given, receives the step's overflow,
    merged and kept index tensors for :func:`wire_stats`.  Inside a mesh
    slot the operands are the slot's ``[1, 1, k]`` block and
    ``axis_size`` is checked against the slot's axis size."""
    k = int(vals.shape[-1])
    P = int(axis_size)
    have = axis_replicas(vals, axis_name)
    if have != P:
        raise ValueError(f"axis {axis_name!r} has {have} replicas, not "
                         f"axis_size={P}")
    slots = push_slots(k, P)
    kr = min(P * slots, pull_budget(k, P))
    lead = tuple(vals.shape[:2])
    with span("sparseagg/route"):
        buf_v, buf_i, of_vals, of_idx = owner_route(vals, idx, n, P, slots)
        if ef_buffer is not None:
            ef_buffer = reinject(ef_buffer, of_vals, of_idx)
        # the wire: [P, W, P_src, slots] pairs a replica; owners receive
        # their rows in party order
        rv = all_to_all(buf_v, axis_name).reshape(lead + (P * slots,))
        ri = all_to_all(buf_i, axis_name).reshape(lead + (P * slots,))
    with span("sparseagg/merge"):
        mvals, midx = merge_sorted_pairs(rv, ri, P)
    with span("sparseagg/reselect"):
        score = torch.where(midx >= 0, mvals.abs(),
                            torch.full((), -1.0, device=mvals.device))
        top_score, top_pos = top_k(score, kr)
        top_pos = top_pos.long()
        keep = top_score >= 0
        tvals = torch.where(keep, mvals.gather(-1, top_pos),
                            torch.zeros((), device=mvals.device))
        tidx = torch.where(keep, midx.gather(-1, top_pos), -1).to(torch.int32)
    # merged mass past the pull budget is DROPPED (the reference's
    # pull-side multiplier truncation); surface the fraction so tuning
    # can see it (telemetry/probes.py: no op unless a collection is open)
    record_inline(
        "sparse_agg_pull_dropped_fraction",
        lambda: 1.0 - (tidx >= 0).sum(-1)
        / (midx >= 0).sum(-1).clamp_min(1))
    if record is not None:
        record.update(overflow_idx=of_idx, n=int(n), merged_idx=midx,
                      kept_idx=tidx)
    av = all_gather(tvals, axis_name).reshape(lead + (-1,))
    ai = all_gather(tidx, axis_name).reshape(lead + (-1,))
    return decompress(av, ai, n, run=kr), ef_buffer


def wire_stats(record: dict) -> dict:
    """Counts of one :func:`sparse_allreduce` call from its ``record``,
    summed over the parties (worker 0 of each: a party's workers hold
    the same pairs): overflow pairs reinjected, merged pairs, pairs kept
    by the re-select, and the pull-dropped share ``1 - kept / merged``
    (the JAX package's ``sparse_agg_pull_dropped_fraction``).  Reads the
    device: call it outside a timed loop."""
    overflow = int((record["overflow_idx"][:, 0] < record["n"]).sum())
    merged = int((record["merged_idx"][:, 0] >= 0).sum())
    kept = int((record["kept_idx"][:, 0] >= 0).sum())
    return dict(overflow_pairs=overflow, merged_pairs=merged,
                kept_pairs=kept,
                pull_dropped_fraction=1.0 - kept / max(merged, 1))


def sparse_wire_bytes(k: int, num_parties: int) -> int:
    """Bytes one party puts on the wire per all-reduce on the
    owner-routed path: the ``all_to_all`` buffers (``P * slots`` pairs)
    and the return-leg selection (``kr`` pairs), 8 B a (fp32, int32)
    pair."""
    P = max(1, int(num_parties))
    slots = push_slots(k, P)
    kr = min(P * slots, pull_budget(k, P))
    return 8 * (P * slots + kr)


# int16 lattice headroom: codes scale to +-(32767 // P) so the exact
# integer sum of P parties cannot overflow the wire type
_INT16_MAX = 32767
_INT8_MAX = 127


def lattice_allreduce_fp16(g: torch.Tensor, axis_name: str,
                           axis_size: int) -> torch.Tensor:
    """Sum ``[P, W, *s]`` ``g`` over the axis on a shared int16 lattice:
    ``pmax`` of each replica's ``max |g|`` is the scale, ``round(g / safe
    * q)`` the codes (``q = 32767 // P``, round half to even as
    ``jnp.round``), an exact integer sum, and one rescale in the JAX op
    order ``total * (safe / q) * (scale > 0)``."""
    if axis_size > _INT16_MAX:
        raise ValueError(
            f"int16 lattice headroom supports at most {_INT16_MAX} "
            f"parties, got {axis_size}")
    q = _INT16_MAX // int(axis_size)
    gf = g.to(torch.float32)
    dev = gf.device
    local = gf.abs().reshape(tuple(g.shape[:2]) + (-1,)).amax(dim=-1)
    scale = pmax(local, axis_name).reshape(local.shape + (1,) * (g.dim() - 2))
    one = torch.ones((), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    safe = torch.where(scale > 0, scale, one)
    codes = torch.round(gf / safe * q).to(torch.int16)
    total = psum(codes, axis_name)
    # a 0-d device divisor: a host scalar would become a reciprocal
    # multiply on the card
    qt = torch.full((), float(q), dtype=torch.float32, device=dev)
    return total.to(torch.float32) * (safe / qt) \
        * torch.where(scale > 0, one, zero)


def lattice_allreduce_signs(signs: torch.Tensor, threshold: float,
                            axis_name: str, axis_size: int) -> torch.Tensor:
    """2-bit lattice sum: the parties' int8 sign codes in {-1, 0, +1} sum
    exactly, then one scale by ``threshold``."""
    if axis_size > _INT8_MAX:
        raise ValueError(
            f"int8 sign-lattice headroom supports at most {_INT8_MAX} "
            f"parties, got {axis_size}")
    total = psum(signs.to(torch.int8), axis_name)
    return total.to(torch.float32) * threshold


# ---------------------------------------------------------------------------
# host-plane sorted-index merge (the global tier's kernel)
# ---------------------------------------------------------------------------

def _native_merge(vals: np.ndarray, idx: np.ndarray):
    """Route the concatenated pair set through the fast-path merge when
    the native wire path is enabled: the nogil C++ ``gx_merge_pairs``
    if ``libgeops.so`` is built, else a numpy replica of its SEQUENTIAL
    left-to-right float32 fold (vectorized across segments by
    accumulation round, so it costs O(max duplicates) passes — the
    duplicate count is the party count, small).  The replica is pinned
    bit-identical to the C++ by tests/test_wire_fastpath.py, so which
    one ran is unobservable in the merged bits.  Returns ``None`` under
    ``GEOMX_NATIVE_WIRE=0`` — that switch forces the UNTOUCHED legacy
    ``np.add.reduceat`` fold (pairwise summation, different low bits
    than the sequential tree) exactly as shipped before the fast path
    existed."""
    from geomx_tpu_torch.service.protocol import binary_wire_enabled
    if not binary_wire_enabled():
        return None
    from geomx_tpu_torch.runtime import native
    out = native.merge_pairs(vals, idx)
    if out is not None:
        return out
    keep = idx >= 0
    vals, idx = vals[keep], idx[keep]
    if idx.size == 0:
        return (np.zeros((0,), np.float32), np.zeros((0,), np.int64))
    order = np.argsort(idx, kind="stable")
    si, sv = idx[order], vals[order]
    head = np.ones(si.size, bool)
    head[1:] = si[1:] != si[:-1]
    starts = np.flatnonzero(head)
    lens = np.diff(np.append(starts, si.size))
    merged = sv[starts].copy()
    for r in range(1, int(lens.max())):
        m = lens > r
        merged[m] = merged[m] + sv[starts[m] + r]
    return merged, si[starts]


def merge_pairs_host(parts) -> Tuple[np.ndarray, np.ndarray]:
    """Merge (value, index) contributions by index on the host — the
    GeoPSServer round-gate kernel (service/server.py).

    ``parts`` is an iterable of ``(vals, idx)`` numpy pairs in the
    caller's CANONICAL order (sorted sender id): concatenation order +
    stable index sort + a fixed per-segment fold define the summation
    tree completely, so the merged bits are a function of the
    contribution set alone — never of push arrival order.  Which fold:
    the fast path (native wire enabled, default) folds each segment
    SEQUENTIALLY left-to-right in float32 (C++ ``gx_merge_pairs`` or
    its pinned-identical numpy replica); ``GEOMX_NATIVE_WIRE=0`` keeps
    the original ``np.add.reduceat`` pairwise fold byte-for-byte.
    Either way the tree is deterministic per switch setting.  Sentinel
    pairs (index < 0) drop.  Cost: O(K log K) in the total pair count
    K, independent of the dense length.  Returns compact ``(vals fp32,
    idx int64)`` sorted by index, indices unique."""
    vs, is_ = [], []
    for v, i in parts:
        vs.append(np.asarray(v, np.float32).reshape(-1))
        is_.append(np.asarray(i).reshape(-1).astype(np.int64))
    if not vs:
        return (np.zeros((0,), np.float32), np.zeros((0,), np.int64))
    vals = np.concatenate(vs)
    idx = np.concatenate(is_)
    merged = _native_merge(vals, idx)
    if merged is not None:
        return merged
    keep = idx >= 0
    vals, idx = vals[keep], idx[keep]
    if idx.size == 0:
        return (np.zeros((0,), np.float32), np.zeros((0,), np.int64))
    order = np.argsort(idx, kind="stable")
    si, sv = idx[order], vals[order]
    head = np.ones(si.size, bool)
    head[1:] = si[1:] != si[:-1]
    starts = np.flatnonzero(head)
    return np.add.reduceat(sv, starts).astype(np.float32), si[starts]


# the concatenated-pair wire format (values then f32-cast indices) is
# index-exact only below this bound — producers must fall back to a
# dense payload past it, consumers refuse the sparse store/reply
PAIR_WIRE_MAX_N = 1 << 24


def encode_pairs_payload(vals: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """(vals, idx) -> the concatenated pair wire payload (values first,
    then indices cast to f32 — exact below :data:`PAIR_WIRE_MAX_N`)."""
    return np.concatenate([np.asarray(vals, np.float32).reshape(-1),
                           np.asarray(idx, np.float32).reshape(-1)])


def decode_pairs_payload(payload: np.ndarray):
    """Inverse of :func:`encode_pairs_payload`: ``(vals fp32, idx
    int64)`` — sentinels (< 0) preserved for the caller's mask."""
    pairs = np.asarray(payload, np.float32).reshape(-1)
    k = pairs.size // 2
    return pairs[:k], pairs[k:].astype(np.int64)


def densify_pairs_host(vals: np.ndarray, idx: np.ndarray, n: int,
                       out: "np.ndarray | None" = None) -> np.ndarray:
    """Scatter a (value, index) pair set into a dense fp32 vector — the
    ONE densify a sparse-merged round ever pays, and only when a dense
    consumer actually asks (lazy value materialization in
    service/server.py; the client-side decompress of a sparse pull).
    Sentinel pairs (index < 0) drop; duplicate indices SUM (merged sets
    are unique by construction, but a raw push payload is not — add
    semantics keep every densify path consistent with
    :func:`merge_pairs_host` and the legacy per-push densify)."""
    if out is None:
        out = np.zeros((int(n),), np.float32)
    idx = np.asarray(idx).reshape(-1).astype(np.int64)
    vals = np.asarray(vals, np.float32).reshape(-1)
    valid = idx >= 0
    if valid.any():
        np.add.at(out, idx[valid], vals[valid])
    return out
