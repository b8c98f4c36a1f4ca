"""Hierarchical collectives over the replica axes (port of
geomx_tpu/parallel/collectives.py:22-98).

In the JAX package each collective runs per device inside
``shard_map`` and reduces over a named mesh axis.  Here every replica
lives in one tensor whose leading dims are ``[P, W]`` (``dc`` = dim 0,
``worker`` = dim 1), and a collective is a reduction over that dim whose
result every replica along it receives — the same value the per-device
collective hands each device.  Results of the sums are broadcast views
(stride 0 over the reduced dim); per-replica slices of them stay
contiguous.

On a device mesh (``topology.ReplicaMesh``) :func:`run_on_mesh` runs one
program a slot, a thread each, at local leading dims ``[1, 1]``, as
``shard_map`` runs one a device.  A public collective called inside a
slot meets the other slots at a rendezvous: every slot's operand is
gathered in ``(p, w)`` order onto the mesh's first device, the one-device
function below runs on the full ``[P, W, ...]`` stack, and each slot
gets a copy of its ``[1, 1, ...]`` block on its own device.  The same
code on the same shapes gives the stacked path's bits; the axis sizes
come from the slot's context, never from the operand's shape.

The sequence-parallel axis ``sp`` is not a state axis: an sp-aware model
holds one replica's ``S`` sequence shards as dim 0 of its activations
(``[S, ...]``), and the ``*_sp`` helpers below exchange data over that
dim as the per-device collectives over the ``sp`` mesh axis do.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional, Sequence

import torch

from geomx_tpu_torch.topology import DC_AXIS, SP_AXIS, WORKER_AXIS

_DIM = {DC_AXIS: 0, WORKER_AXIS: 1}

_recorder = None


def set_recorder(fn):
    """Install ``fn`` in the recorder slot (None clears it); returns the
    callable it replaces."""
    global _recorder
    prev, _recorder = _recorder, fn
    return prev


def axis_dim(axis_name: str) -> int:
    try:
        return _DIM[axis_name]
    except KeyError:
        raise ValueError(f"unknown replica axis {axis_name!r}; expected "
                         f"one of {sorted(_DIM)}") from None


# ---- the device mesh: one program a slot ---------------------------------

_slot_ctx = threading.local()


class _Rendezvous:
    """Where a mesh's slots meet at each collective: a barrier whose
    action (run by the last slot to arrive, before any leaves) computes
    the collective on the gathered stack."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.calls: list = [None] * mesh.size
        self.out = None
        self.barrier = threading.Barrier(mesh.size, action=self._meet,
                                         timeout=mesh.timeout_s)

    def _meet(self) -> None:
        fn, args, x0 = self.calls[0]
        for i, (f, a, x) in enumerate(self.calls):
            if f is not fn or a != args or x.shape != x0.shape \
                    or x.dtype != x0.dtype:
                raise RuntimeError(
                    f"mesh slots diverged at a collective: slot 0 called "
                    f"{fn.__name__}{args} on {tuple(x0.shape)} "
                    f"{x0.dtype}, slot {divmod(i, self.mesh.shape[1])} "
                    f"{f.__name__}{a} on {tuple(x.shape)} {x.dtype}")
        first = self.mesh.first_device
        full = torch.cat([x.to(first) for _, _, x in self.calls])
        self.calls = [None] * self.mesh.size
        self.out = fn(full.view(self.mesh.shape + tuple(x0.shape[2:])),
                      *args)


class MeshSlot:
    """The context of the slot a thread runs (:func:`run_on_mesh`): its
    coordinates ``(p, w)``, the axis sizes ``P, W``, its device."""

    def __init__(self, p: int, w: int, mesh, rendezvous: _Rendezvous):
        self.p, self.w = p, w
        self.P, self.W = mesh.shape
        self.index = p * self.W + w
        self.device = mesh.devices[p][w]
        self._rv = rendezvous

    def collective(self, fn: Callable, x: torch.Tensor, *args):
        """``fn(stack, *args)`` on every slot's ``x`` stacked to ``[P, W,
        ...]``; returns this slot's ``[1, 1, ...]`` block of the result,
        copied onto its device."""
        if tuple(x.shape[:2]) != (1, 1):
            raise ValueError(f"a slot's collective operand is [1, 1, ...], "
                             f"got {tuple(x.shape)}")
        rv = self._rv
        rv.calls[self.index] = (fn, args, x)
        rv.barrier.wait()
        return rv.out[self.p:self.p + 1, self.w:self.w + 1] \
            .to(self.device, copy=True)


def current_slot() -> Optional[MeshSlot]:
    """The mesh slot this thread runs, None outside :func:`run_on_mesh`."""
    return getattr(_slot_ctx, "slot", None)


def run_on_mesh(fn: Callable, mesh, per_slot_args: Sequence) -> list:
    """``fn(*per_slot_args[i])`` once a slot of ``mesh``, a thread each,
    under the slot's context (and ``torch.cuda.device`` on a card), as
    ``shard_map`` runs one program a device.  Returns the results in
    ``(p, w)`` order.  A slot that raises aborts the rendezvous, so the
    others raise at their next collective instead of waiting; a slot
    that waits ``mesh.timeout_s`` at a collective raises too.  The first
    error (one that is not a slot's broken wait, where there is one)
    is re-raised here."""
    n = mesh.size
    if len(per_slot_args) != n:
        raise ValueError(f"{len(per_slot_args)} argument tuples for "
                         f"{n} mesh slots")
    rv = _Rendezvous(mesh)
    results: list = [None] * n
    errors: list = [None] * n

    def body(p: int, w: int, args) -> None:
        slot = MeshSlot(p, w, mesh, rv)
        _slot_ctx.slot = slot
        scope = torch.cuda.device(slot.device) \
            if slot.device.type == "cuda" else contextlib.nullcontext()
        try:
            with scope:
                results[slot.index] = fn(*args)
        except BaseException as e:  # re-raised by the launcher
            errors[slot.index] = e
            rv.barrier.abort()
        finally:
            _slot_ctx.slot = None

    threads = [threading.Thread(target=body, args=(p, w, per_slot_args[i]),
                                name=f"mesh-slot-{p}-{w}", daemon=True)
               for i, (p, w, _) in enumerate(mesh.slots())]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for e in errors:
        if e is not None and not isinstance(e, threading.BrokenBarrierError):
            raise e
    for i, e in enumerate(errors):
        if e is not None:
            raise RuntimeError(
                f"mesh slot {divmod(i, mesh.shape[1])} waited "
                f"{mesh.timeout_s} s at a collective: the slots diverged "
                "or one of them hangs") from e
    return results


def _slotted(fn: Callable, x: torch.Tensor, *args):
    """``fn(x, *args)``, or its meshed form inside a slot."""
    slot = current_slot()
    if slot is None:
        return fn(x, *args)
    return slot.collective(fn, x, *args)


# ---- the collectives --------------------------------------------------------

def _psum(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    d = axis_dim(axis_name)
    if _recorder is not None:
        _recorder("psum", axis_name, x, 2, ())
    return x.sum(dim=d, keepdim=True).expand_as(x)


def _pmean(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    return _psum(x, axis_name) / x.shape[axis_dim(axis_name)]


def psum(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Sum over one replica axis, as every replica on it receives it."""
    return _slotted(_psum, x, axis_name)


def pmean(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    return _slotted(_pmean, x, axis_name)


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
    return _slotted(_psum_scatter, x, axis_name)


def all_gather(x: torch.Tensor, axis_name: str,
               tiled: bool = False) -> torch.Tensor:
    """Gather every replica's payload along one axis: ``x`` is
    ``[P, W, *s]``; replica ``(p, w)`` of the result holds the stack of
    the payloads along the axis, so the result is ``[P, W, A, *s]``
    with ``A`` the axis size (``lax.all_gather`` with ``axis=0``).
    ``tiled``: the payloads are concatenated along their first dim
    instead, ``[P, W, A * s0, *s[1:]]`` (``tiled=True``): the inverse of
    :func:`psum_scatter`'s layout.  A view where it can be one."""
    return _slotted(_all_gather, x, axis_name, tiled)


def all_gather_dc(x: torch.Tensor) -> torch.Tensor:
    """The wire transfer of a compressed push across the global tier."""
    return all_gather(x, DC_AXIS)


def pmax(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Maximum over one replica axis, as every replica on it receives it."""
    return _slotted(_pmax, x, axis_name)


def all_to_all(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Personalised exchange along one axis: ``x`` is ``[P, W, A, *s]``
    with one block a destination along the axis; replica ``(p, w)`` of
    the result holds, at ``q``, the block that replica ``q`` of the axis
    addressed to it (``lax.all_to_all`` with ``split_axis=0,
    concat_axis=0``).  A view."""
    return _slotted(_all_to_all, x, axis_name)


def _psum_scatter(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    d = axis_dim(axis_name)
    P, W = x.shape[:2]
    A = x.shape[d]
    if x.dim() != 3 or x.shape[-1] % A:
        raise ValueError(f"psum_scatter takes [P, W, {A} * s] rows, got "
                         f"{tuple(x.shape)}")
    if _recorder is not None:
        _recorder("reduce_scatter", axis_name, x, 2, ())
    s = x.shape[-1] // A
    if d == 1:
        # out[p, w] = sum_q x[p, q, w*s:(w+1)*s]
        return x.view(P, W, W, s).sum(dim=1)
    # out[p, w] = sum_q x[q, w, p*s:(p+1)*s]
    return x.view(P, W, P, s).sum(dim=0).transpose(0, 1).contiguous()


def _all_gather(x: torch.Tensor, axis_name: str,
                tiled: bool = False) -> torch.Tensor:
    P, W = x.shape[:2]
    if _recorder is not None:
        _recorder("all_gather", axis_name, x, 2, ())
    if axis_dim(axis_name) == 0:
        # out[p, w, q] = x[q, w]
        out = x.transpose(0, 1).unsqueeze(0).expand(P, W, P, *x.shape[2:])
    else:
        # out[p, w, q] = x[p, q]
        out = x.unsqueeze(1).expand(P, W, W, *x.shape[2:])
    return out.flatten(2, 3) if tiled else out


def _pmax(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    d = axis_dim(axis_name)
    if _recorder is not None:
        _recorder("pmax", axis_name, x, 2, ())
    return x.amax(dim=d, keepdim=True).expand_as(x)


def _all_to_all(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    d = axis_dim(axis_name)
    if _recorder is not None:
        _recorder("all_to_all", axis_name, x, 2, ())
    if d == 0:
        # out[p, w, q] = x[q, w, p]
        return x.transpose(0, 2)
    # out[p, w, q] = x[p, q, w]
    return x.transpose(1, 2)


def _slot_block(full: torch.Tensor) -> torch.Tensor:
    """Inside a slot, the slot's ``[1, 1]`` block of a ``[P, W]`` index
    tensor; else the tensor."""
    slot = current_slot()
    if slot is None:
        return full
    return full[slot.p:slot.p + 1, slot.w:slot.w + 1]


def party_index(P: int, W: int, device=None) -> torch.Tensor:
    """``[P, W]`` int tensor: each replica's party index (inside a mesh
    slot, ``[1, 1]``: the slot's global one; ``P, W`` are then the
    slot's axis sizes)."""
    slot = current_slot()
    if slot is not None:
        P, W = slot.P, slot.W
    return _slot_block(torch.arange(P, device=device).view(P, 1)
                       .expand(P, W))


def worker_index(P: int, W: int, device=None) -> torch.Tensor:
    """``[P, W]`` int tensor: each replica's worker index (the slot's
    inside a mesh slot)."""
    slot = current_slot()
    if slot is not None:
        P, W = slot.P, slot.W
    return _slot_block(torch.arange(W, device=device).view(1, W)
                       .expand(P, W))


def global_worker_rank(P: int, W: int, device=None) -> torch.Tensor:
    """Linear rank over all workers (reference: kvstore rank; the
    slot's inside a mesh slot)."""
    slot = current_slot()
    if slot is not None:
        P, W = slot.P, slot.W
    return party_index(P, W, device) * W + worker_index(P, W, device)


# ---- the sp axis: dim 0 of a replica's activations ------------------------

def ppermute_sp(x: torch.Tensor) -> torch.Tensor:
    """The ring step ``lax.ppermute(x, "sp", [(i, (i + 1) % n)])``: shard
    ``i`` receives shard ``i - 1``'s block."""
    if _recorder is not None:
        n = x.shape[0]
        _recorder("ppermute", SP_AXIS, x, 1,
                  (("perm", tuple((i, (i + 1) % n) for i in range(n))),))
    return torch.roll(x, 1, dims=0)


def pmean_sp(x: torch.Tensor) -> torch.Tensor:
    """Mean over the sp shards, as every shard receives it."""
    if _recorder is not None:
        _recorder("psum", SP_AXIS, x, 1, ())
    return x.mean(dim=0, keepdim=True).expand_as(x)


def all_to_all_sp(x: torch.Tensor, split_dim: int,
                  concat_dim: int) -> torch.Tensor:
    """``lax.all_to_all(x, "sp", split_axis, concat_axis, tiled=True)``
    over the shards of ``x = [S, *s]``: ``split_dim`` and ``concat_dim``
    index a shard's own dims ``s``.  Shard ``j`` of the result is the
    concatenation, along ``concat_dim`` and in shard order, of chunk
    ``j`` (of ``S`` along ``split_dim``) of every shard.  A copy."""
    S = x.shape[0]
    if _recorder is not None:
        _recorder("all_to_all", SP_AXIS, x, 1, ())
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
