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
come from the slot's context, never from the operand's shape.  On a
``[P, W, S]`` mesh a dc or worker collective reduces within each sp
plane (the slots of one ``s``), as the JAX collectives over a named axis
of a 3-D mesh do.

The sequence-parallel axis ``sp`` is not a state axis: an sp-aware model
holds one replica's ``S`` sequence shards as dim 0 of its activations
(``[S, ...]``), and the ``*_sp`` helpers below exchange data over that
dim as the per-device collectives over the ``sp`` mesh axis do.  In an
sp mesh slot that dim is 1, the slot's own shard, and the helpers meet
the ``S`` slots of its ``(p, w)``.  There the exchange sits in the
middle of the model's autograd graph, and its transpose is a collective
too: the slot's :class:`SpTape` cuts the graph at every exchange and
runs the backward segment by segment in the slot's own thread, the
cotangents exchanged between segments (:meth:`SpTape.grad`), so no slot
ever waits at a rendezvous inside an autograd backward node (on the card
those run on the device's autograd thread, not the slot's).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional, Sequence

import torch

from geomx_tpu_torch.topology import DC_AXIS, SP_AXIS, WORKER_AXIS

_DIM = {DC_AXIS: 0, WORKER_AXIS: 1}

_recorder = None
# set in the thread that computes a meshed collective once more for
# another sp plane or group: the program's record takes one entry a call
_muted = threading.local()


def set_recorder(fn):
    """Install ``fn`` in the recorder slot (None clears it); returns the
    callable it replaces."""
    global _recorder
    prev, _recorder = _recorder, fn
    return prev


def _record(op: str, axis: str, x: torch.Tensor, lead: int,
            extras: tuple = ()) -> None:
    if _recorder is not None and not getattr(_muted, "on", False):
        _recorder(op, axis, x, lead, extras)


def axis_dim(axis_name: str) -> int:
    try:
        return _DIM[axis_name]
    except KeyError:
        raise ValueError(f"unknown replica axis {axis_name!r}; expected "
                         f"one of {sorted(_DIM)}") from None


def axis_replicas(x: torch.Tensor, axis_name: str) -> int:
    """The size of a replica axis as ``x``'s program sees it: the slot's
    ``P`` or ``W`` inside a mesh slot (where ``x`` is a ``[1, 1, ...]``
    block), else ``x``'s dim for the axis."""
    d = axis_dim(axis_name)
    slot = current_slot()
    if slot is None:
        return int(x.shape[d])
    return (slot.P, slot.W)[d]


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
        fn, args, sp, x0 = self.calls[0]
        for i, (f, a, q, x) in enumerate(self.calls):
            if f is not fn or a != args or q != sp or \
                    x.shape != x0.shape or x.dtype != x0.dtype:
                raise RuntimeError(
                    f"mesh slots diverged at a collective: slot 0 called "
                    f"{fn.__name__}{args} on {tuple(x0.shape)} "
                    f"{x0.dtype}, slot {self.mesh.coords(i)} "
                    f"{f.__name__}{a} on {tuple(x.shape)} {x.dtype}")
        mesh = self.mesh
        first = mesh.first_device
        S = mesh.sp
        xs = [x.to(first) for _, _, _, x in self.calls]
        self.calls = [None] * mesh.size
        if sp:
            # one [S, ...] stack a (p, w): the slot takes its shard's row
            groups = [torch.cat(xs[g * S:(g + 1) * S])
                      for g in range(len(xs) // S)]
        else:
            # one [P, W, ...] stack an sp plane: the slot takes its block
            shape = mesh.shape + tuple(x0.shape[2:])
            groups = [torch.cat(xs[s::S]).view(shape) for s in range(S)]
        outs = []
        try:
            for g in groups:
                outs.append(fn(g, *args))
                _muted.on = True  # one record a collective call
        finally:
            _muted.on = False
        self.out = outs


class MeshSlot:
    """The context of the slot a thread runs (:func:`run_on_mesh`): its
    coordinates ``(p, w, s)``, the axis sizes ``P, W, S``, its device."""

    def __init__(self, p: int, w: int, s: int, mesh,
                 rendezvous: _Rendezvous):
        self.p, self.w, self.s = p, w, s
        self.P, self.W = mesh.shape
        self.S = mesh.sp
        self.index = mesh.index(p, w, s)
        self.coords = mesh.coords(self.index)
        self.device = mesh.devices[p][w][s]
        self._rv = rendezvous
        self.tape: Optional["SpTape"] = None

    def collective(self, fn: Callable, x: torch.Tensor, *args,
                   sp: bool = False):
        """``fn(stack, *args)`` on every slot's ``x`` stacked to ``[P, W,
        ...]`` within the slot's sp plane; returns this slot's ``[1, 1,
        ...]`` block of the result, copied onto its device.  ``sp``:
        ``x`` is the slot's ``[1, ...]`` sp shard instead, stacked to
        ``[S, ...]`` with the other shards of its ``(p, w)``, and the
        slot gets its shard's ``[1, ...]`` row back."""
        lead = (1,) if sp else (1, 1)
        if tuple(x.shape[:len(lead)]) != lead:
            raise ValueError(f"a slot's collective operand is "
                             f"{list(lead) + ['...']}, got {tuple(x.shape)}")
        rv = self._rv
        rv.calls[self.index] = (fn, args, sp, x)
        rv.barrier.wait()
        if sp:
            out = rv.out[self.p * self.W + self.w][self.s:self.s + 1]
        else:
            out = rv.out[self.s][self.p:self.p + 1, self.w:self.w + 1]
        return out.to(self.device, copy=True)


def current_slot() -> Optional[MeshSlot]:
    """The mesh slot this thread runs, None outside :func:`run_on_mesh`."""
    return getattr(_slot_ctx, "slot", None)


def records_here() -> bool:
    """Whether this thread writes a shared object's inspection record
    (a compressor's ``last_wire``): always outside a mesh slot, only
    slot ``(0, 0)`` inside one, so the slots never overwrite each
    other's record and nothing reads a record back within a step."""
    slot = current_slot()
    return slot is None or slot.index == 0


def run_on_mesh(fn: Callable, mesh, per_slot_args: Sequence) -> list:
    """``fn(*per_slot_args[i])`` once a slot of ``mesh``, a thread each,
    under the slot's context (and ``torch.cuda.device`` on a card), as
    ``shard_map`` runs one program a device.  Returns the results in
    slot order.  A slot that raises aborts the rendezvous, so the
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

    def body(p: int, w: int, s: int, args) -> None:
        slot = MeshSlot(p, w, s, mesh, rv)
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

    threads = [threading.Thread(
        target=body, args=(p, w, s, per_slot_args[i]),
        name="mesh-slot-" + "-".join(map(str, mesh.coords(i))), daemon=True)
        for i, (p, w, s, _) in enumerate(mesh.slot_coords())]
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
                f"mesh slot {mesh.coords(i)} waited "
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
    _record("psum", axis_name, x, 2)
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
    _record("reduce_scatter", axis_name, x, 2)
    s = x.shape[-1] // A
    if d == 1:
        # out[p, w] = sum_q x[p, q, w*s:(w+1)*s]
        return x.view(P, W, W, s).sum(dim=1)
    # out[p, w] = sum_q x[q, w, p*s:(p+1)*s]
    return x.view(P, W, P, s).sum(dim=0).transpose(0, 1).contiguous()


def _all_gather(x: torch.Tensor, axis_name: str,
                tiled: bool = False) -> torch.Tensor:
    P, W = x.shape[:2]
    _record("all_gather", axis_name, x, 2)
    if axis_dim(axis_name) == 0:
        # out[p, w, q] = x[q, w]
        out = x.transpose(0, 1).unsqueeze(0).expand(P, W, P, *x.shape[2:])
    else:
        # out[p, w, q] = x[p, q]
        out = x.unsqueeze(1).expand(P, W, W, *x.shape[2:])
    return out.flatten(2, 3) if tiled else out


def _pmax(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    d = axis_dim(axis_name)
    _record("pmax", axis_name, x, 2)
    return x.amax(dim=d, keepdim=True).expand_as(x)


def _all_to_all(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    d = axis_dim(axis_name)
    _record("all_to_all", axis_name, x, 2)
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

def sp_axis_size(x: torch.Tensor) -> int:
    """The sp axis size as ``x``'s program sees it: the slot's ``S`` in a
    mesh slot (where ``x`` holds the slot's one shard), else ``x``'s dim
    0 (``lax.psum(1, "sp")``)."""
    slot = current_slot()
    return int(x.shape[0]) if slot is None else slot.S


def sp_axis_index() -> Optional[int]:
    """The slot's sp index in a mesh slot (``lax.axis_index("sp")``),
    None on the stacked path, where dim 0 holds every shard."""
    slot = current_slot()
    return None if slot is None else slot.s


def _ppermute_sp(x: torch.Tensor, shift: int) -> torch.Tensor:
    n = x.shape[0]
    _record("ppermute", SP_AXIS, x, 1,
            (("perm", tuple((i, (i + shift) % n) for i in range(n))),))
    return torch.roll(x, shift, dims=0)


def _pmean_sp(x: torch.Tensor) -> torch.Tensor:
    _record("psum", SP_AXIS, x, 1)
    return x.mean(dim=0, keepdim=True).expand_as(x)


def _psum_sp(x: torch.Tensor) -> torch.Tensor:
    _record("psum", SP_AXIS, x, 1)
    return x.sum(dim=0, keepdim=True).expand_as(x)


def _all_to_all_sp(x: torch.Tensor, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
    S = x.shape[0]
    _record("all_to_all", SP_AXIS, x, 1)
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


def _sp_exchange(fn: Callable, x: torch.Tensor, args: tuple,
                 t_args: tuple) -> torch.Tensor:
    """``fn(x, *args)`` over the sp shards; in a mesh slot a rendezvous
    of the ``S`` slots of its ``(p, w)``, taped for the backward when
    ``x`` carries a gradient (``fn(ct, *t_args)`` is the transpose)."""
    slot = current_slot()
    if slot is None:
        return fn(x, *args)
    if not (torch.is_grad_enabled() and x.requires_grad):
        return slot.collective(fn, x, *args, sp=True)
    if slot.tape is None:
        raise RuntimeError(
            "an sp exchange in a mesh slot carries a gradient but the slot "
            "records no sp tape: run the forward under collectives.sp_tape() "
            "and its backward through SpTape.grad (train/step.py)")
    y = slot.collective(fn, x.detach(), *args, sp=True).requires_grad_()
    slot.tape.record(x, y, fn, t_args)
    return y


def ppermute_sp(x: torch.Tensor) -> torch.Tensor:
    """The ring step ``lax.ppermute(x, "sp", [(i, (i + 1) % n)])``: shard
    ``i`` receives shard ``i - 1``'s block."""
    return _sp_exchange(_ppermute_sp, x, (1,), (-1,))


def pmean_sp(x: torch.Tensor) -> torch.Tensor:
    """Mean over the sp shards, as every shard receives it."""
    return _sp_exchange(_pmean_sp, x, (), ())


def psum_sp(x: torch.Tensor) -> torch.Tensor:
    """Sum over the sp shards, as every shard receives it."""
    return _sp_exchange(_psum_sp, x, (), ())


def all_to_all_sp(x: torch.Tensor, split_dim: int,
                  concat_dim: int) -> torch.Tensor:
    """``lax.all_to_all(x, "sp", split_axis, concat_axis, tiled=True)``
    over the shards of ``x = [S, *s]``: ``split_dim`` and ``concat_dim``
    index a shard's own dims ``s``.  Shard ``j`` of the result is the
    concatenation, along ``concat_dim`` and in shard order, of chunk
    ``j`` (of ``S`` along ``split_dim``) of every shard.  A copy.  Its
    transpose swaps the two dims."""
    return _sp_exchange(_all_to_all_sp, x, (split_dim, concat_dim),
                        (concat_dim, split_dim))


class SpTape:
    """The sp exchanges of one slot's forward, for its backward.

    Each taped exchange cuts the autograd graph: its output is a fresh
    leaf ``y`` and the tape keeps ``(x, y, transpose)``.  :meth:`grad`
    back-propagates the loss to the inputs and to every ``y``, then walks
    the exchanges in reverse: a ``y``'s cotangent is complete once every
    later segment has run, so its transpose (a collective of the slot's
    own thread, never of an autograd node) hands the cotangent of ``x``
    back, and one ``torch.autograd.grad`` carries it on through ``x``'s
    segment.  Exchanges recorded under :meth:`group` (independent ones,
    such as the ring's K and V rotations) share one backward call."""

    def __init__(self, slot: MeshSlot):
        self.slot = slot
        self.entries: list = []  # (x, y, fn, t_args, group)
        self._group: Optional[int] = None
        self._groups = 0

    @contextlib.contextmanager
    def group(self):
        """Exchanges recorded inside share one backward segment: none of
        their inputs may depend on another's output."""
        prev, self._group = self._group, self._new_group()
        try:
            yield
        finally:
            self._group = prev

    def _new_group(self) -> int:
        self._groups += 1
        return self._groups

    def record(self, x: torch.Tensor, y: torch.Tensor, fn: Callable,
               t_args: tuple) -> None:
        g = self._group if self._group is not None else self._new_group()
        self.entries.append((x, y, fn, t_args, g))

    def grad(self, loss: torch.Tensor, inputs: Sequence[torch.Tensor]
             ) -> tuple:
        """``torch.autograd.grad(loss, inputs)`` through the taped
        exchanges (zeros for an input the loss does not reach)."""
        inputs = list(inputs)
        ys = [e[1] for e in self.entries]
        y_at = {id(y): i for i, y in enumerate(ys)}
        in_at = {id(t): i for i, t in enumerate(inputs)}
        acc_in: list = [None] * len(inputs)
        acc_y: list = [None] * len(ys)

        def add(acc, i, g):
            acc[i] = g if acc[i] is None else acc[i] + g

        def backprop(outs, cts, upto: int) -> None:
            got = torch.autograd.grad(outs, inputs + ys[:upto], cts,
                                      retain_graph=True, allow_unused=True)
            for i, g in enumerate(got):
                if g is not None:
                    if i < len(inputs):
                        add(acc_in, i, g)
                    else:
                        add(acc_y, i - len(inputs), g)

        backprop([loss], None, len(ys))
        end = len(self.entries)
        while end:
            group = self.entries[end - 1][4]
            start = end
            while start and self.entries[start - 1][4] == group:
                start -= 1
            outs, cts = [], []
            for k in range(end - 1, start - 1, -1):
                x, y, fn, t_args, _ = self.entries[k]
                ct = acc_y[k] if acc_y[k] is not None else torch.zeros_like(y)
                ct_x = self.slot.collective(fn, ct, *t_args, sp=True)
                if id(x) in y_at:
                    if y_at[id(x)] >= start:
                        raise RuntimeError("an sp exchange group feeds "
                                           "itself")
                    add(acc_y, y_at[id(x)], ct_x)
                elif id(x) in in_at:
                    add(acc_in, in_at[id(x)], ct_x)
                else:
                    outs.append(x)
                    cts.append(ct_x)
            if outs:
                backprop(outs, cts, start)
            end = start
        return tuple(torch.zeros_like(t) if g is None else g
                     for g, t in zip(acc_in, inputs))


@contextlib.contextmanager
def sp_tape():
    """Tape the sp exchanges of the slot's forward (:class:`SpTape`);
    yields the tape, None outside a mesh slot."""
    slot = current_slot()
    if slot is None:
        yield None
        return
    tape = SpTape(slot)
    prev, slot.tape = slot.tape, tape
    try:
        yield tape
    finally:
        slot.tape = prev


def sp_exchange_group():
    """A context in which the slot's taped sp exchanges share one
    backward segment (:meth:`SpTape.group`); a no-op elsewhere."""
    slot = current_slot()
    if slot is None or slot.tape is None:
        return contextlib.nullcontext()
    return slot.tape.group()
