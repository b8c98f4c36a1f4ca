"""The HiPS two-tier topology (port of geomx_tpu/topology.py).

The JAX package maps the two tiers onto a 2-D device mesh with named
axes.  The port keeps the axis names and the ``[num_parties,
workers_per_party]`` shape.  By default it holds every replica in one
process on one card: each state tensor carries the two replica axes as
its leading dimensions, and ``parallel/collectives.py`` reduces over
them.

``HiPSTopology.build_mesh`` gives the counterpart of the JAX mesh, a
:class:`ReplicaMesh`: a ``[P, W]`` grid of ``torch.device``s, one a
replica slot, or with ``sp_degree = S > 1`` a ``[P, W, S]`` grid, sp
innermost.  ``mesh.place`` splits a stacked ``[P, W, ...]`` tree into
per-slot ``[1, 1, ...]`` blocks on their devices (the JAX package's
``replica_sharding``/``batch_sharding``; over sp the state replicates
and a token batch's sequence dim splits, ``seq_batch_sharding``),
``mesh.gather`` stacks them back onto one device (``jax.device_get``).
The step then runs one program a slot (``parallel/collectives.py``
``run_on_mesh``), as ``shard_map`` runs one a device.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence, Tuple

import torch

# Axis names for the two HiPS tiers (the leading dims of every state
# tensor, in this order).
DC_AXIS = "dc"          # cross-party / global tier: dim 0
WORKER_AXIS = "worker"  # intra-party / local tier: dim 1
REPLICA_AXES = (DC_AXIS, WORKER_AXIS)
# Sequence-parallel axis: not a state axis.  State replicates over it;
# an sp-aware model holds one replica's sequence shards as the leading
# dim of its activations (``parallel/collectives.py`` sp helpers).
SP_AXIS = "sp"


def normalize_live_mask(mask, num_parties: int) -> Tuple[bool, ...]:
    """Canonicalize a live-party mask: a length-``num_parties`` tuple of
    bools with at least one survivor."""
    m = tuple(bool(x) for x in mask)
    if len(m) != num_parties:
        raise ValueError(f"live mask has {len(m)} entries for "
                         f"{num_parties} parties")
    if not any(m):
        raise ValueError("a membership epoch needs at least one live "
                         "party — an all-dead mesh has no survivor mean")
    return m


@dataclasses.dataclass(frozen=True)
class HiPSTopology:
    """A two-tier hierarchical data-parallel topology.

    ``num_parties`` is the number of data centers (the ``dc`` axis),
    ``workers_per_party`` the workers inside each (the ``worker`` axis).
    ``sp_degree`` is the number of sequence shards of each replica (the
    ``sp`` axis): an sp-aware model splits its sequence into that many
    chunks, and the state stays replicated over them.
    """

    num_parties: int = 1
    workers_per_party: int = 1
    sp_degree: int = 1

    def __post_init__(self):
        if self.num_parties < 1 or self.workers_per_party < 1 \
                or self.sp_degree < 1:
            raise ValueError("topology sizes must be >= 1")

    @property
    def total_workers(self) -> int:
        return self.num_parties * self.workers_per_party

    @property
    def replica_shape(self) -> Tuple[int, int]:
        """The leading ``[P, W]`` dims of every state tensor (the state
        replicates over ``sp``)."""
        return (self.num_parties, self.workers_per_party)

    @classmethod
    def from_devices(cls, num_parties: Optional[int] = None,
                     devices: Optional[Sequence] = None) -> "HiPSTopology":
        """Infer a topology covering all the cards (or the given
        devices), as the JAX package's: with ``num_parties`` unset, 2
        parties when the count is even, else 1 (8 devices -> 2 x 4)."""
        n = len(devices) if devices is not None \
            else torch.cuda.device_count()
        if num_parties is None:
            num_parties = 2 if n % 2 == 0 and n >= 2 else 1
        if n % num_parties != 0:
            raise ValueError(f"{n} devices not divisible by {num_parties} "
                             "parties")
        return cls(num_parties=num_parties, workers_per_party=n // num_parties)

    def build_mesh(self, devices: Optional[Sequence] = None,
                   timeout_s: Optional[float] = None) -> "ReplicaMesh":
        """The ``[P, W]`` device mesh, or ``[P, W, S]`` with ``sp_degree
        = S > 1``: slot ``(p, w, s)`` on ``devices[(p * W + w) * S +
        s]``, sp innermost as in the JAX package's mesh.  ``devices``
        defaults to ``cuda:0 .. cuda:n-1``; there is no fallback to the
        CPU.  A list may name one device more than once (``["cpu"] *
        8``: torch has one CPU device).  ``timeout_s``: how long a slot
        waits for the others at a collective before the step raises
        (:class:`ReplicaMesh`)."""
        if devices is None:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        P, W, S = self.num_parties, self.workers_per_party, self.sp_degree
        need = P * W * S
        if len(devices) < need:
            raise ValueError(f"topology needs {need} devices, only "
                             f"{len(devices)} available")
        devs = [torch.device(d) for d in list(devices)[:need]]
        grid = [[devs[(p * W + w) * S:(p * W + w + 1) * S] for w in range(W)]
                for p in range(P)]
        if timeout_s is None:
            return ReplicaMesh(grid)
        return ReplicaMesh(grid, timeout_s=timeout_s)


@dataclasses.dataclass
class PlacedTree:
    """A tree split over a mesh: ``slots[mesh.index(p, w, s)]`` is slot
    ``(p, w, s)``'s copy, its tensors ``[1, 1, ...]`` blocks on the
    slot's device.  ``seq_dim``: the dim a token batch's sequence is
    split along over the sp slots (None: each sp slot holds the whole
    block)."""

    mesh: "ReplicaMesh"
    slots: list
    seq_dim: Optional[int] = None

    def slot(self, p: int, w: int, s: int = 0):
        return self.slots[self.mesh.index(p, w, s)]


class ReplicaMesh:
    """A ``[P, W]`` grid of devices with the axis names ``("dc",
    "worker")``, one replica slot a grid entry (several slots may share
    a device); or a ``[P, W, S]`` grid with ``"sp"`` innermost, whose S
    slots of one ``(p, w)`` hold one replica's sequence shards.
    ``shape`` is ``(P, W)``, the state's replica axes, and ``sp`` is
    ``S``.  ``timeout_s`` bounds a slot's wait for the others at a
    collective: a slot that never arrives fails the step instead of
    hanging it."""

    def __init__(self, devices, timeout_s: float = 300.0):
        rows = [list(row) for row in devices]
        if not rows or not rows[0] or len({len(r) for r in rows}) != 1:
            raise ValueError("a mesh is a non-empty [P, W] grid of devices")
        nested = isinstance(rows[0][0], (list, tuple))
        cells = [[tuple(torch.device(d) for d in (c if nested else [c]))
                  for c in row] for row in rows]
        if len({len(c) for row in cells for c in row}) != 1 \
                or not cells[0][0]:
            raise ValueError("a mesh's sp cells hold one device count")
        self.devices = tuple(tuple(row) for row in cells)  # [P][W][S]
        self.shape = (len(cells), len(cells[0]))
        self.sp = len(cells[0][0])
        self.axis_names = REPLICA_AXES + ((SP_AXIS,) if self.sp > 1 else ())
        self.timeout_s = float(timeout_s)

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1] * self.sp

    def index(self, p: int, w: int, s: int = 0) -> int:
        """Slot ``(p, w, s)``'s position in slot order."""
        return (p * self.shape[1] + w) * self.sp + s

    def coords(self, i: int) -> Tuple[int, ...]:
        """The ``(p, w)`` (or ``(p, w, s)`` on an sp mesh) of slot ``i``."""
        pw, s = divmod(i, self.sp)
        return divmod(pw, self.shape[1]) + ((s,) if self.sp > 1 else ())

    @property
    def first_device(self) -> torch.device:
        """Slot ``(0, 0)``'s device: where the collectives compute and
        where evaluation runs."""
        return self.devices[0][0][0]

    def slot_coords(self) -> Iterator[Tuple[int, int, int, torch.device]]:
        """``(p, w, s, device)`` of every slot, in slot order."""
        for p, row in enumerate(self.devices):
            for w, cell in enumerate(row):
                for s, dev in enumerate(cell):
                    yield p, w, s, dev

    def slots(self) -> Iterator[Tuple[int, int, torch.device]]:
        """``(p, w, device)`` of every slot, in slot order (on an sp
        mesh each ``(p, w)`` once an sp slot)."""
        for p, w, _, dev in self.slot_coords():
            yield p, w, dev

    def distinct_devices(self) -> list:
        """The mesh's devices, each once, in slot order."""
        return list(dict.fromkeys(d for _, _, d in self.slots()))

    def on(self, device) -> "ReplicaMesh":
        """A mesh of this one's shape with every slot on ``device`` (the
        audit records a meshed program on the CPU)."""
        dev = torch.device(device)
        return ReplicaMesh([[[dev] * self.sp for _ in range(self.shape[1])]
                            for _ in range(self.shape[0])],
                           timeout_s=self.timeout_s)

    def place(self, tree, seq_dim: Optional[int] = None) -> PlacedTree:
        """Every ``[P, W, ...]`` tensor of ``tree`` (dicts, lists,
        tuples, dataclasses such as ``TrainState``) split into per-slot
        ``[1, 1, ...]`` copies on the slots' devices, the same copy in
        each sp slot of a ``(p, w)`` unless ``seq_dim`` names the dim
        the sp slots split into ``S`` contiguous chunks (a token
        batch's sequence); a 0-d tensor (a control operand) is copied
        to every slot's device; other leaves (host scalars) go to every
        slot as they are."""
        if isinstance(tree, PlacedTree):
            if tree.mesh is not self:
                raise ValueError("the tree is placed on another mesh")
            return tree
        if self.sp == 1:
            seq_dim = None
        return PlacedTree(self, _split(tree, self, seq_dim), seq_dim)

    def gather(self, placed: PlacedTree, device=None,
               party: Optional[int] = None):
        """The stacked ``[P, W, ...]`` tree of a placed one, on
        ``device`` (default: the first device; ``"meta"`` gives the
        shapes alone); the sp chunks of a split batch joined, else sp
        slot 0's copy; 0-d tensors and host scalars from slot ``(0,
        0)``.  ``party``: that party's row alone, ``[1, W, ...]``."""
        if not isinstance(placed, PlacedTree):
            raise TypeError(f"gather takes a PlacedTree, got "
                            f"{type(placed).__name__}")
        dev = self.first_device if device is None else torch.device(device)
        P, W = self.shape
        parties = range(P) if party is None else (party,)
        groups = [[placed.slots[self.index(p, w, s)] for s in range(self.sp)]
                  for p in parties for w in range(W)]
        return _join(groups, (len(parties), W), dev, placed.seq_dim)


def _split(tree, mesh: ReplicaMesh, seq_dim: Optional[int]) -> list:
    """``tree`` as one tree a slot (:meth:`ReplicaMesh.place`)."""
    n = mesh.size
    if isinstance(tree, torch.Tensor):
        if tree.dim() == 0:
            return [tree.to(dev, copy=True) for _, _, dev in mesh.slots()]
        if tuple(tree.shape[:2]) != mesh.shape:
            raise ValueError(
                f"a placed tensor carries the [P, W] = {list(mesh.shape)} "
                f"replica axes first, got {tuple(tree.shape)}")
        out = []
        for p, w, s, dev in mesh.slot_coords():
            block = tree[p:p + 1, w:w + 1]
            if seq_dim is not None:
                L = block.shape[seq_dim]
                if L % mesh.sp:
                    raise ValueError(f"sequence length {L} does not split "
                                     f"into {mesh.sp} sp chunks")
                block = block.narrow(seq_dim, s * (L // mesh.sp),
                                     L // mesh.sp)
            out.append(block.to(dev, copy=True))
        return out
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        parts = {f.name: _split(getattr(tree, f.name), mesh, seq_dim)
                 for f in dataclasses.fields(tree)}
        return [dataclasses.replace(tree, **{k: v[i]
                                             for k, v in parts.items()})
                for i in range(n)]
    if isinstance(tree, dict):
        parts = {k: _split(v, mesh, seq_dim) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    if isinstance(tree, (list, tuple)):
        parts = [_split(v, mesh, seq_dim) for v in tree]
        return [type(tree)(p[i] for p in parts) for i in range(n)]
    return [tree] * n


def _join(groups: list, shape: Tuple[int, int], device: torch.device,
          seq_dim: Optional[int]):
    """The stacked tree of per-slot trees (:meth:`ReplicaMesh.gather`):
    ``groups`` holds one list of sp-slot trees a ``(p, w)``."""
    first = groups[0][0]
    if isinstance(first, torch.Tensor):
        if first.dim() == 0:
            return first.to(device, copy=True)
        if seq_dim is None:
            parts = [g[0].to(device) for g in groups]
        else:
            parts = [torch.cat([t.to(device) for t in g], seq_dim)
                     for g in groups]
        full = torch.cat(parts)
        return full.view(shape + tuple(parts[0].shape[2:]))
    if dataclasses.is_dataclass(first) and not isinstance(first, type):
        return dataclasses.replace(first, **{
            f.name: _join([[getattr(t, f.name) for t in g] for g in groups],
                          shape, device, seq_dim)
            for f in dataclasses.fields(first)})
    if isinstance(first, dict):
        return {k: _join([[t[k] for t in g] for g in groups], shape, device,
                         seq_dim)
                for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_join([[t[i] for t in g] for g in groups], shape,
                                 device, seq_dim)
                           for i in range(len(first)))
    return first
