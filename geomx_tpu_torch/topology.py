"""The HiPS two-tier topology (port of geomx_tpu/topology.py).

The JAX package maps the two tiers onto a 2-D device mesh with named
axes.  The port keeps the axis names and the ``[num_parties,
workers_per_party]`` shape.  By default it holds every replica in one
process on one card: each state tensor carries the two replica axes as
its leading dimensions, and ``parallel/collectives.py`` reduces over
them.

``HiPSTopology.build_mesh`` gives the counterpart of the JAX mesh, a
:class:`ReplicaMesh`: a ``[P, W]`` grid of ``torch.device``s, one a
replica slot.  ``mesh.place`` splits a stacked ``[P, W, ...]`` tree into
per-slot ``[1, 1, ...]`` blocks on their devices (the JAX package's
``replica_sharding``/``batch_sharding``), ``mesh.gather`` stacks them
back onto one device (``jax.device_get``).  The step then runs one
program a slot (``parallel/collectives.py`` ``run_on_mesh``), as
``shard_map`` runs one a device.
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
        """The ``[P, W]`` device mesh: slot ``(p, w)`` on
        ``devices[p * W + w]``.  ``devices`` defaults to ``cuda:0 ..
        cuda:n-1``; there is no fallback to the CPU.  A list may name one
        device more than once (``["cpu"] * 8``: torch has one CPU
        device).  ``timeout_s``: how long a slot waits for the others at
        a collective before the step raises (:class:`ReplicaMesh`)."""
        if self.sp_degree > 1:
            from geomx_tpu_torch.config import unported
            raise unported("a device mesh with sp_degree > 1",
                           "Device mesh: the other paths")
        if devices is None:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        need = self.num_parties * self.workers_per_party
        if len(devices) < need:
            raise ValueError(f"topology needs {need} devices, only "
                             f"{len(devices)} available")
        devs = [torch.device(d) for d in list(devices)[:need]]
        grid = [devs[p * self.workers_per_party:
                     (p + 1) * self.workers_per_party]
                for p in range(self.num_parties)]
        if timeout_s is None:
            return ReplicaMesh(grid)
        return ReplicaMesh(grid, timeout_s=timeout_s)


@dataclasses.dataclass
class PlacedTree:
    """A tree split over a mesh: ``slots[p * W + w]`` is slot ``(p,
    w)``'s copy, its tensors ``[1, 1, ...]`` blocks on the slot's
    device."""

    mesh: "ReplicaMesh"
    slots: list

    def slot(self, p: int, w: int):
        return self.slots[p * self.mesh.shape[1] + w]


class ReplicaMesh:
    """A ``[P, W]`` grid of devices with the axis names ``("dc",
    "worker")``, one replica slot a grid entry (several slots may share
    a device).  ``timeout_s`` bounds a slot's wait for the others at a
    collective: a slot that never arrives fails the step instead of
    hanging it."""

    axis_names = REPLICA_AXES

    def __init__(self, devices, timeout_s: float = 300.0):
        self.devices = tuple(tuple(torch.device(d) for d in row)
                             for row in devices)
        if not self.devices or not self.devices[0] or \
                len({len(row) for row in self.devices}) != 1:
            raise ValueError("a mesh is a non-empty [P, W] grid of devices")
        self.shape = (len(self.devices), len(self.devices[0]))
        self.timeout_s = float(timeout_s)

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def first_device(self) -> torch.device:
        """Slot ``(0, 0)``'s device: where the collectives compute and
        where evaluation runs."""
        return self.devices[0][0]

    def slots(self) -> Iterator[Tuple[int, int, torch.device]]:
        """``(p, w, device)`` of every slot, in ``(p, w)`` order."""
        for p, row in enumerate(self.devices):
            for w, dev in enumerate(row):
                yield p, w, dev

    def distinct_devices(self) -> list:
        """The mesh's devices, each once, in slot order."""
        return list(dict.fromkeys(d for _, _, d in self.slots()))

    def place(self, tree) -> PlacedTree:
        """Every ``[P, W, ...]`` tensor of ``tree`` (dicts, lists,
        tuples, dataclasses such as ``TrainState``) split into per-slot
        ``[1, 1, ...]`` copies on the slots' devices; other leaves
        (host scalars) go to every slot as they are."""
        if isinstance(tree, PlacedTree):
            if tree.mesh is not self:
                raise ValueError("the tree is placed on another mesh")
            return tree
        return PlacedTree(self, _split(tree, self))

    def gather(self, placed: PlacedTree, device=None):
        """The stacked ``[P, W, ...]`` tree of a placed one, on
        ``device`` (default: the first device); host scalars from slot
        ``(0, 0)``."""
        if not isinstance(placed, PlacedTree):
            raise TypeError(f"gather takes a PlacedTree, got "
                            f"{type(placed).__name__}")
        dev = self.first_device if device is None else torch.device(device)
        return _join(placed.slots, self.shape, dev)


def _split(tree, mesh: ReplicaMesh) -> list:
    """``tree`` as one tree a slot (:meth:`ReplicaMesh.place`)."""
    n = mesh.size
    if isinstance(tree, torch.Tensor):
        if tuple(tree.shape[:2]) != mesh.shape:
            raise ValueError(
                f"a placed tensor carries the [P, W] = {list(mesh.shape)} "
                f"replica axes first, got {tuple(tree.shape)}")
        return [tree[p:p + 1, w:w + 1].to(dev, copy=True)
                for p, w, dev in mesh.slots()]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        parts = {f.name: _split(getattr(tree, f.name), mesh)
                 for f in dataclasses.fields(tree)}
        return [dataclasses.replace(tree, **{k: v[i]
                                             for k, v in parts.items()})
                for i in range(n)]
    if isinstance(tree, dict):
        parts = {k: _split(v, mesh) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    if isinstance(tree, (list, tuple)):
        parts = [_split(v, mesh) for v in tree]
        return [type(tree)(p[i] for p in parts) for i in range(n)]
    return [tree] * n


def _join(trees: list, shape: Tuple[int, int], device: torch.device):
    """The stacked tree of per-slot trees (:meth:`ReplicaMesh.gather`)."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        full = torch.cat([t.to(device) for t in trees])
        return full.view(shape + tuple(first.shape[2:]))
    if dataclasses.is_dataclass(first) and not isinstance(first, type):
        return dataclasses.replace(first, **{
            f.name: _join([getattr(t, f.name) for t in trees], shape, device)
            for f in dataclasses.fields(first)})
    if isinstance(first, dict):
        return {k: _join([t[k] for t in trees], shape, device)
                for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_join([t[i] for t in trees], shape, device)
                           for i in range(len(first)))
    return first
