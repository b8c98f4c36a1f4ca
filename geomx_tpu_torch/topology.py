"""The HiPS two-tier topology (port of geomx_tpu/topology.py).

The JAX package maps the two tiers onto a 2-D device mesh with named
axes.  The port keeps the axis names and the ``[num_parties,
workers_per_party]`` shape, but holds every replica in one process on
one card: each state tensor carries the two replica axes as its leading
dimensions, and ``parallel/collectives.py`` reduces over them.  There is
no mesh object.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# Axis names for the two HiPS tiers (the leading dims of every state
# tensor, in this order).
DC_AXIS = "dc"          # cross-party / global tier: dim 0
WORKER_AXIS = "worker"  # intra-party / local tier: dim 1
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
