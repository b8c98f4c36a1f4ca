"""Key-range sharded global tier: the scheduler-owned shard map (port of
geomx_tpu/service/shardmap.py).

The reference scales its global tier with MultiGPS — N global servers,
each owning a slice of the key space (PAPER.md §"MultiGPS").  The JAX
package re-expresses that as a *scheduler-owned, versioned key-range map*:

- every key hashes into a fixed 32-bit placement space
  (:func:`key_hash` — the same crc32 the MultiGPS host placement uses);
- a :class:`ShardMap` assigns **contiguous hash ranges** to N
  ``GeoPSServer`` shard instances, so rebalancing is a boundary move,
  not a re-hash of the world;
- the map carries a **version** (the roster-epoch idiom): every
  rebalance or failover bumps it, so a client holding a stale map is
  *detectably* stale — a shard answers an out-of-range request with a
  ``wrong_shard`` redirect carrying its map version instead of merging
  into the wrong store;
- maps serialize to wire-primitive dicts (:meth:`ShardMap.to_meta` /
  :meth:`ShardMap.from_meta`) so they travel inside COMMAND replies and
  the scheduler's durable journal unchanged.

:func:`rebalance_bounds` computes new boundaries from *observed*
per-key load (the shards' windowed push counters): static assignment
cannot follow a skewed workload — "Evaluation and Optimization of
Gradient Compression" (PAPERS.md) makes the same argument for
observation-driven placement.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, Iterable, List, Sequence, Tuple

KEYSPACE = 1 << 32   # the placement space: crc32 output


def key_hash(key: str) -> int:
    """Placement hash of a key — crc32, stable across processes and
    runs (NOT Python's salted ``hash``)."""
    return zlib.crc32(str(key).encode("utf-8")) & 0xFFFFFFFF


def even_bounds(num_shards: int) -> Tuple[int, ...]:
    """Equal-width contiguous ranges covering the whole key space:
    ``bounds[i] <= key_hash(k) < bounds[i+1]`` places k on shard i."""
    if num_shards < 1:
        raise ValueError(f"need at least one shard (got {num_shards})")
    step = KEYSPACE // num_shards
    return tuple(i * step for i in range(num_shards)) + (KEYSPACE,)


def _check_bounds(bounds: Sequence[int]) -> Tuple[int, ...]:
    b = tuple(int(x) for x in bounds)
    if len(b) < 2 or b[0] != 0 or b[-1] != KEYSPACE:
        raise ValueError(
            f"shard bounds must run 0..{KEYSPACE} (got {b[:3]}..{b[-1:]})")
    if any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
        raise ValueError(f"shard bounds must be strictly increasing: {b}")
    return b


@dataclasses.dataclass(frozen=True)
class ShardMap:
    """A versioned assignment of contiguous key-hash ranges to shard
    addresses.  ``shards[i]`` serves ``bounds[i] <= key_hash < bounds[i+1]``.
    Immutable: every mutation returns a NEW map with ``version + 1`` —
    a map bump is how clients detect rebalances and failovers."""

    version: int
    bounds: Tuple[int, ...]            # len(shards) + 1, covers KEYSPACE
    shards: Tuple[Tuple[str, int], ...]  # (host, port) per shard index

    def __post_init__(self):
        object.__setattr__(self, "bounds", _check_bounds(self.bounds))
        object.__setattr__(self, "shards",
                           tuple((str(h), int(p)) for h, p in self.shards))
        if len(self.bounds) != len(self.shards) + 1:
            raise ValueError(
                f"{len(self.shards)} shards need {len(self.shards) + 1} "
                f"bounds (got {len(self.bounds)})")

    @property
    def num_shards(self) -> int:
        return len(self.shards)

    def range_of(self, index: int) -> Tuple[int, int]:
        return (self.bounds[index], self.bounds[index + 1])

    def shard_for(self, key: str) -> int:
        """Owning shard index of ``key`` (binary search on the bounds)."""
        import bisect
        h = key_hash(key)
        return bisect.bisect_right(self.bounds, h) - 1

    def addr_of(self, index: int) -> Tuple[str, int]:
        return self.shards[index]

    def owner(self, key: str) -> Tuple[int, Tuple[str, int]]:
        i = self.shard_for(key)
        return i, self.shards[i]

    # ---- versioned mutations (each returns a NEW map) ----------------------

    def with_address(self, index: int, host: str, port: int) -> "ShardMap":
        """Failover: shard ``index`` is now served at a new address (a
        replacement that replayed the dead shard's journal).  Ranges are
        unchanged; the version bump is what redirects clients."""
        shards = list(self.shards)
        shards[index] = (str(host), int(port))
        return ShardMap(self.version + 1, self.bounds, tuple(shards))

    def with_bounds(self, bounds: Sequence[int]) -> "ShardMap":
        """Rebalance: new range boundaries, same shard addresses."""
        return ShardMap(self.version + 1, tuple(bounds), self.shards)

    # ---- wire / journal form ----------------------------------------------

    def to_meta(self) -> dict:
        return {"version": int(self.version),
                "bounds": [int(b) for b in self.bounds],
                "shards": [[h, int(p)] for h, p in self.shards]}

    @classmethod
    def from_meta(cls, meta: dict) -> "ShardMap":
        return cls(int(meta["version"]),
                   tuple(meta["bounds"]),
                   tuple((h, int(p)) for h, p in meta["shards"]))

    @classmethod
    def initial(cls, addrs: Iterable[Tuple[str, int]]) -> "ShardMap":
        """Version-1 map with even bounds over the given shard
        addresses (index order = range order)."""
        shards = tuple((str(h), int(p)) for h, p in addrs)
        return cls(1, even_bounds(len(shards)), shards)


def moved_segments(old: ShardMap, new: ShardMap
                   ) -> List[Tuple[int, int, int, int]]:
    """The contiguous hash segments whose owner changes between two
    maps with the same shard list: ``(lo, hi, old_owner, new_owner)``
    per segment — the migration work list of a rebalance."""
    cuts = sorted(set(old.bounds) | set(new.bounds))
    import bisect
    out: List[Tuple[int, int, int, int]] = []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        o = bisect.bisect_right(old.bounds, lo) - 1
        n = bisect.bisect_right(new.bounds, lo) - 1
        if o != n:
            if out and out[-1][1] == lo and out[-1][2:] == (o, n):
                out[-1] = (out[-1][0], hi, o, n)  # coalesce adjacents
            else:
                out.append((lo, hi, o, n))
    return out


def rebalance_bounds(current: ShardMap,
                     key_loads: Dict[str, float],
                     min_gain: float = 0.10) -> Tuple[int, ...]:
    """New boundaries equalizing *observed* load.

    ``key_loads`` maps key -> windowed load (push counts since the last
    rebalance, as the shards report them).  The keys are placed on the
    hash line, cumulative load is split into ``num_shards`` equal
    parts, and each boundary lands between two distinct key hashes so a
    key is never torn.  Returns the CURRENT bounds unchanged when the
    rebalance would not improve the max-shard share by at least
    ``min_gain`` (relative) — boundary churn has a migration cost, so a
    near-balanced tier stays put.
    """
    S = current.num_shards
    if S < 2 or not key_loads:
        return current.bounds
    pts = sorted((key_hash(k), float(c)) for k, c in key_loads.items()
                 if c > 0)
    if len(pts) < S:
        return current.bounds   # fewer hot keys than shards: nothing to cut
    total = sum(c for _h, c in pts)
    if total <= 0:
        return current.bounds
    import bisect
    cur_hashes = [h for h, _ in pts]

    def shard_shares(bounds: Sequence[int]) -> List[float]:
        shares = [0.0] * S
        for h, c in pts:
            shares[bisect.bisect_right(list(bounds), h) - 1] += c
        return shares

    # walk the sorted keys, cutting after the key that first reaches
    # each i/S cumulative share; the boundary is the midpoint between
    # that key's hash and the next key's, so both stay whole
    target = total / S
    new_bounds: List[int] = [0]
    acc = 0.0
    cut = 1
    for i, (h, c) in enumerate(pts):
        acc += c
        if cut < S and acc >= cut * target:
            nxt = cur_hashes[i + 1] if i + 1 < len(pts) else KEYSPACE - 1
            b = (h + nxt) // 2 + 1 if nxt > h else h + 1
            b = max(new_bounds[-1] + 1, min(b, KEYSPACE - (S - cut)))
            new_bounds.append(int(b))
            cut += 1
    while len(new_bounds) < S:
        new_bounds.append(new_bounds[-1] + 1)
    new_bounds.append(KEYSPACE)
    old_max = max(shard_shares(current.bounds))
    new_max = max(shard_shares(new_bounds))
    if new_max > old_max * (1.0 - float(min_gain)):
        return current.bounds   # not enough improvement to pay migration
    return tuple(new_bounds)
