"""Deterministic fault injection: seeded chaos schedules (port of
geomx_tpu/resilience/chaos.py, which imports no jax).

The reference injects faults with one global knob — ``PS_DROP_MSG``
drops N% of received data messages (van.cc:510-512), which our host
plane mirrors in ``service/protocol.should_drop``.  That is a *rate*,
not a *scenario*: it cannot express "party 1 goes dark at step 3 for 4
steps, then a 30% loss epoch at step 10", and an unseeded rate is not
reproducible.  This module turns failures into data:

- :class:`ChaosSchedule` — a seeded, sorted list of
  :class:`ChaosEvent`\\ s, built from a compact spec string
  (``GEOMX_CHAOS_SCHEDULE``), from code, or sampled reproducibly with
  :meth:`ChaosSchedule.random`;
- :class:`ChaosEngine` — replays the schedule in-process against a
  :class:`~geomx_tpu_torch.resilience.liveness.PartyLivenessController`
  (party blackouts / link flaps -> membership epochs) and against the
  existing ``should_drop`` hook (drop-rate epochs override
  ``GEOMX_DROP_MSG`` for a window of steps).

Spec format (semicolon-separated events):

    seed=<n>                       optional, reseeds the shared drop RNG
    blackout@<step>:party=<p>[,steps=<n>]   party dies (auto-readmit
                                            after n steps when given)
    flap@<step>:party=<p>[,steps=<n>]       short blackout, default 1 step
    readmit@<step>:party=<p>                explicit re-admission
    drop@<step>:rate=<pct>[,steps=<n>]      message-drop epoch (host
                                            transports; cleared after n)
    throttle@<step>:party=<p>,factor=<f>[,steps=<n>]
                                            link-quality shaping: party
                                            p's WAN uplink throughput is
                                            multiplied by f (0 < f <= 1;
                                            0.125 = 8x slower), cleared
                                            after n steps when given
    delay@<step>:party=<p>,ms=<m>[,steps=<n>]
                                            link-quality shaping: m ms
                                            of added latency per WAN
                                            round on party p's link
    kill@<step>:node=server|scheduler|shard<i>[,restart_after=<n>]
                                            host-plane process death:
                                            drives the installed node
                                            lifecycle hook; with
                                            restart_after, the paired
                                            restart@ fires n steps
                                            later.  ``shard<i>``
                                            targets ONE shard of the
                                            key-range sharded global
                                            tier — the rest of the
                                            tier keeps merging
    restart@<step>:node=server|scheduler|shard<i>    explicit restart
    corrupt@<step>:party=<p>,rate=<r>[,steps=<n>]
                                            bit-corruption epoch: r% of
                                            party p's retry-protected
                                            data frames have one bit
                                            flipped at send time (the
                                            wire-CRC gate detects, the
                                            retry path re-delivers);
                                            party=-1 matches every
                                            sender

Example: ``"seed=7;blackout@3:party=1,steps=4;drop@10:rate=30,steps=5"``.

``throttle``/``delay`` ride the same in-process transport hook pattern
``drop`` uses (``protocol.set_link_shaping_override`` next to
``set_drop_rate_override``): the server's relay hop sleeps the shaped
extra time inside its ``RelayToGlobal`` span, so WAN *degradation* —
not just blackout/loss — is deterministically replayable.

Determinism contract: the same spec (or the same ``random`` arguments)
produces the same event sequence, and the engine reseeds the protocol
drop RNG from the schedule seed, so a chaos run is replayable bit for
bit — the property every resilience test and ``chip_smoke.py``'s
resilience paths stand on.  The event lists are the JAX package's for
the same spec or the same ``random`` arguments (both draw from Python's
``random.Random``).
"""

from __future__ import annotations

import dataclasses
import random as _random
import re
from typing import Iterable, List, Optional, Tuple

# event kinds after duration expansion (a blackout/flap/drop/throttle/
# delay WITH a ``steps=`` window expands into its paired restore event
# at build time, so the engine itself is a stateless replayer)
_KINDS = ("blackout", "readmit", "drop_rate", "drop_clear",
          "throttle", "throttle_clear", "delay", "delay_clear",
          "kill", "restart", "corrupt", "corrupt_clear")

# kill/restart targets: the host plane's central singletons, plus
# "shard<i>" for one shard of the key-range sharded global tier
_NODES = ("server", "scheduler")

_SHARD_NODE = re.compile(r"^shard(\d+)$")


def _valid_node(node: str) -> bool:
    return node in _NODES or bool(_SHARD_NODE.match(node))


def shard_node_index(node: str) -> "Optional[int]":
    """``"shard3" -> 3``; None for the non-shard targets."""
    m = _SHARD_NODE.match(node)
    return int(m.group(1)) if m else None

# host-plane lifecycle hook (``kill@``/``restart@``): the in-process
# counterpart of protocol.set_drop_rate_override — whoever owns the
# processes (the recovery bench, a test harness, a supervisor) installs
# a callable ``hook(action, node)`` with action in ("kill", "restart")
# and node in _NODES, and the engine drives it on schedule.
_lifecycle_hook = None


def set_node_lifecycle_hook(hook) -> None:
    """Install (or clear, with None) the process-lifecycle hook the
    ``kill@``/``restart@`` chaos verbs drive."""
    global _lifecycle_hook
    _lifecycle_hook = hook


@dataclasses.dataclass(frozen=True, order=True)
class ChaosEvent:
    step: int
    kind: str          # one of _KINDS
    party: int = -1    # blackout/readmit/throttle/delay/corrupt
    rate: int = 0      # drop_rate / corrupt, percent 0-100
    factor: float = 0.0  # throttle: throughput multiplier (0 < f <= 1)
    ms: int = 0        # delay: added latency per WAN round
    node: str = ""     # kill/restart: "server" | "scheduler"

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown chaos event kind {self.kind!r}; "
                             f"valid: {_KINDS}")
        if self.step < 0:
            raise ValueError(f"chaos event step must be >= 0 ({self.step})")
        if self.kind in ("kill", "restart") and not _valid_node(self.node):
            raise ValueError(
                f"chaos {self.kind} targets node= one of {_NODES} or "
                f"shard<i> (got {self.node!r})")


class ChaosSchedule:
    """An immutable, step-sorted sequence of chaos events plus the seed
    that makes drop-rate epochs reproducible."""

    def __init__(self, events: Iterable[ChaosEvent], seed: int = 0):
        self.events: Tuple[ChaosEvent, ...] = tuple(sorted(events))
        self.seed = int(seed)

    def events_at(self, step: int) -> List[ChaosEvent]:
        return [e for e in self.events if e.step == step]

    @property
    def last_step(self) -> int:
        return max((e.step for e in self.events), default=-1)

    def spec(self) -> str:
        """Canonical spec string (round-trips through ``from_spec``) —
        what the bench record and test failures print."""
        parts = [f"seed={self.seed}"]
        for e in self.events:
            if e.kind in ("blackout", "readmit"):
                parts.append(f"{e.kind}@{e.step}:party={e.party}")
            elif e.kind == "drop_rate":
                parts.append(f"drop@{e.step}:rate={e.rate}")
            elif e.kind == "drop_clear":
                parts.append(f"dropclear@{e.step}")
            elif e.kind == "throttle":
                parts.append(
                    f"throttle@{e.step}:party={e.party},factor={e.factor:g}")
            elif e.kind == "throttle_clear":
                parts.append(f"throttleclear@{e.step}:party={e.party}")
            elif e.kind == "delay":
                parts.append(f"delay@{e.step}:party={e.party},ms={e.ms}")
            elif e.kind == "delay_clear":
                parts.append(f"delayclear@{e.step}:party={e.party}")
            elif e.kind in ("kill", "restart"):
                parts.append(f"{e.kind}@{e.step}:node={e.node}")
            elif e.kind == "corrupt":
                parts.append(
                    f"corrupt@{e.step}:party={e.party},rate={e.rate}")
            else:  # corrupt_clear
                parts.append(f"corruptclear@{e.step}:party={e.party}")
        return ";".join(parts)

    # ---- constructors ------------------------------------------------------

    @classmethod
    def from_config(cls, cfg) -> "Optional[ChaosSchedule]":
        """The ``GEOMX_CHAOS_SCHEDULE`` consumption point: parse the
        config's schedule spec, or None when no chaos is configured."""
        spec = getattr(cfg, "chaos_schedule", "") or ""
        return cls.from_spec(spec) if spec.strip() else None

    @classmethod
    def from_spec(cls, spec: str) -> "ChaosSchedule":
        """Parse the ``GEOMX_CHAOS_SCHEDULE`` format (module docstring)."""
        events: List[ChaosEvent] = []
        seed = 0
        for raw in filter(None, (s.strip() for s in spec.split(";"))):
            if raw.startswith("seed="):
                seed = int(raw.split("=", 1)[1])
                continue
            if "@" not in raw:
                raise ValueError(f"bad chaos event {raw!r}: expected "
                                 "kind@step[:key=val,...]")
            head, _, tail = raw.partition(":")
            kind, step_s = head.split("@", 1)
            step = int(step_s)
            kv = {}
            for item in filter(None, (t.strip() for t in tail.split(","))):
                k, _, v = item.partition("=")
                if not _:
                    raise ValueError(f"bad chaos option {item!r} in {raw!r}")
                # every option is an integer except the throttle factor
                # (a throughput multiplier in (0, 1]) and the kill/
                # restart target node (a role name)
                if k == "node":
                    kv[k] = v
                else:
                    kv[k] = float(v) if k == "factor" else int(v)
            known = {"blackout": {"party", "steps"},
                     "flap": {"party", "steps"},
                     "readmit": {"party"},
                     "drop": {"rate", "steps"},
                     "dropclear": set(),
                     "throttle": {"party", "factor", "steps"},
                     "throttleclear": {"party"},
                     "delay": {"party", "ms", "steps"},
                     "delayclear": {"party"},
                     "kill": {"node", "restart_after"},
                     "restart": {"node"},
                     "corrupt": {"party", "rate", "steps"},
                     "corruptclear": {"party"}}
            if kind not in known:
                raise ValueError(f"unknown chaos kind {kind!r}; valid: "
                                 f"{sorted(known)}")
            if set(kv) - known[kind]:
                raise ValueError(f"chaos {kind!r} does not take "
                                 f"{sorted(set(kv) - known[kind])}")
            if kind in ("blackout", "flap"):
                party = kv["party"]
                events.append(ChaosEvent(step, "blackout", party=party))
                # a flap is a short blackout; both auto-readmit when a
                # window is given (flap defaults to one step)
                steps = kv.get("steps", 1 if kind == "flap" else 0)
                if steps:
                    events.append(ChaosEvent(step + steps, "readmit",
                                             party=party))
            elif kind == "readmit":
                events.append(ChaosEvent(step, "readmit", party=kv["party"]))
            elif kind == "drop":
                rate = kv["rate"]
                if not 0 <= rate <= 100:
                    raise ValueError(f"drop rate {rate} not in [0, 100]")
                events.append(ChaosEvent(step, "drop_rate", rate=rate))
                if kv.get("steps"):
                    events.append(ChaosEvent(step + kv["steps"],
                                             "drop_clear"))
            elif kind == "throttle":
                factor = kv["factor"]
                if not 0.0 < factor <= 1.0:
                    raise ValueError(
                        f"throttle factor {factor} not in (0, 1]")
                events.append(ChaosEvent(step, "throttle",
                                         party=kv["party"], factor=factor))
                if kv.get("steps"):
                    events.append(ChaosEvent(int(step + kv["steps"]),
                                             "throttle_clear",
                                             party=kv["party"]))
            elif kind == "throttleclear":
                events.append(ChaosEvent(step, "throttle_clear",
                                         party=kv["party"]))
            elif kind == "delay":
                ms = kv["ms"]
                if ms < 0:
                    raise ValueError(f"delay ms {ms} must be >= 0")
                events.append(ChaosEvent(step, "delay",
                                         party=kv["party"], ms=ms))
                if kv.get("steps"):
                    events.append(ChaosEvent(int(step + kv["steps"]),
                                             "delay_clear",
                                             party=kv["party"]))
            elif kind == "delayclear":
                events.append(ChaosEvent(step, "delay_clear",
                                         party=kv["party"]))
            elif kind in ("kill", "restart"):
                events.append(ChaosEvent(step, kind,
                                         node=str(kv["node"])))
                # kill@S:node=X,restart_after=N expands into its paired
                # restart, like every other duration-bearing verb
                if kind == "kill" and kv.get("restart_after"):
                    events.append(ChaosEvent(
                        int(step + kv["restart_after"]), "restart",
                        node=str(kv["node"])))
            elif kind == "corrupt":
                rate = kv["rate"]
                if not 0 <= rate <= 100:
                    raise ValueError(
                        f"corrupt rate {rate} not in [0, 100]")
                events.append(ChaosEvent(step, "corrupt",
                                         party=kv.get("party", -1),
                                         rate=rate))
                if kv.get("steps"):
                    events.append(ChaosEvent(int(step + kv["steps"]),
                                             "corrupt_clear",
                                             party=kv.get("party", -1)))
            elif kind == "corruptclear":
                events.append(ChaosEvent(step, "corrupt_clear",
                                         party=kv.get("party", -1)))
            else:  # dropclear
                events.append(ChaosEvent(step, "drop_clear"))
        return cls(events, seed=seed)

    @classmethod
    def random(cls, seed: int, steps: int, num_parties: int,
               blackouts: int = 1, blackout_len: Tuple[int, int] = (2, 5),
               drop_epochs: int = 0,
               drop_rate: Tuple[int, int] = (10, 50),
               keep_party: int = 0,
               node_kills: int = 0,
               nodes: Tuple[str, ...] = ("server",),
               kill_restart_after: Tuple[int, int] = (1, 3),
               corrupt_epochs: int = 0,
               corrupt_rate: Tuple[int, int] = (20, 40),
               throttle_epochs: int = 0,
               throttle_factor: Tuple[float, float] = (0.1, 0.5)
               ) -> "ChaosSchedule":
        """Sample a reproducible schedule: ``blackouts`` party outages
        (never ``keep_party`` — someone must survive) and ``drop_epochs``
        loss windows, all from ``random.Random(seed)`` so the same
        arguments always produce the same scenario.

        Multi-node scenarios (the 16+ party chaos fleet): ``node_kills``
        kill+restart pairs sampled over ``nodes`` (e.g.
        ``("shard0", "shard1", "scheduler")`` — each kill picks a node,
        a start step, and a restart ``kill_restart_after`` steps later;
        at most one outstanding kill per node at a time, and a pair
        whose restart would land past the run is dropped
        (``node_kills`` is an upper bound), so a schedule never
        restarts a node that is not down and never leaves one
        permanently dead.  ``corrupt_epochs`` /
        ``throttle_epochs`` sample seeded bit-flip and link-shaping
        windows over non-kept parties."""
        if num_parties < 2 and blackouts:
            raise ValueError("party blackouts need num_parties >= 2")
        for n in nodes:
            if not _valid_node(n):
                raise ValueError(
                    f"random: node {n!r} is not one of {_NODES} or "
                    "shard<i>")
        rng = _random.Random(seed)
        events: List[ChaosEvent] = []
        candidates = [p for p in range(num_parties) if p != keep_party]
        for _ in range(blackouts):
            party = rng.choice(candidates)
            length = rng.randint(*blackout_len)
            start = rng.randint(1, max(1, steps - length - 1))
            events.append(ChaosEvent(start, "blackout", party=party))
            events.append(ChaosEvent(start + length, "readmit", party=party))
        for _ in range(drop_epochs):
            start = rng.randint(1, max(1, steps - 2))
            length = rng.randint(1, max(1, steps - start - 1))
            events.append(ChaosEvent(start, "drop_rate",
                                     rate=rng.randint(*drop_rate)))
            events.append(ChaosEvent(start + length, "drop_clear"))
        down_until: dict = {}   # node -> step its restart fires
        for _ in range(node_kills):
            node = rng.choice(list(nodes))
            gap = rng.randint(*kill_restart_after)
            start = rng.randint(1, max(1, steps - gap - 1))
            if start <= down_until.get(node, 0):
                # this node is still down at the sampled step: push the
                # kill past its pending restart (never a double-kill)
                start = down_until[node] + 1
            if start + gap >= steps:
                # the pair no longer fits the run: a kill whose restart
                # cannot fire would leave the node permanently dead and
                # make the schedule unsatisfiable — drop it (node_kills
                # is an upper bound)
                continue
            events.append(ChaosEvent(start, "kill", node=node))
            events.append(ChaosEvent(start + gap, "restart", node=node))
            down_until[node] = start + gap
        for _ in range(corrupt_epochs):
            start = rng.randint(1, max(1, steps - 2))
            length = rng.randint(1, max(1, steps - start - 1))
            party = rng.choice(candidates) if candidates else -1
            events.append(ChaosEvent(start, "corrupt", party=party,
                                     rate=rng.randint(*corrupt_rate)))
            events.append(ChaosEvent(start + length, "corrupt_clear",
                                     party=party))
        for _ in range(throttle_epochs):
            start = rng.randint(1, max(1, steps - 2))
            length = rng.randint(1, max(1, steps - start - 1))
            party = rng.choice(candidates) if candidates else -1
            factor = round(rng.uniform(*throttle_factor), 3)
            events.append(ChaosEvent(start, "throttle", party=party,
                                     factor=factor))
            events.append(ChaosEvent(start + length, "throttle_clear",
                                     party=party))
        return cls(events, seed=seed)


class ChaosEngine:
    """Replays a schedule against the liveness controller and the
    ``should_drop`` hook.  Call :meth:`tick` once per training step
    (before running the step); it returns the events applied so the
    caller can react (rebind membership, log, assert)."""

    def __init__(self, schedule: ChaosSchedule,
                 controller: Optional[object] = None,
                 drive_drop_hook: bool = True):
        self.schedule = schedule
        self.controller = controller
        self.drive_drop_hook = drive_drop_hook
        self._applied_through = -1
        if drive_drop_hook:
            # reproducibility: the message-loss AND bit-corruption
            # patterns inside their epochs derive from the schedule
            # seed, not process history
            from geomx_tpu_torch.service.protocol import (reseed_corrupt_rng,
                                                    reseed_drop_rng)
            reseed_drop_rng(schedule.seed)
            reseed_corrupt_rng(schedule.seed)

    def tick(self, step: int) -> List[ChaosEvent]:
        """Apply every event scheduled in ``(last_tick, step]`` (skipped
        steps still fire — a caller that advances by epochs must not
        silently lose a mid-epoch blackout)."""
        if step <= self._applied_through:
            return []
        fired = [e for e in self.schedule.events
                 if self._applied_through < e.step <= step]
        self._applied_through = step
        for e in fired:
            self._apply(e)
        return fired

    def _apply(self, e: ChaosEvent) -> None:
        if e.kind in ("blackout", "readmit"):
            if self.controller is None:
                raise ValueError(
                    f"chaos event {e} needs a PartyLivenessController "
                    "(construct ChaosEngine(schedule, controller))")
            if e.kind == "blackout":
                self.controller.mark_dead(e.party)
            else:
                self.controller.mark_live(e.party)
        elif e.kind in ("kill", "restart"):
            # host-plane process lifecycle: driven through the installed
            # hook, never directly — the engine knows WHEN, the owner of
            # the processes knows HOW (crash semantics, durable dirs,
            # ports; chip_smoke.py's manyparty_sharded phase is one).
            if _lifecycle_hook is None:
                raise ValueError(
                    f"chaos event {e} needs a node lifecycle hook "
                    "(set_node_lifecycle_hook)")
            _lifecycle_hook(e.kind, e.node)
        elif not self.drive_drop_hook:
            return
        elif e.kind in ("drop_rate", "drop_clear"):
            from geomx_tpu_torch.service.protocol import set_drop_rate_override
            set_drop_rate_override(e.rate if e.kind == "drop_rate" else None)
        elif e.kind in ("corrupt", "corrupt_clear"):
            from geomx_tpu_torch.service.protocol import set_corruption_override
            set_corruption_override(
                e.party, e.rate if e.kind == "corrupt" else None)
        else:
            # link-quality shaping: same in-process hook pattern as the
            # drop override — the transports consult it, the engine
            # installs/clears it on schedule
            from geomx_tpu_torch.service.protocol import set_link_shaping_override
            if e.kind == "throttle":
                set_link_shaping_override(e.party, factor=e.factor)
            elif e.kind == "throttle_clear":
                set_link_shaping_override(e.party, factor=None)
            elif e.kind == "delay":
                set_link_shaping_override(e.party, delay_ms=e.ms)
            else:  # delay_clear
                set_link_shaping_override(e.party, delay_ms=None)

    def close(self) -> None:
        """Clear any installed drop/shaping override (idempotent) — pair
        with construction in tests so one chaos run cannot leak loss or
        link degradation into the next."""
        if self.drive_drop_hook:
            from geomx_tpu_torch.service.protocol import (
                clear_corruption_overrides, clear_link_shaping_overrides,
                set_drop_rate_override)
            set_drop_rate_override(None)
            clear_link_shaping_overrides()
            clear_corruption_overrides()

    def __enter__(self) -> "ChaosEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
