"""Deterministic control policies: the Graft Pilot's decision brain
(port of geomx_tpu/control/policy.py).

TSEngine (PAPER.md §6) chose its overlay once a round from measured
throughput; the Graft Pilot generalizes that into four hysteresis-
guarded feedback policies over the telemetry plane's sensors
(:mod:`~geomx_tpu_torch.control.sensors`):

- :class:`RatioPolicy` — compression-ratio retuning toward the
  throughput-matched operating point (the largest payload the measured
  bottleneck link moves inside one step of compute, with ``headroom``),
  by a bounded multiplicative step, never lowering while the
  error-feedback residual marks the gradient as accuracy-unsafe;
- :class:`DepthPolicy` — pipeline-depth switching, a Schmitt trigger on
  the WAN fraction (exposed + hidden comms) with a confirmation streak;
- :class:`RelayPolicy` — relay re-forming: the widest-path chain from
  the ``LinkObservatory`` snapshot, with a minimum-gain margin to form
  and a lower release threshold;
- :class:`SloPolicy` — serving-plane routing and shedding from a
  ``stats_fn`` (a gateway's ``serving_stats``) plus the link snapshot;
  the caller hands a ``("shed", fraction)`` decision to the gateway's
  ``set_shed_fraction``.

Everything here is a pure function of the observation stream plus
bounded internal counters: the same seeded scenario produces the same
decision sequence, which is what makes a replayed run's decision log
byte-identical to the live one.  No wall clock, no RNG.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Tuple

from geomx_tpu_torch.control.sensors import ControlObservation


@dataclasses.dataclass(frozen=True)
class Decision:
    """One actuation the pilot wants applied.

    ``kind``: ``"ratio"`` (value = absolute bsc ratio), ``"depth"``
    (value = 0 or 1), ``"relay"`` (value = party order, widest first)
    or ``"slo"`` (value = ``("shed", fraction)`` / ``("route",
    party)``).  ``prev`` is the value being replaced; ``reason`` is a
    deterministic human-readable justification (no timestamps)."""

    step: int
    kind: str
    value: Any
    prev: Any
    reason: str

    def to_json(self) -> dict:
        val = list(self.value) if isinstance(self.value, tuple) \
            else self.value
        prev = list(self.prev) if isinstance(self.prev, tuple) else self.prev
        return {"step": int(self.step), "kind": self.kind, "value": val,
                "prev": prev, "reason": self.reason}


class Cooldown:
    """Per-knob actuation rate limiter: after a decision fires, the
    knob stays untouchable for ``steps`` steps."""

    def __init__(self, steps: int):
        self.steps = max(0, int(steps))
        self._last: Optional[int] = None

    def ready(self, step: int) -> bool:
        return self._last is None or step - self._last >= self.steps

    def fire(self, step: int) -> None:
        self._last = step


def _bottleneck_bps(obs: ControlObservation, peer: str = "global"
                    ) -> Optional[float]:
    """The narrowest confident measured uplink toward ``peer`` — the
    link that gates a synchronous WAN round."""
    vals = [rec["throughput_bps"] for rec in obs.links.values()
            if rec["peer"] == peer and rec["throughput_bps"] is not None]
    return min(vals) if vals else None


class RatioPolicy:
    """Throughput-matched bsc-ratio retuning with an accuracy floor.

    ``base_ratio`` is the CAPACITY (the configured ratio whose k sizes
    the wire buffers); ``bounds = (lo, hi)`` the absolute operating
    range with ``hi <= base_ratio``.  Per decision the ratio moves at
    most ``step_limit``x and only when the target differs from the
    current ratio by more than ``deadband`` (relative) — the hysteresis
    pair that keeps a noisy bandwidth estimate from oscillating the
    knob.  ``ef_unsafe``: when the EF-residual norm exceeds this
    fraction of the gradient norm, lowering is vetoed (raises stay
    allowed) — telemetry's in-situ accuracy floor.

    The matched-point estimate itself is EWMA-smoothed
    (``target_alpha``) across observations — one noisy bandwidth sample
    moves the target a little, never the knob a lot — and the smoother
    keeps integrating through cooldown, so the policy re-emerges from a
    quiet period aimed at the settled target, not the last spike.
    """

    knob = "ratio"

    def __init__(self, base_ratio: float,
                 bounds: Optional[Tuple[float, float]] = None,
                 cooldown: int = 5, step_limit: float = 4.0,
                 deadband: float = 0.25, ef_unsafe: float = 1.0,
                 headroom: float = 1.0, target_alpha: float = 0.3,
                 wire_bytes_per_ratio: Optional[float] = None):
        if base_ratio <= 0:
            raise ValueError(f"base_ratio must be > 0 (got {base_ratio!r})")
        self.base_ratio = float(base_ratio)
        if bounds is None:
            bounds = (self.base_ratio / 8.0, self.base_ratio)
        lo, hi = float(bounds[0]), float(bounds[1])
        if not 0.0 < lo <= hi:
            raise ValueError(f"ratio bounds must satisfy 0 < lo <= hi "
                             f"(got {bounds!r})")
        if hi > self.base_ratio * (1 + 1e-9):
            raise ValueError(
                f"ratio bound hi={hi} exceeds the configured capacity "
                f"ratio {self.base_ratio}: the scale operand can only "
                "tune DOWN from the static wire size — raise the "
                "configured compression ratio instead")
        self.bounds = (lo, hi)
        self.cooldown = Cooldown(cooldown)
        self.step_limit = max(1.0 + 1e-6, float(step_limit))
        self.deadband = max(0.0, float(deadband))
        self.ef_unsafe = float(ef_unsafe)
        self.headroom = float(headroom)
        if not 0.0 < target_alpha <= 1.0:
            raise ValueError(
                f"target_alpha must be in (0, 1] (got {target_alpha!r})")
        self.target_alpha = float(target_alpha)
        self._target: Optional[float] = None  # EWMA-smoothed matched point
        # bytes one party puts on the WAN per unit of ratio (derived
        # from the dense payload when the sensor reports it)
        self.wire_bytes_per_ratio = wire_bytes_per_ratio
        self.current = min(self.base_ratio, hi)

    def _matched_ratio(self, obs: ControlObservation) -> Optional[float]:
        """The throughput-matched operating point: the ratio whose wire
        payload the measured bottleneck uplink moves in ``headroom``
        steps of compute.  None when a required sensor is missing."""
        bw = _bottleneck_bps(obs)
        if bw is None or not obs.compute_s:
            return None
        bpr = self.wire_bytes_per_ratio
        if bpr is None:
            if not obs.dc_dense_bytes:
                return None
            # bsc wire: 2 (value,index) fp32 pairs per selected element
            # = 2x the dense bytes at ratio 1.0
            bpr = 2.0 * obs.dc_dense_bytes
        if bpr <= 0:
            return None
        return bw * obs.compute_s * self.headroom / bpr

    def decide(self, obs: ControlObservation) -> Optional[Decision]:
        raw = self._matched_ratio(obs)
        if raw is not None:
            # smooth FIRST, gate later: the estimate integrates every
            # observation, including those inside the cooldown window
            a = self.target_alpha
            self._target = raw if self._target is None \
                else a * raw + (1 - a) * self._target
        if not self.cooldown.ready(obs.step):
            return None
        target = self._target
        if target is None:
            # sensor-poor fallback: steer on the exposed-comms fraction
            # alone (still deterministic, still hysteresis-guarded)
            if obs.exposed_comms is None:
                return None
            if obs.exposed_comms > 0.30:
                target = self.current / 2.0
            elif obs.exposed_comms < 0.05:
                target = self.current * 2.0
            else:
                return None
        lo, hi = self.bounds
        # accuracy floor: with EF mass rivaling the gradient, the
        # compressor is starving the update — never lower further
        ef_blocked = (obs.ef_residual_norm is not None
                      and obs.grad_norm is not None and obs.grad_norm > 0
                      and obs.ef_residual_norm
                      > self.ef_unsafe * obs.grad_norm)
        target = min(max(target, lo), hi)
        # bounded step toward the target
        new = min(max(target, self.current / self.step_limit),
                  self.current * self.step_limit)
        new = min(max(new, lo), hi)
        if ef_blocked and new < self.current:
            return None
        if abs(new - self.current) <= self.deadband * self.current:
            return None
        prev = self.current
        self.current = new
        self.cooldown.fire(obs.step)
        direction = "lower" if new < prev else "raise"
        return Decision(
            step=obs.step, kind="ratio", value=new, prev=prev,
            reason=f"{direction} toward throughput-matched ratio "
                   f"{target:.6g} (bounds [{lo:g}, {hi:g}])")


class DepthPolicy:
    """Schmitt-trigger pipeline-depth switching on the WAN fraction.

    The gate signal is ``exposed + hidden`` — the step-time fraction
    spent on the wire whether or not compute currently hides it.  Using
    raw exposure instead would self-oscillate: enabling depth-1 hides
    the comms, the measured exposure collapses to ~0, and a naive
    comparator immediately disables what just started working.  The
    WAN fraction is invariant under the actuation it controls (at
    depth 0 it IS the exposure; at depth 1 it is what the exposure
    would return to), so the trigger is a true Schmitt pair: ``enter``
    (fraction above which depth-1 pays) must exceed ``exit`` (below
    which compute dominates even unhidden), and a reading must persist
    ``confirm`` consecutive observations before the switch — one noisy
    attribution window cannot flip the pipeline."""

    knob = "depth"

    def __init__(self, enter: float = 0.25, exit: float = 0.10,
                 confirm: int = 2, cooldown: int = 5, initial: int = 0):
        if not 0.0 <= exit < enter <= 1.0:
            raise ValueError(
                f"need 0 <= exit < enter <= 1 (got exit={exit}, "
                f"enter={enter}) — equal thresholds are a comparator, "
                "not hysteresis")
        if initial not in (0, 1):
            raise ValueError(f"initial depth must be 0 or 1 "
                             f"(got {initial!r})")
        self.enter = float(enter)
        self.exit = float(exit)
        self.confirm = max(1, int(confirm))
        self.cooldown = Cooldown(cooldown)
        # seed from the system's ACTUAL configured depth (from_config
        # wires cfg.pipeline_depth) — a policy that assumes depth 0
        # while the trainer compiled depth 1 could never emit the exit
        # transition that pays off the staleness
        self.current = int(initial)
        self._streak = 0

    def decide(self, obs: ControlObservation) -> Optional[Decision]:
        if obs.exposed_comms is None:
            return None
        wan = obs.exposed_comms + (obs.hidden_comms or 0.0)
        want = self.current
        if self.current == 0 and wan > self.enter:
            want = 1
        elif self.current == 1 and wan < self.exit:
            want = 0
        if want == self.current:
            self._streak = 0
            return None
        self._streak += 1
        if self._streak < self.confirm or not self.cooldown.ready(obs.step):
            return None
        prev = self.current
        self.current = want
        self._streak = 0
        self.cooldown.fire(obs.step)
        why = (f"wan_fraction {wan:.3f} > enter {self.enter:.3f}"
               if want else
               f"wan_fraction {wan:.3f} < exit {self.exit:.3f}")
        return Decision(step=obs.step, kind="depth", value=want, prev=prev,
                        reason=f"pipeline depth {prev}->{want}: {why}")


class RelayPolicy:
    """Greedy widest-path relay re-forming with a minimum-gain margin.

    The candidate chain is the snapshot's parties ordered widest uplink
    first (the ONE ordering rule ``telemetry.links.relay_order`` also
    gives ``LinkObservatory.best_relay_order`` — policy and observatory
    can never drift); the order's head is the relay SINK the other
    parties merge through.  An empty order ``()`` means direct fan-in
    (no relay — the static default).  The thresholds are a Schmitt
    pair: the chain FORMS only when the widest measured uplink is at
    least ``min_gain``x the narrowest, and RELEASES back to direct
    fan-in only when the asymmetry falls below ``release``
    (< ``min_gain``; default three quarters of the way up the margin) —
    an estimate hovering at the form threshold holds the current
    overlay instead of thrashing it, while a degraded link that
    recovers still does not leave the overlay detouring forever."""

    knob = "relay"

    def __init__(self, min_gain: float = 1.5,
                 release: Optional[float] = None, cooldown: int = 5,
                 min_confidence: float = 0.5, peer: str = "global"):
        self.min_gain = max(1.0, float(min_gain))
        if release is None:
            release = 1.0 + 0.75 * (self.min_gain - 1.0)
        if not 1.0 <= release <= self.min_gain:
            raise ValueError(
                f"release must satisfy 1 <= release <= min_gain "
                f"(got release={release}, min_gain={self.min_gain}) — "
                "release == min_gain is a comparator, not hysteresis")
        self.release = float(release)
        self.cooldown = Cooldown(cooldown)
        self.min_confidence = float(min_confidence)
        self.peer = peer
        self.current: Tuple[str, ...] = ()

    def decide(self, obs: ControlObservation) -> Optional[Decision]:
        from geomx_tpu_torch.telemetry.links import relay_order
        if not self.cooldown.ready(obs.step):
            return None
        links = {rec["party"]: rec for rec in obs.links.values()
                 if rec["peer"] == self.peer
                 and rec["throughput_bps"] is not None
                 and rec["confidence"] >= self.min_confidence}
        if len(links) < 2:
            return None
        order = tuple(relay_order(links.values(), peer=self.peer))
        widest = links[order[0]]["throughput_bps"]
        narrowest = links[order[-1]]["throughput_bps"]
        asym = widest / narrowest if narrowest > 0 else math.inf
        prev = self.current
        if asym < self.min_gain:
            # below the form threshold: hold the current overlay inside
            # the [release, min_gain) band, release under it
            if not prev or asym >= self.release:
                return None
            self.current = ()
            self.cooldown.fire(obs.step)
            return Decision(
                step=obs.step, kind="relay", value=(), prev=prev,
                reason=f"release to direct fan-in (asymmetry "
                       f"{asym:.2f}x < release {self.release:g}x)")
        if order == prev:
            return None
        self.current = order
        self.cooldown.fire(obs.step)
        return Decision(
            step=obs.step, kind="relay", value=order, prev=prev,
            reason=f"widest-path chain via {order[0]} "
                   f"(uplinks {widest:.3g} vs narrowest {narrowest:.3g})")


class SloPolicy:
    """Serving-SLO routing + shedding: the fourth policy family
    (``SloPolicy(gateway.serving_stats)``; a shed decision reaches
    ``gateway.set_shed_fraction``).

    The observation is the gateway's serving stats (``stats_fn`` — a
    zero-arg callable returning ``{"p99_s", "queue_depth", ...}`` or
    None before traffic) plus the shared ``LinkObservatory`` snapshot
    already on the :class:`ControlObservation`.  Two deterministic
    sub-decisions, both ``kind="slo"``:

    - **shed** (``value=("shed", fraction)``): when the measured
      request p99 exceeds ``target_p99_s`` for ``confirm`` consecutive
      evaluations, the shed fraction rises by a bounded ``shed_step``;
      when p99 falls under the Schmitt exit (``release_p99_s`` <
      target) for ``confirm`` evaluations it steps back down.  Sheds
      are explicit 503s the gateway counts — load the SLO cannot carry
      is refused loudly, never queued into timeout loss;
    - **route** (``value=("route", party)``): the refresh source is
      re-pointed at the widest confident measured uplink from the link
      snapshot — the same one ordering rule the relay policy uses, so
      observatory and both overlay consumers can never disagree.

    Same determinism contract as the other three families: pure
    function of the observation stream + bounded counters; no wall
    clock, no RNG."""

    knob = "slo"

    def __init__(self, stats_fn, target_p99_s: float = 0.5,
                 release_p99_s: Optional[float] = None,
                 shed_step: float = 0.1, shed_max: float = 0.9,
                 confirm: int = 2, cooldown: int = 5,
                 min_confidence: float = 0.5, peer: str = "global"):
        if target_p99_s <= 0:
            raise ValueError(
                f"target_p99_s must be > 0 (got {target_p99_s!r})")
        if release_p99_s is None:
            release_p99_s = 0.5 * target_p99_s
        if not 0.0 < release_p99_s < target_p99_s:
            raise ValueError(
                f"need 0 < release < target (got release={release_p99_s}, "
                f"target={target_p99_s}) — equal thresholds are a "
                "comparator, not hysteresis")
        self.stats_fn = stats_fn
        self.target_p99_s = float(target_p99_s)
        self.release_p99_s = float(release_p99_s)
        self.shed_step = max(1e-6, float(shed_step))
        self.shed_max = min(1.0, max(0.0, float(shed_max)))
        self.confirm = max(1, int(confirm))
        self.cooldown = Cooldown(cooldown)
        self.min_confidence = float(min_confidence)
        self.peer = peer
        self.current = 0.0            # active shed fraction
        self.route: Optional[str] = None   # current refresh source
        self._over_streak = 0
        self._under_streak = 0

    def _route_decision(self, obs: ControlObservation
                        ) -> Optional[Decision]:
        links = {rec["party"]: rec for rec in obs.links.values()
                 if rec["peer"] == self.peer
                 and rec["throughput_bps"] is not None
                 and rec["confidence"] >= self.min_confidence}
        if not links:
            return None
        from geomx_tpu_torch.telemetry.links import relay_order
        order = tuple(relay_order(links.values(), peer=self.peer))
        widest = order[0]
        if widest == self.route:
            return None
        prev = self.route
        self.route = widest
        return Decision(
            step=obs.step, kind="slo", value=("route", widest),
            prev=("route", prev),
            reason=f"refresh source -> widest measured uplink {widest} "
                   f"({links[widest]['throughput_bps']:.3g} B/s)")

    def decide(self, obs: ControlObservation) -> Optional[Decision]:
        # routing re-points freely (no cooldown contention with shed:
        # it only fires when the widest uplink actually changes)
        route = self._route_decision(obs)
        if route is not None:
            return route
        stats = self.stats_fn() if self.stats_fn is not None else None
        p99 = None if not stats else stats.get("p99_s")
        if p99 is None:
            self._over_streak = self._under_streak = 0
            return None
        if p99 > self.target_p99_s:
            self._over_streak += 1
            self._under_streak = 0
        elif p99 < self.release_p99_s:
            self._under_streak += 1
            self._over_streak = 0
        else:
            # inside the hysteresis band: hold
            self._over_streak = self._under_streak = 0
            return None
        want = self.current
        if self._over_streak >= self.confirm \
                and self.current < self.shed_max:
            want = min(self.shed_max, self.current + self.shed_step)
        elif self._under_streak >= self.confirm and self.current > 0.0:
            want = max(0.0, self.current - self.shed_step)
        if want == self.current or not self.cooldown.ready(obs.step):
            return None
        prev = self.current
        self.current = want
        self._over_streak = self._under_streak = 0
        self.cooldown.fire(obs.step)
        direction = "raise" if want > prev else "lower"
        bound = self.target_p99_s if want > prev else self.release_p99_s
        cmp = ">" if want > prev else "<"
        return Decision(
            step=obs.step, kind="slo", value=("shed", want),
            prev=("shed", prev),
            reason=f"{direction} shed to {want:.2f}: request p99 "
                   f"{p99:.4g}s {cmp} {bound:.4g}s "
                   f"for {self.confirm} evaluations")


class GraftPilot:
    """The closed loop: sensors -> policies -> decisions, evaluated
    every ``interval`` steps.  Construction wires defaults from
    :class:`~geomx_tpu_torch.config.GeoConfig` via :meth:`from_config`."""

    def __init__(self, sensors, ratio: Optional[RatioPolicy] = None,
                 depth: Optional[DepthPolicy] = None,
                 relay: Optional[RelayPolicy] = None,
                 slo: Optional[SloPolicy] = None,
                 interval: int = 1):
        self.sensors = sensors
        self.policies = [p for p in (ratio, depth, relay, slo)
                         if p is not None]
        if not self.policies:
            raise ValueError("GraftPilot needs at least one policy")
        self.interval = max(1, int(interval))
        self.decisions_made = 0

    @classmethod
    def from_config(cls, cfg, sensors, base_ratio: float,
                    **overrides) -> "GraftPilot":
        """Policy stack from the GEOMX_CONTROL_* knobs: ratio bounds
        from ``control_ratio_bounds`` ("lo,hi", default
        [base/8, base]), shared cooldown from ``control_cooldown``,
        evaluation interval from ``control_interval``."""
        bounds = None
        raw = getattr(cfg, "control_ratio_bounds", "") or ""
        if raw.strip():
            parts = [float(s) for s in raw.split(",")]
            if len(parts) != 2:
                raise ValueError(
                    f"GEOMX_CONTROL_RATIO_BOUNDS must be 'lo,hi' "
                    f"(got {raw!r})")
            bounds = (parts[0], parts[1])
        cooldown = getattr(cfg, "control_cooldown", 5)
        kw = dict(
            ratio=RatioPolicy(base_ratio, bounds=bounds, cooldown=cooldown),
            depth=DepthPolicy(
                cooldown=cooldown,
                initial=1 if getattr(cfg, "pipeline_depth", 0) else 0),
            relay=RelayPolicy(cooldown=cooldown),
            interval=getattr(cfg, "control_interval", 1))
        kw.update(overrides)
        return cls(sensors, **kw)

    def tick(self, step: int, now: Optional[float] = None
             ) -> List[Decision]:
        """One control evaluation: observe once, let every policy vote.
        Returns the decisions to actuate (possibly empty); no-ops on
        steps that are not a multiple of ``interval``."""
        if step % self.interval:
            return []
        obs = self.sensors.observe(step, now=now)
        out: List[Decision] = []
        for pol in self.policies:
            d = pol.decide(obs)
            if d is not None:
                out.append(d)
        self.decisions_made += len(out)
        return out
