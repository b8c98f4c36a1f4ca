"""Elastic resilience (port of geomx_tpu/resilience/): party-liveness
control, degraded-mode WAN sync, deterministic fault injection and the
durable host-plane store.

- ``liveness``   — ``PartyLivenessController`` turns heartbeat and
  roster signals into a versioned **membership epoch** (live-party mask
  and renormalization weight) that the sync algorithms and the Trainer
  consume;
- degraded-mode sync lives in ``sync/`` (FSA, MixedSync and the
  pipelined sync accept the mask through ``bind_membership``; the
  dc-tier aggregate becomes a renormalized mean over the surviving
  parties);
- ``chaos``      — seeded, reproducible schedules of party blackouts,
  link flaps, message-drop epochs and host-plane process deaths that
  drive the controller and the transports in-process;
- ``durability`` — the atomic-snapshot + append-journal store the
  parameter server and the scheduler recover from.
"""

from geomx_tpu_torch.resilience.chaos import (ChaosEngine, ChaosEvent,
                                              ChaosSchedule)
from geomx_tpu_torch.resilience.liveness import (MembershipEpoch,
                                                 PartyLivenessController)

__all__ = ["MembershipEpoch", "PartyLivenessController", "ChaosSchedule",
           "ChaosEvent", "ChaosEngine"]
