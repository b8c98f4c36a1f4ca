"""Graft Pilot: the closed-loop WAN controller (port of geomx_tpu/control/).

A sensor -> policy -> actuator loop that retunes compression ratio,
pipeline depth and relay topology from live measurements instead of
static configuration:

- :mod:`sensors`   — fold links, attribution, the probe registry,
  FleetScope's rollups and resilience into one normalized
  :class:`ControlObservation`;
- :mod:`policy`    — deterministic, hysteresis-guarded policies
  (:class:`RatioPolicy`, :class:`DepthPolicy`, :class:`RelayPolicy`,
  :class:`SloPolicy`) under the :class:`GraftPilot` loop;
- :mod:`actuators` — safe application: ratio changes ride a 0-d fp32
  operand on the device written in place (the step's launches stay the
  same), depth changes go through the ``Trainer.apply_control`` rebuild
  boundary, every actuation lands in the bounded :class:`DecisionLog`
  the scheduler serves at ``GET /control``.

Gated by ``GEOMX_CONTROL``; with it off the step runs exactly the ops of
a build whose control hook cannot run.
"""

from geomx_tpu_torch.control.actuators import (CONTROL_KEY, ControlActuator,
                                               DecisionLog, control_enabled,
                                               control_operands,
                                               current_ratio_scale,
                                               get_decision_log,
                                               init_control_operands,
                                               reset_decision_log)
from geomx_tpu_torch.control.policy import (Decision, DepthPolicy,
                                            GraftPilot, RatioPolicy,
                                            RelayPolicy)
from geomx_tpu_torch.control.sensors import (ControlObservation,
                                             ControlSensors)

__all__ = [
    "CONTROL_KEY", "ControlActuator", "DecisionLog", "control_enabled",
    "control_operands", "current_ratio_scale", "get_decision_log",
    "init_control_operands", "reset_decision_log",
    "Decision", "DepthPolicy", "GraftPilot", "RatioPolicy", "RelayPolicy",
    "ControlObservation", "ControlSensors",
]
