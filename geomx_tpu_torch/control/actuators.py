"""Actuators: apply Graft Pilot decisions safely (port of
geomx_tpu/control/actuators.py).

Three actuation boundaries, by cost:

- **ratio** — the bsc top-k ratio retunes by rewriting a SCALAR OPERAND
  (``bsc_ratio_scale``, a 0-d fp32 tensor on the trainer's device)
  living in ``sync_state["control"]``.  The step never changes: the
  configured ratio is the wire CAPACITY (static shapes), the scale picks
  the effective selection count below it on the device, and unemitted
  slots ride the wire as sentinels the decompressor already drops.
  ``Trainer.apply_control`` writes the new scale into the same tensor in
  place (``fill_`` on the current stream), so the next step makes the
  same launch calls as the one before, with no host round trip — the
  port's counterpart of the JAX package's unchanged jit cache.
- **depth / relay** — pipeline-depth switching is a rebuild boundary
  modeled on ``Trainer.apply_membership`` (a step built for each
  (depth, membership) and cached, error-feedback state carried across
  the swap); relay re-forming is host-plane only and touches no device
  program.

Every actuation lands in the process-global :class:`DecisionLog`
(served by the scheduler's ``GET /control``), the telemetry event log,
the registry and — when a
:class:`~geomx_tpu_torch.telemetry.flight.FlightRecorder` is armed — the
flight ring's decision sibling, so anomaly bundles show the last N
actuations beside the step records.

The step opens :func:`control_operands` around its sync calls only when
``GEOMX_CONTROL`` is on, and :func:`current_ratio_scale` returns ``None``
otherwise, so the disabled step runs exactly the ops of a build whose
control hook cannot run (the probes' inline-sink pattern).
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import Any, Dict, List, Optional

import torch

CONTROL_KEY = "control"


def control_enabled(config: Optional[Any] = None) -> bool:
    """The master control gate: ``config.control`` or ``GEOMX_CONTROL``
    (same numeric-boolean parse as every GEOMX_* knob).  Static —
    evaluated when the step is built."""
    if config is not None and getattr(config, "control", False):
        return True
    from geomx_tpu_torch.config import _env_bool
    return _env_bool(["GEOMX_CONTROL"], False)


def init_control_operands(device=None) -> Dict[str, torch.Tensor]:
    """The control-operand subtree ``Trainer.init_state`` threads into
    ``sync_state[CONTROL_KEY]``: the bsc ratio scale, a 0-d fp32 tensor
    on ``device`` starting at 1.0 (the configured capacity ratio)."""
    return {"bsc_ratio_scale": torch.ones((), dtype=torch.float32,
                                          device=device)}


# ---------------------------------------------------------------------------
# the operand context (the probes' inline-sink pattern)
# ---------------------------------------------------------------------------

_ctl = threading.local()


@contextlib.contextmanager
def control_operands(ops: Dict[str, Any]):
    """Open the control operands for the sync stack: compressors deep
    inside the dc tier read them via :func:`current_ratio_scale` without
    a parameter threaded through every signature."""
    prev = getattr(_ctl, "ops", None)
    _ctl.ops = ops
    try:
        yield ops
    finally:
        _ctl.ops = prev


def current_ratio_scale():
    """The ``bsc_ratio_scale`` operand, or ``None`` when no control
    context is open (the disabled path: no op runs for it)."""
    ops = getattr(_ctl, "ops", None)
    if ops is None:
        return None
    return ops.get("bsc_ratio_scale")


# ---------------------------------------------------------------------------
# decision log (bounded, process-global; the scheduler serves it)
# ---------------------------------------------------------------------------

class DecisionLog:
    """Thread-safe bounded history of applied decisions.  Entries are
    plain JSON-able dicts with NO wall-clock fields — two runs of the
    same seeded scenario must produce byte-identical logs."""

    def __init__(self, capacity: int = 256):
        if capacity <= 0:
            raise ValueError(f"capacity must be > 0 (got {capacity!r})")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._entries: "collections.deque[dict]" = collections.deque(
            maxlen=self.capacity)
        self.total = 0

    def append(self, entry: Dict[str, Any]) -> None:
        with self._lock:
            self._entries.append(dict(entry))
            self.total += 1

    def snapshot(self) -> List[dict]:
        with self._lock:
            return [dict(e) for e in self._entries]

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.total = 0


_global_log: Optional[DecisionLog] = None
_global_log_lock = threading.Lock()


def get_decision_log() -> DecisionLog:
    global _global_log
    with _global_log_lock:
        if _global_log is None:
            _global_log = DecisionLog()
        return _global_log


def reset_decision_log() -> DecisionLog:
    """Fresh global decision log (test and replay isolation)."""
    global _global_log
    with _global_log_lock:
        _global_log = DecisionLog()
        return _global_log


# ---------------------------------------------------------------------------
# the actuator
# ---------------------------------------------------------------------------

class ControlActuator:
    """Routes decisions to their actuation boundary and records every
    application.

    ``trainer``: the :class:`~geomx_tpu_torch.train.trainer.Trainer`
    whose ``apply_control`` owns the ratio/depth boundaries.
    ``relay_apply``: optional callable receiving the new relay order
    (host plane — a transport or a WAN model installs it; the decision
    log records it either way).  ``flight``: optional FlightRecorder
    whose decision ring mirrors the log.
    """

    def __init__(self, trainer=None, relay_apply=None, flight=None,
                 log: Optional[DecisionLog] = None,
                 event_log=None):
        self.trainer = trainer
        self.relay_apply = relay_apply
        self.flight = flight if flight is not None else \
            getattr(trainer, "_flight", None)
        self.log = log if log is not None else get_decision_log()
        self._event_log = event_log

    def apply(self, state, decision):
        """Apply one decision; returns the (possibly new) TrainState.
        Unknown kinds raise — a controller emitting a decision no
        actuator understands is a bug, not a log line."""
        kind = getattr(decision, "kind", None)
        if kind in ("ratio", "depth"):
            if self.trainer is None:
                raise ValueError(
                    f"{kind!r} decision needs a trainer-bound actuator "
                    "(ControlActuator(trainer=...))")
            state = self.trainer.apply_control(state, decision)
        elif kind == "relay":
            if self.relay_apply is not None:
                self.relay_apply(list(decision.value))
        else:
            raise ValueError(f"unknown decision kind {kind!r}; "
                             "expected ratio | depth | relay")
        self._record(decision)
        return state

    def _record(self, decision) -> None:
        entry = decision.to_json()
        self.log.append(entry)
        if self.flight is not None:
            self.flight.record_decision(entry)
        from geomx_tpu_torch.telemetry import get_registry, log_event
        reg = get_registry()
        reg.counter("geomx_control_decisions_total",
                    "Controller actuations applied",
                    ("kind",)).labels(kind=entry["kind"]).inc()
        if entry["kind"] == "ratio":
            reg.gauge("geomx_control_ratio",
                      "Current controller-set bsc ratio").set(
                float(entry["value"]))
        elif entry["kind"] == "depth":
            reg.gauge("geomx_control_pipeline_depth",
                      "Current controller-set pipeline depth").set(
                float(entry["value"]))
        # the event kind is positional; the decision's own "kind" field
        # rides as decision_kind so the two never collide
        ev = {("decision_kind" if k == "kind" else k): v
              for k, v in entry.items()}
        if self._event_log is not None:
            self._event_log.emit("control_decision", **ev)
        else:
            log_event("control_decision", **ev)
