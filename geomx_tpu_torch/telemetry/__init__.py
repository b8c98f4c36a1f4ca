"""Telemetry of the port (geomx_tpu/telemetry/).

Ported: :mod:`registry`, the process-global Counter/Gauge/Histogram
registry that the host plane writes into (retries, CRC rejections,
merged rounds) and its tests read.  The rest of the JAX package's
telemetry plane (the Prometheus exporters, the round ledger, the flight
recorder, tracing, attribution, capsules) is ROADMAP.md Queue 1 item
"Telemetry".
"""

from geomx_tpu_torch.telemetry.registry import (MetricRegistry,
                                                get_registry,
                                                reset_registry)

__all__ = ["MetricRegistry", "get_registry", "reset_registry"]
