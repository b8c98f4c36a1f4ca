"""Transport-layer scheduling equivalents (port of geomx_tpu/transport/).

The reference implements three transport accelerators inside its forked
ps-lite (P3 priority propagation, DGT multi-channel QoS, TSEngine adaptive
overlays).  The host parameter-service plane (``service/``) uses their
scheduling logic, implemented here as standalone components: the
chunk slicer and reassembler and the priority send queue (the pure-Python
fallback of the native one, ``runtime/native.py``), and the TSEngine
scheduler.
"""

from geomx_tpu_torch.transport.p3 import (ChunkAssembler, P3Slicer,
                                          PrioritySendQueue)
from geomx_tpu_torch.transport.tsengine import TSEngineScheduler

__all__ = ["ChunkAssembler", "P3Slicer", "PrioritySendQueue",
           "TSEngineScheduler"]
