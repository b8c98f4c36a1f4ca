"""Native (C++) host runtime bindings (port of geomx_tpu/runtime/).

The priority send queue, the TSEngine scheduler state machine, the
server-side SGD, the wire CRC seal, the pair merge and the RecordIO
codec are C++ (``native/geops_runtime.cpp``, shared with the JAX
package) behind the port's own ctypes binding, with build-on-first-use
and pure-Python fallbacks (``geomx_tpu_torch.transport``) when no
toolchain exists.  The JAX package's ``backends.py`` scrubs TPU plugins
from JAX's backend order and has no counterpart here.
"""

from geomx_tpu_torch.runtime.native import (NativePriorityQueue,
                                            NativeRecordIOReader,
                                            NativeRecordIOWriter,
                                            NativeSGD, NativeTSEngine,
                                            load_native, native_available)

__all__ = ["NativePriorityQueue", "NativeRecordIOReader",
           "NativeRecordIOWriter", "NativeSGD", "NativeTSEngine",
           "load_native", "native_available"]
