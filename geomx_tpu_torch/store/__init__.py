"""KVStore-compatible imperative API (port of geomx_tpu/store/).

A familiarity layer for users migrating from the reference's
``mx.kv.create(...)`` surface (python/mxnet/kvstore.py:99-705): explicit
``init/push/pull/barrier/set_optimizer/set_gradient_compression`` against
named keys.  The functional path (``geomx_tpu_torch.train``) is the
performance path; this store is the compatibility/interop path.
"""

from geomx_tpu_torch.store.api import KVStore, create

__all__ = ["KVStore", "create"]
