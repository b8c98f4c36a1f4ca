"""Imperative key-value store over the HiPS replicas (port of
geomx_tpu/store/api.py).

Semantics parity with the reference python API (python/mxnet/kvstore.py):

- ``init(key, value)``   — one-time value registration (kvstore.py:99);
- ``push(key, value)``   — contribute gradients; values may be a per-worker
  stack (the ``[parties, workers]`` replica axes) and are aggregated
  hierarchically (sum), like multi-device pushes through Comm::Reduce then
  the two PS tiers;
- ``pull(key)``          — read the current aggregated/updated value;
- ``set_optimizer``      — server-side optimizer: subsequent pushes apply
  the update to the stored weights instead of overwriting them
  (kvstore.py:452 set_optimizer -> server Executor);
- ``set_gradient_compression`` — reference kwargs format
  {"type": "2bit"|"bsc"|"fp16"|"mpq", "threshold": x} (kvstore.py:618);
- ``rank/num_workers/num_all_workers/is_master_worker/barrier`` — topology
  introspection (kvstore.py:541-564).

``create("local")`` = single-party in-process store (reference
kvstore_local); ``create("dist_sync")``/``create("hips")`` = hierarchical
store over a HiPSTopology: pushes carry leading [parties, workers] axes
and aggregate across both tiers, compression applying to the cross-party
hop exactly as in the reference.

The values live on the store's ``device`` (``resolve_device``: the card
unless the caller passes ``"cpu"``), so the cross-party hop's compressor
runs there: BSC's select/pack and scatter-add, and the 2-bit quantize
and dequantize, are CUDA kernels on the card.  The port's compressors
take tensors with the ``[P, W]`` replica axes in front
(``compression/base.py``); the store hands each party's sum to them as a
``[1, 1, *shape]`` tensor and keeps one error-feedback state of that
shape per party.  Optimizers are the port's (optax semantics), each key's
value the one-leaf tree ``{"w": value}``.

Where the port differs from the JAX store:

- ``create("dist_sync")`` (and the other distributed names) without a
  topology: the JAX store infers one from ``jax.devices()``; the port's
  replicas all live on one card, so it takes
  ``HiPSTopology(num_parties, workers_per_party)`` from
  ``GeoConfig.from_env()``.
- ``create("dist_async")`` returns the synchronous store, as the JAX
  package's does: it has no asynchronous mode.  The port mirrors that
  rather than fix it alone.
- ``save_optimizer_states`` pickles the port's state with its tensors
  moved to numpy; a JAX file (optax state classes) is not portable, as
  with checkpoints (``utils/checkpoint.py``).
"""

from __future__ import annotations

import pickle
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from geomx_tpu_torch.compression import get_compressor
from geomx_tpu_torch.compression.base import NoCompressor
from geomx_tpu_torch.device import resolve_device
from geomx_tpu_torch.topology import HiPSTopology
from geomx_tpu_torch.tree import state_map
from geomx_tpu_torch.utils.checkpoint import to_host


def _fold_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` as a left fold in index order: the same bits on
    the card and the CPU (``torch.sum`` may reassociate)."""
    parts = x.unbind(dim)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


class KVStore:
    """Hierarchically-aggregating key-value store (single-controller)."""

    def __init__(self, kind: str = "local",
                 topology: Optional[HiPSTopology] = None, device=None):
        self.kind = kind
        self.topology = topology or HiPSTopology(1, 1)
        self.device = resolve_device(device)
        self._store: Dict[Any, torch.Tensor] = {}
        self._comp = NoCompressor()
        self._comp_state: Dict[Any, Any] = {}
        self._tx = None
        self._opt_state: Dict[Any, Any] = {}
        self._updater: Optional[Callable] = None

    def _tensor(self, value) -> torch.Tensor:
        """A value on the store's device; float64 becomes float32, as
        ``jnp.asarray`` makes it with 64-bit mode off."""
        t = torch.as_tensor(np.asarray(value)) \
            if not isinstance(value, torch.Tensor) else value
        if t.dtype == torch.float64:
            t = t.to(torch.float32)
        return t.to(self.device)

    def _comp_init(self, v: torch.Tensor) -> Any:
        return self._comp.init_leaf_state(v[None, None])

    # ---- topology introspection -------------------------------------------
    @property
    def rank(self) -> int:
        return 0

    @property
    def num_workers(self) -> int:
        """Workers in this party (reference: group_size)."""
        return self.topology.workers_per_party

    @property
    def num_all_workers(self) -> int:
        """All workers across parties (reference kvstore.py:541)."""
        return self.topology.total_workers

    @property
    def is_master_worker(self) -> bool:
        """Single controller: this process plays the master worker
        (reference: the distinguished config-driving worker, kvstore.py:554)."""
        return True

    def barrier(self):
        """All outstanding device work completes — the single-process
        analogue of the reference's global barrier (kvstore.py:_barrier)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- configuration -----------------------------------------------------
    def set_gradient_compression(self, compression_params: Dict[str, Any]):
        ctype = compression_params.get("type", "none")
        if ctype == "2bit":
            spec = f"2bit,{compression_params.get('threshold', 0.5)}"
        elif ctype == "bsc":
            spec = f"bsc,{compression_params.get('threshold', 0.01)}"
        elif ctype in ("none", None):
            spec = "none"
        elif ctype == "fp16":
            spec = "fp16"
        elif ctype == "mpq":
            spec = (f"mpq,{compression_params.get('threshold', 0.01)},"
                    f"{compression_params.get('size_lower_bound', 200_000)}")
        else:
            raise ValueError(f"Unknown gradient compression type {ctype}")
        self._comp = get_compressor(spec)
        self._comp_state = {k: self._comp_init(v)
                            for k, v in self._store.items()}

    def set_optimizer(self, optimizer):
        """Server-side optimizer (one of the port's, e.g.
        ``optim.sgd(0.1, momentum=0.9)``): pushes become updates (the
        reference pickles the optimizer to the global server; here it's
        held directly)."""
        self._tx = optimizer
        for k, v in self._store.items():
            self._opt_state[k] = self._tx.init({"w": v})

    def _set_updater(self, updater: Callable):
        """Raw updater fn(key, grad, weight) -> weight, the reference's
        low-level _set_updater hook."""
        self._updater = updater

    # ---- data path ---------------------------------------------------------
    def init(self, key, value):
        if key in self._store:
            raise ValueError(f"duplicate init of key {key!r}")
        v = self._tensor(value)
        self._store[key] = v
        self._comp_state[key] = self._comp_init(v)
        if self._tx is not None:
            self._opt_state[key] = self._tx.init({"w": v})

    def _aggregate(self, key, value) -> torch.Tensor:
        """Hierarchical sum of a pushed value.

        Accepts a bare tensor, a list of per-device tensors (reference
        multi-device push), or a stacked [parties, workers, ...] tensor
        (the global push).  Cross-party aggregation goes through the
        configured compressor with per-party error-feedback state,
        mirroring compression on the local->global hop.
        """
        ref = self._store[key]
        if isinstance(value, (list, tuple)):
            return _fold_sum(torch.stack([self._tensor(v) for v in value]),
                             0)
        value = self._tensor(value)
        if value.shape == ref.shape:
            return value
        if value.shape[2:] == ref.shape and value.ndim == ref.ndim + 2:
            # [parties, workers, ...]: worker tier sums densely,
            # dc tier goes through the compressor
            party_sum = _fold_sum(value, 1)
            if self.topology.num_parties == 1 or \
                    isinstance(self._comp, NoCompressor):
                return _fold_sum(party_sum, 0)
            total = torch.zeros_like(ref)
            # per-party compress/accumulate with per-party error-feedback
            # state, each party's sum as one [1, 1, ...] replica
            states = self._comp_state.get(key)
            if not isinstance(states, list):
                states = [states] + [self._comp_init(ref)
                                     for _ in range(party_sum.shape[0] - 1)]
            for p in range(party_sum.shape[0]):
                g, states[p] = self._comp.allreduce_leaf(
                    party_sum[p][None, None], states[p], axis_name=None,
                    axis_size=1)
                total = total + g[0, 0]
            self._comp_state[key] = states
            return total
        raise ValueError(
            f"push shape {tuple(value.shape)} incompatible with key shape "
            f"{tuple(ref.shape)}")

    def push(self, key, value, priority: int = 0):
        if key not in self._store:
            raise KeyError(f"push to uninitialized key {key!r}")
        grad = self._aggregate(key, value)
        if self._updater is not None:
            self._store[key] = self._tensor(
                self._updater(key, grad, self._store[key]))
        elif self._tx is not None:
            new, self._opt_state[key] = self._tx.update(
                {"w": grad}, self._opt_state[key], {"w": self._store[key]})
            self._store[key] = new["w"]
        else:
            # pure aggregation, like the reference local tier
            self._store[key] = grad

    def pull(self, key, out=None, priority: int = 0):
        """Read the stored value.  With ``out`` (a numpy array or a
        tensor), also fills it in place, matching the reference's
        ``kv.pull(idx, out=param.data())`` usage (examples/cnn.py:124)."""
        if key not in self._store:
            raise KeyError(f"pull of uninitialized key {key!r}")
        v = self._store[key]
        if out is not None:
            if isinstance(out, torch.Tensor):
                out.copy_(v)
            elif isinstance(out, np.ndarray):
                out[...] = v.cpu().numpy().astype(out.dtype, copy=False)
            else:
                raise TypeError("out must be a numpy array or a tensor; "
                                "use the return value instead")
            return out
        return v

    # ---- row-sparse path (reference row_sparse storage: python
    # kvstore.py row_sparse_pull:300-360, EncodeRowSparseKey
    # src/kvstore/kvstore_dist.h:874-906) --------------------------------
    def push_row_sparse(self, key, row_ids, values, priority: int = 0):
        """Push only the touched rows of a 2D+ parameter (embedding-style
        sparse gradients).  ``row_ids`` [k] indexes rows of the stored
        tensor; ``values`` [k, ...] are their gradients.  Lists of
        (row_ids, values) pairs are the multi-worker push; duplicate rows
        accumulate, matching row-sparse gradient summation.

        Untouched rows are never modified: without an optimizer the
        contributions scatter-add into the stored value (row-sparse
        accumulation); with one, the update is **lazy** — it runs only on
        the touched rows (gather rows of params and optimizer state,
        update, scatter back) — the reference's row_sparse optimizer
        semantics, where untouched rows see no weight decay or momentum
        drift (src/operator/optimizer_op: row_sparse sgd/adam kernels)."""
        if key not in self._store:
            raise KeyError(f"push to uninitialized key {key!r}")
        ref = self._store[key]
        if not isinstance(row_ids, (list, tuple)):
            row_ids, values = [row_ids], [values]
        if len(row_ids) != len(values):
            raise ValueError(
                f"{len(row_ids)} row_id lists vs {len(values)} value lists")
        all_r = np.concatenate([np.asarray(r, np.int64).ravel()
                                for r in row_ids])
        all_v = torch.cat(
            [self._tensor(v).to(ref.dtype).reshape((-1,) + ref.shape[1:])
             for v in values])

        if self._tx is None and self._updater is None:
            # aggregation semantics: contributions scatter-add INTO the
            # stored value, leaving untouched rows alone (row-sparse
            # accumulation; a dense-push overwrite would zero every row
            # this push didn't mention)
            self._store[key] = ref.index_add(
                0, torch.from_numpy(all_r).to(self.device), all_v)
            return
        if self._updater is not None:
            grad = torch.zeros_like(ref).index_add(
                0, torch.from_numpy(all_r).to(self.device), all_v)
            self._store[key] = self._tensor(self._updater(key, grad, ref))
            return

        # lazy update: unique touched rows (host-side — the data-dependent
        # size is fine in an imperative store)
        uniq, inverse = np.unique(all_r, return_inverse=True)
        rows = torch.from_numpy(uniq).to(self.device)
        grad_rows = torch.zeros((len(uniq),) + tuple(ref.shape[1:]),
                                dtype=ref.dtype, device=self.device)
        grad_rows = grad_rows.index_add(
            0, torch.from_numpy(inverse.reshape(-1)).to(self.device), all_v)

        def is_rowwise(leaf):
            return isinstance(leaf, torch.Tensor) and \
                tuple(leaf.shape) == tuple(ref.shape)

        def gather(leaf):
            return leaf[rows] if is_rowwise(leaf) else leaf

        def scatter(full, part):
            if not is_rowwise(full):
                return part
            out = full.clone()
            out[rows] = part
            return out

        state_rows = state_map(gather, self._opt_state[key])
        new_rows, new_state_rows = self._tx.update(
            {"w": grad_rows}, state_rows, {"w": ref[rows]})
        new = ref.clone()
        new[rows] = new_rows["w"]
        self._store[key] = new
        self._opt_state[key] = state_map(scatter, self._opt_state[key],
                                         new_state_rows)

    def row_sparse_pull(self, key, row_ids, priority: int = 0):
        """Pull only the requested rows (reference: workers pull just the
        embedding rows their batch touches)."""
        if key not in self._store:
            raise KeyError(f"pull of uninitialized key {key!r}")
        rows = torch.as_tensor(np.asarray(row_ids, np.int64),
                               device=self.device)
        return self._store[key][rows]

    # ---- optimizer state persistence (kvstore.py:566-592) ------------------
    def save_optimizer_states(self, fname: str):
        with open(fname, "wb") as f:
            pickle.dump(to_host(self._opt_state), f)

    def load_optimizer_states(self, fname: str):
        """Read a file ``save_optimizer_states`` wrote (this program's
        own pickle), its arrays placed on the store's device."""
        with open(fname, "rb") as f:
            host = pickle.load(f)
        self._opt_state = state_map(
            lambda a: torch.as_tensor(a, device=self.device)
            if isinstance(a, np.ndarray) else a, host)


def create(name: str = "local", topology: Optional[HiPSTopology] = None,
           device=None) -> KVStore:
    """Factory mirroring mx.kv.create (reference kvstore.py:663 and
    KVStore::Create, src/kvstore/kvstore.cc:41-82).  A distributed store
    without a topology takes ``HiPSTopology(num_parties,
    workers_per_party)`` from ``GeoConfig.from_env()``; ``"dist_async"``
    is the synchronous store, as in the JAX package (module docstring)."""
    name = name.lower()
    if name in ("local", "device"):
        return KVStore("local", HiPSTopology(1, 1), device)
    if name in ("dist_sync", "dist_async", "dist", "hips"):
        if topology is None:
            from geomx_tpu_torch.config import GeoConfig
            cfg = GeoConfig.from_env()
            topology = HiPSTopology(cfg.num_parties, cfg.workers_per_party)
        return KVStore(name, topology, device)
    raise ValueError(f"Unknown kvstore type {name!r}")
