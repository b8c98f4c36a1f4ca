"""Checkpoint/resume (port of geomx_tpu/utils/checkpoint.py).

The full training state round-trips — parameters, optimizer state,
model state and sync-algorithm state (compressor residuals, in-flight
pipeline buffers) — with the leading ``[P, W]`` replica axes kept, so a
resumed run continues bit for bit.

Format, as in the JAX package: one pickle (protocol 4) of host numpy
trees, written atomically and fsynced (``utils/atomicio.py``); with a
``meta`` block the pickle is the envelope ``{"__geomx_ckpt__": 1,
"meta": meta, "tree": tree}``.  The port pickles no torch tensor and no
class of its own: tensors become numpy arrays, a ``TrainState`` becomes
the dict of its fields, dicts, lists and tuples keep their type, and
host scalars (step counts) stay Python numbers.  So a port checkpoint
loads with numpy and pickle alone.

The reverse does not hold: a JAX checkpoint pickles classes of the JAX
package and of optax (its ``TrainState``, optax's state tuples), which
unpickle only with those packages imported.  The port does not import
them, so it cannot read a JAX checkpoint (ROADMAP.md Queue 1, "Slice-1
leftovers"); weights cross over through ``models/convert.py`` instead.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Any, Optional

import numpy as np
import torch

from geomx_tpu_torch.train.state import TrainState
from geomx_tpu_torch.utils.atomicio import atomic_write_bytes

_ENVELOPE_KEY = "__geomx_ckpt__"
_FIELDS = tuple(f.name for f in dataclasses.fields(TrainState))


def to_host(tree: Any) -> Any:
    """``tree`` with every tensor copied to a numpy array and a
    ``TrainState`` as the dict of its fields."""
    if isinstance(tree, torch.Tensor):
        if tree.dtype == torch.bfloat16:
            raise TypeError("bf16 state has no numpy dtype; checkpoints "
                            "hold fp32 state")
        return tree.detach().numpy(force=True).copy()
    if isinstance(tree, TrainState):
        return {f: to_host(getattr(tree, f)) for f in _FIELDS}
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


def tree_to_bytes(tree: Any, meta: Optional[dict] = None) -> bytes:
    """Serialize a state tree; with ``meta``, inside the versioned
    envelope."""
    host = to_host(tree)
    if meta is None:
        return pickle.dumps(host, protocol=4)
    return pickle.dumps({_ENVELOPE_KEY: 1, "meta": dict(meta),
                         "tree": host}, protocol=4)


def _mismatch(what: str) -> ValueError:
    return ValueError("checkpoint structure mismatch: different model/"
                      f"optimizer/sync configuration ({what})")


def place_like(host: Any, target: Any) -> Any:
    """Rebuild ``target``'s structure around ``host``'s leaves: each
    array onto the matching target tensor's device and dtype (the shapes
    must agree), host scalars as stored."""
    if isinstance(target, TrainState):
        if not isinstance(host, dict) or set(host) != set(_FIELDS):
            raise _mismatch("not a training state")
        return TrainState(**{f: place_like(host[f], getattr(target, f))
                             for f in _FIELDS})
    if isinstance(target, torch.Tensor):
        h = np.asarray(host)
        if tuple(h.shape) != tuple(target.shape):
            raise _mismatch(f"a leaf of shape {h.shape} where the target "
                            f"has {tuple(target.shape)}")
        return torch.as_tensor(h, device=target.device).to(target.dtype)
    if isinstance(target, dict):
        if not isinstance(host, dict) or set(host) != set(target):
            raise _mismatch("different keys")
        return {k: place_like(host[k], target[k]) for k in target}
    if isinstance(target, (list, tuple)):
        if not isinstance(host, (list, tuple)) or len(host) != len(target):
            raise _mismatch("different lengths")
        return type(target)(place_like(h, t) for h, t in zip(host, target))
    return host


def tree_from_bytes(blob: bytes, target: Optional[Any] = None,
                    with_meta: bool = False) -> Any:
    """Inverse of :func:`tree_to_bytes`: the host tree, or with
    ``target`` the tree placed like it; ``with_meta`` also returns the
    envelope's meta (None without one) as ``(tree, meta)``."""
    obj = pickle.loads(blob)
    meta = None
    if isinstance(obj, dict) and _ENVELOPE_KEY in obj:
        meta = obj.get("meta")
        obj = obj["tree"]
    if target is not None:
        obj = place_like(obj, target)
    return (obj, meta) if with_meta else obj


def save_checkpoint(path: str, state: Any, step: Optional[int] = None,
                    meta: Optional[dict] = None) -> str:
    """Save a state tree (e.g. a ``TrainState``); returns the final path
    (``<path>[/step_<step>].ckpt``)."""
    if step is not None:
        path = os.path.join(path, f"step_{step}")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    final = path if path.endswith(".ckpt") else path + ".ckpt"
    # a crash mid-write never corrupts a checkpoint; fsync so a resume
    # after power loss never reads a rename that did not survive
    atomic_write_bytes(final, tree_to_bytes(state, meta=meta), fsync=True)
    return final


def load_checkpoint(path: str, target: Optional[Any] = None,
                    with_meta: bool = False) -> Any:
    """Load a checkpoint: the host tree (a ``TrainState`` as a dict of
    numpy trees), or with ``target`` a state placed like it."""
    if not path.endswith(".ckpt"):
        path = path + ".ckpt"
    with open(path, "rb") as f:
        return tree_from_bytes(f.read(), target=target, with_meta=with_meta)
