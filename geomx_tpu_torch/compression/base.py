"""Compressor interface and registry (port of geomx_tpu/compression/base.py).

A compressor is a compressed all-reduce over one replica axis.  In the
port every tensor it receives — gradients and state alike — carries the
leading ``[P, W]`` replica axes (``parallel/collectives.py``), and each
replica row keeps its own state, as each device of the JAX mesh holds
its party's copy.  Trees are flat dicts from dotted path to tensor,
walked in the JAX package's leaf order (``tree.leaf_names``).
"""

from __future__ import annotations

import abc
import math
from typing import Any, Tuple

import torch

from geomx_tpu_torch.parallel.collectives import psum
from geomx_tpu_torch.tree import leaf_names

# leading replica dims of every tensor a compressor sees: [P, W]
REPLICA_DIMS = 2


class Compressor(abc.ABC):
    """A compressed all-reduce over one replica axis."""

    name: str = "base"
    # True for compressors that already fuse the whole gradient tree into
    # flat buffers (BucketedCompressor): the bucketing default skips them
    fuses_tree: bool = False

    # -- state ---------------------------------------------------------------
    def init_leaf_state(self, leaf: torch.Tensor) -> Any:
        """State for one leaf, from an example ``[P, W, *shape]`` leaf."""
        return ()

    def init_state(self, grads: dict) -> dict:
        return {k: self.init_leaf_state(grads[k]) for k in leaf_names(grads)}

    # -- the compressed all-reduce -------------------------------------------
    @abc.abstractmethod
    def allreduce_leaf(self, g: torch.Tensor, state: Any, axis_name: str,
                       axis_size: int) -> Tuple[torch.Tensor, Any]:
        """Return (sum of ``g`` over ``axis_name`` as every replica on it
        receives it, new state)."""

    def allreduce(self, grads: dict, state: dict, axis_name: str,
                  axis_size: int) -> Tuple[dict, dict]:
        out_g, out_s = {}, {}
        for k in leaf_names(grads):
            out_g[k], out_s[k] = self.allreduce_leaf(grads[k], state[k],
                                                     axis_name, axis_size)
        return out_g, out_s

    # -- accounting ----------------------------------------------------------
    def wire_bytes_leaf(self, leaf: torch.Tensor) -> int:
        """Bytes one ``[P, W, *shape]`` leaf puts on the wire per party
        per sync.  The dense default sends the leaf as it is, so its
        dtype sets the bytes an element."""
        return math.prod(leaf.shape[REPLICA_DIMS:]) * leaf.element_size()

    def wire_bytes(self, grads: dict) -> int:
        return sum(self.wire_bytes_leaf(grads[k]) for k in leaf_names(grads))


class NoCompressor(Compressor):
    """Dense fp32 all-reduce (the reference's default uncompressed path)."""

    name = "none"

    def allreduce_leaf(self, g, state, axis_name, axis_size):
        if axis_size == 1:
            return g, state
        return psum(g, axis_name), state


def _parse_bool(v: str) -> bool:
    s = v.strip().lower()
    if s in ("1", "true", "yes", "on"):
        return True
    if s in ("0", "false", "no", "off"):
        return False
    raise ValueError(f"expected a boolean, got {v!r}")


def _parse_int(v: str) -> int:
    return int(float(v))


# per-kind spec grammar: positional arg names (in order) and the key=value
# vocabulary, the JAX package's except bsc's ``fused`` (the port picks
# its kernels by device), which is rejected as an unknown key.
_SPEC_GRAMMAR = {
    "none": ([], {}),
    "fp16": ([], {"bf16": _parse_bool, "sparse_agg": _parse_bool}),
    "2bit": (["threshold"], {"threshold": float, "sparse_agg": _parse_bool}),
    "bsc": (["ratio"], {"ratio": float, "select": str,
                        "min_sparse_size": _parse_int,
                        "approx": _parse_bool, "sparse_agg": _parse_bool,
                        "sparse_agg_parties": _parse_int}),
    "mpq": (["ratio", "size_lower_bound"],
            {"ratio": float, "size_lower_bound": _parse_int,
             "bf16": _parse_bool, "approx": _parse_bool}),
}


def get_compressor(spec) -> Compressor:
    """Parse a reference-style ``"type,args"`` spec (``"bsc,0.01"``,
    ``"bsc,0.01,select=sampled,min_sparse_size=2048"``, ``"2bit,0.5"``,
    ``"fp16,bf16=1"``, ``"mpq,0.01,100000"``) into a Compressor.
    Positional args precede keyword args; unknown keys are rejected with
    the valid vocabulary in the error."""
    from geomx_tpu_torch.compression.bisparse import BiSparseCompressor
    from geomx_tpu_torch.compression.fp16 import FP16Compressor
    from geomx_tpu_torch.compression.mpq import MPQCompressor
    from geomx_tpu_torch.compression.twobit import TwoBitCompressor

    if spec is None:
        return NoCompressor()
    if isinstance(spec, Compressor):
        return spec
    parts = [p.strip() for p in str(spec).split(",")]
    kind = parts[0].lower() or "none"
    if kind not in _SPEC_GRAMMAR:
        raise ValueError(f"Unknown gradient compression type: {spec!r}")
    pos_names, vocab = _SPEC_GRAMMAR[kind]

    kwargs = {}
    seen_kw = False
    npos = 0
    for p in parts[1:]:
        if not p:
            continue
        if "=" in p:
            seen_kw = True
            key, _, val = p.partition("=")
            key = key.strip()
            if key not in vocab:
                raise ValueError(
                    f"Unknown argument {key!r} for compression type "
                    f"{kind!r} in spec {spec!r}; valid keys: "
                    f"{sorted(vocab) or 'none'}")
            if key in kwargs:
                raise ValueError(f"Duplicate argument {key!r} in spec "
                                 f"{spec!r}")
            kwargs[key] = vocab[key](val.strip())
        else:
            if seen_kw:
                raise ValueError(
                    f"Positional argument {p!r} after keyword arguments "
                    f"in spec {spec!r}")
            if npos >= len(pos_names):
                raise ValueError(
                    f"Too many positional arguments for compression type "
                    f"{kind!r} in spec {spec!r} (takes {pos_names or 'none'})")
            name = pos_names[npos]
            kwargs[name] = vocab[name](p)
            npos += 1

    if kind == "none":
        return NoCompressor()
    if kind == "fp16":
        return FP16Compressor(**kwargs)
    if kind == "2bit":
        return TwoBitCompressor(**kwargs)
    if kind == "bsc":
        return BiSparseCompressor(**kwargs)
    return MPQCompressor(**kwargs)
