"""DGT — Differential Gradient Transmission (port of geomx_tpu/sync/dgt.py).

Reference semantics (kv_app.h:1088-1196, van.cc:723-846): the push to the
global tier is sliced into fixed-size blocks; each block's
*contribution* is an EWMA of its mean |gradient| (``contri = alpha *
contri + (1 - alpha) * mean|block|``, kv_app.h:1047-1068); the top
``round(k * nblocks)`` blocks by contribution go over the reliable
channel, the rest over lower-priority channels that deliver late.

The JAX package's re-expression, kept here: the top blocks are
all-reduced at once; the others accumulate in a per-replica ``pending``
buffer and go out when their block ranks high enough, or on the drain
that fires every ``channels`` steps.  No gradient mass is dropped.  The
drain gate reads DGT's own step counter, which is state (one per
replica, a ``[P, W]`` int32 tensor), so no host branch is needed.

The tree-level ``allreduce`` concatenates the whole gradient into one
flat fp32 vector (a plain ``torch.cat``, as the reference's
``jnp.concatenate``), padded to whole blocks, ranks the blocks once, and
runs the inner compressor's ``allreduce_leaf`` on the padded vector;
``allreduce_leaf`` keeps the per-leaf schedule.  The threshold is the
``k``-th value of ``ops.topk.top_k`` (``lax.top_k``'s total order).
``k_min`` and ``adaptive`` are accepted and ignored, as in the reference
(it resets ``dmlc_k`` to its initial value before every send).

Every tensor carries the leading ``[P, W]`` replica axes; each replica
keeps its own ``contri``, ``pending`` and ``step``.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from geomx_tpu_torch.compression.base import (REPLICA_DIMS, Compressor,
                                              NoCompressor)
from geomx_tpu_torch.ops.topk import top_k
from geomx_tpu_torch.tree import leaf_names


class DGTCompressor(Compressor):
    name = "dgt"
    # the tree-level allreduce already fuses the whole gradient into one
    # flat buffer: the bucketing default must not wrap it again
    fuses_tree = True

    def __init__(self, inner: Optional[Compressor] = None,
                 block_elems: int = 1024, k: float = 0.5, alpha: float = 0.3,
                 channels: int = 1, k_min: float = 0.2,
                 adaptive: bool = False):
        # defaults mirror kv_app.h:1036-1045 (DGT_BLOCK_SIZE=4096 bytes,
        # DMLC_K=0.5, DMLC_K_MIN=0.2, DGT_CONTRI_ALPHA=0.3,
        # DMLC_UDP_CHANNEL_NUM=1)
        self.inner = inner or NoCompressor()
        self.block_elems = max(1, int(block_elems))
        self.k = float(k)
        self.k_min = float(k_min)
        self.alpha = float(alpha)
        self.flush_every = max(1, int(channels))
        self.adaptive = adaptive

    def _nblocks(self, n: int) -> int:
        return -(-n // self.block_elems)

    def _schedule_state(self, lead, nb: int, device) -> dict:
        return {"contri": torch.zeros(lead + (nb,), dtype=torch.float32,
                                      device=device),
                "pending": torch.zeros(lead + (nb * self.block_elems,),
                                       dtype=torch.float32, device=device),
                "step": torch.zeros(lead, dtype=torch.int32, device=device)}

    def init_leaf_state(self, leaf: torch.Tensor) -> Any:
        lead = tuple(leaf.shape[:REPLICA_DIMS])
        n = math.prod(leaf.shape[REPLICA_DIMS:])
        state = self._schedule_state(lead, self._nblocks(n), leaf.device)
        state["inner"] = self.inner.init_leaf_state(leaf)
        return state

    def _padded(self, flat: torch.Tensor) -> torch.Tensor:
        """``[*B, n]`` fp32 -> ``[*B, nb * block_elems]``, zero tail."""
        n = flat.shape[-1]
        return F.pad(flat, (0, self._nblocks(n) * self.block_elems - n))

    def _defer_schedule(self, gf: torch.Tensor, state: Any):
        """The DGT core on ``[*B, padded]`` fp32 rows: returns (sendable
        rows, new state without 'inner')."""
        lead = tuple(gf.shape[:-1])
        nb = gf.shape[-1] // self.block_elems
        by_block = lead + (nb, self.block_elems)
        blocks = (gf + state["pending"]).reshape(by_block)

        # contribution EWMA over mean |g| a block (kv_app.h:1058-1066);
        # a sum and a divide, as jnp.mean (torch.mean multiplies by 1/n)
        mag = gf.reshape(by_block).abs().sum(-1) / self.block_elems
        contri = state["contri"] * self.alpha + mag * (1.0 - self.alpha)

        # channel 0 = the top round(k * nblocks) blocks (Get_channel)
        k_now = max(1, int(round(self.k * nb)))
        if k_now >= nb:
            send = torch.ones(lead + (nb,), dtype=torch.bool,
                              device=gf.device)
        else:
            kth = top_k(contri, k_now)[0][..., -1:]
            send = contri >= kth
        # the periodic drain of the deferred channels
        step = state["step"]
        drain = (step + 1) % self.flush_every == 0
        send = (send | drain.unsqueeze(-1)).unsqueeze(-1)

        zero = torch.zeros((), dtype=torch.float32, device=gf.device)
        sendable = torch.where(send, blocks, zero).reshape(gf.shape)
        pending = torch.where(send, zero, blocks).reshape(gf.shape)
        return sendable, {"contri": contri, "pending": pending,
                          "step": step + 1}

    def allreduce_leaf(self, g: torch.Tensor, state: Any, axis_name: str,
                       axis_size: int) -> Tuple[torch.Tensor, Any]:
        lead = tuple(g.shape[:REPLICA_DIMS])
        n = math.prod(g.shape[REPLICA_DIMS:])
        gf = self._padded(g.reshape(lead + (n,)).to(torch.float32))
        sendable, new_state = self._defer_schedule(gf, state)
        summed, inner_state = self.inner.allreduce_leaf(
            sendable[..., :n].reshape(g.shape).to(g.dtype),
            state["inner"], axis_name, axis_size)
        new_state["inner"] = inner_state
        return summed, new_state

    # -- the tree-level path: one schedule for the whole gradient ----------
    def init_state(self, grads: dict) -> Any:
        leaves = [grads[k] for k in leaf_names(grads)]
        lead = tuple(leaves[0].shape[:REPLICA_DIMS])
        n = sum(math.prod(leaf.shape[REPLICA_DIMS:]) for leaf in leaves)
        nb = self._nblocks(n)
        state = self._schedule_state(lead, nb, leaves[0].device)
        # the inner compressor's state lives on the same flat layout
        state["inner"] = self.inner.init_leaf_state(state["pending"])
        return state

    def allreduce(self, grads: dict, state: Any, axis_name: str,
                  axis_size: int) -> Tuple[dict, Any]:
        names = leaf_names(grads)
        leaves = [grads[k] for k in names]
        lead = tuple(leaves[0].shape[:REPLICA_DIMS])
        flat = torch.cat([leaf.reshape(lead + (-1,)).to(torch.float32)
                          for leaf in leaves], dim=-1)
        sendable, new_state = self._defer_schedule(self._padded(flat), state)
        # the inner compressor sees ONE flat vector
        summed, inner_state = self.inner.allreduce_leaf(
            sendable, state["inner"], axis_name, axis_size)
        new_state["inner"] = inner_state
        out, off = {}, 0
        for name, leaf in zip(names, leaves):
            size = math.prod(leaf.shape[REPLICA_DIMS:])
            out[name] = summed[..., off:off + size].reshape(leaf.shape) \
                .to(leaf.dtype)
            off += size
        return out, new_state

    def wire_bytes_leaf(self, leaf: torch.Tensor) -> int:
        """Amortized bytes a sync: ``k`` of the blocks on each of
        ``flush_every - 1`` steps, every block on the drain."""
        inner_bytes = self.inner.wire_bytes_leaf(leaf)
        f = self.flush_every
        frac = (min(1.0, self.k) * (f - 1) + 1.0) / f
        return int(inner_bytes * frac)
