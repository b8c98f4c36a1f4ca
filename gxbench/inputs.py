"""What the benchmark hands both the program and the reference: the
initial weights and every step's batch, made on the device from
``--seed``.

Weights: one normal draw on the device for all random leaves, cut into
views and scaled by leaf (``he``: ``sqrt(2 / fan_in)``, ``lecun``:
``sqrt(1 / fan_in)``, ``embed``: the width's inverse square root), then
the constant leaves (``ones``, ``zeros``).  Batches: a generator on the
device draws each step's inputs and labels as uniform integers in the
workload's ranges, a new batch every step; the same seed gives the same
weights and the same batches in the same order.  A part marked
``sorted`` is sorted along each replica's batch: a training step's
arithmetic does not depend on the order of a replica's samples, but a
step that dropped part of the batch would then see a skewed share of the
labels, not a random half.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

_DTYPES = {"uint8": torch.uint8, "int32": torch.int32, "int64": torch.int64}


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of ``seed`` (any whole number)."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF,
             int(seed) < 0] + [ord(c) for c in tag]
    return int(np.random.SeedSequence(words).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def _std(init: str, fan_in: int, shape: Sequence[int]) -> float:
    if init == "he":
        return math.sqrt(2.0 / fan_in)
    if init == "lecun":
        return math.sqrt(1.0 / fan_in)
    if init == "embed":
        return shape[-1] ** -0.5
    raise ValueError(f"unknown init {init!r}")


def make_tree(specs, seed: int, tag: str, device
              ) -> Dict[str, torch.Tensor]:
    """Float32 leaves from ``(name, shape, init, fan_in)`` specs."""
    random = [s for s in specs if s[2] not in ("ones", "zeros")]
    total = sum(math.prod(s[1]) for s in random)
    flat = torch.randn(total, generator=generator(seed, tag, device),
                       device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape, init, fan_in in random:
        n = math.prod(shape)
        out[name] = flat[off:off + n].view(tuple(shape)) \
            .mul_(_std(init, fan_in, shape))
        off += n
    for name, shape, init, _ in specs:
        if init == "ones":
            out[name] = torch.ones(tuple(shape), device=device)
        elif init == "zeros":
            out[name] = torch.zeros(tuple(shape), device=device)
    return out


class Feed:
    """Each step's ``(x, y)``, ``[P, W, batch, *sample_shape]``, drawn on
    the device."""

    def __init__(self, workload: dict, seed: int, device):
        P, W = workload["topology"]
        lead = (P, W, workload["batch_per_replica"])
        self.parts = []
        for key in ("x", "y"):
            spec = workload["data"][key]
            self.parts.append((lead + tuple(spec["sample_shape"]),
                               int(spec["high"]), _DTYPES[spec["dtype"]],
                               bool(spec.get("sorted", False))))
        self.gen = generator(seed, "data", device)
        self.device = device

    def next(self) -> Tuple[torch.Tensor, torch.Tensor]:
        out = []
        for shape, high, dtype, ordered in self.parts:
            t = torch.randint(0, high, shape, dtype=dtype,
                              generator=self.gen, device=self.device)
            out.append(t.sort(dim=2).values if ordered else t)
        return tuple(out)
