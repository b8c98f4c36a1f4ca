"""The needle-in-a-haystack token task of examples/long_context.py (the
port's own copy: the example imports the JAX package).

Each sequence is uniform noise tokens except one "needle" position whose
token encodes the label, a signal a mean-pool alone dilutes by ``1/L``.
Made from a seed with numpy, so both packages see the same sequences.
"""

from __future__ import annotations

import numpy as np


def make_needle_data(n: int, seq_len: int, num_classes: int = 10,
                     vocab: int = 256, seed: int = 0):
    """``(x [n, seq_len] int32, y [n] int32)``."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, num_classes, size=n).astype(np.int32)
    x = rng.randint(num_classes, vocab, size=(n, seq_len)).astype(np.int32)
    pos = rng.randint(0, seq_len, size=n)
    x[np.arange(n), pos] = y  # label tokens are 0..num_classes-1
    return x, y


def with_positions(tokens: np.ndarray) -> np.ndarray:
    """``[N, L]`` -> ``[N, L, 2]``: global positions beside the ids, so a
    sequence-sharded chunk still embeds the right positions."""
    n, L = tokens.shape
    pos = np.broadcast_to(np.arange(L, dtype=np.int32), (n, L))
    return np.stack([tokens, pos], axis=-1)
