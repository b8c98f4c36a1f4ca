"""2-bit quantize / dequantize (port of geomx_tpu/ops/twobit_pallas.py).

``quantize_2bit``
    ``acc = g + r``; code 1 where ``acc >= thr``, 2 where ``acc <=
    -thr``, else 0; the new residual ``acc - sent`` with ``sent`` the
    code's value in {0, +thr, -thr} (error feedback); 16 codes packed
    into one int32 word.
``dequantize_2bit``
    The inverse, codes -> {0, +thr, -thr}; with ``summed=True`` the sum
    of several parties' parts in party order, one fp32 add a party.

The wire format is the Pallas kernel's, bit for bit: elements in rows of
2048, word ``(row, lane)`` packs elements ``row*2048 + lane + 128*j`` at
bits ``2j`` (lane-strided), ``ceil(n/2048)*128`` words with zero codes
in the padding; a code 2 at ``j = 15`` sets the int32 sign bit.  The
port uses this one format on every device.

Each function takes ``[*B, n]`` rows (the replica axes ride in ``B``).
``threshold`` is a Python float rounded once to fp32.  On CUDA tensors
the wrappers launch the kernels of ``csrc/twobit.cu`` and raise if they
fail; on CPU tensors they run the plain PyTorch versions beside them.
``quantize_2bit.launches`` and ``dequantize_2bit.launches`` count
kernel launches.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from geomx_tpu_torch.ops.bucket import on_cuda

LANES = 128
PACK = 16
BLOCK_COLS = PACK * LANES  # 2048 elements -> 128 words


def num_words(n: int) -> int:
    """Packed int32 words for ``n`` elements: ``ceil(n/2048) * 128``."""
    return max(1, -(-int(n) // BLOCK_COLS)) * LANES


def _thr32(threshold: float) -> float:
    if not threshold > 0:
        raise ValueError("threshold must be greater than 0")
    return float(np.float32(threshold))


def _shifts(device) -> torch.Tensor:
    return (2 * torch.arange(PACK, dtype=torch.int64, device=device)).view(
        PACK, 1)


def quantize_2bit_plain(g: torch.Tensor, r: torch.Tensor, threshold: float):
    """``(packed [*B, words] int32, new_r [*B, n] fp32)``."""
    thr = _thr32(threshold)
    batch, n = tuple(g.shape[:-1]), g.shape[-1]
    acc = g + r
    codes = torch.where(acc >= thr, 1, torch.where(acc <= -thr, 2, 0))
    sent = torch.where(codes == 1, thr, torch.where(codes == 2, -thr, 0.0))
    new_r = acc - sent
    words = num_words(n)
    blocks = codes.to(torch.int64)
    blocks = F.pad(blocks, (0, words * PACK - n)).view(
        batch + (words // LANES, PACK, LANES))
    packed = (blocks << _shifts(g.device)).sum(-2)  # codes never overlap
    packed = torch.where(packed >= 2 ** 31, packed - 2 ** 32, packed)
    return packed.to(torch.int32).reshape(batch + (words,)), new_r


def dequantize_2bit_plain(packed: torch.Tensor, n: int, threshold: float,
                          summed: bool = False) -> torch.Tensor:
    """``[*B, words]`` -> ``[*B, n]``; ``summed``: ``[*B, A, words]`` ->
    the sum of the ``A`` parts, ``((p_0 + p_1) + p_2) + ...``."""
    thr = _thr32(threshold)
    lead, words = tuple(packed.shape[:-1]), packed.shape[-1]
    w = packed.to(torch.int64).view(lead + (words // LANES, 1, LANES))
    codes = (w >> _shifts(packed.device)) & 3
    vals = torch.where(codes == 1, thr, torch.where(codes == 2, -thr, 0.0))
    vals = vals.to(torch.float32).reshape(lead + (-1,))[..., :n]
    if not summed:
        return vals
    out = vals[..., 0, :]
    for a in range(1, vals.shape[-2]):
        out = out + vals[..., a, :]
    return out


def _rows(t: torch.Tensor, dtype) -> torch.Tensor:
    if t.dtype != dtype:
        raise TypeError(f"expected {dtype}, got {t.dtype}")
    return t.contiguous()


def quantize_2bit(g: torch.Tensor, r: torch.Tensor, threshold: float):
    """Quantize ``g + r`` with error feedback: ``(packed [*B, words]
    int32, new_r [*B, n] fp32)``, ``words = ceil(n/2048) * 128``."""
    if g.shape != r.shape:
        raise ValueError("g and r differ in shape")
    if not on_cuda([g, r]):
        return quantize_2bit_plain(g, r, threshold)
    from geomx_tpu_torch.ops._build import kernels
    g, r = _rows(g, torch.float32), _rows(r, torch.float32)
    batch, n = tuple(g.shape[:-1]), g.shape[-1]
    rows = math.prod(batch)
    packed = torch.empty(batch + (num_words(n),), dtype=torch.int32,
                         device=g.device)
    new_r = torch.empty_like(g)
    kernels().quantize_2bit(g.view(rows, n), r.view(rows, n),
                            _thr32(threshold), packed.view(rows, -1),
                            new_r.view(rows, n))
    quantize_2bit.launches += 1
    return packed, new_r


quantize_2bit.launches = 0


def dequantize_2bit(packed: torch.Tensor, n: int, threshold: float,
                    summed: bool = False) -> torch.Tensor:
    """Packed ``[*B, words]`` int32 -> fp32 ``[*B, n]``.  ``summed``:
    ``packed`` is ``[*B, A, words]``, one part a party, and the result
    is their sum in party order, dequantized and summed in one launch."""
    words = packed.shape[-1]
    if words != num_words(n):
        raise ValueError(f"{words} words do not hold {n} elements "
                         f"(expected {num_words(n)})")
    if not on_cuda([packed]):
        return dequantize_2bit_plain(packed, n, threshold, summed)
    from geomx_tpu_torch.ops._build import kernels
    packed = _rows(packed, torch.int32)
    if not summed:
        packed = packed.unsqueeze(-2)
    batch, parts = tuple(packed.shape[:-2]), packed.shape[-2]
    rows = math.prod(batch)
    out = torch.empty(batch + (int(n),), dtype=torch.float32,
                      device=packed.device)
    kernels().dequantize_2bit(packed.view(rows, parts, words), int(n),
                              _thr32(threshold), out.view(rows, int(n)))
    dequantize_2bit.launches += 1
    return out


dequantize_2bit.launches = 0
