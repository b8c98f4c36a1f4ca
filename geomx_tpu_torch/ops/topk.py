"""Deterministic top-k with ``lax.top_k``'s order (plain PyTorch).

``lax.top_k`` returns the ``k`` largest values in descending order under
IEEE total order (``+0.0`` above ``-0.0``) and, among equal values, the
lower index first.  ``torch.topk`` promises no order among ties, so the
port takes the first ``k`` of a stable descending sort of the values'
total-order integer keys, which keeps equal values in index order.  Used
by the exact BSC selection and the owner re-selection of the sparse
merge.
"""

from __future__ import annotations

import torch


def _total_order_key(x: torch.Tensor) -> torch.Tensor:
    """int32 keys that sort fp32 values in IEEE total order."""
    bits = x.contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def top_k(x: torch.Tensor, k: int):
    """``(values [*B, k], indices [*B, k] int32)`` of the ``k`` largest
    entries of each fp32 ``[*B, n]`` row; ties go to the lower index."""
    if x.dtype != torch.float32:
        raise TypeError(f"top_k takes float32, got {x.dtype}")
    _, order = torch.sort(_total_order_key(x), dim=-1, descending=True,
                          stable=True)
    order = order[..., :k]
    return x.gather(-1, order), order.to(torch.int32)
