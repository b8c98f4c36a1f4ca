"""Bi-Sparse (BSC) select/pack and scatter-add (port of
geomx_tpu/ops/bsc_pallas.py).

``select_pack``
    ``u' = 0.9u + g; v' = v + u'``; against the sampled boundary
    ``thr``, emit exactly ``k`` (value, index) pairs per row — elements
    with ``|v'| > thr`` in ascending index order, then ties
    ``|v'| == thr`` in ascending index order, then ``(0.0, -1)``
    sentinels — and zero ``u'``/``v'`` at the emitted coordinates.  The
    wire format is byte-identical to the JAX package's.
``scatter_add``
    The decompress: the dense sum of all gathered pairs, negative
    indices dropped, folding the pairs run by run in order.

Each function takes ``[*B, n]`` rows (the replica axes ride in ``B``).
On CUDA tensors ``select_pack`` and ``scatter_add`` launch the
hand-written kernels of ``csrc/bsc.cu`` and raise if they fail; on CPU
tensors they run the plain PyTorch versions beside them, which follow
the JAX op order.  ``sampled_boundary_guv`` stays in PyTorch ops on
every device.  ``select_pack.launches`` and ``scatter_add.launches``
count kernel launches: one a call each (select/pack is one single-pass
kernel, after a memset of its scratch).

Rounding: the plain versions round after every multiply, and so does
the kernel (``__fmul_rn``/``__fadd_rn``).  XLA on the CPU contracts
``u * 0.9 + g`` into an FMA under ``jit``, so bit-for-bit comparisons
with the JAX package hold where ``0.9 * u`` is exact (``u`` zero or a
signed power of two), as in the parity tests.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from geomx_tpu_torch.ops.bucket import on_cuda
from geomx_tpu_torch.ops.sampled_topk import (boundary_position,
                                              probe_positions,
                                              sampled_threshold_select)

MOMENTUM = 0.9  # gc.cc:200 — must match compression/bisparse.py


def sampled_boundary_guv(g: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                         k: int, sample: int = 8192,
                         positions: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """The sampled magnitude boundary of ``|v + (0.9u + g)|`` computed
    from the ~``sample`` probe positions only (the dense corrected
    tensor lives only inside ``select_pack``).  ``[*B, n]`` -> ``[*B]``.
    ``positions`` may pass :func:`probe_positions` already on the
    device."""
    n = g.shape[-1]
    if positions is None:
        positions = probe_positions(n, sample, g.device)
    samp = (v[..., positions] + (u[..., positions] * MOMENTUM
                                 + g[..., positions])).abs()
    ssorted = samp.sort(dim=-1).values
    return ssorted[..., boundary_position(ssorted.shape[-1], k, n)]


def _check_rows(*ts: torch.Tensor) -> None:
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"expected float32, got {t.dtype}")
        if t.shape != ts[0].shape:
            raise ValueError("g, u, v differ in shape")


def select_pack_plain(g, u, v, thr, k: int):
    """The jnp sampled path of compression/bisparse.py with a given
    boundary: ``(vals [*B, k], idx [*B, k] int32, new_u, new_v)``."""
    u2 = u * MOMENTUM + g
    v2 = v + u2
    vals, idx, keep = sampled_threshold_select(v2, v2.abs(), k, thr=thr)
    zero = torch.zeros((), dtype=v2.dtype, device=v2.device)
    return vals, idx, torch.where(keep, zero, u2), torch.where(keep, zero, v2)


def select_pack(g: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                thr, k: int):
    """Fused momentum + boundary select + fixed-k pack + EF reset.

    ``g``, ``u``, ``v``: fp32 ``[*B, n]`` of any layout (copied to
    dense rows when they are not); ``thr``: the boundary, a scalar or
    ``[*B]``; ``k``: the slots a row.  Returns ``(vals [*B,
    k], idx [*B, k] int32, new_u [*B, n], new_v [*B, n])``."""
    _check_rows(g, u, v)
    k = int(k)
    if not on_cuda([g, u, v]):
        return select_pack_plain(g, u, v, thr, k)
    from geomx_tpu_torch.ops._build import kernels
    batch, n = tuple(g.shape[:-1]), g.shape[-1]
    # the kernel reads dense rows: a broadcast or gathered view (a
    # collective's result) is copied first, as scatter_add copies
    g, u, v = (t.contiguous() for t in (g, u, v))
    rows = math.prod(batch)
    thr = torch.as_tensor(thr, dtype=torch.float32, device=g.device)
    thr = thr.expand(batch).reshape(rows).contiguous()
    ext = kernels()
    dev = g.device
    scratch = torch.empty(ext.select_scratch(rows, n), dtype=torch.int32,
                          device=dev)
    tie_vals = torch.empty(rows * k, dtype=torch.float32, device=dev)
    tie_idx = torch.empty(rows * k, dtype=torch.int32, device=dev)
    new_u = torch.empty_like(g)
    new_v = torch.empty_like(g)
    vals = torch.empty(batch + (k,), dtype=torch.float32, device=dev)
    idx = torch.empty(batch + (k,), dtype=torch.int32, device=dev)
    ext.bsc_select_pack(g.reshape(rows, n), u.reshape(rows, n),
                        v.reshape(rows, n), thr, k, scratch, tie_vals,
                        tie_idx, new_u.view(rows, n), new_v.view(rows, n),
                        vals.view(rows, k), idx.view(rows, k))
    select_pack.launches += 1
    return vals, idx, new_u, new_v


select_pack.launches = 0


def _pairs(vals: torch.Tensor, idx: torch.Tensor, run: Optional[int]):
    if vals.shape != idx.shape:
        raise ValueError("vals and idx differ in shape")
    m = vals.shape[-1]
    run = m if run is None else int(run)
    if run <= 0 and m > 0:
        raise ValueError(f"run length must be > 0, got {run}")
    return m, max(run, 1)


def scatter_add_plain(vals, idx, n: int, run: Optional[int] = None):
    """``zeros(n).at[where(idx >= 0, idx, 0)].add(where(idx >= 0, vals,
    0))`` per row, one run of ``run`` pairs after another."""
    m, run = _pairs(vals, idx, run)
    batch = vals.shape[:-1]
    rows = math.prod(batch)
    v2 = vals.reshape(rows, m).to(torch.float32)
    i2 = idx.reshape(rows, m)
    valid = i2 >= 0
    safe = torch.where(valid, i2, 0).to(torch.int64)
    contrib = torch.where(valid, v2, torch.zeros((), dtype=torch.float32,
                                                 device=v2.device))
    out = torch.zeros(rows, n, dtype=torch.float32, device=v2.device)
    for s in range(0, m, run):
        out.scatter_add_(1, safe[:, s:s + run], contrib[:, s:s + run])
    return out.reshape(batch + (n,))


def scatter_add(vals: torch.Tensor, idx: torch.Tensor, n: int,
                run: Optional[int] = None) -> torch.Tensor:
    """Dense ``[*B, n]`` sum of the ``[*B, m]`` (value, index) pairs;
    negative indices are sentinels and add nothing.

    ``run``: the pairs fold in runs of ``run`` pairs, strictly in order
    (one run per party on the BSC wire, where indices are unique inside
    a run), which makes the sum deterministic for any party count.
    Default: one run.  On CUDA, pairs that collide inside one run add
    in an unspecified order — exact when at most two values meet at a
    coordinate (``0 + a + b``), as at two parties."""
    m, run = _pairs(vals, idx, run)
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if not on_cuda([vals, idx]):
        return scatter_add_plain(vals, idx, n, run)
    from geomx_tpu_torch.ops._build import kernels
    batch = tuple(vals.shape[:-1])
    rows = math.prod(batch)
    v2 = vals.reshape(rows, m).to(torch.float32).contiguous()
    i2 = idx.reshape(rows, m).contiguous()
    out = torch.empty(batch + (int(n),), dtype=torch.float32,
                      device=vals.device)
    kernels().bsc_scatter_add(v2, i2, run, out.view(rows, int(n)))
    scatter_add.launches += 1
    return out


scatter_add.launches = 0
