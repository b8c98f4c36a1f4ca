"""GeoMX's hierarchical training step, written plainly, for any family's
loss: the reference the benchmark holds the program's first steps to.

A step on the ``[P, W]`` replicas (P parties of W workers):

1. every replica computes its loss and gradient on its own batch;
2. the worker tier: each party's gradient is the mean of its workers';
3. the dc tier under Bi-Sparse compression ("bsc,<ratio>"): each party
   lays its gradient out in the flat buckets (``layout.py``) and, per
   bucket of ``n`` elements, keeps DGC momentum ``u = 0.9 u + g`` and
   velocity ``v = v + u``, finds the magnitude boundary from a fixed probe
   of ``min(n, 8192)`` positions ``(i * 2654435761) mod n`` (the probe's
   sorted value at ``round(m (1 - k / n))``, ``k = ceil(ratio n)``), sends
   the coordinates above the boundary in index order, then those equal to
   it, at most ``k`` of them, and zeroes ``u`` and ``v`` where it sent;
   the dense sum of every party's pairs divided by ``P`` is the gradient
   every replica applies.  A bucket under 1,024 elements, or "none", is
   averaged densely;
4. the optimizer: SGD with momentum (``trace = g + m trace; p -= lr
   trace``) or Adam (``mu``, ``nu``, bias corrections ``1 - b ** t``,
   ``p -= lr (mu / bc1) / (sqrt(nu / bc2) + eps)``).

Running statistics (batch normalization's): each replica keeps
``m s + (1 - m) batch_stat`` (``m``: the configuration's
``bn_momentum``), and the step replaces every replica's by the mean over
the replicas (the worker mean, then the party mean).

Every replica holds the same weights after each step, so the reference
keeps one copy of them and one dc-tier state a party.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from gxbench.reference.layout import Layout

MOMENTUM = 0.9
SAMPLE = 8192
WEYL = 2654435761
MIN_SPARSE = 1024


def parse_dc(spec: str):
    """``"none"`` -> None; ``"bsc,<ratio>"`` -> the ratio."""
    parts = [s.strip() for s in str(spec).split(",")]
    if parts[0] == "none":
        return None
    if parts[0] != "bsc" or len(parts) != 2:
        raise ValueError(f"the reference runs 'none' or 'bsc,<ratio>', "
                         f"not {spec!r}")
    return float(parts[1])


def boundary(absv: torch.Tensor, k: int) -> torch.Tensor:
    n = absv.numel()
    m = min(n, SAMPLE)
    probe = (torch.arange(m, dtype=torch.int64) * WEYL) % n
    ranked = absv[probe.to(absv.device)].sort().values
    return ranked[min(max(int(round(m * (1.0 - k / n))), 0), m - 1)]


def compress(g, u, v, k: int):
    """One party's bucket: ``(indices, values, u', v')``."""
    u = u * MOMENTUM + g
    v = v + u
    a = v.abs()
    thr = boundary(a, k)
    sel = torch.cat([torch.nonzero(a > thr).flatten(),
                     torch.nonzero(a == thr).flatten()])[:k]
    vals = v[sel]
    u = u.index_fill(0, sel, 0.0)
    v = v.index_fill(0, sel, 0.0)
    return sel, vals, u, v


def dc_mean(party: List[Dict[str, torch.Tensor]], state, layout: Layout,
            ratio) -> Dict[str, torch.Tensor]:
    """The dc tier over the parties' gradients; updates ``state`` (a list
    a party of ``(u, v)`` a bucket) in place."""
    P = len(party)
    flats = [layout.flatten(g) for g in party]
    out = []
    for b, n in enumerate(layout.bucket_sizes):
        if ratio is None or n < MIN_SPARSE:
            agg = sum(flats[p][b] for p in range(P))
        else:
            k = max(1, math.ceil(n * ratio))
            agg = torch.zeros(n, dtype=torch.float32,
                              device=flats[0][b].device)
            for p in range(P):
                sel, vals, u, v = compress(flats[p][b], *state[p][b], k)
                state[p][b] = (u, v)
                agg.index_add_(0, sel, vals)
        out.append(agg / P)
    return layout.unflatten(out)


class Optimizer:
    def __init__(self, spec: dict, params: Dict[str, torch.Tensor]):
        self.spec = spec
        self.kind = spec["kind"]
        self.t = 0
        zeros = {k: torch.zeros_like(v) for k, v in params.items()}
        if self.kind == "sgd":
            self.trace = zeros
        elif self.kind == "adam":
            self.mu = zeros
            self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        else:
            raise ValueError(f"unknown optimizer {self.kind!r}")

    def step(self, params, grads):
        s = self.spec
        lr = s["learning_rate"]
        self.t += 1
        if self.kind == "sgd":
            m = s.get("momentum", 0.0)
            self.trace = {k: grads[k] + m * self.trace[k] for k in params}
            return {k: params[k] - lr * self.trace[k] for k in params}
        b1, b2 = s.get("b1", 0.9), s.get("b2", 0.999)
        eps = s.get("eps", 1e-8)
        self.mu = {k: (1 - b1) * grads[k] + b1 * self.mu[k] for k in params}
        self.nu = {k: (1 - b2) * grads[k] * grads[k] + b2 * self.nu[k]
                   for k in params}
        bc1, bc2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        return {k: params[k] - lr * (self.mu[k] / bc1)
                / (torch.sqrt(self.nu[k] / bc2) + eps) for k in params}


def _norms(tree) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tree.items()}


def reference_steps(family, cfg: dict, workload: dict,
                    params0: Dict[str, torch.Tensor], batches,
                    mode: str = "fp32", state0=None) -> dict:
    """Follow the program's first ``len(batches)`` steps from ``params0``
    (and the running statistics ``state0``).

    ``batches``: ``(x, y)`` a step, each ``[P, W, B, ...]``.  Returns the
    mean loss of each step, the norm by leaf of the gradient the optimizer
    got at the first step, of the change of the weights after the last,
    of the largest replica-mean raw gradient over the steps (for the rule
    that leaves out leaves that round-off alone would move), and the
    running statistics after the first step."""
    P, W = workload["topology"]
    ratio = parse_dc(workload["dc_compression"])
    params = {k: v.detach().float().clone() for k, v in params0.items()}
    layout = Layout({k: v.shape for k, v in params.items()},
                    workload["bucket_bytes"])
    device = next(iter(params.values())).device
    state = [[(torch.zeros(n, device=device), torch.zeros(n, device=device))
              for n in layout.bucket_sizes] for _ in range(P)]
    opt = Optimizer(workload["optimizer"], params)
    losses, raw_max, first = [], {k: 0.0 for k in params}, None
    state1, m = None, cfg.get("bn_momentum")
    for x, y in batches:
        party, total, loss_sum, stat_sum = [], None, 0.0, {}
        for p in range(P):
            gp = None
            for w in range(W):
                loss, g, stats = family.loss_and_grads(
                    params, x[p, w], y[p, w], cfg, mode)
                loss_sum += float(loss)
                for k, v in stats.items():
                    stat_sum[k] = stat_sum.get(k, 0.0) + v
                gp = g if gp is None else {k: gp[k] + g[k] for k in g}
            total = gp if total is None else {k: total[k] + gp[k]
                                               for k in gp}
            party.append({k: gp[k] / W for k in gp})
        losses.append(loss_sum / (P * W))
        for k, nrm in _norms({k: t / (P * W) for k, t in
                              total.items()}).items():
            raw_max[k] = max(raw_max[k], nrm)
        g = dc_mean(party, state, layout, ratio)
        if first is None:
            first = _norms(g)
            state1 = {k: m * state0[k] + (1 - m) * v / (P * W)
                      for k, v in stat_sum.items()}
        params = opt.step(params, g)
    change = _norms({k: params[k] - params0[k].float() for k in params})
    return {"loss": losses, "first_grad": first, "change": change,
            "raw_grad": raw_max, "state": state1,
            "state_kept": {k: m * state0[k] for k in state1}}
