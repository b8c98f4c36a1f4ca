"""The numbers that decide ``correct`` for a training cell.

The program runs its first steps through the window's own call and feed;
the reference (``gxbench/reference/``) follows the same steps from the
same weights and batches.  Every number below is computed; a workload
holds to a limit (``limits`` in its file) the ones that separate its sound
runs from its control and its faults (``calibrate.py``), and
``correct`` needs each of those at or under its limit.  A number that is
not finite fails.

- ``loss_gap``: over the first steps, the largest ``|L_prog - L_ref| /
  |L_ref|`` of the step's mean loss; ``loss1_gap``: the first step's
  alone (a forward pass only);
- ``grad_gap``: the gradient the optimizer got at the first step (the
  program's worked out from its optimizer state after that step: SGD's
  trace, Adam's ``mu / (1 - b1)``), by leaf and replica, the worst
  ``|norm_prog - norm_ref| / max(norm_ref, median)``, where ``median`` is
  the median reference norm over the leaves whose reference norm is not
  0; ``grad_gap_median``: the median leaf's gap;
- ``change_gap``: the same of the weights' change after the first steps,
  over the leaves whose largest replica-mean raw reference gradient over
  those steps is at least a thousandth of the median leaf's (a leaf under
  that moves by round-off alone); ``change_gap_median``: the median
  leaf's gap;
- ``stat_gap`` (a model with running statistics): those statistics after
  the first step, all as one vector, ``|s_prog - s_ref| / |s_ref - m s0|``
  of the worst replica (``m s0``: the share of the initial statistics
  both keep).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict

import torch

NAMES = ("loss_gap", "loss1_gap", "grad_gap", "grad_gap_median",
         "change_gap", "change_gap_median", "stat_gap")
ROUNDOFF_SHARE = 1e-3


def replica_norms(tree: Dict[str, torch.Tensor], lead: int = 2
                  ) -> Dict[str, torch.Tensor]:
    """The norm of each leaf of each replica, ``[*lead dims]``, left on
    the device."""
    return {k: torch.linalg.vector_norm(
        v.detach().reshape(tuple(v.shape[:lead]) + (-1,)).double(), dim=-1)
        for k, v in tree.items()}


def _leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, float],
               names) -> Dict[str, float]:
    """Each leaf's worst replica ``|norm_prog - norm_ref| / max(norm_ref,
    median)``."""
    nonzero = [ref[k] for k in names if ref[k] > 0]
    med = statistics.median(nonzero) if nonzero else 0.0
    out = {}
    for k in names:
        den = max(ref[k], med)
        diff = float((prog[k].cpu().double() - ref[k]).abs().max())
        if den == 0.0:
            out[k] = 0.0 if diff == 0.0 else math.inf
        else:
            out[k] = diff / den
    return out


def _gap(prog, ref, names):
    """The worst leaf's gap and its name (a NaN counts as the worst)."""
    worst, where = 0.0, None
    for k, g in _leaf_gaps(prog, ref, names).items():
        if not g <= worst:
            worst, where = g, k
    return worst, where


def _median_gap(prog, ref, names):
    return statistics.median(_leaf_gaps(prog, ref, names).values())


def readings(prog: dict, ref: dict) -> Dict[str, dict]:
    """``prog``: ``{"loss": [...], "first_grad": {leaf: [P, W] norms},
    "change": {leaf: [P, W] norms}}``; ``ref``: ``reference_steps``'s
    output.  Returns ``{name: {"value", "leaf"}}``."""
    loss = max(abs(p - r) / abs(r) if r else math.inf
               for p, r in zip(prog["loss"], ref["loss"]))
    if any(not math.isfinite(p) for p in prog["loss"]):
        loss = math.nan
    loss1 = abs(prog["loss"][0] - ref["loss"][0]) / abs(ref["loss"][0])
    names, kept = sorted(ref["first_grad"]), kept_leaves(ref)
    grad, grad_leaf = _gap(prog["first_grad"], ref["first_grad"], names)
    change, change_leaf = _gap(prog["change"], ref["change"], kept)
    out = {"loss_gap": {"value": loss, "leaf": None},
           "loss1_gap": {"value": loss1, "leaf": None},
           "grad_gap": {"value": grad, "leaf": grad_leaf},
           "change_gap": {"value": change, "leaf": change_leaf}}
    out["grad_gap_median"] = {"value": _median_gap(
        prog["first_grad"], ref["first_grad"], names), "leaf": None}
    out["change_gap_median"] = {"value": _median_gap(
        prog["change"], ref["change"], kept), "leaf": None}
    if ref["state"]:
        out["stat_gap"] = {"value": _stat_gap(prog["state"], ref["state"],
                                              ref["state_kept"]),
                           "leaf": None}
    return out


def _stat_gap(prog, ref, kept):
    """The running statistics after the first step, all leaves as one
    vector: the worst replica's ``|s_prog - s_ref| / |s_ref - m s0|``,
    where ``m s0`` (``kept``) is the share of the initial statistics both
    keep."""
    names = sorted(ref)
    r = torch.cat([ref[k].double().flatten() for k in names])
    base = torch.cat([kept[k].double().flatten() for k in names])
    p = torch.cat([prog[k].double().flatten(2) for k in names], dim=-1)
    diff = (p.cpu() - r.cpu()).norm(dim=-1)
    return float(diff.max()) / float((r - base).norm())


def kept_leaves(ref: dict) -> list:
    """The leaves ``change_gap`` compares (module docstring)."""
    med = statistics.median(ref["raw_grad"].values())
    return [k for k in sorted(ref["raw_grad"])
            if ref["raw_grad"][k] >= ROUNDOFF_SHARE * med]


def judge(values: Dict[str, dict], limits: Dict[str, float]):
    """``(correct, checks)``: ``checks`` maps each number the workload
    holds to a limit to its value and limit, in ``NAMES`` order."""
    checks = {n: {"value": values[n]["value"], "limit": limits[n]}
              for n in NAMES if n in limits}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def reference_as_program(ref: dict) -> dict:
    """A reference run's output in the program's snapshot form (the
    control: the reference put in the program's place)."""
    def one(tree):
        return {k: torch.tensor([[v]], dtype=torch.float64)
                for k, v in tree.items()}

    return {"loss": list(ref["loss"]), "first_grad": one(ref["first_grad"]),
            "change": one(ref["change"]),
            "state": {k: v[None, None] for k, v in ref["state"].items()}}
