"""Roofline & MFU accounting of the training step (port of
geomx_tpu/telemetry/roofline.py).

- :func:`roofline_record` grades a measured step time against the three
  rooflines that can bound it — peak compute, memory bandwidth, and the
  WAN wire (bytes from ``sync.wire_accounting``) — and names the binding
  resource; :func:`publish_roofline` exports it as registry gauges.
  Both carry over from the JAX package unchanged.
- :func:`trainer_roofline` counts the step's FLOPs with
  ``torch.utils.flop_counter.FlopCounterMode`` over one step (the JAX
  package reads ``compiled.cost_analysis()``).  PyTorch has no
  bytes-accessed analysis of an eager step, so ``hbm_bytes`` is None
  and the memory roofline drops out of the verdict (``roofline_record``
  grades only the resources it knows).
- The device table holds one row, the H100 SXM (the module
  ``torch.cuda.get_device_name`` calls "NVIDIA H100 80GB HBM3"): dense
  bf16 989.4e12 FLOP/s and HBM3 3.35e12 B/s, both from NVIDIA's H100
  SXM data sheet.  A device the table lacks (the CPU, another card)
  falls back to :func:`calibrate_peak_flops`, a measured matmul rate.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

# peak dense bf16 FLOP/s by device-name substring (NVIDIA H100 SXM data
# sheet, without sparsity)
PEAK_BF16 = (
    ("h100 80gb hbm3", 989.4e12),
)

# HBM bandwidth by device-name substring, bytes/s (the same data sheet)
HBM_BYTES_PER_S = (
    ("h100 80gb hbm3", 3.35e12),
)


def _lookup(table, device_kind: str) -> Optional[float]:
    dk = (device_kind or "").lower()
    for sub, val in table:
        if sub in dk:
            return val
    return None


def peak_flops(device_kind: str) -> Optional[float]:
    return _lookup(PEAK_BF16, device_kind)


def peak_hbm_bytes_per_s(device_kind: str) -> Optional[float]:
    return _lookup(HBM_BYTES_PER_S, device_kind)


def calibrate_peak_flops(n: int = 512, reps: int = 3,
                         device=None) -> float:
    """Measured fp32 matmul FLOP/s on ``device`` (default the CPU) — the
    *effective* peak where no published number exists.  An MFU against
    this calibration reads as "fraction of what this machine's best
    dense kernel achieves"."""
    import time

    import torch

    dev = torch.device(device if device is not None else "cpu")
    a = torch.ones((n, n), dtype=torch.float32, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    a @ a  # warm-up
    sync()
    best = math.inf
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        a @ a
        sync()
        best = min(best, time.perf_counter() - t0)
    return (2.0 * n ** 3) / best


def roofline_record(*, flops: Optional[float],
                    step_time_s: float,
                    peak_flops_per_s: Optional[float],
                    hbm_bytes: Optional[float] = None,
                    hbm_bytes_per_s: Optional[float] = None,
                    wire_bytes: Optional[float] = None,
                    wire_bytes_per_s: Optional[float] = None
                    ) -> Dict[str, Any]:
    """Grade one step against the three rooflines.

    Per-resource lower-bound times are ``t_compute = flops/peak``,
    ``t_memory = hbm_bytes/hbm_bw``, ``t_wire = wire_bytes/wire_bw``
    (each only when both numerator and rate are known); the verdict
    names the largest — the resource whose roofline the measured step
    cannot beat.  ``mfu`` is achieved FLOP/s over peak,
    ``arithmetic_intensity`` is FLOPs per HBM byte, and
    ``ridge_flops_per_byte`` (peak/bw) locates the measured intensity
    on the classic roofline: below the ridge the memory roof is the
    binding one at full utilization.
    """
    if step_time_s <= 0:
        raise ValueError(f"step_time_s must be > 0 (got {step_time_s!r})")
    rec: Dict[str, Any] = {
        "flops_per_step": flops, "step_time_s": step_time_s,
        "peak_flops_per_s": peak_flops_per_s,
        "hbm_bytes_per_step": hbm_bytes,
        "wire_bytes_per_step": wire_bytes,
    }
    achieved = (flops / step_time_s) if flops else None
    rec["achieved_flops_per_s"] = achieved
    rec["mfu"] = (achieved / peak_flops_per_s
                  if achieved and peak_flops_per_s else None)
    rec["arithmetic_intensity"] = (flops / hbm_bytes
                                   if flops and hbm_bytes else None)
    rec["ridge_flops_per_byte"] = (
        peak_flops_per_s / hbm_bytes_per_s
        if peak_flops_per_s and hbm_bytes_per_s else None)

    bounds: Dict[str, float] = {}
    if flops and peak_flops_per_s:
        bounds["compute"] = flops / peak_flops_per_s
    if hbm_bytes and hbm_bytes_per_s:
        bounds["memory"] = hbm_bytes / hbm_bytes_per_s
    if wire_bytes and wire_bytes_per_s:
        bounds["wire"] = wire_bytes / wire_bytes_per_s
    rec["bound_times_s"] = bounds
    if bounds:
        verdict = max(bounds, key=lambda k: bounds[k])
        rec["bound"] = f"{verdict}_bound"
        ordered = sorted(bounds.values(), reverse=True)
        # dominance of the verdict over the runner-up: 1.0 = ties, big =
        # unambiguous.  With one resource known there is no runner-up.
        rec["bound_dominance"] = (ordered[0] / ordered[1]
                                  if len(ordered) > 1 and ordered[1] > 0
                                  else None)
        # fraction of the measured step the binding resource explains —
        # <1 always (the roofline is a lower bound); near 1 means the
        # step runs at that roofline, small means overhead elsewhere
        rec["bound_explains_fraction"] = min(
            bounds[verdict] / step_time_s, 1.0)
    else:
        rec["bound"] = "unknown"
        rec["bound_dominance"] = None
        rec["bound_explains_fraction"] = None
    return rec


def publish_roofline(rec: Dict[str, Any], registry=None) -> None:
    """Export a roofline record as registry gauges: ``geomx_mfu``,
    ``geomx_arithmetic_intensity``, ``geomx_roofline_bound{bound=...}``
    (one-hot over the three verdicts) and the per-resource lower-bound
    times ``geomx_roofline_bound_seconds{resource=...}``."""
    from geomx_tpu_torch.telemetry.registry import get_registry
    reg = registry if registry is not None else get_registry()
    if rec.get("mfu") is not None:
        reg.gauge("geomx_mfu",
                  "Model FLOPs utilization of the measured step").set(
            float(rec["mfu"]))
    if rec.get("arithmetic_intensity") is not None:
        reg.gauge("geomx_arithmetic_intensity",
                  "Step FLOPs per HBM byte accessed").set(
            float(rec["arithmetic_intensity"]))
    fam = reg.gauge("geomx_roofline_bound",
                    "1 on the resource verdict bounding the step",
                    ("bound",))
    for b in ("compute_bound", "memory_bound", "wire_bound"):
        fam.labels(bound=b).set(1.0 if rec.get("bound") == b else 0.0)
    fam_t = reg.gauge("geomx_roofline_bound_seconds",
                      "Per-resource roofline lower bound on step time",
                      ("resource",))
    for res, t in (rec.get("bound_times_s") or {}).items():
        fam_t.labels(resource=res).set(float(t))


def trainer_roofline(trainer, state, xb, yb, step_time_s: float,
                     device_kind: Optional[str] = None,
                     wire_seconds: Optional[float] = None
                     ) -> Dict[str, Any]:
    """Roofline record for a live trainer: FLOPs from one step run on
    ``state`` (its result discarded) under
    ``torch.utils.flop_counter.FlopCounterMode``, which counts the ops
    with a FLOP formula (matmuls, convolutions, attention; the
    hand-written kernels and element-wise ops add none); no HBM bytes
    (module docstring); wire bytes from the sync algorithm's static
    accounting; peaks from the device table (or a calibration on the
    trainer's device when the table has no row).  ``wire_seconds``:
    measured/injected per-step WAN time — when given, the wire roofline
    uses the *achieved* rate (wire_bytes/wire_seconds)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        trainer.train_step(state, xb, yb)
    flops = float(counter.get_total_flops())
    device = torch.device(trainer.device)
    if device_kind is None:
        device_kind = torch.cuda.get_device_name(device) \
            if device.type == "cuda" else "cpu"
    peak = peak_flops(device_kind)
    hbm_bw = peak_hbm_bytes_per_s(device_kind)
    calibrated = False
    if peak is None:
        peak = calibrate_peak_flops(device=device)
        calibrated = True
    wire = float((trainer.sync.wire_accounting(state.params) or {}).get(
        "dc_wire_bytes", 0.0)) or None
    wire_bw = (wire / wire_seconds
               if wire and wire_seconds and wire_seconds > 0 else None)
    rec = roofline_record(
        flops=flops or None, step_time_s=step_time_s,
        peak_flops_per_s=peak, hbm_bytes=None,
        hbm_bytes_per_s=hbm_bw, wire_bytes=wire,
        wire_bytes_per_s=wire_bw)
    rec["device_kind"] = device_kind
    rec["peak_calibrated"] = calibrated
    # no bytes-accessed analysis of an eager PyTorch step
    rec["cost_analysis_available"] = False
    return rec
