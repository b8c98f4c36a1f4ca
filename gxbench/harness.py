"""The benchmark's command line: one run of one cell, one result line.

    python3 gxbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Exits 3 without as many CUDA devices as the cell asks for, and 4 if JAX,
flax or the JAX package is loaded once the window has closed; neither
prints a result.  Otherwise the last line of standard output is one JSON
object: ``correct``, ``attempted`` (the window's steps), ``failed`` (those
whose loss was not finite), ``metrics`` (the cell's end-to-end metrics
with ``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number the
correctness check compared, with its limit.  The same numbers close
standard error, one a line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from dataclasses import dataclass
from types import ModuleType
from typing import List, Optional

from gxbench.cell import HERE, ROOT, load_cell
from gxbench.reference.layout import Layout

FORBIDDEN = ("jax", "jaxlib", "flax", "geomx_tpu")
CACHE = os.path.join(ROOT, "build", "gxbench_cache")


@dataclass
class Run:
    """What a metric's reader reads (``gxbench/metrics/<metric>.py``)."""

    config: dict
    workload: dict
    counts: ModuleType
    peak: Optional[dict]       # the card's row of peaks.json
    out: object                # training.Outcome
    bucket_sizes: List[int]    # the dc tier's buckets (reference layout)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (compared whole: the port's name only begins with it)."""
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


def peak_of(card: str) -> Optional[dict]:
    with open(os.path.join(HERE, "peaks.json")) as f:
        table = json.load(f)["cards"]
    return table.get(card)


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", "-i", "0"], capture_output=True,
            text=True, timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out or None


def main(argv, t0: float) -> int:
    ap = argparse.ArgumentParser(description="one run of a benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the workload file states the configuration: no GEOMX_* knob of the
    # environment reaches the program
    for key in [k for k in os.environ if k.startswith("GEOMX_")]:
        del os.environ[key]
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")

    cell = load_cell(args.workload)
    import torch
    chips = cell.entry["chips"]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"gxbench: {cell.name} needs {chips} CUDA device(s), found "
              f"{have}", file=sys.stderr)
        return 3
    out = execute(cell, args.seed, args.seconds, bool(args.trace),
                  torch.device("cuda", 0), t0)
    found = forbidden_modules()
    if found:
        print("gxbench: loaded after the window: " + ", ".join(found),
              file=sys.stderr)
        return 4
    result, lines = out
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


def execute(cell, seed: int, seconds: float, trace: bool, device, t0: float,
            fault=None):
    """Run the cell on ``device`` (``fault``: planted, ``faults.py``) and
    assemble ``(result, stderr lines)``; the look for a chip is the
    caller's."""
    import torch

    from gxbench import compare, training
    out = training.run(cell, seed, seconds, trace, device, t0, fault)
    cuda = torch.device(device).type == "cuda"
    card = torch.cuda.get_device_name(device) if cuda else "cpu"
    shapes = {n: s for n, s, _, _ in cell.reference.param_specs(cell.config)}
    run = Run(config=cell.config, workload=cell.workload, counts=cell.counts,
              peak=peak_of(card), out=out,
              bucket_sizes=Layout(shapes,
                                  cell.workload["bucket_bytes"]).bucket_sizes)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct, checks = compare.judge(out.readings, cell.workload["limits"])
    correct = correct and out.failed == 0 and out.steps > 0
    limit = power_limit() if cuda else None
    device_doc = {"platform": "gpu" if cuda else "cpu", "kind": card,
                  "count": cell.entry.get("chips", 1),
                  "memory_peak_bytes": out.memory_peak_bytes,
                  "power_limit": limit}
    result = {"correct": correct, "attempted": out.steps,
              "failed": out.failed, "metrics": metrics, "device": device_doc}
    if trace:
        device_doc["busy_s"] = out.trace.busy_us() / 1e6
        device_doc["window_s"] = out.trace.wall_us / 1e6
        result["breakdown"] = out.trace.breakdown()
    result["checks"] = checks
    lines = [f"{name} {m['value']!r} {m['unit']} (power.limit {limit})"
             for name, m in metrics.items()]
    ms = sorted(t * 1e3 for t in out.step_s)
    if ms:
        q = [ms[int(f * (len(ms) - 1))] for f in (0.0, 0.25, 0.5, 0.75, 1.0)]
        lines.append(f"window {out.steps} steps in {out.window_s!r} s; step "
                     f"ms min/q1/median/q3/max {q}; the first five "
                     f"{[round(t * 1e3, 2) for t in out.step_s[:5]]}")
    lines += [f"{name} worst at {r['leaf']}"
              for name, r in out.readings.items() if r.get("leaf")]
    lines += [f"{name} {c['value']!r} limit {c['limit']!r}"
              for name, c in checks.items()]
    return result, lines
