#!/usr/bin/env python3
"""Repeat the JAX package's mixed host-plane job on the CPU and record
the spread of its lowest worker's last test accuracy.

    python3 tools/torch_jax_mixed_repeat.py --repeats 12 --out rep.json

The job is ``chip_smoke.py``'s ``dist_ps_mixed_sched`` as the JAX
package runs it: ``scripts/launch.py`` + ``examples/dist_ps.py`` with
``GEOMX_USE_SCHEDULER=1 GEOMX_SYNC_MODE=mixed``, 2 parties x 2 workers,
the shape of ``DIST_PS_SHAPE`` (3 epochs, batch 64, lr 0.1), every
process on the CPU.  Each run's four last test accuracies are kept; the
summary gives the count, min, median, mean and max of the lowest one,
the statistic ``chip_smoke.py``'s gate compares the port's lowest worker
with (``DIST_PS_JAX_MIXED_LOWEST_MIN``).  Runs one after another, on free
ports.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import socket
import statistics
import subprocess
import sys
import time

SHAPE = dict(parties=2, workers=2, epochs=3, batch=64, lr=0.1)


def free_ports(n: int) -> list:
    """``n`` distinct ports the kernel hands out now (closed again)."""
    socks = []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def run_once(root: str) -> dict:
    gport, lport, sport = free_ports(3)
    env = dict(os.environ)
    env.update({
        "JAX_PLATFORMS": "cpu",
        "GEOMX_SYNC_MODE": "mixed", "GEOMX_USE_SCHEDULER": "1",
        "GEOMX_EPOCHS": str(SHAPE["epochs"]),
        "GEOMX_BATCH": str(SHAPE["batch"]), "GEOMX_LR": str(SHAPE["lr"]),
        "GEOMX_PS_GLOBAL_PORT": str(gport), "GEOMX_PS_PORT": str(lport),
        "GEOMX_SCHEDULER_PORT": str(sport)})
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "scripts/launch.py",
         "--num-parties", str(SHAPE["parties"]),
         "--workers-per-party", str(SHAPE["workers"]), "--",
         sys.executable, "examples/dist_ps.py"],
        cwd=root, env=env, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    accs = {}
    for p, w, _ep, acc in re.findall(
            r"\[worker p(\d+)w(\d+)\] epoch (\d+) train_acc \S+ "
            r"test_acc ([\d.]+)", proc.stdout):
        accs.setdefault(f"p{p}w{w}", []).append(float(acc))
    n = SHAPE["parties"] * SHAPE["workers"]
    if proc.returncode != 0 or len(accs) != n or any(
            len(a) != SHAPE["epochs"] for a in accs.values()):
        raise SystemExit(f"rc {proc.returncode}, accuracies {accs}\n"
                         f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    last = {k: a[-1] for k, a in sorted(accs.items())}
    return {"wall_s": wall, "last_test_acc": last,
            "lowest": min(last.values())}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--out")
    args = ap.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    runs = []
    for i in range(args.repeats):
        r = run_once(root)
        runs.append(r)
        print(f"run {i}: lowest {r['lowest']:.3f} {r['last_test_acc']} "
              f"({r['wall_s']:.1f} s)", flush=True)
    lows = sorted(r["lowest"] for r in runs)
    every = sorted(a for r in runs for a in r["last_test_acc"].values())
    summary = {"count": len(lows), "min": lows[0],
               "median": statistics.median(lows),
               "mean": statistics.mean(lows), "max": lows[-1],
               "all_workers_mean": statistics.mean(every),
               "lowest_sorted": lows}
    out = {"job": "JAX dist_ps mixed + scheduler, CPU", "shape": SHAPE,
           "runs": runs, "lowest_worker": summary}
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
