#!/usr/bin/env python3
"""Repeat chip_smoke.py's host-plane jobs to measure their spread.

    python3 tools/torch_dist_ps_repeat.py --root build/parent --root . \\
        --path dist_ps_mixed_sched --repeats 4 --out rep.json

Runs ``dist_ps_phase`` of each ``--root``'s ``chip_smoke.py`` (a
checkout, e.g. a ``git archive`` of another commit) in turns — A, B, B,
A, ... — on the card, and records every run's wall time, round time and
each worker's last test accuracy.  It records; it does not gate: the
accuracy floor of ``chip_smoke.py`` is reported beside each run, not
enforced (``DIST_PS_JAX_MIXED_LOWEST_MIN``, or in an older checkout
``DIST_PS_JAX_MIXED_TEST_ACC``, is lowered to -1 in the loaded
copies), so a run under the floor is counted instead of ending the
series.  Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys


def load(root: str):
    """``chip_smoke.py`` of ``root`` as a module of its own, with that
    checkout's package first on the import path."""
    root = os.path.abspath(root)
    spec = importlib.util.spec_from_file_location(
        f"chip_smoke_{abs(hash(root))}", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(root: str, path: str) -> dict:
    """One job from ``root`` in a fresh interpreter (each checkout's
    package imports under the same name)."""
    root = os.path.abspath(root)
    code = (
        "import json, sys, torch\n"
        f"sys.path.insert(0, {os.path.abspath(os.path.dirname(__file__))!r})\n"
        "from torch_dist_ps_repeat import load\n"
        f"m = load({root!r})\n"
        # the floor under either name: a checkout from before the
        # lowest-worker gate holds the JAX job's mean less 0.05
        "new = hasattr(m, 'DIST_PS_JAX_MIXED_LOWEST_MIN')\n"
        "floor = m.DIST_PS_JAX_MIXED_LOWEST_MIN if new else "
        "m.DIST_PS_JAX_MIXED_TEST_ACC - 0.05\n"
        "setattr(m, 'DIST_PS_JAX_MIXED_LOWEST_MIN' if new else "
        "'DIST_PS_JAX_MIXED_TEST_ACC', -1.0)\n"
        f"r = m.dist_ps_phase(torch, {path!r})\n"
        "print('RESULT ' + json.dumps({'floor': floor, **{k: r[k] for k in "
        "('wall_s', 'round_ms_median', 'last_test_acc') if k in r}}))\n")
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=root,
                         timeout=900)
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT ")]
    if out.returncode or not line:
        raise SystemExit(f"{root}: rc {out.returncode}\n{out.stdout[-3000:]}"
                         f"\n{out.stderr[-3000:]}")
    res = json.loads(line[0][len("RESULT "):])
    res["root"] = root
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", action="append", required=True)
    ap.add_argument("--path", default="dist_ps_mixed_sched")
    ap.add_argument("--repeats", type=int, default=2,
                    help="rounds of the A, B, B, A turn")
    ap.add_argument("--out")
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    order = []
    for _ in range(args.repeats):
        order += args.root + args.root[::-1]
    runs = []
    for root in order:
        r = run(root, args.path)
        low = min(r["last_test_acc"].values())
        print(f"{root}: wall {r['wall_s']:.2f} s, round "
              f"{r['round_ms_median']:.2f} ms, last test_acc "
              f"{r['last_test_acc']} (min {low:.3f}; floor "
              f"{r['floor']:.3f}{'' if low >= r['floor'] else ', UNDER'})",
              flush=True)
        runs.append(r)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "path": args.path, "runs": runs}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
