#!/usr/bin/env python3
"""The training loop's step time with and without the prefetch thread.

    python3 tools/torch_prefetch_compare.py [--paths flagship,mixed_dcasgd]
        [--steps 16] [--rounds 1] [--out F]

Runs each path of chip_smoke.py through ``Trainer.fit`` (its
``main_path_phase``, ResNet-20 at bf16, batch 128 a replica, TF32 off)
with ``GeoConfig.prefetch`` 0 (batches assembled and copied in the
loop's thread), 2 (the default: a producer thread two batches ahead),
2 and 0 again, in that order in one process, ``--rounds`` times, and
reports each run's median step ms and samples/s, and each setting's
median over its runs.

Needs a CUDA device; exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--paths", default="flagship,mixed_dcasgd")
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=1,
                    help="repeat the 0, 2, 2, 0 order this many times")
    ap.add_argument("--out", help="write the report to this JSON file")
    args = ap.parse_args(argv)

    import statistics

    import torch
    if not torch.cuda.is_available():
        print("torch_prefetch_compare: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import main_path_phase
    from geomx_tpu_torch.ops import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _build.kernels()
    report = {"card": card, "runs": []}
    for path in args.paths.split(","):
        steps = {0: [], 2: []}
        for prefetch in (0, 2, 2, 0) * args.rounds:
            r = main_path_phase(torch, path, args.steps, prefetch=prefetch)
            row = dict(path=path, prefetch=prefetch,
                       step_ms_median=r["step_ms_median"],
                       samples_per_s=r["samples_per_s"])
            steps[prefetch].append(r["step_ms_median"])
            report["runs"].append(row)
            print(json.dumps(row), flush=True)
        summary = {f"prefetch_{p}_step_ms_median": statistics.median(v)
                   for p, v in steps.items()}
        report[path] = summary
        print(json.dumps(dict(path=path, **summary)), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
