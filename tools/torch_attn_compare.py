#!/usr/bin/env python3
"""Times the attention kernels of one checkout of the port on the card.

    python3 tools/torch_attn_compare.py [--root DIR] [--phases head_dim,paths]
                                        [--label NAME] [--verbose-build]
                                        --out FILE

Imports ``geomx_tpu_torch`` from DIR (default: this checkout), which builds
its kernels under DIR, and runs this checkout's ``chip_smoke.py`` phases on
them: ``head_dim`` is ``head_dim_phase()`` (rows 10-13 at head dim 256, the
wide route), ``paths`` is ``attention_kernels()`` (rows 10-13 at the paths'
shapes); each with its gates, timer and bounds.  To compare two checkouts on
one card, unpack the other (``git archive``) into a directory that
``.gitignore`` lists and run this script on both in turns in one call:
parent, change, change, parent.  Writes the kernels' times and the card's
name and power limit to FILE (JSON) and prints one line a kernel.  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="the checkout whose geomx_tpu_torch is timed")
    ap.add_argument("--phases", default="head_dim",
                    help="comma-separated: head_dim, paths")
    ap.add_argument("--label", default="", help="a name for the run")
    ap.add_argument("--out", required=True, help="JSON file to write")
    ap.add_argument("--verbose-build", action="store_true",
                    help="print the build's output (ptxas registers and "
                    "spills of every kernel)")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path[:0] = [root] + ([HERE] if HERE != root else [])
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    import geomx_tpu_torch
    from geomx_tpu_torch.ops import _build

    if not geomx_tpu_torch.__file__.startswith(root + os.sep):
        raise RuntimeError(f"geomx_tpu_torch came from "
                           f"{geomx_tpu_torch.__file__}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.kernels(verbose=args.verbose_build)
    dev = torch.device("cuda")
    phases = {"head_dim": chip_smoke.head_dim_phase,
              "paths": chip_smoke.attention_kernels}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    rec = dict(label=args.label, root=root, card=card,
               build_s=_build.build_seconds)
    print(f"{args.label} {card}; build {_build.build_seconds:.1f} s",
          flush=True)
    for name in args.phases.split(","):
        out = phases[name](torch, dev)
        rec[name] = {k: {f: r[f] for f in ("ms", "plain_ms", "library_ms",
                                           "bound_ms", "max_abs_err")}
                     for k, r in out.items()}
        for k, r in rec[name].items():
            print(f"{args.label} {name} {k}: {r['ms'] * 1e3:.1f} us "
                  f"(bound {r['bound_ms'] * 1e3:.2f}, plain "
                  f"{r['plain_ms'] * 1e3:.1f})", flush=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
