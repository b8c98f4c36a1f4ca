#!/usr/bin/env python3
"""How exactly torch.profiler counts what one training step puts on the card.

    python3 tools/torch_profiler_records.py [--reps 8] [--batch 128]

Builds chip_smoke.py's path 1f twice (ResNet-20 on [2, 4], "bsc,0.01",
the fused SGD): once as it is and once with the step-probe collector
patched to raise (telemetry off, so it must never run).  Profiles one
step of each, alternately, --reps times, and prints for every window the
host's launch calls (chip_smoke._cuda_launches: the CUDA runtime and
driver calls that enqueue kernels, copies and fills, each with its ATen
op) and the device's activity records.  Exits 1 if any window's launch
calls differ from the first's, in count or order; the device records
are printed, not checked.

Needs a CUDA device; exits 2 without one.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--batch", type=int, default=128)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("torch_profiler_records: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from geomx_tpu_torch.data import load_dataset
    from geomx_tpu_torch.models import get_model
    from geomx_tpu_torch.ops import _build
    from geomx_tpu_torch.telemetry import probes

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    _build.kernels()
    data = load_dataset("synthetic", synthetic_train_n=8 * args.batch)

    def build():
        t = cs.make_trainer("fused_sgd", get_model("resnet20"))
        t.init_state(seed=0)
        return t

    def raises(*a, **k):
        raise AssertionError("probe collector ran on the disabled path")

    plain = build()
    x, y = next(iter(plain.make_loader(data["train_x"], data["train_y"],
                                       args.batch).epoch(0)))
    saved = (probes.collect_step_probes, probes.inline_collection)
    probes.collect_step_probes = probes.inline_collection = raises
    try:
        probe_free = build()
        steps = {}
        for name, t in (("off", plain), ("probe-free", probe_free)):
            st = t.init_state(seed=0)
            steps[name] = lambda t=t, st=st: t.train_step(st, x, y)
            steps[name]()                             # warm-up
        first, differ = None, 0
        for rep in range(args.reps):
            for name, fn in steps.items():
                calls, records = cs._cuda_launches(torch, fn)
                first = first or calls
                differ += calls != first
                print(f"rep {rep} {name}: {len(calls)} launch calls "
                      f"({'the first window' if calls == first else 'DIFFER'}"
                      f"), {len(records)} device records", flush=True)
    finally:
        probes.collect_step_probes, probes.inline_collection = saved
    print(f"launch calls: {differ} of {2 * args.reps} windows differ from "
          "the first", flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
