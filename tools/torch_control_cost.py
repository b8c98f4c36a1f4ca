#!/usr/bin/env python3
"""Step time of path 1 with the control plane and the probes off and on,
in turns on one card.

    python3 tools/torch_control_cost.py [--steps 8] [--rounds 2] [--batch 128]
        [--device cuda] [--out chiprun_out/control_cost.json]

Builds four trainers of ``chip_smoke.py``'s path 1 (ResNet-20 at full
width on [2, 4], 128 a replica, ``sgd(0.1, momentum=0.9)`` per leaf,
``"bsc,0.01"``): ``off`` (neither), ``control`` (the control plane
alone, the scale at 0.5), ``telemetry`` (the probes alone) and
``both``.  Each round runs ``--steps`` steps of each, in the order off,
control, telemetry, both, both, telemetry, control, off, each step
timed on the host clock up to a read of its loss (the probes'
configurations read them too, as ``control_fsa`` does).  Prints, per
configuration, the median step ms, the launch calls of one step
(``chip_smoke._cuda_launches``) and the calls it adds to ``off`` by
ATen op, as one JSON object (also written to
``--out``).  ``--device cpu`` rehearses it on the CPU (no launch calls
there, and no time a reader may take for the card's).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

CONFIGS = {"off": {}, "control": dict(control=True),
           "telemetry": dict(telemetry=True),
           "both": dict(control=True, telemetry=True)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch
    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        print("torch_control_cost: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from geomx_tpu_torch.control import Decision
    from geomx_tpu_torch.data import load_dataset
    from geomx_tpu_torch.models import get_model
    from geomx_tpu_torch.telemetry.probes import host_probes

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip() if on_card else "cpu"
    data = load_dataset("synthetic",
                        synthetic_train_n=8 * args.batch * args.steps)
    trainers, states = {}, {}
    for name, fields in CONFIGS.items():
        t = cs.make_trainer("flagship", get_model("resnet20"),
                            device=args.device, **fields)
        st = t.init_state(seed=0)
        if fields.get("control"):
            st = t.apply_control(st, Decision(step=0, kind="ratio",
                                              value=0.005, prev=0.01,
                                              reason="scripted"))
        trainers[name], states[name] = t, st
    loader = trainers["off"].make_loader(data["train_x"], data["train_y"],
                                         args.batch)
    batches = [(x.clone(), y.clone()) for x, y in loader.epoch(0)]
    batches = batches[:args.steps]

    def step(name, i):
        t = trainers[name]
        states[name], m = t.train_step(states[name], *batches[i])
        if "telemetry" in m:
            host_probes(m["telemetry"])
        float(m["loss"])

    for name in CONFIGS:          # warm-up: cuDNN, the allocator
        step(name, 0)
    ms = {name: [] for name in CONFIGS}
    order = list(CONFIGS) + list(reversed(CONFIGS))
    for _ in range(args.rounds):
        for name in order:
            for i in range(args.steps):
                if on_card:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(name, i)
                ms[name].append(1e3 * (time.perf_counter() - t0))
    calls = {}
    for name in CONFIGS:
        calls[name], _ = cs._cuda_launches(torch, lambda: step(name, 0))
    base = collections.Counter(calls["off"])
    res = {"card": card, "steps": args.steps, "rounds": args.rounds,
           "configs": {name: {
               "step_ms_median": statistics.median(ms[name]),
               "step_ms": ms[name],
               "launch_calls_per_step": len(calls[name]),
               "added_launch_calls_by_op": dict(
                   collections.Counter(calls[name]) - base)}
               for name in CONFIGS}}
    for name, r in res["configs"].items():
        print(f"{name}: step {r['step_ms_median']:.2f} ms (median of "
              f"{len(r['step_ms'])}), {r['launch_calls_per_step']} launch "
              f"calls; added {r['added_launch_calls_by_op']}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps({k: v for k, v in res.items() if k != "configs"}
                     | {"median_ms": {n: r["step_ms_median"]
                                      for n, r in res["configs"].items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
