"""The readings a cell's correctness limits are set from (not part of a
benchmark run).

    python3 gxbench/calibrate.py --workload <cell> --seeds 1,2,3
        [--modes sound,control,half_batch,no_exchange,unchanged]
        [--out FILE]

For each seed, in one process: the benchmark's weights and first batches,
the float32 reference's first steps once, and then for each mode the
numbers of ``compare.py`` against that reference:

- ``sound``: the program's first steps, as a benchmark run makes them
  (the lower readings);
- ``control``: the reference itself put in the program's place, in the
  configuration's ``control_precision`` (one step below the precision
  the configuration states);
- a fault of ``faults.py``: the program's first steps with the fault
  planted.

No measured window: a training cell's readings need none.  Prints one
JSON line a (seed, mode), then the largest and smallest value of each
number by mode.  Exits 3 without a CUDA device: the limits are set from
the card's readings, never the CPU's.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from gxbench import compare, faults, training  # noqa: E402
from gxbench.reference import hips  # noqa: E402

MODES = ("sound", "control") + faults.FAULTS


def _free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def seed_readings(cell, seed: int, modes, device) -> dict:
    """``{mode: {number: value}}`` for one seed."""
    wl, cfg = cell.workload, cell.config
    start = training.inputs_for(cell, seed, device)
    batches = [start.feed.next() for _ in range(wl["check_steps"])]
    ref = hips.reference_steps(cell.reference, cfg, wl, start.params0,
                               batches, "fp32", start.state0)
    out = {}
    for mode in modes:
        t = time.perf_counter()
        if mode == "control":
            snap = compare.reference_as_program(hips.reference_steps(
                cell.reference, cfg, wl, start.params0, batches,
                cfg["control_precision"], start.state0))
        else:
            built = training.build(cell, seed, device)
            with faults.planted(None if mode == "sound" else mode,
                                built.trainer.train_step) as step:
                _, snap, _ = training.check_steps(step, built, wl)
            del built, step
            _free(device)
        got = compare.readings(snap, ref)
        out[mode] = {n: r["value"] for n, r in got.items()}
        out[mode]["leaf"] = {n: r["leaf"] for n, r in got.items() if r["leaf"]}
        out[mode]["seconds"] = time.perf_counter() - t
    return out


def main(argv=None) -> int:
    from gxbench.cell import load_cell
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default=",".join(MODES))
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gxbench: calibrate.py reads the card: no CUDA device",
              file=sys.stderr)
        return 3
    cell = load_cell(args.workload)
    device = torch.device("cuda", 0)
    modes = args.modes.split(",")
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        for mode, r in seed_readings(cell, seed, modes, device).items():
            rows.append({"seed": seed, "mode": mode, **r})
            print(json.dumps(rows[-1]), flush=True)
    names = [n for n in compare.NAMES if n in rows[0]]
    summary = {mode: {n: [max(r[n] for r in rows if r["mode"] == mode),
                          min(r[n] for r in rows if r["mode"] == mode)]
                      for n in names} for mode in modes}
    print(json.dumps({"max_min": summary}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "rows": rows,
                       "max_min": summary, "device": str(device),
                       "card": torch.cuda.get_device_name(0)}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
