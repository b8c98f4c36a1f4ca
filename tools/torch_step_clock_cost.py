#!/usr/bin/env python3
"""The host cost of the port's step clock a training step, in µs, and
what the host takes to issue a step.

    python3 tools/torch_step_clock_cost.py [--reps 20000] [--steps 10]
        [--batches 1] [--device cuda] [--out chiprun_out/stepclock_cost.json]

Times, each as the median of seven rounds of ``--reps`` calls, the
rounds of the functions compared taken in turns: a bare
``record_function`` enter and exit; a ``utils/profiler.span`` enter and
exit outside any step, inside an open step record, and as a host range
(``annotation=False``) inside one; a step record's open and close (with
its two CUDA events on the card); and two event records alone.  The
clock's cost a step is its own spans (``train/train_step``,
``train/forward``, ``train/backward``, ``train/stack``,
``train/metrics``: host ranges) at their full cost, the older spans at
what a span adds to a bare ``record_function``, and one record's open
and close, with the spans counted over one step of the benchmark's
encoder cell (``lra_text.hips_bsc.l4096``; its CPU-sized cut with
``--device cpu``).

Then the step clock's medians over ``--steps`` steps (each ending in a
read of its loss, after three) of the cell at its own batch and at each
of ``--batches`` a replica: at a batch small enough that the card waits
for the host, the host's time is what it takes to issue a step; at the
cell's batch it may include waits for room in the card's launch queue.
Prints one JSON object (also written to ``--out``) with the card's name
and power limit.  ``--device cpu`` rehearses it (no events there, and no
time a reader may take for the card's host).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

CLOCK_SPANS = ("train/train_step", "train/forward", "train/backward",
               "train/stack", "train/metrics")
SEED = 2 ** 33 + 41


def per_call_us(fns: dict, reps: int) -> dict:
    """Median µs a call of each of ``fns``, their rounds in turns."""
    rounds = {k: [] for k in fns}
    for _ in range(7):
        for k, fn in fns.items():
            t0 = time.perf_counter_ns()
            for _ in range(reps):
                fn()
            rounds[k].append((time.perf_counter_ns() - t0) / reps / 1e3)
    return {k: statistics.median(v) for k, v in rounds.items()}


def micro(device, reps: int) -> dict:
    import torch
    from torch.profiler import record_function

    from geomx_tpu_torch.utils.profiler import StepClock, span, step_clock

    def bare():
        with record_function("clock/cost"):
            pass

    def spanned():
        with span("clock/cost"):
            pass

    def host_range():
        with span("clock/cost", annotation=False):
            pass

    out = per_call_us({"record_function_us": bare,
                       "span_outside_step_us": spanned}, reps)
    clock = step_clock()
    rec = clock.open(clock.new_fn(), device)
    try:
        out.update(per_call_us({"record_function_in_step_us": bare,
                                "span_in_step_us": spanned,
                                "host_range_in_step_us": host_range}, reps))
    finally:
        clock.close(rec)
    own = StepClock(ring=64)
    fn = own.new_fn()
    fns = {"record_open_close_us": lambda: own.close(own.open(fn, device))}
    if device.type == "cuda":
        stream = torch.cuda.current_stream(device)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))

        def two_events():
            a.record(stream)
            b.record(stream)
        fns["two_event_records_us"] = two_events
    out.update(per_call_us(fns, reps // 10))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out


def encoder_cell(device, batch=None):
    from gxbench.cell import load_cell
    from gxbench.tests.tiny import ENCODER, tiny_cell
    cell = load_cell(ENCODER) if device.type == "cuda" \
        else tiny_cell(ENCODER)
    if batch is not None:
        cell = dataclasses.replace(cell, workload={
            **cell.workload, "batch_per_replica": batch})
    return cell


def run_steps(device, batch, steps: int, count: bool) -> dict:
    """The clock's medians over ``steps`` steps at ``batch`` a replica
    (None: the cell's), after three; with ``count``, the spans one more
    step enters."""
    import torch

    from gxbench import training
    from geomx_tpu_torch.utils.profiler import span, step_records

    cell = encoder_cell(device, batch)
    start = training.build(cell, SEED, device)

    def step():
        x, y = start.feed.next()
        start.state, metrics = start.trainer.train_step(start.state, x, y)
        float(metrics["loss"])

    for _ in range(3 + steps):
        step()
    out = {"batch_per_replica": cell.workload["batch_per_replica"]}
    if count:
        calls: dict = {}
        enter = span.__enter__

        def counted(self):
            calls[self.name] = calls.get(self.name, 0) + 1
            return enter(self)

        span.__enter__ = counted
        try:
            step()
        finally:
            span.__enter__ = enter
        out["calls"] = calls
    recs = [r for r in step_records()
            if r.fn == start.trainer.train_step.clock_fn][3:3 + steps]
    names = sorted({k for r in recs for k in r.host_ns})
    out["host_ms"] = {k: statistics.median(r.host_ns.get(k, 0) / 1e6
                                           for r in recs) for k in names}
    out["wall_ms"] = statistics.median(r.wall_ns / 1e6 for r in recs)
    dev = [r.device_ms for r in recs if r.device_ms is not None]
    out["device_ms"] = statistics.median(dev) if dev else None
    del start
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def card_doc(device) -> dict:
    import torch
    if device.type != "cuda":
        return {"card": "cpu"}
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        limit = None
    return {"card": torch.cuda.get_device_name(device),
            "power_limit": limit}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20000)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batches", default="1",
                    help="comma-separated batches a replica besides the "
                         "cell's")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="chiprun_out/stepclock_cost.json")
    args = ap.parse_args(argv)
    import torch
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 2
        device = torch.device("cuda", device.index or 0)
    doc = card_doc(device)
    doc["micro"] = m = micro(device, args.reps)
    doc["steps"] = [run_steps(device, None, args.steps, count=True)]
    doc["steps"] += [run_steps(device, int(b), args.steps, count=False)
                     for b in args.batches.split(",") if b]
    calls = doc["steps"][0]["calls"]
    own = sum(n for k, n in calls.items() if k in CLOCK_SPANS)
    old = sum(n for k, n in calls.items() if k not in CLOCK_SPANS)
    added = m["span_in_step_us"] - m["record_function_in_step_us"]
    doc["per_step"] = {
        "clock_spans": own, "older_spans": old,
        "clock_spans_us": own * m["host_range_in_step_us"],
        "older_spans_added_us": old * added,
        "record_us": m["record_open_close_us"],
        "clock_us": own * m["host_range_in_step_us"] + old * added
        + m["record_open_close_us"]}
    text = json.dumps(doc, indent=1, sort_keys=True)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
