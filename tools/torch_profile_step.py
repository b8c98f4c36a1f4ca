#!/usr/bin/env python3
"""Where one training step of the PyTorch port spends its time on the card.

    python3 tools/torch_profile_step.py [--steps 5] [--batch 128] [--out F]

Runs the main path of chip_smoke.py (ResNet-20 at bf16 on the HiPS [2, 4]
replica axes, FSA with bucketed "bsc,0.01", sgd(0.1, momentum=0.9), the
synthetic CIFAR-shaped set) for three warm-up steps, times --steps steps
with the host clock (ending in a synchronize), then runs --steps more
under torch.profiler (CPU and CUDA activities) and reports:

- the step time without and with the profiler;
- the device busy share: the union of kernel intervals over the profiled
  wall time, and the same busy time over the unprofiled step;
- for each span of the step (train/forward_backward, train/sync_grads,
  bucket/flatten, bsc/select_pack, ...): host ms a step, the span's
  length on the device timeline and the kernel time inside it;
- the kernels with the most device time.

Needs a CUDA device; exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SPANS = ("train/forward_backward", "train/sync_grads", "bucket/flatten",
         "dc_allreduce/bucket0", "bsc/threshold", "bsc/select_pack",
         "bsc/scatter_add", "bucket/unflatten", "train/optimizer",
         "train/sync_model_state")


def busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=128,
                    help="images a replica a step")
    ap.add_argument("--out", help="write the report to this JSON file")
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_profile_step: no CUDA device", file=sys.stderr)
        return 2
    from geomx_tpu_torch import GeoConfig, HiPSTopology
    from geomx_tpu_torch.data import load_dataset
    from geomx_tpu_torch.models import get_model
    from geomx_tpu_torch.ops import _build
    from geomx_tpu_torch.optim import sgd
    from geomx_tpu_torch.train import Trainer

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _build.kernels()
    trainer = Trainer(get_model("resnet20"), HiPSTopology(2, 4),
                      sgd(0.1, momentum=0.9),
                      config=GeoConfig(num_parties=2, workers_per_party=4,
                                       compression="bsc,0.01"))
    need = 8 * args.batch * (3 + 2 * args.steps)
    data = load_dataset("synthetic", synthetic_train_n=need)
    loader = trainer.make_loader(data["train_x"], data["train_y"],
                                 args.batch)
    batches = iter(loader.epoch(0))
    state = trainer.init_state(seed=0)

    def run(n):
        nonlocal state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            state, metrics = trainer.train_step(state, *next(batches))
        float(metrics["loss"])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n

    run(3)
    step_s = run(args.steps)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_step_s = run(args.steps)
    events = prof.events()
    kern = [e for e in events if e.device_type == DeviceType.CUDA
            and not e.is_user_annotation]
    intervals = sorted((e.time_range.start, e.time_range.end) for e in kern)
    wall_us = prof_step_s * args.steps * 1e6
    by_name: dict = {}
    for e in kern:
        d = by_name.setdefault(e.name, [0.0, 0])
        d[0] += e.time_range.elapsed_us()
        d[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    spans = {}
    for name in SPANS:
        host = [e for e in events if e.name == name
                and e.device_type == DeviceType.CPU]
        # the span's interval on the device timeline, and the kernel time
        # inside it (kernels the autograd thread launched included)
        dev = [e.time_range for e in events if e.name == name
               and e.device_type == DeviceType.CUDA]
        if host:
            spans[name] = dict(
                host_ms_per_step=sum(e.cpu_time_total for e in host)
                / args.steps / 1e3,
                device_span_ms_per_step=sum(r.end - r.start for r in dev)
                / args.steps / 1e3,
                device_busy_ms_per_step=sum(
                    busy_us([(max(s, r.start), min(e, r.end))
                             for s, e in intervals
                             if s < r.end and e > r.start]) for r in dev)
                / args.steps / 1e3,
                calls_per_step=len(host) / args.steps)
    busy = busy_us(intervals)
    report = dict(
        card=card, batch_per_replica=args.batch,
        samples_per_step=8 * args.batch, steps=args.steps,
        step_ms=step_s * 1e3, samples_per_s=8 * args.batch / step_s,
        profiled_step_ms=prof_step_s * 1e3,
        kernels_per_step=len(kern) / args.steps,
        device_busy_ms_per_step=busy / args.steps / 1e3,
        # the profiler slows the host; the card's work does not change,
        # so busy time over the unprofiled step estimates the real share
        device_busy_share_profiled=busy / wall_us if kern else None,
        device_busy_share_est=busy / args.steps / 1e6 / step_s
        if kern else None,
        spans=spans,
        top_kernels=[dict(name=n[:120], ms_per_step=v[0] / args.steps / 1e3,
                          calls_per_step=v[1] / args.steps)
                     for n, v in top])
    print(json.dumps(report, indent=1), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
