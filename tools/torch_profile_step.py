#!/usr/bin/env python3
"""Where one training step of the PyTorch port spends its time on the card.

    python3 tools/torch_profile_step.py [--path flagship] [--steps 5]
        [--batch 128] [--out F]

Runs one training path of chip_smoke.py (ResNet-20 at bf16 on the path's
replica axes, FSA with a bucketed dc tier, the synthetic CIFAR-shaped
set; --path flagship: [2, 4], "bsc,0.01" with sgd(0.1, momentum=0.9),
fused_sgd: the same with the fused optimizer apply, twobit_adam:
[2, 4], "2bit,0.5" with the fused Adam(0.01), sparse_agg: [4, 2], the
owner-routed "bsc,0.01,select=sampled,sparse_agg=1" with the fused
SGD; mixed_dcasgd, hfa_dgt and pipelined_fsa: chip_smoke.py's MixedSync
with DCASGD, HFA over DGT and pipelined FSA paths; zero_sgd,
zero_pipelined_adam and multigps_bsc: its sharded-update paths (ZeRO
over the bucket, with the fused Adam and the pipeline; MultiGPS over
the leaves of 1,000 elements or more); cnn_bsc: GeoCNN on the
MNIST-shaped set, adam(0.01), "bsc,0.01", batch 32 a replica;
alexnet_fused_adam: AlexNet with the fused Adam(0.01) and "bsc,0.01" on
a device-cached loader, batch 32 a replica; seq_flash and seq_ring:
chip_smoke.py's attention paths, the SeqClassifier on the needle task,
--batch sequences a replica, 16 by default) for three warm-up steps, times --steps steps
with the host clock (ending in a synchronize), then runs --steps more
under torch.profiler (CPU and CUDA activities) and reports:

- the step time without and with the profiler;
- the device busy share: the union of kernel intervals over the profiled
  wall time, and the same busy time over the unprofiled step;
- for each span of the step (train/forward_backward, train/sync_grads,
  bucket/flatten, bsc/select_pack, ...): host ms a step, the span's
  length on the device timeline and the kernel time inside it;
- the kernels with the most device time, and those named by --kernel.

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

SPANS = ("train/forward_backward", "attention/forward",
         "attention/backward", "train/sync_grads", "bucket/flatten",
         "dc_allreduce/bucket0", "dc_allreduce/bucket0_shard",
         "dc_pipeline/launch", "dc_pipeline/apply",
         "bsc/threshold", "bsc/select_pack",
         "sparseagg/route", "sparseagg/merge", "sparseagg/reselect",
         "bsc/scatter_add", "twobit/quantize", "twobit/dequantize",
         "bucket/unflatten", "train/optimizer", "train/sync_model_state")


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
    ap.add_argument("--path", default="flagship",
                    choices=("flagship", "fused_sgd", "twobit_adam",
                             "sparse_agg", "mixed_dcasgd", "hfa_dgt",
                             "pipelined_fsa", "zero_sgd",
                             "zero_pipelined_adam", "multigps_bsc",
                             "cnn_bsc", "alexnet_fused_adam",
                             "seq_flash", "seq_ring"))
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=None,
                    help="images (sequences) a replica a step: 128, 32 "
                    "for cnn_bsc and alexnet_fused_adam (16)")
    ap.add_argument("--kernel", action="append", default=[],
                    help="also report the device ms and calls a step of "
                    "the kernels whose name holds this string")
    ap.add_argument("--out", help="write the report to this JSON file")
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_profile_step: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import (SEQ_PATHS, make_seq_trainer, make_trainer,
                            path_data)
    from geomx_tpu_torch.data import make_needle_data, with_positions
    from geomx_tpu_torch.ops import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _build.kernels()
    if args.path in SEQ_PATHS:
        sp_mode, shape, seq_len, batch = SEQ_PATHS[args.path][:4]
        args.batch = args.batch or batch
        trainer = make_seq_trainer(sp_mode, shape, seq_len)
        replicas = shape[0] * shape[1]
        x, y = make_needle_data(
            replicas * args.batch * (3 + 2 * args.steps), seq_len)
        loader = trainer.make_loader(with_positions(x), y, args.batch)
        sample = None
    else:
        zoo = args.path in ("cnn_bsc", "alexnet_fused_adam")
        args.batch = args.batch or (32 if zoo else 128)
        trainer = make_trainer(args.path)
        replicas = 8
        need = replicas * args.batch * (3 + 2 * args.steps)
        data = path_data(args.path, need)
        loader = trainer.make_loader(
            data["train_x"], data["train_y"], args.batch,
            device_cache=args.path == "alexnet_fused_adam")
        sample = data["train_x"][:2]
    batches = iter(loader.epoch(0))
    state = trainer.init_state(seed=0, sample_input=sample)

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
        card=card, path=args.path, batch_per_replica=args.batch,
        samples_per_step=replicas * args.batch, steps=args.steps,
        step_ms=step_s * 1e3, samples_per_s=replicas * args.batch / step_s,
        profiled_step_ms=prof_step_s * 1e3,
        kernels_per_step=len(kern) / args.steps,
        device_busy_ms_per_step=busy / args.steps / 1e3,
        # the profiler slows the host; the card's work does not change,
        # so busy time over the unprofiled step estimates the real share
        device_busy_share_profiled=busy / wall_us if kern else None,
        device_busy_share_est=busy / args.steps / 1e6 / step_s
        if kern else None,
        spans=spans,
        kernels={sub: dict(
            ms_per_step=sum(v[0] for n, v in by_name.items() if sub in n)
            / args.steps / 1e3,
            calls_per_step=sum(v[1] for n, v in by_name.items() if sub in n)
            / args.steps) for sub in args.kernel},
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
