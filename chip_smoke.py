#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (geomx_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json] [--steps 32] [--verbose-build]

Every phase's failure is fatal (non-zero exit, no result line):

1. card    -- ``nvidia-smi --query-gpu=name,power.limit`` as it prints it;
2. build   -- the CUDA kernels of geomx_tpu_torch/csrc, built at first use;
3. kernels -- each hand-written kernel against its plain PyTorch version on
              the card, at the flagship shapes (the ResNet-20 gradient tree
              on the [2, 4] replica axes: one 272,512-element bucket,
              k = ceil(0.01 n), two parties) and on the edge cases of the
              CPU parity tests; all four must be bit-equal.  Each kernel's
              median device time over 50 calls (CUDA events, L2 flushed
              between calls), its plain version's time, one PyTorch call
              computing the same function where there is one, and the
              bytes bound at the card's 3.35 TB/s;
4. reference -- two fp32 training steps of a small ResNet on the card and on
              the CPU (plain versions) from the same weights and batches:
              losses to rtol 1e-4, parameters to atol 2e-3 (TF32 off);
5. main path -- Trainer(get_model("resnet20"), HiPSTopology(2, 4),
              sgd(0.1, momentum=0.9), FSA + "bsc,0.01") at its default bf16
              compute on the synthetic CIFAR-shaped set, 128 images a
              replica (1,024 a step), 32 steps; finite loss, falling from
              the first epoch of 8 steps to the second; replicas
              identical; every kernel launched (launch counts reset just
              before the run and read just after); samples/s.

The two last lines are the ``kernels`` JSON object and the result line
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 2 and
prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
REPLACES = {
    "fused_flatten": ("geomx_tpu_torch/csrc/bucket.cu",
                      "geomx_tpu/ops/bucket_pallas.py:92"),
    "fused_unflatten": ("geomx_tpu_torch/csrc/bucket.cu",
                        "geomx_tpu/ops/bucket_pallas.py:134"),
    "bsc_select_pack": ("geomx_tpu_torch/csrc/bsc.cu",
                        "geomx_tpu/ops/bsc_pallas.py:223"),
    "bsc_scatter_add": ("geomx_tpu_torch/csrc/bsc.cu",
                        "geomx_tpu/ops/bsc_pallas.py:332"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def device_ms(torch, fn, reps: int = 50) -> float:
    """Median device time of ``fn()`` in ms over ``reps`` calls.  The card
    first spins on a sleep kernel while the host enqueues every call
    bracketed by events, so host overhead does not show; a 64 MB memset
    between calls evicts the 50 MB L2, so inputs come from device memory."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    torch.cuda._sleep(400_000_000)
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def max_err(torch, got, ref) -> float:
    """0.0 when bit-equal; raises otherwise."""
    for a, b in zip(got, ref):
        if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
            diff = (a.double() - b.double()).abs().max().item() \
                if a.shape == b.shape else math.inf
            raise AssertionError(f"kernel and plain version differ "
                                 f"(max abs err {diff})")
    return 0.0


def kernel_phase(torch, dev, timer=None):
    """Kernel parity and timings; ``timer(fn)`` defaults to device_ms."""
    timer = timer or (lambda fn: device_ms(torch, fn))
    from geomx_tpu_torch.compression import BiSparseCompressor
    from geomx_tpu_torch.compression.bucketing import GradientBucketer
    from geomx_tpu_torch.models import get_model
    from geomx_tpu_torch.ops import bsc, bucket
    from geomx_tpu_torch.parallel.collectives import all_gather_dc

    gen = torch.Generator(device=dev).manual_seed(0)
    model = get_model("resnet20")
    shapes = [tuple(model.get_parameter(k).shape) for k in model.param_names()]
    rows_shape = (2, 4)
    leaves = [torch.randn(rows_shape + s, generator=gen, device=dev)
              for s in shapes]
    bk = GradientBucketer(leaves, batch_dims=2)
    layout, sizes = bk.layout(), bk.bucket_sizes
    assert len(sizes) == 1, sizes
    n = sizes[0]
    rows = [leaf.flatten(2) for leaf in leaves]
    nrows = 8
    leaf_elems = sum(bk.leaf_sizes)
    out = {}

    # -- flatten / unflatten ------------------------------------------------
    buckets = bucket.flatten(leaves, layout, sizes, 2)
    err = max_err(torch, buckets, bucket.flatten_plain(rows, layout, sizes))
    pad = torch.zeros(rows_shape + (n - leaf_elems,), device=dev)
    fl_bytes = nrows * (leaf_elems + n) * 4
    out["fused_flatten"] = dict(
        max_abs_err=err,
        ms=timer(lambda: bucket.flatten(leaves, layout, sizes, 2)),
        plain_ms=timer(lambda: bucket.flatten_plain(rows, layout,
                                                               sizes)),
        bound_ms=bound_ms(fl_bytes), bound_by="bytes",
        library_ms=timer(lambda: torch.cat(rows + [pad], dim=-1)))
    back = bucket.unflatten(buckets, layout, 2)
    err = max_err(torch, back, bucket.unflatten_plain(buckets, layout))
    split = list(bk.leaf_sizes) + [n - leaf_elems]
    out["fused_unflatten"] = dict(
        max_abs_err=err,
        ms=timer(lambda: bucket.unflatten(buckets, layout, 2)),
        plain_ms=timer(lambda: bucket.unflatten_plain(buckets,
                                                                 layout)),
        bound_ms=bound_ms(fl_bytes), bound_by="bytes",
        library_ms=timer(lambda: [
            t.contiguous() for t in torch.split(buckets[0], split, -1)[:-1]]))

    # -- select/pack and scatter-add at the flagship shapes -----------------
    comp = BiSparseCompressor(0.01)
    k = comp.k_for(n)
    g = buckets[0]
    u = torch.randn(g.shape, generator=gen, device=dev) * 0.1
    v = torch.randn(g.shape, generator=gen, device=dev) * 0.2
    thr = bsc.sampled_boundary_guv(g, u, v, k)
    sel = bsc.select_pack(g, u, v, thr, k)
    err = max_err(torch, sel, bsc.select_pack_plain(g, u, v, thr, k))
    out["bsc_select_pack"] = dict(
        max_abs_err=err,
        ms=timer(lambda: bsc.select_pack(g, u, v, thr, k)),
        plain_ms=timer(lambda: bsc.select_pack_plain(g, u, v, thr,
                                                                k)),
        bound_ms=bound_ms(nrows * (5 * n * 4 + k * 8) + nrows * 4),
        bound_by="bytes", library_ms=None)
    vals = all_gather_dc(sel[0]).reshape(2, 4, -1).contiguous()
    idx = all_gather_dc(sel[1]).reshape(2, 4, -1).contiguous()
    dense = bsc.scatter_add(vals, idx, n, run=k)
    err = max_err(torch, [dense], [bsc.scatter_add_plain(vals, idx, n, k)])
    flat_idx = torch.where(
        idx >= 0, idx.long() + torch.arange(nrows, device=dev)
        .view(2, 4, 1) * n, nrows * n).view(-1)
    flat_vals = vals.view(-1)
    out["bsc_scatter_add"] = dict(
        max_abs_err=err,
        ms=timer(lambda: bsc.scatter_add(vals, idx, n, run=k)),
        plain_ms=timer(lambda: bsc.scatter_add_plain(vals, idx, n,
                                                                k)),
        bound_ms=bound_ms(vals.numel() * 8 + nrows * n * 4),
        bound_by="bytes",
        library_ms=timer(lambda: torch.zeros(
            nrows * n + 1, device=dev).index_add_(0, flat_idx, flat_vals)))

    # -- edge cases of the CPU parity tests, two parties each ---------------
    def case(name, n_, ratio, make):
        c = BiSparseCompressor(ratio)
        k_ = c.k_for(n_)
        parts = []
        for party in range(2):
            g_, u_, v_ = (t.to(dev).view(1, n_) for t in make(party))
            th = bsc.sampled_boundary_guv(g_, u_, v_, k_)
            got = bsc.select_pack(g_, u_, v_, th, k_)
            max_err(torch, got, bsc.select_pack_plain(g_, u_, v_, th, k_))
            parts.append(got)
        pv = torch.cat([p[0] for p in parts], -1)
        pi = torch.cat([p[1] for p in parts], -1)
        max_err(torch, [bsc.scatter_add(pv, pi, n_, run=k_)],
                [bsc.scatter_add_plain(pv, pi, n_, k_)])
        log(f"  edge case {name}: n={n_} k={k_} emitted="
            f"{int((pi >= 0).sum())} of {2 * k_} bit-equal")

    cpu = torch.Generator().manual_seed(1)

    def rnd(n_):
        return [torch.randn(n_, generator=cpu) * s for s in (1.0, 0.1, 0.2)]

    def zeros(n_):
        return [torch.zeros(n_) for _ in range(3)]

    case("odd n", 5000, 0.01, lambda p: rnd(5000))
    case("tiny", 10, 0.5, lambda p: rnd(10))

    def sentinel(p):
        g_ = torch.zeros(8192)
        g_[7 + p] = 3.0
        g_[4096] = -2.0
        return [g_, torch.zeros(8192), torch.zeros(8192)]

    case("all-sentinel", 8192, 0.01, sentinel)
    case("overflow past k", 4096, 0.01,
         lambda p: [torch.full((4096,), -0.75 - p), torch.zeros(4096),
                    torch.zeros(4096)])
    case("all-zero", 5000, 0.01, lambda p: zeros(5000))
    case("mixed ties", 20000, 0.02,
         lambda p: [torch.round(torch.randn(20000, generator=cpu) * 2) * 0.5,
                    torch.zeros(20000), torch.zeros(20000)])
    return out


def reference_phase(torch):
    """Two fp32 steps of a small ResNet on the card vs on the CPU."""
    from geomx_tpu_torch import GeoConfig, HiPSTopology
    from geomx_tpu_torch.data import load_dataset
    from geomx_tpu_torch.models import ResNet
    from geomx_tpu_torch.optim import sgd
    from geomx_tpu_torch.train import Trainer

    data = load_dataset("synthetic", synthetic_train_n=512)
    x = data["train_x"][:, :16, :16]
    cfg = GeoConfig(num_parties=2, workers_per_party=4,
                    compression="bsc,0.01", precision="fp32")
    runs = {}
    for device in ("cuda", "cpu"):
        t = Trainer(ResNet((1, 1, 1), (8, 16, 32), dtype=torch.float32),
                    HiPSTopology(2, 4), sgd(0.1, momentum=0.9), config=cfg,
                    device=device)
        st = t.init_state(seed=0)
        losses = []
        for i, (xb, yb) in enumerate(t.make_loader(x, data["train_y"],
                                                   8).epoch(0)):
            if i == 2:
                break
            st, m = t.train_step(st, xb, yb)
            losses.append(float(m["loss"]))
        runs[device] = (losses, {k: v.cpu() for k, v in st.params.items()})
    (gl, gp), (cl, cp) = runs["cuda"], runs["cpu"]
    for a, b in zip(gl, cl):
        if not math.isfinite(a) or abs(a - b) > 1e-4 * abs(b):
            raise AssertionError(f"card losses {gl} vs CPU {cl}")
    worst = max((gp[k] - cp[k]).abs().max().item() for k in cp)
    if worst > 2e-3:
        raise AssertionError(f"card and CPU params differ by {worst}")
    log(f"reference: card losses {gl} CPU losses {cl} max param diff "
        f"{worst:.3g}")


def main_path_phase(torch, steps: int, device=None, batch: int = 128):
    from geomx_tpu_torch import GeoConfig, HiPSTopology, ops
    from geomx_tpu_torch.data import load_dataset
    from geomx_tpu_torch.models import get_model
    from geomx_tpu_torch.optim import sgd
    from geomx_tpu_torch.train import Trainer

    topo = HiPSTopology(2, 4)
    epochs = max(2, math.ceil(steps / 8))
    data = load_dataset("synthetic", synthetic_train_n=8 * batch * 8)
    trainer = Trainer(get_model("resnet20"), topo, sgd(0.1, momentum=0.9),
                      config=GeoConfig(num_parties=2, workers_per_party=4,
                                       compression="bsc,0.01"),
                      device=device)
    state = trainer.init_state(seed=0)
    loader = trainer.make_loader(data["train_x"], data["train_y"], batch)
    records = []
    on_card = trainer.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    state, records = trainer.fit(state, loader, epochs=epochs, log_every=1,
                                 log_fn=lambda s: None)
    if on_card:
        torch.cuda.synchronize()
    launches = ops.launch_counts()

    losses = [r["loss"] for r in records if "loss" in r]
    times = [r["time"] for r in records if "loss" in r]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    # the loss falls over the first two epochs (8 steps each).  Later this
    # configuration -- sgd momentum on top of BSC's momentum correction at
    # lr 0.1 without warm-up -- turns unstable on the synthetic set, in the
    # JAX package as well, so the check does not read the later steps.
    first, second = losses[:8], losses[8:16]
    if len(second) < 8 or not statistics.mean(second) < statistics.mean(first):
        raise AssertionError(f"loss did not fall: {losses}")
    for k_, v in state.params.items():
        if not torch.equal(v, v[:1, :1].expand_as(v)):
            raise AssertionError(f"replicas diverged at {k_}")
    missing = [name for name, c in launches.items() if c < 1]
    if on_card and missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing} ({launches})")
    warm = 2  # first steps pay cuDNN autotuning and the first allocations
    per_step = [b - a for a, b in zip(times[warm - 1:], times[warm:])]
    sps = 8 * batch * len(per_step) / (times[-1] - times[warm - 1])
    test_acc = trainer.evaluate(state, data["test_x"], data["test_y"])
    res = dict(steps=len(losses), samples_per_step=8 * batch,
               samples_per_s=sps, step_ms_median=1e3 * statistics.median(
                   per_step), loss_first=losses[0], loss_last=losses[-1],
               losses=losses, test_acc=test_acc,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9
               if on_card else None,
               launches=launches)
    log(f"main path: {len(losses)} steps, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, {sps:.1f} samples/s, step "
        f"{res['step_ms_median']:.2f} ms (median), test_acc {test_acc:.3f}, "
        f"peak {res['peak_mem_gb']} GB, launches {launches}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every number to this JSON file")
    ap.add_argument("--steps", type=int, default=32,
                    help="main-path training steps (rounded up to epochs of "
                    "8; at least 16)")
    ap.add_argument("--verbose-build", action="store_true",
                    help="show the compiler's output (ptxas register use)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from geomx_tpu_torch.ops import KERNELS, _build
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.kernels(verbose=args.verbose_build)
    log(f"build: {time.perf_counter() - t0:.1f} s")

    kern = kernel_phase(torch, torch.device("cuda"))
    for name, r in kern.items():
        lib = "-" if r["library_ms"] is None \
            else f"{r['library_ms'] * 1e3:.1f} us"
        log(f"kernel {name}: {r['ms'] * 1e3:.1f} us (plain "
            f"{r['plain_ms'] * 1e3:.1f} us, library {lib}, bound "
            f"{r['bound_ms'] * 1e3:.2f} us), bit-equal")
    reference_phase(torch)
    main = main_path_phase(torch, args.steps)

    kernels = []
    for name in KERNELS:
        source, replaces = REPLACES[name]
        r = kern[name]
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces,
                            launches=main["launches"][name],
                            max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"],
                            library_ms=r["library_ms"]))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "build_s": _build.build_seconds,
                       "kernels": kernels, "main_path": main,
                       "wall_s": time.perf_counter() - t_start}, f, indent=1)
    log(f"wall: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
