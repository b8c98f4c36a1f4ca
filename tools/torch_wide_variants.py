#!/usr/bin/env python3
"""Times the kernels of several copies of the kernel sources in turns.

    python3 tools/torch_wide_variants.py --csrc NAME=DIR [--csrc NAME=DIR ...]
        [--kernels wide|plane] [--rounds 2] [--all-dims] --out FILE

Each DIR is a copy of ``geomx_tpu_torch/csrc`` (from a ``git archive`` of
another commit, or edited to try a form or to knock a phase out).  The
sources of the chosen kernels are built alone with ``nvcc`` for ``sm_90a``
into ``build/wide_variants/NAME`` (a directory ``.gitignore`` lists), every
copy's at once, and loaded through their C interface.  Every copy is run
once and compared with the plain versions, then timed in turns, the copies
in order and then in reverse, ``--rounds`` times, the L2 flushed between
calls.  Prints one line a copy and writes every number, with the card's
name and power limit, to FILE (JSON).  Needs a CUDA device and ``nvcc``.

``--kernels wide`` (the default): ``flash_attention.cu`` and
``ring_hop.cu``, by default with the head dims up to 128 taken out of the
dispatch so each build takes seconds; the forward at q, k, v [16, 4096, 4,
256] fp32 over 10 calls and the hop at [32, 128, 4, 256] over 30 (a
knocked-out phase shows as a large error: such a copy is timed, not
trusted).  The SM clock and power draw are sampled while each copy's
forward runs back to back.

``--kernels plane``: ``twobit.cu`` and ``merge.cu``; the party-summing
dequantize on path 2's all-gathered wire ([2, 4] replica rows, two parties,
n = 272,512) and the merge on path 3's owner-routed pairs ([4, 2] rows of
4 x 1,371, sorted), chip_smoke.py's inputs made on the CPU from seeds.
Each copy must give the plain versions' bits.  Each kernel is timed over
50 calls flushed (``cold``) and over 50 back to back (``warm``: the inputs
in L2, as inside a step).  A copy whose ``geomx_kernels.h`` still declares
the merge's ``rank`` operand gets the ranks, computed outside the timing.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(HERE, "build", "wide_variants")
SOURCES = {"wide": ("flash_attention.cu", "ring_hop.cu"),
           "plane": ("twobit.cu", "merge.cu")}
PTR, INT = ctypes.c_void_p, ctypes.c_int


class Operand(ctypes.Structure):
    _fields_ = [("ptr", ctypes.c_void_p), ("sb", ctypes.c_longlong),
                ("sl", ctypes.c_longlong), ("sh", ctypes.c_longlong)]


class Dims(ctypes.Structure):
    _fields_ = [("B", ctypes.c_int), ("H", ctypes.c_int),
                ("Lq", ctypes.c_int), ("Lk", ctypes.c_int),
                ("D", ctypes.c_int), ("causal", ctypes.c_int),
                ("bf16", ctypes.c_int), ("scale", ctypes.c_float)]


def operand(x) -> Operand:
    return Operand(x.data_ptr(), x.stride(0), x.stride(1), x.stride(2))


def copy_sources(name: str, src: str, all_dims: bool) -> str:
    """DIR copied to the build directory of NAME, its narrow dispatch cases
    dropped unless all_dims."""
    out = os.path.join(BUILD, name)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(src, os.path.join(out, "csrc"))
    if not all_dims:
        path = os.path.join(out, "csrc", "attention.cuh")
        with open(path) as f:
            text = f.read()
        text = re.sub(r"    GX_ATTN_CASE\(\d+, LAUNCH, __VA_ARGS__\)\s*\\\n",
                      "", text)
        with open(path, "w") as f:
            f.write(text)
    return out


def nvcc() -> str:
    """nvcc on the PATH, else under the CUDA toolkit PyTorch found."""
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc") or (
        CUDA_HOME and os.path.join(CUDA_HOME, "bin", "nvcc"))
    if not found or not os.path.exists(found):
        raise RuntimeError("no nvcc: put it on the PATH or set CUDA_HOME")
    return found


def build(dirs: dict, sources: tuple) -> None:
    """The sources of every copy, all nvcc processes at once."""
    compiler = nvcc()
    procs = []
    for name, out in dirs.items():
        for src in sources:
            log = open(os.path.join(out, src + ".log"), "w")
            cmd = [compiler, "-gencode=arch=compute_90a,code=sm_90a", "-O3",
                   "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
                   "-Xptxas", "-v", "-I" + os.path.join(out, "csrc"), "-o",
                   os.path.join(out, src.replace(".cu", ".so")),
                   os.path.join(out, "csrc", src)]
            procs.append((name, src, log, subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for name, src, log, proc in procs:
        if proc.wait(timeout=900) != 0:
            failed.append(f"{name}/{src}")
        log.close()
    if failed:
        raise RuntimeError(f"nvcc failed: {failed} (logs under {BUILD})")


def load(out: str):
    fa = ctypes.CDLL(os.path.join(out, "flash_attention.so"))
    fa.gx_flash_fwd.argtypes = [Operand, Operand, Operand, Dims,
                                ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_void_p]
    hop = ctypes.CDLL(os.path.join(out, "ring_hop.so"))
    hop.gx_ring_hop.argtypes = ([Operand] * 3 + [ctypes.c_void_p] * 3 +
                                [Dims] + [ctypes.c_void_p] * 4)
    return fa, hop


def device_ms(torch, fn, reps: int, flush: bool = True) -> float:
    """Median device time of fn() over reps calls, the L2 flushed before
    each unless not flush, and the host's enqueueing hidden behind a sleep
    kernel."""
    evict = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    torch.cuda._sleep(200_000_000)
    for s, e in zip(starts, ends):
        if flush:
            evict.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def clock_under_load(torch, fn, calls: int = 60) -> tuple:
    """Median SM clock (MHz) and power draw (W) while fn runs back to back."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    time.sleep(0.5)
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    smi.terminate()
    rows = [line.split(",") for line in
            smi.communicate(timeout=60)[0].strip().splitlines()
            if line.strip()][5:]
    if not rows:
        return None, None
    clocks = sorted(float(a) for a, _ in rows)
    power = sorted(float(b) for _, b in rows)
    return clocks[len(clocks) // 2], power[len(power) // 2]


def wide(torch, dirs: dict, rounds: int) -> dict:
    """The wide forward and hop of every copy, timed in turns."""
    from geomx_tpu_torch.ops import flash_attention as fa_mod
    from geomx_tpu_torch.ops import ring_hop as hop_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    B, L, H, D = 16, 4096, 4, 256
    q, k, v = (torch.randn((B, L, H, D), generator=gen, device=dev)
               for _ in range(3))
    ref, ref_lse = fa_mod.flash_attention_with_lse_plain(q, k, v)
    hs = (32, 128, 4, D)
    hq, hk, hv, ho = (torch.randn(hs, generator=gen, device=dev)
                      for _ in range(4))
    hm = torch.randn((32, 4, 128), generator=gen, device=dev)
    hl = hm.abs() + 0.5
    hop_ref = hop_mod.hop_plain(hq, hk, hv, hm, hl, ho, 1.0 / 16, False)
    out, lse = torch.empty_like(q), torch.empty((B, H, L), device=dev)
    m_o, l_o, o_o = (torch.empty_like(hm), torch.empty_like(hm),
                     torch.empty_like(ho))
    dims = Dims(B, H, L, L, D, 0, 0, 1.0 / 16)
    hop_dims = Dims(32, 4, 128, 128, D, 0, 0, 1.0 / 16)
    stream = torch.cuda.current_stream().cuda_stream
    libs = {name: load(d) for name, d in dirs.items()}

    def fwd(name):
        return lambda: libs[name][0].gx_flash_fwd(
            operand(q), operand(k), operand(v), dims, out.data_ptr(),
            lse.data_ptr(), stream)

    def hop(name):
        return lambda: libs[name][1].gx_ring_hop(
            operand(hq), operand(hk), operand(hv), hm.data_ptr(),
            hl.data_ptr(), ho.data_ptr(), hop_dims, m_o.data_ptr(),
            l_o.data_ptr(), o_o.data_ptr(), stream)

    rec = {}
    for name in dirs:
        rc = (fwd(name)(), hop(name)())
        torch.cuda.synchronize()
        if any(rc):
            raise RuntimeError(f"{name}: launch returned {rc}")
        rec[name] = dict(
            fwd_err=max((out - ref).abs().max().item(),
                        (lse - ref_lse).abs().max().item()),
            hop_err=max((a - b).abs().max().item()
                        for a, b in zip((m_o, l_o, o_o), hop_ref)),
            fwd_ms=[], hop_ms=[])
    order = list(dirs)
    for r in range(rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            rec[name]["fwd_ms"].append(device_ms(torch, fwd(name), 10))
            rec[name]["hop_ms"].append(device_ms(torch, hop(name), 30))
    for name in order:
        rec[name]["clock_mhz"], rec[name]["power_w"] = clock_under_load(
            torch, fwd(name))
        r = rec[name]
        print(f"{name}: forward {', '.join(f'{x:.3f}' for x in r['fwd_ms'])}"
              f" ms, hop {', '.join(f'{x * 1e3:.1f}' for x in r['hop_ms'])}"
              f" us; max abs err {r['fwd_err']:.3g} / {r['hop_err']:.3g};"
              f" SM {r['clock_mhz']} MHz at {r['power_w']} W", flush=True)
    return rec


def load_plane(out: str, src: str):
    """(dequantize, merge, whether the merge takes ranks) of one copy."""
    two = ctypes.CDLL(os.path.join(out, "twobit.so"))
    two.gx_dequantize_2bit.argtypes = [PTR, INT, INT, INT, ctypes.c_float,
                                       PTR, PTR]
    mg = ctypes.CDLL(os.path.join(out, "merge.so"))
    with open(os.path.join(src, "geomx_kernels.h")) as f:
        ranked = "const int* rank" in f.read()
    mg.gx_merge_sorted_pairs.argtypes = \
        [PTR, PTR] + [PTR] * ranked + [INT, INT, INT, PTR, PTR, PTR]
    return two.gx_dequantize_2bit, mg.gx_merge_sorted_pairs, ranked


def plane(torch, dirs: dict, rounds: int) -> dict:
    """The dequantize and the merge of every copy, timed in turns."""
    import chip_smoke
    from geomx_tpu_torch.ops import merge, twobit

    dev, cpu = torch.device("cuda"), torch.device("cpu")
    n = 272_512
    _, _, wire = chip_smoke.twobit_inputs(
        torch, cpu, torch.Generator().manual_seed(21), (2, 4, n))
    wire = wire.to(dev)
    rows, parts = 8, wire.shape[-2]
    deq_ref = twobit.dequantize_2bit_plain(wire, n, 0.5, summed=True)
    rv, ri, dup = chip_smoke.merge_inputs(
        torch, cpu, torch.Generator().manual_seed(22), n)
    svals, skey = (t.to(dev).reshape(8, -1).contiguous()
                   for t in merge.sort_pairs(rv, ri))
    rank = merge.segment_ranks(skey)[0].contiguous()
    m, depth = svals.shape[-1], merge.merge_rounds(dup)
    merge_ref = merge.merge_tree_plain(svals, skey, rank, depth)
    out = torch.empty_like(deq_ref)
    out_v, out_i = torch.empty_like(svals), torch.empty_like(skey)
    stream = torch.cuda.current_stream().cuda_stream

    calls, rec = {}, {}
    for name, d in dirs.items():
        deq, mg, ranked = load_plane(d, os.path.join(d, "csrc"))
        calls[name] = (
            lambda deq=deq: deq(wire.data_ptr(), rows, parts, n, 0.5,
                                out.data_ptr(), stream),
            lambda mg=mg, ranked=ranked: mg(
                svals.data_ptr(), skey.data_ptr(),
                *([rank.data_ptr()] if ranked else []), rows, m, depth,
                out_v.data_ptr(), out_i.data_ptr(), stream))
        for what, fn, got, ref in zip(("dequantize", "merge"), calls[name],
                                      ([out], [out_v, out_i]),
                                      ([deq_ref], merge_ref)):
            for t in got:
                t.fill_(7)
            rc = fn()
            torch.cuda.synchronize()
            if rc:
                raise RuntimeError(f"{name} {what}: launch returned {rc}")
            chip_smoke.max_err(torch, got, ref)
        rec[name] = {f"{k}_{t}_ms": [] for k in ("dequantize", "merge")
                     for t in ("cold", "warm")}
    order = list(dirs)
    for r in range(rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            for what, fn in zip(("dequantize", "merge"), calls[name]):
                for t in ("cold", "warm"):
                    rec[name][f"{what}_{t}_ms"].append(device_ms(
                        torch, fn, 50, flush=t == "cold"))
    for name in order:
        r = rec[name]

        def us(key):
            return ", ".join(f"{x * 1e3:.2f}" for x in r[key])
        print(f"{name}: dequantize cold {us('dequantize_cold_ms')} us, warm "
              f"{us('dequantize_warm_ms')} us; merge cold "
              f"{us('merge_cold_ms')} us, warm {us('merge_warm_ms')} us; "
              "bit-equal", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--csrc", action="append", required=True,
                    metavar="NAME=DIR", help="a copy of the kernel sources")
    ap.add_argument("--kernels", choices=sorted(SOURCES), default="wide",
                    help="which kernels to build and time")
    ap.add_argument("--rounds", type=int, default=2,
                    help="turns over the copies (forward, then reverse)")
    ap.add_argument("--all-dims", action="store_true",
                    help="keep the head dims up to 128 in the build")
    ap.add_argument("--out", required=True, help="JSON file to write")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    pairs = [c.split("=", 1) for c in args.csrc]
    cut = args.kernels == "wide" and not args.all_dims
    dirs = {name: copy_sources(name, os.path.abspath(src), not cut)
            for name, src in pairs}
    t0 = time.perf_counter()
    build(dirs, SOURCES[args.kernels])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"{card}; {len(dirs)} copies built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    run = wide if args.kernels == "wide" else plane
    rec = run(torch, dirs, args.rounds)
    with open(args.out, "w") as f:
        json.dump({"card": card, "kernels": args.kernels,
                   "copies": dict(pairs), "variants": rec}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
