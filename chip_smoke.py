#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (geomx_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json] [--steps 32] [--verbose-build]

Every phase's failure is fatal (non-zero exit, no result line):

1. card    -- ``nvidia-smi --query-gpu=name,power.limit`` as it prints it;
2. build   -- the CUDA kernels of geomx_tpu_torch/csrc, built at first use;
3. kernels -- each hand-written kernel against its plain PyTorch version on
              the card, at the shapes of the training paths (the ResNet-20
              gradient tree on the [2, 4] replica axes: one 272,512-element
              bucket, 8 replica rows, k = ceil(0.01 n), two parties; the
              merge at path 3's [4, 2]: 8 rows of 4 x 1,371 routed pairs;
              the flash kernels at seq_flash's q, k, v [16, 4096, 4, 16];
              the ring hop at seq_ring's [32, 128, 4, 16]) and on the edge
              cases of the CPU parity tests; the nine kernels of the
              training plane must be bit-equal, the four attention kernels
              within fp32 rtol/atol 1e-5 forward and 1e-4 backward and hop
              (another order of sums; looser for bf16 inputs).  Each
              kernel's median device time over 50 calls (20 for attention;
              CUDA events, L2 flushed between calls), its plain version's
              time, one PyTorch call computing the same function where
              there is one (scaled_dot_product_attention for the flash
              kernels, naming the backend it ran), and its bound: bytes at
              the card's 3.35 TB/s or flops at its 67 TFLOP/s fp32 rate,
              whichever is larger; for the four attention kernels the
              larger of the bytes, the products as split TF32 (3x the
              flops) at 495 TFLOP/s and the exponentials at the MUFU
              rate, the fp32 figure beside it; two calls of each
              attention kernel give the same bits (the forward's no-lse
              variant too); quantize_2bit and the scatter-add also one
              launch a call and the same bits twice, and on the card
              tests' edge cases (8 replica rows, P = 2-4 runs of odd
              length, operands one float off 16-byte alignment);
   head dims -- the four attention kernels at head dim 256 on the wide
              route (seq_flash's [16, 4096, 4] and seq_ring's hop [32,
              128, 4]): the fp32 gates, two calls the same bits, times,
              attn_bound() and scaled_dot_product_attention's time;
   shards  -- kernels 3-6 at the sharded paths' shapes (shard_phase()):
              ZeRO's [2, 4, 68,224] bucket shards, MultiGPS's per-leaf
              shards of 576 to 9,216 elements, the operands as the
              collectives' broadcast and transposed views; bit-equal, with
              times at the ZeRO shape;
4. reference -- two fp32 training steps on the card and on the CPU (plain
              versions) from the same weights and batches: a small ResNet
              for each path's configuration (HFA at K1 1, K2 2, so that
              both tiers fire) and four more compressors
              (REFERENCE_ONLY: exact BSC, the fp16 and 2-bit lattices,
              MPQ; MixedSync with DCASGD under ZeRO with the fused
              SGD-momentum over the shards; ZeRO over the dense dc tier;
              GeoCNN under "mpq,0.01", resnet20_s2d under
              get_optimizer("nag", 0.1), the MLP under
              get_optimizer("lamb", 1e-3)); the zoo paths' and the
              zoo configurations' models at full width on their
              datasets' shapes (MODEL_DATA; on the card through
              PyTorch's direct convolutions, cuDNN off),
              losses to rtol 1e-4, every replica's parameters to atol
              2e-3 (TF32 off); zero_dense's three steps within 1e-6 of the
              replicated update's on the card; the SeqClassifier at L = 256 un-meshed, ring and
              Ulysses on [2, 2] x sp 2 (SEQ_REFERENCE), losses to rtol
              1e-4, parameters to atol 4e-3;
5. paths   -- ResNet-20 at its default bf16 compute through Trainer, FSA
              with a bucketed dc tier unless named, the synthetic
              CIFAR-shaped set, 128 images a replica (1,024 a step), each
              path with the launch counts reset just before its run and
              read just after:
              1  (flagship)    [2, 4], sgd(0.1, momentum=0.9), "bsc,0.01",
                               32 steps;
              1f (fused_sgd)   the same with fused_optimizer("sgd") and
                               GeoConfig(fused_optim=True), 16 steps;
              2  (twobit_adam) [2, 4], fused_optimizer("adam",
                               learning_rate=0.01), "2bit,0.5",
                               fused_optim=True, 16 steps;
              3  (sparse_agg)  [4, 2], fused_optimizer("sgd", 0.1),
                               "bsc,0.01,select=sampled,sparse_agg=1"
                               (the owner-routed merge), fused_optim=True,
                               16 steps;
              mixed_dcasgd     [2, 4], MixedSync with DCASGD (lambda 0.04,
                               a pull every 2 steps), fused_optimizer(
                               "adam", 0.01), "bsc,0.01", 16 steps;
              hfa_dgt          [2, 4], HFA (K1 4, K2 2) over DGT (4096-byte
                               blocks, k 0.8, 3 channels, alpha 0.3) with
                               "bsc,0.01" inside, adam(0.01), 16 steps;
              pipelined_fsa    path 1 with GEOMX_PIPELINE_DEPTH=1, 16 steps,
                               then Trainer.drain_pipeline: one apply of
                               the parked aggregate, the CPU's bits;
              zero_sgd         path 1 with GEOMX_ZERO=1: the update on
                               [2, 4, 68,224] bucket shards, 16 steps;
              zero_pipelined_adam  ZeRO with fused_optimizer("adam",
                               0.01) over the shards and
                               GEOMX_PIPELINE_DEPTH=1, 16 steps, then the
                               drain: one apply_shard_update of the parked
                               shard aggregates, the CPU's bits;
              multigps_bsc     path 1 with GEOMX_MULTI_GPS=1,
                               bigarray_bound 1,000: 19 leaves as worker
                               shards, BSC per leaf, 16 steps.
              The sharded paths also check their optimizer state
              shard-shaped, the same in every party and distinct across
              workers, the dc-tier state shard-shaped, and print the
              per-slot bytes of that state and the dc wire bytes against
              the replicated twin's (SHARDED_TWIN).
              Each checks a finite loss, identical replicas (HFA: the 16
              steps end on a global sync) and every kernel of its
              configuration launched, and that the loss falls from the
              first epoch of 8 steps to the second (for path 2, the
              three sync paths and the two zoo paths as the JAX
              package's own trajectories fall, PERF.md);
              path 2 also that the 2-bit wire carried non-zero codes;
              path 3 prints its last step's merge counts (overflow pairs
              reinjected, merged, kept, the pull-dropped share);
              cnn_bsc     the port's examples/cnn_bsc.py itself
                          (cnn_common.run, -d mnist -bs 32 -ep 1) on
                          [2, 4] from the GEOMX_* environment: GeoCNN,
                          adam(0.01), "bsc,0.01", 16 steps, the test
                          accuracy printed after each;
              alexnet_fused_adam  get_model("alexnet") (bf16
                          convolutions), fused_optimizer("adam", 0.01),
                          "bsc,0.01" on [2, 4], batch 32 a replica of the
                          CIFAR-shaped set, a device-cached loader and
                          Trainer.fit(scan_epochs=True), 2 epochs of 8
                          steps; then one epoch of the cached batches
                          against the host loader's bytes, and the
                          checkpoint round trip: saved after epoch 0,
                          loaded into a fresh Trainer, epoch 1 run with
                          the scanned runner, the loaded state and the
                          resumed state bit-equal to the saved and the
                          uninterrupted ones with
                          torch.backends.cudnn.deterministic (the largest
                          difference without it printed too).  Both
                          print step ms, samples/s, their kernels a step,
                          the peak memory and the computed dc wire bytes
                          a step; AlexNet the bytes of its cached set;
              seq_flash   get_model("transformer") at L = 4096, HiPS
                          [2, 2], 16 sequences a replica, adam(1e-3), FSA,
                          the needle task, 8 steps: flash kernels 10-12,
                          8 launches a step each; then 64 sequences
                          evaluated (the forward without the logsumexp);
              seq_ring    examples/long_context.py's defaults: ring
                          attention on [2, 2] x sp 2, L = 256, 16 a
                          replica, 16 steps: the hop kernel, 16 launches a
                          step; its loss falls as the JAX package's does;
                          512 sequences evaluated on the un-meshed twin.
              Median step times of the paths come from the same call.

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
FP32_FLOPS = 67e12         # H100 SXM fp32 on the CUDA cores (data sheet)
TF32_FLOPS = 495e12        # dense TF32 tensor cores (data sheet)
# the MUFU unit's exponentials: 16 a clock an SM, 132 SMs at 1.98 GHz
EXP_PER_S = 132 * 16 * 1.98e9
REPLACES = {
    "fused_flatten": ("geomx_tpu_torch/csrc/bucket.cu",
                      "geomx_tpu/ops/bucket_pallas.py:92"),
    "fused_unflatten": ("geomx_tpu_torch/csrc/bucket.cu",
                        "geomx_tpu/ops/bucket_pallas.py:134"),
    "bsc_select_pack": ("geomx_tpu_torch/csrc/bsc.cu",
                        "geomx_tpu/ops/bsc_pallas.py:223"),
    "bsc_scatter_add": ("geomx_tpu_torch/csrc/bsc.cu",
                        "geomx_tpu/ops/bsc_pallas.py:332"),
    "fused_sgd_momentum": ("geomx_tpu_torch/csrc/optim.cu",
                           "geomx_tpu/ops/optim_pallas.py:195"),
    "fused_adam": ("geomx_tpu_torch/csrc/optim.cu",
                   "geomx_tpu/ops/optim_pallas.py:233"),
    "quantize_2bit": ("geomx_tpu_torch/csrc/twobit.cu",
                      "geomx_tpu/ops/twobit_pallas.py:89"),
    "dequantize_2bit": ("geomx_tpu_torch/csrc/twobit.cu",
                        "geomx_tpu/ops/twobit_pallas.py:116"),
    "merge_sorted_pairs": ("geomx_tpu_torch/csrc/merge.cu",
                           "geomx_tpu/ops/merge_pallas.py:160"),
    "flash_attention_fwd": ("geomx_tpu_torch/csrc/flash_attention.cu",
                            "geomx_tpu/ops/flash_attention.py:154"),
    "flash_attention_dq": ("geomx_tpu_torch/csrc/flash_attention_dq.cu",
                           "geomx_tpu/ops/flash_attention.py:339"),
    "flash_attention_dkv": ("geomx_tpu_torch/csrc/flash_attention_dkv.cu",
                            "geomx_tpu/ops/flash_attention.py:353"),
    "fused_block": ("geomx_tpu_torch/csrc/ring_hop.cu",
                    "geomx_tpu/parallel/_fused_block.py:100"),
}

# path -> (model, optimizer, compression, fused apply, steps, its kernels,
# its topology [P, W], its other GeoConfig fields).  The model is a
# get_model name; the optimizer is (kind, learning rate): "sgd" is
# sgd(lr, momentum=0.9), "adam" adam(lr), each fused_optimizer(kind) when
# fused, and any other kind get_optimizer(kind, lr).  Every path runs FSA
# but for its GeoConfig fields.
SLICE1 = ("fused_flatten", "fused_unflatten", "bsc_select_pack",
          "bsc_scatter_add")
PATHS = {
    "flagship": ("resnet20", ("sgd", 0.1), "bsc,0.01", False, None, SLICE1,
                 (2, 4), {}),
    "fused_sgd": ("resnet20", ("sgd", 0.1), "bsc,0.01", True, 16,
                  SLICE1 + ("fused_sgd_momentum",), (2, 4), {}),
    "twobit_adam": ("resnet20", ("adam", 0.01), "2bit,0.5", True, 16,
                    ("fused_flatten", "fused_unflatten", "quantize_2bit",
                     "dequantize_2bit", "fused_adam"), (2, 4), {}),
    # four parties: the merge tree runs ceil(log2 4) = 2 rounds
    "sparse_agg": ("resnet20", ("sgd", 0.1),
                   "bsc,0.01,select=sampled,sparse_agg=1", True, 16,
                   SLICE1 + ("fused_sgd_momentum", "merge_sorted_pairs"),
                   (4, 2), {}),
    # examples/cnn.py -ms -dc (scripts' run_mixed_sync.sh with --dcasgd):
    # a pull every 2 steps, so the stale copy lags and the DCASGD term is
    # not zero
    "mixed_dcasgd": ("resnet20", ("adam", 0.01), "bsc,0.01", True, 16,
                     SLICE1 + ("fused_adam",), (2, 4),
                     dict(sync_mode="mixed", dcasgd=True, dcasgd_lambda=0.04,
                          mixed_pull_interval=2)),
    # examples/cnn_hfa.py with run_dgt.sh's DGT settings; K1 20, K2 10
    # cut to 4, 2 so that two global syncs fall inside 16 steps.  DGT
    # fuses the tree itself (no bucket copies) and its inner BSC runs on
    # the two global steps
    "hfa_dgt": ("resnet20", ("adam", 0.01), "bsc,0.01", False, 16,
                ("bsc_select_pack", "bsc_scatter_add"), (2, 4),
                dict(sync_mode="hfa", hfa_k1=4, hfa_k2=2, enable_dgt=2,
                     dgt_k=0.8, udp_channel_num=3, dgt_block_size=4096,
                     dgt_contri_alpha=0.3)),
    # the flagship with the pipelined WAN sync; Trainer.drain_pipeline
    # after the run
    "pipelined_fsa": ("resnet20", ("sgd", 0.1), "bsc,0.01", False, 16,
                      SLICE1, (2, 4), dict(pipeline_depth=1)),
    # bench.py --compare-zero's ZeRO run (GEOMX_ZERO=1): each worker
    # updates one 68,224-element shard of the 272,896-element bucket
    # (pad_to 512) and the dc tier's BSC runs on the shards
    "zero_sgd": ("resnet20", ("sgd", 0.1), "bsc,0.01", False, 16, SLICE1,
                 (2, 4), dict(zero=True)),
    # ZeRO with the fused Adam over the shards and the pipelined dc tier;
    # Trainer.drain_pipeline after the run (the JAX package's ZeRO drain
    # runs the fused apply too)
    "zero_pipelined_adam": ("resnet20", ("adam", 0.01), "bsc,0.01", True,
                            16, SLICE1 + ("fused_adam",), (2, 4),
                            dict(zero=True, pipeline_depth=1)),
    # scripts/tpu/run_multi_gps.sh (GEOMX_MULTI_GPS=1,
    # GEOMX_BIGARRAY_BOUND=1000) with the bsc dc tier: 19 of ResNet-20's
    # 65 leaves update as worker shards; the bucket is unwrapped, so BSC
    # runs per leaf where a leaf (or shard) has 1,024 elements or more
    "multigps_bsc": ("resnet20", ("sgd", 0.1), "bsc,0.01", False, 16,
                     ("bsc_select_pack", "bsc_scatter_add"), (2, 4),
                     dict(multi_gps=True, bigarray_bound=1000)),
    # examples/cnn_bsc.py as scripts/cpu/run_bisparse_compression.sh
    # launches it (-d mnist, batch 32 a replica, adam(0.01), "bsc,0.01"
    # on [2, 4]), through the port's entry point (cnn_bsc_phase):
    # GeoCNN's one bucket of 449,098 elements; one epoch of the
    # MNIST-shaped set is 16 steps
    "cnn_bsc": ("cnn", ("adam", 0.01), "bsc,0.01", False, 16, SLICE1,
                (2, 4), {}),
    # get_model("alexnet") at its published width (6,976,842 parameters,
    # bf16 convolutions, fp32 head): five 4 MiB buckets under the fused
    # Adam, batch 32 a replica of the CIFAR-shaped set, a device-cached
    # loader and fit(scan_epochs=True), as bench.py runs the flagship
    # (alexnet_phase), then the checkpoint round trip
    "alexnet_fused_adam": ("alexnet", ("adam", 0.01), "bsc,0.01", True, 16,
                           SLICE1 + ("fused_adam",), (2, 4), {}),
}
# the sharded paths and the GeoConfig fields of their replicated twins,
# whose per-slot state and wire bytes they are held against
SHARDED_TWIN = {"zero_sgd": dict(zero=False),
                "zero_pipelined_adam": dict(zero=False),
                "multigps_bsc": dict(multi_gps=False)}
# the reference phase's two steps: HFA's periods such that both tiers fire
REFERENCE_FIELDS = {"hfa_dgt": dict(hfa_k1=1, hfa_k2=2)}
# configurations the reference phase checks beside PATHS: the compressors
# without a kernel of their own, and the rest of the zoo and the factory,
# on the card
REFERENCE_ONLY = {
    "bsc_exact": ("resnet20", ("sgd", 0.1), "bsc,0.01,select=exact", False,
                  None, (), (2, 4), {}),
    "fp16_lattice": ("resnet20", ("sgd", 0.1), "fp16,sparse_agg=1", False,
                     None, (), (4, 2), {}),
    "twobit_lattice": ("resnet20", ("sgd", 0.1), "2bit,0.5,sparse_agg=1",
                       False, None, (), (4, 2), {}),
    # the small ResNet's one bucket is below 200k elements: fp16 gather
    "mpq": ("resnet20", ("sgd", 0.1), "mpq,0.01", False, None, (), (2, 4),
            {}),
    # MixedSync with DCASGD under ZeRO: the shard-wise DCASGD term and
    # the fused SGD-momentum (kernel 5) over the shards
    "zero_mixed_dcasgd": ("resnet20", ("sgd", 0.1), "bsc,0.01", True, None,
                          (), (2, 4),
                          dict(zero=True, sync_mode="mixed", dcasgd=True,
                               dcasgd_lambda=0.04, mixed_pull_interval=2)),
    # ZeRO over the uncompressed dc tier: the replicated update's params
    # (zero_identity(); tests/test_zero.py:93-100)
    "zero_dense": ("resnet20", ("sgd", 0.1), "none", False, None, (),
                   (2, 4), dict(zero=True)),
    # examples/cnn_mpq.py: GeoCNN's one 449,098-element bucket is above
    # MPQ's 200,000 bound, so it takes the BSC route (kernels 3-4)
    "cnn_mpq": ("cnn", ("adam", 0.01), "mpq,0.01", False, None, (), (2, 4),
                {}),
    # the space-to-depth ResNet-20 under Nesterov momentum
    "resnet20_s2d_nag": ("resnet20_s2d", ("nag", 0.1), "bsc,0.01", False,
                         None, (), (2, 4), {}),
    # the MLP under LAMB (per-slot trust ratios)
    "mlp_lamb": ("mlp", ("lamb", 1e-3), "bsc,0.01", False, None, (),
                 (2, 4), {}),
}
# the dataset each model trains on here: the MNIST shape for the demo
# CNN and the MLP (the synthetic fallback without MNIST's files), the
# CIFAR shape for the others
MODEL_DATA = {"cnn": "mnist", "mlp": "mnist"}
# the attention paths, examples/long_context.py's SeqClassifier (vocab 256,
# dim 64, 4 heads, 2 layers, 10 classes) under adam(1e-3) and FSA with the
# uncompressed (bucketed) dc tier, on the needle task: path -> (sp mode,
# topology [P, W, sp], sequence length, sequences a replica, steps, the
# kernels of the path with their launches a step, sequences evaluated)
_FLASH = ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv")
SEQ_PATHS = {
    # get_model("transformer") at its max_len: the flash kernels
    "seq_flash": (None, (2, 2, 1), 4096, 16, 8,
                  {name: 2 * 4 for name in _FLASH}, 64),
    # the example's defaults: ring attention over sp 2, two hops a layer,
    # one hop launch covering both shards
    "seq_ring": ("ring", (2, 2, 2), 256, 16, 16, {"fused_block": 2 * 2 * 4},
                 512),
}
# the paths whose loss must fall from the first half of the steps to the
# second: seq_ring's does in the JAX package too (2.4197 -> 2.3303 over
# 16 steps, tests/torch_jax_trajectory.py --path seq_ring); seq_flash's
# needle signal is diluted 1/4096 and does not move in 8 steps
LOSS_FALLS = ("seq_ring",)
# the reference phase's attention configurations: (sp mode, topology, L)
SEQ_REFERENCE = {"seq_flash": (None, (2, 2, 1), 256),
                 "seq_ring": ("ring", (2, 2, 2), 256),
                 "seq_ulysses": ("ulysses", (2, 2, 2), 256)}
# the path whose launch counts the kernels line reports for each kernel
_PATH_KERNELS = {**{p: cfg[5] for p, cfg in PATHS.items()},
                 **{p: cfg[5] for p, cfg in SEQ_PATHS.items()}}
FIRST_PATH = {name: next(p for p, kernels in _PATH_KERNELS.items()
                         if name in kernels)
              for name in REPLACES}


def make_trainer(path: str, model=None, device=None, precision=None,
                 **fields):
    """The Trainer of one configuration of PATHS or REFERENCE_ONLY, on
    ``model`` (default: the configuration's zoo model); ``fields``
    override its GeoConfig fields."""
    from geomx_tpu_torch import GeoConfig, HiPSTopology
    from geomx_tpu_torch.models import get_model
    from geomx_tpu_torch.ops.optim import fused_optimizer
    from geomx_tpu_torch.optim import adam, get_optimizer, sgd
    from geomx_tpu_torch.train import Trainer

    name, (kind, lr), spec, fused, _, _, (P, W), extra = \
        PATHS[path] if path in PATHS else REFERENCE_ONLY[path]
    if fused:
        tx = fused_optimizer(kind, learning_rate=lr, momentum=0.9)
    elif kind == "adam":
        tx = adam(lr)
    elif kind == "sgd":
        tx = sgd(lr, momentum=0.9)
    else:
        tx = get_optimizer(kind, lr)
    cfg = dict(num_parties=P, workers_per_party=W, compression=spec,
               fused_optim=fused, **{**extra, **fields})
    if precision is not None:
        cfg["precision"] = precision
    if model is None:
        model = get_model(name, precision=precision)
    return Trainer(model, HiPSTopology(P, W), tx, config=GeoConfig(**cfg),
                   device=device)


def path_data(path: str, n: int):
    """The configuration's dataset (MODEL_DATA) with ``n`` training
    images."""
    from geomx_tpu_torch.data import load_dataset
    name = (PATHS[path] if path in PATHS else REFERENCE_ONLY[path])[0]
    return load_dataset(MODEL_DATA.get(name, "synthetic"),
                        synthetic_train_n=n)


def make_seq_trainer(sp_mode, shape, seq_len: int, device=None):
    """The Trainer of an attention configuration: SeqClassifier at
    examples/long_context.py's widths (``get_model("transformer")`` when
    un-meshed), adam(1e-3), FSA, HiPS ``shape = (P, W, sp)``."""
    from geomx_tpu_torch import HiPSTopology
    from geomx_tpu_torch.models import SeqClassifier, get_model
    from geomx_tpu_torch.optim import adam
    from geomx_tpu_torch.sync import FSA
    from geomx_tpu_torch.train import Trainer

    P, W, S = shape
    if sp_mode is None:
        model, twin = get_model("transformer"), None
    else:
        model = SeqClassifier(max_len=seq_len, sp_mode=sp_mode)
        twin = SeqClassifier(max_len=seq_len)
    return Trainer(model, HiPSTopology(P, W, sp_degree=S), adam(1e-3),
                   sync=FSA(), device=device, single_device_model=twin)


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


def close_err(torch, got, ref, rtol: float, atol: float) -> float:
    """Max abs difference of kernel and plain outputs; raises where they
    differ by more than ``atol + rtol * |plain|``."""
    worst = 0.0
    for a, b in zip(got, ref):
        torch.testing.assert_close(a.float(), b.float(), rtol=rtol,
                                   atol=atol)
        if a.numel():
            worst = max(worst, (a.float() - b.float()).abs().max().item())
    return worst


def op_bound(nbytes: int, flops: int):
    """(bound ms, "bytes" or "operations") at the fp32 CUDA-core rate."""
    b, f = bound_ms(nbytes), flops / FP32_FLOPS * 1e3
    return (f, "operations") if f >= b else (b, "bytes")


def attn_bound(nbytes: int, flops: int, exps: int):
    """The attention kernels' bound: (ms, "bytes" or "operations", which
    of the three it is) -- the larger of the bytes at 3.35 TB/s, the
    products as split TF32 (3 TF32 products for each fp32 one, the
    tensor-core route to fp32 accuracy) at 495 TFLOP/s and the
    exponentials at the MUFU rate; the fp32 CUDA-core figure of
    op_bound() stays beside it as fp32_bound_ms."""
    cands = [(bound_ms(nbytes), "bytes", "bytes"),
             (3 * flops / TF32_FLOPS * 1e3, "operations",
              "split-TF32 tensor operations"),
             (exps / EXP_PER_S * 1e3, "operations", "exponentials")]
    return max(cands, key=lambda c: c[0])


def attn_record(nbytes: int, flops: int, exps: int, **kw) -> dict:
    """A kernel-phase record of rows 10-13 with both bounds."""
    bound, by, kind = attn_bound(nbytes, flops, exps)
    return dict(kw, bound_ms=bound, bound_by=by, bound_kind=kind,
                fp32_bound_ms=op_bound(nbytes, flops)[0])


def bits(torch, t):
    """t's bits as integers of its width, so -0.0 and +0.0 differ."""
    if not t.is_floating_point():
        return t
    return t.view({2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def max_err(torch, got, ref) -> float:
    """0.0 when bit-equal (the sign of a zero included); raises
    otherwise."""
    for a, b in zip(got, ref):
        if a.shape != b.shape or a.dtype != b.dtype or \
                not torch.equal(bits(torch, a), bits(torch, b)):
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
    launches = bsc.select_pack.launches
    sel = bsc.select_pack(g, u, v, thr, k)
    if bsc.select_pack.launches != launches + 1:
        raise AssertionError("select/pack: not one launch a call")
    err = max_err(torch, sel, bsc.select_pack_plain(g, u, v, thr, k))
    max_err(torch, sel, bsc.select_pack(g, u, v, thr, k))
    log("  select/pack: one launch a call; two calls give the same bits")
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
    once_same_bits(torch, bsc.scatter_add,
                   lambda: [bsc.scatter_add(vals, idx, n, run=k)], [dense])
    log("  scatter-add: one launch a call; two calls give the same bits")
    out["bsc_scatter_add"] = dict(
        max_abs_err=err,
        ms=timer(lambda: bsc.scatter_add(vals, idx, n, run=k)),
        plain_ms=timer(lambda: bsc.scatter_add_plain(vals, idx, n,
                                                                k)),
        bound_ms=bound_ms(vals.numel() * 8 + nrows * n * 4),
        bound_by="bytes",
        library_ms=timer(lambda: torch.zeros(
            nrows * n + 1, device=dev).index_add_(0, flat_idx, flat_vals)))
    scatter_edge_cases(torch, dev, n)

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

    out.update(optim_kernels(torch, dev, timer, gen, rows_shape + (n,)))
    out.update(twobit_kernels(torch, dev, timer, gen, rows_shape + (n,)))
    out.update(merge_kernels(torch, dev, timer, gen, n))
    return out


def once_same_bits(torch, wrapper, call, first) -> None:
    """``call()`` launches ``wrapper``'s kernel exactly once and gives the
    bits of ``first`` (an earlier call's outputs) again."""
    before = wrapper.launches
    again = call()
    if wrapper.launches != before + 1:
        raise AssertionError(f"{wrapper.__name__}: "
                             f"{wrapper.launches - before} launches a call")
    max_err(torch, again, first)


def scatter_runs(torch, dev, parties, k, n, seed, rows=8):
    """``[2, 4]`` rows of ``parties`` runs of ``k`` pairs in any order:
    indices unique inside a run, 200 shared by every run of the row
    (collisions across parties), none in [65_536, 98_304) (four output
    slices of the kernel's 8,192 floats that no pair touches), a sentinel
    tail of 50 a run, and row 5 all sentinels."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    pick = torch.cat([torch.arange(0, 65_536),
                      torch.arange(98_304, n)]).to(dev)
    vals, idx = [], []
    for row in range(rows):
        perm = pick[torch.randperm(len(pick), generator=gen, device=dev)]
        shared, rest = perm[:200], perm[200:]
        for _ in range(parties):
            ix = torch.cat([shared, rest[torch.randperm(
                len(rest), generator=gen, device=dev)[:k - 200]]])
            ix = ix[torch.randperm(k, generator=gen, device=dev)]
            ix[k - 50:] = -1
            if row == 5:
                ix[:] = -1
            idx.append(ix.to(torch.int32))
            vals.append(torch.randn(k, generator=gen, device=dev))
    shape = (2, 4, parties * k)
    return torch.cat(vals).view(shape), torch.cat(idx).view(shape)


def scatter_edge_cases(torch, dev, n) -> None:
    """The scatter-add on the card tests' edge cases, bit-equal to the
    plain version: 8 rows of P = 2, 3, 4 runs (run starts off 16-byte
    alignment at k = 2,726 and odd k), n and n + 1 (output rows off
    alignment), and vals/idx views one float off 16-byte alignment."""
    from geomx_tpu_torch.ops import bsc
    for parties, k in ((2, 2726), (3, 2726), (4, 2726), (3, 1001),
                       (4, 2727)):
        for n_ in (n, n + 1):
            v, i = scatter_runs(torch, dev, parties, k, n_, parties * k + n_)
            got = bsc.scatter_add(v, i, n_, run=k)
            max_err(torch, [got], [bsc.scatter_add_plain(v, i, n_, run=k)])
            if got[..., 65_536:98_304].any() or got[1, 1].any():
                raise AssertionError("scatter-add wrote where no pair is")
        log(f"  edge case scatter-add P={parties} k={k}, 8 rows, n={n} and "
            f"{n + 1}: bit-equal")
    v, i = scatter_runs(torch, dev, 3, 2726, n, seed=7)
    va = torch.empty(v.numel() + 1, device=dev)[1:].view(v.shape)
    ia = torch.empty(i.numel() + 1, dtype=torch.int32,
                     device=dev)[1:].view(i.shape)
    va.copy_(v)
    ia.copy_(i)
    max_err(torch, [bsc.scatter_add(va, ia, n, run=2726)],
            [bsc.scatter_add_plain(v, i, n, run=2726)])
    log("  edge case scatter-add pairs one float off 16-byte alignment: "
        "bit-equal")


def timer_floors(torch, dev, timer=None) -> dict:
    """What device_ms() reads for work that is not a kernel of the port:
    one fill of a 4-byte tensor (a launch and nothing else) and a device
    copy of the flatten's bytes (8 rows of the 272,512-element bucket, in
    and out), so each kernel's time can be read against the least this
    timer shows for a launch and for moving those bytes."""
    timer = timer or (lambda fn: device_ms(torch, fn))
    tiny = torch.zeros(1, device=dev)
    src = torch.ones(8 * 272_512, device=dev)
    dst = torch.empty_like(src)
    return dict(launch_ms=timer(lambda: tiny.fill_(1.0)),
                copy_ms=timer(lambda: dst.copy_(src)),
                copy_bytes=2 * src.numel() * 4)


def shard_phase(torch, dev, timer=None) -> dict:
    """Kernels 3-6 at the sharded paths' shapes, bit-equal to their plain
    versions: select/pack and the scatter-add on zero_sgd's [2, 4, 68,224]
    bucket shards (k = 683) and on multigps_bsc's per-leaf shards of
    ceil(n / 4) = 576 to 9,216 elements (two parties' pairs gathered);
    select/pack's g as a broadcast view over the workers and as a
    transposed view, the scatter-add's pairs as the tiled all-gather's
    broadcast view (four runs); the fused SGD-momentum and Adam over
    [2, 4, 68,224].  Times and bounds at the ZeRO shard shape."""
    timer = timer or (lambda fn: device_ms(torch, fn))
    from geomx_tpu_torch.compression import BiSparseCompressor
    from geomx_tpu_torch.ops import bsc, optim
    from geomx_tpu_torch.optim.adam import bias_corrections
    from geomx_tpu_torch.parallel.collectives import (all_gather,
                                                      all_gather_dc)

    gen = torch.Generator(device=dev).manual_seed(3)
    comp = BiSparseCompressor(0.01)
    out = {}

    def rows(n, *scales, lead=(2, 4)):
        return [torch.randn(lead + (n,), generator=gen, device=dev) * s
                for s in scales]

    for n in (68_224, 576, 1_152, 2_304, 4_608, 9_216):
        k = comp.k_for(n)
        g, u, v = rows(n, 1.0, 0.1, 0.2)
        thr = bsc.sampled_boundary_guv(g, u, v, k)
        sel = bsc.select_pack(g, u, v, thr, k)
        max_err(torch, sel, bsc.select_pack_plain(g, u, v, thr, k))
        vals = all_gather_dc(sel[0]).reshape(2, 4, -1)
        idx = all_gather_dc(sel[1]).reshape(2, 4, -1)
        max_err(torch, [bsc.scatter_add(vals, idx, n, run=k)],
                [bsc.scatter_add_plain(vals, idx, n, k)])
        rec = dict(n=n, k=k)
        if n == 68_224:
            rec.update(
                select_pack_ms=timer(lambda: bsc.select_pack(g, u, v, thr,
                                                             k)),
                select_pack_bound_ms=bound_ms(8 * (5 * n * 4 + k * 8)
                                              + 8 * 4),
                scatter_add_ms=timer(lambda: bsc.scatter_add(vals, idx, n,
                                                             run=k)),
                scatter_add_bound_ms=bound_ms(vals.numel() * 8
                                              + 8 * n * 4))
        out[f"bsc_{n}"] = rec
        log(f"  shard n={n} k={k}: select/pack and scatter-add bit-equal"
            + (f"; select/pack {rec['select_pack_ms'] * 1e3:.1f} us "
               f"(bound {rec['select_pack_bound_ms'] * 1e3:.2f}), "
               f"scatter-add {rec['scatter_add_ms'] * 1e3:.1f} us (bound "
               f"{rec['scatter_add_bound_ms'] * 1e3:.2f})"
               if "select_pack_ms" in rec else ""))

    n = 68_224
    k = comp.k_for(n)
    u, v = rows(n, 0.1, 0.2)
    for name, g in (
            ("broadcast over the workers",
             rows(n, 1.0, lead=(2, 1))[0].expand(2, 4, n)),
            ("transposed", rows(n, 1.0, lead=(4, 2))[0].transpose(0, 1))):
        thr = bsc.sampled_boundary_guv(g, u, v, k)
        sel = bsc.select_pack(g, u, v, thr, k)
        max_err(torch, sel, bsc.select_pack_plain(g.contiguous(), u, v,
                                                  thr, k))
        log(f"  shard select/pack on a {name} view: bit-equal")
    vals = all_gather(sel[0], "worker", tiled=True)
    idx = all_gather(sel[1], "worker", tiled=True)
    if vals.stride(1) != 0:
        raise AssertionError("the tiled all-gather is not a broadcast view")
    max_err(torch, [bsc.scatter_add(vals, idx, n, run=k)],
            [bsc.scatter_add_plain(vals.contiguous(), idx.contiguous(), n,
                                   k)])
    log("  shard scatter-add of the tiled all-gather's broadcast view (four "
        "runs): bit-equal")

    p, g, m, v = rows(n, 1.0, 1e-2, 1e-2, 1e-2)
    v = v.square()
    kw = dict(lr=0.1, momentum=0.9)
    bc1, bc2 = bias_corrections(0.9, 0.999, 7)
    akw = dict(lr=0.01, b1=0.9, b2=0.999, eps=1e-8)
    max_err(torch, optim.fused_sgd_momentum(p, g, m, **kw),
            optim.sgd_momentum_ref(p, g, m, **kw))
    max_err(torch, optim.fused_adam(p, g, m, v, bc1, bc2, **akw),
            optim.adam_ref(p, g, m, v, bc1, bc2, **akw))
    elems = 8 * n
    out["optim_68224"] = dict(
        fused_sgd_momentum_ms=timer(lambda: optim.fused_sgd_momentum(
            p, g, m, **kw)),
        fused_sgd_momentum_bound_ms=bound_ms(elems * 20),
        fused_adam_ms=timer(lambda: optim.fused_adam(p, g, m, v, bc1, bc2,
                                                     **akw)),
        fused_adam_bound_ms=bound_ms(elems * 28))
    r = out["optim_68224"]
    log(f"  shard fused SGD-momentum and Adam over [2, 4, {n}]: bit-equal; "
        f"{r['fused_sgd_momentum_ms'] * 1e3:.1f} us (bound "
        f"{r['fused_sgd_momentum_bound_ms'] * 1e3:.2f}), "
        f"{r['fused_adam_ms'] * 1e3:.1f} us (bound "
        f"{r['fused_adam_bound_ms'] * 1e3:.2f})")
    return out


def optim_kernels(torch, dev, timer, gen, shape):
    """fused_sgd_momentum and fused_adam at the fused paths' shape (every
    replica row of the one bucket) and at the CPU tests' sizes."""
    from geomx_tpu_torch.ops import optim
    from geomx_tpu_torch.optim.adam import bias_corrections

    def rand(*scales):
        return [torch.randn(shape, generator=gen, device=dev) * s
                for s in scales]

    elems = math.prod(shape)
    out = {}
    p, g, m = rand(1.0, 1e-2, 1e-2)
    kw = dict(lr=0.1, momentum=0.9)
    lib = [t.clone() for t in (p, g, m)]
    out["fused_sgd_momentum"] = dict(
        max_abs_err=max_err(torch, optim.fused_sgd_momentum(p, g, m, **kw),
                            optim.sgd_momentum_ref(p, g, m, **kw)),
        ms=timer(lambda: optim.fused_sgd_momentum(p, g, m, **kw)),
        plain_ms=timer(lambda: optim.sgd_momentum_ref(p, g, m, **kw)),
        bound_ms=bound_ms(elems * 20), bound_by="bytes",
        library_ms=timer(lambda: torch._fused_sgd_(
            [lib[0]], [lib[1]], [lib[2]], weight_decay=0.0, momentum=0.9,
            lr=0.1, dampening=0.0, nesterov=False, maximize=False,
            is_first_step=False)))

    v = rand(1e-2)[0].square()
    bc1, bc2 = bias_corrections(0.9, 0.999, 7)
    akw = dict(lr=0.01, b1=0.9, b2=0.999, eps=1e-8)
    lib = [t.clone() for t in (p, g, m, v)]
    steps = [torch.full((), 7.0, device=dev)]
    out["fused_adam"] = dict(
        max_abs_err=max_err(torch, optim.fused_adam(p, g, m, v, bc1, bc2,
                                                    **akw),
                            optim.adam_ref(p, g, m, v, bc1, bc2, **akw)),
        ms=timer(lambda: optim.fused_adam(p, g, m, v, bc1, bc2, **akw)),
        plain_ms=timer(lambda: optim.adam_ref(p, g, m, v, bc1, bc2, **akw)),
        bound_ms=bound_ms(elems * 28), bound_by="bytes",
        # the same function in another op order: a time, not a reference
        library_ms=timer(lambda: torch._fused_adam_(
            [lib[0]], [lib[1]], [lib[2]], [lib[3]], [], steps, lr=0.01,
            beta1=0.9, beta2=0.999, weight_decay=0.0, eps=1e-8,
            amsgrad=False, maximize=False)))

    cpu = torch.Generator().manual_seed(2)
    for n in (1, 1000, 32_768, 300_000):
        p, g, m, v = (torch.randn(n, generator=cpu).to(dev) * s
                      for s in (1.0, 1e-2, 1e-2, 1e-2))
        v = v.square()
        bf = torch.bfloat16
        max_err(torch, optim.fused_sgd_momentum(p, g, m, cast_dtype=bf, **kw),
                optim.sgd_momentum_ref(p, g, m, cast_dtype=bf, **kw))
        max_err(torch, optim.fused_adam(p, g, m, v, bc1, bc2, cast_dtype=bf,
                                        **akw),
                optim.adam_ref(p, g, m, v, bc1, bc2, cast_dtype=bf, **akw))
        log(f"  edge case optimizer n={n} (+ bf16 copy): bit-equal")
    return out


def twobit_inputs(torch, dev, gen, shape):
    """Path 2's quantize operands (g, r) and the all-gathered wire of their
    words, [2, 4, 2 parties, words], through the plain quantize."""
    from geomx_tpu_torch.ops import twobit
    from geomx_tpu_torch.parallel.collectives import all_gather_dc
    g = torch.randn(shape, generator=gen, device=dev) * 0.6
    r = torch.randn(shape, generator=gen, device=dev) * 0.1
    packed, _ = twobit.quantize_2bit_plain(g, r, 0.5)
    return g, r, all_gather_dc(packed).contiguous()


def twobit_kernels(torch, dev, timer, gen, shape):
    """quantize_2bit and the party-summing dequantize_2bit at path 2's
    shape (every replica row, two parties) and at the CPU tests' sizes."""
    from geomx_tpu_torch.ops import twobit

    nrows, n = math.prod(shape[:-1]), shape[-1]
    words = twobit.num_words(n)
    out = {}
    g, r, wire = twobit_inputs(torch, dev, gen, shape)
    got = twobit.quantize_2bit(g, r, 0.5)
    err = max_err(torch, got, twobit.quantize_2bit_plain(g, r, 0.5))
    once_same_bits(torch, twobit.quantize_2bit,
                   lambda: twobit.quantize_2bit(g, r, 0.5), got)
    log("  quantize: one launch a call; two calls give the same bits")
    out["quantize_2bit"] = dict(
        max_abs_err=err,
        ms=timer(lambda: twobit.quantize_2bit(g, r, 0.5)),
        plain_ms=timer(lambda: twobit.quantize_2bit_plain(g, r, 0.5)),
        bound_ms=bound_ms(nrows * (n * 12 + words * 4)), bound_by="bytes",
        library_ms=None)
    parts = wire.shape[-2]
    got = [twobit.dequantize_2bit(wire, n, 0.5, summed=True)]
    err = max_err(torch, got,
                  [twobit.dequantize_2bit_plain(wire, n, 0.5, summed=True)])
    once_same_bits(torch, twobit.dequantize_2bit,
                   lambda: [twobit.dequantize_2bit(wire, n, 0.5,
                                                   summed=True)], got)
    log("  dequantize: one launch a call; two calls give the same bits")
    out["dequantize_2bit"] = dict(
        max_abs_err=err,
        ms=timer(lambda: twobit.dequantize_2bit(wire, n, 0.5, summed=True)),
        plain_ms=timer(lambda: twobit.dequantize_2bit_plain(wire, n, 0.5,
                                                            summed=True)),
        # the fused dequantize + in-order party sum: words in, sum out
        bound_ms=bound_ms(nrows * (parts * words * 4 + n * 4)),
        bound_by="bytes", library_ms=None)

    cpu = torch.Generator().manual_seed(3)
    for n_ in (1, 2047, 2048, 2049, 600_000):
        for thr in (0.5, 0.3):
            g_ = (torch.randn(3, n_, generator=cpu) * 0.6).to(dev)
            r_ = (torch.randn(3, n_, generator=cpu) * 0.1).to(dev)
            if n_ == 600_000 and thr == 0.3:
                g_ = -g_.abs() - 1.0  # every code 2: every sign bit set
            w_, _ = got = twobit.quantize_2bit(g_, r_, thr)
            max_err(torch, got, twobit.quantize_2bit_plain(g_, r_, thr))
            max_err(torch, [twobit.dequantize_2bit(w_, n_, thr)],
                    [twobit.dequantize_2bit_plain(w_, n_, thr)])
            w3 = w_.unsqueeze(0)  # three parties' parts, summed in order
            max_err(torch, [twobit.dequantize_2bit(w3, n_, thr, summed=True)],
                    [twobit.dequantize_2bit_plain(w3, n_, thr, summed=True)])
        log(f"  edge case 2-bit n={n_} (thr 0.5, 0.3): bit-equal")
    quantize_edge_cases(torch, dev, n)
    dequantize_edge_cases(torch, dev, n)
    return out


def dequantize_edge_cases(torch, dev, n) -> None:
    """The summed dequantize on the card tests' edge cases, bit-equal to
    the plain version: [2, 4] rows of 1, 2, 3 and 8 parties' parts at n
    (16-byte quads) and n - 1 (the element-wise branch); packed one word
    off 16-byte alignment (the element-wise branch at n); every code 2
    (every sign bit set), each sum -parts * thr, and at threshold 0
    through the binding, each sum -0.0."""
    from geomx_tpu_torch.ops import twobit
    from geomx_tpu_torch.ops._build import kernels
    cpu = torch.Generator().manual_seed(6)
    for parts in (1, 2, 3, 8):
        for n_ in (n, n - 1):
            g_ = (torch.randn(2, 4, parts, n_, generator=cpu) * 0.6).to(dev)
            w_, _ = twobit.quantize_2bit_plain(g_, torch.zeros_like(g_), 0.5)
            max_err(torch, [twobit.dequantize_2bit(w_, n_, 0.5, summed=True)],
                    [twobit.dequantize_2bit_plain(w_, n_, 0.5, summed=True)])
        g_ = (torch.randn(2, 4, parts, n, generator=cpu) * 0.6).to(dev)
        w_, _ = twobit.quantize_2bit_plain(g_, torch.zeros_like(g_), 0.5)
        off = torch.empty(w_.numel() + 1, dtype=torch.int32,
                          device=dev)[1:].view(w_.shape)
        off.copy_(w_)
        if off.data_ptr() % 16 != 4:
            raise AssertionError("dequantize edge case: packed is aligned")
        max_err(torch, [twobit.dequantize_2bit(off, n, 0.5, summed=True)],
                [twobit.dequantize_2bit_plain(w_, n, 0.5, summed=True)])
        neg = torch.full((2, 4, parts, n), -1.0, device=dev)
        w_, _ = twobit.quantize_2bit_plain(neg, torch.zeros_like(neg), 0.5)
        got = twobit.dequantize_2bit(w_, n, 0.5, summed=True)
        max_err(torch, [got],
                [twobit.dequantize_2bit_plain(w_, n, 0.5, summed=True)])
        if not bool((got == -0.5 * parts).all()):
            raise AssertionError("dequantize: every code 2 does not sum to "
                                 "-parts * thr")
        # threshold 0 (the wrappers refuse it; the binding takes it): a
        # code 2 decodes to -0.0, and the sum of -0.0s is -0.0
        kernels().dequantize_2bit(w_.view(8, parts, -1), n, 0.0,
                                  got.view(8, n))
        if not bool((bits(torch, got) == -0x80000000).all()):
            raise AssertionError("dequantize: threshold 0 loses the sign "
                                 "of -0.0")
        log(f"  edge case dequantize {parts} parts, [2, 4] rows of n={n} and "
            f"{n - 1}, packed one word off 16-byte alignment, every code 2 "
            "(threshold 0.5 and 0): bit-equal")


def quantize_edge_cases(torch, dev, n) -> None:
    """quantize_2bit on the card tests' edge cases, bit-equal to the plain
    version: [2, 4, n_] for n_ % 4 != 0 (the element-wise branch), inputs
    and outputs one float off 16-byte alignment passed to the binding
    directly, and every code 2 over 8 rows of n (the sign bits)."""
    from geomx_tpu_torch.ops import twobit
    from geomx_tpu_torch.ops._build import kernels
    cpu = torch.Generator().manual_seed(5)
    for n_ in (4093, 4094, 4095):
        g_ = (torch.randn(2, 4, n_, generator=cpu) * 0.6).to(dev)
        r_ = (torch.randn(2, 4, n_, generator=cpu) * 0.1).to(dev)
        got = twobit.quantize_2bit(g_, r_, 0.5)
        max_err(torch, got, twobit.quantize_2bit_plain(g_, r_, 0.5))
    log("  edge case 2-bit [2, 4, n] n=4093, 4094, 4095: bit-equal")
    words = twobit.num_words(n)
    for off_in, off_out in ((1, 0), (0, 1)):
        def rows(count, off, scale=1.0, dtype=torch.float32):
            flat = torch.randn(8 * count + 1, generator=cpu) * scale
            return flat.to(dev, dtype)[off:off + 8 * count].view(8, count)
        g_, r_ = rows(n, off_in, 0.6), rows(n, off_in, 0.1)
        new_r, packed = rows(n, off_out), rows(words, off_out,
                                               dtype=torch.int32)
        if g_.data_ptr() % 16 != 4 * off_in or \
                new_r.data_ptr() % 16 != 4 * off_out:
            raise AssertionError("2-bit edge case: not the alignment meant")
        kernels().quantize_2bit(g_, r_, 0.5, packed, new_r)
        max_err(torch, [packed, new_r], twobit.quantize_2bit_plain(g_, r_,
                                                                   0.5))
    log(f"  edge case 2-bit 8 x {n}, inputs and outputs one float off "
        "16-byte alignment: bit-equal")
    g_ = torch.full((2, 4, n), -1.0, device=dev)
    packed, _ = got = twobit.quantize_2bit(g_, torch.zeros_like(g_), 0.5)
    max_err(torch, got, twobit.quantize_2bit_plain(g_, torch.zeros_like(g_),
                                                   0.5))
    full = (n // 2048) * 128
    if not bool((packed[..., :full] == -0x55555556).all()):
        raise AssertionError("2-bit: a complete word of code 2 is not "
                             "0xAAAAAAAA")
    log(f"  edge case 2-bit every code 2, 8 x {n}: bit-equal, sign bits set")


def merge_inputs(torch, dev, gen, n):
    """Path 3's merge operands: the owner-routed pairs of a sampled BSC
    select of the ResNet-20 bucket on [4, 2], after the all_to_all
    ([4, 2, 4 x 1,371] values and indices), and the party count."""
    from geomx_tpu_torch.compression import BiSparseCompressor, sparseagg
    from geomx_tpu_torch.parallel.collectives import all_to_all

    P, W = PATHS["sparse_agg"][6]
    comp = BiSparseCompressor(0.01)
    k = comp.k_for(n)
    g, u, v = (torch.randn(P, W, n, generator=gen, device=dev) * s
               for s in (1.0, 0.1, 0.2))
    vals, idx, _, _ = comp.compress(g, u, v)
    slots = sparseagg.push_slots(k, P)
    bv, bi, _, _ = sparseagg.owner_route(vals, idx, n, P, slots)
    rv = all_to_all(bv, "dc").reshape(P, W, P * slots).contiguous()
    ri = all_to_all(bi, "dc").reshape(P, W, P * slots).contiguous()
    return rv, ri, P


def merge_kernels(torch, dev, timer, gen, n):
    """merge_sorted_pairs at path 3's shapes (merge_inputs) and on edge
    cases.  ``ms`` times the kernel over the sorted columns, ``plain_ms``
    its plain version (the ranks and the tree); the whole wrapper (with
    the sort in PyTorch ops) is logged beside.  On the card the wrapper
    computes no ranks: the kernel finds the heads from the keys."""
    from geomx_tpu_torch.ops import merge

    rv, ri, P = merge_inputs(torch, dev, gen, n)
    ranks_built = []
    segment_ranks = merge.segment_ranks
    merge.segment_ranks = lambda skey: ranks_built.append(1) or \
        segment_ranks(skey)
    try:
        got = merge.merge_sorted_pairs(rv, ri, P)
    finally:
        merge.segment_ranks = segment_ranks
    if ranks_built:
        raise AssertionError("merge_sorted_pairs built ranks on the card")
    err = max_err(torch, got, merge.merge_sorted_pairs_plain(rv, ri, P))
    once_same_bits(torch, merge.merge_sorted_pairs,
                   lambda: merge.merge_sorted_pairs(rv, ri, P), got)
    log("  merge: one launch a call, no ranks built; two calls give the "
        "same bits")
    svals, skey = merge.sort_pairs(rv, ri)
    rounds = merge.merge_rounds(P)
    rows, m = math.prod(rv.shape[:-1]), rv.shape[-1]
    # another output format: one total per (row, key) segment, sentinel
    # segments included
    flat_key = (torch.arange(rows, device=dev).view(rv.shape[:-1] + (1,))
                << 32) + skey
    _, lengths = torch.unique_consecutive(flat_key.view(-1),
                                          return_counts=True)
    flat_vals = svals.reshape(-1)
    res = dict(
        max_abs_err=err,
        ms=timer(lambda: merge.merge_tree(svals, skey, rounds)),
        plain_ms=timer(lambda: merge.merge_tree_plain(
            svals, skey, merge.segment_ranks(skey)[0], rounds)),
        # the values and keys in, the merged pairs out
        bound_ms=bound_ms(rows * m * 16), bound_by="bytes",
        library_ms=timer(lambda: torch.segment_reduce(flat_vals, "sum",
                                                      lengths=lengths)),
        wrapper_ms=timer(lambda: merge.merge_sorted_pairs(rv, ri, P)),
        plain_wrapper_ms=timer(lambda: merge.merge_sorted_pairs_plain(
            rv, ri, P)),
        merged_pairs=int((got[1] >= 0).sum()), pairs=rows * m)
    log(f"  merge at path 3's shapes: {list(rv.shape[:-1])} rows of {m} "
        f"pairs, {res['merged_pairs']} merged of {rows * m}, bit-equal")

    cpu = torch.Generator().manual_seed(4)

    def pairs(parties, k_, n_, sentinel_frac=0.15):
        vs, ix = [], []
        for _ in range(parties):
            i_ = torch.randperm(n_, generator=cpu)[:k_].to(torch.int32)
            v_ = torch.randn(k_, generator=cpu)
            drop = torch.rand(k_, generator=cpu) < sentinel_frac
            vs.append(torch.where(drop, 0.0, v_))
            ix.append(torch.where(drop, -1, i_))
        return torch.cat(vs), torch.cat(ix)

    same = torch.randperm(50_000, generator=cpu)[:700].to(torch.int32)
    # keys 0, 1, 2, ... with one index 7 times from position 252 on: its
    # segment straddles the kernel's 256-position tile; the last key is
    # unique, so column m - 1 is a head
    straddle = torch.cat([torch.arange(253), torch.full((6,), 252),
                          torch.arange(253, 600)]).to(torch.int32)
    cases = {
        "P=1": (*pairs(1, 900, 5000), 1),
        "P=2": (*pairs(2, 1371, 272_512), 2),
        "P=3": (*pairs(3, 1000, 4000), 3),
        "P=8": (*pairs(8, 685, 20_000), 8),
        "all sentinels": (torch.zeros(4000), torch.full((4000,), -1,
                                                        dtype=torch.int32), 4),
        "every party the same indices": (torch.randn(4 * 700, generator=cpu),
                                         same.repeat(4), 4),
        "segment longer than 2^rounds": (
            torch.randn(40, generator=cpu),
            torch.tensor([5] * 3 + [2] * 29 + [-1] * 4 + [0] * 4,
                         dtype=torch.int32), 3),
        "segment across a tile, head at m - 1": (
            torch.randn(straddle.numel(), generator=cpu), straddle, 8),
        "m=1": (torch.randn(1, generator=cpu),
                torch.tensor([7], dtype=torch.int32), 4),
        "m below the halo": (torch.randn(5, generator=cpu),
                             torch.tensor([3, 1, 3, 9, 1],
                                          dtype=torch.int32), 64),
        "m=5483": (*(t[:5483] for t in pairs(4, 1371, 272_512)), 4),
    }
    for name, (v_, i_, dup) in cases.items():
        v_, i_ = v_.to(dev), i_.to(dev)
        rows_ = (torch.stack([v_, v_.flip(0), v_ * 2]),
                 torch.stack([i_, i_.flip(0), i_]))
        for a, b in ((v_, i_), rows_):
            max_err(torch, merge.merge_sorted_pairs(a, b, dup),
                    merge.merge_sorted_pairs_plain(a, b, dup))
        log(f"  edge case merge {name}: m={v_.numel()} max_duplicates={dup} "
            "(one row and three rows): bit-equal")
    return {"merge_sorted_pairs": res}


def sdpa_kernels(torch, fn) -> str:
    """Names of the CUDA kernels one call of ``fn`` runs (the backend
    ``scaled_dot_product_attention`` picked), from the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    return ", ".join(dict.fromkeys(n[:60] for n in names)) or "not identified"


def attention_kernels(torch, dev, timer=None):
    """Rows 10-13 against their plain versions at the attention paths'
    shapes (seq_flash: q, k, v [16, 4096, 4, 16]; seq_ring's hop: [32 = sp
    2 x 16, 128, 4, 16]) and on the JAX tests' edge cases.  Held at fp32
    rtol/atol 1e-5 forward, 1e-4 backward and hop, 2e-2/1e-2 for bf16
    inputs: the kernels sum each row's products in another order than the
    plain versions' matmuls, all four in split TF32 on the tensor
    cores).  Two calls of each kernel must give the same bits.  Times
    over 20 calls; the bound is attn_bound()'s, with the fp32 CUDA-core
    bound beside it."""
    import torch.nn.functional as F

    from geomx_tpu_torch.ops import flash_attention as fa
    from geomx_tpu_torch.ops import ring_hop

    timer = timer or (lambda fn: device_ms(torch, fn, reps=20))
    gen = torch.Generator(device=dev).manual_seed(10)

    def rand(shape, n, dtype=torch.float32):
        return [torch.randn(shape, generator=gen, device=dev).to(dtype)
                for _ in range(n)]

    out = {}
    B, L, H, D = 16, 4096, 4, 16
    q, k, v, g = rand((B, L, H, D), 4)
    elems, rows, pairs = B * L * H * D, B * H * L, B * H * L * L
    o, lse = fa.flash_attention_with_lse(q, k, v)
    ro, rlse = fa.flash_attention_with_lse_plain(q, k, v)
    # no atomics: a second call, and the variant without the logsumexp,
    # give the same bits
    o2, lse2 = fa.flash_attention_with_lse(q, k, v)
    if not (torch.equal(o, o2) and torch.equal(lse, lse2)
            and torch.equal(fa.flash_attention(q, k, v), o)):
        raise AssertionError("flash forward: two calls, or the two "
                             "variants, differ")
    log("  flash forward: two calls, and the no-lse variant, give the "
        "same bits")
    qt, kt, vt, gt = (x.transpose(1, 2).contiguous() for x in (q, k, v, g))
    sdpa = (lambda: F.scaled_dot_product_attention(qt, kt, vt))
    out["flash_attention_fwd"] = attn_record(
        4 * (4 * elems + rows), 4 * pairs * D, pairs,
        max_abs_err=close_err(torch, [o, lse], [ro, rlse], 1e-5, 1e-5),
        ms=timer(lambda: fa.flash_attention_with_lse(q, k, v)),
        nolse_ms=timer(lambda: fa.flash_attention(q, k, v)),
        plain_ms=timer(lambda: fa.flash_attention_with_lse_plain(q, k, v)),
        library_ms=timer(sdpa),
        library="scaled_dot_product_attention forward: "
        + sdpa_kernels(torch, sdpa))
    delta = fa.attention_delta(ro, g)
    dq = fa.flash_dq(q, k, v, g, rlse, delta)
    rdq = fa.flash_dq_plain(q, k, v, g, rlse, delta)
    dk, dv = fa.flash_dkv(q, k, v, g, rlse, delta)
    rdk, rdv = fa.flash_dkv_plain(q, k, v, g, rlse, delta)
    # no atomics: a second call gives the same bits
    if not (torch.equal(dq, fa.flash_dq(q, k, v, g, rlse, delta)) and all(
            torch.equal(a, b) for a, b in
            zip((dk, dv), fa.flash_dkv(q, k, v, g, rlse, delta)))):
        raise AssertionError("flash backward: two calls differ")
    log("  flash dq, dk/dv: two calls give the same bits")
    # the library's backward: one autograd call over a retained graph
    # computes dq, dk and dv together (rows 11 and 12 at once)
    qg, kg, vg = (x.clone().requires_grad_() for x in (qt, kt, vt))
    so = F.scaled_dot_product_attention(qg, kg, vg)
    sdpa_bwd = (lambda: torch.autograd.grad(so, (qg, kg, vg), gt,
                                            retain_graph=True))
    lib_bwd = timer(sdpa_bwd)
    lib_fwd_bwd = timer(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qg, kg, vg), (qg, kg, vg), gt))
    lib_name = ("scaled_dot_product_attention backward (dq, dk and dv): "
                + sdpa_kernels(torch, sdpa_bwd))
    out["flash_attention_dq"] = attn_record(
        4 * (5 * elems + 2 * rows), 6 * pairs * D, pairs,
        max_abs_err=close_err(torch, [dq], [rdq], 1e-4, 1e-4),
        ms=timer(lambda: fa.flash_dq(q, k, v, g, rlse, delta)),
        plain_ms=timer(lambda: fa.flash_dq_plain(q, k, v, g, rlse, delta)),
        library_ms=lib_bwd, library=lib_name,
        library_fwd_bwd_ms=lib_fwd_bwd)
    out["flash_attention_dkv"] = attn_record(
        4 * (6 * elems + 2 * rows), 8 * pairs * D, pairs,
        max_abs_err=close_err(torch, [dk, dv], [rdk, rdv], 1e-4, 1e-4),
        ms=timer(lambda: fa.flash_dkv(q, k, v, g, rlse, delta)),
        plain_ms=timer(lambda: fa.flash_dkv_plain(q, k, v, g, rlse, delta)),
        library_ms=lib_bwd, library=lib_name,
        library_fwd_bwd_ms=lib_fwd_bwd)
    del qg, kg, vg, so

    # the ring hop at seq_ring's shape, a later hop (finite carries)
    hs = (32, 128, 4, 16)
    hq, hk, hv, ho = rand(hs, 4)
    hm = rand(hs[:1] + (4, 128), 1)[0]
    hl = hm.abs() + 0.5
    scale = 0.25
    got = ring_hop.hop(hq, hk, hv, hm, hl, ho, scale, False)
    hop_pairs, hop_elems = 32 * 4 * 128 * 128, math.prod(hs)
    hop_args = (hq, hk, hv, hm, hl, ho, scale, False)
    for diag in (False, True):
        a = ring_hop.hop(*hop_args[:-1], diag)
        if not all(torch.equal(x, y) for x, y in
                   zip(a, ring_hop.hop(*hop_args[:-1], diag))):
            raise AssertionError(f"ring hop diag={diag}: two calls differ")
    log("  ring hop, full and diagonal: two calls give the same bits")
    out["fused_block"] = attn_record(
        4 * (6 * hop_elems + 4 * 32 * 4 * 128), 4 * hop_pairs * 16,
        hop_pairs,
        max_abs_err=close_err(torch, got, ring_hop.hop_plain(*hop_args),
                              1e-4, 1e-4),
        ms=timer(lambda: ring_hop.hop(*hop_args)),
        plain_ms=timer(lambda: ring_hop.hop_plain(*hop_args)),
        library_ms=None)

    # -- edge cases of the JAX tests ------------------------------------------
    cases = [((1, 100, 2, 16), True, torch.float32),
             ((1, 100, 2, 16), False, torch.float32),
             ((1, 16, 1, 8), True, torch.float32),
             ((2, 64, 4, 32), True, torch.float32),
             ((2, 128, 4, 64), False, torch.float32),
             ((1, 96, 2, 128), True, torch.float32),
             ((1, 20, 1, 8), True, torch.float32),
             ((2, 64, 4, 32), False, torch.bfloat16),
             ((1, 100, 2, 16), True, torch.bfloat16)]
    for shape, causal, dtype in cases:
        fwd, bwd = ((1e-5, 1e-5), (1e-4, 1e-4)) if dtype == torch.float32 \
            else ((2e-2, 2e-2), (1e-2, 1e-2))
        eq, ek, ev, eg = rand(shape, 4, dtype)
        eo, el = fa.flash_attention_with_lse(eq, ek, ev, causal)
        po, pl = fa.flash_attention_with_lse_plain(eq, ek, ev, causal)
        err = close_err(torch, [eo, el], [po, pl], *fwd)
        if not torch.equal(fa.flash_attention(eq, ek, ev, causal), eo):
            raise AssertionError(f"{shape}: the no-lse variant differs")
        ed = fa.attention_delta(po, eg)
        err = max(err, close_err(
            torch, [fa.flash_dq(eq, ek, ev, eg, pl, ed, causal),
                    *fa.flash_dkv(eq, ek, ev, eg, pl, ed, causal)],
            [fa.flash_dq_plain(eq, ek, ev, eg, pl, ed, causal),
             *fa.flash_dkv_plain(eq, ek, ev, eg, pl, ed, causal)], *bwd))
        log(f"  edge case flash {shape} causal={causal} "
            f"{str(dtype)[6:]}: forward, dq, dk/dv within tolerance "
            f"(max abs err {err:.3g})")
    # fully-masked rows: no key at all -> zeros and lse at the sentinel
    z0, zl = fa.flash_attention_with_lse(q[:1, :100], k[:1, :0], v[:1, :0])
    if not (torch.equal(z0, torch.zeros_like(z0)) and bool((zl <= -1e29)
                                                           .all())):
        raise AssertionError("fully-masked rows are not zero")
    log("  edge case flash, no key for any row: zeros, lse -1e30")
    for dtype in (torch.float32, torch.bfloat16):
        for hops_done in (0, 1):
            for diag in (False, True):
                eq, ek, ev = rand(hs, 3, dtype)
                if hops_done == 0:
                    em = torch.full(hm.shape, -math.inf, device=dev)
                    el, eo = torch.zeros_like(hl), torch.zeros_like(ho)
                else:
                    em, el, eo = hm, hl, ho
                tol = (1e-4, 1e-4) if dtype == torch.float32 else (1e-2, 1e-2)
                got = ring_hop.hop(eq, ek, ev, em, el, eo, scale, diag)
                if not all(bool(torch.isfinite(t).all()) for t in got):
                    raise AssertionError("ring hop: non-finite carries")
                err = close_err(torch, got, ring_hop.hop_plain(
                    eq, ek, ev, em, el, eo, scale, diag), *tol)
                log(f"  edge case ring hop hops_done={hops_done} "
                    f"diag={diag} {str(dtype)[6:]}: within tolerance "
                    f"(max abs err {err:.3g})")
    return out


def head_dim_phase(torch, dev, timer=None):
    """Rows 10-13 at head dim 256, which the kernels run on the wide route
    (each block two 128-wide chunks of its output): the forward, dq and
    dk/dv at seq_flash's B, L, H (q, k, v [16, 4096, 4, 256]) and the hop
    at seq_ring's ([32, 128, 4, 256]), held to the fp32 gates (1e-5
    forward, 1e-4 backward and hop), two calls giving the same bits, with
    times over 20 calls, attn_bound()'s bound, and
    scaled_dot_product_attention's time at the same shape."""
    import torch.nn.functional as F

    from geomx_tpu_torch.ops import flash_attention as fa
    from geomx_tpu_torch.ops import ring_hop

    timer = timer or (lambda fn: device_ms(torch, fn, reps=20))
    gen = torch.Generator(device=dev).manual_seed(11)

    def rand(shape, n):
        return [torch.randn(shape, generator=gen, device=dev)
                for _ in range(n)]

    out = {}
    B, L, H, D = 16, 4096, 4, 256
    q, k, v, g = rand((B, L, H, D), 4)
    elems, rows, pairs = B * L * H * D, B * H * L, B * H * L * L
    o, lse = fa.flash_attention_with_lse(q, k, v)
    ro, rlse = fa.flash_attention_with_lse_plain(q, k, v)
    o2, lse2 = fa.flash_attention_with_lse(q, k, v)
    if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
        raise AssertionError("flash forward, D = 256: two calls differ")
    qt, kt, vt, gt = (x.transpose(1, 2).contiguous() for x in (q, k, v, g))
    sdpa = (lambda: F.scaled_dot_product_attention(qt, kt, vt))
    out["flash_attention_fwd"] = attn_record(
        4 * (4 * elems + rows), 4 * pairs * D, pairs,
        max_abs_err=close_err(torch, [o, lse], [ro, rlse], 1e-5, 1e-5),
        ms=timer(lambda: fa.flash_attention_with_lse(q, k, v)),
        plain_ms=timer(lambda: fa.flash_attention_with_lse_plain(q, k, v)),
        library_ms=timer(sdpa),
        library="scaled_dot_product_attention forward: "
        + sdpa_kernels(torch, sdpa))
    del o, o2, lse2
    delta = fa.attention_delta(ro, g)
    dq = fa.flash_dq(q, k, v, g, rlse, delta)
    dk, dv = fa.flash_dkv(q, k, v, g, rlse, delta)
    if not (torch.equal(dq, fa.flash_dq(q, k, v, g, rlse, delta)) and all(
            torch.equal(a, b) for a, b in
            zip((dk, dv), fa.flash_dkv(q, k, v, g, rlse, delta)))):
        raise AssertionError("flash backward, D = 256: two calls differ")
    qg, kg, vg = (x.clone().requires_grad_() for x in (qt, kt, vt))
    so = F.scaled_dot_product_attention(qg, kg, vg)
    sdpa_bwd = (lambda: torch.autograd.grad(so, (qg, kg, vg), gt,
                                            retain_graph=True))
    lib_bwd = timer(sdpa_bwd)
    lib_name = ("scaled_dot_product_attention backward (dq, dk and dv): "
                + sdpa_kernels(torch, sdpa_bwd))
    del qg, kg, vg, so
    out["flash_attention_dq"] = attn_record(
        4 * (5 * elems + 2 * rows), 6 * pairs * D, pairs,
        max_abs_err=close_err(
            torch, [dq], [fa.flash_dq_plain(q, k, v, g, rlse, delta)],
            1e-4, 1e-4),
        ms=timer(lambda: fa.flash_dq(q, k, v, g, rlse, delta)),
        plain_ms=timer(lambda: fa.flash_dq_plain(q, k, v, g, rlse, delta)),
        library_ms=lib_bwd, library=lib_name)
    del dq
    out["flash_attention_dkv"] = attn_record(
        4 * (6 * elems + 2 * rows), 8 * pairs * D, pairs,
        max_abs_err=close_err(
            torch, [dk, dv], fa.flash_dkv_plain(q, k, v, g, rlse, delta),
            1e-4, 1e-4),
        ms=timer(lambda: fa.flash_dkv(q, k, v, g, rlse, delta)),
        plain_ms=timer(lambda: fa.flash_dkv_plain(q, k, v, g, rlse, delta)),
        library_ms=lib_bwd, library=lib_name)
    del dk, dv, q, k, v, g, qt, kt, vt, gt, ro, rlse, delta

    hs = (32, 128, 4, D)
    hq, hk, hv, ho = rand(hs, 4)
    hm = rand(hs[:1] + (4, 128), 1)[0]
    hop_args = (hq, hk, hv, hm, hm.abs() + 0.5, ho, 1.0 / 16, False)
    got = ring_hop.hop(*hop_args)
    for diag in (False, True):
        a = ring_hop.hop(*hop_args[:-1], diag)
        if not all(torch.equal(x, y) for x, y in
                   zip(a, ring_hop.hop(*hop_args[:-1], diag))):
            raise AssertionError(f"ring hop D = 256 diag={diag}: two calls "
                                 "differ")
        close_err(torch, a, ring_hop.hop_plain(*hop_args[:-1], diag),
                  1e-4, 1e-4)
    hop_pairs, hop_elems = 32 * 4 * 128 * 128, math.prod(hs)
    out["fused_block"] = attn_record(
        4 * (6 * hop_elems + 4 * 32 * 4 * 128), 4 * hop_pairs * D,
        hop_pairs,
        max_abs_err=close_err(torch, got, ring_hop.hop_plain(*hop_args),
                              1e-4, 1e-4),
        ms=timer(lambda: ring_hop.hop(*hop_args)),
        plain_ms=timer(lambda: ring_hop.hop_plain(*hop_args)),
        library_ms=None)
    for name, r in out.items():
        lib = "-" if r["library_ms"] is None \
            else f"{r['library_ms'] * 1e3:.1f} us"
        log(f"head dim 256 {name}: {r['ms'] * 1e3:.1f} us (plain "
            f"{r['plain_ms'] * 1e3:.1f} us, library {lib}, bound "
            f"{r['bound_ms'] * 1e3:.2f} us by {r['bound_kind']}), max abs "
            f"err {r['max_abs_err']:.3g}; two calls give the same bits"
            + (f"; library: {r['library']}" if "library" in r else ""))
    return out


def seq_reference_phase(torch):
    """Two fp32 steps of each attention configuration (SEQ_REFERENCE) on
    the card vs on the CPU (plain versions), from the same weights and
    batches: losses to rtol 1e-4; parameters to atol 4e-3 — Adam moves a
    coordinate by about lr = 1e-3 a step whatever its gradient's size, so
    a near-zero gradient whose sign differs between the devices (another
    order of sums) can part them by 2 lr a step."""
    from geomx_tpu_torch.data import make_needle_data, with_positions

    for name, (sp_mode, shape, L) in SEQ_REFERENCE.items():
        P, W, _ = shape
        x, y = make_needle_data(P * W * 8 * 2, L, seed=2)
        runs = {}
        for device in ("cuda", "cpu"):
            t = make_seq_trainer(sp_mode, shape, L, device=device)
            st = t.init_state(seed=0)
            losses = []
            for xb, yb in t.make_loader(with_positions(x), y, 8).epoch(0):
                st, m = t.train_step(st, xb, yb)
                losses.append(float(m["loss"]))
            runs[device] = (losses, {k: v.cpu() for k, v in st.params.items()})
        (gl, gp), (cl, cp) = runs["cuda"], runs["cpu"]
        for a, b in zip(gl, cl):
            if not math.isfinite(a) or abs(a - b) > 1e-4 * abs(b):
                raise AssertionError(f"{name}: card losses {gl} vs CPU {cl}")
        worst = max((gp[k] - cp[k]).abs().max().item() for k in cp)
        if worst > 4e-3:
            raise AssertionError(f"{name}: card and CPU params differ by "
                                 f"{worst}")
        log(f"reference {name}: card losses {gl} CPU losses {cl} max param "
            f"diff {worst:.3g}")


def reference_phase(torch):
    """Two fp32 steps on the card vs on the CPU, for each path's
    configuration and REFERENCE_ONLY's (HFA at K1 1, K2 2: both tiers
    fire): a small ResNet where the configuration names ResNet-20, the
    named zoo model at full width otherwise (on its MODEL_DATA shape).
    Losses to rtol 1e-4 and every replica's parameters to atol 2e-3.
    The zoo models run their convolutions on the card without cuDNN
    (``torch.backends.cudnn.enabled = False``: PyTorch's direct
    convolution, im2col and one GEMM): cuDNN's fp32 weight gradients of
    AlexNet's convolutions part from the CPU's by about 1% of their
    largest magnitude and leave residue where the exact sum is 0
    (tools/torch_conv_gap.py), which moves coordinates across BSC's
    magnitude boundary and, under Adam or LAMB, such a coordinate by
    about the learning rate.  The paths themselves run cuDNN."""
    from geomx_tpu_torch.data import load_dataset
    from geomx_tpu_torch.models import ResNet

    data = load_dataset("synthetic", synthetic_train_n=512)
    small = data["train_x"][:, :16, :16]
    for path in list(PATHS) + list(REFERENCE_ONLY):
        name = (PATHS[path] if path in PATHS else REFERENCE_ONLY[path])[0]
        if name == "resnet20":
            x, y = small, data["train_y"]
        else:
            zoo = path_data(path, 512)
            x, y = zoo["train_x"], zoo["train_y"]
        runs = {}
        for device in ("cuda", "cpu"):
            model = ResNet((1, 1, 1), (8, 16, 32), dtype=torch.float32) \
                if name == "resnet20" else None
            t = make_trainer(path, model, device=device, precision="fp32",
                             **REFERENCE_FIELDS.get(path, {}))
            st = t.init_state(seed=0, sample_input=x[:2])
            losses = []
            torch.backends.cudnn.enabled = name == "resnet20"
            try:
                for i, (xb, yb) in enumerate(
                        t.make_loader(x, y, 8).epoch(0)):
                    if i == 2:
                        break
                    st, m = t.train_step(st, xb, yb)
                    losses.append(float(m["loss"]))
            finally:
                torch.backends.cudnn.enabled = True
            runs[device] = (losses, {k: v.cpu()
                                     for k, v in st.params.items()})
        (gl, gp), (cl, cp) = runs["cuda"], runs["cpu"]
        for a, b in zip(gl, cl):
            if not math.isfinite(a) or abs(a - b) > 1e-4 * abs(b):
                raise AssertionError(f"{path}: card losses {gl} vs CPU {cl}")
        worst = max((gp[k] - cp[k]).abs().max().item() for k in cp)
        if worst > 2e-3:
            raise AssertionError(f"{path}: card and CPU params differ by "
                                 f"{worst}")
        log(f"reference {path} ({name}"
            + ("" if name == "resnet20" else ", cuDNN off")
            + f"): card losses {gl} CPU losses {cl} max param diff "
            f"{worst:.3g}")


def zero_identity(torch) -> float:
    """zero_dense's three fp32 steps on the card against the replicated
    update's from the same weights and batches (the uncompressed dc
    tier): the params within 1e-6 (tests/test_zero.py:93-100).  Returns
    the largest difference."""
    from geomx_tpu_torch.data import load_dataset
    from geomx_tpu_torch.models import ResNet

    data = load_dataset("synthetic", synthetic_train_n=512)
    x = data["train_x"][:, :16, :16]
    params = []
    for zero in (True, False):
        t = make_trainer("zero_dense", ResNet((1, 1, 1), (8, 16, 32),
                                              dtype=torch.float32),
                         device="cuda", precision="fp32", zero=zero)
        st = t.init_state(seed=0)
        for i, (xb, yb) in enumerate(t.make_loader(x, data["train_y"],
                                                   8).epoch(0)):
            if i == 3:
                break
            st, _ = t.train_step(st, xb, yb)
        params.append(st.params)
    worst = max((params[0][k] - params[1][k]).abs().max().item()
                for k in params[0])
    if not worst <= 1e-6:
        raise AssertionError(f"zero_dense: the ZeRO params differ from the "
                             f"replicated update's by {worst}")
    log(f"reference zero_dense: 3 steps on the card, ZeRO vs the replicated "
        f"update max param diff {worst:.3g} (limit 1e-6)")
    return worst


def state_bytes(torch, tree) -> int:
    """Bytes of the tensors of a state tree (dicts, lists, tuples)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(state_bytes(torch, v) for v in tree)
    return 0


def tensors(torch, tree, path=""):
    """(path, tensor) pairs of a state tree."""
    if isinstance(tree, torch.Tensor):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in tensors(torch, v, f"{path}.{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in tensors(torch, v, f"{path}[{i}]")]
    return []


def dc_tier(sync):
    """A sync algorithm's dc-tier compressor, and its dc state's key
    path (a pipelined sync's lives under its inner algorithm)."""
    if hasattr(sync, "dc_compressor"):
        return sync.dc_compressor, ("dc_comp",)
    return sync.inner.dc_compressor, ("inner", "dc_comp")


def sharded_checks(torch, path: str, trainer, state, res: dict) -> None:
    """A sharded path after its run.  The optimizer state of a shard
    ([P, W, s]) is the same in every party and differs across the
    workers, by design (a replicated leaf's, under MultiGPS, is the same
    in every slot); the dc-tier state is shard-shaped (each party keeps
    its own residuals, so it is not compared across parties).  Then the
    per-slot bytes of the optimizer plus dc-tier state and the computed
    dc wire bytes a slot, against the replicated twin (SHARDED_TWIN) on
    the same weights."""
    from geomx_tpu_torch.models import get_model
    from geomx_tpu_torch.tree import leaf_names

    P, W = trainer.topology.replica_shape
    zplan, mgps = trainer._zero_plan, trainer._mgps
    names = list(state.params)
    sizes = {k: state.params[k][0, 0].numel() for k in names}
    if zplan is not None:
        bk = zplan.bucketed.zero_bucketer([state.params[k] for k in
                                           leaf_names(state.params)])
        shard_lens = {n // W for n in bk.bucket_sizes}
    else:
        shard_lens = {mgps.shard_len(n) for n in sizes.values()
                      if mgps.is_big(n)}

    def big(name):
        """Whether a state tensor at ``name`` belongs to a sharded leaf
        (every tensor under ZeRO; a big leaf's under MultiGPS)."""
        if zplan is not None:
            return True
        base = name.split("[")[0]
        leaf = next(k for k in names if base.endswith("." + k))
        return mgps.is_big(sizes[leaf])

    n_sharded = 0
    for name, t in tensors(torch, state.opt_state):
        if not big(name):
            if not torch.equal(t, t[:1, :1].expand_as(t)):
                raise AssertionError(f"{path}: replicated optimizer state "
                                     f"{name} diverged across slots")
            continue
        if t.shape[:2] != (P, W) or t.shape[2] not in shard_lens:
            raise AssertionError(f"{path}: optimizer state {name} "
                                 f"{tuple(t.shape)} is not shard-shaped")
        if not torch.equal(t, t[:1].expand_as(t)):
            raise AssertionError(f"{path}: optimizer shard {name} differs "
                                 "across parties")
        if torch.equal(t[:, 0], t[:, 1]):
            raise AssertionError(f"{path}: optimizer shard {name} is the "
                                 "same on workers 0 and 1")
        n_sharded += 1
    if not n_sharded:
        raise AssertionError(f"{path}: no sharded optimizer state")
    _, key = dc_tier(trainer.sync)
    dc_state = state.sync_state
    for k in key:
        dc_state = dc_state[k]
    for name, t in tensors(torch, dc_state):
        if big(name):
            if t.shape[2] not in shard_lens:
                raise AssertionError(f"{path}: dc-tier state {name} "
                                     f"{tuple(t.shape)} is not "
                                     "shard-shaped")

    twin = make_trainer(path, get_model("resnet20"), device=trainer.device,
                        **SHARDED_TWIN[path])
    tstate = twin.init_state(seed=0)
    _, tkey = dc_tier(twin.sync)
    tdc = tstate.sync_state
    for k in tkey:
        tdc = tdc[k]
    slot = {"sharded": (state_bytes(torch, state.opt_state)
                        + state_bytes(torch, dc_state)) / (P * W),
            "replicated": (state_bytes(torch, tstate.opt_state)
                           + state_bytes(torch, tdc)) / (P * W)}
    twin_dc, _ = dc_tier(twin.sync)
    if zplan is not None:
        wire = zplan.bucketed.shard_wire_bytes(state.params, W)
    else:
        wire = trainer.sync.dc_compressor.wire_bytes(
            mgps.mixed_example(state.params))
    res.update(slot_state_bytes=slot,
               slot_state_ratio=slot["sharded"] / slot["replicated"],
               dc_wire_bytes_per_slot=wire,
               dc_wire_bytes_replicated=twin_dc.wire_bytes(tstate.params),
               sharded_optimizer_tensors=n_sharded)
    del twin, tstate, tdc
    log(f"path {path}: optimizer + dc-tier state a slot "
        f"{slot['sharded']:.0f} B sharded vs {slot['replicated']:.0f} B "
        f"replicated (ratio {res['slot_state_ratio']:.4f}); dc wire bytes a "
        f"slot {wire} vs {res['dc_wire_bytes_replicated']} replicated "
        f"(computed); {n_sharded} sharded optimizer tensors, each the same "
        "in both parties and distinct across workers")


def code_density(torch, words, n: int) -> float:
    """Share of non-zero 2-bit codes among the ``n`` elements of each
    ``[..., words]`` part (padding codes are zero)."""
    shifts = torch.arange(0, 32, 2, dtype=torch.int32, device=words.device)
    codes = (words.unsqueeze(-1) >> shifts) & 3
    return int((codes != 0).sum()) / (math.prod(words.shape[:-1]) * n)


def to_device(torch, obj, device):
    """A state tree (tensors in dicts, lists and tuples) on ``device``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: to_device(torch, v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_device(torch, v, device) for v in obj)
    return obj


def drain_check(torch, path: str, trainer, state, res: dict):
    """A pipelined path after its run: ``Trainer.drain_pipeline`` moves
    the params by exactly one optimizer apply of the parked aggregate
    (the in-flight buckets unflattened and divided by P; under ZeRO the
    in-flight shards divided by P through ``apply_shard_update``), lands the
    parked BatchNorm statistics, zeroes the buffer, and gives the bits
    the same drain of the same state gives on the CPU.  Returns the
    drained state."""
    import dataclasses

    from geomx_tpu_torch.models import get_model
    from geomx_tpu_torch.tree import leaf_names

    names = leaf_names(state.params)
    inflight = state.sync_state["inner"]["dc_comp"]["inflight"]
    P = trainer.topology.num_parties
    if trainer._zero_plan is not None:
        # ZeRO: the parked [P, W, n/W] shard aggregates through the one
        # shard-update path (the fused kernels when bound)
        want, _ = trainer._zero_plan.apply_shard_update(
            trainer.tx, [b / P for b in inflight], state.params,
            state.opt_state)
    else:
        bk = trainer.sync.inner.dc_compressor.inner._bucketer(
            [state.params[k] for k in names])
        g = {k: v / P for k, v in zip(names, bk.unflatten(inflight))}
        want, _ = trainer.tx.update(g, state.opt_state, state.params)
    drained = trainer.drain_pipeline(state)
    for k in names:
        if not torch.equal(drained.params[k], want[k]):
            raise AssertionError(f"{path}: the drain is not one apply of "
                                 f"the parked aggregate at {k}")
        if not torch.equal(drained.params[k],
                           drained.params[k][:1, :1].expand_as(want[k])):
            raise AssertionError(f"{path}: replicas diverged at {k} in "
                                 "the drain")
    for k, v in state.sync_state["inflight_ms"].items():
        if not torch.equal(drained.model_state[k], v):
            raise AssertionError(f"{path}: the drain did not land the "
                                 f"parked statistics at {k}")
    if any(b.any() for b in
           drained.sync_state["inner"]["dc_comp"]["inflight"]):
        raise AssertionError(f"{path}: the drain left the buffer full")
    moved = max((drained.params[k] - state.params[k]).abs().max().item()
                for k in names)
    if not moved > 0:
        raise AssertionError(f"{path}: the parked aggregate is empty")
    cpu = make_trainer(path, get_model("resnet20"), device="cpu")
    on_cpu = cpu.drain_pipeline(dataclasses.replace(
        state, params=to_device(torch, state.params, "cpu"),
        opt_state=to_device(torch, state.opt_state, "cpu"),
        model_state=to_device(torch, state.model_state, "cpu"),
        sync_state=to_device(torch, state.sync_state, "cpu")))
    cpu_diff = max((drained.params[k].cpu() - on_cpu.params[k])
                   .abs().max().item() for k in names)
    if cpu_diff > 1e-6:
        raise AssertionError(f"{path}: the card's drain and the CPU's "
                             f"differ by {cpu_diff}")
    res.update(drain_max_param_change=moved, drain_cpu_max_abs_diff=cpu_diff)
    log(f"path {path}: the drain moved the params by up to {moved:.3g}, one "
        f"apply of the parked aggregate; card vs CPU drain max abs diff "
        f"{cpu_diff:.3g}")
    return drained


def main_path_phase(torch, path: str, steps: int, device=None,
                    batch: int = 128, **fields):
    """One path of PATHS at full width through Trainer.fit; ``fields``
    override its GeoConfig fields."""
    from geomx_tpu_torch import ops
    from geomx_tpu_torch.compression import TwoBitCompressor
    from geomx_tpu_torch.data import load_dataset
    from geomx_tpu_torch.models import get_model

    epochs = max(2, math.ceil(steps / 8))
    data = load_dataset("synthetic", synthetic_train_n=8 * batch * 8)
    trainer = make_trainer(path, get_model("resnet20"), device=device,
                           **fields)
    state = trainer.init_state(seed=0)
    loader = trainer.make_loader(data["train_x"], data["train_y"], batch)
    on_card = trainer.device.type == "cuda"
    # path 2: every step's wire words, read after the run (no device work
    # or host wait inside the timed loop)
    comp = getattr(getattr(trainer.sync, "dc_compressor", None), "inner",
                   None)
    wires = []
    log_fn = (lambda s: wires.append(comp.last_wire)) \
        if isinstance(comp, TwoBitCompressor) else (lambda s: None)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    state, records = trainer.fit(state, loader, epochs=epochs, log_every=1,
                                 log_fn=log_fn)
    if on_card:
        torch.cuda.synchronize()
    launches = ops.launch_counts()

    losses = [r["loss"] for r in records if "loss" in r]
    times = [r["time"] for r in records if "loss" in r]
    # every replica identical: FSA, MixedSync and the pipeline replicate
    # the update; HFA's replicas drift between syncs, and the 16 steps
    # end on a global sync (16 is a multiple of K1 * K2 = 8)
    sync = trainer.sync
    if getattr(sync, "k1", None) and len(losses) % (sync.k1 * sync.k2):
        raise AssertionError(f"{path}: {len(losses)} steps do not end on "
                             "an HFA global sync")
    res = step_stats(torch, trainer, state, path, losses, launches)
    # the loss falls over the first two epochs (8 steps each).  Later the
    # sgd configurations -- sgd momentum on top of BSC's momentum
    # correction at lr 0.1 without warm-up -- turn unstable on the
    # synthetic set, in the JAX package as well, so the check does not
    # read the later steps.  Path 2's fall is small (its 2-bit wire sends
    # few codes in 16 steps) and the JAX package's falls the same way.
    # The JAX package's 16 fp32 steps of the three sync paths fall too
    # (tests/torch_jax_trajectory.py --batch 128 --steps 16, mean of steps
    # 1-8 -> 9-16): mixed_dcasgd 2.2702 -> 1.9595, hfa_dgt 2.0416 ->
    # 1.3433, pipelined_fsa 2.3837 -> 2.2991; and of the sharded paths:
    # zero_sgd 2.3329 -> 2.2110, zero_pipelined_adam 2.3137 -> 2.0533,
    # multigps_bsc 2.3326 -> 2.2185.
    first, second = losses[:8], losses[8:16]
    if len(second) < 8 or not statistics.mean(second) < statistics.mean(first):
        raise AssertionError(f"{path}: loss did not fall: {losses}")
    res.update(steps=len(losses), samples_per_step=8 * batch, losses=losses,
               loss_first=losses[0], loss_last=losses[-1],
               launches_per_step={name: n / len(losses)
                                  for name, n in launches.items() if n})
    if path in SHARDED_TWIN:
        sharded_checks(torch, path, trainer, state, res)
    if hasattr(sync, "drain_grads"):
        state = drain_check(torch, path, trainer, state, res)
    last = getattr(comp, "last_wire", None)
    if isinstance(last, dict):
        # path 3: the owner-routed merge's counts of the last step
        from geomx_tpu_torch.compression.sparseagg import wire_stats
        res.update(wire_stats(last), wire_bytes_per_party=comp.wire_bytes_leaf(
            state.sync_state["dc_comp"][0][0]))
    if wires:
        n = state.sync_state["dc_comp"][0].shape[-1]
        density = [code_density(torch, w, n) for w in wires]
        if not max(density) > 0:
            raise AssertionError(f"{path}: the 2-bit wire carried no codes "
                                 f"in {len(wires)} steps")
        res.update(wire_code_density=statistics.mean(density),
                   wire_code_density_per_step=density,
                   wire_words_per_party=int(wires[-1].shape[-1]))
    warm = 2  # first steps pay cuDNN autotuning and the first allocations
    per_step = [b - a for a, b in zip(times[warm - 1:], times[warm:])]
    res.update(
        samples_per_s=8 * batch * len(per_step) / (times[-1] - times[warm - 1]),
        step_ms_median=1e3 * statistics.median(per_step),
        test_acc=trainer.evaluate(state, data["test_x"], data["test_y"]))
    log(f"path {path}: {len(losses)} steps, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} (first-8 mean {statistics.mean(first):.4f}, "
        f"next-8 mean {statistics.mean(second):.4f}), "
        f"{res['samples_per_s']:.1f} samples/s, step "
        f"{res['step_ms_median']:.2f} ms (median), test_acc "
        f"{res['test_acc']:.3f}, peak {res['peak_mem_gb']} GB"
        + (f", last step's merge: {res['overflow_pairs']} overflow pairs "
           f"reinjected, {res['merged_pairs']} merged pairs, "
           f"{res['kept_pairs']} kept by the re-select, pull-dropped share "
           f"{res['pull_dropped_fraction']:.4f}, "
           f"{res['wire_bytes_per_party']} wire bytes a party (computed)"
           if "merged_pairs" in res else "")
        + (f", 2-bit code density {res['wire_code_density']:.3g} (mean "
           f"over the steps; per step "
           f"{[f'{d:.3g}' for d in res['wire_code_density_per_step']]}) "
           f"of {res['wire_words_per_party']} words a party"
           if "wire_code_density" in res else "")
        + f", launches {launches}"
        + (f" ({res['launches_per_step']} a step)"
           if path in SHARDED_TWIN else ""))
    return res


def state_diff(torch, a, b) -> float:
    """The largest absolute difference between two TrainStates of the
    same structure (inf where the steps, paths or shapes differ)."""
    import dataclasses
    ta = tensors(torch, dataclasses.asdict(a))
    tb = tensors(torch, dataclasses.asdict(b))
    if a.step != b.step or [p for p, _ in ta] != [p for p, _ in tb]:
        return math.inf
    worst = 0.0
    for (_, u), (_, v) in zip(ta, tb):
        if u.shape != v.shape:
            return math.inf
        if u.numel():
            worst = max(worst, (u.double() - v.double()).abs().max().item())
    return worst


def step_stats(torch, trainer, state, path: str, losses, launches) -> dict:
    """The checks every path of PATHS shares: finite losses, identical
    replicas and, on the card, every kernel of the configuration
    launched in the run; returns the launches and the peak memory."""
    if not losses or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{path}: non-finite loss: {losses}")
    for k_, v in state.params.items():
        if not torch.equal(v, v[:1, :1].expand_as(v)):
            raise AssertionError(f"{path}: replicas diverged at {k_}")
    on_card = trainer.device.type == "cuda"
    missing = [name for name in PATHS[path][5] if launches[name] < 1]
    if on_card and missing:
        raise AssertionError(f"{path}: kernels not launched: {missing} "
                             f"({launches})")
    return dict(launches=launches,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9
                if on_card else None)


def cnn_bsc_phase(torch) -> dict:
    """Path cnn_bsc: the port's examples/cnn_bsc.py entry point itself
    (``cnn_common.run``), on [2, 4] from the GEOMX_* environment, as the
    launch script sets it; 16 steps, the test accuracy printed after
    each, as the example does.  Step time: the iteration (step and the
    example's evaluation) less one evaluation, timed after the run."""
    import os

    from geomx_tpu_torch import ops
    from geomx_tpu_torch.examples import cnn_bsc

    _, _, _, _, steps, _, (P, W), _ = PATHS["cnn_bsc"]
    losses, stamps = [], []

    def on_step(it, metrics):
        losses.append(float(metrics["loss"]))
        stamps.append(time.perf_counter())

    env = {"GEOMX_NUM_PARTIES": str(P), "GEOMX_WORKERS_PER_PARTY": str(W)}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        state, trainer = cnn_bsc.main(["-d", "mnist", "-bs", "32", "-ep",
                                       "1"], on_step=on_step)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    res = step_stats(torch, trainer, state, "cnn_bsc", losses, launches)
    res["dc_wire_bytes_per_step"] = trainer.sync.dc_compressor.wire_bytes(
        state.params)
    # the JAX package's 16 fp32 steps fall too (tests/torch_jax_trajectory.py
    # --path cnn_bsc --batch 32 --steps 16, steps 1-8 -> 9-16: 2.2994 ->
    # 2.1959)
    if len(losses) < steps:
        raise AssertionError(f"cnn_bsc: {len(losses)} steps, want {steps}")
    first, second = losses[:steps // 2], losses[steps // 2:steps]
    if not statistics.mean(second) < statistics.mean(first):
        raise AssertionError(f"cnn_bsc: loss did not fall: {losses}")
    from geomx_tpu_torch.data import load_dataset
    data = load_dataset("mnist", root=trainer.config.data_dir)
    evals = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        test_acc = trainer.evaluate(state, data["test_x"], data["test_y"])
        evals.append(time.perf_counter() - t0)
    eval_s = statistics.median(evals)
    warm = 2
    iters = [b - a for a, b in zip(stamps[warm - 1:], stamps[warm:])]
    step_s = statistics.median(iters) - eval_s
    res.update(steps=len(losses), samples_per_step=P * W * 32,
               losses=losses, loss_first=losses[0], loss_last=losses[-1],
               launches_per_step={n: c / len(losses)
                                  for n, c in launches.items() if c},
               iteration_ms_median=1e3 * statistics.median(iters),
               eval_ms=1e3 * eval_s, step_ms_median=1e3 * step_s,
               samples_per_s=P * W * 32 / step_s, test_acc=test_acc,
               synthetic=bool(data["synthetic"]),
               params=sum(v[0, 0].numel() for v in state.params.values()))
    log(f"path cnn_bsc: the entry point ran {len(losses)} steps on "
        f"{P}x{W}, loss {losses[0]:.4f} -> {losses[-1]:.4f} (first-8 mean "
        f"{statistics.mean(first):.4f}, next-8 mean "
        f"{statistics.mean(second):.4f}), {res['params']} parameters, "
        f"iteration {res['iteration_ms_median']:.2f} ms (median, with the "
        f"example's evaluation of {len(data['test_x'])} images, "
        f"{res['eval_ms']:.2f} ms alone), step {res['step_ms_median']:.2f} "
        f"ms, {res['samples_per_s']:.1f} samples/s, test_acc "
        f"{test_acc:.3f}, peak {res['peak_mem_gb']:.4f} GB, dc wire bytes a "
        f"step {res['dc_wire_bytes_per_step']} (computed), launches "
        f"{launches} ({res['launches_per_step']} a step)")
    return res


def checkpoint_round_trip(torch, path: str, x, y, batch: int,
                          deterministic: bool) -> dict:
    """Save after the first epoch, load into a fresh Trainer and run the
    second epoch with the scanned runner: the loaded state against the
    saved one, and the resumed state against the 16 uninterrupted steps
    (params, fused Adam state and dc-tier state), as largest
    differences.  ``deterministic`` sets
    ``torch.backends.cudnn.deterministic`` on both sides."""
    import os
    import tempfile

    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = deterministic, False
    try:
        a = make_trainer(path)
        la = a.make_loader(x, y, batch, device_cache=True)
        st8, _ = a.run_epoch(a.init_state(seed=0, sample_input=x[:2]), la, 0)
        with tempfile.TemporaryDirectory() as d:
            ckpt = a.save_checkpoint(os.path.join(d, "epoch0"), st8)
            size = os.path.getsize(ckpt)
            b = make_trainer(path)
            loaded = b.load_checkpoint(
                ckpt, b.init_state(seed=1, sample_input=x[:2]))
        st16, _ = a.run_epoch(st8, la, 1)
        lb = b.make_loader(x, y, batch, device_cache=True)
        resumed, _ = b.run_epoch(loaded, lb, 1)
        torch.cuda.synchronize()
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    return dict(loaded_max_diff=state_diff(torch, loaded, st8),
                resumed_max_diff=state_diff(torch, resumed, st16),
                checkpoint_bytes=size)


def alexnet_phase(torch) -> dict:
    """Path alexnet_fused_adam through ``Trainer.fit(scan_epochs=True)``
    on a device-cached loader (two epochs of 8 steps; the records are
    the epochs' mean losses), then the cached gather against the host
    loader's bytes and the checkpoint round trip."""
    from geomx_tpu_torch import ops
    from geomx_tpu_torch.data import GeoDataLoader

    path, batch = "alexnet_fused_adam", 32
    _, _, _, _, steps, _, (P, W), _ = PATHS[path]
    data = path_data(path, P * W * batch * steps // 2)
    x, y = data["train_x"], data["train_y"]
    trainer = make_trainer(path)
    state = trainer.init_state(seed=0, sample_input=x[:2])
    loader = trainer.make_loader(x, y, batch, device_cache=True)
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in (loader._dev_x, loader._dev_y))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    state, records = trainer.fit(state, loader, epochs=2, log_every=1,
                                 log_fn=lambda s: None, scan_epochs=True)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    epoch_losses = [r["loss"] for r in records]
    res = step_stats(torch, trainer, state, path, epoch_losses, launches)
    res["dc_wire_bytes_per_step"] = trainer.sync.dc_compressor.wire_bytes(
        state.params)
    if state.step != steps or len(records) != 2:
        raise AssertionError(f"{path}: {state.step} steps, {records}")
    # the JAX package's 16 fp32 steps fall too (tests/torch_jax_trajectory.py
    # --path alexnet_fused_adam --batch 32 --steps 16: 2.9025 -> 2.3641)
    if not epoch_losses[1] < epoch_losses[0]:
        raise AssertionError(f"{path}: loss did not fall: {epoch_losses}")
    step_s = (records[1]["time"] - records[0]["time"]) \
        / loader.steps_per_epoch
    # the cached gather: one epoch's batches against the host loader's
    host = GeoDataLoader(x, y, trainer.topology, batch, device="cpu")
    for (xb, yb), (hx, hy) in zip(loader.epoch(0), host.host_batches(0)):
        if not (torch.equal(xb.cpu(), torch.from_numpy(hx))
                and torch.equal(yb.cpu(), torch.from_numpy(
                    hy.astype("int64")))):
            raise AssertionError(f"{path}: a device-cached batch differs "
                                 "from the host loader's")
    ckpt = checkpoint_round_trip(torch, path, x, y, batch, True)
    if ckpt["loaded_max_diff"] != 0 or ckpt["resumed_max_diff"] != 0:
        raise AssertionError(f"{path}: the checkpoint round trip is not "
                             f"bit-equal: {ckpt}")
    loose = checkpoint_round_trip(torch, path, x, y, batch, False)
    res.update(steps=state.step, samples_per_step=P * W * batch,
               epoch_losses=epoch_losses, loss_first=epoch_losses[0],
               loss_last=epoch_losses[1],
               launches_per_step={n: c / steps
                                  for n, c in launches.items() if c},
               step_ms_median=1e3 * step_s,
               samples_per_s=P * W * batch / step_s,
               test_acc=trainer.evaluate(state, data["test_x"],
                                         data["test_y"]),
               cached_dataset_bytes=cache_bytes,
               params=sum(v[0, 0].numel() for v in state.params.values()),
               checkpoint=ckpt, checkpoint_nondeterministic_cudnn=loose)
    log(f"path {path}: 2 scanned epochs of {loader.steps_per_epoch} steps "
        f"on {P}x{W}, {res['params']} parameters, epoch mean loss "
        f"{epoch_losses[0]:.4f} -> {epoch_losses[1]:.4f}, step "
        f"{res['step_ms_median']:.2f} ms (the second epoch's mean), "
        f"{res['samples_per_s']:.1f} samples/s, test_acc "
        f"{res['test_acc']:.3f}, peak {res['peak_mem_gb']:.4f} GB, cached "
        f"dataset {cache_bytes} B on the card, dc wire bytes a step "
        f"{res['dc_wire_bytes_per_step']} (computed), launches {launches} "
        f"({res['launches_per_step']} a step); the cached batches of an "
        "epoch are the host loader's bytes; checkpoint after epoch 0 "
        f"({ckpt['checkpoint_bytes']} B): loaded and resumed states "
        "bit-equal with cudnn.deterministic; without it the resumed state "
        f"differs by up to {loose['resumed_max_diff']:.3g} (loaded "
        f"{loose['loaded_max_diff']:.3g})")
    return res


def seq_path_phase(torch, path: str, device=None):
    """One attention path of SEQ_PATHS at full width through Trainer.fit,
    then the evaluation (the un-meshed twin, the forward without the
    logsumexp)."""
    from geomx_tpu_torch import ops
    from geomx_tpu_torch.data import make_needle_data, with_positions

    sp_mode, shape, L, batch, steps, kernels, n_eval = SEQ_PATHS[path]
    P, W, _ = shape
    trainer = make_seq_trainer(sp_mode, shape, L, device=device)
    x, y = make_needle_data(P * W * batch * steps, L)
    xt, yt = make_needle_data(n_eval, L, seed=1)
    state = trainer.init_state(seed=0)
    loader = trainer.make_loader(with_positions(x), y, batch)
    on_card = trainer.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    state, records = trainer.fit(state, loader, epochs=1, log_every=1,
                                 log_fn=lambda s: None)
    if on_card:
        torch.cuda.synchronize()
    launches = ops.launch_counts()

    losses = [r["loss"] for r in records if "loss" in r]
    times = [r["time"] for r in records if "loss" in r]
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{path}: losses {losses}")
    for k_, v in state.params.items():
        if not torch.equal(v, v[:1, :1].expand_as(v)):
            raise AssertionError(f"{path}: replicas diverged at {k_}")
    want = {name: n * steps for name, n in kernels.items()}
    if on_card and any(launches[name] != n for name, n in want.items()):
        raise AssertionError(f"{path}: launches {launches}, want {want}")
    first, second = losses[:steps // 2], losses[steps // 2:]
    if path in LOSS_FALLS and \
            not statistics.mean(second) < statistics.mean(first):
        raise AssertionError(f"{path}: loss did not fall: {losses}")
    nolse0 = ops.variant_launch_counts()["flash_attention_fwd_nolse"]
    test_acc = trainer.evaluate(state, with_positions(xt), yt, batch_size=64)
    nolse = ops.variant_launch_counts()["flash_attention_fwd_nolse"] - nolse0
    if on_card and nolse < 1:
        raise AssertionError(f"{path}: the evaluation launched no forward "
                             "kernel without the logsumexp")
    warm = 2  # the first steps pay the first allocations
    per_step = [b - a for a, b in zip(times[warm - 1:], times[warm:])]
    res = dict(steps=len(losses), samples_per_step=P * W * batch,
               seq_len=L, losses=losses, loss_first=losses[0],
               loss_last=losses[-1], launches=launches,
               eval_nolse_launches=nolse,
               samples_per_s=P * W * batch * len(per_step)
               / (times[-1] - times[warm - 1]),
               step_ms_median=1e3 * statistics.median(per_step),
               test_acc=test_acc,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9
               if on_card else None)
    res["tokens_per_s"] = res["samples_per_s"] * L
    log(f"path {path}: {len(losses)} steps of {P}x{W}x{shape[2]} at L={L}, "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f} (first-half mean "
        f"{statistics.mean(first):.4f}, second-half mean "
        f"{statistics.mean(second):.4f}), {res['samples_per_s']:.2f} "
        f"sequences/s ({res['tokens_per_s']:.0f} tokens/s), step "
        f"{res['step_ms_median']:.2f} ms (median), test_acc "
        f"{test_acc:.3f} over {n_eval} ({nolse} no-lse forward launches), "
        f"peak {res['peak_mem_gb']} GB, launches {launches}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every number to this JSON file")
    ap.add_argument("--steps", type=int, default=32,
                    help="path 1 training steps (rounded up to epochs of "
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
    kern.update(attention_kernels(torch, torch.device("cuda")))
    wide = head_dim_phase(torch, torch.device("cuda"))
    shards = shard_phase(torch, torch.device("cuda"))
    floors = timer_floors(torch, torch.device("cuda"))
    log(f"timer floors: a 4-byte fill {floors['launch_ms'] * 1e3:.1f} us; a "
        f"device copy of {floors['copy_bytes'] / 1e6:.1f} MB (in and out) "
        f"{floors['copy_ms'] * 1e3:.1f} us")
    for name, r in kern.items():
        lib = "-" if r["library_ms"] is None \
            else f"{r['library_ms'] * 1e3:.1f} us"
        log(f"kernel {name}: {r['ms'] * 1e3:.1f} us (plain "
            f"{r['plain_ms'] * 1e3:.1f} us, library {lib}, bound "
            f"{r['bound_ms'] * 1e3:.2f} us by "
            f"{r.get('bound_kind', r['bound_by'])}), "
            + ("bit-equal" if "fp32_bound_ms" not in r else
               f"max abs err {r['max_abs_err']:.3g}; fp32 CUDA-core bound "
               f"{r['fp32_bound_ms'] * 1e3:.2f} us")
            + (f"; without the logsumexp {r['nolse_ms'] * 1e3:.1f} us"
               if "nolse_ms" in r else "")
            + (f"; library: {r['library']}" if "library" in r else "")
            + (f"; library forward+backward "
               f"{r['library_fwd_bwd_ms'] * 1e3:.1f} us"
               if "library_fwd_bwd_ms" in r else "")
            + (f"; with the sort {r['wrapper_ms'] * 1e3:.1f} us "
               f"(plain {r['plain_wrapper_ms'] * 1e3:.1f} us)"
               if "wrapper_ms" in r else ""))
    reference_phase(torch)
    zero_diff = zero_identity(torch)
    seq_reference_phase(torch)
    zoo_phases = {"cnn_bsc": cnn_bsc_phase,
                  "alexnet_fused_adam": alexnet_phase}
    paths = {path: zoo_phases[path](torch) if path in zoo_phases
             else main_path_phase(torch, path, cfg[4] or args.steps)
             for path, cfg in PATHS.items()}
    paths.update({path: seq_path_phase(torch, path) for path in SEQ_PATHS})
    log("median step: " + ", ".join(
        f"{p} {r['step_ms_median']:.2f} ms" for p, r in paths.items())
        + " (this call)")

    kernels = []
    for name in KERNELS:
        source, replaces = REPLACES[name]
        r = kern[name]
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces,
                            launches=paths[FIRST_PATH[name]]["launches"][name],
                            max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"],
                            library_ms=r["library_ms"]))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "build_s": _build.build_seconds,
                       "kernels": kernels, "kernel_phase": kern,
                       "head_dim_phase": wide, "timer_floors": floors,
                       "shard_phase": shards,
                       "zero_dense_max_param_diff": zero_diff,
                       "paths": paths,
                       "wall_s": time.perf_counter() - t_start}, f, indent=1)
    log(f"wall: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
