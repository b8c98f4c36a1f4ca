#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (geomx_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json] [--steps 16] [--verbose-build]

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
              cases of the CPU parity tests (and select/pack on [4, 2]
              rows of which party 1's are all +-0 with zero residuals, a
              dead party's bucket: exactly its k lowest indices a row);
              the nine kernels of the training plane must be bit-equal, the four attention kernels
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
              PyTorch's direct convolutions, cuDNN off); the resilience
              paths' configurations on [4, 2] with party 1 dead for the
              second step (RESILIENCE_REFERENCE_MASK),
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
                               16 steps (--steps);
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
              resilience_fsa  path 1f on [4, 2], 16 steps, under
                          RESILIENCE_SCHEDULE (party 1 dead for steps
                          3-5, party 3 for step 9) through a
                          PartyLivenessController, a ChaosEngine and
                          Trainer.apply_membership: the num_live_parties
                          metric the schedule's at every step, every
                          replica (the dead party's too) identical after
                          each, kernels 1-5 as many launches in every
                          step, the catch-up round trip at each
                          re-admission bit-equal (its bytes printed), and
                          one degraded fp32 step under the dense dc tier
                          bit-equal (or within the fp32 rounding of the
                          dead party's zero add) to a [3, 2] run of the
                          three survivors;
              resilience_zero  the same with GEOMX_ZERO=1 and the
                          per-leaf sgd(0.1, momentum=0.9): the catch-up
                          through host_zero_state/place_zero_state, every
                          worker's shard back bit-equal.
              Median step times of the paths come from the same call.
   mesh    -- MESH_PATHS: mesh_fsa, mesh_fused_sgd, mesh_zero (paths 1,
              1f, zero_sgd) and mesh_twobit_adam,
              mesh_sparse_agg ([4, 2]), mesh_mixed_dcasgd, mesh_hfa_dgt
              (8 steps: HFA's first dc milestone), mesh_pipelined_fsa
              and mesh_zero_pipelined_adam (then drained),
              mesh_multigps_bsc and mesh_fp16_mpq (the flagship with fp16,
              then mpq), 4 steps each, on a ReplicaMesh
              (topology.build_mesh) of the path's [P, W], one program a
              slot (parallel/collectives.run_on_mesh), the slots
              round-robin over the cards (all on cuda:0 with one card,
              which the phase prints), ResNet-20 bf16, 128 a replica,
              cuDNN deterministic, beside a stacked twin on the first
              card (mesh_phase): after every step and the drain the
              gathered state, the loss and the accuracy bit-equal to the
              twin's; the loss finite (and falling over the steps of the
              first three); every slot launching each kernel as many
              times a step (and a drain) as the twin's step does, and
              each kernel of the run at least once; a slot fed a
              malformed batch failing the step with its own error inside
              the rendezvous timeout.  Meshed and stacked step ms, peak
              memory and the optimizer-state bytes by device, per-slot
              launches and each phase's wall printed, not gated;
   telemetry_fsa -- path 1f again (16 steps) through Trainer.fit with
              GEOMX_TELEMETRY, the event log, the flight recorder (16
              steps) and the run capsule (sampled every 0.5 s) on, cuDNN
              deterministic: a telemetry-off step makes the launch calls,
              in order, of a build whose probe collector raises, and
              kernels 1-5 3, 2, 1, 1, 1 times; the losses and final
              parameters bit-equal with telemetry on and off, kernels
              1-5 at 3, 2, 1, 1, 1 in every on step; step 1's
              grad_norm_global within rtol 1e-5 of an fp64 recompute of
              the applied gradient, no non-finite probe, the emitted
              share recomputed from kernel 3's output, dc_wire_bytes
              21,808; one event record a step; the capsule's step records
              the published probes, its link journal replayed
              bit-identically; a poisoned twin (NaN in party 1's input at
              step 5, 8 steps) whose flight bundle names party 1 at step
              5; the probes' extra launch calls a step, step ms on and off and
              one step's roofline (FLOPs from PyTorch's counter, MFU
              against the H100 row) printed, not gated;
   control_fsa -- path 1 (16 steps) with GEOMX_CONTROL=1 and telemetry
              under CONTROL_SCRIPT's decisions through a ControlActuator
              (ratio 0.005 and 0.00125 of the 0.01 capacity, depth 1, the
              drain back to 0, ratio 0.01): a control-off step makes the
              launch calls of a build whose control hook raises; the step
              after each ratio actuation the launch calls of the step
              before it, the step cache unchanged; the emitted share falls
              with the scale, kernel 3's pairs at the eff_k boundary equal
              the plain selection's on the CPU; the EF carried across 0->1
              (copy (0, 0)), the drain one apply of the parked aggregate;
              two fp32 steps at scale 0.5 card against CPU; step ms on and
              off printed;
   audit_fsa -- path 1f's resilience configuration (resilience_fsa:
              ResNet-20 on [4, 2], "bsc,0.01", the fused SGD-momentum)
              with GEOMX_AUDIT=1 (analysis/): fit arms the auditor (the
              step recorded once on CPU zeros), a swap to
              RESILIENCE_REFERENCE_MASK and back audits clean, a
              reference cut by one entry raises AuditError with the active
              step left in place; the same configuration with the
              per-leaf sgd(0.1, momentum=0.9) (a depth-1 drain does not
              compose with the fused apply) re-arms clean at a depth
              switch 0->1->0; an audited step makes the launch calls, in
              order, of an unaudited twin's; hlo.materialization_counts
              of the fused BSC compress below the plain version's on the
              same CUDA tensors, the dense cumsum/scatter gone and kernel
              3 launched (the fused-versus-plain verdict); the host ms of
              arming and of each swap's recording, the signature's
              length and the two counts printed;
   control_replay -- bench.py --compare-control in the port
              (CONTROL_REPLAY: the MLP on 3 parties, 60 steps, a modelled
              WAN under a throttle-and-delay schedule): the controller
              first to the loss target of four static configurations, its
              decision log byte-identical over two runs and reproduced by
              its capsule's replay, the launch calls unchanged by each
              ratio actuation; the decisions beside CONTROL_r01.json's;
6. host plane -- the port's parameter-service plane, one process a role
              (service/, transport/, runtime/native.py):
              dist_ps_fsa  the port's launcher forks the port's
                          examples/dist_ps.py on the card at the JAX
                          script's defaults: 2 parties x 2 workers and a
                          global server (7 processes), GEOMX_SYNC_MODE
                          fsa, no compression, 3 epochs of batch 64,
                          GEOMX_SAVE_PARAMS set; every process exits 0,
                          every worker on cuda, the 4 saved models
                          bit-equal and within 5e-5 of the job as one
                          process on the CPU with the workers' gradients
                          summed (dist_ps_golden), the native runtime
                          built (the global server's SGD route); wall
                          time, the workers' push-and-pull round (median),
                          socket bytes a round on each tier (WireStats),
                          the last test accuracies;
              dist_ps_mixed_sched  the same with GEOMX_USE_SCHEDULER=1
                          GEOMX_SYNC_MODE=mixed (8 processes): every
                          process exits 0, the lowest worker's last test
                          accuracy at least the lowest that the JAX
                          example's lowest worker reached in that job on
                          the CPU over 32 runs
                          (DIST_PS_JAX_MIXED_LOWEST_MIN);
              fleetscope_sched  the same job with GEOMX_FLEETSCOPE=1 (a
                          0.5 s poll) and the scheduler's metrics port:
                          its GET /fleet names the roster and the
                          scheduler, the version rising, GET /control 200
                          with no decisions, tools/gxtop.py renders the
                          document; a seeded burn series gives the same
                          breaches twice; its wall time beside
                          dist_ps_mixed_sched's;
              host_plane_resnet20  in process: a global GeoPSServer (sync,
                          native SGD 0.05), two local servers ("bsc,0.01",
                          relay compressor on the card) and 4 clients on
                          ResNet-20's 65 parameter leaves at full width;
                          8 rounds, each worker one forward/backward on
                          the card on its own synthetic batch of 32; the
                          pushes replayed through a CPU twin: pulls
                          bit-equal across workers and to the twin,
                          bsc_select_pack launched exactly (eligible
                          leaves) x 2 parties x 8 rounds times, every
                          eligible relay exactly k pairs; round time,
                          relay compress time a key on the card and on the
                          twin, relay bytes a round against dense, and
                          kernel 3 against its plain version at each relay
                          leaf size.  The dist_ps paths run no kernel of
                          csrc/ (no compression);
              manyparty_sharded  the range-sharded global tier at the JAX
                          acceptance's size (MANYPARTY): a scheduler, 4
                          shards on the card (Adam 0.01 through the
                          factory there) and 16 ShardedGlobalClients,
                          one thread each, on ResNet-20's 65 leaves at
                          full width; 6 rounds of seeded normal
                          gradients, the 19 leaves of 1,024 or more
                          pushed as BSC pairs from each party's own
                          compressor on the card (kernel 3), the rest
                          dense; rebalance_shards(min_gain=0) with round
                          3 open.  Gates: progress 6 on every key, the
                          map bumped and keys moved, the final pulls
                          bit-equal across parties and to a one-shard
                          twin whose parties compress on the CPU,
                          bsc_select_pack exactly 19 x 16 x 6 launches;
                          the chaos run of bench.py --compare-manyparty
                          (MANYPARTY_CHAOS: shard 1 killed before round 3
                          through the chaos engine's lifecycle hook and
                          restarted on its journal, every process durable
                          under a temporary root), its final pulls
                          bit-equal to the twin's, the outage and the
                          replayed records printed; then bench.py's merge
                          throughput at 1, 2 and 4 shard processes (not
                          gated);
              kvstore_hips  the port's KVStore, create("hips", [2, 4])
                          on the card over the 65 leaves: bsc 0.01 (8
                          rounds) and 2bit 0.5 (4 rounds) bit-equal to a
                          CPU twin store, kernels 3 and 4 exactly 19 x 2
                          x 8 launches, 7 and 8 launched; a training loop
                          of 8 replicas' ResNet-20 gradients through a
                          bsc store with sgd(0.1, momentum=0.9); a lazy
                          row-sparse Adam push (untouched rows
                          bit-unchanged);
              ledger_host_plane  host_plane_resnet20's plane again (65
                          leaves, 2 parties, kernel 3 on the relay hop;
                          seeded normal gradients) with the round ledger
                          reset before it: every (key, round) record
                          complete; the ledger's frame bytes plus the
                          frames it gives to no round (commands,
                          heartbeats, ACKs, the first pulls) equal to
                          WireStats' socket bytes within
                          LEDGER_WIRE_SLACK a direction; every round's
                          honesty ratio within the frame bound
                          (active_frame_overhead_bound); the registry's
                          Prometheus text parses back, and the metrics
                          command to the global server answers the same
                          families;
              durable_recovery  (no kernel) a durable GeoPSServer in its
                          own process, SIGKILLed with round 2 of two
                          workers' pushes of ResNet-20's 65 leaves open,
                          restarted on the same directory: the workers'
                          session resume closes the round, every pull the
                          exact sum of the four pushes; a durable
                          scheduler restarted inside its grace window:
                          every node's old id, the epoch going on, no
                          node read as dead;
7. examples -- long_context_ring, long_context_ulysses: the port's
              examples/long_context.py main(mode) at its defaults (2 x 2
              x sp 2, L 256, 6 epochs of 64 steps): the last test
              accuracy above 0.5 and the mode's kernels launched (ring:
              13, 1, 2 and 10 in the evaluation; Ulysses: 10, 11, 12, 1,
              2);
8. serving -- the port's serving plane (serve/), the gateway's forward
              on the card as one captured CUDA graph a bucket:
              serve_mlp  bench.py --compare-serve at its defaults
                          (SERVE_MLP): the zoo MLP (6 leaves, 940,584
                          dense bytes) published to a durable
                          RegistryServer, a replica at party 1, the
                          gateway at max_batch 8 and queue_ms 2 behind
                          HTTP and the native lane; 120 requests of 2
                          rows from 4 clients on each lane, 5
                          train-while-serving rounds of 1% pair deltas,
                          the registry crashed mid-refresh, its failover
                          and the replay of the whole round.  Every gate
                          of _compare_serve's ok, each printed (bit_exact,
                          delta_only, staleness_bounded, zero_lost,
                          chaos_p99_bounded, no_double_apply,
                          jit_cache_bounded, batch_bounded,
                          restart_detected, slo_shed_decision — a
                          SloPolicy on the gateway's serving_stats, its
                          shed handed to set_shed_fraction —,
                          prewarm_no_recompile, native_wire_honest, QPS
                          above 0), and the served logits against the
                          plain forward of the checkpoint on the CPU;
              serve_seq_flash  the SeqClassifier at seq_flash's
                          configuration (SERVE_SEQ: L 4096, dim 64, 4
                          heads, 2 layers, fp32), seeded weights through
                          the registry, every bucket (1, 2, 4, 8)
                          captured in warmup: each bucket's replay
                          bit-equal to an eager forward through the same
                          kernels on the same weights and within fp32
                          1e-5 of the plain forward (dense attention)
                          and 1e-4 of the CPU; local and native-lane
                          load while two delta rounds land, every
                          batch's logits those of the round it stamps;
                          kernel 10's no-lse variant in every replay
                          (2 kernel nodes a graph times its replays; a
                          profiler window of 4 replays printed beside);
                          no capture after warmup; p50/p99, QPS, the
                          replay's device ms a bucket, peak memory.

The two last lines are the ``kernels`` JSON object and the result line
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 2 and
prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
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
    # path 1f on [4, 2] under RESILIENCE_SCHEDULE (resilience_phase): the
    # survivors' mean on the bucketed BSC path, a dead party's rows
    # through every kernel, the catch-up at each re-admission
    "resilience_fsa": ("resnet20", ("sgd", 0.1), "bsc,0.01", True, 16,
                       SLICE1 + ("fused_sgd_momentum",), (4, 2), {}),
    # the same schedule under GEOMX_ZERO=1 with the per-leaf momentum:
    # the catch-up through host_zero_state/place_zero_state
    "resilience_zero": ("resnet20", ("sgd", 0.1), "bsc,0.01", False, 16,
                        SLICE1, (4, 2), dict(zero=True)),
}
# the resilience paths' chaos schedule (bench.py --compare-resilience's
# default with a flap after it): party 1 dead for steps 3-5, party 3 for
# step 9; and the reference phase's mask for their second step
RESILIENCE_SCHEDULE = "seed=1234;blackout@3:party=1,steps=3;flap@9:party=3"
RESILIENCE_PATHS = ("resilience_fsa", "resilience_zero")
RESILIENCE_REFERENCE_MASK = (True, False, True, True)
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
                 fused=None, mesh=None, **fields):
    """The Trainer of one configuration of PATHS or REFERENCE_ONLY, on
    ``model`` (default: the configuration's zoo model); ``fused``
    overrides whether it runs the fused optimizer, ``fields`` its
    GeoConfig fields; ``mesh``: on that device mesh instead of
    ``device``."""
    from geomx_tpu_torch import GeoConfig, HiPSTopology
    from geomx_tpu_torch.models import get_model
    from geomx_tpu_torch.ops.optim import fused_optimizer
    from geomx_tpu_torch.optim import adam, get_optimizer, sgd
    from geomx_tpu_torch.train import Trainer

    name, (kind, lr), spec, path_fused, _, _, (P, W), extra = \
        PATHS[path] if path in PATHS else REFERENCE_ONLY[path]
    fused = path_fused if fused is None else fused
    if fused:
        tx = fused_optimizer(kind, learning_rate=lr, momentum=0.9)
    elif kind == "adam":
        tx = adam(lr)
    elif kind == "sgd":
        tx = sgd(lr, momentum=0.9)
    else:
        tx = get_optimizer(kind, lr)
    cfg = {**dict(num_parties=P, workers_per_party=W, compression=spec,
                  fused_optim=fused), **extra, **fields}
    if precision is not None:
        cfg["precision"] = precision
    if model is None:
        model = get_model(name, precision=precision)
    return Trainer(model, HiPSTopology(P, W), tx, config=GeoConfig(**cfg),
                   device=device, mesh=mesh)


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
    dead_party_select(torch, dev, n, k)

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


def dead_party_select(torch, dev, n, k) -> None:
    """Select/pack on [4, 2] rows of which party 1's are all zeros of
    mixed signs with zero residuals (a dead party's bucket under the
    reset policy): bit-equal to the plain version, and each of party 1's
    rows emits exactly k pairs, the k lowest indices (lax.top_k's order
    among equal magnitudes)."""
    from geomx_tpu_torch.ops import bsc
    gen = torch.Generator(device=dev).manual_seed(17)
    shape = (4, 2, n)
    g = torch.randn(shape, generator=gen, device=dev)
    u = torch.randn(shape, generator=gen, device=dev) * 0.1
    v = torch.randn(shape, generator=gen, device=dev) * 0.2
    neg = torch.rand((2, n), generator=gen, device=dev) < 0.5
    g[1] = torch.where(neg, torch.tensor(-0.0, device=dev),
                       torch.tensor(0.0, device=dev))
    u[1] = 0.0
    v[1] = 0.0
    thr = bsc.sampled_boundary_guv(g, u, v, k)
    sel = bsc.select_pack(g, u, v, thr, k)
    max_err(torch, sel, bsc.select_pack_plain(g, u, v, thr, k))
    idx = sel[1][1].long()
    lowest = torch.arange(k, device=dev).expand(2, k)
    if not torch.equal(idx.sort(-1).values, lowest):
        raise AssertionError("select/pack: a dead party's row did not emit "
                             "exactly its k lowest indices")
    log(f"  edge case select/pack with party 1 dead ([4, 2] x {n}, its "
        f"rows +-0, residuals 0): bit-equal; party 1's rows {k} pairs "
        f"each, indices 0..{k - 1}; the live rows "
        f"{(sel[1][[0, 2, 3]] >= 0).sum(-1).flatten().tolist()} pairs")


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
                    if i == 1 and path in RESILIENCE_PATHS:
                        # the degraded configuration: party 1 dead for
                        # step 2 of 2
                        st = t.apply_membership(
                            st, RESILIENCE_REFERENCE_MASK)
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
            + (f", step 2 under the mask {RESILIENCE_REFERENCE_MASK}"
               if path in RESILIENCE_PATHS else "")
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


def expected_live(schedule, parties: int, steps: int) -> list:
    """The live-party count of each step under ``schedule``, from a
    controller of its own."""
    from geomx_tpu_torch.resilience import (ChaosEngine,
                                            PartyLivenessController)
    ctrl = PartyLivenessController(parties)
    engine = ChaosEngine(schedule, ctrl, drive_drop_hook=False)
    out = []
    for step in range(steps):
        engine.tick(step)
        out.append(ctrl.epoch.num_live)
    return out


def catchup_check(torch, trainer, state) -> dict:
    """The re-admission round trip: ``catchup_payload`` -> ``admit_party``
    gives back the state bit for bit (params, optimizer and model state
    on every replica; the sync state's copy (0, 0), or under ZeRO its
    party-0 shard of every worker, over every slot), and the admitted
    state packs to the same bytes."""
    t0 = time.perf_counter()
    blob = trainer.catchup_payload(state)
    back = trainer.admit_party(blob)
    if trainer.device.type == "cuda":
        torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    zero = trainer._zero_plan is not None
    for field in ("params", "opt_state", "model_state", "sync_state"):
        a_ts = tensors(torch, getattr(state, field))
        b_ts = tensors(torch, getattr(back, field))
        if [p for p, _ in a_ts] != [p for p, _ in b_ts]:
            raise AssertionError(f"catch-up: {field} changed structure")
        for (path, a), (_, b) in zip(a_ts, b_ts):
            if field != "sync_state":
                same = torch.equal(bits(torch, a), bits(torch, b))
            elif zero and "dc_comp" in path:
                same = torch.equal(bits(torch, a[0]), bits(torch, b[0])) \
                    and torch.equal(b, b[:1].expand_as(b))
            else:
                same = torch.equal(bits(torch, a[0, 0]),
                                   bits(torch, b[0, 0])) \
                    and torch.equal(b, b[:1, :1].expand_as(b))
            if not same:
                raise AssertionError(f"catch-up: {field}{path} differs")
    if trainer.catchup_payload(back) != blob:
        raise AssertionError("catch-up: the admitted state packs to other "
                             "bytes")
    return dict(bytes=len(blob), ms=ms)


def survivor_identity(torch, device=None, batch: int = 32) -> dict:
    """One degraded [4, 2] step (party 1 dead) under the uncompressed dc
    tier, fp32, ResNet-20 at full width with the fused SGD-momentum,
    against a [3, 2] run of the three survivors from the same state and
    batches: the parameters bit for bit, or within the fp32 rounding of
    the dead party's zero add (4 ulp of each leaf's largest magnitude)
    where the card's party sum associates it differently."""
    from geomx_tpu_torch import GeoConfig, HiPSTopology
    from geomx_tpu_torch.models import get_model
    from geomx_tpu_torch.ops.optim import fused_optimizer
    from geomx_tpu_torch.train import Trainer
    from geomx_tpu_torch.train.state import unreplicate_tree

    def trainer(P):
        return Trainer(get_model("resnet20", precision="fp32"),
                       HiPSTopology(P, 2),
                       fused_optimizer("sgd", learning_rate=0.1,
                                       momentum=0.9),
                       config=GeoConfig(num_parties=P, workers_per_party=2,
                                        compression="none",
                                        fused_optim=True, precision="fp32"),
                       device=device)

    t4, t3 = trainer(4), trainer(3)
    st4 = t4.init_state(seed=0)
    st3 = t3.init_state(params=unreplicate_tree(st4.params),
                        model_state=unreplicate_tree(st4.model_state))
    gen = torch.Generator().manual_seed(5)
    x = torch.randint(0, 256, (4, 2, batch, 32, 32, 3), generator=gen,
                      dtype=torch.uint8).to(t4.device)
    y = torch.randint(0, 10, (4, 2, batch), generator=gen).to(t4.device)
    st4 = t4.apply_membership(st4, RESILIENCE_REFERENCE_MASK)
    s4, m4 = t4.train_step(st4, x, y)
    live = [0, 2, 3]
    s3, m3 = t3.train_step(st3, x[live], y[live])
    bit_equal, worst, worst_ulp = True, 0.0, 0.0
    eps = torch.finfo(torch.float32).eps
    for k_, a in s4.params.items():
        if not torch.equal(a, a[:1, :1].expand_as(a)):
            raise AssertionError(f"survivor identity: replicas of {k_} "
                                 "differ")
        a, b = a[0, 0], s3.params[k_][0, 0]
        if torch.equal(bits(torch, a), bits(torch, b)):
            continue
        bit_equal = False
        d = (a.double() - b.double()).abs().max().item()
        scale = max(b.abs().max().item(), 1e-30)
        worst, worst_ulp = max(worst, d), max(worst_ulp, d / (eps * scale))
    if worst_ulp > 4:
        raise AssertionError(f"survivor identity: {worst} from the [3, 2] "
                             f"survivors' run ({worst_ulp:.1f} ulp)")
    return dict(bit_equal=bit_equal, max_abs_diff=worst,
                max_ulp=worst_ulp, loss_degraded=float(m4["loss"]),
                loss_survivors=float(m3["loss"]))


def resilience_phase(torch, path: str, device=None, batch: int = 128,
                     ) -> dict:
    """Paths resilience_fsa and resilience_zero: ResNet-20 at full width
    on [4, 2], 128 images a replica, 16 steps, with RESILIENCE_SCHEDULE
    driving a PartyLivenessController through a ChaosEngine and every
    published epoch bound through Trainer.apply_membership (the reset
    policy).  Gates: the step's num_live_parties metric is the
    schedule's; every replica (the dead party's too) identical after each
    step; each step launches kernels 1-5 as often as the first (a full
    step); at each re-admission the catch-up round trip is bit-equal
    (catchup_check); for resilience_fsa, survivor_identity."""
    from geomx_tpu_torch import ops
    from geomx_tpu_torch.data import load_dataset
    from geomx_tpu_torch.models import get_model
    from geomx_tpu_torch.resilience import (ChaosEngine, ChaosSchedule,
                                            PartyLivenessController)

    _, _, _, _, steps, kernels, (P, W), _ = PATHS[path]
    schedule = ChaosSchedule.from_spec(RESILIENCE_SCHEDULE)
    want = expected_live(schedule, P, steps)
    data = load_dataset("synthetic", synthetic_train_n=P * W * batch * 8)
    trainer = make_trainer(path, get_model("resnet20"), device=device)
    state = trainer.init_state(seed=0)
    loader = trainer.make_loader(data["train_x"], data["train_y"], batch)
    batches = [b for epoch in range(math.ceil(steps / 8))
               for b in loader.epoch(epoch, prefetch=0)][:steps]
    on_card = trainer.device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    ctrl = PartyLivenessController(P)
    current = ctrl.epoch
    live, losses, step_ms, per_step, catchups, epochs = \
        [], [], [], [], [], []
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with ChaosEngine(schedule, ctrl) as engine:
        for step, (xb, yb) in enumerate(batches):
            fired = engine.tick(step)
            ep = ctrl.epoch
            if ep.version != current.version:
                if ep.num_live > current.num_live:
                    catchups.append(dict(step=step, **catchup_check(
                        torch, trainer, state)))
                state = trainer.apply_membership(state, ep)
                epochs.append(dict(step=step, version=ep.version,
                                   live_mask=list(ep.live_mask),
                                   events=[e.kind for e in fired]))
                current = ep
            before = ops.launch_counts()
            sync()
            t0 = time.perf_counter()
            state, m = trainer.train_step(state, xb, yb)
            sync()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            after = ops.launch_counts()
            per_step.append({name: after[name] - before[name]
                             for name in kernels})
            live.append(float(m["num_live_parties"]))
            losses.append(float(m["loss"]))
            for k_, v in state.params.items():
                if not torch.equal(v, v[:1, :1].expand_as(v)):
                    raise AssertionError(f"{path}: replicas differ at {k_} "
                                         f"after step {step}")
    launches = ops.launch_counts()
    if live != [float(n) for n in want]:
        raise AssertionError(f"{path}: num_live_parties {live}, the "
                             f"schedule's {want}")
    if any(d != per_step[0] for d in per_step):
        raise AssertionError(f"{path}: launches a step differ: {per_step}")
    if len(catchups) != 2:
        raise AssertionError(f"{path}: {len(catchups)} re-admissions")
    res = step_stats(torch, trainer, state, path, losses, launches)
    full = [t for t, n in zip(step_ms[1:], want[1:]) if n == P]
    degraded = [t for t, n in zip(step_ms[1:], want[1:]) if n < P]
    res.update(steps=len(losses), samples_per_step=P * W * batch,
               schedule=schedule.spec(), num_live=live, epochs=epochs,
               losses=losses, step_ms=step_ms,
               step_ms_median=statistics.median(step_ms[1:]),
               step_ms_median_full=statistics.median(full),
               step_ms_median_degraded=statistics.median(degraded),
               launches_per_step=per_step[0], catchups=catchups)
    if path == "resilience_fsa":
        res["survivor_identity"] = survivor_identity(torch, device=device)
    si = res.get("survivor_identity")
    log(f"path {path}: {len(losses)} steps of [{P}, {W}] x {batch} under "
        f"{schedule.spec()}: num_live_parties {[int(n) for n in live]} (the "
        f"schedule's), loss {losses[0]:.4f} -> {losses[-1]:.4f}, replicas "
        f"identical after every step, launches a step {per_step[0]} in "
        f"every step (full and degraded), step "
        f"{res['step_ms_median_full']:.2f} ms full / "
        f"{res['step_ms_median_degraded']:.2f} ms degraded (median), "
        f"catch-up " + ", ".join(
            f"at step {c['step']} {c['bytes']} bytes in {c['ms']:.1f} ms"
            for c in catchups) + " (bit-equal round trips)"
        + ("" if si is None else
           f"; survivor identity vs [3, 2]: "
           + ("bit-equal" if si["bit_equal"] else
              f"max {si['max_abs_diff']:.3g} ({si['max_ulp']:.2f} ulp)")
           + f", losses {si['loss_degraded']:.6f} / "
           f"{si['loss_survivors']:.6f}")
        + f", peak {res['peak_mem_gb']} GB")
    return res


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


# ---- the host parameter-service plane --------------------------------------

# the dist_ps_mixed_sched gate, like for like: the JAX example's job
# (GEOMX_USE_SCHEDULER=1 GEOMX_SYNC_MODE=mixed, 2 x 2, 3 epochs, batch
# 64; scripts/launch.py + examples/dist_ps.py) on the CPU, its LOWEST
# worker's last test accuracy over 32 runs on an otherwise idle host
# (tools/torch_jax_mixed_repeat.py: min 0.734, median 0.847; PERF.md):
# the port's lowest worker must reach the JAX job's worst lowest worker.
# MixedSync's asynchronous tiers now and then leave one party's workers
# behind in both packages, so the mean of all workers is no floor for
# the lowest one
DIST_PS_JAX_MIXED_LOWEST_MIN = 0.734
DIST_PS = {"dist_ps_fsa": dict(mode="fsa", scheduler=False, procs=7),
           "dist_ps_mixed_sched": dict(mode="mixed", scheduler=True,
                                       procs=8)}
DIST_PS_SHAPE = dict(parties=2, workers=2, epochs=3, batch=64, lr=0.1)
HOST_PLANE_ROUNDS = 8
HOST_PLANE_BATCH = 32
# ledger_host_plane: the ledger's bytes plus the frames in no round may
# part from WireStats' socket bytes by at most this many bytes a
# direction over the phase
LEDGER_WIRE_SLACK = 64


def dist_ps_golden(torch) -> dict:
    """The dist_ps_fsa job as one process on the CPU: the example's data,
    init and batch order, every worker's gradient summed into one SGD
    step, as the two tiers sum them (the golden of the JAX package's
    host-PS smoke, __graft_entry__.py _hostps_smoke)."""
    import numpy as np
    P, W = DIST_PS_SHAPE["parties"], DIST_PS_SHAPE["workers"]
    batch, lr = DIST_PS_SHAPE["batch"], DIST_PS_SHAPE["lr"]
    n, d, classes = 2048, 64, 10
    rng = np.random.RandomState(0)
    w_true = rng.normal(size=(d, classes)).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = np.argmax(x @ w_true + 0.1 * rng.normal(size=(n, classes)), axis=1)
    part = n // (P * W)
    prng = np.random.RandomState(0)
    w = torch.from_numpy((prng.normal(size=(d, classes)) * 0.01)
                         .astype(np.float32))
    b = torch.zeros(classes)
    for ep in range(DIST_PS_SHAPE["epochs"]):
        perm = np.random.RandomState(ep).permutation(part)
        for s in range(part // batch):
            idx = perm[s * batch:(s + 1) * batch]
            gw, gb = torch.zeros_like(w), torch.zeros_like(b)
            for rank in range(P * W):
                xb = torch.from_numpy(x[rank * part:(rank + 1) * part][idx])
                yb = torch.from_numpy(y[rank * part:(rank + 1) * part][idx])
                pw = w.clone().requires_grad_()
                pb = b.clone().requires_grad_()
                logits = xb @ pw + pb
                ll = logits[torch.arange(batch), yb] \
                    - torch.logsumexp(logits, dim=1)
                (-ll.mean()).backward()
                gw, gb = gw + pw.grad, gb + pb.grad
            w, b = w - lr * gw, b - lr * gb
    return {"w": w.numpy(), "b": b.numpy()}


def dist_ps_phase(torch, path: str, label: str = None,
                  extra_env: dict = None, watch=None) -> dict:
    """Paths dist_ps_fsa and dist_ps_mixed_sched: the port's launcher
    forks the port's examples/dist_ps.py, one process a role, on the
    card (no -c), at the JAX script's defaults (DIST_PS_SHAPE); the
    processes' exit codes, the saved models, the processes' socket
    counters and the workers' round times come back through the
    launcher and GEOMX_SAVE_PARAMS.  No kernel of csrc/ runs here (no
    compression): the workers' gradients are PyTorch ops on the card.
    ``label`` names the run in messages (default ``path``);
    ``extra_env`` adds variables to the job's environment; ``watch``
    is ``(fn, stop_event)``: ``fn`` runs on a thread while the job runs
    and the event is set when it has ended."""
    import os
    import re
    import tempfile
    import threading

    import numpy as np

    from geomx_tpu_torch.runtime import native_available
    from geomx_tpu_torch.utils.net import free_port_blocks

    cfg = DIST_PS[path]
    path = label or path
    P, W = DIST_PS_SHAPE["parties"], DIST_PS_SHAPE["workers"]
    root = os.path.dirname(os.path.abspath(__file__))
    gport, lport, sport = free_port_blocks(1, P, 1)
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ)
        env.update({
            "GEOMX_SYNC_MODE": cfg["mode"],
            "GEOMX_USE_SCHEDULER": "1" if cfg["scheduler"] else "0",
            "GEOMX_EPOCHS": str(DIST_PS_SHAPE["epochs"]),
            "GEOMX_BATCH": str(DIST_PS_SHAPE["batch"]),
            "GEOMX_LR": str(DIST_PS_SHAPE["lr"]),
            "GEOMX_PS_GLOBAL_PORT": str(gport), "GEOMX_PS_PORT": str(lport),
            "GEOMX_SCHEDULER_PORT": str(sport), "GEOMX_SAVE_PARAMS": tmp})
        env.update(extra_env or {})
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "geomx_tpu_torch.launch",
             "--num-parties", str(P), "--workers-per-party", str(W), "--",
             sys.executable, "-m", "geomx_tpu_torch.examples.dist_ps"],
            cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        watcher = None
        if watch is not None:
            watcher = threading.Thread(target=watch[0], daemon=True)
            watcher.start()
        try:
            out, err = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
            if watcher is not None:
                watch[1].set()
                watcher.join(timeout=10)
        wall = time.perf_counter() - t0
        tail = out[-3000:] + err[-3000:]
        codes = re.findall(r"\[launch\] exit codes (\{.*\})", err)
        if proc.returncode != 0 or not codes:
            raise AssertionError(f"{path}: launch rc {proc.returncode}\n"
                                 f"{tail}")
        codes = json.loads(codes[-1])
        if len(codes) != cfg["procs"] or any(codes.values()):
            raise AssertionError(f"{path}: exit codes {codes}\n{tail}")
        devices = re.findall(r"\[worker p\d+w\d+\] device (\S+)",
                             out)
        if len(devices) != P * W or \
                any(not dv.startswith("cuda") for dv in devices):
            raise AssertionError(f"{path}: worker devices {devices}")
        accs = {}
        for p_, w_, ep, acc in re.findall(
                r"\[worker p(\d+)w(\d+)\] epoch (\d+) train_acc \S+ "
                r"test_acc ([\d.]+)", out):
            accs.setdefault((int(p_), int(w_)), []).append(float(acc))
        if len(accs) != P * W or any(
                len(a) != DIST_PS_SHAPE["epochs"] for a in accs.values()):
            raise AssertionError(f"{path}: accuracies {accs}\n{tail}")
        models, stats = {}, {}
        for p_ in range(P):
            for w_ in range(W):
                with np.load(os.path.join(tmp, f"worker_p{p_}w{w_}.npz")) \
                        as z:
                    models[(p_, w_)] = {k: z[k] for k in z.files}
        for f in os.listdir(tmp):
            if f.startswith("stats_"):
                with open(os.path.join(tmp, f)) as fh:
                    stats[f[6:-5]] = json.load(fh)
    workers = [v for k, v in stats.items() if k.startswith("worker")]
    rounds = len(workers[0]["round_ms"])
    round_ms = [t for v in workers for t in v["round_ms"]]

    def tier_bytes(docs):
        return sum(v["wire"]["bytes_sent"] + v["wire"]["bytes_received"]
                   for v in docs) / rounds

    res = dict(wall_s=wall, processes=cfg["procs"], exit_codes=codes,
               rounds=rounds, round_ms_median=statistics.median(round_ms),
               local_tier_bytes_per_round=tier_bytes(workers),
               global_tier_bytes_per_round=tier_bytes(
                   [v for k, v in stats.items()
                    if k.startswith("global_server")]),
               last_test_acc={f"p{p_}w{w_}": a[-1]
                              for (p_, w_), a in accs.items()},
               native_sgd=native_available())
    if cfg["mode"] == "fsa":
        if not res["native_sgd"]:
            raise AssertionError(f"{path}: the native runtime is not "
                                 "available, so the global server's SGD "
                                 "took the factory route")
        ref = models[(0, 0)]
        for key, m in models.items():
            for k in ref:
                if m[k].tobytes() != ref[k].tobytes():
                    raise AssertionError(f"{path}: worker {key}'s {k} "
                                         "differs from worker (0, 0)'s")
        golden = dist_ps_golden(torch)
        gap = max(float(np.abs(ref[k] - golden[k]).max()) for k in golden)
        if not gap < 5e-5:
            raise AssertionError(f"{path}: {gap} from the one-process "
                                 "golden (gate 5e-5)")
        res["golden_max_abs_diff"] = gap
        gate = "4 models bit-equal, golden gap " f"{gap:.3g} (gate 5e-5)"
    else:
        floor = DIST_PS_JAX_MIXED_LOWEST_MIN
        low = min(res["last_test_acc"].values())
        if low < floor:
            raise AssertionError(f"{path}: lowest last test accuracy {low} "
                                 f"under the JAX job's lowest worker's "
                                 f"minimum {floor:.3f}: "
                                 f"{res['last_test_acc']}")
        gate = (f"the lowest last test accuracy {low:.3f} >= the JAX "
                f"job's lowest worker's minimum {floor:.3f}")
    log(f"path {path}: {cfg['procs']} processes exited 0 in {wall:.1f} s, "
        f"{gate}, native SGD {res['native_sgd']}, round "
        f"{res['round_ms_median']:.2f} ms (median of {len(round_ms)} "
        f"push-and-pull rounds), socket bytes a round: local tier "
        f"{res['local_tier_bytes_per_round']:.0f}, global tier "
        f"{res['global_tier_bytes_per_round']:.0f}, last test_acc "
        f"{res['last_test_acc']}")
    return res


def _host_plane(device, rounds, grads_of, record=None, spy=None,
                on_done=None):
    """One host plane in this process: a global GeoPSServer (sync, two
    parties, native SGD 0.05), two local servers (sync, two workers
    each, "bsc,0.01", relay compressor on ``device``) and four clients.
    ``grads_of(pw, r, params)`` gives worker ``pw``'s pushes of round
    ``r``; ``on_done(global_server, clients)`` runs after the rounds,
    before the servers stop; returns every worker's pulls after each
    round and the workers' round times."""
    import threading

    import numpy as np

    from geomx_tpu_torch.service import GeoPSClient, GeoPSServer

    gs = GeoPSServer(num_workers=2, mode="sync", device=device).start()
    if spy is not None:
        orig = gs._handle_push
        gs._handle_push = lambda conn, msg: (spy(msg), orig(conn, msg))[1]
    locals_ = [GeoPSServer(num_workers=2, mode="sync",
                           global_addr=("127.0.0.1", gs.port),
                           global_sender_id=1000 + p, rank=1 + p,
                           compression="bsc,0.01", device=device).start()
               for p in range(2)]
    init = record["init"]
    keys = list(init)
    clients = {(p, w): GeoPSClient(("127.0.0.1", ls.port), sender_id=w)
               for p, ls in enumerate(locals_) for w in range(2)}
    for c in clients.values():
        for k in keys:
            c.init(k, init[k])
    clients[(0, 0)].set_optimizer("sgd", learning_rate=0.05)
    if gs._native_sgd is None:
        raise AssertionError("host plane: the global server's SGD took "
                             "the factory route, not the native one")
    pulls, round_ms, errs = {}, {}, []

    def run(pw, c):
        try:
            params = {k: np.array(c.pull(k, timeout=120.0)) for k in keys}
            for r in range(rounds):
                grads = grads_of(pw, r, params)
                t0 = time.perf_counter()
                rids = [c.push_async(k, grads[k], priority=-i)
                        for i, k in enumerate(keys)]
                for rid in rids:
                    c.wait(rid, timeout=120.0)
                params = {k: np.array(c.pull(k, timeout=120.0))
                          for k in keys}
                round_ms[(pw, r)] = 1e3 * (time.perf_counter() - t0)
                pulls[(pw, r)] = params
        except Exception as e:  # surfaced below: the phase fails
            errs.append(f"worker {pw}: {e!r}")

    threads = [threading.Thread(target=run, args=(pw, c))
               for pw, c in clients.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errs or any(t.is_alive() for t in threads):
        raise AssertionError(f"host plane failed: {errs}")
    if on_done is not None:
        on_done(gs, clients)
    for c in clients.values():
        c.stop_server()
        c.close()
    for ls in locals_:
        ls.join(timeout=60)
    gs.join(timeout=60)
    return pulls, round_ms


def host_plane_phase(torch) -> dict:
    """Phase host_plane_resnet20: the host plane in process on
    ResNet-20's parameter leaves at full width, kernel 3 on the relay
    hop.  Four workers train ResNet-20 on the card (one forward/backward
    a round on a synthetic CIFAR batch of 32 each) and push every leaf's
    gradient as numpy; the local servers' relay compressor runs
    bsc_select_pack on the card.  The pushed arrays replay through a
    twin plane whose relay compressor runs on the CPU (the plain
    versions): every round's pulls bit-equal across the workers and to
    the twin's, select/pack launched exactly (eligible leaves) x 2
    parties x 8 rounds times (the counts reset just before the card
    plane and read just after), each eligible leaf's relay payload
    exactly k (value, index) pairs.  The relay compress time a key is
    timed after the plane, one leaf at a time, as the relay runs it:
    the gradient to the device, the selection, the pairs back."""
    import threading

    import numpy as np

    from geomx_tpu_torch import ops
    from geomx_tpu_torch.compression import BiSparseCompressor
    from geomx_tpu_torch.compression.sparseagg import decode_pairs_payload
    from geomx_tpu_torch.models import get_model
    from geomx_tpu_torch.ops import bsc

    rounds, batch = HOST_PLANE_ROUNDS, HOST_PLANE_BATCH
    dev = torch.device("cuda")
    init = resnet20_leaves(torch)
    comp = BiSparseCompressor(0.01)
    eligible = {k: comp.k_for(v.size) for k, v in init.items()
                if v.size >= comp.min_sparse_size}
    models = {}
    for p in range(2):
        for w in range(2):
            m = get_model("resnet20").to(dev)
            m.train()
            models[(p, w)] = m
    pushed, losses = {}, []
    lock = threading.Lock()

    def card_grads(pw, r, params):
        m = models[pw]
        gen = torch.Generator(device=dev).manual_seed(1000 * r + 10 * pw[0]
                                                      + pw[1])
        x = torch.randn((batch, 32, 32, 3), generator=gen, device=dev)
        y = torch.randint(0, 10, (batch,), generator=gen, device=dev)
        with torch.no_grad():
            for k in params:
                m.get_parameter(k).copy_(torch.from_numpy(params[k]))
        m.zero_grad(set_to_none=True)
        loss = torch.nn.functional.cross_entropy(m(x, train=True), y)
        loss.backward()
        grads = {k: m.get_parameter(k).grad.detach().float().cpu().numpy()
                 for k in params}
        with lock:
            losses.append(float(loss.detach()))
            pushed[(pw, r)] = grads
        return grads

    relays = []

    def spy(msg):
        if msg.meta.get("comp") == "bsc" or msg.sender >= 1000:
            relays.append((msg.key, msg.meta.get("comp"),
                           None if msg.array is None
                           else np.array(msg.array)))

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    pulls, round_ms = _host_plane(dev, rounds, card_grads,
                                  record={"init": init}, spy=spy)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    want = len(eligible) * 2 * rounds
    if launches["bsc_select_pack"] != want:
        raise AssertionError(
            f"host plane: bsc_select_pack launched "
            f"{launches['bsc_select_pack']} times, want {want} "
            f"({len(eligible)} leaves x 2 parties x {rounds} rounds)")
    if not all(math.isfinite(v) for v in losses) or \
            len(losses) != 4 * rounds:
        raise AssertionError(f"host plane: losses {losses}")
    twin, _ = _host_plane("cpu", rounds, lambda pw, r, params: pushed[(pw, r)],
                          record={"init": init})
    for r in range(rounds):
        ref = pulls[((0, 0), r)]
        for pw in [(p, w) for p in range(2) for w in range(2)]:
            for k in ref:
                if pulls[(pw, r)][k].tobytes() != ref[k].tobytes():
                    raise AssertionError(f"host plane: round {r}: worker "
                                         f"{pw}'s {k} differs from (0, 0)'s")
                if twin[(pw, r)][k].tobytes() != ref[k].tobytes():
                    raise AssertionError(f"host plane: round {r}: worker "
                                         f"{pw}'s {k} differs from the CPU "
                                         "twin's")
    relay_bytes = dense_bytes = 0
    for key, kind, arr in relays:
        dense_bytes += init[key].nbytes
        relay_bytes += arr.nbytes
        if key in eligible:
            vals, idx = decode_pairs_payload(arr)
            if kind != "bsc" or vals.size != eligible[key] or \
                    not (idx < init[key].size).all():
                raise AssertionError(f"host plane: relay of {key} is not "
                                     f"{eligible[key]} pairs: {kind}, "
                                     f"{arr.size}")
        elif kind is not None or arr.size != init[key].size:
            raise AssertionError(f"host plane: {key} did not relay dense")
    if len(relays) != 2 * rounds * len(init):
        raise AssertionError(f"host plane: {len(relays)} relays, want "
                             f"{2 * rounds * len(init)}")
    # kernel 3 at the relay's leaf sizes: one [1, n] row a call
    sizes = sorted({init[k].size for k in eligible})
    gen = torch.Generator(device=dev).manual_seed(3)
    at_sizes = {}
    for n in sizes:
        k = comp.k_for(n)
        g, u, v = (torch.randn((1, n), generator=gen, device=dev)
                   for _ in range(3))
        thr = bsc.sampled_boundary_guv(g, u, v, k)
        before = bsc.select_pack.launches
        sel = bsc.select_pack(g, u, v, thr, k)
        err = max_err(torch, sel, bsc.select_pack_plain(g, u, v, thr, k))
        bsc.select_pack.launches = before
        at_sizes[n] = dict(
            k=k, max_abs_err=err,
            ms=device_ms(torch, lambda: bsc.select_pack(g, u, v, thr, k)),
            plain_ms=device_ms(torch, lambda: bsc.select_pack_plain(
                g, u, v, thr, k)),
            bound_ms=bound_ms(5 * n * 4 + k * 8 + 4))
    # the relay's compress of one key, as _relay_to_global_impl runs it
    # (the gradient to the device, the selection, the pairs back to the
    # host), on the card and on the CPU: median of 20 after one warm-up
    def relay_ms(device, key):
        c = BiSparseCompressor(0.01)
        n = init[key].size
        grad = pushed[((0, 0), 0)][key].reshape(-1)
        u = torch.zeros(n, device=device)
        v = torch.zeros(n, device=device)
        times = []
        for _ in range(21):
            if device.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            vals, idx, u, v = c.compress(
                torch.from_numpy(np.array(grad)).to(device), u, v)
            vals.cpu().numpy(), idx.cpu().numpy()
            times.append(time.perf_counter() - t0)
        return 1e3 * statistics.median(times[1:])

    card_ms = {k: relay_ms(dev, k) for k in eligible}
    cpu_ms = {k: relay_ms(torch.device("cpu"), k) for k in eligible}
    ops.reset_launch_counts()

    res = dict(
        leaves=len(init), eligible_leaves=len(eligible), rounds=rounds,
        params=int(sum(v.size for v in init.values())),
        round_ms_median=statistics.median(round_ms.values()),
        launches=launches,
        select_pack_launches_per_round=launches["bsc_select_pack"] / rounds,
        relay_compress_ms_by_key_card=card_ms,
        relay_compress_ms_by_key_cpu=cpu_ms,
        relay_compress_ms_per_key_card=statistics.median(card_ms.values()),
        relay_compress_ms_per_key_cpu_twin=statistics.median(
            cpu_ms.values()),
        relay_compress_ms_per_round_card=2 * sum(card_ms.values()),
        relay_compress_ms_per_round_cpu_twin=2 * sum(cpu_ms.values()),
        relay_bytes_per_round=relay_bytes / rounds,
        dense_relay_bytes_per_round=dense_bytes / rounds,
        loss_first=losses[0], loss_last=losses[-1],
        select_pack_at_leaf_sizes=at_sizes)
    log(f"phase host_plane_resnet20: {len(init)} ResNet-20 leaves "
        f"({res['params']} parameters, {len(eligible)} relayed as BSC "
        f"pairs), 4 workers x {rounds} rounds on the card, pulls bit-equal "
        f"across workers and to the CPU twin; bsc_select_pack "
        f"{launches['bsc_select_pack']} launches "
        f"({res['select_pack_launches_per_round']:.0f} a round); round "
        f"{res['round_ms_median']:.2f} ms (median); relay compress "
        f"{res['relay_compress_ms_per_key_card']:.3f} ms a key on the card "
        f"vs {res['relay_compress_ms_per_key_cpu_twin']:.3f} ms on the CPU "
        f"(medians over the {len(eligible)} leaves; "
        f"{res['relay_compress_ms_per_round_card']:.2f} vs "
        f"{res['relay_compress_ms_per_round_cpu_twin']:.2f} ms a round for "
        f"two parties, one key at a time); "
        f"relay bytes a round {res['relay_bytes_per_round']:.0f} vs dense "
        f"{res['dense_relay_bytes_per_round']:.0f}; loss "
        f"{res['loss_first']:.4f} -> {res['loss_last']:.4f}")
    for n, r in at_sizes.items():
        log(f"  bsc_select_pack at a relay leaf of {n} (k {r['k']}): "
            f"{r['ms'] * 1e3:.1f} us (plain {r['plain_ms'] * 1e3:.1f} us, "
            f"bound {r['bound_ms'] * 1e3:.3f} us), bit-equal")
    return res


# ---- telemetry: the step probes, flight recorder, capsule; the ledger ----

# Phase T: path 1f with the telemetry plane on; the poisoned twin's NaN
# lands in party 1's first input image at this step (1-based), and it
# runs TELEMETRY_POISON_STEPS steps
TELEMETRY_STEPS = 16
TELEMETRY_POISON_STEP = 5
TELEMETRY_POISON_STEPS = 8


# the CUDA runtime and driver calls that put work on the card's stream
_LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cuMemcpy",
                 "cudaMemset", "cuMemset")


def _cuda_launches(torch, fn) -> tuple:
    """What ``fn()`` puts on the card, from one profiler window:
    ``(launches, kernels)``.  ``launches`` is the host's launch calls
    (kernels, copies, fills) in the order they were made, each as
    "<ATen op>/<runtime call>"; the gates compare these.  ``kernels`` is
    the device's activity records by name, only printed: the profiler
    drops a varying number of the records at the end of a window (0 to
    70 of a ResNet-20 step's 12,700 on an H100), while the host's calls
    come out the same every time.  Both are empty off the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    on_card = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if on_card else [])
    if on_card:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        fn()
        if on_card:
            torch.cuda.synchronize()
    events = prof.events()
    calls = sorted((e for e in events if e.device_type == DeviceType.CPU
                    and e.name.startswith(_LAUNCH_CALLS)),
                   key=lambda e: e.time_range.start)
    launches = [f"{e.cpu_parent.name if e.cpu_parent else ''}/{e.name}"
                for e in calls]
    kernels = [e.name for e in events if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    return launches, kernels


class _Batches:
    """A loader over fixed ``(x, y)`` batches (the fit loop's
    ``epoch`` surface)."""

    def __init__(self, batches):
        self.batches = batches

    def epoch(self, epoch, prefetch=0):
        return iter(self.batches)


def telemetry_phase(torch, device=None, batch: int = 128,
                    steps: int = TELEMETRY_STEPS,
                    out_dir: str = os.path.join("chiprun_out", "telemetry"),
                    poison_steps: int = TELEMETRY_POISON_STEPS) -> dict:
    """Phase telemetry_fsa: path 1f (ResNet-20 at full width on [2, 4],
    128 a replica, "bsc,0.01", the fused SGD) through ``Trainer.fit``
    with GEOMX_TELEMETRY, the event log, the flight recorder (16 steps)
    and the capsule (sampled every 0.5 s) on.  Gates: a telemetry-off
    step makes the same launch calls (kernels, copies, fills), in the
    same order and from the same ATen ops, as a build whose probe
    collector raises, and kernels 1-5 3, 2, 1, 1, 1 times a step;
    the on-run's losses and final parameters bit-equal to the off-run's
    (cuDNN deterministic in both) with kernels 1-5 at 3, 2, 1, 1, 1 in
    every step; step 1's grad_norm_global within rtol 1e-5 of an fp64
    recompute over the applied gradient copied off the card; no
    non-finite probe; bsc_emitted_fraction equal to the emitted share
    recomputed from kernel 3's output of step 1; dc_wire_bytes the
    compressor's; one event-log record a log boundary; the capsule's step
    records equal to the published probes and its link journal replaying
    bit-identically; a poisoned twin (NaN in party 1's input at step 5)
    whose nonfinite rule fires at step 5 with a bundle naming party 1.
    Prints the probes' extra launch calls a step, the median step ms with
    telemetry on and off and the roofline record of one step."""
    from geomx_tpu_torch import ops
    from geomx_tpu_torch.data import load_dataset
    from geomx_tpu_torch.models import get_model
    from geomx_tpu_torch.telemetry import (Capsule, EventLog,
                                           get_link_observatory,
                                           parse_prometheus_text,
                                           render_prometheus, reset_registry)
    from geomx_tpu_torch.telemetry import probes as tprobes
    from geomx_tpu_torch.telemetry.export import set_default_event_log
    from geomx_tpu_torch.telemetry.flight import uninstall_incident_recorder
    from geomx_tpu_torch.telemetry.roofline import trainer_roofline
    from geomx_tpu_torch.train import step as step_mod

    t_phase = time.perf_counter()
    os.makedirs(out_dir, exist_ok=True)
    events = os.path.join(out_dir, "events.jsonl")
    for f in (events, events + ".1"):
        if os.path.exists(f):
            os.remove(f)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    reset_registry()
    try:
        data = load_dataset("synthetic", synthetic_train_n=8 * batch * steps)

        def build(**fields):
            t = make_trainer("fused_sgd", get_model("resnet20"),
                             device=device, **fields)
            t.init_state(seed=0)
            return t

        off = build()
        dev = off.device
        on_card = dev.type == "cuda"
        loader = off.make_loader(data["train_x"], data["train_y"], batch)
        batches = [(x.clone(), y.clone()) for x, y in loader.epoch(0)]
        batches = batches[:steps]

        # 1. the disabled path: a telemetry-off step against a build whose
        # probe collector cannot run, kernel for kernel
        def one_step(t):
            st = t.init_state(seed=0)
            return lambda: t.train_step(st, *batches[0])

        one_step(off)()                       # warm-up (cuDNN, allocator)
        ops.reset_launch_counts()
        calls_off, names_off = _cuda_launches(torch, one_step(off))
        counts_off = ops.launch_counts()

        def poison(*a, **k):
            raise AssertionError("probe collector ran on the disabled path")

        saved = (tprobes.collect_step_probes, tprobes.inline_collection)
        tprobes.collect_step_probes = tprobes.inline_collection = poison
        try:
            base = build()
            one_step(base)()
            calls_base, _ = _cuda_launches(torch, one_step(base))
        finally:
            tprobes.collect_step_probes, tprobes.inline_collection = saved
        if calls_off != calls_base:
            at = next((i for i, (a, b) in enumerate(zip(calls_off,
                                                         calls_base))
                       if a != b), min(len(calls_off), len(calls_base)))
            raise AssertionError(
                f"telemetry_fsa: the telemetry-off step made "
                f"{len(calls_off)} launch calls, the probe-free build "
                f"{len(calls_base)}; first difference at call {at}: "
                f"{calls_off[at:at + 3]} vs {calls_base[at:at + 3]}")
        want = {"fused_flatten": 3, "fused_unflatten": 2,
                "bsc_select_pack": 1, "bsc_scatter_add": 1,
                "fused_sgd_momentum": 1}
        if on_card and any(counts_off[k] != n for k, n in want.items()):
            raise AssertionError(f"telemetry_fsa: off step launches "
                                 f"{counts_off}, want {want}")

        # 2. the runs: off, then on with the step-1 applied gradient and
        # kernel 3's output captured
        def fit(t):
            st = t.init_state(seed=0)
            per_step = []
            ops.reset_launch_counts()
            prev = dict(ops.launch_counts())

            def log_fn(_s):
                now = ops.launch_counts()
                per_step.append({k: now[k] - prev[k] for k in want})
                prev.update(now)

            st, recs = t.fit(st, _Batches(batches), epochs=1, log_every=1,
                             log_fn=log_fn)
            losses = [r["loss"] for r in recs if "loss" in r]
            times = [r["time"] for r in recs if "loss" in r]
            return st, losses, times, per_step

        st_off, loss_off, times_off, _ = fit(off)
        on = build(telemetry=True, telemetry_events=events, flight=True,
                   flight_steps=steps,
                   flight_dir=os.path.join(out_dir, "flight"), capsule=True,
                   capsule_dir=os.path.join(out_dir, "capsule"),
                   capsule_sample_s=0.5)
        captured = {}
        fused_apply = step_mod.fused_apply
        bsc_comp = on.sync.dc_compressor.inner

        def capture_apply(spec, pb, gb, opt_state):
            if "grad" not in captured:
                captured["grad"] = [g[0, 0].detach().double().cpu()
                                    for g in gb]
            return fused_apply(spec, pb, gb, opt_state)

        def capture_compress(g, u, v, compress=bsc_comp.compress):
            out = compress(g, u, v)
            if "idx" not in captured:
                captured["idx"] = (out[1].detach().cpu(),
                                   bsc_comp.k_for(g.shape[-1]))
            return out

        step_mod.fused_apply, bsc_comp.compress = (capture_apply,
                                                   capture_compress)
        try:
            st_on, loss_on, times_on, per_step = fit(on)
        finally:
            step_mod.fused_apply = fused_apply
            del bsc_comp.compress
        on.close_capsule()
        set_default_event_log(None)
        uninstall_incident_recorder(on._flight)
        if [float(x) for x in loss_on] != [float(x) for x in loss_off]:
            raise AssertionError(f"telemetry_fsa: losses with telemetry "
                                 f"{loss_on} differ from {loss_off}")
        for k_, v in st_on.params.items():
            if not torch.equal(v, st_off.params[k_]):
                raise AssertionError(f"telemetry_fsa: parameter {k_} "
                                     "differs with telemetry on")
        if on_card and any(ps != want for ps in per_step):
            raise AssertionError(f"telemetry_fsa: on-run launches a step "
                                 f"{per_step}, want {want} every step")

        # 3. the probes
        recs = [e for e in EventLog(events).read()
                if e["kind"] == "step_probes"]
        if [e["iteration"] for e in recs] != list(range(1, steps + 1)):
            raise AssertionError(f"telemetry_fsa: event log iterations "
                                 f"{[e['iteration'] for e in recs]}")
        p1 = recs[0]
        g64 = torch.cat([g.reshape(-1) for g in captured["grad"]])
        norm64 = float(torch.linalg.vector_norm(g64))
        rel = abs(p1["grad_norm_global"] - norm64) / norm64
        if not rel <= 1e-5:
            raise AssertionError(f"telemetry_fsa: grad_norm_global "
                                 f"{p1['grad_norm_global']} vs fp64 "
                                 f"{norm64} (rel {rel:.3g})")
        for e in recs:
            if e["grad_nonfinite_count"] != 0 or \
                    any(e["party_grad_nonfinite"]) or \
                    e["grad_all_finite"] != 1.0:
                raise AssertionError(f"telemetry_fsa: non-finite probe at "
                                     f"{e['iteration']}: {e}")
        idx, k = captured["idx"]
        emitted = ((idx >= 0).sum(-1).double() / k).mean(1).mean(0).item()
        if abs(p1["bsc_emitted_fraction"] - emitted) > 2.0 ** -23:
            raise AssertionError(f"telemetry_fsa: bsc_emitted_fraction "
                                 f"{p1['bsc_emitted_fraction']} vs "
                                 f"{emitted} recomputed from kernel 3")
        wire = float(on.sync.dc_compressor.wire_bytes(st_on.params))
        if p1["dc_wire_bytes"] != wire or wire != 21808:
            raise AssertionError(f"telemetry_fsa: dc_wire_bytes "
                                 f"{p1['dc_wire_bytes']}, compressor "
                                 f"{wire}")
        parse_prometheus_text(render_prometheus())

        # 4. the capsule: step records as published, the link journal
        # (one observation a party a step: the dc payload over the step's
        # wall time) replaying bit-identically
        cap = Capsule.load(os.path.join(out_dir, "capsule",
                                        "run_capsule.json"))
        if [s["step"] for s in cap.steps] != list(range(1, steps + 1)):
            raise AssertionError("telemetry_fsa: capsule steps "
                                 f"{[s['step'] for s in cap.steps]}")
        for s, e in zip(cap.steps, recs):
            for name, val in s["probes"].items():
                if e.get(name) != val:
                    raise AssertionError(
                        f"telemetry_fsa: capsule step {s['step']} {name} "
                        f"{val} vs published {e.get(name)}")
        obs = get_link_observatory()
        from geomx_tpu_torch.telemetry.capsule import RunCapsule
        rc = RunCapsule(os.path.join(out_dir, "capsule", "links.json"))
        rc.attach_observatory(obs)
        t_prev = times_on[0]
        for i, t in enumerate(times_on[1:], start=1):
            for p in range(2):
                obs.observe(f"party{p}", nbytes=wire, seconds=t - t_prev,
                            t=1000.0 + i)
            t_prev = t
        live = json.dumps(obs.snapshot(now=1000.0 + steps), sort_keys=True)
        rc.detach_observatory()
        replay = Capsule.load(rc.write(now=1000.0 + steps))
        if json.dumps(replay.link_snapshot(now=1000.0 + steps),
                      sort_keys=True) != live:
            raise AssertionError("telemetry_fsa: the capsule's link "
                                 "journal did not replay bit-identically")
        cap_bytes = os.path.getsize(os.path.join(out_dir, "capsule",
                                                 "run_capsule.json"))

        # 5. the poisoned twin: NaN in party 1's input at step 5
        pois = build(telemetry=True, flight=True, flight_steps=poison_steps,
                     flight_dir=os.path.join(out_dir, "flight_poison"))
        pb = []
        for s, (x, y) in enumerate(batches[:poison_steps]):
            x = x.to(torch.float32)
            if s + 1 == TELEMETRY_POISON_STEP:
                x[1, 0, 0, 0, 0, 0] = float("nan")
            pb.append((x, y))
        st_p = pois.init_state(seed=0)
        pois.fit(st_p, _Batches(pb), epochs=1, log_every=1,
                 log_fn=lambda s: None)
        uninstall_incident_recorder(pois._flight)
        fired = [d for d in pois._flight.dumps
                 if os.path.basename(d).startswith(
                     f"flight_step{TELEMETRY_POISON_STEP}_nonfinite")]
        first = min((int(os.path.basename(d)[len("flight_step"):]
                         .split("_")[0]) for d in pois._flight.dumps),
                    default=None)
        if not fired or first != TELEMETRY_POISON_STEP:
            raise AssertionError(f"telemetry_fsa: flight dumps "
                                 f"{pois._flight.dumps}")
        with open(fired[0]) as f:
            bundle = json.load(f)
        if bundle["poisoned_parties"] != [1]:
            raise AssertionError(f"telemetry_fsa: the bundle names "
                                 f"{bundle['poisoned_parties']}")

        # 6. the probes' extra kernels a step, the roofline of one step
        one_step(on)()
        calls_on, names_on = _cuda_launches(torch, one_step(on))
        set_default_event_log(None)
        warm = 2
        med = {}
        for name, ts in (("on", times_on), ("off", times_off)):
            d = [b - a for a, b in zip(ts[warm - 1:], ts[warm:])]
            med[name] = 1e3 * statistics.median(d)
        st = off.init_state(seed=0)
        roof = trainer_roofline(off, st, *batches[0],
                                step_time_s=med["off"] / 1e3)
        # the probes' launches: the on-step's launch calls less the
        # off-step's, by ATen op and call (the probes interleave with the
        # step's own)
        import collections
        extra = dict(collections.Counter(calls_on)
                     - collections.Counter(calls_off))
        res = dict(
            steps=steps, losses=[float(x) for x in loss_on],
            step_ms_median_on=med["on"], step_ms_median_off=med["off"],
            launch_calls_per_step_off=len(calls_off),
            launch_calls_per_step_on=len(calls_on),
            probe_launch_calls_per_step=len(calls_on) - len(calls_off),
            device_records_per_step_off=len(names_off),
            device_records_per_step_on=len(names_on),
            probe_launch_calls_by_op=extra,
            launches_per_step_on=per_step[-1] if per_step else None,
            grad_norm_global_step1=p1["grad_norm_global"],
            grad_norm_fp64=norm64, grad_norm_rel_err=rel,
            bsc_emitted_fraction=p1["bsc_emitted_fraction"],
            dc_nonzero_fraction=p1["dc_nonzero_fraction"],
            ef_residual_norm=p1["ef_residual_norm"],
            dc_wire_bytes=p1["dc_wire_bytes"], capsule_bytes=cap_bytes,
            capsule_samples=len(cap.registry_samples),
            event_records=len(recs), flight_bundle=fired[0],
            roofline=roof, wall_s=time.perf_counter() - t_phase)
        log(f"phase telemetry_fsa: {steps} steps, losses and parameters "
            f"bit-equal with telemetry on and off; launch calls a step "
            f"{len(calls_off)} off (= the probe-free build, call for "
            f"call), {len(calls_on)} on (+"
            f"{res['probe_launch_calls_per_step']} for the probes; device "
            f"records {len(names_off)} off, {len(names_on)} on); kernels "
            f"1-5 {per_step[-1] if per_step else '-'}"
            f" every step; step {med['on']:.2f} ms on vs {med['off']:.2f} "
            f"ms off (medians); step 1 grad_norm_global "
            f"{p1['grad_norm_global']:.7g} vs fp64 {norm64:.7g} (rel "
            f"{rel:.2g}), bsc_emitted_fraction "
            f"{p1['bsc_emitted_fraction']}, dc_nonzero_fraction "
            f"{p1['dc_nonzero_fraction']:.6g}, dc_wire_bytes "
            f"{p1['dc_wire_bytes']:.0f}; {len(recs)} event records; "
            f"capsule {cap_bytes} B ({len(cap.registry_samples)} registry "
            f"samples) replayed; the poisoned twin's bundle "
            f"{os.path.basename(fired[0])} names party 1; roofline: "
            f"{roof['flops_per_step']:.4g} FLOPs a step, MFU "
            f"{roof['mfu']:.4g} of {roof['peak_flops_per_s']:.4g} FLOP/s "
            f"({roof['device_kind']}), {roof['bound']}; phase "
            f"{res['wall_s']:.1f} s")
        log(f"  the probes' launch calls a step, by ATen op: {extra}")
        return res
    finally:
        torch.backends.cudnn.deterministic = deterministic
        set_default_event_log(None)


def _audit_env_trainer(path: str, **kw):
    """make_trainer under GEOMX_AUDIT=1 (the variable restored after)."""
    prev = os.environ.get("GEOMX_AUDIT")
    os.environ["GEOMX_AUDIT"] = "1"
    try:
        return make_trainer(path, **kw)
    finally:
        if prev is None:
            os.environ.pop("GEOMX_AUDIT", None)
        else:
            os.environ["GEOMX_AUDIT"] = prev


def audit_fsa_phase(torch, device=None, batch: int = 128,
                    depth_batch: int = 32) -> dict:
    """Phase audit_fsa: resilience_fsa's configuration (ResNet-20 at full
    width on [4, 2], 128 images a replica, "bsc,0.01", the fused
    SGD-momentum) with GEOMX_AUDIT=1.  Gates: (a) fit's first batch arms
    the auditor (one recording on CPU zeros); (b) a swap to
    RESILIENCE_REFERENCE_MASK and back audits clean, a step under the
    mask reports 3 live parties; (c) against a reference signature cut by
    one entry the swap raises AuditError (GX-COLLECTIVE-002) with the
    active step and binding left in place; (d) the per-leaf SGD twin
    (a depth-1 drain does not compose with the fused apply, as in the
    JAX package), at ``depth_batch`` images a replica (a recording is a
    CPU step, its host time grows with the batch; the collectives do
    not), re-arms clean at a depth switch 0->1->0, one reference after
    each; (e) an audited step makes the launch calls, in order, of
    an unaudited twin's step; (f) on the card, hlo.materialization_counts
    of the fused BSC compress is below the plain version's on the same
    CUDA tensors, the dense cumsum/scatter gone with kernel 3 launched
    (hlo.compare_paths / assert_dense_intermediates_removed); finite
    losses.  Prints the host ms of arming and each recording, the
    signature's length and the two counts."""
    from geomx_tpu_torch import ops
    from geomx_tpu_torch.analysis import AuditError, hlo, record_program
    from geomx_tpu_torch.control import Decision
    from geomx_tpu_torch.data import load_dataset
    from geomx_tpu_torch.models import get_model
    from geomx_tpu_torch.ops import bsc as bsc_ops
    from geomx_tpu_torch.ops.sampled_topk import probe_positions
    from geomx_tpu_torch.tree import leaf_names

    t_phase = time.perf_counter()
    # the recorder's one-off cost in a process (torch's lazy imports on a
    # first dispatch mode), apart from the arming it would land in
    t0 = time.perf_counter()
    record_program(lambda x: x + 1.0, torch.zeros(1))
    first_use_ms = 1e3 * (time.perf_counter() - t0)
    _, _, _, _, _, _, (P, W), _ = PATHS["resilience_fsa"]
    mask = RESILIENCE_REFERENCE_MASK
    data = load_dataset("synthetic", synthetic_train_n=P * W * batch * 2)
    trainer = _audit_env_trainer("resilience_fsa", model=get_model(
        "resnet20"), device=device)
    on_card = trainer.device.type == "cuda"
    loader = trainer.make_loader(data["train_x"], data["train_y"], batch)
    batches = list(loader.epoch(0, prefetch=0))[:2]
    res = {"device": str(trainer.device), "batch": batch,
           "recorder_first_use_ms": first_use_ms}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    state = trainer.init_state(seed=0)
    sync()
    ops.reset_launch_counts()
    state, _ = trainer.fit(state, _Batches(batches[:1]), epochs=1,
                           log_fn=lambda s: None)
    sync()
    res["launches"] = ops.launch_counts()
    res["arm_ms"] = trainer.audit_record_ms[0]
    ref_sig, ref_findings = trainer._audit_sigs[None]
    res["signature_len"] = len(ref_sig)
    res["signature_collectives"] = sorted({e[0] for e in ref_sig})
    _gate(res, "armed", trainer._audit_args is not None
          and len(trainer.audit_record_ms) == 1 and ref_findings == [])
    losses = []
    # (b) the swap to the mask and back
    state = trainer.apply_membership(state, mask)
    state, m = trainer.train_step(state, *batches[1])
    losses.append(float(m["loss"]))
    live_under_mask = float(m["num_live_parties"])
    state = trainer.apply_membership(state, (True,) * P)
    state, m = trainer.train_step(state, *batches[0])
    losses.append(float(m["loss"]))
    res["swap_ms"] = trainer.audit_record_ms[1:]
    _gate(res, "swap_audits_clean", set(trainer._audit_sigs) == {None, mask}
          and trainer._audit_sigs[mask][0] == ref_sig
          and live_under_mask == float(sum(mask))
          and len(trainer.audit_record_ms) == 2)
    # (c) an injected divergence: the reference one entry short
    active = trainer.train_step
    trainer._audit_sigs[None] = (ref_sig[:-1], ref_findings)
    raised = None
    try:
        trainer.apply_membership(state, mask)
    except AuditError as e:
        raised = sorted({f.rule_id for f in e.findings})
    finally:
        trainer._audit_sigs[None] = (ref_sig, ref_findings)
    res["divergence_findings"] = raised
    _gate(res, "divergence_raises_before_swap",
          raised == ["GX-COLLECTIVE-002"] and trainer.train_step is active
          and trainer.sync.live_parties is None
          and trainer._membership is None)
    # (e) the audited step's launch calls against an unaudited twin's
    twin = make_trainer("resilience_fsa", get_model("resnet20"),
                        device=device)
    tstate = twin.init_state(seed=0)
    tstate, _ = twin.train_step(tstate, *batches[0])  # lazily built consts
    calls_on, _ = _cuda_launches(torch, lambda: trainer.train_step(
        state, *batches[1]))
    calls_off, _ = _cuda_launches(torch, lambda: twin.train_step(
        tstate, *batches[1]))
    res["launch_calls_per_step_on"] = len(calls_on)
    res["launch_calls_per_step_off"] = len(calls_off)
    _gate(res, "same_launch_calls_audit_on_off", calls_on == calls_off)
    if calls_on != calls_off:
        log(f"audit_fsa: launch calls differ at "
            f"{_first_difference(calls_on, calls_off)}")
    del twin, tstate
    # (d) the depth switch on the per-leaf SGD twin
    depth_tr = _audit_env_trainer("resilience_fsa", model=get_model(
        "resnet20"), device=device, fused=False, control=True)
    dloader = depth_tr.make_loader(data["train_x"], data["train_y"],
                                   depth_batch)
    dbatches = list(dloader.epoch(0, prefetch=0))[:2]
    dstate = depth_tr.init_state(seed=0)
    dstate, _ = depth_tr.fit(dstate, _Batches(dbatches[:1]), epochs=1,
                             log_fn=lambda s: None)
    sig_len = {0: len(depth_tr._audit_sigs[None][0])}
    ok = True
    for depth in (1, 0):
        dstate = depth_tr.apply_control(dstate, Decision(
            step=0, kind="depth", value=depth, prev=1 - depth, reason="audit"))
        dstate, m = depth_tr.train_step(dstate, *dbatches[1])
        losses.append(float(m["loss"]))
        ok = ok and list(depth_tr._audit_sigs) == [None] \
            and depth_tr._audit_sigs[None][1] == [] \
            and depth_tr.control_depth() == depth
        sig_len[depth if depth else "0_again"] = len(
            depth_tr._audit_sigs[None][0])
    res["depth_signature_len"] = sig_len
    res["depth_record_ms"] = depth_tr.audit_record_ms
    _gate(res, "depth_switch_rearms_clean", ok
          and len(depth_tr.audit_record_ms) == 3
          and sig_len["0_again"] == sig_len[0])
    del depth_tr, dstate
    # (f) the fused-versus-plain verdict on the card
    if on_card:
        bucketed, _ = dc_tier(trainer.sync)
        comp = bucketed.inner
        n = bucketed.zero_bucketer([state.params[k] for k in leaf_names(
            state.params)]).bucket_sizes[0]
        gen = torch.Generator(device=trainer.device).manual_seed(21)
        g = torch.randn((P, W, n), device=trainer.device, generator=gen)
        u = torch.randn((P, W, n), device=trainer.device, generator=gen)
        v = torch.randn((P, W, n), device=trainer.device, generator=gen)
        k = comp.k_for(n)
        pos = probe_positions(n, device=trainer.device)

        def plain(g, u, v):
            thr = bsc_ops.sampled_boundary_guv(g, u, v, k, positions=pos)
            return bsc_ops.select_pack_plain(g, u, v, thr, k)

        verdict = hlo.compare_paths(plain, comp.compress, g, u, v,
                                    dense_ops=("cumsum", "scatter"))
        res["materialization"] = verdict
        ok = True
        try:
            hlo.assert_dense_intermediates_removed(verdict)
        except AssertionError as e:
            log(f"audit_fsa: {e}")
            ok = False
        _gate(res, "fused_compress_materializes_less", ok
              and verdict["fused"]["total"] < verdict["unfused"]["total"]
              and verdict["unfused"]["kernel_launches"] == 0)
    _gate(res, "finite_losses", all(math.isfinite(x) for x in losses))
    res["losses"] = losses
    res["wall_s"] = time.perf_counter() - t_phase
    mat = res.get("materialization")
    log(f"audit_fsa: [{P}, {W}] x {batch}, the recorder's first use "
        f"{first_use_ms:.1f} ms, arming {res['arm_ms']:.1f} ms "
        f"host, swap recordings {[round(x, 1) for x in res['swap_ms']]} "
        f"ms, depth re-arms "
        f"{[round(x, 1) for x in res['depth_record_ms']]} ms (arm, 0->1, "
        f"1->0); signature {res['signature_len']} entries "
        f"({', '.join(res['signature_collectives'])}), depth "
        f"{res['depth_signature_len']}; divergence "
        f"{res['divergence_findings']}; launch calls a step "
        f"{res['launch_calls_per_step_on']} audited / "
        f"{res['launch_calls_per_step_off']} unaudited; "
        + ("materializing ops of the BSC compress: plain "
           f"{mat['unfused']} vs fused {mat['fused']}" if mat else
           "no card: the fused-versus-plain verdict not taken")
        + f"; wall {res['wall_s']:.1f} s")
    failed = [k_ for k_, v_ in res["gates"].items() if not v_]
    if failed:
        raise AssertionError(f"audit_fsa: gates failed: {failed}")
    return res


def ledger_phase(torch, device=None, rounds: int = HOST_PLANE_ROUNDS) -> dict:
    """Phase ledger_host_plane: host_plane_resnet20's in-process plane
    (65 leaves, 2 parties, the relay's kernel 3 on ``device``) with the
    round ledger reset before it, seeded normal gradients.  Gates: every
    (key, round) record complete; the ledger's frame bytes plus the
    frames it gives to no round (commands, heartbeats, ACKs, pulls)
    equal to WireStats' socket bytes in both directions within
    LEDGER_WIRE_SLACK bytes; every clean round reconciles (its push bytes
    within active_frame_overhead_bound a frame of the declared bytes,
    under the binary codec within 2% once frames carry 4 KiB); the
    registry's Prometheus text parses back, and a metrics command to the
    global server returns the same families."""
    import numpy as np

    from geomx_tpu_torch.service import protocol
    from geomx_tpu_torch.telemetry import (parse_prometheus_text,
                                           render_prometheus)
    from geomx_tpu_torch.telemetry.ledger import (active_frame_overhead_bound,
                                                  reset_round_ledger)

    t_phase = time.perf_counter()
    dev = torch.device("cuda") if device is None else torch.device(device)
    init = resnet20_leaves(torch)
    rng = np.random.RandomState(17)
    grads = {(pw, r): {k: (rng.standard_normal(v.shape) * 1e-2)
                       .astype(np.float32) for k, v in init.items()}
             for pw in [(p, w) for p in range(2) for w in range(2)]
             for r in range(rounds)}
    unassigned = {"tx": [0, 0], "rx": [0, 0]}
    orig = protocol._ledger_account

    def account(direction, msg, nbytes):
        meta = msg.meta
        if msg.key is None or not meta or \
                int(msg.type) not in protocol._LEDGER_TYPES or \
                meta.get("round") is None:
            unassigned[direction][0] += 1
            unassigned[direction][1] += int(nbytes)
        return orig(direction, msg, nbytes)

    led = reset_round_ledger(capacity=4 * len(init) * rounds)
    families = {}

    def metrics(gs, clients):
        c = clients[(0, 0)]
        text = c.metrics_text()
        families["command"] = set(parse_prometheus_text(text))
        families["local"] = set(parse_prometheus_text(render_prometheus()))

    before = protocol.wire_stats.snapshot()
    protocol._ledger_account = account
    try:
        _host_plane(dev, rounds, lambda pw, r, params: grads[(pw, r)],
                    record={"init": init}, on_done=metrics)
    finally:
        protocol._ledger_account = orig
    after = protocol.wire_stats.snapshot()
    socket_tx = after["bytes_sent"] - before["bytes_sent"]
    socket_rx = after["bytes_received"] - before["bytes_received"]
    recs = led.records()
    want = {(k, r) for k in init for r in range(1, rounds + 1)}
    got = {(r["key"], r["round"]): r for r in recs}
    missing = sorted(want - set(got))
    if missing:
        raise AssertionError(f"ledger_host_plane: {len(missing)} rounds "
                             f"without a record, e.g. {missing[:3]}")
    open_ = [rk for rk in want if got[rk]["status"] != "complete"]
    if open_:
        raise AssertionError(f"ledger_host_plane: {len(open_)} rounds not "
                             f"complete, e.g. {open_[:3]}")
    led_tx = sum(v for r in recs for k, v in r["wire"].items()
                 if k.endswith("_tx_bytes"))
    led_rx = sum(v for r in recs for k, v in r["wire"].items()
                 if k.endswith("_rx_bytes"))
    diff_tx = socket_tx - (led_tx + unassigned["tx"][1])
    diff_rx = socket_rx - (led_rx + unassigned["rx"][1])
    if abs(diff_tx) > LEDGER_WIRE_SLACK or abs(diff_rx) > LEDGER_WIRE_SLACK:
        raise AssertionError(
            f"ledger_host_plane: socket bytes {socket_tx} sent / "
            f"{socket_rx} received vs ledger {led_tx} / {led_rx} plus "
            f"unassigned {unassigned['tx'][1]} / {unassigned['rx'][1]}")
    bound = active_frame_overhead_bound()
    bad, ratios = [], []
    for rec in led._done.values():
        if rec.fault_hops():
            continue
        ratio = rec.honesty_ratio()
        if ratio is not None:
            ratios.append(ratio)
        if not rec.reconciles():
            bad.append((rec.key, rec.round, ratio))
    if bad:
        raise AssertionError(f"ledger_host_plane: {len(bad)} rounds do not "
                             f"reconcile, e.g. {bad[:3]}")
    if families["command"] != families["local"]:
        raise AssertionError(
            "ledger_host_plane: the metrics command's families differ: "
            f"{sorted(families['command'] ^ families['local'])}")
    hops: dict = {}
    for r in recs:
        for h in r["hops"]:
            hops[h["hop"]] = hops.get(h["hop"], 0) + 1
    res = dict(
        rounds=rounds, keys=len(init), records=len(recs),
        ledger_tx_bytes_per_round=led_tx / rounds,
        ledger_rx_bytes_per_round=led_rx / rounds,
        socket_tx_bytes_per_round=socket_tx / rounds,
        socket_rx_bytes_per_round=socket_rx / rounds,
        unassigned_tx_frames=unassigned["tx"][0],
        unassigned_tx_bytes=unassigned["tx"][1],
        unassigned_rx_frames=unassigned["rx"][0],
        unassigned_rx_bytes=unassigned["rx"][1],
        diff_tx_bytes=diff_tx, diff_rx_bytes=diff_rx,
        honesty_ratio_min=min(ratios), honesty_ratio_max=max(ratios),
        frame_overhead_bound=bound, hops=hops,
        metric_families=len(families["local"]),
        wall_s=time.perf_counter() - t_phase)
    log(f"phase ledger_host_plane: {len(init)} keys x {rounds} rounds, "
        f"{len(recs)} records all complete; bytes a round: ledger "
        f"{res['ledger_tx_bytes_per_round']:.1f} sent / "
        f"{res['ledger_rx_bytes_per_round']:.1f} received, socket "
        f"(WireStats) {res['socket_tx_bytes_per_round']:.1f} / "
        f"{res['socket_rx_bytes_per_round']:.1f}; frames in no round "
        f"{unassigned['tx'][0]} sent ({unassigned['tx'][1]} B) / "
        f"{unassigned['rx'][0]} received ({unassigned['rx'][1]} B); "
        f"socket - (ledger + no-round) = {diff_tx} / {diff_rx} B; honesty "
        f"ratio {res['honesty_ratio_min']:.5f}-"
        f"{res['honesty_ratio_max']:.5f} (frame bound {bound} B); hops "
        f"{hops}; metrics command: {len(families['local'])} families, the "
        f"registry's; phase {res['wall_s']:.1f} s")
    return res


# ---- the sharded global tier, the KVStore, the long-context example --------

# the JAX package's many-party acceptance (bench.py --compare-manyparty)
# at its cluster size: 16 virtual parties x 4 shards, each party a
# ShardedGlobalClient with session resume and P3 slices of 512 elements
# as bench.py:4348-4353 builds them; here on ResNet-20's 65 leaves
MANYPARTY = dict(parties=16, shards=4, rounds=6, rebalance_round=2,
                 p3_slice_elems=512)
# bench.py --compare-manyparty's chaos run on the same traffic: shard 1
# killed before round 3's traffic (round index 2) and restarted on its
# journal one tick later; the clock moves to the restart once no party
# has finished the round for MANYPARTY_DWELL_S (bench.py's stall dwell)
MANYPARTY_CHAOS = "seed=991;kill@2:node=shard1,restart_after=1"
MANYPARTY_DWELL_S = 0.4
# the chaos run's rounds: the restart's round and one after it (its
# final pulls are held against the twin's pulls after as many rounds)
MANYPARTY_CHAOS_ROUNDS = 4
# bench.py:4581's merge-throughput shape: 8 keys of 65,536, each shard
# its own process, 48 pushes a key from 4 threads (best of 2)
MANYPARTY_THROUGHPUT = dict(shard_counts=(1, 2, 4), nkeys=8, dim=65536,
                            pushes_per_key=48, threads=4, repeats=2)
KVSTORE = dict(topology=(2, 4), bsc_rounds=8, twobit_rounds=4,
               train_rounds=8, batch=32, rs_shape=(256, 64), rs_rows=48)
# kvstore_hips (d): the touched rows' lazy Adam on the card against the
# CPU twin (its square root and division may round an ulp apart)
KVSTORE_RS_RTOL, KVSTORE_RS_ATOL = 1e-5, 1e-7


def resnet20_leaves(torch) -> dict:
    """ResNet-20's parameter leaves at full width (their initial values,
    numpy, in the JAX package's leaf order)."""
    from geomx_tpu_torch.models import get_model
    base = get_model("resnet20")
    return {k: base.get_parameter(k).detach().float().numpy().copy()
            for k in base.param_names()}


def _manyparty_tier(torch, init: dict, num_shards: int, shard_device,
                    compress_device, rebalance: bool,
                    durable_root=None, rounds=None) -> dict:
    """One run of the many-party traffic against a sharded tier of
    ``num_shards`` shards on ``shard_device`` (Adam through the factory
    there): every party pushes each round's seeded normal gradient of
    every leaf, the leaves of at least 1,024 elements as BSC pairs from
    its own BiSparseCompressor on ``compress_device``, the rest dense;
    then pulls every leaf.  With ``rebalance`` the scheduler rebalances
    (min_gain 0) after the first half of the parties pushed round
    ``rebalance_round``, while the round is open.  With ``durable_root``
    the scheduler and every shard journal under it, and MANYPARTY_CHAOS
    drives the shards' lifecycle through the chaos engine's hook, as
    bench.py --compare-manyparty does: ``kill`` crashes the shard before
    the round's traffic, ``restart`` is a replacement on the same port
    replaying the shard's journal; the clock moves to the restart once
    no party has finished the round for MANYPARTY_DWELL_S.  ``rounds``
    defaults to MANYPARTY's; party 0's pulls after each round come back
    as ``round_pulls``."""
    import threading

    import numpy as np

    from geomx_tpu_torch.compression import BiSparseCompressor
    from geomx_tpu_torch.compression.sparseagg import encode_pairs_payload
    from geomx_tpu_torch.service import (GeoScheduler, SchedulerClient,
                                         ShardedGlobalClient,
                                         start_sharded_global_tier)
    from geomx_tpu_torch.service.protocol import wire_stats

    P = MANYPARTY["parties"]
    rounds = rounds or MANYPARTY["rounds"]
    keys = list(init)
    round_pulls = []
    sdir = tdir = None
    if durable_root is not None:
        sdir = os.path.join(durable_root, "scheduler")
        tdir = os.path.join(durable_root, "tier")
    sched = GeoScheduler(durable_dir=sdir).start()
    addr = ("127.0.0.1", sched.port)
    servers = start_sharded_global_tier(addr, num_shards=num_shards,
                                        num_workers=P, device=shard_device,
                                        durable_dir=tdir)
    chaos = _ShardLifecycle(servers, P, shard_device, tdir) \
        if durable_root is not None else None
    sc = SchedulerClient(addr)
    workers = [ShardedGlobalClient(
        addr, sender_id=p, reconnect=True,
        p3_slice_elems=MANYPARTY["p3_slice_elems"], reconnect_timeout_s=8.0,
        op_timeout_s=240.0) for p in range(P)]
    try:
        for k in keys:
            for w in workers:   # idempotent replays of one INIT
                w.init(k, init[k])
        workers[0].set_optimizer("adam", learning_rate=0.01)
        comps = [BiSparseCompressor(0.01) for _ in range(P)]
        eligible = [k for k in keys
                    if init[k].size >= comps[0].min_sparse_size]
        uv = {(p, k): (torch.zeros((1, init[k].size),
                                   device=compress_device),
                       torch.zeros((1, init[k].size),
                                   device=compress_device))
              for p in range(P) for k in eligible}
        compress_ms, round_ms, errs = [], [], []
        rebalanced = threading.Event()
        first_half = threading.Semaphore(0)
        done = threading.Semaphore(0)
        go = [threading.Event() for _ in range(rounds)]
        payloads = {}
        rebal = {}

        def party(p):
            w = workers[p]
            try:
                for r in range(rounds):
                    go[r].wait()
                    late = rebalance and r == MANYPARTY["rebalance_round"] \
                        and p >= P // 2
                    if late:
                        rebalanced.wait()
                    for k in keys:
                        arr, meta = payloads[(p, k)]
                        w.push(k, arr, meta=meta)
                    if rebalance and r == MANYPARTY["rebalance_round"] \
                            and not late:
                        first_half.release()
                    pulled = {k: np.array(w.pull(k, timeout=240.0))
                              for k in keys}
                    if p == 0:
                        round_pulls.append(pulled)
                    done.release()
            except Exception as e:  # surfaced below: the phase fails
                errs.append(f"party {p}: {e!r}")
                done.release()

        threads = [threading.Thread(target=party, args=(p,), daemon=True)
                   for p in range(P)]
        for t in threads:
            t.start()
        wire0 = wire_stats.snapshot()
        for r in range(rounds):
            for p in range(P):
                rng = np.random.default_rng(7919 * p + r)
                for k in keys:
                    g = rng.standard_normal(init[k].shape, dtype=np.float32)
                    if k not in eligible:
                        payloads[(p, k)] = (g, None)
                        continue
                    if compress_device.type == "cuda":
                        torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    u, v = uv[(p, k)]
                    vals, idx, u, v = comps[p].compress(
                        torch.from_numpy(g.reshape(1, -1)).to(
                            compress_device), u, v)
                    pay = encode_pairs_payload(vals.cpu().numpy(),
                                               idx.cpu().numpy())
                    compress_ms.append(1e3 * (time.perf_counter() - t0))
                    uv[(p, k)] = (u, v)
                    payloads[(p, k)] = (pay, {"comp": "bsc",
                                              "n": int(init[k].size),
                                              "shape": list(init[k].shape)})
            if chaos is not None:
                chaos.engine.tick(r)  # before the round's traffic
            t0 = time.perf_counter()
            go[r].set()
            if rebalance and r == MANYPARTY["rebalance_round"]:
                for _ in range(P // 2):
                    if not first_half.acquire(timeout=600):
                        raise AssertionError("manyparty: the first half of "
                                             "the parties did not push")
                t1 = time.perf_counter()
                rebal = sc.rebalance_shards(min_gain=0)
                rebal["wall_ms"] = 1e3 * (time.perf_counter() - t1)
                rebalanced.set()
            got, last = 0, time.perf_counter()
            while got < P:
                if done.acquire(timeout=0.05):
                    got, last = got + 1, time.perf_counter()
                elif time.perf_counter() - last > 600:
                    raise AssertionError(f"manyparty: round {r} stalled")
                elif chaos is not None and chaos.killed and \
                        time.perf_counter() - last > MANYPARTY_DWELL_S:
                    # an outage: move the clock so the restart fires
                    chaos.engine.tick(r + 1)
            if errs:
                raise AssertionError(f"manyparty: {errs}")
            round_ms.append(1e3 * (time.perf_counter() - t0))
        wire1 = wire_stats.snapshot()
        for t in threads:
            t.join(timeout=60)
        progress = [w.progress() for w in workers]
        finals = [{k: np.array(w.pull(k, timeout=240.0)) for k in keys}
                  for w in workers]
        return dict(
            finals=finals, progress=progress, round_ms=round_ms,
            rebalance=rebal, compress_ms=compress_ms, eligible=eligible,
            map_version=max(w.map_version for w in workers),
            socket_bytes=wire1["bytes_sent"] - wire0["bytes_sent"],
            round_pulls=round_pulls,
            chaos=None if chaos is None else chaos.record())
    finally:
        if chaos is not None:
            chaos.close()
        for w in workers:
            w.close()
        for s in servers:
            s.stop(forward=False)
        sc.close()
        sched.stop()


class _ShardLifecycle:
    """The owner of a sharded tier's processes for the chaos engine's
    ``kill@``/``restart@ ... node=shard<i>`` verbs (MANYPARTY_CHAOS):
    kill = ``crash()``; restart = a replacement on the same port
    replaying ``shard<i>``'s journal.  Records the outage and the
    records each restart replays."""

    def __init__(self, servers: list, parties: int, device, tier_dir):
        from geomx_tpu_torch.resilience.chaos import (
            ChaosEngine, ChaosSchedule, set_node_lifecycle_hook)
        from geomx_tpu_torch.service.shardmap import even_bounds
        self.servers, self.parties = servers, parties
        self.device, self.tier_dir = device, tier_dir
        self.bounds = even_bounds(len(servers))
        self.killed, self.kill_t = set(), {}
        self.outage_s, self.replayed, self.events = 0.0, {}, []
        self.schedule = ChaosSchedule.from_spec(MANYPARTY_CHAOS)
        set_node_lifecycle_hook(self.lifecycle)
        self.engine = ChaosEngine(self.schedule, controller=None)

    def lifecycle(self, action: str, node: str) -> None:
        from geomx_tpu_torch.resilience.chaos import shard_node_index
        from geomx_tpu_torch.resilience.durability import DurableStateStore
        from geomx_tpu_torch.service import GeoPSServer
        i = shard_node_index(node)
        now = time.perf_counter()
        self.events.append((action, node))
        if action == "kill":
            self.kill_t[node] = now
            self.servers[i].crash()
            self.killed.add(node)
            return
        # what the replacement replays: the snapshot and the journal
        # records after it, read before it starts
        store = DurableStateStore(self.tier_dir, f"shard{i}")
        snap, records = store.load()
        store.close()
        self.replayed[node] = len(records) + (snap is not None)
        self.servers[i] = GeoPSServer(
            num_workers=self.parties, mode="sync", accumulate=True, rank=i,
            shard_index=i, port=self.servers[i].port,
            shard_range=(self.bounds[i], self.bounds[i + 1]),
            shard_map_version=1, durable_dir=self.tier_dir,
            durable_name=f"shard{i}", device=self.device).start()
        self.killed.discard(node)
        self.outage_s += now - self.kill_t.pop(node, now)

    def record(self) -> dict:
        return dict(schedule=self.schedule.spec(), events=self.events,
                    outage_s=self.outage_s, replayed_records=self.replayed,
                    generations={f"shard{i}": s.generation
                                 for i, s in enumerate(self.servers)})

    def close(self) -> None:
        from geomx_tpu_torch.resilience.chaos import set_node_lifecycle_hook
        self.engine.close()
        set_node_lifecycle_hook(None)


_MANYPARTY_SHARD_CHILD = """
import sys
from geomx_tpu_torch.service.server import GeoPSServer
from geomx_tpu_torch.service.shardmap import even_bounds
total, idx = map(int, sys.argv[1:3])
b = even_bounds(total)
srv = GeoPSServer(num_workers=1, mode="async", accumulate=True, rank=idx,
                  shard_index=idx, shard_range=(b[idx], b[idx + 1]),
                  shard_map_version=1, device="cpu").start()
print("PORT", srv.port, flush=True)
srv.join()
"""


def manyparty_throughput() -> list:
    """bench.py:4581's merge throughput of the port's shards: each shard
    its own process (one interpreter would share one lock among them),
    the parent sends pre-encoded async PUSH frames from 4 threads
    through a window of 16 and counts the merged ACKs.  The shards run
    no device work (accumulate, no optimizer): device "cpu".  Best of
    two a shard count; not gated (the host's load moves it)."""
    import bisect
    import os
    import socket
    import threading

    import numpy as np

    from geomx_tpu_torch.service.protocol import (Msg, MsgType, recv_frame,
                                                  send_frame)
    from geomx_tpu_torch.service.shardmap import even_bounds, key_hash

    cfg = MANYPARTY_THROUGHPUT
    dim, ppk, nthreads = cfg["dim"], cfg["pushes_per_key"], cfg["threads"]
    keys = [f"t{i}" for i in range(cfg["nkeys"])]
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)

    def run_once(S):
        procs = [subprocess.Popen(
            [sys.executable, "-c", _MANYPARTY_SHARD_CHILD, str(S), str(i)],
            stdout=subprocess.PIPE, env=env, cwd=root, text=True)
            for i in range(S)]
        try:
            ports = []
            for p in procs:
                line = p.stdout.readline()
                if not line.startswith("PORT"):
                    raise AssertionError(f"shard child: {line!r}")
                ports.append(int(line.split()[1]))
            bounds = even_bounds(S)
            owner = {k: bisect.bisect_right(bounds, key_hash(k)) - 1
                     for k in keys}
            for k in keys:   # one INIT per key at its owner
                with socket.create_connection(("127.0.0.1",
                                               ports[owner[k]])) as s:
                    m = Msg(MsgType.INIT, key=k,
                            array=np.zeros(dim, np.float32))
                    m.meta["rid"] = 1
                    send_frame(s, m)
                    recv_frame(s)
            errs = []

            def blast(t):
                try:
                    conns, frames = {}, {}
                    for k in keys[t::nthreads]:
                        if owner[k] not in conns:
                            conns[owner[k]] = socket.create_connection(
                                ("127.0.0.1", ports[owner[k]]))
                        msg = Msg(MsgType.PUSH, key=k,
                                  array=np.full(dim, 1.0, np.float32))
                        msg.sender = t
                        msg.meta["rid"] = 7
                        frames[k] = msg.encode()
                    inflight = []
                    for _ in range(ppk):
                        for k in keys[t::nthreads]:
                            c, f = conns[owner[k]], frames[k]
                            c.sendall(len(f).to_bytes(4, "little") + f)
                            inflight.append(c)
                            if len(inflight) >= 16:
                                recv_frame(inflight.pop(0))
                    for c in inflight:
                        recv_frame(c)
                    for c in conns.values():
                        c.close()
                except Exception as e:  # surfaced below
                    errs.append(repr(e))

            ths = [threading.Thread(target=blast, args=(t,), daemon=True)
                   for t in range(nthreads)]
            t0 = time.monotonic()
            for t in ths:
                t.start()
            for t in ths:
                t.join(timeout=600.0)
            wall = time.monotonic() - t0
            if errs or any(t.is_alive() for t in ths):
                raise AssertionError(f"throughput blast failed: {errs}")
            return wall
        finally:
            for p in procs:
                p.kill()
                p.wait(timeout=10)

    out = []
    for S in cfg["shard_counts"]:
        walls = [run_once(S) for _ in range(cfg["repeats"])]
        out.append(dict(shards=S, wall_s=walls,
                        pushes_per_s=ppk * len(keys) / min(walls)))
    return out


def manyparty_phase(torch, device=None) -> dict:
    """Phase manyparty_sharded: the port's sharded global tier at the JAX
    acceptance's cluster size (MANYPARTY), ResNet-20's 65 leaves at full
    width as the keys, Adam(0.01) on the shards through the factory on
    the card, 6 rounds, a rebalance with round 3 open.  Gates: every
    key's progress 6 at every party; the map bumped and keys moved;
    every party's final pulls bit-equal to each other and to a twin run
    of the same traffic against one shard whose parties compress on the
    CPU (the plain versions; the sorted-sender merge promises the same
    bits at any shard count); bsc_select_pack launched exactly (19
    leaves) x 16 parties x 6 rounds times.  Then the chaos run
    (MANYPARTY_CHAOS, no rebalance): every process journals under a
    temporary root, shard 1 is killed before round 3 and restarted on its
    journal; after MANYPARTY_CHAOS_ROUNDS rounds its final pulls must be
    bit-equal to the same twin's pulls after as many rounds."""
    import numpy as np

    from geomx_tpu_torch import ops

    dev = torch.device(device or "cuda")
    cpu = torch.device("cpu")
    P, rounds, S = (MANYPARTY["parties"], MANYPARTY["rounds"],
                    MANYPARTY["shards"])
    init = resnet20_leaves(torch)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    card = _manyparty_tier(torch, init, S, dev, dev, rebalance=True)
    wall = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = ops.launch_counts()
    twin = _manyparty_tier(torch, init, 1, dev, cpu, rebalance=False)
    with tempfile.TemporaryDirectory() as root:
        t1 = time.perf_counter()
        chaos_run = _manyparty_tier(torch, init, S, dev, dev,
                                    rebalance=False, durable_root=root,
                                    rounds=MANYPARTY_CHAOS_ROUNDS)
        chaos_wall = time.perf_counter() - t1
    eligible = card["eligible"]
    want = len(eligible) * P * rounds
    if dev.type == "cuda" and launches["bsc_select_pack"] != want:
        raise AssertionError(
            f"manyparty: bsc_select_pack launched "
            f"{launches['bsc_select_pack']} times, want {want} "
            f"({len(eligible)} leaves x {P} parties x {rounds} rounds)")
    for p, prog in enumerate(card["progress"]):
        if any(prog.get(k, 0) != rounds for k in init):
            raise AssertionError(f"manyparty: party {p} progress {prog}")
    reb = card["rebalance"]
    if not reb.get("changed") or reb.get("moved_keys", 0) <= 0 \
            or card["map_version"] < 2:
        raise AssertionError(f"manyparty: the rebalance moved nothing "
                             f"(map v{card['map_version']}, {reb})")
    ref = card["finals"][0]
    for p in range(P):
        for k in init:
            if card["finals"][p][k].tobytes() != ref[k].tobytes():
                raise AssertionError(f"manyparty: party {p}'s {k} differs "
                                     "from party 0's")
            if twin["finals"][p][k].tobytes() != ref[k].tobytes():
                raise AssertionError(f"manyparty: party {p}'s {k} differs "
                                     "from the one-shard CPU-compress twin")
            if chaos_run["finals"][p][k].tobytes() != twin["round_pulls"][
                    MANYPARTY_CHAOS_ROUNDS - 1][k].tobytes():
                raise AssertionError(f"manyparty chaos: party {p}'s {k} "
                                     "differs from the no-kill twin's "
                                     f"after {MANYPARTY_CHAOS_ROUNDS} "
                                     "rounds")
    ch = chaos_run["chaos"]
    if ch["events"] != [("kill", "shard1"), ("restart", "shard1")] or \
            ch["generations"]["shard1"] != 2 or \
            any(prog.get(k, 0) != MANYPARTY_CHAOS_ROUNDS
                for prog in chaos_run["progress"] for k in init):
        raise AssertionError(f"manyparty chaos: {ch}, progress "
                             f"{chaos_run['progress'][0]}")
    if not all(np.isfinite(v).all() for v in ref.values()):
        raise AssertionError("manyparty: non-finite parameters")
    res = dict(
        parties=P, shards=S, rounds=rounds, keys=len(init),
        bsc_keys=len(eligible), params=int(sum(v.size for v in
                                               init.values())),
        wall_s=wall, round_ms=card["round_ms"],
        round_ms_median=statistics.median(card["round_ms"]),
        twin_round_ms_median=statistics.median(twin["round_ms"]),
        rebalance_wall_ms=reb["wall_ms"], moved_keys=reb["moved_keys"],
        segments=reb["segments"], map_version=card["map_version"],
        socket_bytes_per_round=card["socket_bytes"] / rounds,
        socket_bytes_per_shard_round=card["socket_bytes"] / rounds / S,
        compress_ms_per_key_card=statistics.median(card["compress_ms"]),
        compress_ms_per_key_cpu=statistics.median(twin["compress_ms"]),
        launches=launches,
        chaos=dict(ch, wall_s=chaos_wall, round_ms=chaos_run["round_ms"]))
    log(f"phase manyparty_sharded: {P} parties x {S} shards, "
        f"{len(init)} ResNet-20 leaves ({res['params']} parameters, "
        f"{len(eligible)} pushed as BSC pairs), Adam(0.01) on the shards, "
        f"{rounds} rounds; rebalance with round "
        f"{MANYPARTY['rebalance_round'] + 1} open: {reb['moved_keys']} keys "
        f"moved in {reb['segments']} segments, map v{card['map_version']}, "
        f"{reb['wall_ms']:.1f} ms; progress {rounds} on every key; final "
        f"pulls bit-equal across parties and to the one-shard CPU-compress "
        f"twin; bsc_select_pack {launches['bsc_select_pack']} launches; "
        f"round {res['round_ms_median']:.1f} ms (median; twin "
        f"{res['twin_round_ms_median']:.1f}); socket bytes a round "
        f"{res['socket_bytes_per_round']:.0f} "
        f"({res['socket_bytes_per_shard_round']:.0f} a shard, mean); "
        f"compress {res['compress_ms_per_key_card']:.3f} ms a key on the "
        f"card vs {res['compress_ms_per_key_cpu']:.3f} ms on the CPU")
    log(f"  chaos run {ch['schedule']} (durable, no rebalance): outage "
        f"{ch['outage_s'] * 1e3:.1f} ms, shard1 replayed "
        f"{ch['replayed_records']['shard1']} records at generation "
        f"{ch['generations']['shard1']}; rounds "
        f"{[round(x, 1) for x in chaos_run['round_ms']]} ms; "
        f"{chaos_wall:.1f} s; final pulls bit-equal to the no-kill twin's "
        f"after {MANYPARTY_CHAOS_ROUNDS} rounds")
    res["throughput"] = manyparty_throughput()
    log("  merge throughput (8 keys of 65,536, a process a shard, not "
        "gated): " + ", ".join(
            f"{r['shards']} shards {r['pushes_per_s']:.1f} pushes/s"
            for r in res["throughput"]))
    return res


_DURABLE_SERVER_CHILD = """
import sys
from geomx_tpu_torch.service import GeoPSServer
srv = GeoPSServer(num_workers=2, mode="sync", accumulate=True,
                  port=int(sys.argv[1]), durable_dir=sys.argv[2],
                  durable_name="g", device="cpu").start()
print("READY", srv.generation, flush=True)
srv.join()
"""


def _spawn_durable_server(port: int, durable_dir: str):
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, "-c", _DURABLE_SERVER_CHILD, str(port),
         durable_dir], cwd=root, stdout=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=root))
    line = proc.stdout.readline().split()
    if not line or line[0] != "READY":
        proc.kill()
        raise AssertionError(f"durable server child failed: {line}")
    return proc, int(line[1])


def durable_recovery_phase(torch) -> dict:
    """Phase durable_recovery (the host plane alone, no kernel): (a) a
    durable GeoPSServer in its own process takes two workers' pushes of
    ResNet-20's 65 leaves; round 2 is open (worker 0's pushes merged in
    memory only) when the process is SIGKILLed; a new process on the same
    directory and port replays the journal, worker 0's session resume
    re-pushes its retained round, worker 1 pushes, and every pull is the
    exact sum of the four pushes (no loss, no double merge), bit for bit;
    (b) a durable GeoScheduler with 2 parties x 2 workers registered is
    crashed and restarted inside its grace window: every node gets its
    old id back, the roster epoch goes on counting, and the dead list
    stays empty."""
    import signal
    import socket

    import numpy as np

    from geomx_tpu_torch.resilience.durability import DurableStateStore
    from geomx_tpu_torch.service import (GeoPSClient, GeoScheduler,
                                         SchedulerClient)

    init = resnet20_leaves(torch)
    rng = np.random.default_rng(4242)
    pushes = [[{k: rng.standard_normal(v.shape, dtype=np.float32)
                for k, v in init.items()} for _ in range(2)]
              for _ in range(2)]  # [round][worker]
    want = {k: (init[k] + (pushes[0][0][k] + pushes[0][1][k]))
            + (pushes[1][0][k] + pushes[1][1][k]) for k in init}
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    res = {}
    with tempfile.TemporaryDirectory() as root:
        proc, gen1 = _spawn_durable_server(port, root)
        proc2 = None
        cs = []
        try:
            cs = [GeoPSClient(("127.0.0.1", port), sender_id=i,
                              reconnect=True) for i in range(2)]
            for c in cs:
                for k, v in init.items():
                    c.init(k, v)
            t0 = time.perf_counter()
            for i, c in enumerate(cs):
                for k in init:
                    c.push(k, pushes[0][i][k])
            for k in init:
                cs[0].pull(k, timeout=60.0)
            round_ms = 1e3 * (time.perf_counter() - t0)
            for k in init:   # round 2 open: ACKed, merged in memory only
                cs[0].push(k, pushes[1][0][k])
            t_kill = time.perf_counter()
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=30)
            store = DurableStateStore(root, "g")
            snap, records = store.load()
            store.close()
            proc2, gen2 = _spawn_durable_server(port, root)
            t_up = time.perf_counter()
            for k in init:
                cs[1].push(k, pushes[1][1][k])
            got = [{k: np.asarray(c.pull(k, timeout=120.0)) for k in init}
                   for c in cs]
            t_done = time.perf_counter()
            for g in got:
                for k in init:
                    if g[k].tobytes() != want[k].tobytes():
                        raise AssertionError(
                            f"durable_recovery: {k} after the restart "
                            "is not the exact sum of the four pushes")
            if (gen1, gen2) != (1, 2):
                raise AssertionError(f"durable_recovery: generations "
                                     f"{gen1}, {gen2}")
            res.update(keys=len(init), params=int(sum(
                v.size for v in init.values())), round_ms=round_ms,
                restart_s=t_up - t_kill, resume_s=t_done - t_up,
                outage_s=t_done - t_kill,
                replayed_records=len(records) + (snap is not None),
                generations=[gen1, gen2])
            cs[0].stop_server()
        finally:
            for c in cs:
                c.close()
            for p in (proc, proc2):
                if p is not None and p.poll() is None:
                    p.kill()
                    p.wait(timeout=30)
    with tempfile.TemporaryDirectory() as root:
        sched = GeoScheduler(durable_dir=root, heartbeat_timeout=0.5).start()
        port = sched.port
        tags = [f"{p}.{w}" for p in range(2) for w in range(2)]
        clients = [SchedulerClient(("127.0.0.1", port)) for _ in tags]
        try:
            for c, tag in zip(clients, tags):
                c.register("worker", tag=tag)
                c.heartbeat()
            ids = [c.node_id for c in clients]
            epoch0 = max(c.roster_epoch for c in clients)
            sched.crash()
            t0 = time.perf_counter()
            sched = GeoScheduler(durable_dir=root, port=port,
                                 heartbeat_timeout=0.5,
                                 restart_grace_s=30.0).start()
            again = [SchedulerClient(("127.0.0.1", port)) for _ in tags]
            clients += again
            metas = [c.register("worker", tag=tag)
                     for c, tag in zip(again, tags)]
            rejoin_ms = 1e3 * (time.perf_counter() - t0)
            if [c.node_id for c in again] != ids or \
                    not all(m["is_recovery"] for m in metas):
                raise AssertionError(f"durable_recovery: ids {ids} -> "
                                     f"{[c.node_id for c in again]}")
            health = sched.health_snapshot()
            if not (health["restart_grace"] and health["generation"] == 2
                    and again[0].dead_nodes() == []
                    and again[-1].roster_epoch > epoch0):
                raise AssertionError(f"durable_recovery: scheduler after "
                                     f"its restart {health}")
            res["scheduler"] = dict(nodes=len(tags), ids=ids,
                                    epoch_before=epoch0,
                                    epoch_after=again[-1].roster_epoch,
                                    rejoin_ms=rejoin_ms, generation=2)
        finally:
            for c in clients:
                c.close()
            sched.stop()
    log(f"phase durable_recovery: a durable server process with "
        f"{res['keys']} ResNet-20 leaves ({res['params']} parameters) x 2 "
        f"workers, SIGKILLed with round 2 open; the new process replayed "
        f"{res['replayed_records']} records (generation "
        f"{res['generations'][0]} -> {res['generations'][1]}) and was up "
        f"{res['restart_s']:.2f} s after the kill; session resume closed "
        f"round 2 {res['resume_s']:.2f} s later, every pull the exact sum "
        f"of the four pushes (round 1 took {res['round_ms']:.1f} ms); the "
        f"scheduler restarted inside its grace window: {len(tags)} nodes "
        f"got their ids {ids} back in {res['scheduler']['rejoin_ms']:.1f} "
        f"ms, epoch {epoch0} -> {res['scheduler']['epoch_after']}, no "
        f"node read as dead")
    return res


def _kv_rounds(store, init: dict, pushes):
    """Push then pull every key for each round's ``{key: [P, W, ...]}``;
    every round's pulls as numpy, and the push-and-pull ms a round."""
    pulls, ms = [], []
    for push in pushes:
        t0 = time.perf_counter()
        for k in init:
            store.push(k, push[k])
        out = {k: store.pull(k) for k in init}
        store.barrier()
        ms.append(1e3 * (time.perf_counter() - t0))
        pulls.append({k: v.cpu().numpy() for k, v in out.items()})
    return pulls, ms


def kvstore_phase(torch, device=None) -> dict:
    """Phase kvstore_hips: the port's KVStore, create("hips",
    HiPSTopology(2, 4)) on the card over ResNet-20's 65 leaves.
    (a) "bsc" 0.01 aggregation, 8 rounds of seeded [2, 4, ...] pushes:
    every round's pulls bit-equal to a CPU twin store fed the same
    pushes, bsc_select_pack and bsc_scatter_add each launched exactly
    19 x 2 parties x 8 rounds times; (b) the same under "2bit" 0.5, 4
    rounds: bit-equal, quantize_2bit and dequantize_2bit launched;
    (c) an imperative loop, a fresh "bsc" store with
    sgd(0.1, momentum=0.9): 8 rounds of 8 replicas' ResNet-20
    forward/backward on the card at the pulled weights (synthetic CIFAR
    batches of 32), the stacked gradients pushed: finite losses; (d) one
    push_row_sparse with lazy adam(0.01) on a [256, 64] key: untouched
    rows bit-unchanged, touched rows within KVSTORE_RS_RTOL/ATOL of the
    CPU twin."""
    import numpy as np

    from geomx_tpu_torch import ops
    from geomx_tpu_torch.models import get_model
    from geomx_tpu_torch.optim import adam, sgd
    from geomx_tpu_torch.store import create
    from geomx_tpu_torch.topology import HiPSTopology

    dev = torch.device(device or "cuda")
    on_card = dev.type == "cuda"
    P, W = KVSTORE["topology"]
    topo = HiPSTopology(P, W)
    init = resnet20_leaves(torch)
    res = {}

    def hop(params, rounds, seed):
        rng = np.random.default_rng(seed)
        pushes = [{k: rng.standard_normal((P, W) + v.shape,
                                          dtype=np.float32)
                   for k, v in init.items()} for _ in range(rounds)]
        out = {}
        for name, d in (("card", dev), ("twin", torch.device("cpu"))):
            kv = create("hips", topo, device=d)
            for k, v in init.items():
                kv.init(k, v)
            kv.set_gradient_compression(params)
            if d == dev and on_card:
                torch.cuda.synchronize()
            if d == dev:
                ops.reset_launch_counts()
            out[name] = _kv_rounds(kv, init, pushes)
            if d == dev:
                if on_card:
                    torch.cuda.synchronize()
                out["launches"] = ops.launch_counts()
        for r, (a, b) in enumerate(zip(out["card"][0], out["twin"][0])):
            for k in init:
                if a[k].tobytes() != b[k].tobytes():
                    raise AssertionError(
                        f"kvstore {params['type']}: round {r}: {k} differs "
                        "from the CPU twin store")
        return out

    comp_keys = [k for k, v in init.items() if v.size >= 1024]
    rounds = KVSTORE["bsc_rounds"]
    bsc = hop({"type": "bsc", "threshold": 0.01}, rounds, 11)
    want = len(comp_keys) * P * rounds
    for name in ("bsc_select_pack", "bsc_scatter_add"):
        if on_card and bsc["launches"][name] != want:
            raise AssertionError(f"kvstore bsc: {name} launched "
                                 f"{bsc['launches'][name]} times, want "
                                 f"{want}")
    res["bsc"] = dict(rounds=rounds, launches=bsc["launches"],
                      round_ms_median=statistics.median(bsc["card"][1]),
                      twin_round_ms_median=statistics.median(bsc["twin"][1]))
    rounds = KVSTORE["twobit_rounds"]
    two = hop({"type": "2bit", "threshold": 0.5}, rounds, 12)
    if on_card and not (two["launches"]["quantize_2bit"] > 0 and
                        two["launches"]["dequantize_2bit"] > 0):
        raise AssertionError(f"kvstore 2bit: launches {two['launches']}")
    res["twobit"] = dict(rounds=rounds, launches=two["launches"],
                         round_ms_median=statistics.median(two["card"][1]),
                         twin_round_ms_median=statistics.median(
                             two["twin"][1]))

    # (c) the imperative training loop
    kv = create("hips", topo, device=dev)
    for k, v in init.items():
        kv.init(k, v)
    kv.set_gradient_compression({"type": "bsc", "threshold": 0.01})
    kv.set_optimizer(sgd(0.1, momentum=0.9))
    model = get_model("resnet20").to(dev)
    model.train()
    gen = torch.Generator(device=dev).manual_seed(5)
    losses, step_ms = [], []
    for _ in range(KVSTORE["train_rounds"]):
        t0 = time.perf_counter()
        with torch.no_grad():
            for k in init:
                model.get_parameter(k).copy_(kv.pull(k))
        grads = {k: [] for k in init}
        for _rep in range(P * W):
            x = torch.randn((KVSTORE["batch"], 32, 32, 3), generator=gen,
                            device=dev)
            y = torch.randint(0, 10, (KVSTORE["batch"],), generator=gen,
                              device=dev)
            model.zero_grad(set_to_none=True)
            loss = torch.nn.functional.cross_entropy(model(x, train=True), y)
            loss.backward()
            losses.append(float(loss.detach()))
            for k in init:
                grads[k].append(model.get_parameter(k).grad.detach().float())
        for k in init:
            kv.push(k, torch.stack(grads[k]).reshape(
                (P, W) + tuple(init[k].shape)))
        kv.barrier()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"kvstore training loop: losses {losses}")
    res["train"] = dict(rounds=len(step_ms), loss_first=losses[0],
                        loss_last=losses[-1],
                        round_ms_median=statistics.median(step_ms))

    # (d) one lazy row-sparse Adam push
    shape, n_rows = KVSTORE["rs_shape"], KVSTORE["rs_rows"]
    rng = np.random.default_rng(13)
    base = rng.standard_normal(shape, dtype=np.float32)
    rows = [rng.choice(shape[0], n_rows, replace=False) for _ in range(2)]
    vals = [rng.standard_normal((n_rows, shape[1]), dtype=np.float32)
            for _ in range(2)]
    outs = {}
    for name, d in (("card", dev), ("twin", torch.device("cpu"))):
        kv = create("local", device=d)
        kv.init("emb", base)
        kv.set_optimizer(adam(0.01))
        kv.push_row_sparse("emb", rows, vals)
        outs[name] = kv.pull("emb").cpu().numpy()
    touched = np.zeros(shape[0], bool)
    touched[np.concatenate(rows)] = True
    if outs["card"][~touched].tobytes() != base[~touched].tobytes():
        raise AssertionError("kvstore row-sparse: an untouched row moved")
    if not np.allclose(outs["card"][touched], outs["twin"][touched],
                       rtol=KVSTORE_RS_RTOL, atol=KVSTORE_RS_ATOL):
        raise AssertionError("kvstore row-sparse: touched rows differ from "
                             "the CPU twin")
    res["row_sparse"] = dict(
        touched_rows=int(touched.sum()),
        max_abs_err=float(np.abs(outs["card"] - outs["twin"]).max()),
        moved=bool((outs["card"][touched] != base[touched]).any()))
    log(f"phase kvstore_hips: [{P}, {W}] over {len(init)} ResNet-20 leaves; "
        f"(a) bsc 0.01, {res['bsc']['rounds']} rounds bit-equal to the CPU "
        f"twin, select/pack {bsc['launches']['bsc_select_pack']} and "
        f"scatter-add {bsc['launches']['bsc_scatter_add']} launches, "
        f"{res['bsc']['round_ms_median']:.1f} ms a round (twin "
        f"{res['bsc']['twin_round_ms_median']:.1f}); (b) 2bit 0.5, "
        f"{res['twobit']['rounds']} rounds bit-equal, quantize "
        f"{two['launches']['quantize_2bit']} and dequantize "
        f"{two['launches']['dequantize_2bit']} launches, "
        f"{res['twobit']['round_ms_median']:.1f} ms a round (twin "
        f"{res['twobit']['twin_round_ms_median']:.1f}); (c) the training "
        f"loop: loss {res['train']['loss_first']:.4f} -> "
        f"{res['train']['loss_last']:.4f}, "
        f"{res['train']['round_ms_median']:.1f} ms a round; (d) row-sparse "
        f"Adam on {res['row_sparse']['touched_rows']} rows: untouched rows "
        f"bit-unchanged, max abs err {res['row_sparse']['max_abs_err']:.3g} "
        f"against the twin")
    return res


# the kernels each long-context mode reaches: on the training step, and
# in the epoch-end evaluation (the un-meshed twin's forward)
LONG_CONTEXT_KERNELS = {
    "ring": ("fused_block", "fused_flatten", "fused_unflatten",
             "flash_attention_fwd"),
    "ulysses": ("flash_attention_fwd", "flash_attention_dq",
                "flash_attention_dkv", "fused_flatten", "fused_unflatten"),
}
# tests/test_long_context.py:110's bar for the example's last accuracy
LONG_CONTEXT_MIN_ACC = 0.5


# the variables examples/long_context.py reads (its defaults when unset)
LONG_CONTEXT_ENV = ("GEOMX_SP_MODE", "GEOMX_NUM_PARTIES",
                    "GEOMX_WORKERS_PER_PARTY", "GEOMX_SP_DEGREE",
                    "GEOMX_SEQ_LEN", "GEOMX_EPOCHS")


def long_context_phase(torch, mode: str, device=None, env=None) -> dict:
    """Phases long_context_ring and long_context_ulysses: the port's
    examples/long_context.py main(mode) at its defaults (2 x 2 replicas
    x sp 2, L 256, 16 sequences a replica, 6 epochs of 64 steps: the
    example's variables unset for the run, or set to ``env``), the
    launch counts reset just before and read just after.  Gates: the
    last test accuracy above LONG_CONTEXT_MIN_ACC, every kernel of
    LONG_CONTEXT_KERNELS[mode] launched."""
    import json as _json
    import os

    from geomx_tpu_torch import ops
    from geomx_tpu_torch.examples import long_context

    on_card = device is None or torch.device(device).type == "cuda"
    env = dict(env or {})
    saved = {k: os.environ.pop(k, None) for k in LONG_CONTEXT_ENV}
    os.environ.update(env)
    records = []

    def collect(line):
        print(f"[long-context] {line}", flush=True)
        records.append(_json.loads(line))

    try:
        if on_card:
            torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        acc = long_context.main(mode, device=device, log_fn=collect)
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    missing = [k for k in LONG_CONTEXT_KERNELS[mode] if launches[k] < 1]
    if on_card and missing:
        raise AssertionError(f"long_context {mode}: {missing} not launched "
                             f"({launches})")
    if not acc > LONG_CONTEXT_MIN_ACC:
        raise AssertionError(f"long_context {mode}: test_acc {acc}")
    P = int(env.get("GEOMX_NUM_PARTIES", "2"))
    W = int(env.get("GEOMX_WORKERS_PER_PARTY", "2"))
    steps = records[-1]["iteration"]
    per_epoch = records[0]["iteration"]
    # the first epoch pays the first allocations: step time from the
    # later epochs' records (each includes its epoch-end evaluation)
    span = records[-1]["time"] - records[0]["time"]
    step_ms = 1e3 * span / (steps - per_epoch)
    res = dict(mode=mode, steps=steps, epochs=len(records),
               sequences_per_step=16 * P * W, test_acc=acc,
               test_accs=[r["test_acc"] for r in records], wall_s=wall,
               step_ms=step_ms,
               sequences_per_s=16 * P * W * 1e3 / step_ms,
               launches=launches)
    log(f"phase long_context_{mode}: examples/long_context.py main("
        f"{mode!r}), {steps} steps of {16 * P * W} sequences, test_acc "
        f"{acc:.3f} ({res['test_accs']}), step {step_ms:.2f} ms "
        f"(epochs 2-{len(records)}, evaluations included), "
        f"{res['sequences_per_s']:.1f} sequences/s, wall {wall:.1f} s, "
        f"launches { {k: launches[k] for k in LONG_CONTEXT_KERNELS[mode]} }")
    return res


# ---- the control plane and FleetScope (control/, telemetry/fleetscope.py)

# control_fsa: path 1 with the control plane on, the decisions applied
# after this many steps; path 1's "bsc,0.01" is the capacity, so the ratios
# are the scales 0.5, 0.125 and 1
CONTROL_STEPS = 16
CONTROL_SCRIPT = ((4, "ratio", 0.005), (8, "ratio", 0.00125),
                  (10, "depth", 1), (13, "depth", 0), (14, "ratio", 0.01))
# the emitted share's distance from the scale reported (not gated: the
# sampled boundary's Weyl probe under-samples ResNet-20's largest
# coordinates, so the route emits more than eff_k pairs, PERF.md)
CONTROL_EMITTED_TOL = 0.05
# bench.py --compare-control at its defaults (bench.py:2827-3093): the MLP
# on 3 parties x 1 worker, 48 a step, 60 steps of sgd(0.012), "bsc" at
# 0.25 and 0.25 / 8, 1 MiB buckets, party 1's uplink throttled 8x with
# 300 ms more latency for steps 2-39, the modelled WAN's compute 0.05 s a
# step and base latency 0.01 s
CONTROL_REPLAY = dict(
    parties=3, batch=48, steps=60, lr=0.012, ratio_hi=0.25,
    bucket_bytes=1 << 20, compute_s=0.05, base_delay_s=0.01,
    schedule="seed=77;throttle@2:party=1,factor=0.125,steps=38;"
             "delay@2:party=1,ms=300,steps=38")
# fleetscope_sched: the aggregator's poll interval, and the burn series'
# seed (bench.py --compare-fleetscope's)
FLEETSCOPE_INTERVAL_S = 0.5
FLEETSCOPE_BURN_SEED = 1234


class WanModel:
    """Deterministic WAN time model of the control replay (a copy of
    bench.py's ``_WanModel`` over the port's link-shaping hook).

    Link quality is a pure function of the active chaos shaping
    overrides (``service.protocol.get_link_shaping``), so the seeded
    schedule fully determines the bandwidth/delay timeline.  Routing:
    ``routes == ()`` is direct fan-in; a relay order's head is the merge
    sink — the other parties cross the fast intra-overlay link to it,
    and it forwards one merged payload up its own uplink.  The bytes a
    party sends are the run's own telemetry (the capacity times the
    measured emitted share)."""

    def __init__(self, num_parties: int, base_bps: float, p2p_bps: float,
                 base_delay_s: float, compute_s: float):
        self.P = int(num_parties)
        self.base_bps = float(base_bps)
        self.p2p_bps = float(p2p_bps)
        self.base_delay_s = float(base_delay_s)
        self.compute_s = float(compute_s)

    def _bw(self, party: int) -> float:
        from geomx_tpu_torch.service.protocol import get_link_shaping
        return self.base_bps * get_link_shaping(party).get("factor", 1.0)

    def _delay(self, party: int) -> float:
        from geomx_tpu_torch.service.protocol import get_link_shaping
        return self.base_delay_s + \
            get_link_shaping(party).get("delay_ms", 0.0) / 1e3

    def uplink_seconds(self, party: int, nbytes: float) -> float:
        return self._delay(party) + nbytes / self._bw(party)

    def round_seconds(self, nbytes: float, routes: tuple) -> float:
        """One synchronous WAN round: the gate waits for the slowest
        path to the global tier."""
        if not routes:
            return max(self.uplink_seconds(p, nbytes)
                       for p in range(self.P))
        sink = int(routes[0])
        hop = max((nbytes / self.p2p_bps
                   for p in range(self.P) if p != sink), default=0.0)
        return hop + self.uplink_seconds(sink, nbytes)

    def step_seconds(self, nbytes: float, depth: int, routes: tuple) -> dict:
        wan = self.round_seconds(nbytes, routes)
        hidden = min(wan, self.compute_s) if depth else 0.0
        exposed = wan - hidden
        return {"total": self.compute_s + exposed, "wan": wan,
                "exposed": exposed, "hidden": hidden}

    def feed_observatory(self, obs, nbytes: float, t: float) -> None:
        """Every party's direct uplink gets a payload-sized observation
        a step."""
        for p in range(self.P):
            obs.observe(f"party{p}", "global", nbytes=nbytes,
                        seconds=self.uplink_seconds(p, nbytes), t=t)

    def publish_phases(self, rec: dict) -> None:
        from geomx_tpu_torch.telemetry.attribution import publish_attribution
        total = rec["total"] or 1.0
        publish_attribution({
            "compute": (self.compute_s - rec["hidden"]) / total,
            "hidden_comms": rec["hidden"] / total,
            "exposed_comms": rec["exposed"] / total,
            "host_stall": 0.0})


def control_make_data(n: int = 1536, seed: int = 0):
    """The control replay's learnable synthetic classification set
    (class-prototype images plus noise, bench.py's generator): numpy
    uint8 ``[n, 32, 32, 3]`` and int labels."""
    import numpy as np
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 10, size=n).astype(np.int32)
    protos = rng.rand(10, 32, 32, 3) * 70
    x = protos[y] + rng.rand(n, 32, 32, 3) * 185
    return np.clip(x, 0, 255).astype(np.uint8), y


def fleetscope_burn_series(seed: int, windows: str = "20:4,60:2"):
    """One deterministic burn-monitor run over a seeded latency-inflation
    window (virtual time: t is the tick index; bench.py's
    ``_fleetscope_burn_series`` over the port's monitor): the breach
    list as canonical JSON, and its length."""
    import numpy as np

    from geomx_tpu_torch.telemetry.fleetscope import BurnRateMonitor

    rng = np.random.default_rng(seed)
    mon = BurnRateMonitor(windows=windows, slo_target=0.99)
    breaches = []
    for i in range(140):
        t = float(i)
        good, bad = 50.0, 0.0
        if 60 <= i < 95:
            infl = 1.0 + float(rng.random())
            bad = round(25.0 * infl, 6)
            good = round(max(0.0, 50.0 - bad), 6)
        mon.record(t, good, bad)
        b = mon.evaluate(t)
        if b is not None:
            breaches.append(b)
    return json.dumps(breaches, sort_keys=True), len(breaches)


def _run_step(torch, trainer, state, batch, profile: bool):
    """One ``trainer.train_step``; with ``profile`` inside a profiler
    window, also returning its launch calls (``_cuda_launches``)."""
    if not profile:
        return trainer.train_step(state, *batch), None
    out = {}
    calls, _ = _cuda_launches(
        torch, lambda: out.update(r=trainer.train_step(state, *batch)))
    return out["r"], calls


def _first_difference(a: list, b: list) -> str:
    at = next((i for i, (u, v) in enumerate(zip(a, b)) if u != v),
              min(len(a), len(b)))
    return (f"{len(a)} vs {len(b)} launch calls, first difference at "
            f"{at}: {a[at:at + 3]} vs {b[at:at + 3]}")


def control_reference(torch) -> dict:
    """Gate (e) of control_fsa: two fp32 steps at scale 0.5 (ratio 0.005
    under "bsc,0.01") on the card and on the CPU, the small ResNet of
    the reference phase: losses to rtol 1e-4, every replica's
    parameters to atol 2e-3."""
    from geomx_tpu_torch.control import Decision
    from geomx_tpu_torch.data import load_dataset
    from geomx_tpu_torch.models import ResNet

    data = load_dataset("synthetic", synthetic_train_n=512)
    x, y = data["train_x"][:, :16, :16], data["train_y"]
    runs = {}
    for device in ("cuda", "cpu"):
        t = make_trainer("flagship", ResNet((1, 1, 1), (8, 16, 32),
                                            dtype=torch.float32),
                         device=device, precision="fp32", control=True)
        st = t.init_state(seed=0, sample_input=x[:2])
        st = t.apply_control(st, Decision(step=0, kind="ratio", value=0.005,
                                          prev=0.01, reason="scripted"))
        losses = []
        for i, (xb, yb) in enumerate(t.make_loader(x, y, 8).epoch(0)):
            if i == 2:
                break
            st, m = t.train_step(st, xb, yb)
            losses.append(float(m["loss"]))
        runs[device] = (losses, {k: v.cpu() for k, v in st.params.items()})
    (gl, gp), (cl, cp) = runs["cuda"], runs["cpu"]
    for a, b in zip(gl, cl):
        if not math.isfinite(a) or abs(a - b) > 1e-4 * abs(b):
            raise AssertionError(f"control_fsa: card losses {gl} vs CPU "
                                 f"{cl} at scale 0.5")
    worst = max((gp[k] - cp[k]).abs().max().item() for k in cp)
    if worst > 2e-3:
        raise AssertionError(f"control_fsa: card and CPU params differ by "
                             f"{worst} at scale 0.5")
    return dict(card_losses=gl, cpu_losses=cl, max_param_diff=worst)


def control_fsa_phase(torch, device=None, batch: int = 128,
                      steps: int = CONTROL_STEPS) -> dict:
    """Phase control_fsa: path 1 (ResNet-20 at full width on [2, 4], 128
    a replica, sgd(0.1, momentum=0.9) per leaf, "bsc,0.01", kernels 1-4)
    with GEOMX_CONTROL=1 and telemetry on, 16 steps under CONTROL_SCRIPT
    through a ControlActuator.  Gates: (a) a control-off step makes the
    launch calls of a build whose control_operands raises; (b) the step
    after each ratio actuation makes the launch calls of the step before
    it (no device-to-host copy added) and _control_cache is unchanged;
    (c) bsc_emitted_fraction's mean over the steps at a scale falls with
    the scale, and at the second step after each ratio actuation kernel
    3's pairs equal the plain selection's on the CPU from the same inputs
    at the same eff_k boundary, the probe equal to the share recomputed
    from them (the mean's distance from the scale is printed); (d) the 0->1
    switch carries the dc-tier EF buffers bit for bit (copy (0, 0) into
    every slot, as the JAX package's swap), and the 1->0 switch's drain
    moves the params by exactly one apply of the parked aggregate; (e)
    control_reference on the card; (f) finite losses, identical
    replicas, kernels 1-4 launched in every step.  Prints the median
    step ms with control on and off and the launch calls a step."""
    from geomx_tpu_torch import ops
    from geomx_tpu_torch.control import (ControlActuator, Decision,
                                         reset_decision_log)
    from geomx_tpu_torch.control import actuators as ctl_mod
    from geomx_tpu_torch.data import load_dataset
    from geomx_tpu_torch.models import get_model
    from geomx_tpu_torch.telemetry import reset_registry
    from geomx_tpu_torch.telemetry.probes import host_probes
    from geomx_tpu_torch.tree import leaf_names

    t_phase = time.perf_counter()
    reset_registry()
    data = load_dataset("synthetic", synthetic_train_n=8 * batch * steps)

    def build(**fields):
        return make_trainer("flagship", get_model("resnet20"),
                            device=device, **fields)

    off = build()
    on_card = off.device.type == "cuda"
    loader = off.make_loader(data["train_x"], data["train_y"], batch)
    batches = [(x.clone(), y.clone()) for x, y in loader.epoch(0)][:steps]

    # (a) the disabled path against a build whose control hook raises
    def one_step(t):
        st = t.init_state(seed=0)
        return lambda: t.train_step(st, *batches[0])

    one_step(off)()                       # warm-up (cuDNN, allocator)
    calls_off, _ = _cuda_launches(torch, one_step(off))

    def poison(*a, **k):
        raise AssertionError("control hook ran on the disabled path")

    saved = ctl_mod.control_operands
    ctl_mod.control_operands = poison
    try:
        base = build()
        one_step(base)()
        calls_base, _ = _cuda_launches(torch, one_step(base))
    finally:
        ctl_mod.control_operands = saved
    if calls_off != calls_base:
        raise AssertionError("control_fsa: the control-off step and the "
                             "hook-free build differ: "
                             + _first_difference(calls_off, calls_base))

    # the off run's step times
    st = off.init_state(seed=0)
    ms_off = []
    for xb, yb in batches:
        t0 = time.perf_counter()
        st, m = off.train_step(st, xb, yb)
        float(m["loss"])
        ms_off.append(1e3 * (time.perf_counter() - t0))

    # the controlled run
    prior = os.environ.get("GEOMX_CONTROL")
    os.environ["GEOMX_CONTROL"] = "1"
    try:
        on = build(telemetry=True)
        st = on.init_state(seed=0)
    finally:
        if prior is None:
            del os.environ["GEOMX_CONTROL"]
        else:
            os.environ["GEOMX_CONTROL"] = prior
    dlog = reset_decision_log()
    act = ControlActuator(trainer=on, log=dlog)
    script = {s: (kind, value) for s, kind, value in CONTROL_SCRIPT}
    ratio_at = {s for s, kind, _ in CONTROL_SCRIPT if kind == "ratio"}
    profiled = ratio_at | {s - 1 for s in ratio_at}
    # kernel 3's inputs and output at the second step after each ratio
    # actuation (not a profiled one: the copies would add launch calls)
    captured, capture_at = {}, {s + 1 for s in ratio_at}
    bsc = on._dc_ratio_compressor()

    def capture(g, u, v, compress=bsc.compress):
        out = compress(g, u, v)
        if len(rows) in capture_at:
            captured[len(rows)] = ([t.detach().cpu() for t in (g, u, v)],
                                   out[0].detach().cpu(),
                                   out[1].detach().cpu())
        return out

    bsc.compress = capture
    current = {"ratio": 0.01, "depth": 0}
    P = on.topology.num_parties
    rows, pins, prev_calls, pending, depth_checks = [], [], None, None, {}
    for i in range(steps):
        if i in script:
            kind, value = script[i]
            dec = Decision(step=i, kind=kind, value=value,
                           prev=current[kind], reason="scripted")
            if kind == "ratio":
                pending = dict(before=prev_calls, fn=on.train_step,
                               cache=dict(on._control_cache))
            if kind == "depth" and value == 1:
                ef_before = [(p, t.clone()) for p, t in
                             tensors(torch, st.sync_state["dc_comp"])]
            if kind == "depth" and value == 0:
                names = leaf_names(st.params)
                bk = on.sync.inner.dc_compressor.inner._bucketer(
                    [st.params[k] for k in names])
                inflight = st.sync_state["inner"]["dc_comp"]["inflight"]
                g = {k: v / P for k, v in zip(names, bk.unflatten(inflight))}
                want, _ = on.tx.update(g, st.opt_state, st.params)
                parked = max(float(b.abs().max()) for b in inflight)
            st = act.apply(st, dec)
            current[kind] = value
            if kind == "depth" and value == 1:
                after = tensors(torch,
                                st.sync_state["inner"]["dc_comp"]["inner"])
                if [p for p, _ in after] != [p for p, _ in ef_before]:
                    raise AssertionError("control_fsa: the dc-tier EF "
                                         "layout changed across 0->1")
                spread = 0.0
                for (p, a), (_, b) in zip(after, ef_before):
                    if not torch.equal(a, b[:1, :1].expand_as(b)):
                        raise AssertionError(f"control_fsa: EF {p} not "
                                             "carried bit for bit")
                    spread = max(spread, float((b - b[:1, :1]).abs().max()))
                depth_checks["ef_buffers"] = len(after)
                depth_checks["ef_party_spread_before"] = spread
            if kind == "depth" and value == 0:
                for k in names:
                    if not torch.equal(st.params[k], want[k]):
                        raise AssertionError(
                            f"control_fsa: the 1->0 drain is not one "
                            f"apply of the parked aggregate at {k}")
                depth_checks["drained_parked_max_abs"] = parked
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        (st, m), calls = _run_step(torch, on, st, batches[i], i in profiled)
        probes = host_probes(m["telemetry"])
        loss = float(m["loss"])
        ms = 1e3 * (time.perf_counter() - t0)
        launches = ops.launch_counts()
        if on_card and any(launches[k] < 1 for k in SLICE1):
            raise AssertionError(f"control_fsa: step {i} launches "
                                 f"{launches}")
        if pending is not None:
            if on.train_step is not pending["fn"] or \
                    dict(on._control_cache) != pending["cache"]:
                raise AssertionError(f"control_fsa: the ratio actuation "
                                     f"before step {i} changed the step")
            if calls != pending["before"]:
                raise AssertionError(
                    f"control_fsa: the ratio actuation before step {i} "
                    "changed the launch calls: "
                    + _first_difference(pending["before"], calls))
            pins.append(dict(step=i, launch_calls=len(calls)))
            pending = None
        prev_calls = calls
        rows.append(dict(step=i, loss=loss, ms=ms, depth=on.control_depth(),
                         scale=probes["control_ratio_scale"],
                         emitted=probes["bsc_emitted_fraction"],
                         launches={k: launches[k] for k in SLICE1},
                         profiled=i in profiled))
    del bsc.compress
    if not all(math.isfinite(r["loss"]) for r in rows):
        raise AssertionError(f"control_fsa: losses {[r['loss'] for r in rows]}")
    # kernel 3 under the eff_k boundary against the plain selection on
    # the CPU from the same inputs, and the probe against its output
    exact = {}
    for i, ((g, u, v), vals, idx) in sorted(captured.items()):
        k = bsc.k_for(g.shape[-1])
        scale = torch.tensor(rows[i]["scale"], dtype=torch.float32)
        eff_k = torch.round(scale * k).clamp(1.0, float(k)).to(torch.int32)
        thr = ops.bsc.sampled_boundary_guv(g, u, v, eff_k)
        pv, pidx, _, _ = ops.bsc.select_pack_plain(g, u, v, thr, k)
        if not (torch.equal(pidx, idx) and torch.equal(pv, vals)):
            raise AssertionError(f"control_fsa: step {i}'s selection at "
                                 f"eff_k {int(eff_k)} differs from the "
                                 "plain version's on the CPU")
        share = ((idx >= 0).sum(-1).double() / k).mean().item()
        if abs(share - rows[i]["emitted"]) > 2.0 ** -23:
            raise AssertionError(f"control_fsa: step {i}'s probe "
                                 f"{rows[i]['emitted']} vs {share} from "
                                 "kernel 3's output")
        # the selection's over-reach, before the k slots cap it: the
        # coordinates at or above the Weyl probe's boundary per eff_k,
        # beside the same quantile of uniform random probes of the same
        # size (a diagnostic, not gated)
        absv = (v + (u * ops.bsc.MOMENTUM + g)).abs()
        above = (absv >= thr.unsqueeze(-1)).sum(-1).double()
        n = absv.shape[-1]
        pos = ops.sampled_topk.boundary_position(8192, eff_k, n)
        gen = torch.Generator().manual_seed(0)
        rand = []
        for _ in range(8):
            probe = absv[..., torch.randperm(n, generator=gen)[:8192]]
            rthr = probe.sort(-1).values.index_select(-1, pos.reshape(1))
            rand.append((absv >= rthr).sum(-1).double())
        exact[i] = dict(scale=rows[i]["scale"], eff_k=int(eff_k), k=k,
                        emitted=share,
                        over_reach=(above / int(eff_k)).mean().item(),
                        over_reach_random_probe=(
                            torch.stack(rand).mean(0) / int(eff_k))
                        .mean().item())
    for k_, v in st.params.items():
        if not torch.equal(v, v[:1, :1].expand_as(v)):
            raise AssertionError(f"control_fsa: replicas diverged at {k_}")
    by_scale = {}
    for r in rows:
        by_scale.setdefault(r["scale"], []).append(r["emitted"])
    means = {s: statistics.mean(v) for s, v in by_scale.items()}
    scales = sorted(means, reverse=True)
    if scales != [1.0, 0.5, 0.125] or \
            not means[1.0] > means[0.5] > means[0.125]:
        raise AssertionError(f"control_fsa: emitted share by scale {means}")
    off_scale = {s: means[s] - s for s in scales
                 if abs(means[s] - s) > CONTROL_EMITTED_TOL}
    if len(dlog.snapshot()) != len(CONTROL_SCRIPT):
        raise AssertionError(f"control_fsa: decision log {dlog.snapshot()}")
    ref = control_reference(torch) if on_card else None
    timed = [r["ms"] for r in rows[1:] if not r["profiled"]]
    res = dict(
        steps=steps, losses=[r["loss"] for r in rows], rows=rows,
        emitted_by_scale=means, emitted_off_scale=off_scale,
        kernel3_vs_plain=exact, pins=pins, depth=depth_checks,
        launch_calls_per_step_off=len(calls_off),
        launch_calls_per_step_on=pins[0]["launch_calls"] if pins else None,
        step_ms_median_on=statistics.median(timed),
        step_ms_median_off=statistics.median(ms_off[1:]),
        decisions=dlog.snapshot(), reference=ref,
        wall_s=time.perf_counter() - t_phase)
    log(f"phase control_fsa: {steps} steps under {len(CONTROL_SCRIPT)} "
        f"scripted decisions; a control-off step makes the hook-free "
        f"build's {len(calls_off)} launch calls; the step after each of "
        f"{len(pins)} ratio actuations made the step before's launch "
        f"calls ({[p['launch_calls'] for p in pins]}), the step cache "
        f"unchanged; emitted share by scale "
        + ", ".join(f"{s:g}: {means[s]:.4f}" for s in scales)
        + f" (per step {[round(r['emitted'], 4) for r in rows]}; more "
        f"than {CONTROL_EMITTED_TOL} from the scale at "
        f"{sorted(off_scale, reverse=True)}); kernel 3 at steps "
        f"{sorted(exact)} (eff_k {[e['eff_k'] for _, e in sorted(exact.items())]}"
        f") equal to the plain selection on the CPU, coordinates at or "
        f"above the boundary per eff_k "
        f"{[round(e['over_reach'], 3) for _, e in sorted(exact.items())]} "
        f"(uniform random probes: "
        f"{[round(e['over_reach_random_probe'], 3) for _, e in sorted(exact.items())]}"
        f"); 0->1 "
        f"carried {depth_checks['ef_buffers']} EF buffers bit for bit "
        f"(copy (0, 0); parties differed by up to "
        f"{depth_checks['ef_party_spread_before']:.3g} before), the 1->0 "
        f"drain one apply of the parked aggregate (max "
        f"{depth_checks['drained_parked_max_abs']:.3g}); "
        + (f"card vs CPU at scale 0.5: losses {ref['card_losses']} vs "
           f"{ref['cpu_losses']}, params within {ref['max_param_diff']:.3g}; "
           if ref else "")
        + f"step {res['step_ms_median_on']:.2f} ms with control on vs "
        f"{res['step_ms_median_off']:.2f} ms off (medians; per step on "
        f"{[round(r['ms'], 1) for r in rows]}, off "
        f"{[round(t, 1) for t in ms_off]}); launch calls "
        f"a step {res['launch_calls_per_step_off']} off, "
        f"{res['launch_calls_per_step_on']} on (telemetry too); phase "
        f"{res['wall_s']:.1f} s")
    return res


def control_wan(torch, device=None):
    """The control replay's WAN constants (bench.py's calibration over
    the port's own wire accounting): the hi ratio's bytes a party,
    moved by a healthy uplink in a tenth of a compute step; the overlay
    link 8x that.  Returns ``(wan_kw, hi_bytes)``."""
    from geomx_tpu_torch import GeoConfig, HiPSTopology
    from geomx_tpu_torch.models import get_model
    from geomx_tpu_torch.optim import sgd
    from geomx_tpu_torch.train import Trainer

    c = CONTROL_REPLAY
    probe = Trainer(get_model("mlp", num_classes=10),
                    HiPSTopology(c["parties"], 1), sgd(c["lr"]),
                    config=GeoConfig(num_parties=c["parties"],
                                     workers_per_party=1,
                                     compression=f"bsc,{c['ratio_hi']}",
                                     bucket_bytes=c["bucket_bytes"]),
                    device=device)
    st = probe.init_state(seed=0, sample_input=control_make_data()[0][:2])
    hi_bytes = float(probe.sync.dc_compressor.wire_bytes(st.params))
    bps = hi_bytes / (0.1 * c["compute_s"])
    return dict(base_bps=bps, p2p_bps=8.0 * bps,
                base_delay_s=c["base_delay_s"],
                compute_s=c["compute_s"]), hi_bytes


def _control_run(torch, ratio: float, depth: int, wan_kw: dict,
                 controller: bool, ratio_bounds=None, device=None,
                 capsule_path: str = None, pin: bool = False,
                 steps: int = None) -> dict:
    """One seeded replay of the control acceptance (bench.py's
    ``_control_run`` in the port): a real training run on ``device``
    whose WAN wall clock is modelled a step from the chaos-shaped link
    timeline (``steps``, default CONTROL_REPLAY's).  Returns the
    timeline, the decision log, the launch-call pins of the ratio
    actuations (``pin``: every step profiled) and the capsule's path."""
    import numpy as np

    from geomx_tpu_torch import GeoConfig, HiPSTopology
    from geomx_tpu_torch.control import (ControlActuator, ControlSensors,
                                         reset_decision_log)
    from geomx_tpu_torch.models import get_model
    from geomx_tpu_torch.optim import sgd
    from geomx_tpu_torch.resilience import ChaosEngine, ChaosSchedule
    from geomx_tpu_torch.telemetry import (reset_link_observatory,
                                           reset_registry)
    from geomx_tpu_torch.telemetry.capsule import RunCapsule
    from geomx_tpu_torch.telemetry.probes import host_probes
    from geomx_tpu_torch.train import Trainer

    c = CONTROL_REPLAY
    P, batch = c["parties"], c["batch"]
    steps = c["steps"] if steps is None else int(steps)
    reset_registry()
    observatory = reset_link_observatory()
    dlog = reset_decision_log()
    cfg = GeoConfig(num_parties=P, workers_per_party=1,
                    compression=f"bsc,{ratio}",
                    bucket_bytes=c["bucket_bytes"], pipeline_depth=depth,
                    telemetry=True, control=controller)
    trainer = Trainer(get_model("mlp", num_classes=10), HiPSTopology(P, 1),
                      sgd(c["lr"]), config=cfg, device=device)
    x, y = control_make_data()
    state = trainer.init_state(seed=0, sample_input=x[:2])
    dev = trainer.device
    xt = torch.as_tensor(x, device=dev)
    yt = torch.as_tensor(y.astype(np.int64), device=dev)
    local_b = batch // P
    model = WanModel(P, **wan_kw)
    routes: tuple = ()
    pilot = actuator = None
    if controller:
        sensors = ControlSensors(observatory=observatory, min_confidence=0.5,
                                 compute_s_fn=lambda s: model.compute_s)
        pilot = control_pilot(sensors, ratio, ratio_bounds)

        def relay_apply(order):
            nonlocal routes
            routes = tuple(int(p[5:]) for p in order)  # "party<i>" -> i

        actuator = ControlActuator(trainer=trainer, relay_apply=relay_apply,
                                   log=dlog)
    capsule = None
    if capsule_path:
        capsule = RunCapsule(capsule_path, config=cfg)
        capsule.attach_observatory(observatory)
    clock, timeline, pins, pending = 0.0, [], [], None
    with ChaosEngine(ChaosSchedule.from_spec(c["schedule"])) as engine:
        for it in range(steps):
            engine.tick(it)
            sel = torch.as_tensor((np.arange(batch) + it * batch) % len(x),
                                  device=dev)
            xb = xt[sel].reshape(P, 1, local_b, 32, 32, 3)
            yb = yt[sel].reshape(P, 1, local_b)
            (state, metrics), calls = _run_step(torch, trainer, state,
                                                (xb, yb), pin)
            if pending is not None:
                step_fn, before, cache = pending
                if step_fn is trainer.train_step:
                    pins.append(dict(step=it, same_calls=calls == before,
                                     calls=len(calls or ()),
                                     same_cache=cache == dict(
                                         trainer._control_cache)))
                pending = None
            flat = host_probes(metrics["telemetry"])
            trainer._publish_telemetry(metrics["telemetry"], it + 1)
            emitted = float(flat.get("bsc_emitted_fraction", 1.0))
            nbytes = float(flat["dc_wire_bytes"]) * emitted
            rec = model.step_seconds(nbytes, trainer.control_depth(), routes)
            clock += rec["total"]
            model.feed_observatory(observatory, nbytes, clock)
            model.publish_phases(rec)
            timeline.append({
                "step": it, "loss": float(metrics["loss"]),
                "t": round(clock, 6), "wan_s": round(rec["wan"], 6),
                "exposed_s": round(rec["exposed"], 6), "bytes": nbytes,
                "emitted": emitted, "depth": trainer.control_depth(),
                "routes": list(routes)})
            if capsule is not None:
                capsule.record_step(it, t=clock)
            if pilot is not None:
                for dec in pilot.tick(it, now=clock):
                    if dec.kind == "ratio":
                        pending = (trainer.train_step, calls,
                                   dict(trainer._control_cache))
                    state = actuator.apply(state, dec)
    out = {"timeline": timeline,
           "decisions": dlog.snapshot() if controller else [],
           "pins": pins}
    if capsule is not None:
        capsule.detach_observatory()
        out["capsule"] = capsule.write(now=clock)
    return out


def control_pilot(sensors, ratio: float, ratio_bounds):
    """The acceptance's policy stack (bench.py's): the ratio policy on
    cooldown 3 with a 0.2 deadband, a Schmitt depth band above the
    healthy WAN share (enter 0.45, exit 0.40, confirm 2), the relay on
    a 2x margin."""
    from geomx_tpu_torch.control import (DepthPolicy, GraftPilot,
                                         RatioPolicy, RelayPolicy)
    return GraftPilot(
        sensors,
        ratio=RatioPolicy(ratio, bounds=ratio_bounds, cooldown=3,
                          deadband=0.2),
        depth=DepthPolicy(enter=0.45, exit=0.40, confirm=2, cooldown=3),
        relay=RelayPolicy(min_gain=2.0, cooldown=3, min_confidence=0.5))


def _smoothed_losses(timeline, window: int = 3):
    losses = [rec["loss"] for rec in timeline]
    return [statistics.mean(losses[max(0, i - window + 1):i + 1])
            for i in range(len(losses))]


def _time_to_target(timeline, target: float):
    for rec, sm in zip(timeline, _smoothed_losses(timeline)):
        if sm <= target:
            return rec["t"]
    return None


def control_replay_phase(torch, device=None,
                         out_dir: str = os.path.join("chiprun_out",
                                                     "control")) -> dict:
    """Phase control_replay: bench.py --compare-control at its defaults
    (CONTROL_REPLAY) in the port: four static runs (ratio 0.25 and
    0.03125 x depth 0 and 1) and two controller runs of the MLP on the
    card, the WAN modelled with its bandwidth calibrated from the port's
    own wire accounting (the hi ratio's bytes a party moved in a tenth
    of a compute step; the overlay link 8x that).  Gates: the controller
    reaches the loss target (the tightest smoothed loss every run
    reached, +2%) before every static run; the two controller runs'
    decision logs byte-identical (json.dumps, sort_keys); the step after
    each ratio actuation makes the launch calls of the step before it
    with the step cache unchanged (the first controller run profiles
    every step); the controller run's capsule, replayed through
    Capsule.replay_decisions, reproduces its log.  Prints the port's
    decisions beside CONTROL_r01.json's (the JAX package's recorded run;
    not a gate)."""
    from geomx_tpu_torch.telemetry.capsule import Capsule

    t_phase = time.perf_counter()
    c = CONTROL_REPLAY
    os.makedirs(out_dir, exist_ok=True)
    ratio_hi = c["ratio_hi"]
    ratio_lo = ratio_hi / 8.0
    wan_kw, hi_bytes = control_wan(torch, device)
    grid = {"hi_d0": (ratio_hi, 0), "hi_d1": (ratio_hi, 1),
            "lo_d0": (ratio_lo, 0), "lo_d1": (ratio_lo, 1)}
    static = {name: _control_run(torch, r, d, wan_kw, controller=False,
                                 device=device)
              for name, (r, d) in grid.items()}
    bounds = (ratio_lo, ratio_hi)
    cap_path = os.path.join(out_dir, "capsule_controller.json")
    ctrl = _control_run(torch, ratio_hi, 0, wan_kw, controller=True,
                        ratio_bounds=bounds, device=device,
                        capsule_path=cap_path, pin=True)
    ctrl2 = _control_run(torch, ratio_hi, 0, wan_kw, controller=True,
                         ratio_bounds=bounds, device=device)
    dec_a = json.dumps(ctrl["decisions"], sort_keys=True)
    dec_b = json.dumps(ctrl2["decisions"], sort_keys=True)
    floors = [min(_smoothed_losses(run["timeline"]))
              for run in list(static.values()) + [ctrl]]
    target = round(max(floors) * 1.02, 6)
    static_times = {name: _time_to_target(run["timeline"], target)
                    for name, run in static.items()}
    ctrl_time = _time_to_target(ctrl["timeline"], target)
    replayed = Capsule.load(ctrl["capsule"]).replay_decisions(
        lambda sensors: control_pilot(sensors, ratio_hi, bounds),
        min_confidence=0.5, compute_s_fn=lambda s: c["compute_s"])
    with open(os.path.join(out_dir, "control_decisions.json"), "w") as f:
        json.dump({"decisions": ctrl["decisions"],
                   "timeline": ctrl["timeline"],
                   "static": {n: r["timeline"] for n, r in static.items()}},
                  f, indent=1)
    res = dict(
        hi_wire_bytes=hi_bytes, wan=wan_kw, loss_target=target,
        static={n: dict(ratio=grid[n][0], depth=grid[n][1],
                        time_to_target_s=static_times[n],
                        final_loss=_smoothed_losses(r["timeline"])[-1],
                        total_time_s=r["timeline"][-1]["t"])
                for n, r in static.items()},
        controller=dict(time_to_target_s=ctrl_time,
                        final_loss=_smoothed_losses(ctrl["timeline"])[-1],
                        total_time_s=ctrl["timeline"][-1]["t"],
                        decisions=ctrl["decisions"]),
        decision_log_deterministic=dec_a == dec_b,
        replay_reproduces_log=json.dumps(replayed, sort_keys=True) == dec_a,
        ratio_pins=ctrl["pins"], wall_s=time.perf_counter() - t_phase)
    try:
        with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "CONTROL_r01.json")) as f:
            jax_decs = json.load(f)["controller"]["decisions"]
    except (OSError, KeyError, ValueError):
        jax_decs = None
    log(f"phase control_replay: static time to loss {target:.4f}: "
        + ", ".join(f"{n} {t if t is None else round(t, 4)} s"
                    for n, t in static_times.items())
        + f"; controller {ctrl_time if ctrl_time is None else round(ctrl_time, 4)} s, "
        f"{len(ctrl['decisions'])} decisions; logs byte-identical "
        f"{res['decision_log_deterministic']}; capsule replay reproduces "
        f"the log {res['replay_reproduces_log']}; ratio actuations "
        f"{[(p['step'], p['calls']) for p in ctrl['pins']]} (step, launch "
        f"calls of the step after); hi-ratio wire {hi_bytes:.0f} B a party; "
        f"phase {res['wall_s']:.1f} s")
    width = max((len(f"{d['step']} {d['kind']} {d['value']}")
                 for d in ctrl["decisions"]), default=0)
    for i in range(max(len(ctrl["decisions"]), len(jax_decs or []))):
        a = ctrl["decisions"][i] if i < len(ctrl["decisions"]) else None
        b = (jax_decs or [])[i] if i < len(jax_decs or []) else None
        fmt = (lambda d: "-" if d is None else
               f"{d['step']} {d['kind']} {d['value']}")
        log(f"  decision {i}: port {fmt(a):<{width}}  JAX (CONTROL_r01) "
            f"{fmt(b)}")
    if ctrl_time is None or any(t is not None and not ctrl_time < t
                                for t in static_times.values()):
        raise AssertionError(f"control_replay: the controller's time to "
                             f"target {ctrl_time} does not beat every "
                             f"static run's {static_times}")
    if dec_a != dec_b:
        raise AssertionError(f"control_replay: the two controller runs' "
                             f"logs differ:\n{dec_a}\n{dec_b}")
    if not ctrl["pins"] or not all(p["same_calls"] and p["same_cache"]
                                   for p in ctrl["pins"]):
        raise AssertionError(f"control_replay: ratio pins {ctrl['pins']}")
    if not res["replay_reproduces_log"]:
        raise AssertionError(f"control_replay: the capsule replay "
                             f"{replayed} differs from the live log "
                             f"{ctrl['decisions']}")
    return res


def fleetscope_sched_phase(torch, out_dir: str = os.path.join(
        "chiprun_out", "fleetscope")) -> dict:
    """Phase fleetscope_sched: dist_ps_mixed_sched's job (8 processes)
    with GEOMX_FLEETSCOPE=1, a FLEETSCOPE_INTERVAL_S poll and the
    scheduler's metrics port set; this process fetches the scheduler's
    GET /fleet, /healthz and /control while the job runs.  Gates: the
    job's own (every process exits 0, the accuracy floor); a fleet
    document that names every roster node the scheduler's /healthz
    counts, by role, and the scheduler itself, with fleet_version rising
    across polls; GET /control 200 with no decisions; tools/gxtop.py
    --json and its text view render the fetched document; the seeded
    burn series (fleetscope_burn_series) gives byte-identical breach
    lists twice."""
    import collections
    import threading
    import urllib.request

    from geomx_tpu_torch.utils.net import free_port_blocks

    os.makedirs(out_dir, exist_ok=True)
    mport, = free_port_blocks(1)
    base = f"http://127.0.0.1:{mport}"
    docs, healths, controls = [], [], []
    stop = threading.Event()

    def fetch(route):
        with urllib.request.urlopen(base + route, timeout=2) as r:
            return r.status, json.loads(r.read())

    def watch():
        while not stop.is_set():
            try:
                _, doc = fetch("/fleet")
                _, health = fetch("/healthz")
                if doc.get("fleet_version"):
                    docs.append(doc)
                    healths.append(health)
                if not controls:
                    controls.append(fetch("/control"))
            except (OSError, ValueError):
                pass
            stop.wait(0.25)

    res = dist_ps_phase(
        torch, "dist_ps_mixed_sched", label="fleetscope_sched",
        extra_env={"GEOMX_FLEETSCOPE": "1",
                   "GEOMX_FLEETSCOPE_INTERVAL_S": str(FLEETSCOPE_INTERVAL_S),
                   "GEOMX_METRICS_PORT": str(mport)},
        watch=(watch, stop))
    versions = [d["fleet_version"] for d in docs]
    if len(docs) < 2 or not all(b >= a for a, b in zip(versions,
                                                       versions[1:])) \
            or not versions[-1] > versions[0]:
        raise AssertionError(f"fleetscope_sched: fleet versions {versions}")
    full = None
    for doc, health in zip(docs, healths):
        kinds = collections.Counter(e["kind"] for e in doc["nodes"].values())
        roster = health.get("roster") or {}
        if "scheduler" in doc["nodes"] and \
                sum(roster.values()) == DIST_PS["dist_ps_mixed_sched"][
                    "procs"] - 1 and \
                all(kinds.get(role, 0) == n for role, n in roster.items()):
            full = (doc, dict(roster))
    if full is None:
        raise AssertionError(f"fleetscope_sched: no fleet document names "
                             f"the whole roster: {docs[-1]['nodes']}, "
                             f"{healths[-1].get('roster')}")
    doc, roster = full
    if doc["nodes"]["scheduler"]["health"] != "ok":
        raise AssertionError(f"fleetscope_sched: the scheduler's own entry "
                             f"{doc['nodes']['scheduler']}")
    if not controls or controls[0][0] != 200 or \
            controls[0][1].get("decisions") != []:
        raise AssertionError(f"fleetscope_sched: GET /control {controls}")
    path = os.path.join(out_dir, "fleet.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    root = os.path.dirname(os.path.abspath(__file__))
    gx = [sys.executable, os.path.join(root, "tools", "gxtop.py"),
          f"--file={path}"]
    as_json = subprocess.run(gx + ["--json"], capture_output=True, text=True,
                             timeout=60)
    text = subprocess.run(gx, capture_output=True, text=True, timeout=60)
    if as_json.returncode or json.loads(as_json.stdout) != doc or \
            text.returncode or "scheduler" not in text.stdout:
        raise AssertionError(f"fleetscope_sched: gxtop rc "
                             f"{as_json.returncode}/{text.returncode}: "
                             f"{as_json.stderr[-500:]}{text.stderr[-500:]}")
    b1, n1 = fleetscope_burn_series(FLEETSCOPE_BURN_SEED)
    b2, n2 = fleetscope_burn_series(FLEETSCOPE_BURN_SEED)
    if b1 != b2 or not n1:
        raise AssertionError(f"fleetscope_sched: burn breaches {n1} / {n2}")
    res.update(fleet_polls=len(docs), fleet_versions=[versions[0],
                                                      versions[-1]],
               fleet_nodes=sorted(doc["nodes"]), roster=roster,
               scheduler_entry=doc["nodes"]["scheduler"],
               rollups=doc["rollups"], burn_breaches=n1,
               gxtop_lines=len(text.stdout.splitlines()))
    log(f"phase fleetscope_sched: {len(docs)} fleet documents fetched "
        f"(fleet_version {versions[0]} -> {versions[-1]}), one naming "
        f"{len(doc['nodes'])} nodes: the scheduler and the roster {roster}; "
        f"GET /control 200 with no decisions; gxtop rendered it "
        f"({res['gxtop_lines']} lines); the seeded burn series gave "
        f"{n1} breach(es) twice, byte-identical")
    return res


# ---- the serving plane ------------------------------------------------------

# serve_mlp: bench.py --compare-serve at its defaults, on the port
SERVE_MLP = dict(rounds=5, requests=120, clients=4, rows=2, max_batch=8,
                 queue_ms=2.0, delta_frac=0.01, seed=0)
# serve_seq_flash: the SeqClassifier at seq_flash's configuration (vocab
# 256, max_len 4096, dim 64, 4 heads, 2 layers, fp32), one request a row
# of 4,096 token ids; two delta rounds land while requests are served
SERVE_SEQ = dict(L=4096, max_batch=8, queue_ms=2.0, rounds=2,
                 delta_frac=0.01, delta_std=0.1, requests=64, clients=4,
                 seed=0)


def _load_stats(worker, clients, stats, deadline_s):
    """Run ``clients`` load threads, then fold their latencies into
    p50/p99 and the sustained QPS (bench.py's _run_load_threads)."""
    import threading
    t0 = time.monotonic()
    threads = [threading.Thread(target=worker, args=(w,), daemon=True)
               for w in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(deadline_s * 4)
    stats["elapsed_s"] = time.monotonic() - t0
    lat = sorted(stats.pop("latencies_s"))

    def pct(q):
        return lat[min(len(lat) - 1, int(math.ceil(q * len(lat))) - 1)] \
            if lat else None

    stats["p50_s"], stats["p99_s"] = pct(0.50), pct(0.99)
    stats["qps"] = stats["ok"] / stats["elapsed_s"] \
        if stats["elapsed_s"] > 0 else 0.0
    return stats


def serve_http_load(port, xs, n_requests, clients, rows_per_req,
                    stop_evt=None, deadline_s=30.0):
    """``n_requests`` POST /infer calls from ``clients`` threads (or until
    ``stop_evt``); every request ends ok (2xx), shed (503) or error."""
    import threading
    import urllib.error
    import urllib.request

    import numpy as np
    lock = threading.Lock()
    stats = {"issued": 0, "ok": 0, "shed": 0, "error": 0,
             "latencies_s": [], "batch_sizes": []}
    url = f"http://127.0.0.1:{port}/infer"

    def worker(wid):
        rng = np.random.default_rng(1000 + wid)
        while True:
            with lock:
                if n_requests is not None and stats["issued"] >= n_requests:
                    return
                if stop_evt is not None and stop_evt.is_set():
                    return
                stats["issued"] += 1
            rows = [xs[rng.integers(0, len(xs))].tolist()
                    for _ in range(rows_per_req)]
            req = urllib.request.Request(
                url, data=json.dumps({"inputs": rows}).encode(),
                headers={"Content-Type": "application/json"})
            t0 = time.monotonic()
            try:
                with urllib.request.urlopen(req, timeout=deadline_s) as r:
                    doc = json.loads(r.read())
                with lock:
                    stats["ok"] += 1
                    stats["latencies_s"].append(time.monotonic() - t0)
                    stats["batch_sizes"].extend(doc.get("batch_sizes", []))
            except urllib.error.HTTPError as e:
                e.read()
                with lock:
                    stats["shed" if e.code == 503 else "error"] += 1
                    stats["latencies_s"].append(time.monotonic() - t0)
            except Exception:
                with lock:
                    stats["error"] += 1

    return _load_stats(worker, clients, stats, deadline_s)


def serve_native_load(port, xs, n_requests, clients, rows_per_req,
                      stop_evt=None, deadline_s=30.0, keep=None):
    """The native lane's twin of serve_http_load: one persistent INFER
    connection a client thread.  ``keep`` (a list) collects (row indices,
    reply) pairs."""
    import threading

    import numpy as np

    from geomx_tpu_torch.serve.infer_wire import NativeInferenceClient
    lock = threading.Lock()
    stats = {"issued": 0, "ok": 0, "shed": 0, "error": 0,
             "latencies_s": [], "batch_sizes": []}

    def worker(wid):
        rng = np.random.default_rng(2000 + wid)
        cli = NativeInferenceClient(("127.0.0.1", port),
                                    timeout_s=deadline_s)
        try:
            while True:
                with lock:
                    if n_requests is not None \
                            and stats["issued"] >= n_requests:
                        return
                    if stop_evt is not None and stop_evt.is_set():
                        return
                    stats["issued"] += 1
                rows = [int(rng.integers(0, len(xs)))
                        for _ in range(rows_per_req)]
                t0 = time.monotonic()
                try:
                    rep = cli.infer(np.stack([xs[i] for i in rows]))
                    dt = time.monotonic() - t0
                    with lock:
                        if "outputs" in rep:
                            stats["ok"] += 1
                            stats["latencies_s"].append(dt)
                            stats["batch_sizes"].extend(
                                rep.get("batch_sizes", []))
                            if keep is not None:
                                keep.append((rows, rep))
                        elif rep.get("error") == "shed":
                            stats["shed"] += 1
                            stats["latencies_s"].append(dt)
                        else:
                            stats["error"] += 1
                except Exception:
                    with lock:
                        stats["error"] += 1
        finally:
            cli.close()

    return _load_stats(worker, clients, stats, deadline_s)


def _seeded_model(torch, model, seed: int):
    """``model``'s flax initializers drawn from a seeded generator."""
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model


def _random_pairs(rng, dense: dict, frac: float, std: float) -> dict:
    """One round of pair deltas, ``frac`` of each layer, folded into the
    dense checkpoint with np.add.at (the registry's add semantics)."""
    import numpy as np
    layers = {}
    for k, v in dense.items():
        kk = max(1, int(v.size * frac))
        idx = rng.choice(v.size, size=kk, replace=False).astype(np.int64)
        vals = (rng.normal(size=kk) * std).astype(np.float32)
        layers[k] = (vals, idx)
        np.add.at(v.reshape(-1), idx, vals)
    return layers


def _gate(res: dict, name: str, ok) -> None:
    res.setdefault("gates", {})[name] = bool(ok)
    log(f"  gate {name}: {'ok' if ok else 'FAILED'}")


def _fill(sizes, max_batch):
    return sum(sizes) / (len(sizes) * max_batch) if sizes else None


def serve_mlp_phase(torch, device=None, **over) -> dict:
    """bench.py --compare-serve on the port: the zoo MLP (6 leaves,
    940,584 dense bytes) published to a durable RegistryServer, a replica
    at party 1, the gateway (max_batch 8, queue_ms 2, one captured graph
    a bucket on the card) behind HTTP and the native lane; 120 requests
    of 2 rows from 4 clients on each lane, 5 train-while-serving rounds
    of 1% pair deltas under load, then the registry crashed mid-refresh,
    its failover and the replay of the whole round.  Every gate of
    _compare_serve's ok must hold."""
    import shutil
    import threading

    import numpy as np

    from geomx_tpu_torch.config import GeoConfig
    from geomx_tpu_torch.control.policy import SloPolicy
    from geomx_tpu_torch.control.sensors import ControlObservation
    from geomx_tpu_torch.device import resolve_device
    from geomx_tpu_torch.models import get_model
    from geomx_tpu_torch.serve.gateway import (InferenceGateway,
                                               flatten_params,
                                               unflatten_params)
    from geomx_tpu_torch.serve.infer_wire import serve_native
    from geomx_tpu_torch.tree import from_nested
    from geomx_tpu_torch.serve.registry import (RegistryClient,
                                                RegistryServer)
    from geomx_tpu_torch.serve.replica import ServingReplica
    from geomx_tpu_torch.telemetry.ledger import (get_request_ledger,
                                                  get_round_ledger,
                                                  reset_request_ledger,
                                                  reset_round_ledger)
    p = dict(SERVE_MLP, **over)
    dev = resolve_device(device)
    cfg = GeoConfig.from_env()
    rng = np.random.default_rng(p["seed"])
    t_start = time.perf_counter()
    reset_round_ledger()
    reset_request_ledger()
    feat = 28 * 28
    model = get_model("mlp", num_classes=10)
    model.build((feat,))
    _seeded_model(torch, model, p["seed"])
    named, treedef = flatten_params(model)
    dense_ckpt = {k: v.copy() for k, v in named.items()}
    dense_bytes = int(sum(v.nbytes for v in named.values()))
    res = {"model": {"name": "mlp", "layers": len(named),
                     "dense_bytes": dense_bytes}, "device": str(dev)}
    if len(named) != 6 or dense_bytes != 940_584:
        raise AssertionError(f"serve_mlp: the MLP is {res['model']}")
    durable_dir = tempfile.mkdtemp(prefix="geomx_serve_registry_")
    srv = RegistryServer(durable_dir=durable_dir).start()
    trainer = RegistryClient(srv.addr, sender=0, timeout_s=20.0)
    trainer.publish("v1", named)
    replica_cli = RegistryClient(srv.addr, sender=1, timeout_s=20.0)
    replica = ServingReplica("v1", party=1)
    replica.sync(replica_cli)
    gw = InferenceGateway(replica, treedef=treedef, model_name="mlp",
                          num_classes=10, max_batch=p["max_batch"],
                          queue_ms=p["queue_ms"], warmup_shapes=[(feat,)],
                          warmup=True, device=dev)
    gw.start()
    res["warmup_compiles"] = gw.warmup_compiles
    httpd = gw.serve_http(port=cfg.serve_port)
    port = httpd.server_address[1]
    nsrv = serve_native(gw, port=0)
    if nsrv is None:
        raise AssertionError("serve_mlp: GEOMX_SERVE_NATIVE_WIRE is off")
    xs = rng.normal(size=(16, feat)).astype(np.float32)
    failover = trainer2 = replica_cli2 = None
    try:
        # ---- A: sustained QPS on both lanes ---------------------------
        serve_http_load(port, xs, 8, 2, p["rows"])       # warm the door
        reset_request_ledger()
        http = serve_http_load(port, xs, p["requests"], p["clients"],
                               p["rows"])
        native = serve_native_load(nsrv.port, xs, p["requests"],
                                   p["clients"], p["rows"])
        for lane, st in (("http", http), ("native", native)):
            res[lane] = dict(st, fill=_fill(st["batch_sizes"],
                                            p["max_batch"]))
            res[lane].pop("batch_sizes")
            log(f"serve_mlp {lane}: {st['qps']:.1f} requests/s, p50 "
                f"{1e3 * (st['p50_s'] or 0):.3f} ms, p99 "
                f"{1e3 * (st['p99_s'] or 0):.3f} ms, batch fill "
                f"{res[lane]['fill']}, {st['ok']} ok of {st['issued']}")
        res["serve_qps"] = native["qps"]
        res["batch_max_seen"] = int(max(native["batch_sizes"]
                                        + http["batch_sizes"] + [0]))
        lane = get_request_ledger().summary().get("wire", {}).get(
            "native", {})
        res["native_honesty_ratio"] = lane.get("honesty_ratio_rx")
        res["jit_cache_size"] = gw.jit_cache_size()
        # ---- B: train-while-serving, delta-only refresh ----------------
        stop = threading.Event()
        bg, bgn = {}, {}
        threads = [threading.Thread(target=lambda: bg.update(
            serve_http_load(port, xs, None, 2, p["rows"], stop_evt=stop)),
            daemon=True), threading.Thread(target=lambda: bgn.update(
                serve_native_load(nsrv.port, xs, None, 2, p["rows"],
                                  stop_evt=stop)), daemon=True)]
        for t in threads:
            t.start()
        max_stale = 0.0
        for r in range(1, p["rounds"] + 1):
            layers = _random_pairs(rng, dense_ckpt, p["delta_frac"], 0.01)
            ack = trainer.push_delta("v1", r, layers)
            if ack["applied_layers"] != len(layers):
                raise AssertionError(f"serve_mlp: round {r} push "
                                     f"under-applied: {ack}")
            replica.sync(replica_cli)
            max_stale = max(max_stale, replica.staleness_s())
        stop.set()
        for t in threads:
            t.join(30.0)
        res["train_while_serving"] = {"http": bg, "native": bgn,
                                      "max_staleness_s": max_stale}
        served = replica.params()
        res["bit_exact"] = all(np.array_equal(served[k], dense_ckpt[k])
                               for k in dense_ckpt)
        base_rx = delta_rx = 0
        honest = True
        for rec in get_round_ledger().records():
            if not str(rec.get("key", "")).startswith("v1/"):
                continue
            got = int(rec.get("wire", {}).get("push_rx_bytes", 0))
            if int(rec.get("round", -1)) == 0:
                base_rx += got
            else:
                delta_rx += got
                declared = int(rec.get("declared_rx_bytes", 0) or 0)
                honest = honest and 0 < declared <= got
        per_round = delta_rx / max(1, p["rounds"])
        res["ledger_bytes"] = {"base_push_rx": base_rx,
                               "delta_push_rx": delta_rx,
                               "delta_per_round": per_round,
                               "declared_honest": honest}
        # ---- C: the registry killed mid-refresh, failover, replay ------
        reset_request_ledger()
        stop2 = threading.Event()
        ch, chn = {}, {}
        threads = [threading.Thread(target=lambda: ch.update(
            serve_http_load(port, xs, None, 2, p["rows"], stop_evt=stop2)),
            daemon=True), threading.Thread(target=lambda: chn.update(
                serve_native_load(nsrv.port, xs, None, 2, p["rows"],
                                  stop_evt=stop2)), daemon=True)]
        for t in threads:
            t.start()
        chaos_round = p["rounds"] + 1
        layers = _random_pairs(rng, dense_ckpt, p["delta_frac"], 0.01)
        names = list(layers)
        half = {k: layers[k] for k in names[:max(1, len(names) // 2)]}
        trainer.push_delta("v1", chaos_round, half)
        srv.crash()
        gen_old = srv.generation
        failover = RegistryServer(durable_dir=durable_dir).start()
        res["failover_generation"] = {"old": gen_old,
                                      "new": failover.generation}
        trainer2 = RegistryClient(failover.addr, sender=0, timeout_s=20.0)
        ack = trainer2.push_delta("v1", chaos_round, layers)
        res["chaos_replay"] = {"layers": len(layers),
                               "pre_crash": len(half),
                               "replay_applied": int(ack["applied_layers"])}
        replica_cli2 = RegistryClient(failover.addr, sender=1,
                                      timeout_s=20.0)
        post = replica.sync(replica_cli2)
        served = replica.params()
        chaos_exact = all(np.array_equal(served[k], dense_ckpt[k])
                          for k in dense_ckpt)
        stop2.set()
        for t in threads:
            t.join(30.0)
        res["chaos_load"] = {"http": ch, "native": chn}
        lanes = [ch, chn]
        chaos_p99 = max(s.get("p99_s") or 0.0 for s in lanes)
        res["chaos_p99_s"] = chaos_p99
        res["replica"] = replica.snapshot()
        # the served answers are the plain forward of the checkpoint
        from geomx_tpu_torch.serve.infer_wire import NativeInferenceClient
        cli = NativeInferenceClient(("127.0.0.1", nsrv.port),
                                    timeout_s=30.0)
        try:
            got = cli.infer(xs[:4])["outputs"]
        finally:
            cli.close()
        ref_model = get_model("mlp", num_classes=10)
        ref_model.build((feat,))
        ref_model.load_state_dict({
            k: torch.from_numpy(v) for k, v in from_nested(
                unflatten_params(treedef, dense_ckpt)["params"]).items()})
        with torch.no_grad():
            want = ref_model(torch.from_numpy(xs[:4])).numpy()
        res["cpu_max_abs_err"] = float(np.abs(got - want).max())
        # ---- the SLO policy on this gateway's stats: a target under the
        # chaos load's measured p99 makes it shed, the decision reaches
        # set_shed_fraction and the gateway refuses that share
        obs = ControlObservation(step=1, links={}, exposed_comms=0.0,
                                 hidden_comms=0.0, compute_s=0.0,
                                 ef_residual_norm=0.0, grad_norm=0.0,
                                 dc_dense_bytes=0)
        p99 = gw.serving_stats()["p99_s"] or 0.0
        pol = SloPolicy(gw.serving_stats, target_p99_s=max(1e-9, p99 / 2),
                        shed_step=0.5, confirm=1, cooldown=1)
        d = pol.decide(obs)
        slo = d is not None and d.value[0] == "shed" and d.value[1] > 0
        if slo:
            gw.set_shed_fraction(d.value[1])
            reqs = [gw.submit(xs[0]) for _ in range(4)]
            gw.wait_requests(reqs)
            res["slo_shed"] = {"fraction": d.value[1], "shed": sum(
                r.error == "shed" for r in reqs)}
            slo = res["slo_shed"]["shed"] == 2
            gw.set_shed_fraction(0.0)
    finally:
        for closer in (lambda: nsrv.stop(), httpd.shutdown,
                       httpd.server_close, gw.stop, trainer.close,
                       replica_cli.close,
                       lambda: trainer2 and trainer2.close(),
                       lambda: replica_cli2 and replica_cli2.close(),
                       lambda: failover and failover.stop(),
                       srv.stop):
            closer()
        shutil.rmtree(durable_dir, ignore_errors=True)

    def zero_lost(st):
        return (st.get("issued", 0) > 0 and st.get("error", 0) == 0
                and st["issued"] == st["ok"] + st["shed"] + st["error"])

    log(f"serve_mlp: replica o1_applies {res['replica']['o1_applies']}, "
        f"dense_copies {res['replica']['dense_copies']}; delta "
        f"{per_round:.0f} B a round against {dense_bytes} dense; chaos "
        f"p99 {1e3 * chaos_p99:.3f} ms; native honesty "
        f"{res['native_honesty_ratio']}; served vs the plain forward on "
        f"the CPU max abs err {res['cpu_max_abs_err']:.3g}; graphs "
        f"{gw.graph_captures}")
    _gate(res, "bit_exact", res["bit_exact"])
    _gate(res, "delta_only", base_rx > 0 and delta_rx > 0 and honest
          and per_round < 0.5 * dense_bytes)
    _gate(res, "staleness_bounded", max_stale <= cfg.serve_staleness_s)
    _gate(res, "zero_lost", all(zero_lost(s) for s in lanes))
    _gate(res, "chaos_p99_bounded", 0.0 < chaos_p99 < 2.0)
    _gate(res, "no_double_apply", ack["applied_layers"]
          == len(layers) - len(half) and chaos_exact)
    _gate(res, "jit_cache_bounded", res["jit_cache_size"]
          <= len(gw.buckets))
    _gate(res, "batch_bounded", res["batch_max_seen"] <= p["max_batch"])
    _gate(res, "restart_detected", bool(post.get("restart_detected")))
    _gate(res, "slo_shed_decision", slo)
    _gate(res, "prewarm_no_recompile", res["warmup_compiles"] > 0
          and gw.jit_cache_size() == res["warmup_compiles"]
          and (dev.type != "cuda"
               or gw.graph_captures == res["warmup_compiles"]))
    hr = res["native_honesty_ratio"]
    _gate(res, "native_wire_honest", hr is not None and hr <= 1.02
          and res["http"]["qps"] > 0)
    _gate(res, "qps_above_zero", res["serve_qps"] > 0)
    _gate(res, "matches_cpu_forward", res["cpu_max_abs_err"] <= 1e-4)
    res["wall_s"] = time.perf_counter() - t_start
    log(f"serve_mlp wall {res['wall_s']:.1f} s")
    failed = [k for k, v in res["gates"].items() if not v]
    if failed:
        raise AssertionError(f"serve_mlp: gates failed: {failed}")
    return res


def serve_seq_flash_phase(torch, device=None, **over) -> dict:
    """The SeqClassifier at seq_flash's configuration behind the gateway:
    seeded weights published to the registry, every bucket (1, 2, 4, 8)
    captured in warmup; each bucket's replay bit-equal to an eager
    forward through the same kernels on the same weights, and within
    fp32 1e-5 / 1e-4 of the plain forward and of the CPU; native-lane
    load while two delta rounds land, every batch's logits those of the
    round it stamps (no mix); kernel 10's no-lse variant in every replay
    (the graphs' kernel nodes times their replays; a profiler window
    over replays cross-checks on the card); no capture after warmup."""
    import copy
    import threading

    import numpy as np

    from geomx_tpu_torch import ops
    from geomx_tpu_torch.device import resolve_device
    from geomx_tpu_torch.models import SeqClassifier
    from geomx_tpu_torch.serve.gateway import (InferenceGateway,
                                               flatten_params)
    from geomx_tpu_torch.serve.infer_wire import NativeInferenceServer
    from geomx_tpu_torch.serve.registry import (RegistryClient,
                                                RegistryServer)
    from geomx_tpu_torch.serve.replica import ServingReplica
    from geomx_tpu_torch.telemetry.ledger import reset_request_ledger
    p = dict(SERVE_SEQ, **over)
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    L = p["L"]
    rng = np.random.default_rng(p["seed"])
    t_start = time.perf_counter()
    reset_request_ledger()
    mk = dict(max_len=L) if L != 4096 else {}
    model = _seeded_model(torch, SeqClassifier(**mk), p["seed"])
    named, treedef = flatten_params(model)
    srv = RegistryServer().start()
    trainer = RegistryClient(srv.addr, sender=0, timeout_s=30.0)
    rcli = RegistryClient(srv.addr, sender=1, timeout_s=30.0)
    trainer.publish("v1", named)
    replica = ServingReplica("v1", party=1)
    replica.sync(rcli)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    gw = InferenceGateway(replica, treedef=treedef, model=model,
                          max_batch=p["max_batch"], queue_ms=p["queue_ms"],
                          warmup_shapes=[(L,)], warmup=True, device=dev)
    nsrv = None
    res = {"device": str(dev), "seq_len": L, "buckets": None}
    try:
        t0 = time.perf_counter()
        gw.start()
        res["warmup_s"] = time.perf_counter() - t0
        res["buckets"] = list(gw.buckets)
        res["warmup_compiles"] = gw.warmup_compiles
        xs = rng.integers(0, 256, size=(32, L)).astype(np.float32)
        # ---- every bucket: replay == eager, bit for bit; near plain/CPU
        w0 = replica.params()
        per_bucket = {}
        cpu = copy.deepcopy(model).cpu()
        for b in gw.buckets:
            xb = xs[:b]
            fn = gw._forward_fn(b, (L,))
            rep = fn(w0, xb).result().copy()
            eager = gw.eager_forward(w0, xb)
            bit_equal = rep.shape == eager.shape and \
                rep.view(np.int32).tobytes() == eager.view(np.int32).tobytes()
            os.environ["GEOMX_FLASH_ATTN"] = "0"
            try:
                plain = gw.eager_forward(w0, xb)
            finally:
                os.environ.pop("GEOMX_FLASH_ATTN", None)
            plain_err = float(np.abs(rep - plain).max())
            plain_ok = bool(np.allclose(rep, plain, rtol=1e-5, atol=1e-5))
            rec = {"bit_equal_eager": bool(bit_equal),
                   "plain_max_abs_err": plain_err,
                   "plain_within_1e-5": plain_ok}
            if on_card:
                def replay(fn=fn):
                    fn.graph.replay()
                with torch.cuda.stream(gw._stream):
                    rec["replay_ms"] = device_ms(torch, replay, reps=20)
            per_bucket[b] = rec
        # the CPU on two rows (the plain flash version there)
        with torch.inference_mode():
            want = cpu(torch.from_numpy(xs[:2]).to(torch.int32)).numpy()
        got = gw._forward_fn(2, (L,))(w0, xs[:2]).result().copy()
        res["cpu_max_abs_err"] = float(np.abs(got - want).max())
        cpu_ok = bool(np.allclose(got, want, rtol=1e-4, atol=1e-4))
        res["per_bucket"] = {str(b): r for b, r in per_bucket.items()}
        # ---- serve while two delta rounds land ------------------------
        snaps = {0: {k: v.copy() for k, v in replica.params().items()}}
        dense = {k: v.copy() for k, v in named.items()}
        kept = []
        lock = threading.Lock()
        stop = threading.Event()

        def local_load(wid):
            r = np.random.default_rng(3000 + wid)
            while not stop.is_set():
                i = int(r.integers(0, len(xs)))
                req = gw.submit(xs[i])
                if not req.event.wait(60) or req.error is not None:
                    raise AssertionError(f"serve_seq_flash: request "
                                         f"{req.error}")
                with lock:
                    kept.append((i, req.model_round, req.layer_rounds,
                                 req.result.copy()))

        nsrv = NativeInferenceServer(gw, port=0).start()
        loaders = [threading.Thread(target=local_load, args=(w,),
                                    daemon=True) for w in range(2)]
        for t in loaders:
            t.start()
        native = {}
        nthread = threading.Thread(target=lambda: native.update(
            serve_native_load(nsrv.port, xs, p["requests"], p["clients"],
                              1)), daemon=True)
        nthread.start()
        for r in range(1, p["rounds"] + 1):
            with lock:
                seen = len(kept)
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                with lock:
                    if len(kept) >= seen + 4:
                        break
                time.sleep(0.005)
            layers = _random_pairs(rng, dense, p["delta_frac"],
                                   p["delta_std"])
            trainer.push_delta("v1", r, layers)
            replica.sync(rcli)
            snaps[r] = {k: v.copy() for k, v in replica.params().items()}
        with lock:
            seen = len(kept)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            with lock:
                if len(kept) >= seen + 4:
                    break
            time.sleep(0.005)
        nthread.join(120)
        stop.set()
        for t in loaders:
            t.join(60)
        res["native"] = dict(native, fill=_fill(native.get(
            "batch_sizes", []), p["max_batch"]))
        res["native"].pop("batch_sizes", None)
        # ---- every batch's logits are those of the weight set it
        # stamps: each layer at the round the replica held it at when the
        # batch read the params (a refresh lands a layer at a time, so a
        # batch read mid-sync holds some layers at the new round); a
        # batch stamped with a whole round differs from every other
        # round's logits
        order = list(named)
        refs = {}
        for _i, _rnd, lr, _o in kept:
            key = tuple(lr[k] for k in order)
            if key not in refs:
                refs[key] = gw.eager_forward(
                    {k: snaps[r][k] for k, r in zip(order, key)}, xs)
        whole = {r: tuple([r] * len(order)) for r in snaps}
        for key in whole.values():
            if key not in refs:
                refs[key] = gw.eager_forward(
                    {k: snaps[key[0]][k] for k in order}, xs)
        rounds_seen = sorted({rnd for _i, rnd, _lr, _o in kept})
        worst, mixed, partial = 0.0, 0, 0
        first = {}
        for i, rnd, lr, out in kept:
            key = tuple(lr[k] for k in order)
            worst = max(worst, float(np.abs(out - refs[key][i]).max()))
            ok = np.allclose(out, refs[key][i], rtol=1e-5, atol=1e-5)
            if key == whole.get(rnd):
                first.setdefault(rnd, ok)
                ok = ok and all(
                    not np.allclose(out, refs[w][i], rtol=1e-5, atol=1e-5)
                    for r2, w in whole.items() if r2 != rnd)
            else:
                partial += 1
            mixed += not ok
        res["served"] = {"requests": len(kept), "rounds_seen": rounds_seen,
                         "batches_read_mid_refresh": partial,
                         "max_abs_err_to_stamped_set": worst,
                         "first_whole_round_batches_ok": first,
                         "not_the_stamped_set": mixed}
        res["graph_captures"] = gw.graph_captures
        res["launches"] = ops.launch_counts()
        res["variant_launches"] = ops.variant_launch_counts()
        res["graph_launches"] = gw.graph_launches()
        replays = sum(fn.replays for fn in gw._jit_cache.values()) \
            if on_card else 0
        nodes = {k: fn.kernel_nodes.get("flash_attention_fwd_nolse", 0)
                 for k, fn in gw._jit_cache.items()} if on_card else {}
        res["replays"] = replays
        res["nolse_nodes_per_graph"] = {str(k): v for k, v in nodes.items()}
        if on_card:
            from torch.autograd import DeviceType
            from torch.profiler import ProfilerActivity, profile
            fn = gw._forward_fn(gw.buckets[-1], (L,))
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(4):
                    with torch.cuda.stream(gw._stream):
                        fn.graph.replay()
                torch.cuda.synchronize()
            res["profiler_flash_fwd_in_4_replays"] = sum(
                1 for e in prof.events() if e.device_type == DeviceType.CUDA
                and "flash_fwd" in e.name)
            res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    finally:
        if nsrv is not None:
            nsrv.stop()
        gw.stop()
        trainer.close()
        rcli.close()
        srv.stop()
    nat = res.get("native", {})
    log(f"serve_seq_flash: L {L}, buckets {res['buckets']}, warmup "
        f"{res['warmup_s']:.2f} s ({res['warmup_compiles']} graphs), "
        f"native lane {nat.get('qps', 0):.1f} requests/s, p50 "
        f"{1e3 * (nat.get('p50_s') or 0):.3f} ms, p99 "
        f"{1e3 * (nat.get('p99_s') or 0):.3f} ms, fill {nat.get('fill')}; "
        + ", ".join(f"bucket {b}: replay "
                    + (f"{r['replay_ms']:.3f} ms" if "replay_ms" in r
                       else "-")
                    + f", plain err {r['plain_max_abs_err']:.3g}"
                    for b, r in res["per_bucket"].items())
        + f"; CPU err {res['cpu_max_abs_err']:.3g}; served "
        f"{res['served']['requests']} over rounds "
        f"{res['served']['rounds_seen']} "
        f"({res['served']['batches_read_mid_refresh']} read mid-refresh), "
        f"worst err to the stamped weight set "
        f"{res['served']['max_abs_err_to_stamped_set']:.3g}; replays "
        f"{res['replays']}, graph launches {res['graph_launches']}, "
        f"profiler flash_fwd records in 4 replays "
        f"{res.get('profiler_flash_fwd_in_4_replays')}; peak "
        f"{res.get('peak_mem_gb')} GB")
    nb = len(res["buckets"])
    _gate(res, "captured_every_bucket", res["warmup_compiles"] == nb
          and (not on_card or res["graph_captures"] == nb))
    _gate(res, "replay_bit_equal_eager", all(
        r["bit_equal_eager"] for r in res["per_bucket"].values()))
    _gate(res, "replay_within_1e-5_of_plain", all(
        r["plain_within_1e-5"] for r in res["per_bucket"].values()))
    _gate(res, "within_1e-4_of_cpu", cpu_ok)
    _gate(res, "no_mixed_weights", res["served"]["not_the_stamped_set"]
          == 0 and res["served"]["rounds_seen"] == list(
              range(p["rounds"] + 1))
          and all(res["served"]["first_whole_round_batches_ok"].values()))
    _gate(res, "no_capture_after_warmup", gw.jit_cache_size() == nb
          and (not on_card or res["graph_captures"] == nb))
    if on_card:
        _gate(res, "nolse_in_every_replay", res["replays"] > 0
              and all(v == model.num_layers for v in nodes.values())
              and res["graph_launches"].get("flash_attention_fwd_nolse")
              == model.num_layers * res["replays"])
    _gate(res, "native_lane_served", nat.get("ok", 0) == p["requests"]
          and nat.get("error", 1) == 0)
    res["wall_s"] = time.perf_counter() - t_start
    log(f"serve_seq_flash wall {res['wall_s']:.1f} s")
    failed = [k for k, v in res["gates"].items() if not v]
    if failed:
        raise AssertionError(f"serve_seq_flash: gates failed: {failed}")
    return res


# the device-mesh phases: phase -> (a path of PATHS, steps, its runs).  A
# run is (GeoConfig fields over the path's, the kernels it must launch in
# every slot; None: the path's); each run is a meshed trainer at the
# path's [P, W] beside a stacked twin on the first card.  The steps are
# the fewest that reach the path's events (a MixedSync pull at step 2,
# HFA's first dc milestone at step 8, the pipeline's warm-up and drain),
# never fewer than 4 (the first three are held to 4 for the script's
# time limit)
MESH_PATHS = {
    "mesh_fsa": ("flagship", 4, (({}, None),)),
    "mesh_fused_sgd": ("fused_sgd", 4, (({}, None),)),
    "mesh_zero": ("zero_sgd", 4, (({}, None),)),
    "mesh_twobit_adam": ("twobit_adam", 4, (({}, None),)),
    "mesh_sparse_agg": ("sparse_agg", 4, (({}, None),)),
    "mesh_mixed_dcasgd": ("mixed_dcasgd", 4, (({}, None),)),
    "mesh_hfa_dgt": ("hfa_dgt", 8, (({}, None),)),
    "mesh_pipelined_fsa": ("pipelined_fsa", 4, (({}, None),)),
    "mesh_zero_pipelined_adam": ("zero_pipelined_adam", 4, (({}, None),)),
    "mesh_multigps_bsc": ("multigps_bsc", 4, (({}, None),)),
    # the flagship with the FP16 gather, then MPQ (ResNet-20's one
    # 272,512-element bucket is above MPQ's 200,000 bound: the BSC route)
    "mesh_fp16_mpq": ("flagship", 4, (
        (dict(compression="fp16"), ("fused_flatten", "fused_unflatten")),
        (dict(compression="mpq,0.01"), SLICE1))),
}
# the phases whose loss must fall over their steps (the mean of the last
# half below the first half's); the others are held to their twin
MESH_LOSS_FALLS = ("mesh_fsa", "mesh_fused_sgd", "mesh_zero")
# every mesh run trains on the first batches of one synthetic set of 8
# steps' images, made once a batch size
_MESH_DATA: dict = {}
# a slot's wait at a collective before the step fails (the first step
# pays cuDNN's set-up on every card)
MESH_TIMEOUT_S = 120.0


def mesh_devices(torch, slots: int) -> list:
    """One device a slot: round-robin over the cards when there are two
    or more, every slot on cuda:0 on one card."""
    n = torch.cuda.device_count()
    return [torch.device("cuda", i % n) for i in range(slots)]


def _sync_all(torch, devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _state_diff(torch, a, b) -> list:
    """The tensor paths where two TrainStates' bits differ."""
    diff = [k for (k, u), (_, v) in zip(tensors(torch, dataclasses.asdict(a)),
                                        tensors(torch, dataclasses.asdict(b)))
            if u.shape != v.shape or not torch.equal(bits(torch, u),
                                                     bits(torch, v))]
    return diff + (["step"] if a.step != b.step else [])


def _slot_gate(name: str, what: str, twin_n: dict, slots: dict,
               nslots: int) -> None:
    """Every slot launched every kernel as many times as the twin did."""
    from geomx_tpu_torch.ops import KERNELS
    for slot in slots:
        bad = {k: (slots[slot].get(k, 0), twin_n[k]) for k in KERNELS
               if slots[slot].get(k, 0) != twin_n[k]}
        if bad:
            raise AssertionError(f"{name}: {what}: slot {slot} launched "
                                 f"{bad} (slot, twin)")
    if any(twin_n.values()) and len(slots) != nslots:
        raise AssertionError(f"{name}: {what}: {len(slots)} slots launched "
                             f"kernels of {nslots}")


def mesh_run(torch, name: str, path: str, steps: int, fields: dict,
             kernels, devices, batch: int) -> dict:
    """One run of a mesh phase (mesh_phase)."""
    from geomx_tpu_torch import HiPSTopology, ops
    from geomx_tpu_torch.data import load_dataset
    from geomx_tpu_torch.models import get_model

    P, W = PATHS[path][6]
    kernels = PATHS[path][5] if kernels is None else kernels
    mesh = HiPSTopology(P, W).build_mesh(devices, timeout_s=MESH_TIMEOUT_S)
    first = mesh.first_device
    on_card = first.type == "cuda"
    cards = mesh.distinct_devices()
    if batch not in _MESH_DATA:
        _MESH_DATA[batch] = load_dataset("synthetic",
                                         synthetic_train_n=8 * batch * 8)
    data = _MESH_DATA[batch]
    t_run = time.perf_counter()
    twin = make_trainer(path, get_model("resnet20"), device=first, **fields)
    meshed = make_trainer(path, get_model("resnet20"), mesh=mesh, **fields)
    tstate, mstate = twin.init_state(seed=0), meshed.init_state(seed=0)
    loader = twin.make_loader(data["train_x"], data["train_y"], batch)
    batches = list(loader.epoch(0))[:steps]
    if len(batches) < steps:
        raise AssertionError(f"{name}: {len(batches)} batches for "
                             f"{steps} steps")
    losses, twin_losses, mesh_ms, twin_ms = [], [], [], []
    totals = {}  # (p, w) -> {kernel: launches over the run}
    slot00 = []  # slot (0, 0)'s launches a step
    if on_card:
        for d in cards:
            torch.cuda.reset_peak_memory_stats(d)

    def timed(fn, times):
        _sync_all(torch, cards)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        _sync_all(torch, cards)
        times.append(1e3 * (time.perf_counter() - t0))
        return out

    def compare(what: str):
        diff = _state_diff(torch, meshed.mesh.gather(mstate), tstate)
        if diff:
            raise AssertionError(
                f"{name}: {what}: the meshed state differs from the "
                f"stacked twin's at {diff[:5]} ({len(diff)} tensors)")

    def launches(what: str, twin_n: dict):
        slots = ops.slot_launch_counts()
        if on_card:
            _slot_gate(name, what, twin_n, slots, P * W)
        for slot, counts in slots.items():
            tot = totals.setdefault(slot, {})
            for k, n in counts.items():
                tot[k] = tot.get(k, 0) + n
        slot00.append({k: n for k, n in slots.get((0, 0), {}).items() if n})

    for i, (xb, yb) in enumerate(batches):
        tstate, tm = timed(lambda: twin.train_step(tstate, xb, yb), twin_ms)
        twin_n = ops.launch_counts()
        mstate, mm = timed(lambda: meshed.train_step(mstate, xb, yb),
                           mesh_ms)
        launches(f"step {i + 1}", twin_n)
        losses.append(float(mm["loss"]))
        twin_losses.append(float(tm["loss"]))
        if losses[-1] != twin_losses[-1] or \
                float(mm["accuracy"]) != float(tm["accuracy"]):
            raise AssertionError(f"{name}: step {i + 1}: loss {losses[-1]} "
                                 f"/ {twin_losses[-1]}, accuracy "
                                 f"{float(mm['accuracy'])} / "
                                 f"{float(tm['accuracy'])} (meshed / twin)")
        compare(f"step {i + 1}")
    drained = hasattr(twin.sync, "drain_grads")
    drain_ms = []
    if drained:
        tstate = timed(lambda: twin.drain_pipeline(tstate), drain_ms)
        twin_n = ops.launch_counts()
        mstate = timed(lambda: meshed.drain_pipeline(mstate), drain_ms)
        launches("the drain", twin_n)
        compare("the drain")
    peak = {str(d): torch.cuda.max_memory_allocated(d)
            for d in cards} if on_card else None
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{name}: non-finite loss: {losses}")
    if on_card:
        if len(totals) != P * W:
            raise AssertionError(f"{name}: {len(totals)} slots launched "
                                 f"kernels of {P * W}")
        for slot, tot in totals.items():
            missing = [k for k in kernels if tot.get(k, 0) < 1]
            if missing:
                raise AssertionError(f"{name}: slot {slot} never launched "
                                     f"{missing} of {kernels}")
    # the optimizer state each device holds, and the twin's a replica
    opt_by_device = {}
    for p, w, d in mesh.slots():
        opt_by_device[str(d)] = opt_by_device.get(str(d), 0) + state_bytes(
            torch, mstate.slot(p, w).opt_state)
    # a slot made to raise: slot (1, 1) gets a batch with 2 channels
    x_bad = mesh.place(batches[0][0])
    x_bad.slots[W + 1] = x_bad.slots[W + 1][..., :2].contiguous()
    t0 = time.perf_counter()
    try:
        meshed.train_step(mstate, x_bad, batches[0][1])
    except RuntimeError as e:
        fail_s = time.perf_counter() - t0
        if "waited" in str(e) or fail_s >= MESH_TIMEOUT_S:
            raise AssertionError(f"{name}: the failing slot's step hung "
                                 f"({fail_s:.1f} s): {e}") from e
        fail_msg = str(e).splitlines()[0]
    else:
        raise AssertionError(f"{name}: a slot fed a malformed batch did "
                             "not fail the step")
    warm = 1  # the first step pays cuDNN's set-up
    return dict(
        path=path, fields=fields, shape=[P, W], steps=steps, losses=losses,
        step_ms_median=statistics.median(mesh_ms[warm:]),
        stacked_step_ms_median=statistics.median(twin_ms[warm:]),
        step_ms=mesh_ms, stacked_step_ms=twin_ms,
        drain_ms=drain_ms if drained else None,
        slot00_launches_per_step=slot00,
        launches_per_slot={f"{p},{w}": tot for (p, w), tot in
                           sorted(totals.items())},
        peak_mem_bytes=peak, opt_state_bytes_by_device=opt_by_device,
        opt_state_bytes_per_slot=state_bytes(torch,
                                             mstate.slots[0].opt_state),
        stacked_opt_state_bytes_per_replica=state_bytes(
            torch, tstate.opt_state) / (P * W),
        fail_s=fail_s, fail_error=fail_msg,
        wall_s=time.perf_counter() - t_run)


def mesh_phase(torch, name: str, device=None, batch: int = 128) -> dict:
    """One phase of MESH_PATHS on a device mesh, ResNet-20 at full width,
    ``batch`` a replica, cuDNN deterministic, each run beside a stacked
    twin on the first device from the same seed and batches: after every
    step, and after the drain where the sync has one, the meshed state
    (gathered), the loss and the accuracy are bit-equal to the twin's;
    the loss is finite (and falls, MESH_LOSS_FALLS); each slot launches
    every kernel as many times a step (and a drain) as the twin does in
    its step, and each kernel of the run at least once over it; then a
    slot fed a malformed batch fails the step with its own error.
    Recorded: meshed and stacked step ms, peak memory by device, per-slot
    launches, the optimizer-state bytes by device and the phase's wall.
    ``device="cpu"`` runs the slots on repeated CPU slots (the plain
    kernels; no launch gate)."""
    path, steps, runs = MESH_PATHS[name]
    P, W = PATHS[path][6]
    if device is None:
        devices = mesh_devices(torch, P * W)
    else:
        devices = [torch.device(device)] * (P * W)
    cards = list(dict.fromkeys(devices))
    log(f"{name}: slots on {[str(d) for d in devices]} "
        + (f"({len(cards)} cards)" if len(cards) > 1 else
           f"(one device, every slot on {devices[0]}: not a cross-device "
           "run)"))
    t0 = time.perf_counter()
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic
    cudnn.deterministic = True
    try:
        results = [mesh_run(torch, name, path, steps, fields, kernels,
                            devices, batch) for fields, kernels in runs]
    finally:
        cudnn.deterministic = saved
    for r in results:
        losses = r["losses"]
        half = steps // 2
        if name in MESH_LOSS_FALLS and not (
                statistics.mean(losses[half:]) <
                statistics.mean(losses[:half])):
            raise AssertionError(f"{name}: loss did not fall: {losses}")
        log(f"{name} ({path}{' ' + str(r['fields']) if r['fields'] else ''}"
            f" on the [{P}, {W}] mesh): {steps} steps, loss {losses[0]:.4f}"
            f" -> {losses[-1]:.4f}, the state bit-equal to the stacked "
            f"twin's after every step"
            + (" and the drain" if r["drain_ms"] else "")
            + f"; step {r['step_ms_median']:.2f} ms meshed vs "
            f"{r['stacked_step_ms_median']:.2f} ms stacked (medians of "
            f"steps 2-{steps}); slot (0, 0)'s launches a step "
            f"{r['slot00_launches_per_step']} (every slot's = the twin's); "
            f"peak memory {r['peak_mem_bytes']}; optimizer state by device "
            f"{r['opt_state_bytes_by_device']} "
            f"({r['opt_state_bytes_per_slot']} B a slot, the stacked "
            f"twin's {r['stacked_opt_state_bytes_per_replica']:.0f} B a "
            f"replica); a slot fed a malformed batch failed the step in "
            f"{r['fail_s']:.3f} s: {r['fail_error']}; run wall "
            f"{r['wall_s']:.1f} s")
    res = dict(results[0]) if len(results) == 1 else dict(
        path=path, runs=results,
        step_ms_median=max(r["step_ms_median"] for r in results),
        stacked_step_ms_median=max(r["stacked_step_ms_median"]
                                   for r in results))
    res.update(slots=[str(d) for d in devices], cards=len(cards),
               wall_s=time.perf_counter() - t0)
    log(f"{name}: phase wall {res['wall_s']:.1f} s")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every number to this JSON file")
    ap.add_argument("--steps", type=int, default=16,
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
                  "alexnet_fused_adam": alexnet_phase,
                  **{p: lambda t, p=p: resilience_phase(t, p)
                     for p in RESILIENCE_PATHS}}
    paths = {path: zoo_phases[path](torch) if path in zoo_phases
             else main_path_phase(torch, path, cfg[4] or args.steps)
             for path, cfg in PATHS.items()}
    paths.update({path: seq_path_phase(torch, path) for path in SEQ_PATHS})
    meshes = {name: mesh_phase(torch, name) for name in MESH_PATHS}
    telemetry = telemetry_phase(torch)
    audit = audit_fsa_phase(torch)
    control = {"control_fsa": control_fsa_phase(torch),
               "control_replay": control_replay_phase(torch)}
    host = {path: dist_ps_phase(torch, path) for path in DIST_PS}
    host["fleetscope_sched"] = fleetscope_sched_phase(torch)
    log(f"fleetscope_sched wall {host['fleetscope_sched']['wall_s']:.1f} s "
        f"vs dist_ps_mixed_sched "
        f"{host['dist_ps_mixed_sched']['wall_s']:.1f} s (this call)")
    host["host_plane_resnet20"] = host_plane_phase(torch)
    host["ledger_host_plane"] = ledger_phase(torch)
    host["manyparty_sharded"] = manyparty_phase(torch)
    host["kvstore_hips"] = kvstore_phase(torch)
    host["durable_recovery"] = durable_recovery_phase(torch)
    examples = {f"long_context_{mode}": long_context_phase(torch, mode)
                for mode in ("ring", "ulysses")}
    serving = {"serve_mlp": serve_mlp_phase(torch),
               "serve_seq_flash": serve_seq_flash_phase(torch)}
    log("median step: " + ", ".join(
        f"{p} {r['step_ms_median']:.2f} ms" for p, r in paths.items())
        + ", on the mesh: " + ", ".join(
            f"{n} {r['step_ms_median']:.2f} ms (stacked twin "
            f"{r['stacked_step_ms_median']:.2f})" for n, r in meshes.items())
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
                       "paths": paths, "mesh": meshes,
                       "telemetry_fsa": telemetry,
                       "audit_fsa": audit,
                       "control": control,
                       "host_plane": host,
                       "examples": examples, "serving": serving,
                       "wall_s": time.perf_counter() - t_start}, f, indent=1)
    log(f"wall: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
