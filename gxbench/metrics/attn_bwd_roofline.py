"""Percent of its bound that the flash attention backward reaches
(kernels 11 and 12, ``flash_dq_kernel`` and ``flash_dkv_kernel``
together), over the profiled steps.

Useful operations 8 B H L^2 D a call (dV, dP, dQ, dK; the recomputed
scores not counted), bytes from shapes: Q, K, V, dO, the logsumexp and
the row sums of dO O (each ``[B, H, L]``) read, dQ, dK, dV written, all
float32; a call a layer a replica a step.  The bound is the larger of the
operations over the card's TF32 peak and the bytes over its memory
bandwidth; the share is the bound over the kernels' device time."""


def read(run):
    cfg, wl = run.config, run.workload
    if run.peak is None or "num_heads" not in cfg:
        return None
    P, W = wl["topology"]
    B, L = wl["batch_per_replica"], wl["data"]["x"]["sample_shape"][0]
    H = cfg["num_heads"]
    D = cfg["dim"] // H
    calls = cfg["num_layers"] * P * W
    flops = 8.0 * B * H * L * L * D
    nbytes = 4.0 * (7 * B * L * H * D + 2 * B * H * L)
    tr = run.out.trace
    us, count = tr.op_us(lambda name: "flash_dq_kernel" in name
                         or "flash_dkv_kernel" in name)
    if count == 0:
        return None
    bound_s = calls * tr.steps * max(flops / run.peak["tf32_flops"],
                                     nbytes / run.peak["hbm_bytes_per_s"])
    return 100.0 * bound_s / (us / 1e6)
