"""Percent of their bound that the Bi-Sparse kernels reach: kernel 3
(``select_pack_kernel``) and kernel 4 (``scatter_add_kernel``) of
``csrc/bsc.cu`` together, over the profiled steps.

Bytes from shapes, each input byte read once and each output byte
written once, a bucket of ``n`` elements with ``k = ceil(ratio n)`` slots
on ``R = P W`` replica rows: select/pack reads g, u, v and the boundary
and writes u, v and the ``k`` values and indices; the scatter-add reads
the ``P k`` gathered values and indices and writes the dense row.  The
bound is those bytes over the card's memory bandwidth; the share is the
bound over the kernels' device time."""

import math


def _ratio(spec):
    parts = spec.split(",")
    return float(parts[1]) if parts[0] == "bsc" else None


def read(run):
    ratio = _ratio(run.workload["dc_compression"])
    if ratio is None or run.peak is None:
        return None
    P, W = run.workload["topology"]
    R, f4 = P * W, 4
    per_step = 0
    for n in run.bucket_sizes:
        k = max(1, math.ceil(n * ratio))
        per_step += R * f4 * (3 * n + 1 + 2 * n + 2 * k)     # select/pack
        per_step += R * f4 * (2 * P * k + n)                 # scatter-add
    tr = run.out.trace
    us, count = tr.op_us(lambda name: "select_pack_kernel" in name
                         or ("scatter_add_kernel" in name
                             and "at::" not in name))
    if count == 0:
        return None
    bound_s = per_step * tr.steps / run.peak["hbm_bytes_per_s"]
    return 100.0 * bound_s / (us / 1e6)
