"""Structural assertions about a path's ops (port of
geomx_tpu/analysis/hlo.py).

The name is kept so a reader finds the counterpart; nothing here reads
HLO.  The JAX module cross-lowers a function for the TPU and counts the
stablehlo ops that materialize a dense intermediate.  The port records
the function (``analysis/record.py``) and counts the ATen ops that do:
the ``MATERIALIZING_OPS`` below, in-place forms included.  The fused
path replaces them with hand-written kernel launches, which no record
sees and which the counts carry as ``kernel_launches`` (from the
wrappers' launch counters, ``geomx_tpu_torch.ops``).

Cross-lowering for the TPU (``lower_text``) has no counterpart
(``NOT_PORTABLE``).  On the CPU every wrapper runs its plain version, so
the fused-versus-plain verdict shows only on CUDA tensors
(``chip_smoke.py``'s ``audit_fsa`` phase).
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

from geomx_tpu_torch.analysis.record import ProgramRecord, record_program

# ATen ops that materialize an intermediate in the plain compression
# paths: scatter/sort/gather for the select chain, cat/index_put/
# slice_scatter for the bucket (un)flatten, cumsum for the rank scans
MATERIALIZING_OPS = ("scatter", "scatter_add", "scatter_reduce", "sort",
                     "gather", "index_select", "cat", "index_put",
                     "slice_scatter", "cumsum")


def count_ops(record: ProgramRecord, ops: Sequence[str]) -> Dict[str, int]:
    """Occurrences of each ATen op name among ``record``'s events (an
    in-place form counts as its op); zero-count ops are omitted."""
    want = set(ops)
    counts: Dict[str, int] = {}
    for site in record.events:
        name = site.primitive.rstrip("_")
        if site.kind == "aten" and name in want:
            counts[name] = counts.get(name, 0) + 1
    return counts


def materialization_counts(fn: Callable, *args, extra_ops=()) -> Dict[str, int]:
    """Record ``fn(*args)`` and count its materializing ATen ops;
    ``total`` sums them and ``kernel_launches`` counts the hand-written
    kernel launches the call made."""
    from geomx_tpu_torch import ops as kernel_ops
    before = sum(kernel_ops.launch_counts().values())
    rec = record_program(fn, *args)
    launched = sum(kernel_ops.launch_counts().values()) - before
    counts = count_ops(rec, tuple(MATERIALIZING_OPS) + tuple(extra_ops))
    counts["total"] = sum(counts.values())
    counts["kernel_launches"] = launched
    return counts


def hlo_verdict(unfused: Dict[str, int], fused: Dict[str, int],
                dense_ops: Sequence[str]) -> dict:
    """The structural acceptance check: the ops that write a dense
    intermediate on the plain path are GONE (not just fewer) from the
    fused one.  ``total``/``kernel_launches`` ride along."""
    du = sum(unfused.get(o, 0) for o in dense_ops)
    df = sum(fused.get(o, 0) for o in dense_ops)
    return {"unfused": unfused, "fused": fused,
            "dense_ops": list(dense_ops), "dense_unfused": du,
            "dense_fused": df,
            "dense_intermediates_removed": bool(df == 0 and du > 0)}


def compare_paths(unfused_fn: Callable, fused_fn: Callable, *args,
                  dense_ops: Sequence[str], extra_ops=()) -> dict:
    """One-call form of the fused-vs-plain comparison: record both paths
    on identical arguments and return :func:`hlo_verdict`."""
    return hlo_verdict(
        materialization_counts(unfused_fn, *args, extra_ops=extra_ops),
        materialization_counts(fused_fn, *args, extra_ops=extra_ops),
        dense_ops)


def assert_dense_intermediates_removed(verdict: dict,
                                       min_custom_calls: int = 1) -> dict:
    """Raise AssertionError (with the full verdict) unless the fused
    path removed every dense op and launched at least
    ``min_custom_calls`` hand-written kernels."""
    if not verdict.get("dense_intermediates_removed"):
        raise AssertionError(
            f"dense intermediates NOT removed from the fused path: "
            f"{verdict}")
    calls = verdict.get("fused", {}).get("kernel_launches", 0)
    if calls < min_custom_calls:
        raise AssertionError(
            f"fused path made {calls} kernel launch(es), expected >= "
            f"{min_custom_calls}: {verdict}")
    return verdict


def assert_ops_absent(fn: Callable, *args, ops: Sequence[str]) -> None:
    """Assert none of ``ops`` (ATen op names) runs in ``fn(*args)``."""
    present = count_ops(record_program(fn, *args), ops)
    if present:
        raise AssertionError(
            f"ops expected ABSENT from the recorded path are present: "
            f"{present}")
