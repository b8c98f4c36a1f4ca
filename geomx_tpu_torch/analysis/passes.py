"""The Graft Auditor's pass catalog (port of geomx_tpu/analysis/passes.py),
over recorded programs (``analysis/record.py``).

Rule ids:

- ``GX-COLLECTIVE-001``  cross-program collective-signature divergence
  (would deadlock or silently diverge a multi-party mesh at run time)
- ``GX-COLLECTIVE-002``  a membership swap changed the collective program
  (the ``Trainer.apply_membership`` boundary)
- ``GX-DTYPE-001``       fp32 compute op on a declared-16-bit path
- ``GX-DTYPE-002``       wire-dtype accounting mismatch: the bytes the
  recorded collectives move disagree with ``Compressor.wire_bytes``
- ``GX-PURITY-001``      a dense(-sized) payload crosses the wire on a
  compressed dc path, or the merge densifies per party after the final
  collective

``GX-DONATE-001``/``-002`` (donation and ``input_output_aliases``) have
no form here: an eager step returns fresh tensors and the caching
allocator reuses freed blocks (``NOT_PORTABLE`` in
``analysis/__init__.py``).  Nor has ``axis_index_groups``: no port
collective takes subgroups, so the consistency pass has no warning
branch.

The compressor audits record the compressor's all-reduce over
``[num_parties, 1]`` stacks of the given parameters on the CPU (where
every kernel wrapper runs its plain version); a record's collective
operands are per replica, its ATen outputs whole tensors, which the
purity rule divides by the replica count.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from geomx_tpu_torch.analysis.core import (AuditContext, AuditPass, Finding,
                                           walk_program)
from geomx_tpu_torch.analysis.record import (DENSIFY_OPS, ProgramRecord,
                                             record_program, sig_bytes)
from geomx_tpu_torch.topology import DC_AXIS

# the collective primitives the JAX package's signature carries (pmax,
# which the sparse-agg lattice's scale negotiation runs, is not one)
COLLECTIVE_PRIMS = frozenset({
    "psum", "psum2", "all_gather", "all_gather_invariant", "all_to_all",
    "ppermute", "pbroadcast", "psum_scatter", "reduce_scatter"})

# ATen ops that materialize a full-size intermediate when they appear
# dense-shaped (the scatter/cumsum/sort chains the fused kernels remove)
DENSE_MATERIALIZING_PRIMS = DENSIFY_OPS | frozenset({
    "cumsum", "cumprod", "cummax", "cummin", "logcumsumexp", "sort"})

# the heavy compute ops the dtype-flow leak rule inspects
_HEAVY_COMPUTE_OPS = frozenset({"mm", "addmm", "bmm", "baddbmm",
                                "convolution"})


def _is_collective(site) -> bool:
    return site.kind == "collective" and site.primitive in COLLECTIVE_PRIMS


# ---------------------------------------------------------------------------
# collective-consistency
# ---------------------------------------------------------------------------

def count_collectives(record: ProgramRecord,
                      axis: Optional[str] = None) -> int:
    """Number of collective calls in a recorded program, optionally
    restricted to those over the named ``axis``."""
    return sum(1 for site in walk_program(record) if _is_collective(site)
               and (axis is None or axis in site.axes))


def collective_signature(record: ProgramRecord) -> Tuple[tuple, ...]:
    """The ordered named-axis collective signature of a recorded program:
    one ``(op, axes, (shape, dtype), extras)`` entry per collective
    operand, in walk order, the per-replica shape as a jaxpr carries the
    per-device one.  Two programs whose signatures differ cannot safely
    share a mesh — the first differing entry deadlocks (count/op
    mismatch) or silently mis-aggregates (shape/dtype/routing mismatch).
    ``extras`` carries the routing that changes peer pairing
    (``ppermute``'s ``perm``)."""
    sig = []
    for site in walk_program(record):
        if not _is_collective(site):
            continue
        for operand in site.operands:
            sig.append((site.primitive, site.axes, operand, site.extras))
    return tuple(sig)


def diff_collective_signatures(
        sigs: Mapping[str, tuple],
        rule_id: str = "GX-COLLECTIVE-001") -> List[Finding]:
    """Diff named collective signatures pairwise against the first
    entry; one finding per divergent party naming the first differing
    position (op/axes/operands or a missing/extra collective)."""
    findings: List[Finding] = []
    items = list(sigs.items())
    if len(items) < 2:
        return findings
    ref_name, ref = items[0]
    for name, sig in items[1:]:
        if sig == ref:
            continue
        pos = next((i for i, (a, b) in enumerate(zip(ref, sig)) if a != b),
                   min(len(ref), len(sig)))
        a = ref[pos] if pos < len(ref) else None
        b = sig[pos] if pos < len(sig) else None
        findings.append(Finding(
            rule_id=rule_id, severity="error",
            message=(f"collective sequence diverges between {ref_name!r} "
                     f"({len(ref)} collectives) and {name!r} ({len(sig)}) "
                     f"at position {pos}: {a} vs {b} — this program pair "
                     "deadlocks or silently diverges on a shared mesh"),
            detail={"parties": [ref_name, name], "position": pos,
                    "reference": a, "divergent": b}))
    return findings


def audit_cross_party(configs: Mapping[str, Any],
                      build: Optional[Callable[[Any], Any]] = None,
                      rule_id: str = "GX-COLLECTIVE-001") -> List[Finding]:
    """Diff the collective signature of a step program across party
    configurations.  ``configs`` maps a party label to a
    :class:`ProgramRecord`, a signature tuple, a zero-arg callable
    returning either, or — with ``build`` given — an opaque config
    object ``build`` turns into one.  Empty result = every party runs
    the same collective program."""
    sigs: Dict[str, tuple] = {}
    for name, cfg in configs.items():
        if build is not None:
            rec = build(cfg)
        elif callable(cfg):
            rec = cfg()
        else:
            rec = cfg
        sigs[name] = rec if isinstance(rec, tuple) \
            else collective_signature(rec)
    return diff_collective_signatures(sigs, rule_id=rule_id)


class CollectiveConsistencyPass(AuditPass):
    """Single-program form: record the signature into ``ctx.extras`` for
    cross-program diffing by the caller.  The JAX pass also warns on
    ``axis_index_groups``; no port collective takes subgroups, so this
    one finds nothing by itself."""

    rule_id = "GX-COLLECTIVE-001"

    def run(self, record: ProgramRecord, ctx: AuditContext) -> List[Finding]:
        ctx.extras["collective_signature"] = collective_signature(record)
        return []


# ---------------------------------------------------------------------------
# dtype-flow
# ---------------------------------------------------------------------------

class DtypeFlowPass(AuditPass):
    """GX-DTYPE-001: fp32 heavy-compute ops (``mm``/``addmm``/``bmm``/
    ``convolution``) on a path that declares 16-bit compute
    (``ctx.compute_dtype`` of "bfloat16" or "float16")."""

    rule_id = "GX-DTYPE-001"

    def run(self, record: ProgramRecord, ctx: AuditContext) -> List[Finding]:
        declared = ctx.compute_dtype
        if declared not in ("bfloat16", "float16"):
            return []
        findings: List[Finding] = []
        for site in walk_program(record):
            if site.kind != "aten" or site.primitive not in _HEAVY_COMPUTE_OPS:
                continue
            op_dtypes = {dtype for _shape, dtype in site.operands}
            if "float32" in op_dtypes or "float64" in op_dtypes:
                findings.append(self.finding(
                    f"{site.primitive} computes in "
                    f"{sorted(op_dtypes & {'float32', 'float64'})} on a "
                    f"declared-{declared} path (fp32 leak)",
                    site=site,
                    detail={"operand_dtypes": sorted(op_dtypes)}))
        return findings


def audit_dtype_flow(fn: Callable, *args,
                     compute_dtype: str = "bfloat16") -> List[Finding]:
    """Record ``fn`` and run the fp32-leak rule against the declared
    compute dtype."""
    return DtypeFlowPass().run(record_program(fn, *args),
                               AuditContext(compute_dtype=compute_dtype))


def audit_precision(fn: Callable, *args, precision: str = "bf16",
                    allowed_fp32_sites: int = 0) -> List[Finding]:
    """GX-DTYPE-001 for ``GEOMX_PRECISION``: audit a forward/loss closure
    built for ``precision``.  ``allowed_fp32_sites`` drops that many
    trailing findings (the zoo's fp32 classifier head, the last heavy op
    of the forward); ``precision="fp32"`` always returns []."""
    if str(precision).lower() in ("fp32", "float32", "f32"):
        return []
    findings = audit_dtype_flow(fn, *args, compute_dtype="bfloat16")
    if allowed_fp32_sites > 0:
        findings = findings[:-allowed_fp32_sites] \
            if len(findings) > allowed_fp32_sites else []
    return findings


# ---------------------------------------------------------------------------
# wire accounting
# ---------------------------------------------------------------------------

def _leaf(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


def _as_tree(params) -> dict:
    """A flat dict of tensors from a dict, a list (in its order) or one
    array."""
    if isinstance(params, dict):
        return {k: _leaf(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return {f"{i:04d}": _leaf(p) for i, p in enumerate(params)}
    return {"w": _leaf(params)}


def stack_parties(params, num_parties: int) -> dict:
    """The parameters as ``[num_parties, 1, *shape]`` CPU tensors: one
    replica a party, as the JAX audit's dc mesh holds them."""
    return {k: v.detach().to("cpu").expand(
        (num_parties, 1) + tuple(v.shape)).clone()
        for k, v in _as_tree(params).items()}


def _recorded_allreduce(compressor, params, num_parties: int = 2):
    """Record ``compressor.allreduce`` over ``[num_parties, 1]`` stacks
    of ``params`` (the shared harness of the wire and purity audits);
    returns ``(record, stacked params)``."""
    grads = stack_parties(params, num_parties)
    state = compressor.init_state(grads)
    rec = record_program(compressor.allreduce, grads, state, DC_AXIS,
                         num_parties)
    return rec, grads


# scatter-family collectives whose per-chip bytes differ from the
# operand-once convention
_SCATTER_PRIMS = frozenset({"psum_scatter", "reduce_scatter"})
_GATHER_PRIMS = frozenset({"all_gather", "all_gather_invariant"})


def collective_wire_bytes(record: ProgramRecord,
                          convention: str = "per_chip") -> int:
    """Bytes one participant puts on the wire per run of the recorded
    program, summed over its collectives' operands.

    ``convention="per_chip"`` (default) counts physical bytes: a
    ``psum``'s operand once; a ``reduce_scatter`` ``(N-1)/N`` of its
    full-size operand (the chip keeps its own shard); an ``all_gather``
    its shard ``(N-1)`` times.  ``N`` is the axis size the call ran
    over.  ``convention="payload"`` counts every operand once — the
    N-independent per-party contribution ``Compressor.wire_bytes``
    declares."""
    if convention not in ("per_chip", "payload"):
        raise ValueError(f"unknown wire-byte convention {convention!r}")
    total = 0.0
    for site in walk_program(record):
        if not _is_collective(site):
            continue
        opb = sum(sig_bytes(o) for o in site.operands)
        n = site.axis_size
        if convention == "payload":
            total += opb
        elif n and site.primitive in _SCATTER_PRIMS:
            total += opb * (n - 1) / n
        elif n and site.primitive in _GATHER_PRIMS:
            total += opb * (n - 1)
        else:
            total += opb
    return int(round(total))


def audit_wire_accounting(compressor, params, num_parties: int = 2,
                          rel_tol: float = 0.01,
                          abs_tol: int = 512) -> List[Finding]:
    """GX-DTYPE-002: diff ``compressor.wire_bytes`` (of the stacked
    parameters) against the payload-convention bytes the recorded dc-tier
    collectives carry.  Tolerances absorb lane padding and rounding."""
    rec, grads = _recorded_allreduce(compressor, params, num_parties)
    traced = collective_wire_bytes(rec, convention="payload")
    declared = int(compressor.wire_bytes(grads))
    gap = abs(traced - declared)
    if gap <= abs_tol or gap <= rel_tol * max(traced, declared):
        return []
    return [Finding(
        rule_id="GX-DTYPE-002", severity="error",
        message=(f"wire accounting mismatch for compressor "
                 f"{compressor.name!r}: wire_bytes() declares {declared} "
                 f"B/party/step but the traced collectives carry "
                 f"{traced} B ({gap} B apart)"),
        detail={"declared": declared, "traced": traced,
                "compressor": compressor.name})]


# ---------------------------------------------------------------------------
# compressed-path purity
# ---------------------------------------------------------------------------

class PurityPass(AuditPass):
    """GX-PURITY-001, both sides of the compressed dc path:

    - *compress-before-collective*: a collective operand whose per-replica
      byte size reaches ``ctx.dense_bytes`` (the dense fp32 footprint of
      the largest bucket/leaf) means a dense intermediate crossed
      select/pack and the collective;
    - *merge-without-densify*: after the FINAL collective, the merged
      stream may densify at most
      ``ctx.extras["allowed_dense_after_collective"]`` (default 1)
      buffers.  A densifying op (``scatter``, ``scatter_add``,
      ``index_add``, ``index_put``) counts once per buffer it writes with
      a dense-size share per replica (``ctx.extras["replicas"]`` rows,
      default 1): an in-place fold of the parties' runs into one buffer
      is one materialization, a per-party densify-then-sum is one a
      party.

    The hand-written kernels are not in the record, so on the card only
    the plain ops around them are inspected."""

    rule_id = "GX-PURITY-001"

    def run(self, record: ProgramRecord, ctx: AuditContext) -> List[Finding]:
        dense = ctx.dense_bytes
        if not dense:
            return []
        findings: List[Finding] = []
        sites = list(walk_program(record))
        last_collective = -1
        for i, site in enumerate(sites):
            if not _is_collective(site):
                continue
            last_collective = i
            for shape, dtype in site.operands:
                nbytes = sig_bytes((shape, dtype))
                if nbytes >= dense:
                    findings.append(self.finding(
                        f"{site.primitive} puts a dense-size operand "
                        f"({shape} {dtype}, {nbytes} B >= dense "
                        f"{dense} B) on the compressed dc path — a "
                        "dense intermediate leaked between select/pack "
                        "and the collective",
                        site=site,
                        detail={"bytes": nbytes, "dense_bytes": dense,
                                "shape": list(shape), "dtype": dtype}))
        if last_collective < 0:
            return findings
        allowed = int(ctx.extras.get("allowed_dense_after_collective", 1))
        replicas = max(1, int(ctx.extras.get("replicas", 1)))
        seen = set()
        for site in sites[last_collective + 1:]:
            if site.kind != "aten" or \
                    site.primitive.rstrip("_") not in DENSIFY_OPS:
                continue
            for (shape, dtype), buf in zip(site.outputs, site.buffers):
                if buf in seen or \
                        sig_bytes((shape, dtype)) // replicas < dense:
                    continue
                seen.add(buf)
                if len(seen) > allowed:
                    findings.append(self.finding(
                        f"{site.primitive} materializes dense output "
                        f"#{len(seen)} ({shape} {dtype}) after the final "
                        f"collective (allowed: {allowed}) — the merge "
                        "densifies per party instead of combining in "
                        "the compressed domain",
                        site=site,
                        detail={"densify_count": len(seen),
                                "allowed": allowed,
                                "shape": list(shape), "dtype": dtype}))
        return findings


def _dense_floor_bytes(compressor, grads: dict) -> int:
    """The dense fp32 footprint (per replica) of the largest unit the
    compressor sparsifies: the largest bucket for tree-fusing
    compressors, the largest sparse-eligible leaf otherwise.  ``grads``
    carry the ``[P, W]`` replica dims."""
    leaves = list(grads.values())
    bucketer = getattr(compressor, "_bucketer", None)
    if callable(bucketer):
        bk = bucketer(leaves)
        if bk.bucket_sizes:
            return 4 * max(bk.bucket_sizes)
    floor = max((getattr(compressor, "min_sparse_size", 1),
                 getattr(compressor, "size_lower_bound", 1)))
    sizes = [int(np.prod(leaf.shape[2:])) for leaf in leaves]
    eligible = [n for n in sizes if n >= floor]
    return 4 * max(eligible) if eligible else 0


def audit_zero_compressed_path(bucketed, params, num_shards: int,
                               num_parties: int = 2) -> List[Finding]:
    """GX-PURITY-001 for the ZeRO dc tier (``train/zero.py``): record the
    per-shard compressed all-reduce (``allreduce_shards``) and require
    every wire payload to stay below the *shard*-dense floor.  Dense
    inner compressors are skipped like :func:`audit_compressed_path`."""
    grads = stack_parties(params, num_parties)
    bk = bucketed.zero_bucketer(list(grads.values()))
    if not bk.bucket_sizes:
        return []
    shard_sizes = [n // num_shards for n in bk.bucket_sizes]
    dense_shard = 4 * max(shard_sizes)
    wire = int(bucketed.shard_wire_bytes(grads, num_shards))
    if wire >= 4 * sum(shard_sizes):
        return []  # dense inner compressor: nothing to audit
    shards = [torch.zeros((num_parties, 1, s)) for s in shard_sizes]
    state = bucketed.init_shard_state(grads, num_shards)
    rec = record_program(bucketed.allreduce_shards, shards, state, DC_AXIS,
                         num_parties, bk)
    return PurityPass().run(rec, AuditContext(
        dense_bytes=dense_shard, extras={"replicas": num_parties}))


def audit_compressed_path(compressor, params,
                          num_parties: int = 2) -> List[Finding]:
    """Record the compressor's dc-tier all-reduce over ``params`` and run
    :class:`PurityPass` with the dense floor derived from the
    compressor's own layout.  Dense compressors (``wire_bytes`` >= the
    dense fp32 bytes) are skipped — purity is a property of compressed
    paths."""
    grads = stack_parties(params, num_parties)
    dense_fp32 = sum(int(np.prod(v.shape[2:])) * 4 for v in grads.values())
    if int(compressor.wire_bytes(grads)) >= dense_fp32:
        return []  # dense path: nothing to audit
    dense_bytes = _dense_floor_bytes(compressor, grads)
    if not dense_bytes:
        return []
    rec, _ = _recorded_allreduce(compressor, params, num_parties)
    return PurityPass().run(rec, AuditContext(
        dense_bytes=dense_bytes, extras={"replicas": num_parties}))
