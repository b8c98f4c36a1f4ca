"""Seeded known-bad corpus (port of geomx_tpu/analysis/corpus.py):
programs the auditor MUST flag.

Each entry builds a minimal port program with one defect class of the
pass catalog and runs the matching audit entry point; the tests hold
every entry to the rule id and severity its JAX entry gets.  The BSC
entries subclass the port's ``BiSparseCompressor`` and override its
``allreduce_leaf`` with the JAX entry's defect.

Entries (name -> expected rule):

- ``divergent_collectives``  -> GX-COLLECTIVE-001   two parties run
  different collective sequences
- ``fp32_leak_bf16_path``    -> GX-DTYPE-001        an fp32 matmul on a
  declared-bf16 compute path
- ``wire_accounting_lie``    -> GX-DTYPE-002        a compressor whose
  wire_bytes() claims half the bytes its collectives move
- ``scatter_wire_lie``       -> GX-DTYPE-002        a ZeRO-style
  reduce_scatter + all_gather pair accounted with the allreduce
  convention
- ``dense_compressed_path``  -> GX-PURITY-001       a "compressed" path
  that decompresses to dense BEFORE the collective
- ``dense_merge``            -> GX-PURITY-001       a compressed path
  whose merge densifies each party's stream after the gather

The JAX corpus's ``read_after_donate`` (GX-DONATE-001) has no entry:
``NOT_PORTABLE`` in ``analysis/__init__.py``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple

from geomx_tpu_torch.analysis.core import Finding


class CorpusEntry(NamedTuple):
    name: str
    expected_rule: str
    run: Callable[[], List[Finding]]


# ---------------------------------------------------------------------------
# entry builders
# ---------------------------------------------------------------------------

def _divergent_collectives() -> List[Finding]:
    """Party 1's program launches an extra all_gather party 0 never
    posts: at run time party 0 blocks in its psum while party 1 blocks
    in a gather no peer joins."""
    import torch

    from geomx_tpu_torch.analysis.passes import audit_cross_party
    from geomx_tpu_torch.analysis.record import record_program
    from geomx_tpu_torch.parallel.collectives import all_gather, psum
    from geomx_tpu_torch.topology import DC_AXIS

    x = torch.zeros((2, 1, 256))

    def party0(v):
        return psum(v, DC_AXIS) / 2.0

    def party1(v):
        g = all_gather(v, DC_AXIS)        # the divergent launch
        return psum(v, DC_AXIS) / 2.0 + g.sum()

    return audit_cross_party({"party0": lambda: record_program(party0, x),
                              "party1": lambda: record_program(party1, x)})


def _fp32_leak_bf16_path() -> List[Finding]:
    """A two-layer bf16 matmul chain with one forgotten cast: the second
    layer silently computes in fp32."""
    import torch

    from geomx_tpu_torch.analysis.passes import audit_dtype_flow

    w1 = torch.zeros((64, 64), dtype=torch.bfloat16)
    w2 = torch.zeros((64, 64), dtype=torch.float32)  # the leak

    def fwd(x):
        h = x @ w1                          # bf16 x bf16: clean
        return h.to(torch.float32) @ w2     # fp32 leak

    return audit_dtype_flow(fwd, torch.zeros((8, 64), dtype=torch.bfloat16),
                            compute_dtype="bfloat16")


def _wire_accounting_lie() -> List[Finding]:
    """An fp16-wire compressor whose accounting claims 2 bytes an element
    while it gathers fp32."""
    import math

    import torch

    from geomx_tpu_torch.analysis.passes import audit_wire_accounting
    from geomx_tpu_torch.compression.base import REPLICA_DIMS, Compressor
    from geomx_tpu_torch.parallel.collectives import all_gather

    class LyingFP16(Compressor):
        name = "fp16_lie"

        def allreduce_leaf(self, g, state, axis_name, axis_size):
            gathered = all_gather(g, axis_name)   # fp32 on the wire
            return gathered.sum(dim=REPLICA_DIMS), state

        def wire_bytes_leaf(self, leaf):
            # claims the 16-bit wire it never built
            return math.prod(leaf.shape[REPLICA_DIMS:]) * 2

    return audit_wire_accounting(LyingFP16(), torch.zeros((4096,)))


def _scatter_wire_lie() -> List[Finding]:
    """A ZeRO-style sharded reducer (reduce-scatter the gradient, then
    all_gather the shard back) whose accounting keeps the allreduce
    operand-once convention: the payload is ``full + shard``, 1.25x the
    declared bytes at N = 4."""
    import math

    import torch

    from geomx_tpu_torch.analysis.passes import audit_wire_accounting
    from geomx_tpu_torch.compression.base import REPLICA_DIMS, Compressor
    from geomx_tpu_torch.parallel.collectives import (all_gather,
                                                      psum_scatter)

    n_axis = 4

    class LyingScatter(Compressor):
        name = "zero_scatter_lie"

        def allreduce_leaf(self, g, state, axis_name, axis_size):
            lead = tuple(g.shape[:REPLICA_DIMS])
            shard = psum_scatter(g.reshape(lead + (-1,)).to(torch.float32),
                                 axis_name)
            full = all_gather(shard, axis_name, tiled=True)
            return full.reshape(g.shape).to(g.dtype), state

        def wire_bytes_leaf(self, leaf):
            # the allreduce convention: a lie here
            return math.prod(leaf.shape[REPLICA_DIMS:]) * 4

    return audit_wire_accounting(LyingScatter(), torch.zeros((4096,)),
                                 num_parties=n_axis)


def _bsc_defect(name: str, allreduce_leaf, **kw):
    """A BiSparseCompressor whose ``allreduce_leaf`` is ``allreduce_leaf``
    (exact selection, every leaf sparse)."""
    from geomx_tpu_torch.compression.bisparse import BiSparseCompressor

    cls = type(name, (BiSparseCompressor,),
               {"name": name, "allreduce_leaf": allreduce_leaf})
    return cls(ratio=0.01, select="exact", min_sparse_size=1, **kw)


def _dense_compressed_path() -> List[Finding]:
    """A BSC variant that decompresses each party's pairs to dense and
    THEN psums: select/pack ran, but the WAN carries the dense
    gradient."""
    import math

    import torch

    from geomx_tpu_torch.analysis.passes import audit_compressed_path
    from geomx_tpu_torch.compression.base import REPLICA_DIMS
    from geomx_tpu_torch.parallel.collectives import psum

    def allreduce_leaf(self, g, state, axis_name, axis_size):
        lead = tuple(g.shape[:REPLICA_DIMS])
        n = math.prod(g.shape[REPLICA_DIMS:])
        if not self._sparse_eligible(n):
            return psum(g, axis_name), state
        u, v = state
        vals, idx, u, v = self.compress(
            g.reshape(lead + (n,)).to(torch.float32),
            u.reshape(lead + (n,)), v.reshape(lead + (n,)))
        dense = self.decompress(vals, idx, n)   # dense BEFORE the wire
        out = psum(dense, axis_name)
        return (out.reshape(g.shape).to(g.dtype),
                (u.reshape(g.shape), v.reshape(g.shape)))

    comp = _bsc_defect("bsc_dense_leak", allreduce_leaf)
    return audit_compressed_path(comp, torch.zeros((8192,)))


def _dense_merge() -> List[Finding]:
    """Every wire payload is compressed — the gather carries (value,
    index) pairs — but the merge decompresses EACH party's pairs into
    its own dense buffer and sums the dense copies: one dense buffer a
    party after the final collective."""
    import math

    import torch

    from geomx_tpu_torch.analysis.passes import audit_compressed_path
    from geomx_tpu_torch.compression.base import REPLICA_DIMS
    from geomx_tpu_torch.parallel.collectives import all_gather, psum

    def allreduce_leaf(self, g, state, axis_name, axis_size):
        lead = tuple(g.shape[:REPLICA_DIMS])
        n = math.prod(g.shape[REPLICA_DIMS:])
        if not self._sparse_eligible(n):
            return psum(g, axis_name), state
        u, v = state
        vals, idx, u, v = self.compress(
            g.reshape(lead + (n,)).to(torch.float32),
            u.reshape(lead + (n,)), v.reshape(lead + (n,)))
        all_vals = all_gather(vals, axis_name)   # sparse wire: fine
        all_idx = all_gather(idx, axis_name)
        out = torch.zeros(lead + (n,))
        for p in range(axis_size):   # the defect: per-party densify
            out = out + self.decompress(all_vals[:, :, p],
                                        all_idx[:, :, p], n)
        return (out.reshape(g.shape).to(g.dtype),
                (u.reshape(g.shape), v.reshape(g.shape)))

    comp = _bsc_defect("bsc_dense_merge", allreduce_leaf, sparse_agg=False)
    return audit_compressed_path(comp, torch.zeros((8192,)))


CORPUS = (
    CorpusEntry("divergent_collectives", "GX-COLLECTIVE-001",
                _divergent_collectives),
    CorpusEntry("fp32_leak_bf16_path", "GX-DTYPE-001", _fp32_leak_bf16_path),
    CorpusEntry("wire_accounting_lie", "GX-DTYPE-002", _wire_accounting_lie),
    CorpusEntry("scatter_wire_lie", "GX-DTYPE-002", _scatter_wire_lie),
    CorpusEntry("dense_compressed_path", "GX-PURITY-001",
                _dense_compressed_path),
    CorpusEntry("dense_merge", "GX-PURITY-001", _dense_merge),
)


def run_corpus() -> Dict[str, dict]:
    """Run every corpus entry; each record carries the expected rule,
    the findings' rule ids, and the flagged verdict (expected rule among
    them).  The auditor is healthy iff every entry is flagged."""
    out: Dict[str, dict] = {}
    for entry in CORPUS:
        findings = entry.run()
        rules = sorted({f.rule_id for f in findings})
        out[entry.name] = {
            "expected_rule": entry.expected_rule,
            "finding_rules": rules,
            "finding_count": len(findings),
            "flagged": entry.expected_rule in rules,
        }
    return out
