"""Graft Auditor (port of geomx_tpu/analysis/): static checks over
recorded programs.

- ``record`` — records a program's collectives and ATen ops (the port's
  counterpart of tracing to a jaxpr; no JAX counterpart of its own)
- ``core``   — the walker, pass framework, ``Finding``s, severity gate
- ``passes`` — collective consistency (+ ``audit_cross_party``),
  dtype flow and wire accounting, compressed-path purity
- ``hlo``    — op-count assertions (the fused-versus-plain matchers)
- ``corpus`` — seeded known-bad programs the auditor must flag

``NOT_PORTABLE`` names what the JAX package has and the port leaves
out, with the reason; ``RENAMED`` maps the JAX names whose port
counterparts read a record instead of a jaxpr.
"""

from geomx_tpu_torch.analysis.core import (AuditContext, AuditError,
                                           AuditPass, Finding,
                                           audit_enabled,
                                           audit_severity_gate, enforce,
                                           run_passes, summarize,
                                           walk_program)
from geomx_tpu_torch.analysis.passes import (CollectiveConsistencyPass,
                                             DtypeFlowPass, PurityPass,
                                             audit_compressed_path,
                                             audit_cross_party,
                                             audit_dtype_flow,
                                             audit_wire_accounting,
                                             audit_zero_compressed_path,
                                             collective_signature,
                                             diff_collective_signatures)
from geomx_tpu_torch.analysis.record import (OpSite, ProgramRecord,
                                             record_program)

_DONATION = ("PyTorch eager has no buffer donation and no "
             "input_output_aliases: the port's step returns fresh tensors, "
             "and the caching allocator reuses freed blocks on its own")

NOT_PORTABLE = {
    "GX-DONATE-001": _DONATION,
    "GX-DONATE-002": _DONATION,
    "DonationPass": _DONATION,
    "audit_donation": _DONATION,
    "parse_compiled_aliases": _DONATION + " (no compiled module to parse)",
    "read_after_donate": _DONATION + " (the corpus entry of GX-DONATE-001)",
    "lower_text": "there is no TPU lowering to cross-compile: the op "
                  "counts read a recorded program (analysis/hlo.py)",
    "OPAQUE_PRIMS": "the hand-written CUDA kernels are pybind calls no "
                    "dispatch mode sees: they never enter a record, so "
                    "there is nothing to skip",
    "axis_index_groups": "no port collective takes subgroups, so the "
                         "consistency pass has no warning branch",
}

# JAX name -> its port counterpart (over a ProgramRecord, not a jaxpr)
RENAMED = {
    "walk_jaxpr": "walk_program",
    "EqnSite": "OpSite",
    "aval_bytes": "sig_bytes",
    "aval_sig": "tensor_sig",
}

__all__ = [
    "AuditContext", "AuditError", "AuditPass", "Finding",
    "CollectiveConsistencyPass", "DtypeFlowPass", "NOT_PORTABLE",
    "OpSite", "ProgramRecord", "PurityPass", "RENAMED",
    "audit_compressed_path", "audit_cross_party", "audit_dtype_flow",
    "audit_enabled", "audit_severity_gate", "audit_wire_accounting",
    "audit_zero_compressed_path",
    "collective_signature", "diff_collective_signatures", "enforce",
    "record_program", "run_passes", "summarize", "walk_program",
]
