"""Graft Auditor core (port of geomx_tpu/analysis/core.py): walking a
recorded program, the pass framework, findings and the severity gate.

The correctness properties the system lives on are program-shape
properties: every party must run the same collective sequence (or the
mesh deadlocks or diverges silently), the compressed path must never
put a dense payload on the WAN, and a declared 16-bit path must not
compute in fp32.  The JAX package checks them on traced jaxprs; the
port checks them on recorded programs (``analysis/record.py``): passes
produce structured :class:`Finding` s with event provenance, and a
severity gate (``GEOMX_AUDIT`` / ``GEOMX_AUDIT_SEVERITY``) turns findings
into hard errors at the Trainer's swap boundaries.

Vocabulary:

- ``OpSite`` (``record.py``) — one recorded event plus its scope path
  and index, yielded by :func:`walk_program`;
- :class:`Finding`  — rule id, severity, message, provenance;
- :class:`AuditPass` — ``run(record, ctx) -> [Finding]``;
- :func:`run_passes` / :func:`enforce` — drive passes, gate severities.

The hand-written CUDA kernels never enter a record (``record.py``), so
there is no opaque-call set to skip, and no lowered text: the donation
rules read none (``NOT_PORTABLE`` in ``analysis/__init__.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Optional, Sequence

from geomx_tpu_torch.analysis.record import OpSite, ProgramRecord

# severity order: gate "warning" admits warnings AND errors; "error"
# admits errors only.  "info" findings never raise.
SEVERITIES = ("info", "warning", "error")


def _severity_rank(sev: str) -> int:
    try:
        return SEVERITIES.index(sev)
    except ValueError:
        raise ValueError(
            f"unknown severity {sev!r}: expected one of {SEVERITIES}")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One auditor result, with enough provenance to act on it."""

    rule_id: str                 # e.g. "GX-COLLECTIVE-001"
    severity: str                # "info" | "warning" | "error"
    message: str                 # human-readable, one line
    primitive: str = ""          # offending event's primitive ("" = n/a)
    path: str = ""               # scope path, e.g. "train/sync_grads[12]"
    source: str = ""             # file:line of the call when recorded
    detail: Optional[dict] = None  # rule-specific structured payload

    def __post_init__(self):
        _severity_rank(self.severity)  # validate eagerly

    def format(self) -> str:
        loc = self.path or "<program>"
        src = f" ({self.source})" if self.source else ""
        return f"[{self.rule_id}:{self.severity}] {loc}{src}: {self.message}"


def walk_program(record: ProgramRecord) -> Iterator[OpSite]:
    """Every recorded event of ``record``, in the order it ran (stable
    across identical runs)."""
    yield from record.events


@dataclasses.dataclass
class AuditContext:
    """Per-audit metadata handed to passes.

    ``dense_bytes``: the dense fp32 footprint a replica's compressed-path
    payloads are compared against (largest bucket/leaf).
    ``compute_dtype``: the declared 16-bit compute dtype for the
    dtype-flow pass (None disables the leak rule).  ``extras`` is a
    free-form bag for rule-specific inputs."""

    dense_bytes: Optional[int] = None
    compute_dtype: Optional[str] = None
    label: str = ""
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)


class AuditPass:
    """Base class: one named rule family over a recorded program."""

    rule_id: str = "GX-BASE-000"
    default_severity: str = "error"

    def run(self, record: ProgramRecord, ctx: AuditContext) -> List[Finding]:
        raise NotImplementedError

    def finding(self, message: str, site: Optional[OpSite] = None,
                severity: Optional[str] = None, rule_id: Optional[str] = None,
                detail: Optional[dict] = None) -> Finding:
        return Finding(
            rule_id=rule_id or self.rule_id,
            severity=severity or self.default_severity,
            message=message,
            primitive=site.primitive if site is not None else "",
            path=(f"{site.path}[{site.index}]" if site is not None else ""),
            source=site.source() if site is not None else "",
            detail=detail)


def run_passes(record: ProgramRecord, passes: Sequence[AuditPass],
               ctx: Optional[AuditContext] = None) -> List[Finding]:
    """Run every pass over one recorded program; findings concatenate
    in pass order (each pass's findings keep walk order)."""
    ctx = ctx or AuditContext()
    out: List[Finding] = []
    for p in passes:
        out.extend(p.run(record, ctx))
    return out


class AuditError(Exception):
    """Raised by :func:`enforce` when findings cross the severity gate.
    Carries the full finding list (``.findings``) so callers can log or
    rejudge — the message holds the formatted gate-crossing subset."""

    def __init__(self, findings: Sequence[Finding], gate: str):
        self.findings = list(findings)
        self.gate = gate
        over = [f for f in findings
                if _severity_rank(f.severity) >= _severity_rank(gate)]
        lines = "\n  ".join(f.format() for f in over)
        super().__init__(
            f"graft auditor: {len(over)} finding(s) at or above "
            f"severity {gate!r}:\n  {lines}")


def enforce(findings: Sequence[Finding], gate: str = "error") -> List[Finding]:
    """Raise :class:`AuditError` if any finding's severity reaches
    ``gate``; otherwise return the findings unchanged (callers log the
    sub-gate remainder)."""
    rank = _severity_rank(gate)
    if any(_severity_rank(f.severity) >= rank for f in findings):
        raise AuditError(findings, gate)
    return list(findings)


def summarize(findings: Sequence[Finding]) -> Dict[str, int]:
    """Finding counts per rule id."""
    out: Dict[str, int] = {}
    for f in findings:
        out[f.rule_id] = out.get(f.rule_id, 0) + 1
    return out


# ---------------------------------------------------------------------------
# the audit gate (config surface, mirroring telemetry_enabled)
# ---------------------------------------------------------------------------

def audit_enabled(config: Optional[Any] = None) -> bool:
    """The master auditor gate: ``config.audit`` or ``GEOMX_AUDIT``,
    parsed with the same numeric-boolean rules as every other GEOMX_*
    knob.  Read where the audit hooks are built (Trainer init), so
    flipping it takes a new Trainer."""
    if config is not None and getattr(config, "audit", False):
        return True
    from geomx_tpu_torch.config import _env_bool
    return _env_bool(["GEOMX_AUDIT"], False)


def audit_severity_gate(config: Optional[Any] = None) -> str:
    """The severity at which findings raise (``GEOMX_AUDIT_SEVERITY`` /
    ``GeoConfig.audit_severity``); below it they only warn."""
    gate = None
    if config is not None:
        gate = getattr(config, "audit_severity", None)
    if not gate:
        from geomx_tpu_torch.config import _env
        gate = _env(["GEOMX_AUDIT_SEVERITY"], "error", str)
    _severity_rank(gate)
    return gate
