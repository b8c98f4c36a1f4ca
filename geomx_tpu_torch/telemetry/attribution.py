"""Step-time attribution: Chrome traces -> per-step phase breakdown (port
of geomx_tpu/telemetry/attribution.py; the port's fit loop brackets
every step with the same ``train/step``/``train/compute`` spans).

The tracing plane *collects* spans (``utils/profiler.py`` host spans,
``tracing.merge_traces`` for the cross-party view); this module
*interprets* them, following the phase-attribution methodology of
profiling-driven compression tuning ("Evaluation and Optimization of
Gradient Compression", PAPERS.md): every step window is partitioned into
four DISJOINT phases whose durations sum to the window exactly —

- ``compute``       covered by compute spans only;
- ``hidden_comms``  covered by compute AND communication (the collective
                    rides under compute — the overlap pipelining buys);
- ``exposed_comms`` covered by communication only (the step is blocked
                    on the wire — what a TSEngine-style controller must
                    shrink);
- ``host_stall``    covered by neither (input pipeline, dispatch gaps,
                    host work).

Because the partition is disjoint the four fractions sum to ~1.0 by
construction, which is the acceptance invariant ``bench.py --attribute``
gates on.

Classification is keyed on the span names/categories the repo already
records: ``train/step`` marks the step window (``Trainer.fit`` and bench
emit it), ``train/compute`` + ``kernel``-category spans
(``bsc/select_pack``, ``bsc/scatter_add``) are compute, and
``comm``-category spans (``dc_pipeline/launch``/``apply``, the bucketed
engine's ``dc_allreduce/bucket*`` spans, the host plane's
``RelayToGlobal:*`` / ``ServerPush:*`` WAN spans) are communication.
Spans matching no rule (scheduler chatter, metadata) attribute to
nothing — their time shows up as ``host_stall``, which is honest: the
step was not computing and not on the wire.

The multi-party view builds on :func:`~geomx_tpu_torch.telemetry.tracing.
merge_traces`: :func:`attribute_merged` attributes each party's process
row separately on the shared wall-clock axis.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

PHASES = ("compute", "hidden_comms", "exposed_comms", "host_stall")

STEP_SPAN = "train/step"
COMPUTE_SPAN = "train/compute"

# span-name prefixes the host plane records for WAN communication
_COMM_NAME_PREFIXES = ("RelayToGlobal:", "RelayRowSparse:", "ServerPush:",
                       "ServerPull:", "ServerMerge:")
_COMM_NAME_PARTS = ("_pipeline/", "_allreduce/")


def classify_span(name: str, category: str = "") -> Optional[str]:
    """``"step"`` / ``"compute"`` / ``"comms"`` / None for a span.

    The rule table (first match wins):

    ==========================  =========  =============================
    match                       class      emitted by
    ==========================  =========  =============================
    name ``train/step``         step       Trainer.fit / bench
    name ``train/compute``      compute    Trainer.fit / bench
    category ``kernel``         compute    ``bsc/select_pack`` etc.
    category ``compute``        compute    any explicit compute span
    category ``comm``           comms      ``dc_pipeline/launch``,
                                           ``dc_allreduce/bucket*``,
                                           ``RelayToGlobal:*``
    name WAN prefixes/parts     comms      host-plane spans dumped
                                           without a category
    ==========================  =========  =============================
    """
    if name == STEP_SPAN or category == "step":
        return "step"
    if name == COMPUTE_SPAN or category in ("kernel", "compute"):
        return "compute"
    if category == "comm":
        return "comms"
    if name.startswith(_COMM_NAME_PREFIXES):
        return "comms"
    if any(part in name for part in _COMM_NAME_PARTS):
        return "comms"
    return None


# ---------------------------------------------------------------------------
# interval algebra
# ---------------------------------------------------------------------------

def _merge_intervals(ivs: List[Tuple[float, float]]
                     ) -> List[Tuple[float, float]]:
    """Union of [begin, end) intervals as a sorted disjoint list."""
    out: List[Tuple[float, float]] = []
    for b, e in sorted(ivs):
        if e <= b:
            continue
        if out and b <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((b, e))
    return out


def _covered(ivs: List[Tuple[float, float]]) -> float:
    return sum(e - b for b, e in ivs)


def _intersect(a: List[Tuple[float, float]],
               b: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Intersection of two disjoint sorted interval lists."""
    out: List[Tuple[float, float]] = []
    i = j = 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if lo < hi:
            out.append((lo, hi))
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _clip(ivs: List[Tuple[float, float]], lo: float, hi: float
          ) -> List[Tuple[float, float]]:
    return [(max(b, lo), min(e, hi)) for b, e in ivs
            if min(e, hi) > max(b, lo)]


def attribute_window(window: Tuple[float, float],
                     compute: List[Tuple[float, float]],
                     comms: List[Tuple[float, float]]) -> Dict[str, float]:
    """Partition one step window into the four disjoint phase durations
    (microseconds, same unit as Chrome trace timestamps)."""
    lo, hi = window
    total = max(hi - lo, 0.0)
    cmp_u = _merge_intervals(_clip(compute, lo, hi))
    com_u = _merge_intervals(_clip(comms, lo, hi))
    hidden = _covered(_intersect(cmp_u, com_u))
    compute_only = _covered(cmp_u) - hidden
    exposed = _covered(com_u) - hidden
    stall = total - compute_only - hidden - exposed
    return {"compute": compute_only, "hidden_comms": hidden,
            "exposed_comms": exposed, "host_stall": max(stall, 0.0),
            "total": total}


# ---------------------------------------------------------------------------
# trace-level attribution
# ---------------------------------------------------------------------------

def _duration_events(doc: dict) -> List[dict]:
    return [ev for ev in doc.get("traceEvents", [])
            if ev.get("ph") == "X" and "ts" in ev and "dur" in ev]


def attribute_trace(doc: dict, pid: Optional[int] = None,
                    extend_to_next: bool = True,
                    since_us: Optional[float] = None) -> Dict[str, Any]:
    """Attribute a Chrome trace document into per-step phase breakdowns.

    ``doc``: a loaded trace (``Profiler.dump`` output or one process row
    of a merged trace — restrict with ``pid``).  Step windows come from
    ``train/step`` spans; with ``extend_to_next`` (default) each window
    runs to the NEXT step's start so the inter-step gap (input pipeline,
    host loop) is attributed as ``host_stall`` instead of vanishing
    between windows — the last step keeps its own span length.
    ``since_us`` drops spans starting before that trace timestamp — the
    window-scoping hook for a long-lived process whose global profiler
    accumulates across fits (mark ``Profiler.now_us()`` at the window
    start, attribute only what this window recorded).

    Returns ``{"steps": [per-step dicts], "summary": {phase ->
    fraction}, "totals_us": {phase -> us}, "num_steps": N}``; the four
    summary fractions sum to ~1.0 whenever any step was found.
    """
    steps_spans: List[dict] = []
    compute: List[Tuple[float, float]] = []
    comms: List[Tuple[float, float]] = []
    for ev in _duration_events(doc):
        if pid is not None and ev.get("pid") != pid:
            continue
        if since_us is not None and float(ev["ts"]) < since_us:
            continue
        kind = classify_span(ev.get("name", ""), ev.get("cat", ""))
        iv = (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]))
        if kind == "step":
            steps_spans.append(ev)
        elif kind == "compute":
            compute.append(iv)
        elif kind == "comms":
            comms.append(iv)

    steps_spans.sort(key=lambda e: e["ts"])
    steps: List[Dict[str, Any]] = []
    for i, ev in enumerate(steps_spans):
        lo = float(ev["ts"])
        hi = lo + float(ev["dur"])
        if extend_to_next and i + 1 < len(steps_spans):
            hi = max(hi, float(steps_spans[i + 1]["ts"]))
        rec = attribute_window((lo, hi), compute, comms)
        rec["step"] = (ev.get("args") or {}).get("step", i)
        steps.append(rec)

    totals = {ph: sum(s[ph] for s in steps) for ph in PHASES}
    grand = sum(totals.values())
    summary = {ph: (totals[ph] / grand if grand else 0.0) for ph in PHASES}
    return {"steps": steps, "summary": summary, "totals_us": totals,
            "num_steps": len(steps)}


def attribute_merged(traces: Sequence[Any],
                     labels: Optional[Sequence[str]] = None
                     ) -> Dict[str, Any]:
    """Multi-party attribution on one shared timeline: merge N parties'
    trace dumps (``merge_traces`` — wall-clock aligned) and attribute
    each party's process row separately.  Returns ``{"parties": {label:
    attribution}, "merged": <merged trace doc>}``."""
    from geomx_tpu_torch.telemetry.tracing import merge_traces, process_names
    merged = merge_traces(traces, labels=labels)
    names = process_names(merged)
    parties = {}
    for pid in sorted(names):
        att = attribute_trace(merged, pid=pid)
        if att["num_steps"] or any(att["totals_us"].values()):
            parties[names[pid]] = att
    return {"parties": parties, "merged": merged}


def publish_attribution(summary: Dict[str, float], registry=None) -> None:
    """Publish a phase-fraction summary as registry gauges
    (``geomx_phase_fraction{phase=...}``) — the scheduler's ``/metrics``
    surface then exports the live breakdown."""
    from geomx_tpu_torch.telemetry.registry import get_registry
    reg = registry if registry is not None else get_registry()
    fam = reg.gauge("geomx_phase_fraction",
                    "Step-time fraction per attributed phase", ("phase",))
    for ph in PHASES:
        fam.labels(phase=ph).set(float(summary.get(ph, 0.0)))
