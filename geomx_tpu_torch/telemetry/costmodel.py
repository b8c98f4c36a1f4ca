"""Fitted step-time cost model over run-capsule records (port of
geomx_tpu/telemetry/costmodel.py).

A config planner needs an *oracle*: "what would step time be
under config C on the links this run actually had?" — the trade-off
study of "Evaluation and Optimization of Gradient Compression for
Distributed Deep Learning" (PAPERS.md), which fits communication cost
curves from measured runs, and EQuARX, which publishes measured
quantized-collective cost curves for exactly this purpose.
:class:`StepTimeCostModel` is that oracle, fitted from ONE
:class:`~geomx_tpu_torch.telemetry.capsule.Capsule`:

- **links**: per-party uplink models ``seconds(B) = a + B*ib``.  When
  the run fed *paired* observations — the payload transfer on the
  ``global`` peer plus a heartbeat-sized probe on the ``probe`` peer
  (what ``bench.py --compare-capsule`` records; the scheduler's
  heartbeats are the live analogue) — the pair solves ``(a, ib)``
  EXACTLY per step, so latency shaping and bandwidth shaping separate
  and the model tracks chaos windows step by step.  Without probes it
  falls back to a least-squares affine fit over the journal plus a
  per-observation multiplicative residual — exact at the capsule's
  own payload sizes, interpolated elsewhere;
- **compute**: the median per-step compute seconds from the capsule's
  step records (``timing.compute_s``, or the compute phase fraction
  times total step seconds);
- **structure**: the same overlap semantics the system implements —
  a synchronous dc tier exposes the whole WAN round; pipeline depth
  >= 1 hides ``min(wan, compute)`` behind the next step's compute
  (sync/pipeline.py), so ``step = compute + max(0, wan - compute)``.

:meth:`predict` takes a candidate ``(compression, depth,
bucket_bytes)`` config, derives its per-step wire bytes from the
capsule's recorded parameter layout via the compressors' own static
wire accounting (:func:`candidate_wire_bytes` — the same
``wire_bytes`` the GX-DTYPE-002 audit holds honest), and integrates
the per-step prediction over the capsule's timeline.  ``bench.py
--compare-capsule`` validates the model's *ranking* of a ratio x
depth x compressor grid against measured runs and reports per-config
relative error (docs/performance.md "What-if search over capsules").

Known limits (documented, not hidden): compute is treated as
config-invariant (a candidate whose compressor changes on-chip time
inherits the capsule's measured compute), and
the residual correction is exact only at the capsule's own payload
sizes; between them the affine interpolation rules.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

DEFAULT_PEER = "global"
PROBE_PEER = "probe"


def _median(vals: List[float]) -> float:
    s = sorted(vals)
    n = len(s)
    if not n:
        raise ValueError("median of empty sequence")
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def fit_affine_link(samples: List[dict]) -> Dict[str, Any]:
    """Least-squares affine fit ``seconds = latency + bytes *
    sec_per_byte`` over one party's journal samples, clamped to the
    physical region (latency >= 0, sec_per_byte > 0; a degenerate
    spread falls back to the zero-latency throughput line).  Each
    sample gains ``resid`` — measured over fitted — so predictions can
    re-apply the run's time-local conditions."""
    pts = [(float(s["nbytes"]), float(s["seconds"]), float(s["t"]))
           for s in samples
           if s.get("ok", True) and s.get("seconds")
           and float(s.get("nbytes") or 0) > 0]
    if not pts:
        raise ValueError("no usable (bytes, seconds) samples to fit")
    n = len(pts)
    sum_b = sum(b for b, _s, _t in pts)
    sum_s = sum(s for _b, s, _t in pts)
    sum_bb = sum(b * b for b, _s, _t in pts)
    sum_bs = sum(b * s for b, s, _t in pts)
    den = n * sum_bb - sum_b * sum_b
    if den > 0:
        ib = (n * sum_bs - sum_b * sum_s) / den
        a = (sum_s - ib * sum_b) / n
    else:                       # one distinct payload size: slope-only
        ib, a = -1.0, 0.0
    if ib <= 0:                 # unphysical: zero-latency throughput line
        ib = sum_s / sum_b
        a = 0.0
    elif a < 0:                 # re-fit the slope through the origin
        ib = sum_bs / sum_bb
        a = 0.0
    fitted_samples = []
    for b, s, t in pts:
        nominal = a + b * ib
        fitted_samples.append({
            "t": t, "nbytes": b, "seconds": s,
            "resid": s / nominal if nominal > 0 else 1.0})
    return {"latency_s": a, "sec_per_byte": ib,
            "num_samples": n, "samples": fitted_samples}


def fit_paired_link(payload: List[dict],
                    probe: List[dict]) -> Optional[Dict[str, Any]]:
    """EXACT per-step link solve from paired observations: at each run
    clock ``t`` with both a payload transfer (bytes ``Bg``, seconds
    ``sg``) and a probe (``Bp``, ``sp``),

        sec_per_byte = (sg - sp) / (Bg - Bp),
        latency_s    = sp - Bp * sec_per_byte,

    clamped to the physical region.  Returns a per-``t`` timeline of
    ``(latency_s, sec_per_byte)`` plus median summary params, or None
    when fewer than one pair matched (the caller falls back to the
    affine fit)."""
    by_t = {float(s["t"]): s for s in probe
            if s.get("ok", True) and s.get("seconds")}
    timeline: List[dict] = []
    for s in payload:
        if not (s.get("ok", True) and s.get("seconds")):
            continue
        p = by_t.get(float(s["t"]))
        if p is None:
            continue
        bg, sg = float(s["nbytes"]), float(s["seconds"])
        bp, sp = float(p["nbytes"]), float(p["seconds"])
        if bg <= bp:
            continue
        ib = (sg - sp) / (bg - bp)
        if ib <= 0:
            ib = sg / bg
            a = 0.0
        else:
            a = max(0.0, sp - bp * ib)
        timeline.append({"t": float(s["t"]), "latency_s": a,
                         "sec_per_byte": ib})
    if not timeline:
        return None
    timeline.sort(key=lambda e: e["t"])
    return {
        "latency_s": _median([e["latency_s"] for e in timeline]),
        "sec_per_byte": _median([e["sec_per_byte"] for e in timeline]),
        "num_samples": len(timeline),
        "timeline": timeline,
    }


def candidate_wire_bytes(param_shapes: Dict[str, dict],
                         compression: str,
                         bucket_bytes: int) -> float:
    """Per-party per-step dc-tier wire bytes for a candidate config,
    from the compressors' own static accounting over the capsule's
    recorded parameter layout (``manifest["param_shapes"]``).  The port's
    compressors account ``[P, W, *shape]`` leaves; the layout enters as
    ``[1, 1, *shape]`` tensors on the ``meta`` device (shapes and dtypes
    only, no storage)."""
    import torch

    from geomx_tpu_torch.compression.base import get_compressor
    from geomx_tpu_torch.compression.bucketing import BucketedCompressor
    tree = {name: torch.empty((1, 1) + tuple(meta["shape"]),
                              dtype=getattr(torch, str(meta["dtype"])),
                              device="meta")
            for name, meta in param_shapes.items()}
    comp = get_compressor(compression)
    if bucket_bytes:
        comp = BucketedCompressor(comp, bucket_bytes=int(bucket_bytes))
    return float(comp.wire_bytes(tree))


class StepTimeCostModel:
    """The fitted oracle: per-party affine+residual link models, a
    compute constant, and the capsule's step timeline to integrate
    predictions over."""

    def __init__(self, links: Dict[str, dict], compute_s: float,
                 step_times: List[float],
                 param_shapes: Optional[Dict[str, dict]] = None,
                 peer: str = DEFAULT_PEER,
                 skipped_links: Optional[List[str]] = None):
        if not links:
            raise ValueError("cost model needs at least one fitted link")
        self.links = links
        self.compute_s = float(compute_s)
        self.step_times = list(step_times)   # the capsule's step clocks
        self.param_shapes = param_shapes
        self.peer = peer
        # parties whose journal had no usable timing (a link dead for
        # the whole run): predictions cover the fitted parties only
        self.skipped_links = list(skipped_links or [])

    # ---- fitting -----------------------------------------------------------

    @classmethod
    def fit(cls, capsule, peer: str = DEFAULT_PEER,
            probe_peer: str = PROBE_PEER) -> "StepTimeCostModel":
        """Fit from one loaded :class:`Capsule`: links from the link
        journal (exact per-step pairs when ``probe_peer`` observations
        exist, affine+residual otherwise), compute from the step
        records' timing."""
        by_party: Dict[str, List[dict]] = {}
        probes: Dict[str, List[dict]] = {}
        for e in capsule.link_journal:
            if e.get("peer") == peer:
                by_party.setdefault(e["party"], []).append(e)
            elif e.get("peer") == probe_peer:
                probes.setdefault(e["party"], []).append(e)
        links: Dict[str, dict] = {}
        skipped: List[str] = []
        for p, samples in sorted(by_party.items()):
            fit = fit_paired_link(samples, probes.get(p, []))
            if fit is None:
                try:
                    fit = fit_affine_link(samples)
                except ValueError:
                    # a party whose every observation failed (a link
                    # dead for the whole run) has no timing to fit —
                    # model the parties that do, and say so
                    skipped.append(p)
                    continue
            links[p] = fit
        compute_samples: List[float] = []
        step_times: List[float] = []
        for rec in capsule.steps:
            step_times.append(float(rec["t"]))
            timing = rec.get("timing") or {}
            if "compute_s" in timing:
                compute_samples.append(float(timing["compute_s"]))
            elif "total_s" in timing and rec.get("phases", {}) \
                    .get("compute") is not None:
                compute_samples.append(float(timing["total_s"])
                                       * float(rec["phases"]["compute"]))
        if not compute_samples:
            raise ValueError(
                "capsule has no per-step compute timing (record_step "
                "timing= or phases.compute + timing.total_s)")
        return cls(links, _median(compute_samples), step_times,
                   param_shapes=capsule.manifest.get("param_shapes"),
                   peer=peer, skipped_links=skipped)

    # ---- prediction --------------------------------------------------------

    def _uplink_at(self, party: str, nbytes: float,
                   t: Optional[float]) -> float:
        """Predicted uplink seconds for ``nbytes`` on ``party`` at run
        clock ``t`` — the link state the run measured then: the exact
        per-step ``(latency, sec_per_byte)`` pair when the fit had
        probes, else the affine nominal scaled by the residual of the
        latest journal observation at or before ``t``."""
        fit = self.links[party]
        timeline = fit.get("timeline")
        if timeline:
            entry = timeline[0]
            if t is not None:
                for e in timeline:
                    if e["t"] <= t:
                        entry = e
                    else:
                        break
            else:
                entry = {"latency_s": fit["latency_s"],
                         "sec_per_byte": fit["sec_per_byte"]}
            return entry["latency_s"] + nbytes * entry["sec_per_byte"]
        nominal = fit["latency_s"] + nbytes * fit["sec_per_byte"]
        resid = 1.0
        if t is not None:
            for s in fit["samples"]:
                if s["t"] <= t:
                    resid = s["resid"]
                else:
                    break
        return resid * nominal

    def wan_round_s(self, nbytes: float,
                    t: Optional[float] = None) -> float:
        """One synchronous WAN round at run clock ``t``: the gate waits
        for the slowest party's uplink (direct fan-in — the shape the
        static grid configs run)."""
        return max(self._uplink_at(p, nbytes, t) for p in self.links)

    def predict_step_s(self, nbytes: float, depth: int,
                       t: Optional[float] = None) -> Dict[str, float]:
        wan = self.wan_round_s(nbytes, t)
        hidden = min(wan, self.compute_s) if depth else 0.0
        exposed = wan - hidden
        return {"total": self.compute_s + exposed, "wan": wan,
                "exposed": exposed, "hidden": hidden}

    def predict(self, candidate: Dict[str, Any],
                param_shapes: Optional[Dict[str, dict]] = None
                ) -> Dict[str, Any]:
        """Predict mean step time for a candidate config dict:
        ``compression`` (spec string), ``depth`` (0/1), ``bucket_bytes``
        (0 = per-leaf), optional ``emitted_fraction`` (a controller's
        achieved emission; static configs send capacity = 1.0) or an
        explicit ``wire_bytes`` override.  Integrated over the
        capsule's step timeline so chaos windows price in at the steps
        they actually covered."""
        shapes = param_shapes or self.param_shapes
        if "wire_bytes" in candidate:
            nbytes = float(candidate["wire_bytes"])
        else:
            if not shapes:
                raise ValueError(
                    "candidate has no wire_bytes and the capsule "
                    "recorded no param_shapes")
            nbytes = candidate_wire_bytes(
                shapes, candidate.get("compression", "none"),
                candidate.get("bucket_bytes", 0))
        nbytes *= float(candidate.get("emitted_fraction", 1.0))
        depth = int(candidate.get("depth", 0))
        times = self.step_times or [None]
        per_step = [self.predict_step_s(nbytes, depth, t)["total"]
                    for t in times]
        return {
            "wire_bytes": nbytes,
            "depth": depth,
            "mean_step_s": sum(per_step) / len(per_step),
            "num_steps": len(per_step),
        }

    def to_json(self) -> dict:
        """JSON form (bench artifact / docs examples) — fits without
        the per-sample residual tables."""
        out = {
            "compute_s": self.compute_s,
            "links": {p: {k: f[k] for k in
                          ("latency_s", "sec_per_byte", "num_samples")}
                      for p, f in sorted(self.links.items())},
            "num_steps": len(self.step_times),
        }
        if self.skipped_links:
            out["skipped_links"] = self.skipped_links
        return out
