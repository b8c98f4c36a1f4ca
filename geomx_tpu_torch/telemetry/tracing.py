"""Cross-party WAN round tracing: merge N Chrome traces into one timeline
(port of geomx_tpu/telemetry/tracing.py, over the port's
``utils/profiler.py`` documents).

The host plane already records per-process Chrome traces
(``utils/profiler.py``): a local server's ``RelayToGlobal:<key>`` span
is its WAN push+pull, the global server's ``ServerPush:<key>`` /
``ServerMerge:<key>`` / ``ServerPull:<key>`` events are the far side.
What was missing is *correlation*: which party's relay belongs to which
global round, and one timeline to see the straggler on.

Two pieces close that gap:

- a ``round_id`` rides the span ``args`` end to end — the client's
  per-key push round counter (``GeoPSClient._key_rounds``) is the wire
  round id, the server threads it through merge completion, the WAN
  relay queue and the pull replies (``service/server.py``);
- :func:`merge_traces` folds N parties' trace dumps into one document:
  every input becomes a named Chrome process, timestamps are aligned on
  each dump's wall-clock anchor (``metadata.anchor_unix_us``, written
  by ``Profiler.dump``) so skewed per-process monotonic clocks land on
  one real timeline, and every ``(key, round_id)`` group is stitched
  with Chrome *flow events* — load the merged file in
  ``chrome://tracing``/Perfetto and each WAN round draws as one arrow
  chain across parties.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

ROUND_FLOW_CAT = "wan_round"


def _load(trace) -> dict:
    if isinstance(trace, str):
        with open(trace) as f:
            return json.load(f)
    return dict(trace)


def round_key(event: dict) -> Optional[Tuple[str, int]]:
    """The (key, round_id) a trace event is correlated under, or None."""
    args = event.get("args") or {}
    rid = args.get("round_id")
    if rid is None:
        return None
    key = args.get("key")
    if key is None:
        # spans name themselves "<What>:<key>"
        name = event.get("name", "")
        key = name.split(":", 1)[1] if ":" in name else name
    return (str(key), int(rid))


def merge_traces(traces: Sequence[Any],
                 labels: Optional[Sequence[str]] = None) -> dict:
    """Merge Chrome trace docs (paths or dicts) into one document.

    Each input becomes its own Chrome process (pid = input index) with a
    ``process_name`` metadata row; event timestamps shift onto a shared
    wall-clock axis using each dump's ``metadata.anchor_unix_us`` (inputs
    without an anchor keep their own zero — correct only for same-clock
    dumps, flagged in the output metadata).  Spans/instants whose args
    carry a ``round_id`` are linked per ``(key, round_id)`` with flow
    events ordered by merged timestamp.
    """
    docs = [_load(t) for t in traces]
    anchors = [
        (d.get("metadata") or {}).get("anchor_unix_us") for d in docs]
    known = [a for a in anchors if a is not None]
    base = min(known) if known else 0.0

    out_events: List[dict] = []
    rounds: Dict[Tuple[str, int], List[dict]] = {}
    for i, doc in enumerate(docs):
        shift = (anchors[i] - base) if anchors[i] is not None else 0.0
        if labels is not None and i < len(labels):
            label = labels[i]
        else:
            rank = (doc.get("metadata") or {}).get("rank")
            label = f"rank{rank}" if rank is not None else f"party{i}"
        out_events.append({"name": "process_name", "ph": "M", "pid": i,
                           "tid": 0, "args": {"name": label}})
        for ev in doc.get("traceEvents", []):
            ev = dict(ev)
            ev["pid"] = i
            if "ts" in ev:
                ev["ts"] = ev["ts"] + shift
            out_events.append(ev)
            rk = round_key(ev)
            if rk is not None and ev.get("ph") in ("X", "i"):
                rounds.setdefault(rk, []).append(ev)

    # one flow chain per WAN round: s -> t... -> f in timestamp order.
    # Binding point is each event's own (pid, tid, ts), which Chrome
    # attaches to the enclosing slice.
    flow_id = 0
    for (key, rid), evs in sorted(rounds.items()):
        if len(evs) < 2:
            continue
        flow_id += 1
        evs = sorted(evs, key=lambda e: (e.get("ts", 0.0), e.get("pid", 0)))
        for j, ev in enumerate(evs):
            ph = "s" if j == 0 else ("f" if j == len(evs) - 1 else "t")
            flow = {"name": f"round {rid}", "cat": ROUND_FLOW_CAT,
                    "ph": ph, "id": flow_id,
                    "ts": ev.get("ts", 0.0),
                    "pid": ev.get("pid", 0), "tid": ev.get("tid", 0),
                    "args": {"key": key, "round_id": rid}}
            if ph == "f":
                flow["bp"] = "e"  # bind to enclosing slice
            out_events.append(flow)

    return {
        "traceEvents": out_events,
        "displayTimeUnit": "ms",
        "metadata": {
            "merged_from": len(docs),
            "clock_aligned": all(a is not None for a in anchors),
            "anchor_unix_us": base,
            "wan_rounds": len(rounds),
        },
    }


def process_names(doc: dict) -> Dict[int, str]:
    """pid -> label from a trace's ``process_name`` metadata rows (what
    :func:`merge_traces` writes per party) — the one place the metadata
    shape is known to the observatory consumers (attribution, links)."""
    names: Dict[int, str] = {}
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            names[ev.get("pid", 0)] = (ev.get("args") or {}).get(
                "name", str(ev.get("pid")))
    return names


def rounds_in_trace(doc: dict) -> Dict[Tuple[str, int], List[dict]]:
    """Group a (merged or single) trace's correlated events by
    (key, round_id) — the assertion surface for tests and bench."""
    out: Dict[Tuple[str, int], List[dict]] = {}
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") not in ("X", "i"):
            continue
        rk = round_key(ev)
        if rk is not None:
            out.setdefault(rk, []).append(ev)
    return out
