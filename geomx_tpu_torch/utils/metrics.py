"""Per-iteration measurement reporter (port of geomx_tpu/utils/metrics.py).

Parity with the reference's example-side reporter (examples/utils.py:120-192
``Measure``): collects per-iteration wall time / accuracy / loss records and
dumps a JSON file; used by examples and benchmarks.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Optional


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Linear-interpolated percentile over an already-sorted list."""
    if not sorted_vals:
        return math.nan
    if len(sorted_vals) == 1:
        return sorted_vals[0]
    pos = q * (len(sorted_vals) - 1)
    lo = int(pos)
    frac = pos - lo
    hi = min(lo + 1, len(sorted_vals) - 1)
    return sorted_vals[lo] + (sorted_vals[hi] - sorted_vals[lo]) * frac


class Measure:
    def __init__(self, output_path: Optional[str] = None):
        self.output_path = output_path
        self.records: List[Dict[str, Any]] = []
        self._begin = time.time()

    def reset_clock(self):
        self._begin = time.time()

    def add(self, **fields):
        rec = {"time": round(time.time() - self._begin, 4)}
        rec.update(fields)
        self.records.append(rec)
        return rec

    def summary(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"iterations": len(self.records)}
        if self.records:
            out["total_time"] = self.records[-1]["time"]
            for k in self.records[-1]:
                if k != "time":
                    out[f"final_{k}"] = self.records[-1][k]
            # p50/p95/p99 distribution over the MEASUREMENT fields: the
            # straggler evidence (a p99 loss 10x the p50 is invisible
            # in final_* values).  Bookkeeping columns are excluded —
            # percentiles of a cumulative clock or a monotonically
            # increasing epoch/iteration counter mean nothing.
            skip = ("time", "epoch", "iteration")
            numeric: Dict[str, List[float]] = {}
            for rec in self.records:
                for k, v in rec.items():
                    if k in skip or isinstance(v, bool) \
                            or not isinstance(v, (int, float)):
                        continue
                    if isinstance(v, float) and not math.isfinite(v):
                        continue
                    numeric.setdefault(k, []).append(float(v))
            pct: Dict[str, Dict[str, float]] = {}
            for k, vals in numeric.items():
                vals.sort()
                pct[k] = {"p50": _percentile(vals, 0.50),
                          "p95": _percentile(vals, 0.95),
                          "p99": _percentile(vals, 0.99)}
            if pct:
                out["percentiles"] = pct
        return out

    def dump(self, path: Optional[str] = None):
        """Atomic JSON dump (temp file + ``os.replace``): a crash
        mid-dump leaves the previous complete file — or nothing — never
        a truncated, unloadable record."""
        path = path or self.output_path
        if not path:
            raise ValueError("no output path")
        from geomx_tpu_torch.utils.atomicio import atomic_json_dump
        return atomic_json_dump(path, {"records": self.records,
                                       "summary": self.summary()},
                                indent=2)
