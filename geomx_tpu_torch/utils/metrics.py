"""Per-iteration measurement reporter (copy of geomx_tpu/utils/metrics.py,
``Measure`` without its summary and dump)."""

from __future__ import annotations

import time
from typing import Any, Dict, List


class Measure:
    def __init__(self):
        self.records: List[Dict[str, Any]] = []
        self._begin = time.time()

    def reset_clock(self):
        self._begin = time.time()

    def add(self, **fields):
        rec = {"time": round(time.time() - self._begin, 4)}
        rec.update(fields)
        self.records.append(rec)
        return rec
