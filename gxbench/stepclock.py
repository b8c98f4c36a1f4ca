"""The program's step clock (``geomx_tpu_torch/utils/profiler.py``:
``step_records()``), as the step readers read it once the run is over:
the records of the newest step function that ran outside
``torch.profiler``, the window's steps and the first steps before it.
A program without the clock yields no records, and its readers None."""

from __future__ import annotations

import statistics
from typing import List, Optional


def window_records() -> List[object]:
    from geomx_tpu_torch.utils import profiler
    read = getattr(profiler, "step_records", None)
    records = read() if read is not None else []
    if not records:
        return []
    newest = max(r.fn for r in records)
    return [r for r in records if r.fn == newest and not r.profiled]


def median_host_ms(span: str) -> Optional[float]:
    """Median host ms a step of ``span``."""
    ms = [r.host_ns[span] / 1e6 for r in window_records()
          if span in r.host_ns]
    return statistics.median(ms) if ms else None


def median_device_ms() -> Optional[float]:
    """Median device ms between a step's two events (None on the CPU)."""
    ms = [r.device_ms for r in window_records() if r.device_ms is not None]
    return statistics.median(ms) if ms else None
