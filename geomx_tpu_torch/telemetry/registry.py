"""Process-global metric registry: Counters, Gauges, Histograms (port
of geomx_tpu/telemetry/registry.py).

The unified telemetry plane's write side.  Every subsystem (sync tiers,
host-plane servers, scheduler, resilience controller, trainer) records
into one process-global :class:`MetricRegistry`; the read side is the
Prometheus text exposition in :mod:`geomx_tpu_torch.telemetry.export` (served
from the scheduler's HTTP endpoint and ``COMMAND {cmd:"metrics"}`` on
``GeoPSServer``).

Design points, in the spirit of prometheus_client but dependency-free:

- a *family* is (name, help, type, label names); ``labels(...)`` binds a
  label-value tuple to a *child* carrying the actual number.  Families
  are idempotent to re-register (same type + labels required), so every
  call site can say ``get_registry().counter("x", ...)`` without
  coordinating module import order;
- children are cached — hot paths bind once and call ``inc()``/
  ``set()``/``observe()`` on the bound child (a dict hit + one lock);
- everything is thread-safe: the host plane records from server handler
  threads, relay shards, heartbeat loops and the training loop at once.

Metric and label names follow the Prometheus data model
(``[a-zA-Z_:][a-zA-Z0-9_:]*`` / ``[a-zA-Z_][a-zA-Z0-9_]*``); the
registry rejects invalid names at registration so a typo fails at the
call site, not in the scrape.
"""

from __future__ import annotations

import math
import re
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

_METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# prometheus_client's default histogram buckets (seconds-oriented, which
# suits the host plane's RPC latencies); callers with other units pass
# their own
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0)


class _Child:
    """One labeled series.  Subclasses add the type-specific mutators."""

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class CounterChild(_Child):
    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counters only go up (inc by {amount})")
        with self._lock:
            self._value += amount


class GaugeChild(_Child):
    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount


class HistogramChild(_Child):
    def __init__(self, buckets: Sequence[float]):
        super().__init__()
        self.upper_bounds = tuple(buckets)
        self.bucket_counts = [0] * (len(self.upper_bounds) + 1)  # +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self.sum += value
            self.count += 1
            for i, ub in enumerate(self.upper_bounds):
                if value <= ub:
                    self.bucket_counts[i] += 1
                    break
            else:
                self.bucket_counts[-1] += 1

    def snapshot(self) -> Tuple[List[int], float, int]:
        """(cumulative bucket counts incl. +Inf, sum, count) — the
        cumulative form the exposition format wants."""
        with self._lock:
            cum, acc = [], 0
            for c in self.bucket_counts:
                acc += c
                cum.append(acc)
            return cum, self.sum, self.count

    def percentile(self, q: float) -> float:
        """Linear-interpolated estimate from the bucket boundaries (for
        in-process summaries; the scrape side gets the raw buckets)."""
        cum, _s, count = self.snapshot()
        if count == 0:
            return math.nan
        target = q * count
        lo = 0.0
        for i, ub in enumerate(self.upper_bounds):
            if cum[i] >= target:
                prev = cum[i - 1] if i else 0
                frac = (target - prev) / max(cum[i] - prev, 1)
                return lo + (ub - lo) * frac
            lo = ub
        return self.upper_bounds[-1] if self.upper_bounds else math.nan


_CHILD_TYPES = {"counter": CounterChild, "gauge": GaugeChild,
                "histogram": HistogramChild}


class MetricFamily:
    def __init__(self, name: str, help: str, type: str,
                 label_names: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        if not _METRIC_NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in label_names:
            if not _LABEL_NAME_RE.match(ln) or ln.startswith("__"):
                raise ValueError(f"invalid label name {ln!r} for {name}")
        if type not in _CHILD_TYPES:
            raise ValueError(f"unknown metric type {type!r}")
        self.name = name
        self.help = help
        self.type = type
        self.label_names = tuple(label_names)
        self.buckets = tuple(sorted(set(float(b) for b in buckets)))
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], _Child] = {}
        if not self.label_names:
            # unlabeled metric: one implicit child, usable directly
            self._children[()] = self._make_child()

    def _make_child(self) -> _Child:
        if self.type == "histogram":
            return HistogramChild(self.buckets)
        return _CHILD_TYPES[self.type]()

    def labels(self, *values, **kv):
        if kv:
            if values:
                raise ValueError("pass label values positionally OR by "
                                 "keyword, not both")
            try:
                values = tuple(kv[n] for n in self.label_names)
            except KeyError as e:
                raise ValueError(
                    f"{self.name}: missing label {e.args[0]!r} "
                    f"(labels: {self.label_names})")
            if set(kv) - set(self.label_names):
                raise ValueError(
                    f"{self.name}: unknown label(s) "
                    f"{sorted(set(kv) - set(self.label_names))}")
        values = tuple(str(v) for v in values)
        if len(values) != len(self.label_names):
            raise ValueError(
                f"{self.name}: got {len(values)} label values for "
                f"{len(self.label_names)} labels {self.label_names}")
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._children[values] = self._make_child()
            return child

    def children(self) -> List[Tuple[Tuple[str, ...], _Child]]:
        with self._lock:
            return sorted(self._children.items())

    # unlabeled convenience: family acts as its own single child
    def _solo(self):
        if self.label_names:
            raise ValueError(
                f"{self.name} has labels {self.label_names}; bind with "
                ".labels(...) first")
        return self._children[()]

    def inc(self, amount: float = 1.0) -> None:
        self._solo().inc(amount)

    def set(self, value: float) -> None:
        self._solo().set(value)

    def dec(self, amount: float = 1.0) -> None:
        self._solo().dec(amount)

    def observe(self, value: float) -> None:
        self._solo().observe(value)


class MetricRegistry:
    """Name -> family table.  Registration is idempotent when the
    (type, label set) agree; a conflicting re-registration raises —
    two subsystems silently sharing a name with different schemas is a
    bug worth failing on."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, MetricFamily] = {}
        self.created_unix = time.time()

    def _register(self, name: str, help: str, type: str,
                  labels: Sequence[str], buckets=DEFAULT_BUCKETS
                  ) -> MetricFamily:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.type != type or fam.label_names != tuple(labels) \
                        or (type == "histogram" and fam.buckets != tuple(
                            sorted(set(float(b) for b in buckets)))):
                    raise ValueError(
                        f"metric {name!r} re-registered with a different "
                        f"schema: existing ({fam.type}, {fam.label_names}"
                        f"{', buckets ' + str(fam.buckets) if fam.type == 'histogram' else ''})"
                        f" vs new ({type}, {tuple(labels)})")
                return fam
            fam = MetricFamily(name, help, type, labels, buckets)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> MetricFamily:
        return self._register(name, help, "counter", labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> MetricFamily:
        return self._register(name, help, "gauge", labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS
                  ) -> MetricFamily:
        return self._register(name, help, "histogram", labels, buckets)

    def get(self, name: str) -> Optional[MetricFamily]:
        with self._lock:
            return self._families.get(name)

    def collect(self) -> Iterable[MetricFamily]:
        with self._lock:
            return [self._families[n] for n in sorted(self._families)]

    def clear(self) -> None:
        """Drop every family (test isolation)."""
        with self._lock:
            self._families.clear()


# the process-global registry every subsystem writes into
_registry = MetricRegistry()
_registry_lock = threading.Lock()


def get_registry() -> MetricRegistry:
    return _registry


def reset_registry() -> MetricRegistry:
    """Clear the global registry (tests); the object identity is kept so
    already-bound families go stale rather than resurrect — re-bind via
    get_registry() after a reset."""
    _registry.clear()
    return _registry
