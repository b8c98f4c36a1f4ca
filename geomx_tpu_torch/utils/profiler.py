"""Tracing/profiling: Chrome-trace event recording + device traces
(port of geomx_tpu/utils/profiler.py).

Parity with the reference's profiler subsystem (src/profiler/profiler.h:256,
aggregate_stats.cc): named scopes are recorded as Chrome trace events and
dumped to a ``chrome://tracing``-loadable JSON file; ``aggregate_stats()``
reproduces the reference's per-name aggregate table (count/total/min/max/avg).
Device-side profiling delegates to ``torch.profiler`` where the JAX
package uses ``jax.profiler``: a ``profile`` over the CPU and CUDA
activities between ``start_device_trace``/``stop_device_trace``, written
as a Chrome trace, and ``record_function`` annotations for the scopes.

The reference can also drive profilers on *remote PS servers* from a worker
via kvstore commands (kSetProfilerParams, src/kvstore/kvstore_dist.h:197-203;
server side src/kvstore/kvstore_dist_server.h:383-430, filename prefixed
with the server's rank at :415).  `GeoPSServer` exposes the same surface:
COMMAND {cmd: "set_profiler_params"|"profiler_start"|"profiler_stop"|
"profiler_dump"}, with the dump path prefixed ``rank<k>_``.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Any, Dict, List, Optional

import torch
from torch.profiler import ProfilerActivity, record_function

class Profiler:
    """Host-side Chrome-trace profiler with optional device trace capture.

    Modes mirror the reference's MXSetProcessProfilerConfig /
    MXDumpProcessProfile cycle: configure -> set_state(run) ->
    scopes/events accumulate -> dump.
    """

    def __init__(self, filename: str = "profile.json",
                 profile_all: bool = True,
                 rank: Optional[int] = None,
                 max_events: int = 1_000_000):
        self.filename = filename
        self.profile_all = profile_all
        self.rank = rank
        self.running = False
        # bounded buffer: a profiler left running for a long job must
        # not grow without limit — past max_events new events are
        # DROPPED and counted, and the dump metadata reports both
        # (num_events / dropped_events) so a truncated trace is
        # self-describing instead of silently partial
        self.max_events = int(max_events)
        self._dropped = 0
        self._events: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        # wall-clock anchor of the trace's t=0: merge_traces
        # (telemetry/tracing.py) aligns per-process monotonic clocks on
        # it, so N parties' dumps land on one real timeline
        self._anchor_unix_us = time.time() * 1e6
        self._device_trace_dir: Optional[str] = None
        self._device_trace: Optional[torch.profiler.profile] = None
        # stable registry-assigned trace lane per thread:
        # threading.get_ident() % 100000 could alias two threads into one
        # lane, so the first event from a thread claims the next small id
        # and the thread's name becomes lane metadata at dump time
        self._tid_ids: Dict[int, int] = {}
        self._tid_names: Dict[int, str] = {}

    # ---- configuration (reference kSetProfilerParams payload) -------------
    def set_config(self, filename: Optional[str] = None,
                   profile_all: Optional[bool] = None,
                   **_ignored) -> None:
        if filename is not None:
            self.filename = filename
        if profile_all is not None:
            self.profile_all = bool(profile_all)

    def set_state(self, run: bool) -> None:
        self.running = bool(run)

    # ---- event recording ---------------------------------------------------
    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def now_us(self) -> float:
        """The trace clock (microseconds since profiler construction) —
        the same timebase event ``ts`` values carry, so a caller can
        mark a window boundary and later attribute only spans recorded
        after it (``attribute_trace(..., since_us=...)``)."""
        return self._now_us()

    def _tid_locked(self) -> int:
        """Stable small trace-lane id for the calling thread (caller
        holds self._lock)."""
        ident = threading.get_ident()
        tid = self._tid_ids.get(ident)
        if tid is None:
            tid = self._tid_ids[ident] = len(self._tid_ids)
            self._tid_names[tid] = threading.current_thread().name
        return tid

    def _append_locked(self, ev: Dict[str, Any]) -> None:
        """Record one event under the buffer cap (caller holds
        self._lock): past max_events the event is dropped and counted."""
        if len(self._events) >= self.max_events:
            self._dropped += 1
            return
        self._events.append(ev)

    def add_event(self, name: str, begin_us: float, end_us: float,
                  category: str = "host", args: Optional[Dict] = None):
        if not self.running:
            return
        with self._lock:
            self._append_locked({
                "name": name, "cat": category, "ph": "X",
                "ts": begin_us, "dur": end_us - begin_us,
                "pid": os.getpid(), "tid": self._tid_locked(),
                "args": args or {},
            })

    def instant(self, name: str, category: str = "host",
                args: Optional[Dict] = None):
        if not self.running:
            return
        with self._lock:
            ev = {
                "name": name, "cat": category, "ph": "i", "s": "g",
                "ts": self._now_us(), "pid": os.getpid(),
                "tid": self._tid_locked(),
            }
            if args:
                ev["args"] = dict(args)
            self._append_locked(ev)

    def counter(self, name: str, values: Dict[str, float],
                category: str = "host"):
        """Chrome-trace counter sample (ph "C"): a named value track.
        The pipelined sync engine (sync/pipeline.py) samples
        ``<axis>_pipeline_inflight`` {bytes} here so the trace shows the
        WAN payload parked between its launch span and the next step's
        apply span."""
        if not self.running:
            return
        with self._lock:
            self._append_locked({
                "name": name, "cat": category, "ph": "C",
                "ts": self._now_us(), "pid": os.getpid(),
                "args": dict(values),
            })

    @contextlib.contextmanager
    def scope(self, name: str, category: str = "host",
              args: Optional[Dict] = None):
        """Record a named duration; also annotates the torch.profiler
        trace (``record_function``) so the scope shows up inside device
        profiles (the analogue of
        engine ops carrying profiler names, kvstore_dist.h:654).

        ``args`` attaches structured metadata to the Chrome-trace event —
        the bucketed communication engine uses it to report per-bucket
        payload sizes ({"bucket", "elems", "padded", "payload_bytes"})."""
        if not self.running:
            yield
            return
        begin = self._now_us()
        try:
            with record_function(name):
                yield
        finally:
            self.add_event(name, begin, self._now_us(), category, args)

    # ---- device traces ---------------------------------------------------------
    def start_device_trace(self, logdir: str) -> None:
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._device_trace = torch.profiler.profile(activities=activities)
        self._device_trace.start()
        self._device_trace_dir = logdir

    def stop_device_trace(self) -> Optional[str]:
        """Stop the device trace and write it as a Chrome trace under
        the ``logdir`` it started with; returns the file's path."""
        if self._device_trace_dir is None:
            return None
        self._device_trace.stop()
        os.makedirs(self._device_trace_dir, exist_ok=True)
        path = os.path.join(self._device_trace_dir,
                            f"device_trace_{os.getpid()}.json")
        self._device_trace.export_chrome_trace(path)
        self._device_trace = None
        self._device_trace_dir = None
        return path

    # ---- output ------------------------------------------------------------
    def _dump_path(self) -> str:
        # reference prefixes the dump filename with the server's rank
        # (kvstore_dist_server.h:415)
        if self.rank is None:
            return self.filename
        d, b = os.path.split(self.filename)
        return os.path.join(d, f"rank{self.rank}_{b}")

    def to_doc(self) -> Dict[str, Any]:
        """The trace as a Chrome document (what ``dump`` serializes):
        events plus lane-name metadata rows, with self-describing
        accounting in ``metadata`` — ``num_events``/``num_spans`` this
        trace holds and ``dropped_events`` the buffer cap discarded, so
        a truncated trace announces its truncation instead of reading
        as a complete record (the in-process consumer is the step-time
        attribution layer, telemetry/attribution.py)."""
        with self._lock:
            events = list(self._events)
            names = dict(self._tid_names)
            dropped = self._dropped
        pid = os.getpid()
        num_spans = sum(1 for e in events if e.get("ph") == "X")
        for tid, tname in sorted(names.items()):
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": tid, "args": {"name": tname}})
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "metadata": {"anchor_unix_us": self._anchor_unix_us,
                             "rank": self.rank,
                             "num_events": len(events),
                             "num_spans": num_spans,
                             "dropped_events": dropped}}

    def dump(self, path: Optional[str] = None) -> str:
        """Write the Chrome trace ATOMICALLY: serialize to a temp file in
        the destination directory and ``os.replace`` it into place, so a
        crash (or a concurrent reader) mid-dump can never observe a
        truncated, unloadable trace.  Thread-name metadata rows label
        each registry-assigned lane; ``metadata.anchor_unix_us`` is the
        wall-clock anchor ``merge_traces`` aligns cross-party dumps on;
        ``metadata.num_events``/``num_spans``/``dropped_events`` record
        the trace's own span accounting (``to_doc``)."""
        path = path or self._dump_path()
        from geomx_tpu_torch.utils.atomicio import atomic_json_dump
        return atomic_json_dump(path, self.to_doc())

    def aggregate_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-name {count,total_us,min_us,max_us,avg_us} — the reference's
        AggregateStats table (src/profiler/aggregate_stats.cc)."""
        out: Dict[str, Dict[str, float]] = {}
        with self._lock:
            for e in self._events:
                if e.get("ph") != "X":
                    continue
                s = out.setdefault(e["name"], {
                    "count": 0, "total_us": 0.0,
                    "min_us": float("inf"), "max_us": 0.0})
                s["count"] += 1
                s["total_us"] += e["dur"]
                s["min_us"] = min(s["min_us"], e["dur"])
                s["max_us"] = max(s["max_us"], e["dur"])
        for s in out.values():
            s["avg_us"] = s["total_us"] / max(s["count"], 1)
        return out

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._dropped = 0


# Process-global profiler, like the reference's Profiler::Get() singleton.
_global: Optional[Profiler] = None
_global_lock = threading.Lock()


def get_profiler() -> Profiler:
    global _global
    with _global_lock:
        if _global is None:
            _global = Profiler()
        return _global


@contextlib.contextmanager
def profile_scope(name: str, category: str = "host",
                  args: Optional[Dict] = None):
    with get_profiler().scope(name, category, args=args):
        yield
