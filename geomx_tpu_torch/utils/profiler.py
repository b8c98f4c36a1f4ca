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

:func:`span` is the port's one span API: every named region of the
program enters it, so ``torch.profiler`` sees it as a
``record_function`` range, a running :class:`Profiler` as a Chrome
event (:meth:`Profiler.scope`), and the step clock as host time.

The step clock (:class:`StepClock`, read by :func:`step_records`) keeps
each training step's own timing without the profiler: the step
(``train/step.py``) opens a :class:`StepRecord` for its mesh slot, every
span inside it adds its host time there, and two CUDA events on the
step's stream give its device time.  It is always on.

The reference can also drive profilers on *remote PS servers* from a worker
via kvstore commands (kSetProfilerParams, src/kvstore/kvstore_dist.h:197-203;
server side src/kvstore/kvstore_dist_server.h:383-430, filename prefixed
with the server's rank at :415).  `GeoPSServer` exposes the same surface:
COMMAND {cmd: "set_profiler_params"|"profiler_start"|"profiler_stop"|
"profiler_dump"}, with the dump path prefixed ``rank<k>_``.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Any, Dict, List, Optional

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.profiler import ProfilerActivity, record_function

from geomx_tpu_torch.parallel.collectives import owning_slot, records_here

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

    def scope(self, name: str, category: str = "host",
              args: Optional[Dict] = None) -> "span":
        """A :func:`span` that also records a named duration in this
        profiler while it runs (the analogue of engine ops carrying
        profiler names, kvstore_dist.h:654).

        ``args`` attaches structured metadata to the Chrome-trace event —
        the bucketed communication engine uses it to report per-bucket
        payload sizes ({"bucket", "elems", "padded", "payload_bytes"})."""
        return span(name, category, args, profiler=self)

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


class span:
    """A named region of the program: always a range of the profiler's
    own record functions (so ``torch.profiler`` times it on its clock and
    its trace can put an idle gap down to it), a Chrome event of
    ``profiler`` while that :class:`Profiler` runs, and host time
    (``time.perf_counter_ns``) added under ``name`` to the step record
    open for the calling thread's slot (``collectives.owning_slot``: on
    the autograd thread, the slot a backward node is attributed to).

    ``annotation``: the range is a ``record_function`` user annotation:
    the device trace books to it every kernel launched inside it and in
    no annotation nested deeper, and draws the span's device-side
    interval around them.  False: a host range alone
    (``_RecordFunctionFast``, a fraction of the host cost), as the step
    clock's own spans are: nested in ``train/forward_backward``, whose
    device interval is read, an annotation would take the phase's
    kernels from it."""

    __slots__ = ("name", "category", "args", "profiler", "annotation",
                 "_rf", "_rec", "_t0", "_begin_us")

    def __init__(self, name: str, category: str = "host",
                 args: Optional[Dict] = None,
                 profiler: Optional[Profiler] = None,
                 annotation: bool = True):
        self.name = name
        self.category = category
        self.args = args
        self.profiler = profiler
        self.annotation = annotation

    def __enter__(self) -> "span":
        prof = self.profiler
        if prof is not None and prof.running:
            self._begin_us = prof._now_us()
        else:
            self._begin_us = None
        self._rec = _CLOCK.current()
        self._rf = record_function(self.name) if self.annotation \
            else _RecordFunctionFast(self.name)
        self._rf.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        dt = time.perf_counter_ns() - self._t0
        self._rf.__exit__(*exc)
        rec = self._rec
        if rec is not None:
            h = rec.host_ns
            h[self.name] = h.get(self.name, 0) + dt
        if self._begin_us is not None:
            self.profiler.add_event(self.name, self._begin_us,
                                    self.profiler._now_us(), self.category,
                                    self.args)


# ---- the step clock ---------------------------------------------------------

STEP_SPAN = "train/train_step"
STEPS_TOTAL = "geomx_train_steps_total"


class StepRecord:
    """One training step's own timing, kept by :class:`StepClock`.

    ``host_ns``: host nanoseconds by span name, summed over the step's
    spans of that name (the replica loop's repeats, the backward the
    autograd thread runs for the step); ``wall_ns``: the step's host
    wall; ``device_ms``: the device time between the two events recorded
    on the step's stream at its entry and exit (None on the CPU, while
    the stream captures a graph, or while the events are unresolved);
    ``profiled``: whether ``torch.profiler`` was active; ``slot``: the
    mesh slot's coordinates (None off a mesh); ``fn``: the id of the
    step function that made it (:meth:`StepClock.new_fn`)."""

    __slots__ = ("fn", "slot", "profiled", "host_ns", "wall_ns",
                 "device_ms", "_stream", "_events", "_t0", "_prev")

    def __init__(self, fn: int, slot, profiled: bool):
        self.fn = fn
        self.slot = slot
        self.profiled = profiled
        self.host_ns: Dict[str, int] = {}
        self.wall_ns = 0
        self.device_ms: Optional[float] = None
        self._stream = self._events = self._prev = None

    def __repr__(self) -> str:
        return (f"StepRecord(fn={self.fn}, slot={self.slot}, "
                f"profiled={self.profiled}, wall_ns={self.wall_ns}, "
                f"device_ms={self.device_ms}, host_ns={self.host_ns})")


class StepClock:
    """The records of every training step, the newest ``ring`` a slot.

    A step's two events come from a pool a device; an older record's
    events are resolved with ``Event.query()`` when a later step opens,
    so a step never waits for the device, and :meth:`records` waits once
    for what is still unresolved.  Off a mesh the process is one slot
    (None), which the autograd thread's spans find: two threads stepping
    at once outside a mesh would share its open record."""

    def __init__(self, ring: int = 4096):
        self.ring = ring
        self._lock = threading.Lock()
        self._fn_ids = itertools.count(1)
        self._rings: Dict[Any, collections.deque] = {}
        self._unresolved: Dict[Any, collections.deque] = {}
        self._pool: Dict[torch.device, list] = {}
        # slot coords -> the record open there; a slot's thread writes
        # only its own key
        self._open: Dict[Any, StepRecord] = {}

    def new_fn(self) -> int:
        """A fresh id for a step function."""
        return next(self._fn_ids)

    def current(self) -> Optional[StepRecord]:
        """The record open for the calling thread's slot, if any."""
        if not self._open:
            return None
        slot = owning_slot()
        return self._open.get(None if slot is None else slot.coords)

    def open(self, fn: int, device: torch.device) -> StepRecord:
        """Open a step's record for the calling thread's slot and record
        its entry event on ``device``'s current stream."""
        slot = owning_slot()
        key = None if slot is None else slot.coords
        rec = StepRecord(fn, key, torch._C._autograd._profiler_enabled())
        if device.type == "cuda" and \
                not torch.cuda.is_current_stream_capturing():
            self._resolve(key, wait=False)
            rec._stream = torch.cuda.current_stream(device)
            rec._events = (self._take(rec._stream.device),
                           self._take(rec._stream.device))
            rec._events[0].record(rec._stream)
        rec._prev = self._open.get(key)
        self._open[key] = rec
        rec._t0 = time.perf_counter_ns()
        return rec

    def close(self, rec: StepRecord) -> None:
        """Close ``rec``: its exit event, its host wall, its place in the
        slot's ring; one more ``geomx_train_steps_total`` (slot (0, 0)
        alone on a mesh, as a step's collectives count once)."""
        if rec._events is not None:
            rec._events[1].record(rec._stream)
        rec.wall_ns = time.perf_counter_ns() - rec._t0
        key = rec.slot
        if rec._prev is None:
            self._open.pop(key, None)
        else:
            self._open[key] = rec._prev
        rec._prev = None
        with self._lock:
            ring = self._rings.get(key)
            if ring is None:
                ring = self._rings[key] = collections.deque(maxlen=self.ring)
                self._unresolved[key] = collections.deque()
            ring.append(rec)
            if rec._events is not None:
                self._unresolved[key].append(rec)
        if records_here():
            # imported here: the telemetry package imports this module
            from geomx_tpu_torch.telemetry.registry import get_registry
            get_registry().counter(STEPS_TOTAL, "Training steps run").inc()

    def _take(self, device: torch.device):
        with self._lock:
            pool = self._pool.get(device)
            if pool:
                return pool.pop()
        return torch.cuda.Event(enable_timing=True)

    def _resolve(self, key, wait: bool) -> None:
        """Read the device times of ``key``'s unresolved records, oldest
        first: those whose exit event has completed, or every one with
        ``wait`` (the caller synchronized)."""
        with self._lock:
            pending = self._unresolved.get(key)
            while pending:
                rec = pending[0]
                start, end = rec._events
                if not wait and not end.query():
                    break
                pending.popleft()
                rec.device_ms = start.elapsed_time(end)
                rec._events = None
                self._pool.setdefault(rec._stream.device, []).extend(
                    (start, end))

    def records(self) -> List[StepRecord]:
        """Every kept record, a slot's oldest first, after one wait for
        the devices whose events are still unresolved."""
        with self._lock:
            devices = {r._stream.device for q in self._unresolved.values()
                       for r in q}
            keys = list(self._rings)
        for device in devices:
            torch.cuda.synchronize(device)
        for key in keys:
            self._resolve(key, wait=True)
        with self._lock:
            return [r for key in keys for r in self._rings[key]]


_CLOCK = StepClock()


def step_clock() -> StepClock:
    """The process's step clock."""
    return _CLOCK


def step_records() -> List[StepRecord]:
    """The step clock's records (:meth:`StepClock.records`)."""
    return _CLOCK.records()
