"""The traced stretch of a run, reduced to what the per-layer readers need.

``busy_us`` and the span arithmetic (a span's host ms, and the kernel
time inside the span's interval on the device timeline) are copied from
``tools/torch_profile_step.py`` (lines 59-72 and 161-179 at the commit
that added this file), so that a later change to that tool cannot move
the benchmark's yardstick.

A ``Trace`` holds, over the profiled steps: every device operation
(kernels, copies, fills) as ``(name, start_us, end_us)``; every host span
(``record_function`` ranges: the program's ``train/*``, ``bucket/*``,
``bsc/*``, ``attention/*`` and the harness's own ``gxbench/*``) with its
host interval; and each span's device-side interval.  Times are the
profiler's microseconds.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

WINDOW_SPAN = "gxbench/profiled_steps"


def busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def merged(intervals) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Trace:
    def __init__(self, device_ops, host_spans, device_spans, steps: int):
        self.steps = steps
        self.device_ops: List[Tuple[str, float, float]] = device_ops
        self.host_spans: List[Tuple[str, float, float, float]] = host_spans
        self.device_spans: Dict[str, List[Tuple[float, float]]] = \
            device_spans
        win = [s for s in host_spans if s[0] == WINDOW_SPAN]
        if win:
            self.start, self.end = win[0][1], win[0][2]
        else:
            self.start = min(s for _, s, _ in device_ops)
            self.end = max(e for _, _, e in device_ops)
        self.ops = [(n, max(s, self.start), min(e, self.end))
                    for n, s, e in device_ops
                    if s < self.end and e > self.start]

    @classmethod
    def from_profiler(cls, prof, steps: int) -> "Trace":
        from torch.autograd import DeviceType
        ops, hosts, devs = [], [], {}
        for e in prof.events():
            annot = getattr(e, "is_user_annotation", False)
            r = e.time_range
            if e.device_type == DeviceType.CUDA:
                if annot:
                    devs.setdefault(e.name, []).append((r.start, r.end))
                else:
                    ops.append((e.name, r.start, r.end))
            elif e.device_type == DeviceType.CPU and (annot or "/" in
                                                      e.name):
                hosts.append((e.name, r.start, r.end, e.cpu_time_total))
        return cls(ops, hosts, devs, steps)

    # ---- reductions ------------------------------------------------------

    @property
    def wall_us(self) -> float:
        return self.end - self.start

    def busy_us(self) -> float:
        return busy_us([(s, e) for _, s, e in self.ops])

    def op_us(self, match: Callable[[str], bool]) -> Tuple[float, int]:
        """Summed device time and count of the operations ``match``
        names."""
        hits = [e - s for n, s, e in self.ops if match(n)]
        return sum(hits), len(hits)

    def span_host_ms_per_step(self, name: str) -> Optional[float]:
        host = [c for n, _, _, c in self.host_spans if n == name]
        if not host:
            return None
        return sum(host) / self.steps / 1e3

    def span_device_busy_ms_per_step(self, name: str) -> Optional[float]:
        """The device time inside the span's device-side intervals (the
        kernels the autograd thread launched included)."""
        dev = self.device_spans.get(name)
        if not dev:
            return None
        intervals = [(s, e) for _, s, e in self.ops]
        return sum(busy_us([(max(s, r0), min(e, r1)) for s, e in intervals
                            if s < r1 and e > r0]) for r0, r1 in dev) \
            / self.steps / 1e3

    def breakdown(self, top: int = 10) -> dict:
        """The device operations with the most time (seconds over the
        profiled steps) and the device's idle time by the innermost host
        span open when each gap began."""
        by_name: Dict[str, float] = {}
        for n, s, e in self.ops:
            by_name[n] = by_name.get(n, 0.0) + (e - s)
        device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = merged([(s, e) for _, s, e in self.ops])
        gaps, t = [], self.start
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.end > t:
            gaps.append((t, self.end))
        spans = sorted((s, e, n) for n, s, e, _ in self.host_spans
                       if n != WINDOW_SPAN)
        idle: Dict[str, float] = {}
        for g0, g1 in gaps:
            owner, begun = "host, outside any span", None
            for s, e, n in spans:
                if s > g0:
                    break
                if e > g0 and (begun is None or s >= begun):
                    owner, begun = n, s
            idle[owner] = idle.get(owner, 0.0) + (g1 - g0)
        idle_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:160], us / 1e6] for n, us in device_ops],
                "idle_gaps": [[n, us / 1e6] for n, us in idle_gaps]}
