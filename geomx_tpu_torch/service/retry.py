"""One retry discipline for the host plane (port of
geomx_tpu/service/retry.py).

``service/client.py`` grew ~10 ad-hoc ``except OSError`` retry loops
(relay retransmits, reconnects, resend timers), each with its own
constants and none of them observable.  This module is the single
replacement: a **seeded-jitter exponential backoff** (deterministic
delay sequence for a given seed — chaos replays reproduce their retry
timing) and a process-global ``geomx_rpc_retries_total{op}`` counter so
retry pressure shows up on the telemetry plane instead of only in
tail-latency mysteries.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, Tuple

def count_retry(op: str, amount: int = 1) -> None:
    """Bump ``geomx_rpc_retries_total{op}``.  The registry is resolved
    per call (registration is idempotent) so a test-time registry reset
    never orphans a cached child — retries are off the hot path by
    definition, so the extra dict lookups don't matter."""
    from geomx_tpu_torch.telemetry import get_registry
    get_registry().counter(
        "geomx_rpc_retries_total",
        "Host-plane RPC retries, by operation",
        ("op",)).labels(op=op).inc(amount)


class SeededBackoff:
    """Deterministic jittered exponential backoff.

    ``next()`` yields ``min(max_s, base_s * factor**i)`` scaled by a
    jitter factor drawn uniformly from ``[1 - jitter, 1]`` out of a
    seeded RNG — bounded above by the un-jittered curve, so total retry
    time stays predictable, while distinct seeds decorrelate thundering
    herds.  The same seed always produces the same delay sequence,
    which is what makes chaos-replay retry timing reproducible."""

    def __init__(self, seed: int = 0, base_s: float = 0.05,
                 factor: float = 2.0, max_s: float = 2.0,
                 jitter: float = 0.5):
        if base_s <= 0 or factor < 1.0 or max_s < base_s:
            raise ValueError(
                f"bad backoff shape (base={base_s}, factor={factor}, "
                f"max={max_s})")
        if not 0.0 <= jitter < 1.0:
            raise ValueError(f"jitter must be in [0, 1) (got {jitter})")
        self._rng = random.Random(seed)
        self.base_s = float(base_s)
        self.factor = float(factor)
        self.max_s = float(max_s)
        self.jitter = float(jitter)
        self.attempts = 0

    def next(self) -> float:
        raw = min(self.max_s, self.base_s * self.factor ** self.attempts)
        self.attempts += 1
        scale = 1.0 - self.jitter * self._rng.random()
        return raw * scale

    def reset(self) -> None:
        self.attempts = 0


def call_with_retries(op: str, fn: Callable[[], object], *,
                      attempts: int,
                      backoff: Optional[SeededBackoff] = None,
                      exceptions: Tuple[type, ...] = (OSError,),
                      should_stop: Optional[Callable[[], bool]] = None,
                      sleep: Callable[[float], None] = time.sleep):
    """Run ``fn`` up to ``attempts`` times.  Each retry sleeps the
    backoff's next delay and bumps ``geomx_rpc_retries_total{op}``.
    ``should_stop`` (e.g. a closed-flag check) aborts between attempts
    by re-raising the last failure.  The final failure always
    propagates."""
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1 (got {attempts})")
    bo = backoff or SeededBackoff()
    last: Optional[BaseException] = None
    for i in range(attempts):
        if i:
            count_retry(op)
            sleep(bo.next())
        try:
            return fn()
        except exceptions as e:  # noqa: PERF203 — retry loop by design
            last = e
            if should_stop is not None and should_stop():
                break
    assert last is not None
    raise last
