"""Small networking helpers shared by tests, examples and chip_smoke.py
(port of geomx_tpu/utils/net.py)."""

from __future__ import annotations

import socket


def free_port_blocks(*sizes: int):
    """One kernel-assigned base port per requested block size, each with
    size-1 consecutive free successors (the PS plane derives per-party
    ports as base + party_id).  Every reservation socket is held open
    until ALL blocks are chosen, so blocks never overlap each other;
    binding instead of guessing lets concurrent processes on one machine
    each get distinct ephemeral ports from the kernel.

    The ports are free at return time, not leased — the caller must bind
    them promptly (the usual bind-0 handoff race, acceptable because the
    kernel hands out ephemeral ports round-robin).
    """
    held, bases = [], []
    try:
        for n in sizes:
            for _attempt in range(64):
                socks = []
                try:
                    s0 = socket.socket()
                    s0.bind(("127.0.0.1", 0))
                    base = s0.getsockname()[1]
                    socks.append(s0)
                    for i in range(1, n):
                        s = socket.socket()
                        s.bind(("127.0.0.1", base + i))
                        socks.append(s)
                    held.extend(socks)
                    bases.append(base)
                    break
                except (OSError, OverflowError):  # Overflow: base+i > 65535
                    for s in socks:
                        s.close()
            else:
                raise RuntimeError("could not reserve a free port block")
    finally:
        for s in held:
            s.close()
    return bases
