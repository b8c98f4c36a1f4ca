"""The 90th percentile (nearest rank) of the host-clock step times of the
untraced window: a step from the end of the last loss read to the end of
its own."""

import math


def read(run):
    t = sorted(run.out.step_s)
    if not t:
        return None
    return t[math.ceil(0.9 * len(t)) - 1] * 1e3
