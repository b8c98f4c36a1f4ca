"""Percent of the profiled steps' wall time in which no operation ran on
the device: 100 (1 - union of device intervals / wall)."""


def read(run):
    tr = run.out.trace
    if not tr.ops:
        return None
    return 100.0 * (1.0 - tr.busy_us() / tr.wall_us)
