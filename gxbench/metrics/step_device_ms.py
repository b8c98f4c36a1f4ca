"""Median device ms a step between the two CUDA events the program's step
clock records on the step's stream at its entry and exit, over the
untraced steps; None on the CPU."""

from gxbench import stepclock


def read(run):
    return stepclock.median_device_ms()
