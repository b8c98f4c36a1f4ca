"""Median host ms of span ``train/forward_backward`` (``train/step.py``:
the replica loop's forwards and backwards and the stacks), from the
program's step clock over the untraced steps."""

from gxbench import stepclock


def read(run):
    return stepclock.median_host_ms("train/forward_backward")
