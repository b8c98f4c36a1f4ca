"""Median host ms of span ``train/train_step`` (``train/step.py``: the
whole step as the host issues it), from the program's step clock over the
untraced steps."""

from gxbench import stepclock


def read(run):
    return stepclock.median_host_ms("train/train_step")
