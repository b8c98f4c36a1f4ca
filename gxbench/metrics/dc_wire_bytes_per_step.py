"""Bytes one party puts on the WAN tier a step: the benchmark's recorder
in the program's collectives slot sums one replica's block of every
collective over the ``dc`` axis in the window, over the window's steps."""


def read(run):
    return run.out.dc_bytes / run.out.steps
