"""Samples (images, sequences) of every step the window completed, over
the window's host-clock seconds (the last step's device work included)."""


def read(run):
    return run.out.samples_per_s
