"""Percent of the card's peak that the whole step's model operations
reach: the configuration's forward operations a sample
(``gxbench/counts/<config>.py``) times three (forward and backward),
times the untraced window's samples a second, over the peak of the
configuration's arithmetic (``peak`` in the configuration file, the row
of ``gxbench/peaks.json`` for the card)."""


def read(run):
    if run.peak is None:
        return None
    flops = 3.0 * run.counts.forward_flops_per_sample(run.config)
    return 100.0 * flops * run.out.samples_per_s / \
        run.peak[run.config["peak"] + "_flops"]
