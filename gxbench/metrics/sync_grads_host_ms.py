"""Host ms a step of span ``train/sync_grads`` (``train/step.py``: the
worker mean and the dc tier, ``sync/fsa.py``), over the profiled steps."""


def read(run):
    return run.out.trace.span_host_ms_per_step("train/sync_grads")
