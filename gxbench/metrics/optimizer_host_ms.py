"""Host ms a step of span ``train/optimizer`` (``train/step.py``: the
per-leaf optimizer or the fused apply), over the profiled steps."""


def read(run):
    return run.out.trace.span_host_ms_per_step("train/optimizer")
