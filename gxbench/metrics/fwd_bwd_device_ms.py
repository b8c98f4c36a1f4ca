"""Device ms a step inside span ``train/forward_backward``
(``train/step.py``): the union of device operations within the span's
device-side intervals, over the profiled steps."""


def read(run):
    return run.out.trace.span_device_busy_ms_per_step(
        "train/forward_backward")
