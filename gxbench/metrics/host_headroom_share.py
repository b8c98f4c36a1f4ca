"""How much of the device's step the host has spare: 100 x (1 - median
host ms of ``train/train_step`` / median device ms between the step's
events), from the program's step clock over the untraced steps.  At or
under 0 the host paces the step."""

from gxbench import stepclock


def read(run):
    host = stepclock.median_host_ms("train/train_step")
    device = stepclock.median_device_ms()
    if host is None or not device:
        return None
    return 100.0 * (1.0 - host / device)
