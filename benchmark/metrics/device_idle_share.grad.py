"""1 - (the union of the device operations' intervals) / (the traced
window): the share of the traced calls' time in which the device ran
nothing."""

import tracing


def read(run):
    tr = run.trace
    if tr is None or not tr.device_ops:
        return None
    return 1.0 - tracing.busy_us(tr) / tracing.window_us(tr)
