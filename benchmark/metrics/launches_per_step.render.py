"""The device kernels launched over the traced calls, per wavefront step
they ran (forward steps, where a call also runs backward)."""

import _steps


def read(run):
    k, n = _steps.kernels(run), _steps.steps(run)
    if not k or not n:
        return None
    return len(k) / n
