"""The device time of the pair stage's kernels (by name) over the traced
calls, in milliseconds per wavefront step."""

import _steps
import tracing


def read(run):
    k, n = _steps.kernels(run), _steps.steps(run)
    if not k or not n:
        return None
    us = sum(e - s for name, s, e in k
             if any(p in name for p in tracing.PAIR_KERNELS))
    return us / 1e3 / n if us else None
