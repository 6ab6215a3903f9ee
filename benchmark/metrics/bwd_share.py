"""The share of a gradient step's time spent in backward: the spans
around torch.autograd.grad (the device synchronised before and after) over
the calls' times, over the calls that ran outside the profiler."""

import _steps


def read(run):
    calls = [r for r in _steps.untraced(run) if "bwd_s" in r]
    if not calls:
        return None
    return sum(r["bwd_s"] for r in calls) / sum(r["call_s"] for r in calls)
