"""The share of an image's time spent in the exact repair (rendering the
suspect pixels of an overflowing image again with the fallback attached):
the span around each image's repair step over the calls' times, over the
calls that ran outside the profiler."""

import _steps


def read(run):
    calls = [r for r in _steps.untraced(run) if "repair_s" in r]
    if not calls:
        return None
    return sum(r["repair_s"] for r in calls) / sum(r["call_s"] for r in calls)
