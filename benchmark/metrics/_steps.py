"""Shared by the per-layer readers: the device operations of the traced
calls, the wavefront steps those calls ran, and the calls outside the
profiler."""

import tracing


def kernels(run):
    if run.trace is None:
        return None
    return [op for op in run.trace.device_ops if tracing.is_kernel(op[0])]


def steps(run):
    n = sum(r["steps"] for r in run.traced_records)
    return n or None


def untraced(run):
    """The window's calls that ran outside the profiler (all of them where
    none ran inside)."""
    return run.records[len(run.traced_records):] or run.records
