"""Reduction of a ``torch.profiler`` trace to what the per-layer readers
read: the device operations with their intervals, the host operations, the
union of the device's busy intervals over the traced window, the device
operations that took most time, and the longest idle gaps named by what
the host was doing during each."""

from __future__ import annotations

from typing import NamedTuple

# The port's own kernels, by the names their launches carry in a trace.
PAIR_KERNELS = ("pair_major_kernel", "pair_tile_isect_kernel",
                "pair_segmin_kernel", "pair_tile_isect_dedup_kernel")


class Trace(NamedTuple):
    device_ops: list    # (name, start_us, end_us), device operations
    host_ops: list      # (name, start_us, end_us), host operations
    window: tuple       # (start_us, end_us) of the traced window


def from_profile(prof, t0_ns: int, t1_ns: int) -> Trace:
    """The trace of ``prof`` over the traced window ``t0_ns``-``t1_ns``
    (``time.time_ns()`` marks taken, the device synchronised, as the
    profiler started and before it stopped: its events carry that clock).
    Where the events do not lie inside the marks, the window is what the
    trace spans: the first host operation to the last device operation's
    end."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        end = start + e.duration_ns() / 1e3
        if "CUDA" in str(e.device_type()):
            dev.append((e.name(), start, end))
        else:
            host.append((e.name(), start, end))
    if not dev and not host:
        return Trace([], [], (0.0, 0.0))
    lo = min(s for _, s, _ in host) if host else min(s for _, s, _ in dev)
    hi = max([e for _, _, e in dev] + [e for _, _, e in host])
    m0, m1 = t0_ns / 1e3, t1_ns / 1e3
    if m0 - 1e3 <= lo and hi <= m1 + 1e3:
        lo, hi = m0, max(m1, hi)
    return Trace(dev, host, (lo, hi))


def is_kernel(name: str) -> bool:
    """A kernel launch, not a copy or a fill issued by the runtime."""
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


def busy_intervals(tr: Trace) -> list:
    """The union of the device operations' intervals, sorted."""
    out = []
    for _, s, e in sorted(tr.device_ops, key=lambda x: x[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_us(tr: Trace) -> float:
    return sum(e - s for s, e in busy_intervals(tr))


def window_us(tr: Trace) -> float:
    return tr.window[1] - tr.window[0]


def top_device_ops(tr: Trace, n: int = 10) -> list:
    """[[name, seconds], ...]: the device operations that took most time,
    summed by name."""
    by = {}
    for name, s, e in tr.device_ops:
        by[name] = by.get(name, 0.0) + (e - s)
    top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    return [[k[:120], v / 1e6] for k, v in top]


def idle_gaps(tr: Trace, n: int = 10) -> list:
    """[[host operation, seconds], ...]: the longest gaps in which the
    device ran nothing, each named by the innermost host operation running
    at its middle (``idle`` where none was)."""
    busy = busy_intervals(tr)
    gaps = []
    prev = tr.window[0]
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if tr.window[1] > prev:
        gaps.append((prev, tr.window[1]))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
    host = sorted(tr.host_ops, key=lambda x: x[1])
    out = []
    for s, e in gaps:
        mid = 0.5 * (s + e)
        name, width = "idle", float("inf")
        for hn, hs, he in host:
            if hs > mid:
                break
            if he >= mid and he - hs < width:
                name, width = hn, he - hs
        out.append([name[:120], (e - s) / 1e6])
    return out
