"""The device memory a gradient step adds at its peak: the peak during the
step less the memory allocated before it, the largest over the traced
run's steps, in units of 10^6 bytes."""


def read(run):
    m = [r["step_mem_bytes"] for r in run.records if "step_mem_bytes" in r]
    return max(m) / 1e6 if m else None
