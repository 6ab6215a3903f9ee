"""peak_mem_MB: the largest device memory allocated during the window
(torch.cuda.max_memory_allocated after reset_peak_memory_stats at its
start), in units of 10^6 bytes."""


def read(run):
    return run.window_peak_bytes / 1e6 if run.window_peak_bytes else None
