"""torch.cuda.max_memory_allocated() over the window, after
reset_peak_memory_stats() at its start: what the requests allocate and
what the program keeps between them (its device programs' cache)."""


def read(run):
    return run.window_peak_bytes / 2 ** 20 if run.window_peak_bytes else None
