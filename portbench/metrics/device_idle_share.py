"""1 - the union of the device's busy intervals over the profiled slice's
wall (torch.profiler, CUPTI)."""


def read(run):
    p = run.profile
    if p is None or not p.has_device:
        return None
    return 1.0 - p.busy_s / p.window_s
