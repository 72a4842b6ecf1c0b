"""The IPM spans' seconds over their iterations (the largest lane's niter
of each call), summed over the traced window, in ms."""


def read(run):
    calls = [s for r in run.records for s in r.spans if s["name"] == "ipm"]
    iters = sum(s["iters"] for s in calls)
    if not iters:
        return None
    return sum(s["s"] for s in calls) / iters * 1e3
