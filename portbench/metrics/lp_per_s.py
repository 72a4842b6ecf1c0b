"""LPs finished in the window over all of the window's time, the last
request's tail included (host clock)."""


def read(run):
    return sum(r.n for r in run.records) / run.window_s
