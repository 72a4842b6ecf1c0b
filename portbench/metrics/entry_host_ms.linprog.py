"""A request's wall minus its IPM span (the wrapper around
batched_hsd_solve, ending in a synchronize), mean a request over the
traced window: the host side of batch_linprog."""


def read(run):
    rows = [(r.s, sum(s["s"] for s in r.spans if s["name"] == "ipm"))
            for r in run.records]
    rows = [(w, ipm) for w, ipm in rows if ipm > 0]
    if not rows:
        return None
    return sum(w - ipm for w, ipm in rows) / len(rows) * 1e3
