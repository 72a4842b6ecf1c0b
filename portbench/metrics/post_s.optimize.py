"""Model.timings' extract + postsolve, mean a solve over the traced
window."""


def read(run):
    t = [r.stats["timings"] for r in run.records if "timings" in r.stats]
    if not t:
        return None
    return sum(d.get("extract", 0.0) + d.get("postsolve", 0.0)
               for d in t) / len(t)
