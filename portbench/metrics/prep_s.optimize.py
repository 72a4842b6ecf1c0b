"""Model.timings' presolve + standard_form (the sparse-first plan
included), mean a solve over the traced window."""


def read(run):
    t = [r.stats["timings"] for r in run.records if "timings" in r.stats]
    if not t:
        return None
    return sum(d.get("presolve", 0.0) + d.get("standard_form", 0.0)
               for d in t) / len(t)
