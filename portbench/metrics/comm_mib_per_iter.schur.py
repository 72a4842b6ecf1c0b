"""Rank 0's bytes of collectives in a solve (the ``comm_bytes`` counter of
its ``hsd_solve`` call record) over the solve's iterations, in MiB, mean a
request of the traced window."""

from portbench.calls import window


def read(run):
    recs = window(run, "hsd_solve")
    if not recs:
        return None
    per = []
    for rec, r in zip(recs, run.records):
        iters = sum(s["iters"] for s in r.spans if s["name"] == "ipm")
        nbytes = rec["counters"].get("comm_bytes")
        if nbytes is None or not iters:
            return None
        per.append(nbytes / iters / 2 ** 20)
    return sum(per) / len(per)
