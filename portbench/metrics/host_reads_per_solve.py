"""The device program's host reads (ipm/graph.py LAST["host_reads"]), mean
an IPM call over the traced window."""


def read(run):
    reads = [s["host_reads"] for r in run.records for s in r.spans
             if s["name"] == "ipm" and s["host_reads"] is not None]
    return sum(reads) / len(reads) if reads else None
