"""The bulk load's call record (``ProblemData.load`` of 1.6 M nonzeros
into the Model's row and column lists), its wall, mean a request of the
traced window."""

from portbench.calls import window


def read(run):
    recs = window(run, "load")
    return sum(r["wall_s"] for r in recs) / len(recs) if recs else None
