"""The ``results`` span of the ``batch_linprog`` call record (each lane's
extraction, postsolve and result), mean a call of the traced window, in
ms."""

from portbench.calls import mean_span


def read(run):
    s = mean_span(run, "batch_linprog", "results")
    return None if s is None else s * 1e3
