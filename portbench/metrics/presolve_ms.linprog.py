"""The per-problem ``presolve`` spans of the ``batch_linprog`` call record
(``PresolveData``, the Python presolve, the reduced problem, and the
postsolve of problems it decides), summed over a call, mean a call of the
traced window, in ms."""

from portbench.calls import mean_span


def read(run):
    s = mean_span(run, "batch_linprog", "presolve")
    return None if s is None else s * 1e3
