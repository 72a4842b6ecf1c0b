"""The per-problem ``load`` spans of the ``batch_linprog`` call record
(``ProblemData`` and ``_fill_pbdata``: the scipy dicts into row and column
lists), summed over a call, mean a call of the traced window, in ms."""

from portbench.calls import mean_span


def read(run):
    s = mean_span(run, "batch_linprog", "load")
    return None if s is None else s * 1e3
