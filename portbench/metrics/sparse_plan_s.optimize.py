"""The ``sparse_first`` span of the ``optimize`` call record (the
sparse-first plan, its upload included), mean a solve of the traced
window."""

from portbench.calls import mean_span


def read(run):
    return mean_span(run, "optimize", "sparse_first")
