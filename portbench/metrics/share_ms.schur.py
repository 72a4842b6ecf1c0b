"""The ``share`` span of the ``share`` call record (rank 0's share of the
LP built and copied to its card, ``parallel.make_block_angular_share``),
in ms, mean a request of the traced window."""

from portbench.calls import mean_span


def read(run):
    s = mean_span(run, "share", "share")
    return None if s is None else s * 1e3
