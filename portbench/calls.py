"""The program's own call records of a traced run's window, for the
per-layer metrics that read them (``tulip_tpu_torch.trace.CALLS``).

Each request of a cell opens one record of its entry (``"load"`` and
``"optimize"`` for ``Model.optimize``'s, ``"batch_linprog"`` for
``batch_linprog``'s). After the window the profiled slice runs S more
requests, and set-up ran some before it, so the window's W records are the
last W + S of the entry's but the last S.
"""

from __future__ import annotations

from typing import Optional


def window(run, entry: str) -> Optional[list]:
    """The window's records of ``entry``, oldest first; None where the
    program keeps no call records (a build from before them) or fewer than
    the window and the slice made."""
    try:
        from tulip_tpu_torch import trace
    except ImportError:
        return None
    if run.profile is None or not run.records:
        return None
    recs = [r for r in trace.CALLS if r["entry"] == entry]
    w, s = len(run.records), run.profile.requests
    if len(recs) < w + s:
        return None
    return recs[len(recs) - w - s:len(recs) - s]


def mean_span(run, entry: str, name: str) -> Optional[float]:
    """Seconds of the span ``name`` summed over a call, mean a call of the
    window (0 for a call that did not run it)."""
    recs = window(run, entry)
    if not recs:
        return None
    return sum(r["spans"].get(name, 0.0) for r in recs) / len(recs)
