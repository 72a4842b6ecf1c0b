"""Spans and call records of the port's host phases.

A public entry opens a call record (:class:`call`): ``Model.optimize``
(``"optimize"``), ``ProblemData.load`` (``"load"``) and ``batch_linprog``
(``"batch_linprog"``). Inside it, each :class:`span` adds its seconds and
one count under its name, and :func:`count` adds to a counter; repeats
sum, so the 128 per-problem ``load`` spans of a batch make one figure. A
call opened inside another adds to the outer record. On exit the record
goes to :data:`CALLS`, the process's record of its recent calls::

    {"entry": "optimize", "t0_ns": 1792..., "wall_s": 4.1,
     "spans": {"presolve": 0.52, ...}, "times": {"presolve": 1, ...},
     "counters": {"passes": 18, "host_reads": 6, "programs_built": 0}}

``t0_ns`` is ``time.time_ns()`` at the open, the clock of torch.profiler's
events; durations come from ``time.perf_counter_ns()``. A record holds
``str``, ``int`` and ``float`` only: it keeps no tensor, array or model
alive.

Under an active torch.profiler a span is also a ``record_function`` range,
so it shows on the trace's timeline. A range that launches device work is
recorded again on the device's timeline, so a span around a launch or a
copy takes the name the benchmark's entry gives that phase
(``portbench/entries/*.py``'s ``SPANS``); a new name (``results``,
``sparse_first/coo``, ...) wraps host-only code. With no profiler a span
costs two clock reads and a dict update, and no synchronize.
"""

from __future__ import annotations

import collections
import functools
import threading
import time

import torch
from torch.autograd import profiler as _profiler

# The records of the process's most recent calls, oldest first.
CALLS: "collections.deque[dict]" = collections.deque(maxlen=1024)

# The record open in this thread (``_open.record``), if any.
_open = threading.local()


class _Scope:
    """A context manager that also wraps a function (``@span("x")``),
    entering a fresh instance on each call."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __call__(self, fn):
        @functools.wraps(fn)
        def scoped(*args, **kwargs):
            with type(self)(self.name):
                return fn(*args, **kwargs)

        return scoped


class span(_Scope):
    """The block's seconds and one count under ``name`` in the open
    record; ``.s`` holds the seconds after the block."""

    __slots__ = ("s", "_t0", "_range")

    def __init__(self, name: str):
        self.name = name
        self.s = 0.0
        self._range = None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.s = s = (time.perf_counter_ns() - self._t0) * 1e-9
        rec = getattr(_open, "record", None)
        if rec is not None:
            name, spans, times = self.name, rec["spans"], rec["times"]
            spans[name] = spans.get(name, 0.0) + s
            times[name] = times.get(name, 0) + 1
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


class call(_Scope):
    """A call record of the entry ``name``: opened if none is open in
    this thread, else the outer record collects the block's spans and
    counters. :meth:`spans` gives what the block added."""

    __slots__ = ("outer", "record", "_base", "_t0")

    def __enter__(self):
        rec = getattr(_open, "record", None)
        self.outer = rec is not None
        if self.outer:
            self._base = dict(rec["spans"]), dict(rec["times"])
        else:
            rec = dict(entry=self.name, t0_ns=time.time_ns(), wall_s=0.0,
                       spans={}, times={}, counters={})
            self._base = {}, {}
            _open.record = rec
            self._t0 = time.perf_counter_ns()
        self.record = rec
        return self

    def __exit__(self, *exc):
        if not self.outer:
            self.record["wall_s"] = (time.perf_counter_ns() - self._t0) * 1e-9
            _open.record = None
            CALLS.append(self.record)
        return False

    def spans(self) -> dict:
        """Seconds by name of the spans that ran in the block."""
        s0, t0 = self._base
        rec = self.record
        return {k: v - s0.get(k, 0.0) for k, v in rec["spans"].items()
                if rec["times"][k] > t0.get(k, 0)}


def count(name: str, k: int = 1) -> None:
    """Add ``k`` to the open record's counter ``name``."""
    rec = getattr(_open, "record", None)
    if rec is not None:
        counters = rec["counters"]
        counters[name] = counters.get(name, 0) + int(k)
