"""Presolve / postsolve pipeline (host-side).

Counterpart of the reference's presolve layer (reference:
src/Presolve/Presolve.jl). Presolve is pointer-chasing, data-dependent
work — exactly what should NOT be forced into XLA — so it runs on the host
over ``ProblemData`` and emits a reduced problem for the device-side IPM,
plus an undo stack replayed in reverse by ``postsolve``.

This module currently provides the pipeline skeleton with a pass-through
reduction (no rules applied); the reduction rules land incrementally:
empty row/column, fixed variable, row singleton, forcing row, free column
singleton, dominated column (reference: src/Presolve/*.jl).
"""

from .presolve import PresolveData, postsolve

__all__ = ["PresolveData", "postsolve"]
