"""Termination and solution status codes.

Mirrors the reference's status vocabulary (reference: src/status.jl:15-49)
but as integer enums so statuses can live inside jitted device code as int32
scalars (branchless status updates, batched solves).
"""

import enum


class TerminationStatus(enum.IntEnum):
    """Why the solver stopped (reference: src/status.jl:15-29)."""

    NOT_CALLED = 0
    UNKNOWN = 1
    # OK statuses
    OPTIMAL = 2
    PRIMAL_INFEASIBLE = 3
    DUAL_INFEASIBLE = 4
    PRIMAL_DUAL_INFEASIBLE = 5
    # Limits
    ITERATION_LIMIT = 6
    TIME_LIMIT = 7
    # Errors
    MEMORY_LIMIT = 8
    NUMERICAL_PROBLEM = 9


class SolutionStatus(enum.IntEnum):
    """Status of a primal or dual solution (reference: src/status.jl:43-49)."""

    UNKNOWN = 0
    OPTIMAL = 1
    FEASIBLE_POINT = 2
    INFEASIBLE_POINT = 3
    # The primal solution is a certificate of dual infeasibility (unbounded
    # ray); the dual solution is a Farkas certificate of primal infeasibility.
    INFEASIBILITY_CERTIFICATE = 4
