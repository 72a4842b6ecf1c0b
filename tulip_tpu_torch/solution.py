"""Original-space solution container (reference: src/solution.jl:1-27)."""

from __future__ import annotations

import numpy as np

from .status import SolutionStatus


class Solution:
    """Primal-dual solution in the original (pre-presolve) space.

    Duals are sign-split exactly like the reference: ``y_lower/y_upper`` are
    the nonnegative parts of the row duals, ``s_lower/s_upper`` the reduced
    costs of the variable bounds (reference: src/solution.jl:10-16).
    """

    def __init__(self, m: int, n: int):
        self.m = m
        self.n = n

        self.primal_status = SolutionStatus.UNKNOWN
        self.dual_status = SolutionStatus.UNKNOWN
        self.is_primal_ray = False
        self.is_dual_ray = False

        self.z_primal = 0.0
        self.z_dual = 0.0

        self.x = np.zeros(n)
        self.Ax = np.zeros(m)
        self.y_lower = np.zeros(m)
        self.y_upper = np.zeros(m)
        self.s_lower = np.zeros(n)
        self.s_upper = np.zeros(n)

    def resize(self, m: int, n: int) -> "Solution":
        """Resize all vectors (reference: src/solution.jl:32-48)."""
        if m < 0 or n < 0:
            raise ValueError("m and n must be >= 0")
        self.m, self.n = m, n
        self.x = np.resize(self.x, n)
        self.Ax = np.resize(self.Ax, m)
        self.y_lower = np.resize(self.y_lower, m)
        self.y_upper = np.resize(self.y_upper, m)
        self.s_lower = np.resize(self.s_lower, n)
        self.s_upper = np.resize(self.s_upper, n)
        return self
