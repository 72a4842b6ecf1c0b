"""Presolve transformation records (undo-stack entries).

Each reduction pushes one record; ``postsolve`` replays them in reverse to
recover the original-space primal-dual solution
(reference: src/Presolve/*.jl transformation structs).
All records operate on ORIGINAL-space indices.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

from ..solution import Solution
from ..utils import neg_part, pos_part

SparseVec = Tuple[List[int], List[float]]  # (indices, values)


class PresolveOp:
    def postsolve(self, sol: Solution) -> None:
        raise NotImplementedError


@dataclasses.dataclass
class EmptyRow(PresolveOp):
    """Removed 0-nonzero row (reference: src/Presolve/empty_row.jl:4-7)."""

    i: int
    y: float = 0.0

    def postsolve(self, sol: Solution) -> None:
        sol.y_lower[self.i] = pos_part(self.y)
        sol.y_upper[self.i] = neg_part(self.y)


@dataclasses.dataclass
class EmptyColumn(PresolveOp):
    """Removed 0-nonzero column fixed at value x with reduced cost s
    (reference: src/Presolve/empty_column.jl:1-5)."""

    j: int
    x: float
    s: float

    def postsolve(self, sol: Solution) -> None:
        # Ray-aware: in a homogeneous certificate the fixed value and the
        # cost-derived reduced cost contribute zero. (The reference replays
        # these unconditionally, corrupting certificates after multi-rule
        # presolve — reference: empty_column.jl postsolve.)
        sol.x[self.j] = 0.0 if sol.is_primal_ray else self.x
        s = 0.0 if sol.is_dual_ray else self.s
        sol.s_lower[self.j] = pos_part(s)
        sol.s_upper[self.j] = neg_part(s)


@dataclasses.dataclass
class FixedVariable(PresolveOp):
    """Removed variable with l == u; ``col`` is its active column at removal
    time (reference: src/Presolve/fixed_variable.jl:1-6). Postsolve
    recomputes the reduced cost s = c - a_j'y."""

    j: int
    x: float
    c: float
    col: SparseVec

    def postsolve(self, sol: Solution) -> None:
        sol.x[self.j] = 0.0 if sol.is_primal_ray else self.x
        s = 0.0 if sol.is_dual_ray else self.c
        for i, aij in zip(*self.col):
            s -= aij * (sol.y_lower[i] - sol.y_upper[i])
        sol.s_lower[self.j] = pos_part(s)
        sol.s_upper[self.j] = neg_part(s)


@dataclasses.dataclass
class RowSingleton(PresolveOp):
    """1-nonzero row converted into a variable bound
    (reference: src/Presolve/row_singleton.jl:1-8)."""

    i: int
    j: int
    aij: float
    force_lower: bool
    force_upper: bool

    def postsolve(self, sol: Solution) -> None:
        if self.force_lower:
            if self.aij > 0:
                sol.y_lower[self.i] = sol.s_lower[self.j] / self.aij
            else:
                sol.y_upper[self.i] = sol.s_lower[self.j] / abs(self.aij)
            sol.s_lower[self.j] = 0.0
        if self.force_upper:
            if self.aij > 0:
                sol.y_upper[self.i] = sol.s_upper[self.j] / self.aij
            else:
                sol.y_lower[self.i] = sol.s_upper[self.j] / abs(self.aij)
            sol.s_upper[self.j] = 0.0


@dataclasses.dataclass
class DominatedRow(PresolveOp):
    """Row whose implied activity bounds lie within its bounds
    (reference: src/Presolve/forcing_row.jl:10-12)."""

    i: int

    def postsolve(self, sol: Solution) -> None:
        sol.y_lower[self.i] = 0.0
        sol.y_upper[self.i] = 0.0


@dataclasses.dataclass
class ForcingRow(PresolveOp):
    """Row whose implied activity bound equals one of its bounds: all its
    variables get fixed (reference: src/Presolve/forcing_row.jl:1-8).
    Dual postsolve recovers y via a max/min ratio over the row
    (forcing_row.jl:185-213)."""

    i: int
    at_lower: bool       # True: forced to lower activity (row at upper bnd)
    row: SparseVec       # active row at removal time
    cols: List[SparseVec]  # active column of each fixed variable
    xs: List[float]      # primal values the variables were fixed to
    cs: List[float]      # objective coefficients

    def postsolve(self, sol: Solution) -> None:
        for j, xj in zip(self.row[0], self.xs):
            sol.x[j] = 0.0 if sol.is_primal_ray else xj

        z = []
        for cj, col in zip(self.cs, self.cols):
            zj = 0.0 if sol.is_dual_ray else cj
            for k, akj in zip(*col):
                zj -= akj * (sol.y_lower[k] - sol.y_upper[k])
            z.append(zj)

        ratios = [zj / aij for zj, aij in zip(z, self.row[1])]
        y = max(ratios) if self.at_lower else min(ratios)
        sol.y_lower[self.i] = pos_part(y)
        sol.y_upper[self.i] = neg_part(y)

        for j, aij, zj in zip(self.row[0], self.row[1], z):
            s = zj - aij * y
            sol.s_lower[j] = pos_part(s)
            sol.s_upper[j] = neg_part(s)


@dataclasses.dataclass
class FreeColumnSingleton(PresolveOp):
    """(Implied-)free column singleton: variable and its row both eliminated
    by substitution (reference: src/Presolve/free_column_singleton.jl:1-9).
    Postsolve back-solves x_j from the row."""

    i: int
    j: int
    l: float   # row lower bound
    u: float   # row upper bound
    aij: float
    y: float   # dual of row i
    row: SparseVec  # rest of row i (active cols, j excluded)

    def postsolve(self, sol: Solution) -> None:
        # The stored dual y = c_j/a_ij is cost-derived: zero in a Farkas
        # ray (the free column forces (A'y)_j = 0 there).
        y = 0.0 if sol.is_dual_ray else self.y
        sol.y_lower[self.i] = pos_part(y)
        sol.y_upper[self.i] = neg_part(y)
        sol.s_lower[self.j] = 0.0
        sol.s_upper[self.j] = 0.0

        xj = 0.0 if sol.is_primal_ray else (self.l if y >= 0 else self.u)
        for k, aik in zip(*self.row):
            xj -= aik * sol.x[k]
        sol.x[self.j] = xj / self.aij


@dataclasses.dataclass
class DominatedColumn(PresolveOp):
    """Column fixed to a bound by dual-bound domination
    (reference: src/Presolve/dominated_column.jl:1-6)."""

    j: int
    x: float
    cj: float
    col: SparseVec

    def postsolve(self, sol: Solution) -> None:
        sol.x[self.j] = 0.0 if sol.is_primal_ray else self.x
        s = 0.0 if sol.is_dual_ray else self.cj
        for i, aij in zip(*self.col):
            s -= aij * (sol.y_lower[i] - sol.y_upper[i])
        sol.s_lower[self.j] = pos_part(s)
        sol.s_upper[self.j] = neg_part(s)
