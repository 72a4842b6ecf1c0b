"""Presolve driver + reduction rules (host-side).

Faithful re-implementation of the reference presolve semantics
(reference: src/Presolve/Presolve.jl:31-710 and the per-rule files):

- workspace over the original problem with row/column active flags, live
  nonzero counts, primal bounds, and dual bounds ly/uy/ls/us;
- a fixpoint pass loop over: bounds checks → empty columns → row singletons
  → fixed variables → forcing/dominated rows → free column singletons →
  dominated columns (reference: Presolve.jl:374-431);
- Farkas / unbounded-ray certificates emitted directly from presolve when a
  reduction proves in/unboundedness (reference: empty_row.jl:19-63,
  empty_column.jl:25-90, dominated_column.jl:30-60, Presolve.jl:502-566);
- row/column 2-norm equilibration applied when extracting the reduced
  problem (reference: Presolve.jl:256-300);
- an undo stack of transformation records replayed in reverse by
  ``postsolve`` (reference: Presolve.jl:321-366).

This is pointer-chasing, data-dependent host work by design — it shrinks
and conditions the problem before the device-side IPM sees it.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from ..problem import INF, ArrayProblemData, ProblemData, SparseAxis
from ..solution import Solution
from ..status import SolutionStatus, TerminationStatus
from . import ops as OPS

Trm = TerminationStatus
Sln = SolutionStatus


class PresolveData:
    """Presolve workspace (reference: src/Presolve/Presolve.jl:31-174)."""

    def __init__(self, pb: ProblemData, options=None):
        self.updated = False
        self.status = Trm.UNKNOWN
        self.options = options
        # Feasibility tolerances (sqrt(eps) like reference PresolveOptions).
        self.tol_pfeas = 1.4901161193847656e-08
        self.tol_dfeas = 1.4901161193847656e-08

        self.pb0 = pb
        self.pb_red: Optional[ProblemData] = None
        self.solution = Solution(pb.ncon, pb.nvar)

        self.nrow = pb.ncon
        self.ncol = pb.nvar

        self.rowflag = [True] * self.nrow
        self.colflag = [True] * self.ncol

        # Active nonzero counts: on arrays the pointers give them (load
        # keeps no zero).
        if type(pb) is ArrayProblemData:
            self.nzrow = np.diff(pb.csr[0]).tolist()
            self.nzcol = np.diff(pb.csc[0]).tolist()
        else:
            self.nzrow = [0] * self.nrow
            self.nzcol = [0] * self.ncol
            for j, col in enumerate(pb.acols):
                for i, aij in col.items():
                    if aij != 0.0:
                        self.nzcol[j] += 1
                        self.nzrow[i] += 1

        # Objective in MIN convention (reference: Presolve.jl:124-134).
        self.objsense = pb.objsense
        if pb.objsense:
            self.obj = list(pb.obj)
            self.obj0 = pb.obj0
        else:
            self.obj = [-c for c in pb.obj]
            self.obj0 = -pb.obj0

        self.lrow = list(pb.lcon)
        self.urow = list(pb.ucon)
        self.lcol = list(pb.lvar)
        self.ucol = list(pb.uvar)

        # Row dual bounds, strengthened from column singletons before the
        # dominated-column scan (reference: Presolve.jl:142-154, 648-703).
        # The reference also initializes column dual bounds ls/us
        # (Presolve.jl:145-153) but never reads them — the one case their
        # wiring would add (a FREE column singleton pinning its row dual
        # exactly) is unreachable because the free-column-singleton rule
        # eliminates such columns earlier in the same pass — so they are
        # deliberately not carried here.
        self.ly = [0.0 if u == INF else -INF for u in self.urow]
        self.uy = [0.0 if l == -INF else INF for l in self.lrow]

        self.row_scaling = np.ones(self.nrow)
        self.col_scaling = np.ones(self.ncol)

        self.new_con_idx: List[int] = []
        self.new_var_idx: List[int] = []
        self.old_con_idx: List[int] = []
        self.old_var_idx: List[int] = []

        self.row_singletons: List[int] = []
        self.free_col_singletons: List[int] = []

        self.ops: List[OPS.PresolveOp] = []

    # ------------------------------------------------------------------
    # Helpers
    # ------------------------------------------------------------------
    def _active_row(self, i: int):
        for j, aij in self.pb0.arows[i].items():
            if self.colflag[j] and aij != 0.0:
                yield j, aij

    def _active_col(self, j: int):
        for i, aij in self.pb0.acols[j].items():
            if self.rowflag[i] and aij != 0.0:
                yield i, aij

    def compute_index_mapping(self) -> None:
        """Old <-> new index maps; removed entries map to -1
        (reference: Presolve.jl:465-493)."""
        self.new_con_idx = [-1] * self.pb0.ncon
        self.new_var_idx = [-1] * self.pb0.nvar
        self.old_con_idx = []
        self.old_var_idx = []
        for iold in range(self.pb0.ncon):
            if self.rowflag[iold]:
                self.new_con_idx[iold] = len(self.old_con_idx)
                self.old_con_idx.append(iold)
        for jold in range(self.pb0.nvar):
            if self.colflag[jold]:
                self.new_var_idx[jold] = len(self.old_var_idx)
                self.old_var_idx.append(jold)

    def _blank_reduced_solution(self) -> Solution:
        self.compute_index_mapping()
        sol = Solution(self.nrow, self.ncol)
        self.solution = sol
        return sol

    def _primal_infeasible_cert(self, *, row: int = None, col: int = None,
                                y_lower=0.0, y_upper=0.0,
                                s_lower=0.0, s_upper=0.0) -> None:
        """Emit a Farkas dual ray (reference: Presolve.jl:502-566,
        empty_row.jl:19-63)."""
        self.status = Trm.PRIMAL_INFEASIBLE
        self.updated = True
        sol = self._blank_reduced_solution()
        sol.primal_status = Sln.UNKNOWN
        sol.dual_status = Sln.INFEASIBILITY_CERTIFICATE
        sol.is_primal_ray = False
        sol.is_dual_ray = True
        sol.z_primal = sol.z_dual = INF
        if row is not None:
            i_ = self.new_con_idx[row]
            sol.y_lower[i_] = y_lower
            sol.y_upper[i_] = y_upper
        if col is not None:
            j_ = self.new_var_idx[col]
            sol.s_lower[j_] = s_lower
            sol.s_upper[j_] = s_upper

    def _dual_infeasible_cert(self, col: int, x: float) -> None:
        """Emit an unbounded primal ray (reference: empty_column.jl:25-90)."""
        self.status = Trm.DUAL_INFEASIBLE
        self.updated = True
        sol = self._blank_reduced_solution()
        sol.primal_status = Sln.INFEASIBILITY_CERTIFICATE
        sol.dual_status = Sln.UNKNOWN
        sol.is_primal_ray = True
        sol.is_dual_ray = False
        sol.z_primal = sol.z_dual = -INF
        sol.x[self.new_var_idx[col]] = x

    # ------------------------------------------------------------------
    # Rules
    # ------------------------------------------------------------------
    def remove_empty_row(self, i: int) -> None:
        """(reference: src/Presolve/empty_row.jl:9-71)."""
        if not (self.rowflag[i] and self.nzrow[i] == 0):
            return
        lb, ub = self.lrow[i], self.urow[i]
        eps = self.tol_pfeas
        if ub < -eps:
            self._primal_infeasible_cert(row=i, y_upper=1.0)
            return
        elif lb > eps:
            self._primal_infeasible_cert(row=i, y_lower=1.0)
            return
        else:
            self.ops.append(OPS.EmptyRow(i, 0.0))
        self.updated = True
        self.rowflag[i] = False
        self.nrow -= 1

    def remove_empty_column(self, j: int) -> None:
        """(reference: src/Presolve/empty_column.jl:7-100)."""
        if not (self.colflag[j] and self.nzcol[j] == 0):
            return
        lb, ub = self.lcol[j], self.ucol[j]
        cj = self.obj[j]
        eps = self.tol_dfeas
        if cj > eps:
            if math.isfinite(lb):
                self.obj0 += lb * cj
                self.ops.append(OPS.EmptyColumn(j, lb, cj))
            else:
                self._dual_infeasible_cert(j, -1.0)
                return
        elif cj < -eps:
            if math.isfinite(ub):
                self.obj0 += ub * cj
                self.ops.append(OPS.EmptyColumn(j, ub, cj))
            else:
                self._dual_infeasible_cert(j, 1.0)
                return
        else:
            if math.isfinite(lb):
                self.ops.append(OPS.EmptyColumn(j, lb, 0.0))
            elif math.isfinite(ub):
                self.ops.append(OPS.EmptyColumn(j, ub, 0.0))
            else:
                self.ops.append(OPS.EmptyColumn(j, 0.0, 0.0))
        self.colflag[j] = False
        self.updated = True
        self.ncol -= 1

    def remove_fixed_variable(self, j: int) -> None:
        """(reference: src/Presolve/fixed_variable.jl:8-57)."""
        if not self.colflag[j]:
            return
        lb, ub = self.lcol[j], self.ucol[j]
        if lb != ub:
            return
        cj = self.obj[j]
        active = list(self._active_col(j))

        self.colflag[j] = False
        self.ncol -= 1
        self.updated = True
        self.ops.append(OPS.FixedVariable(
            j, lb, cj, ([i for i, _ in active], [a for _, a in active])))
        self.obj0 += cj * lb

        for i, aij in active:
            self.lrow[i] -= aij * lb
            self.urow[i] -= aij * lb
            self.nzrow[i] -= 1
            if self.nzrow[i] == 0:
                self.remove_empty_row(i)
                if self.status != Trm.UNKNOWN:
                    return
            elif self.nzrow[i] == 1:
                self.row_singletons.append(i)

    def remove_row_singleton(self, i: int) -> None:
        """(reference: src/Presolve/row_singleton.jl:10-77)."""
        if not (self.rowflag[i] and self.nzrow[i] == 1):
            return
        active = list(self._active_row(i))
        if len(active) != 1:
            return  # empty (numerically) — next pass handles it
        j, aij = active[0]

        if aij > 0:
            l = self.lrow[i] / aij
            u = self.urow[i] / aij
        else:
            l = self.urow[i] / aij
            u = self.lrow[i] / aij

        lb, ub = self.lcol[j], self.ucol[j]
        # Implied bounds incompatible with variable bounds -> primal
        # infeasible, with a Farkas ray combining the row dual and the
        # conflicting bound's reduced cost. (The reference leaves this as a
        # TODO, reference: src/Presolve/row_singleton.jl:49; it would
        # otherwise silently mis-solve via a later dominated-column fix.)
        if l > ub + self.tol_pfeas:
            if aij > 0:
                #  a x >= lrow with x <= ub: y+ = 1, s- = a.
                self._primal_infeasible_cert(row=i, col=j, y_lower=1.0,
                                             s_upper=aij)
            else:
                #  a x <= urow (a<0) forces x > ub: y- = 1, s- = -a.
                self._primal_infeasible_cert(row=i, col=j, y_upper=1.0,
                                             s_upper=-aij)
            return
        if u < lb - self.tol_pfeas:
            if aij > 0:
                self._primal_infeasible_cert(row=i, col=j, y_upper=1.0,
                                             s_lower=aij)
            else:
                self._primal_infeasible_cert(row=i, col=j, y_lower=1.0,
                                             s_lower=-aij)
            return
        force_lower = l >= lb
        force_upper = u <= ub
        if force_lower:
            self.lcol[j] = l
        if force_upper:
            self.ucol[j] = u

        self.ops.append(OPS.RowSingleton(i, j, aij, force_lower, force_upper))
        self.rowflag[i] = False
        self.updated = True
        self.nrow -= 1
        self.nzcol[j] -= 1

        if self.lcol[j] == self.ucol[j]:
            self.remove_fixed_variable(j)

    def remove_forcing_row(self, i: int) -> None:
        """Forcing/dominated row (reference: src/Presolve/forcing_row.jl:14-180)."""
        if not self.rowflag[i]:
            return
        if self.nzrow[i] == 1:
            return  # row singletons handled separately

        l_ = u_ = 0.0
        for j, aij in self._active_row(i):
            if aij < 0:
                l_ += aij * self.ucol[j]
                u_ += aij * self.lcol[j]
            else:
                l_ += aij * self.lcol[j]
                u_ += aij * self.ucol[j]
            if not (math.isfinite(l_) or math.isfinite(u_)):
                break

        l, u = self.lrow[i], self.urow[i]
        if l <= l_ and u_ <= u:
            # Dominated row.
            self.rowflag[i] = False
            self.updated = True
            self.nrow -= 1
            self.ops.append(OPS.DominatedRow(i))
            for j, aij in self.pb0.arows[i].items():
                if self.colflag[j] and aij != 0.0:
                    self.nzcol[j] -= 1
            return
        if l_ == u or u_ == l:
            at_lower = (l_ == u)
            # Row is forced: fix every variable to the bound achieving the
            # active side.
            active = list(self._active_row(i))
            row_rec = ([j for j, _ in active], [a for _, a in active])
            cols_rec, xs, cs = [], [], []
            for j, aij in active:
                if at_lower:
                    xj = self.lcol[j] if aij > 0 else self.ucol[j]
                else:
                    xj = self.ucol[j] if aij > 0 else self.lcol[j]
                col_active = list(self._active_col(j))
                # Exclude row i itself? Reference keeps all still-active rows
                # of the column; row i is still flagged at this point, so it
                # is included — but its bound updates are skipped via the
                # rowflag check after i is removed. Mirror: include rows with
                # rowflag True (i included), but only update rows != i.
                cols_rec.append(([k for k, _ in col_active],
                                 [a for _, a in col_active]))
                xs.append(xj)
                cs.append(self.obj[j])
                for k, akj in col_active:
                    if k == i:
                        continue
                    self.nzrow[k] -= 1
                    self.lrow[k] -= akj * xj
                    self.urow[k] -= akj * xj
                    if self.nzrow[k] == 1:
                        self.row_singletons.append(k)
                self.colflag[j] = False
                self.ncol -= 1

            self.ops.append(OPS.ForcingRow(i, at_lower, row_rec, cols_rec,
                                           xs, cs))
            self.rowflag[i] = False
            self.nrow -= 1
            self.updated = True

    def remove_free_column_singleton(self, j: int) -> None:
        """(reference: src/Presolve/free_column_singleton.jl:11-109)."""
        if not (self.colflag[j] and self.nzcol[j] == 1):
            return
        active = list(self._active_col(j))
        if len(active) != 1:
            return
        i, aij = active[0]

        row = self.pb0.arows[i]
        lr, ur = self.lrow[i], self.urow[i]

        l, u = self.lcol[j], self.ucol[j]
        if math.isfinite(l) or math.isfinite(u):
            # Compute implied bounds to check implied-freeness.
            if aij > 0:
                l_, u_ = lr, ur
                for k, aik in row.items():
                    if not self.colflag[k] or k == j or aik == 0.0:
                        continue
                    if aik > 0:
                        l_ -= aik * self.ucol[k]
                        u_ -= aik * self.lcol[k]
                    else:
                        l_ -= aik * self.lcol[k]
                        u_ -= aik * self.ucol[k]
                l_ /= aij
                u_ /= aij
            else:
                l_, u_ = ur, lr
                for k, aik in row.items():
                    if not self.colflag[k] or k == j or aik == 0.0:
                        continue
                    if aik > 0:
                        l_ -= aik * self.lcol[k]
                        u_ -= aik * self.ucol[k]
                    else:
                        l_ -= aik * self.ucol[k]
                        u_ -= aik * self.lcol[k]
                l_ /= aij
                u_ /= aij
            if not (l <= l_ and l_ <= u_ and u_ <= u):
                return  # not implied free

        y = self.obj[j] / aij
        # The dual y prices row i's activity t into the objective as y·t
        # with t ∈ [lr, ur]; minimization drives t to lr when y > 0 and
        # to ur when y < 0. If THAT bound is infinite the objective is
        # unbounded along the singleton direction — emit the dual-
        # infeasibility certificate (ray: xj = d_t/aij with t moving
        # toward the infinite bound; implied-freeness guarantees xj's
        # bound on that side is infinite too). The reference absorbs
        # y·(±inf) into the objective constant and reports a garbage
        # "optimal" −inf here (free_column_singleton.jl:90) — a round-5
        # fuzz finding, fixed rather than reproduced.
        priced = lr if y >= 0 else ur
        if y != 0.0 and not math.isfinite(priced):
            self._dual_infeasible_cert(j, (-1.0 if y > 0 else 1.0) / aij)
            return
        self.obj0 += y * lr if y >= 0 else y * ur
        rind, rval = [], []
        for k, aik in row.items():
            if not self.colflag[k] or k == j or aik == 0.0:
                continue
            rind.append(k)
            rval.append(aik)
            self.obj[k] -= y * aik
            self.nzcol[k] -= 1

        self.ops.append(OPS.FreeColumnSingleton(i, j, lr, ur, aij, y,
                                                (rind, rval)))
        self.rowflag[i] = False
        self.colflag[j] = False
        self.nrow -= 1
        self.ncol -= 1
        self.updated = True

    def remove_dominated_column(self, j: int, tol: float = None) -> None:
        """(reference: src/Presolve/dominated_column.jl:8-147)."""
        if not self.colflag[j]:
            return
        if tol is None:
            tol = 100 * math.sqrt(2.220446049250313e-16)

        ls = us = 0.0
        for i, aij in self._active_col(j):
            ls += aij * (self.ly[i] if aij >= 0 else self.uy[i])
            us += aij * (self.uy[i] if aij >= 0 else self.ly[i])

        cj = self.obj[j]
        if cj - us > tol:
            # Reduced cost always positive -> fix to lower bound.
            lb = self.lcol[j]
            if not math.isfinite(lb):
                self._dual_infeasible_cert(j, -1.0)
                return
            self._fix_column_at(j, lb, cj)
        elif cj - ls < -tol:
            ub = self.ucol[j]
            if not math.isfinite(ub):
                self._dual_infeasible_cert(j, 1.0)
                return
            self._fix_column_at(j, ub, cj)

    def _fix_column_at(self, j: int, x: float, cj: float) -> None:
        """Shared tail of dominated-column fixing
        (reference: dominated_column.jl:60-140)."""
        if self.lcol[j] > self.ucol[j]:
            # Bounds became inconsistent mid-pass; certify instead of
            # fixing at an infeasible value.
            self._primal_infeasible_cert(col=j, s_lower=1.0, s_upper=1.0)
            return
        self.obj0 += cj * x
        active = list(self._active_col(j))
        for i, aij in active:
            self.lrow[i] -= aij * x
            self.urow[i] -= aij * x
            self.nzrow[i] -= 1
            if self.nzrow[i] == 1:
                self.row_singletons.append(i)
        self.ops.append(OPS.DominatedColumn(
            j, x, cj, ([i for i, _ in active], [a for _, a in active])))
        self.colflag[j] = False
        self.ncol -= 1
        self.updated = True

    # ------------------------------------------------------------------
    # Batch rule application (reference: Presolve.jl:568-710)
    # ------------------------------------------------------------------
    def remove_empty_rows(self) -> None:
        for i in range(self.pb0.ncon):
            if self.rowflag[i] and self.nzrow[i] == 0:
                self.remove_empty_row(i)
                if self.status != Trm.UNKNOWN:
                    return

    def remove_empty_columns(self) -> None:
        for j in range(self.pb0.nvar):
            self.remove_empty_column(j)
            if self.status != Trm.UNKNOWN:
                return

    def remove_fixed_variables(self) -> None:
        for j in range(self.pb0.nvar):
            if self.colflag[j]:
                self.remove_fixed_variable(j)
                if self.status != Trm.UNKNOWN:
                    return

    def remove_row_singletons(self) -> None:
        singletons = self.row_singletons
        self.row_singletons = []
        for i in singletons:
            self.remove_row_singleton(i)
            if self.status != Trm.UNKNOWN:
                return

    def remove_forcing_rows(self) -> None:
        for i in range(self.pb0.ncon):
            if self.rowflag[i]:
                self.remove_forcing_row(i)
                if self.status != Trm.UNKNOWN:
                    return

    def remove_free_column_singletons(self) -> None:
        for j in range(self.pb0.nvar):
            self.remove_free_column_singleton(j)
            if self.status != Trm.UNKNOWN:
                return

    def remove_dominated_columns(self) -> None:
        """Strengthen dual bounds from column singletons, then scan
        (reference: Presolve.jl:648-710)."""
        for j in range(self.pb0.nvar):
            if not (self.colflag[j] and self.nzcol[j] == 1):
                continue
            active = list(self._active_col(j))
            if len(active) != 1:
                continue
            i, aij = active[0]
            l, u = self.lcol[j], self.ucol[j]
            cj = self.obj[j]
            y_ = cj / aij
            if math.isfinite(l) and not math.isfinite(u):
                if aij > 0:
                    self.uy[i] = min(self.uy[i], y_)
                else:
                    self.ly[i] = max(self.ly[i], y_)
            elif not math.isfinite(l) and math.isfinite(u):
                if aij > 0:
                    self.ly[i] = max(self.ly[i], y_)
                else:
                    self.uy[i] = min(self.uy[i], y_)

        for j in range(self.pb0.nvar):
            self.remove_dominated_column(j)
            if self.status != Trm.UNKNOWN:
                return

    def bounds_consistency_checks(self) -> None:
        """(reference: Presolve.jl:502-566)."""
        for i in range(self.pb0.ncon):
            if self.rowflag[i] and self.lrow[i] > self.urow[i]:
                self._primal_infeasible_cert(row=i, y_lower=1.0, y_upper=1.0)
                return
        for j in range(self.pb0.nvar):
            if self.colflag[j] and self.lcol[j] > self.ucol[j]:
                self._primal_infeasible_cert(col=j, s_lower=1.0, s_upper=1.0)
                return

    # ------------------------------------------------------------------
    # Driver
    # ------------------------------------------------------------------
    def upgrade_if_both_infeasible(self) -> TerminationStatus:
        """Upgrade a one-sided infeasibility verdict to
        PRIMAL_DUAL_INFEASIBLE when a cheap witness for the OTHER side
        also exists, attaching the second certificate ray.

        The reference defines Trm_PrimalDualInfeasible
        (reference: src/status.jl:22) and checks for it
        (reference: src/model.jl:105) but no reference code path ever
        assigns it; this is a sound partial detection beyond reference
        behavior (a semidecision — absence of a cheap witness does not
        rule the other side's infeasibility out). Idempotent.
        """
        sol = self.solution
        if self.status == Trm.PRIMAL_INFEASIBLE and sol is not None:
            # Dual-infeasibility witness: an improving column ray —
            # moving x_j in the improving direction violates no finite
            # row or variable bound (the empty-column ray generalized).
            for j in range(self.pb0.nvar):
                if not self.colflag[j]:
                    continue
                cj = self.obj[j]
                for d in (1.0, -1.0):
                    if cj * d >= 0.0:
                        continue  # not improving
                    if d > 0 and math.isfinite(self.ucol[j]):
                        continue
                    if d < 0 and math.isfinite(self.lcol[j]):
                        continue
                    free = True
                    for i, aij in self._active_col(j):
                        hi = self.urow[i] if aij * d > 0 else -self.lrow[i]
                        if math.isfinite(hi):
                            free = False
                            break
                    if free:
                        self.status = Trm.PRIMAL_DUAL_INFEASIBLE
                        sol.primal_status = Sln.INFEASIBILITY_CERTIFICATE
                        sol.is_primal_ray = True
                        sol.x[self.new_var_idx[j]] = d
                        return self.status
        elif self.status == Trm.DUAL_INFEASIBLE and sol is not None:
            # Primal-infeasibility witness: an active bound conflict or
            # an empty row whose bounds exclude zero.
            for j in range(self.pb0.nvar):
                if self.colflag[j] and self.lcol[j] > self.ucol[j]:
                    self.status = Trm.PRIMAL_DUAL_INFEASIBLE
                    sol.dual_status = Sln.INFEASIBILITY_CERTIFICATE
                    sol.is_dual_ray = True
                    j_ = self.new_var_idx[j]
                    sol.s_lower[j_] = 1.0
                    sol.s_upper[j_] = 1.0
                    return self.status
            for i in range(self.pb0.ncon):
                if not self.rowflag[i]:
                    continue
                lr, ur = self.lrow[i], self.urow[i]
                if lr > ur or (self.nzrow[i] == 0
                               and (lr > 0.0 or ur < 0.0)):
                    self.status = Trm.PRIMAL_DUAL_INFEASIBLE
                    sol.dual_status = Sln.INFEASIBILITY_CERTIFICATE
                    sol.is_dual_ray = True
                    i_ = self.new_con_idx[i]
                    if lr > ur or lr > 0.0:
                        sol.y_lower[i_] = 1.0
                    if lr > ur or ur < 0.0:
                        sol.y_upper[i_] = 1.0
                    return self.status
        return self.status

    def presolve(self) -> TerminationStatus:
        """Fixpoint pass loop (reference: Presolve.jl:374-463)."""
        self.bounds_consistency_checks()
        if self.status == Trm.PRIMAL_INFEASIBLE:
            return self.status

        self.remove_empty_rows()
        self.remove_empty_columns()
        if self.status != Trm.UNKNOWN:
            return self.status

        self.row_singletons = [
            i for i in range(self.pb0.ncon)
            if self.rowflag[i] and self.nzrow[i] == 1]

        self.updated = True
        while self.updated and self.status == Trm.UNKNOWN:
            self.updated = False

            self.bounds_consistency_checks()
            if self.status != Trm.UNKNOWN:
                return self.status
            self.remove_empty_columns()
            if self.status != Trm.UNKNOWN:
                return self.status

            self.remove_row_singletons()
            if self.status != Trm.UNKNOWN:
                return self.status
            self.remove_fixed_variables()
            if self.status != Trm.UNKNOWN:
                return self.status

            self.remove_row_singletons()
            if self.status != Trm.UNKNOWN:
                return self.status
            self.remove_forcing_rows()
            if self.status != Trm.UNKNOWN:
                return self.status

            self.remove_row_singletons()
            if self.status != Trm.UNKNOWN:
                return self.status
            self.remove_free_column_singletons()
            if self.status != Trm.UNKNOWN:
                return self.status

            self.remove_row_singletons()
            if self.status != Trm.UNKNOWN:
                return self.status
            self.remove_dominated_columns()
            if self.status != Trm.UNKNOWN:
                return self.status

        self.remove_empty_columns()

        if self.nrow == 0 and self.ncol == 0:
            # Empty problem: declare optimality (reference: Presolve.jl:442-454).
            self.status = Trm.OPTIMAL
            self.solution = Solution(0, 0)
            self.solution.primal_status = Sln.OPTIMAL
            self.solution.dual_status = Sln.OPTIMAL
            self.solution.z_primal = self.obj0
            self.solution.z_dual = self.obj0

        self.compute_index_mapping()
        return self.status

    # ------------------------------------------------------------------
    # Reduced-problem extraction + scaling (reference: Presolve.jl:177-305)
    # ------------------------------------------------------------------
    def extract_reduced_problem(self) -> ProblemData:
        pb = ProblemData(self.pb0.name)
        pb.objsense = self.objsense
        if self.objsense:
            pb.obj0 = self.obj0
            obj = [self.obj[j] for j in self.old_var_idx]
        else:
            pb.obj0 = -self.obj0
            obj = [-self.obj[j] for j in self.old_var_idx]

        lvar = [self.lcol[j] for j in self.old_var_idx]
        uvar = [self.ucol[j] for j in self.old_var_idx]
        lcon = [self.lrow[i] for i in self.old_con_idx]
        ucon = [self.urow[i] for i in self.old_con_idx]

        # Build rows in new indexing.
        rows = []
        for iold in self.old_con_idx:
            rind, rval = [], []
            for jold, aij in self.pb0.arows[iold].items():
                if self.colflag[jold] and aij != 0.0:
                    rind.append(self.new_var_idx[jold])
                    rval.append(aij)
            rows.append((rind, rval))

        # Row/column 2-norm equilibration: aij /= sqrt(||row||)·sqrt(||col||)
        # (reference: Presolve.jl:256-300).
        nr, nc = len(lcon), len(lvar)
        rnorm = np.zeros(nr)
        cnorm = np.zeros(nc)
        for i, (rind, rval) in enumerate(rows):
            rnorm[i] = math.sqrt(sum(v * v for v in rval))
        for i, (rind, rval) in enumerate(rows):
            for j, v in zip(rind, rval):
                cnorm[j] += v * v
        cnorm = np.sqrt(cnorm)
        rscale = np.sqrt(np.where(rnorm > 0, rnorm, 1.0))
        cscale = np.sqrt(np.where(cnorm > 0, cnorm, 1.0))

        pb.nvar = nc
        pb.ncon = nr
        pb.obj = [obj[j] / cscale[j] for j in range(nc)]
        pb.lvar = [lvar[j] * cscale[j] for j in range(nc)]
        pb.uvar = [uvar[j] * cscale[j] for j in range(nc)]
        pb.lcon = [lcon[i] / rscale[i] for i in range(nr)]
        pb.ucon = [ucon[i] / rscale[i] for i in range(nr)]
        pb.var_names = [self.pb0.var_names[j] for j in self.old_var_idx]
        pb.con_names = [self.pb0.con_names[i] for i in self.old_con_idx]

        pb.arows = []
        pb.acols = [SparseAxis() for _ in range(nc)]
        for i, (rind, rval) in enumerate(rows):
            r = SparseAxis()
            for j, v in zip(rind, rval):
                v_ = v / (rscale[i] * cscale[j])
                r.nzind.append(j)
                r.nzval.append(v_)
                pb.acols[j].nzind.append(i)
                pb.acols[j].nzval.append(v_)
            pb.arows.append(r)

        self.row_scaling = rscale
        self.col_scaling = cscale
        self.pb_red = pb
        return pb


def postsolve(sol: Solution, sol_: Solution, ps: PresolveData) -> None:
    """Map reduced-space solution to original space: unscale, replay the
    undo stack in reverse, recompute row activities
    (reference: Presolve.jl:321-366)."""
    sol.primal_status = sol_.primal_status
    sol.dual_status = sol_.dual_status
    sol.is_primal_ray = sol_.is_primal_ray
    sol.is_dual_ray = sol_.is_dual_ray
    sol.z_primal = sol_.z_primal
    sol.z_dual = sol_.z_dual

    sol.x[:] = 0.0
    sol.Ax[:] = 0.0
    sol.y_lower[:] = 0.0
    sol.y_upper[:] = 0.0
    sol.s_lower[:] = 0.0
    sol.s_upper[:] = 0.0

    # Unscale + scatter reduced-space values to original indices
    # (vectorized: flat per-solve host cost, like _extract_reduced_arrays).
    vidx = np.asarray(ps.old_var_idx, dtype=np.intp)
    cidx = np.asarray(ps.old_con_idx, dtype=np.intp)
    # Before extraction the scaling vectors still have original length
    # (all ones); after extraction they have reduced length — either way
    # entry k scales reduced index k.
    cs = ps.col_scaling[:vidx.size]
    rs = ps.row_scaling[:cidx.size]
    if vidx.size:
        sol.x[vidx] = np.asarray(sol_.x)[:vidx.size] / cs
        sol.s_lower[vidx] = np.asarray(sol_.s_lower)[:vidx.size] * cs
        sol.s_upper[vidx] = np.asarray(sol_.s_upper)[:vidx.size] * cs
    if cidx.size:
        sol.y_lower[cidx] = np.asarray(sol_.y_lower)[:cidx.size] / rs
        sol.y_upper[cidx] = np.asarray(sol_.y_upper)[:cidx.size] / rs

    for op in reversed(ps.ops):
        op.postsolve(sol)

    # Row activities over the ORIGINAL matrix (vectorized COO bincount).
    I, J, V = ps.pb0.to_coo()
    if len(I):
        sol.Ax[:] = np.bincount(I, V * sol.x[J], minlength=ps.pb0.ncon)
    else:
        sol.Ax[:] = 0.0


class ReducedArrays:
    """Lightweight reduced-problem container (vectorized extraction path).

    Duck-types the slice of the ProblemData surface that the standard-form
    converter consumes (ncon/nvar/bounds/obj/objsense/to_coo/nnz), without
    building per-row dict storage — O(nnz) numpy instead of Python loops.
    """

    def __init__(self, name, objsense, obj, obj0, lcon, ucon, lvar, uvar,
                 I, J, V):
        self.name = name
        self.objsense = objsense
        self.obj = obj
        self.obj0 = obj0
        self.lcon = lcon
        self.ucon = ucon
        self.lvar = lvar
        self.uvar = uvar
        self._I, self._J, self._V = I, J, V

    @property
    def ncon(self):
        return len(self.lcon)

    @property
    def nvar(self):
        return len(self.lvar)

    @property
    def nnz(self):
        return len(self._V)

    def to_coo(self):
        return self._I, self._J, self._V


def _extract_reduced_arrays(self) -> "ReducedArrays":
    """Vectorized counterpart of :meth:`extract_reduced_problem`.

    Same output (same scaling formulas, same index maps, sets the same
    ``row_scaling``/``col_scaling`` used by postsolve) as the list-based
    path — asserted by tests/test_presolve.py equivalence tests — but
    built with numpy gathers/bincounts: O(nnz) C instead of Python loops.
    On arrays the original matrix comes from ``to_coo``; on lists these
    ``fromiter`` reads beat the lists' ``to_coo``.
    """
    pb0 = self.pb0
    if type(pb0) is ArrayProblemData:
        I, J, V = pb0.to_coo()
    else:
        I = np.fromiter((i for col in pb0.acols for i in col.nzind),
                        np.int64,
                        count=sum(len(c.nzind) for c in pb0.acols))
        J = np.fromiter((j for j, col in enumerate(pb0.acols)
                         for _ in col.nzind), np.int64, count=I.size)
        V = np.fromiter((v for col in pb0.acols for v in col.nzval),
                        np.float64, count=I.size)

    rowflag = np.asarray(self.rowflag, bool)
    colflag = np.asarray(self.colflag, bool)
    keep = rowflag[I] & colflag[J] & (V != 0.0) if I.size else \
        np.zeros(0, bool)
    new_con = np.asarray(self.new_con_idx, np.int64)
    new_var = np.asarray(self.new_var_idx, np.int64)
    I2 = new_con[I[keep]]
    J2 = new_var[J[keep]]
    V2 = V[keep]

    nr, nc = len(self.old_con_idx), len(self.old_var_idx)
    rnorm = np.sqrt(np.bincount(I2, V2 * V2, minlength=nr)) if nr else \
        np.zeros(0)
    cnorm = np.sqrt(np.bincount(J2, V2 * V2, minlength=nc)) if nc else \
        np.zeros(0)
    rscale = np.sqrt(np.where(rnorm > 0, rnorm, 1.0))
    cscale = np.sqrt(np.where(cnorm > 0, cnorm, 1.0))
    V2 = V2 / (rscale[I2] * cscale[J2])

    ovi = np.asarray(self.old_var_idx, np.int64)
    oci = np.asarray(self.old_con_idx, np.int64)
    obj = np.asarray(self.obj)[ovi] if nc else np.zeros(0)
    obj0 = self.obj0
    if not self.objsense:
        obj = -obj
        obj0 = -obj0
    red = ReducedArrays(
        name=pb0.name,
        objsense=self.objsense,
        obj=obj / cscale,
        obj0=obj0,
        lcon=np.asarray(self.lrow)[oci] / rscale if nr else np.zeros(0),
        ucon=np.asarray(self.urow)[oci] / rscale if nr else np.zeros(0),
        lvar=np.asarray(self.lcol)[ovi] * cscale if nc else np.zeros(0),
        uvar=np.asarray(self.ucol)[ovi] * cscale if nc else np.zeros(0),
        I=I2, J=J2, V=V2)
    self.row_scaling = rscale
    self.col_scaling = cscale
    self.pb_red = red
    return red


PresolveData.extract_reduced_arrays = _extract_reduced_arrays
