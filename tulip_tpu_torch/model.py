"""Mapping a solved standard-form lane back to the general-form problem.

Counterpart of the part of ``tulip_tpu/model.py`` that ``batch_linprog``
needs: ``_extract_solution``, copied verbatim (numpy only). The ``Model``
class is not ported yet.
"""

from __future__ import annotations

import numpy as np

from .problem import ProblemData
from .solution import Solution
from .status import SolutionStatus


def _extract_solution(sol: Solution, pb: ProblemData, state,
                      n_struct: int) -> None:
    """Map the standard-form iterate back to the general-form problem
    (reference: src/model.jl:156-215): drop slack columns, divide by τ
    unless the point is a certificate ray, sign-split row duals."""
    pt = state.pt
    n = n_struct

    sol.primal_status = SolutionStatus(int(state.primal_status))
    sol.dual_status = SolutionStatus(int(state.dual_status))
    is_primal_ray = sol.primal_status == SolutionStatus.INFEASIBILITY_CERTIFICATE
    is_dual_ray = sol.dual_status == SolutionStatus.INFEASIBILITY_CERTIFICATE
    sol.is_primal_ray = is_primal_ray
    sol.is_dual_ray = is_dual_ray
    tau_inv = 1.0 if (is_primal_ray or is_dual_ray) else 1.0 / float(pt.tau)

    x = np.asarray(pt.x)
    zl = np.asarray(pt.zl)
    zu = np.asarray(pt.zu)
    y = np.asarray(pt.y)

    sol.x[:] = x[:n] * tau_inv
    sol.s_lower[:] = zl[:n] * tau_inv
    sol.s_upper[:] = zu[:n] * tau_inv
    sol.y_lower[:] = np.maximum(y, 0.0) * tau_inv
    sol.y_upper[:] = np.maximum(-y, 0.0) * tau_inv

    # Row activity in original space (COO bincount: works for both
    # ProblemData and the vectorized ReducedArrays container).
    I, J, V = pb.to_coo()
    if len(I):
        sol.Ax[:] = np.bincount(I, V * np.asarray(sol.x)[J],
                                minlength=pb.ncon)
    else:
        sol.Ax[:] = 0.0

    pobj = float(state.pobj)
    dobj = float(state.dobj)
    if sol.primal_status == SolutionStatus.INFEASIBILITY_CERTIFICATE:
        sol.z_primal = -np.inf
        sol.z_dual = -np.inf
    elif sol.primal_status in (SolutionStatus.OPTIMAL,
                               SolutionStatus.FEASIBLE_POINT):
        sol.z_primal = pobj
    else:
        sol.z_primal = np.nan

    if sol.dual_status == SolutionStatus.INFEASIBILITY_CERTIFICATE:
        sol.z_primal = np.inf
        sol.z_dual = np.inf
    elif sol.dual_status in (SolutionStatus.OPTIMAL,
                             SolutionStatus.FEASIBLE_POINT):
        sol.z_dual = dobj
    else:
        sol.z_dual = np.nan
