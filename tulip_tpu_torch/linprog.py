"""scipy.optimize.linprog-compatible entry points.

Counterpart of ``tulip_tpu/linprog.py``: ``linprog`` solves one LP through
:class:`~tulip_tpu_torch.model.Model`, ``batch_linprog`` many in batched
solves. Both take ``device`` (default ``"cuda"``)::

    from tulip_tpu_torch import linprog
    res = linprog(c, A_ub=..., b_ub=..., A_eq=..., b_eq=..., bounds=...)
    res.x, res.fun, res.status, res.success
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .params import Parameters
from .problem import INF
from .status import TerminationStatus


@dataclasses.dataclass
class LinprogResult:
    x: np.ndarray
    fun: float
    success: bool
    status: int            # 0 optimal, 1 iter limit, 2 infeasible,
    # 3 unbounded, 4 numerical (scipy convention)
    message: str
    nit: int
    # Extras beyond scipy:
    termination: TerminationStatus
    y: Optional[np.ndarray] = None      # row duals (eq then ub rows)
    s: Optional[np.ndarray] = None      # bound reduced costs


_STATUS_MAP = {
    TerminationStatus.OPTIMAL: (0, "Optimization terminated successfully."),
    TerminationStatus.ITERATION_LIMIT: (1, "Iteration limit reached."),
    TerminationStatus.TIME_LIMIT: (1, "Time limit reached."),
    TerminationStatus.PRIMAL_INFEASIBLE: (2, "Problem is infeasible."),
    TerminationStatus.DUAL_INFEASIBLE: (3, "Problem is unbounded."),
    TerminationStatus.NUMERICAL_PROBLEM: (4, "Numerical difficulties."),
}


def _fill_pbdata(pb, c, A_ub, b_ub, A_eq, b_eq, bounds):
    """Populate a ProblemData from scipy-linprog-style inputs; returns n."""
    c = np.atleast_1d(np.asarray(c, dtype=float))
    n = c.shape[0]
    if bounds is None:
        bounds = [(0.0, None)] * n
    elif len(bounds) == 2 and np.isscalar(bounds[0]):
        bounds = [tuple(bounds)] * n
    for j in range(n):
        lb, ub = bounds[j]
        pb.add_variable((), (), c[j],
                        -INF if lb is None else float(lb),
                        INF if ub is None else float(ub))

    def add_rows(A, b, is_eq):
        if A is None:
            return 0
        A = np.atleast_2d(np.asarray(A, dtype=float))
        b = np.atleast_1d(np.asarray(b, dtype=float))
        for i in range(A.shape[0]):
            cols = np.nonzero(A[i])[0]
            vals = A[i, cols]
            if is_eq:
                pb.add_constraint(cols.tolist(), vals.tolist(), b[i], b[i])
            else:
                pb.add_constraint(cols.tolist(), vals.tolist(), -INF, b[i])
        return A.shape[0]

    add_rows(A_eq, b_eq, True)
    add_rows(A_ub, b_ub, False)
    return n


def linprog(c, A_ub=None, b_ub=None, A_eq=None, b_eq=None,
            bounds: Optional[Sequence] = None, *,
            params: Optional[Parameters] = None,
            device="cuda") -> LinprogResult:
    """Minimize ``c @ x`` s.t. ``A_ub x <= b_ub``, ``A_eq x = b_eq``,
    ``bounds[j] = (lb, ub)`` (default ``(0, None)`` like scipy), with the
    IPM on ``device``."""
    from .api import get_attribute
    from .model import Model

    m = Model(params, device=device)
    n = _fill_pbdata(m.pbdata, c, A_ub, b_ub, A_eq, b_eq, bounds)

    st = m.optimize()
    code, msg = _STATUS_MAP.get(st, (4, st.name))
    sol = m.solution
    x = sol.x.copy() if sol is not None else np.full(n, np.nan)
    fun = (get_attribute(m, "ObjectiveValue")
           if st == TerminationStatus.OPTIMAL else np.nan)
    return LinprogResult(
        x=x, fun=fun, success=st == TerminationStatus.OPTIMAL,
        status=code, message=msg, nit=m.barrier_iterations,
        termination=st,
        y=(sol.y_lower - sol.y_upper) if sol is not None else None,
        s=(sol.s_lower - sol.s_upper) if sol is not None else None,
    )


def batch_linprog(problems: Sequence[dict], *, device="cuda",
                  dtype="float32", params: Optional[Parameters] = None,
                  backend=None, algorithm: str = "HSD",
                  presolve: Optional[bool] = None) -> list:
    """Solve MANY independent LPs, one batched solve per shape bucket.

    ``problems``: sequence of dicts with scipy ``linprog`` keywords
    (``c`` required; ``A_ub``/``b_ub``/``A_eq``/``b_eq``/``bounds``
    optional). Heterogeneous shapes are grouped into pad-to-next-power-of-
    two shape buckets, one batched solve per bucket, results re-interleaved
    (padded columns pinned to 0, padded rows 0·x=0, see
    :func:`tulip_tpu_torch.ipm.batch.pad_lp`); convergence is tracked per
    instance.

    ``presolve`` (default: follow ``params.Presolve.Level``) runs the
    Python host presolve per instance; instances decided outright never
    reach the device, and the rest solve in reduced form with postsolve
    mapping back.

    ``device`` and ``dtype`` ("float32" or "float64") place the batched
    solve. The default backend is :class:`SmallK1Backend` (the chol-inv
    kernel) for float32 on CUDA, else ``DenseK1Backend(inv_factor=True)``.
    ``algorithm`` is "HSD" or "MPC".

    Returns a list of :class:`LinprogResult` (duals in standard-form row
    order: equality rows first, then inequality rows).
    """
    from .ipm.batch import (batched_hsd_solve, batched_mpc_solve,
                            bucket_dim, stack_lps_host)
    from .ipm.data import standard_form_arrays
    from .ipm.hsd import HSDOptions
    from .ipm.mpc import MPCOptions
    from .kkt import DenseK1Backend, SmallK1Backend
    from .model import TORCH_DTYPES, _extract_solution, _host_lane, _to_numpy
    from .presolve import PresolveData, postsolve
    from .problem import ProblemData
    from .solution import Solution

    algorithm = algorithm.upper()
    if algorithm not in ("HSD", "MPC"):
        raise ValueError(f"unknown algorithm {algorithm!r}")

    params = params or Parameters()
    dt = np.dtype(dtype)
    tdtype = TORCH_DTYPES[dt]
    device = torch.device(device)
    if presolve is None:
        presolve = params.Presolve.Level > 0

    dats, meta, decided = [], [], {}
    for idx, kw in enumerate(problems):
        pb = ProblemData()
        n = _fill_pbdata(pb, kw["c"], kw.get("A_ub"), kw.get("b_ub"),
                         kw.get("A_eq"), kw.get("b_eq"), kw.get("bounds"))
        cvec = np.asarray(pb.obj, dtype=float)
        ps = None
        pb_ = pb
        if presolve:
            ps = PresolveData(pb, params.Presolve)
            st = ps.presolve()
            if st in (TerminationStatus.OPTIMAL,
                      TerminationStatus.PRIMAL_INFEASIBLE,
                      TerminationStatus.DUAL_INFEASIBLE,
                      TerminationStatus.PRIMAL_DUAL_INFEASIBLE):
                sol = Solution(pb.ncon, pb.nvar)
                postsolve(sol, ps.solution, ps)
                decided[idx] = (st, sol, cvec, pb.obj0, n)
                continue
            pb_ = ps.extract_reduced_arrays()
        # Keep standard-form arrays on host; one stacked transfer below.
        A_, b_, c_, c0_, l_, u_, _ = standard_form_arrays(pb_)
        dats.append((A_, b_, c_, c0_, l_, u_))
        meta.append((idx, n, cvec, pb.obj0, ps, pb, pb_, pb_.nvar))

    def _decided_result(st, sol, cvec, c0, n):
        code, msg = _STATUS_MAP.get(st, (4, st.name))
        x = np.asarray(sol.x[:n], dtype=float)
        fun = (float(cvec @ x + c0)
               if st == TerminationStatus.OPTIMAL else np.nan)
        return LinprogResult(
            x=x, fun=fun, success=st == TerminationStatus.OPTIMAL,
            status=code, message=msg, nit=0, termination=st,
            y=np.asarray(sol.y_lower) - np.asarray(sol.y_upper),
            s=np.asarray(sol.s_lower) - np.asarray(sol.s_upper))

    results = [None] * len(problems)
    for i, args in decided.items():
        results[i] = _decided_result(*args)
    if not dats:                        # everything decided by presolve
        return results

    if backend is None:
        if dt == np.float32 and device.type == "cuda":
            backend = SmallK1Backend(refinement_steps=1)
        else:
            backend = DenseK1Backend(
                inv_factor=True,
                refinement_steps=1 if dt == np.float32 else 0)
    ipm = params.IPM.resolved(dt)
    opt_kw = dict(
        TolerancePFeas=ipm.TolerancePFeas, ToleranceDFeas=ipm.ToleranceDFeas,
        ToleranceRGap=ipm.ToleranceRGap, ToleranceIFeas=ipm.ToleranceIFeas,
        IterationsLimit=ipm.IterationsLimit,
        PRegMin=max(ipm.PRegMin, 1e-6 if dt == np.float32 else 0.0),
        DRegMin=max(ipm.DRegMin, 1e-6 if dt == np.float32 else 0.0),
    )
    if algorithm == "HSD":
        opts, solver = HSDOptions(**opt_kw), batched_hsd_solve
    else:
        opts, solver = MPCOptions(**opt_kw), batched_mpc_solve

    # Shape buckets: group lanes by a pad-to-next-power-of-two envelope,
    # one batched solve per bucket, so one outlier instance inflates only
    # its own bucket.
    buckets: dict = {}
    for lane, d in enumerate(dats):
        key = (bucket_dim(d[0].shape[0]), bucket_dim(d[0].shape[1]))
        buckets.setdefault(key, []).append(lane)

    lane_out = {}
    for key in sorted(buckets):
        lanes = buckets[key]
        stacked = stack_lps_host([dats[i] for i in lanes], device=device,
                                 dtype=tdtype, m_pad=key[0], n_pad=key[1])
        out_b = _to_numpy(solver(backend, opts, stacked))
        for pos, lane in enumerate(lanes):
            lane_out[lane] = (out_b, pos)

    for lane, (idx, n, cvec, c0, ps, pb, pb_, n_struct) in enumerate(meta):
        out, pos = lane_out[lane]
        st = TerminationStatus(int(out.status[pos]))
        code, msg = _STATUS_MAP.get(st, (4, st.name))
        # Un-pad the lane back to the instance's true standard-form dims.
        m_i, n_i = dats[lane][0].shape
        state_i = _host_lane(out, pos, m_i, n_i)
        if ps is not None:
            sol_inner = Solution(pb_.ncon, pb_.nvar)
            _extract_solution(sol_inner, pb_, state_i, n_struct)
            sol = Solution(pb.ncon, pb.nvar)
            postsolve(sol, sol_inner, ps)
        else:
            sol = Solution(pb.ncon, pb.nvar)
            _extract_solution(sol, pb, state_i, n_struct)
        x = np.asarray(sol.x[:n], dtype=float)
        fun = (float(cvec @ x + c0)
               if st == TerminationStatus.OPTIMAL else np.nan)
        results[idx] = LinprogResult(
            x=x, fun=fun, success=st == TerminationStatus.OPTIMAL,
            status=code, message=msg, nit=int(out.niter[pos]),
            termination=st,
            y=np.asarray(sol.y_lower) - np.asarray(sol.y_upper),
            s=np.asarray(sol.s_lower) - np.asarray(sol.s_upper))
    return results
