"""Mehrotra predictor-corrector IPM (no homogeneous embedding), batch-first.

Counterpart of ``tulip_tpu/ipm/mpc.py`` (reference: src/IPM/MPC/MPC.jl:218-410,
src/IPM/MPC/step.jl:10-358). Every tensor has a leading lane axis, as in
:mod:`.hsd`, and the reference's per-lane ``lax.while_loop``/``lax.cond``
become per-lane masks: the regularization bumps, the extra corrections (a
lane stops at its first rejected correction) and the step gate. The state
is :class:`~.hsd.HSDState` with τ ≡ 1, κ ≡ 0 and regG ≡ 0. Differences from
HSD (reference: MPC.jl:1-5):

- a 6-block Newton system, no Δτ/Δκ recovery (step.jl:192-194);
- the Mehrotra starting point from two least-squares KKT solves
  (MPC.jl:353-410);
- separate primal and dual step lengths (step.jl:213-223);
- corrector centering σ = clamp((μ_aff/μ)³, √eps, 1-√eps) (step.jl:263);
- weaker infeasibility detection (no certificate scaling by τ).

:func:`mpc_solve` and ``batch.batched_mpc_solve`` run :func:`mpc_iteration`
through :func:`.hsd.solve`, on the device program or the host-driven loop
as it routes; :func:`mpc_solve_device` is the device program alone.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Optional, Tuple

import torch

from .data import LPData, matvec, rmatvec
from .graph import bounded_while
from .hsd import (_DUAL_INFEASIBLE, _ITERATION_LIMIT, _NUMERICAL_PROBLEM,
                  _OPTIMAL, _PRIMAL_INFEASIBLE, _SLN_CERTIFICATE,
                  _SLN_FEASIBLE, _SLN_OPTIMAL, _SLN_UNKNOWN, _UNKNOWN,
                  DataNorms, HSDState, _col, _data_norms, device_solve,
                  factor_with_bumps, first_match, fresh_state,
                  full_matmul_precision, solve, tree_where)
from .point import Point, Residuals, dot, inf_norm, num_finite_bounds, \
    update_mu


@dataclasses.dataclass(frozen=True)
class MPCOptions:
    """MPC options (defaults: reference src/IPM/options.jl).
    ``OutputLevel`` and ``TimeLimit`` apply to one LP, and ``HostLoop``
    (``tulip_tpu/ipm/mpc.py:69``) keeps the solve on the host-driven loop,
    as in :class:`~.hsd.HSDOptions`."""

    TolerancePFeas: float = 1.4901161193847656e-08
    ToleranceDFeas: float = 1.4901161193847656e-08
    ToleranceRGap: float = 1.4901161193847656e-08
    ToleranceIFeas: float = 1.4901161193847656e-08
    IterationsLimit: int = 100
    TimeLimit: float = float("inf")
    CorrectionLimit: int = 3
    StepDampFactor: float = 0.9995
    GammaMin: float = 0.1
    PRegMin: float = 1.4901161193847656e-08
    DRegMin: float = 1.4901161193847656e-08
    # Extra-correction parameters (reference: MPC/step.jl:282-285).
    CorrectionStepShift: float = 0.3   # δ
    CorrectionGamma: float = 0.1       # γ
    OutputLevel: int = 0
    HostLoop: bool = False


def mpc_residuals(dat: LPData, pt: Point):
    """Residuals without τ scaling (reference: MPC.jl:101-142)."""
    rp = dat.b - matvec(dat, pt.x)
    rl = (dat.l + pt.xl - pt.x) * dat.lflag
    ru = (dat.u - pt.x - pt.xu) * dat.uflag
    rd = (dat.c - rmatvec(dat, pt.y) - pt.zl * dat.lflag + pt.zu * dat.uflag)
    return rp, rl, ru, rd


def mpc_objectives(dat: LPData, pt: Point):
    pobj = dot(dat.c, pt.x) + dat.c0
    dobj = (dot(dat.b, pt.y)
            + dot(dat.l * dat.lflag, pt.zl)
            - dot(dat.u * dat.uflag, pt.zu)) + dat.c0
    return pobj, dobj


def solve_newton_system_mpc(dat: LPData, pt: Point, kkt_solve,
                            xi_p, xi_l, xi_u, xi_d, xi_xzl, xi_xzu) -> Point:
    """6-block Newton solve via one augmented solve + closed-form recovery
    (reference: src/IPM/MPC/step.jl:164-206)."""
    lf, uf = dat.lflag, dat.uflag
    xl_s = torch.where(lf > 0, pt.xl, 1.0)
    xu_s = torch.where(uf > 0, pt.xu, 1.0)

    xi_d_ = xi_d + (-((xi_xzl + pt.zl * xi_l) / xl_s) * lf
                    + ((xi_xzu - pt.zu * xi_u) / xu_s) * uf)
    dx, dy = kkt_solve(xi_p, xi_d_)

    dxl = (-xi_l + dx) * lf
    dxu = (xi_u - dx) * uf
    dzl = ((xi_xzl - pt.zl * dxl) / xl_s) * lf
    dzu = ((xi_xzu - pt.zu * dxu) / xu_s) * uf

    zero = torch.zeros_like(pt.tau)
    return Point(x=dx, xl=dxl, xu=dxu, y=dy, zl=dzl, zu=dzu,
                 tau=zero, kappa=zero, mu=zero)


def max_step_length_pd(dat: LPData, pt: Point, delta: Point,
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Separate primal and dual ratio tests per lane, each capped at 1
    (reference: step.jl:213-223)."""
    def ratio(x, dx, mask):
        neg = (dx < 0) & (mask > 0)
        r = torch.where(neg, -x / torch.where(neg, dx, -1.0), float("inf"))
        return r.amin(dim=-1)

    ap = torch.clamp_max(torch.minimum(ratio(pt.xl, delta.xl, dat.lflag),
                                       ratio(pt.xu, delta.xu, dat.uflag)),
                         1.0)
    ad = torch.clamp_max(torch.minimum(ratio(pt.zl, delta.zl, dat.lflag),
                                       ratio(pt.zu, delta.zu, dat.uflag)),
                         1.0)
    return ap, ad


def mpc_starting_point(dat: LPData, backend, kkt) -> Tuple[Point, object]:
    """Mehrotra starting point (reference: src/IPM/MPC/MPC.jl:353-410):
    two least-squares KKT solves, positivity shifts, complementarity
    balancing. Returns the point and the factorized backend state."""
    lf, uf = dat.lflag, dat.uflag
    zeros_n = torch.zeros_like(dat.c)

    kkt, _ok = backend.update(kkt, zeros_n, torch.ones_like(dat.c),
                              torch.full_like(dat.b, 1e-6))
    _, y = backend.solve(kkt, torch.zeros_like(dat.b), dat.c)
    x, _ = backend.solve(kkt, dat.b, zeros_n)

    dx_shift = 1.0 + torch.clamp_min(torch.maximum(
        -1.5 * ((x - dat.l) * lf).amin(dim=-1),
        -1.5 * ((dat.u - x) * uf).amin(dim=-1)), 0.0)
    xl = ((x - dat.l) + _col(dx_shift)) * lf
    xu = ((dat.u - x) + _col(dx_shift)) * uf

    z = dat.c - rmatvec(dat, y)
    denom = torch.clamp_min(lf + uf, 1.0)
    zl = (z / denom) * lf
    zu = (-z / denom) * uf
    dz_shift = 1.0 + torch.clamp_min(torch.maximum(
        -1.5 * zl.amin(dim=-1), -1.5 * zu.amin(dim=-1)), 0.0)
    zl = zl + _col(dz_shift) * lf
    zu = zu + _col(dz_shift) * uf

    # Balance complementarity products (MPC.jl:396-404).
    mu0 = dot(xl, zl) + dot(xu, zu)
    sz = zl.sum(-1) + zu.sum(-1)
    sx = xl.sum(-1) + xu.sum(-1)
    dxb = mu0 / torch.clamp_min(2 * sz, 1e-300)
    dzb = mu0 / torch.clamp_min(2 * sx, 1e-300)
    xl = xl + _col(dxb) * lf
    xu = xu + _col(dxb) * uf
    zl = zl + _col(dzb) * lf
    zu = zu + _col(dzb) * uf

    one = torch.ones_like(dat.c0)
    pt = Point(x=x, xl=xl, xu=xu, y=y, zl=zl, zu=zu,
               tau=one, kappa=torch.zeros_like(one), mu=one)
    return update_mu(pt, dat, hflag=False), kkt


def compute_step_mpc(backend, opts: MPCOptions, dat: LPData, state: HSDState,
                     ) -> HSDState:
    """One MPC step for every lane (reference: src/IPM/MPC/step.jl:10-123).
    The caller masks the result to the lanes that should move."""
    pt, res = state.pt, state.res
    lf, uf = dat.lflag, dat.uflag
    p = num_finite_bounds(dat)
    sqeps = math.sqrt(torch.finfo(pt.x.dtype).eps)

    xl_s = torch.where(lf > 0, pt.xl, 1.0)
    xu_s = torch.where(uf > 0, pt.xu, 1.0)
    theta_l = (pt.zl / xl_s) * lf
    theta_u = (pt.zu / xu_s) * uf
    theta_inv = theta_l + theta_u

    # Regularization decay, clamped to [min, 1] (step.jl:29-32).
    regP = torch.clamp(state.regP / 10.0, opts.PRegMin, 1.0)
    regD = torch.clamp(state.regD / 10.0, opts.DRegMin, 1.0)

    kkt, regP, regD, _, fact_ok = factor_with_bumps(
        backend, state.kkt, theta_inv, regP, regD)

    kkt_solve = partial(backend.solve, kkt)
    rp, rl, ru, rd = res.rp, res.rl, res.ru, res.rd

    # Predictor (step.jl:229-246).
    delta = solve_newton_system_mpc(
        dat, pt, kkt_solve, rp, rl, ru, rd,
        -(pt.xl * pt.zl) * lf, -(pt.xu * pt.zu) * uf)
    ap, ad = max_step_length_pd(dat, pt, delta)

    # Corrector (step.jl:251-277). p = 0 (all variables free): mu_aff and
    # the centering ratio are 0 by convention rather than 0/0 = NaN.
    apc, adc = _col(ap), _col(ad)
    mu_aff = (dot((pt.xl + apc * delta.xl) * lf, pt.zl + adc * delta.zl)
              + dot((pt.xu + apc * delta.xu) * uf, pt.zu + adc * delta.zu)
              ) / torch.clamp_min(p, 1.0)
    pos = pt.mu > 0
    mu_ratio = torch.where(pos, mu_aff / torch.where(pos, pt.mu, 1.0), 0.0)
    sigma = torch.clamp(mu_ratio ** 3, sqeps, 1.0 - sqeps)
    smu = _col(sigma * pt.mu)
    delta = solve_newton_system_mpc(
        dat, pt, kkt_solve, rp, rl, ru, rd,
        (smu - delta.xl * delta.zl - pt.xl * pt.zl) * lf,
        (smu - delta.xu * delta.zu - pt.xu * pt.zu) * uf)
    ap, ad = max_step_length_pd(dat, pt, delta)

    # Extra centrality corrections (step.jl:85-109, 282-358): zero p/l/u/d
    # blocks; accepted only if BOTH step lengths grow by >= 1%. A lane
    # stops at CorrectionLimit or at its first rejected correction.
    gam = opts.CorrectionGamma
    shift = opts.CorrectionStepShift
    zero_m = torch.zeros_like(pt.y)
    zero_n = torch.zeros_like(pt.x)

    def correct(c, active):
        delta, ap, ad, done = c
        ap_ = _col(torch.clamp_max(ap + shift, 1.0))
        ad_ = _col(torch.clamp_max(ad + shift, 1.0))
        apc, adc = _col(ap), _col(ad)

        g = dot(pt.xl, pt.zl) + dot(pt.xu, pt.zu)
        ga = (dot((pt.xl + apc * delta.xl) * lf, pt.zl + adc * delta.zl)
              + dot((pt.xu + apc * delta.xu) * uf, pt.zu + adc * delta.zu))
        mu_t = (ga / g) * (ga / g) * (ga / p)
        tmin, tmax = _col(mu_t * gam), _col(mu_t / gam)

        def target(x, dxv, z, dzv, mask):
            v = (x + ap_ * dxv) * (z + ad_ * dzv)
            return torch.where(v < tmin, tmin - v,
                               torch.where(v > tmax, tmax - v, 0.0)) * mask

        xzl = target(pt.xl, delta.xl, pt.zl, delta.zl, lf)
        xzu = target(pt.xu, delta.xu, pt.zu, delta.zu, uf)

        dc = solve_newton_system_mpc(dat, pt, kkt_solve,
                                     zero_m, zero_n, zero_n, zero_n,
                                     xzl, xzu)
        dc = Point(x=dc.x + delta.x, xl=dc.xl + delta.xl,
                   xu=dc.xu + delta.xu, y=dc.y + delta.y,
                   zl=dc.zl + delta.zl, zu=dc.zu + delta.zu,
                   tau=dc.tau, kappa=dc.kappa, mu=dc.mu)
        ap_c, ad_c = max_step_length_pd(dat, pt, dc)
        accept = active & (ap_c >= 1.01 * ap) & (ad_c >= 1.01 * ad)
        return (tree_where(accept, dc, delta), torch.where(accept, ap_c, ap),
                torch.where(accept, ad_c, ad), done | ~accept)

    delta, ap, ad, _ = bounded_while(
        lambda c: ~c[3], correct,
        (delta, ap, ad, torch.zeros_like(ap, dtype=torch.bool)),
        opts.CorrectionLimit)

    # Damped update with separate primal/dual lengths (step.jl:111-120).
    apc = _col(ap * opts.StepDampFactor)
    adc = _col(ad * opts.StepDampFactor)
    pt_new = Point(
        x=pt.x + apc * delta.x,
        xl=pt.xl + apc * delta.xl,
        xu=pt.xu + apc * delta.xu,
        y=pt.y + adc * delta.y,
        zl=pt.zl + adc * delta.zl,
        zu=pt.zu + adc * delta.zu,
        tau=pt.tau, kappa=pt.kappa, mu=pt.mu)
    pt_new = update_mu(pt_new, dat, hflag=False)

    # Factorization failure after all bumps → numerical-problem status:
    # keep the old point, flag the lane.
    pt_out = tree_where(fact_ok, pt_new, pt)
    status = torch.where(fact_ok, state.status,
                         torch.full_like(state.status, _NUMERICAL_PROBLEM))
    niter = torch.where(fact_ok, state.niter + 1, state.niter)
    return state._replace(pt=pt_out, regP=regP, regD=regD, kkt=kkt,
                          niter=niter, status=status)


def update_status_mpc(dat: LPData, opts: MPCOptions, norms: DataNorms,
                      state: HSDState) -> HSDState:
    """Optimality + (weaker) infeasibility tests per lane
    (reference: src/IPM/MPC/MPC.jl:150-211)."""
    pt, res = state.pt, state.res

    pobj, dobj = mpc_objectives(dat, pt)

    rho_p = torch.maximum(
        res.rp_nrm / (1.0 + norms.b),
        torch.maximum(res.rl_nrm / (1.0 + norms.l),
                      res.ru_nrm / (1.0 + norms.u)))
    rho_d = res.rd_nrm / (1.0 + norms.c)
    rho_g = (pobj - dobj).abs() / (1.0 + pobj.abs())

    p_feas = rho_p <= opts.TolerancePFeas
    d_feas = rho_d <= opts.ToleranceDFeas
    # Divergence guard (tulip_tpu/ipm/mpc.py:332-343): on an unbounded LP
    # the relative tests fire spuriously once |pobj| ~ 1/eps, so an optimal
    # claim needs finite objectives and an iterate within 1/eps.
    diverge = 1.0 / torch.finfo(pt.x.dtype).eps
    finite = (torch.isfinite(pobj) & torch.isfinite(dobj)
              & (inf_norm(pt.x) < diverge))
    optimal = p_feas & d_feas & (rho_g <= opts.ToleranceRGap) & finite

    ray_nrm = torch.maximum(
        inf_norm(matvec(dat, pt.x)),
        torch.maximum(inf_norm((pt.x - pt.xl) * dat.lflag),
                      inf_norm((pt.x + pt.xu) * dat.uflag)))
    dual_infeas = (ray_nrm * (norms.c / torch.clamp_min(norms.b, 1.0))
                   < -opts.ToleranceIFeas * dot(dat.c, pt.x))

    dlt = rmatvec(dat, pt.y) + pt.zl * dat.lflag - pt.zu * dat.uflag
    farkas_obj = (dot(dat.b, pt.y)
                  + dot(dat.l * dat.lflag, pt.zl)
                  - dot(dat.u * dat.uflag, pt.zu))
    primal_infeas = (inf_norm(dlt)
                     * torch.maximum(torch.maximum(norms.l, norms.u), norms.b)
                     / torch.clamp_min(norms.c, 1.0)
                     < farkas_obj * opts.ToleranceIFeas)

    pick = partial(first_match, state.status)
    status = pick((optimal, _OPTIMAL), (dual_infeas, _DUAL_INFEASIBLE),
                  (primal_infeas, _PRIMAL_INFEASIBLE), default=_UNKNOWN)
    primal_status = pick((optimal, _SLN_OPTIMAL),
                         (dual_infeas, _SLN_CERTIFICATE),
                         (p_feas, _SLN_FEASIBLE), default=_SLN_UNKNOWN)
    dual_status = pick((optimal, _SLN_OPTIMAL),
                       (primal_infeas, _SLN_CERTIFICATE),
                       (d_feas, _SLN_FEASIBLE), default=_SLN_UNKNOWN)

    return state._replace(status=status, primal_status=primal_status,
                          dual_status=dual_status, pobj=pobj, dobj=dobj)


def _mpc_residual_state(dat: LPData, state: HSDState) -> HSDState:
    rp, rl, ru, rd = mpc_residuals(dat, state.pt)
    zero = torch.zeros_like(dat.c0)
    res = Residuals(rp=rp, rl=rl, ru=ru, rd=rd, rg=zero,
                    rp_nrm=inf_norm(rp), rl_nrm=inf_norm(rl),
                    ru_nrm=inf_norm(ru), rd_nrm=inf_norm(rd), rg_nrm=zero)
    pt = update_mu(state.pt, dat, hflag=False)
    return state._replace(pt=pt, res=res)


def mpc_iteration(backend, opts: MPCOptions, dat: LPData, state: HSDState,
                  ) -> HSDState:
    """Residuals → status checks → one step on the lanes still UNKNOWN
    (reference: ``tulip_tpu/ipm/mpc.py:392-404``)."""
    norms = _data_norms(dat)
    state = _mpc_residual_state(dat, state)
    state = update_status_mpc(dat, opts, norms, state)
    state = state._replace(status=torch.where(
        (state.status == _UNKNOWN) & (state.niter >= opts.IterationsLimit),
        torch.full_like(state.status, _ITERATION_LIMIT), state.status))
    moving = state.status == _UNKNOWN
    return tree_where(moving, compute_step_mpc(backend, opts, dat, state),
                      state)


def init_state_mpc(dat: LPData, backend) -> HSDState:
    """Mehrotra start for every lane (reference: MPC.jl:353-410)."""
    kkt = backend.setup_data(dat)
    pt, kkt = mpc_starting_point(dat, backend, kkt)
    state = fresh_state(dat, pt, None, kkt, regG=torch.zeros_like(dat.c0))
    return _mpc_residual_state(dat, state)


def mpc_solve_device(backend, opts: MPCOptions, dat: LPData,
                     state: Optional[HSDState] = None) -> HSDState:
    """The whole MPC solve as the device program (reference:
    ``tulip_tpu/ipm/mpc.py:435-448``), from ``state`` or, when None, from
    :func:`init_state_mpc` run eagerly, for any backend, as the
    reference's."""
    if state is None:
        with full_matmul_precision():
            state = init_state_mpc(dat, backend)
    return device_solve(backend, opts, dat, state, mpc_iteration)


def mpc_solve(dat: LPData, backend, opts: MPCOptions,
              log_fn=None) -> HSDState:
    """Solve one LP, a batch of one (reference: MPC.jl:218-351).
    ``log_fn(state)`` is called after every iteration."""
    if dat.b.shape[0] != 1:
        raise ValueError(f"mpc_solve takes one LP, got a batch of "
                         f"{dat.b.shape[0]}; use batched_mpc_solve")
    return solve(backend, opts, dat, init=init_state_mpc,
                 iteration=mpc_iteration, algo="MPC", log_fn=log_fn)
