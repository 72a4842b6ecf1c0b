"""Homogeneous self-dual interior-point method over a batch of LPs.

Counterpart of ``tulip_tpu/ipm/hsd.py`` (reference: src/IPM/HSD/HSD.jl:203-350,
src/IPM/HSD/step.jl:10-401), written batch-first: every tensor has a
leading lane axis, and one LP is a batch of one.

The JAX package gets its batch from ``vmap`` around ``lax.while_loop`` and
``lax.cond``. Under vmap the body runs for every lane and a lane whose
predicate is false keeps its old carry; here the same is written out as
per-lane masks:

- the regularization bump ladder: a lane that factored keeps its regP,
  regD, regG and factor;
- the centrality-correction loop: ``use``/``done`` are per lane;
- the step gate: a lane that is not UNKNOWN does not move and its ``niter``
  freezes;
- the iteration loop (:func:`solve`): a lane that has terminated keeps
  its whole state.

:func:`solve` runs the loop one of two ways, as the reference's
``hsd_solve`` does (``tulip_tpu/ipm/hsd.py:587-595``):

- the device program (:func:`hsd_solve_device`, :mod:`.graph`): one
  captured pass, replayed with one host read a pass; the two inner loops
  run their bound of trips, masked (3 bumps, CorrectionLimit
  corrections). The pass is one CUDA graph, or, where it holds Krylov
  solves or Gloo collectives, a script of graphs with the Krylov trips in
  chunk graphs (a host read a chunk) and the collectives on the host
  between them. It is taken when nothing needs the host between passes
  (``OutputLevel == 0``, no ``log_fn``, no finite ``TimeLimit``,
  ``HostLoop`` off) and the backend declares ``device_loop`` (every
  backend of the port);
- the host-driven loop: every loop asks the device whether any lane is
  still active, one host sync a pass, a bump and a correction.

Both compute the same state, bit for bit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from functools import partial
from typing import Any, NamedTuple, Optional, Tuple

import torch

from .. import trace
from ..status import SolutionStatus, TerminationStatus
from . import graph
from .data import LPData, matvec, rmatvec
from .graph import bounded_while
from .point import (Point, Residuals, compute_residuals, dot, dual_objective,
                    inf_norm, num_finite_bounds, primal_objective,
                    starting_point, update_mu)

_UNKNOWN = int(TerminationStatus.UNKNOWN)
_OPTIMAL = int(TerminationStatus.OPTIMAL)
_PRIMAL_INFEASIBLE = int(TerminationStatus.PRIMAL_INFEASIBLE)
_DUAL_INFEASIBLE = int(TerminationStatus.DUAL_INFEASIBLE)
_ITERATION_LIMIT = int(TerminationStatus.ITERATION_LIMIT)
_NUMERICAL_PROBLEM = int(TerminationStatus.NUMERICAL_PROBLEM)

_SLN_UNKNOWN = int(SolutionStatus.UNKNOWN)
_SLN_OPTIMAL = int(SolutionStatus.OPTIMAL)
_SLN_FEASIBLE = int(SolutionStatus.FEASIBLE_POINT)
_SLN_CERTIFICATE = int(SolutionStatus.INFEASIBILITY_CERTIFICATE)


@dataclasses.dataclass(frozen=True)
class HSDOptions:
    """Solver options; defaults mirror the reference
    (reference: src/IPM/options.jl:1-25). Tolerance and regularization
    fields must be pre-resolved floats.

    ``OutputLevel > 0`` (an iteration log) and a finite ``TimeLimit``
    apply to one LP, a batch of one; for more lanes the solve raises
    ``ValueError``, as the reference's batched path has neither.

    ``HostLoop`` (the reference's field, ``tulip_tpu/ipm/hsd.py:97``)
    keeps the solve on the host-driven loop even when the device program
    could run it (:func:`solve`). The reference sets it to work around an
    XLA:TPU compiler fault; here it selects the loop that syncs between
    passes, with the same result.
    """

    TolerancePFeas: float = 1.4901161193847656e-08
    ToleranceDFeas: float = 1.4901161193847656e-08
    ToleranceRGap: float = 1.4901161193847656e-08
    ToleranceIFeas: float = 1.4901161193847656e-08
    IterationsLimit: int = 100
    TimeLimit: float = float("inf")
    CorrectionLimit: int = 3
    StepDampFactor: float = 0.9995
    GammaMin: float = 0.1
    CentralityOutlierThreshold: float = 0.1
    PRegMin: float = 1.4901161193847656e-08
    DRegMin: float = 1.4901161193847656e-08
    OutputLevel: int = 0
    MehrotraStart: bool = False
    # Solve the predictor / the extra centrality corrections with the
    # backend's unrefined base solve (the corrector direction, the one
    # taken, keeps full accuracy).
    FastPredictor: bool = False
    FastCorrections: bool = False
    HostLoop: bool = False


class HSDState(NamedTuple):
    """Full solver state of a batch; every field has a leading lane axis."""

    pt: Point
    res: Residuals
    regP: torch.Tensor           # (B, n)
    regD: torch.Tensor           # (B, m)
    regG: torch.Tensor           # (B,)
    kkt: Any                     # backend state (NamedTuple of tensors)
    niter: torch.Tensor          # (B,) int32
    status: torch.Tensor         # (B,) int32 TerminationStatus
    primal_status: torch.Tensor  # (B,) int32 SolutionStatus
    dual_status: torch.Tensor    # (B,) int32 SolutionStatus
    pobj: torch.Tensor           # (B,)
    dobj: torch.Tensor           # (B,)


class DataNorms(NamedTuple):
    """Per-lane inf-norms of problem data, computed once per iteration."""

    b: torch.Tensor
    c: torch.Tensor
    l: torch.Tensor  # of l*lflag
    u: torch.Tensor  # of u*uflag


def _data_norms(dat: LPData) -> DataNorms:
    return DataNorms(
        b=inf_norm(dat.b), c=inf_norm(dat.c),
        l=inf_norm(dat.l * dat.lflag), u=inf_norm(dat.u * dat.uflag),
    )


def tree_where(mask: torch.Tensor, a, b):
    """Per-lane select over matching NamedTuples of tensors: lane i takes
    ``a`` where ``mask[i]`` is true, else ``b``. Leaves and subtrees that
    are the same object are passed through (a structured KKT state's plan:
    its index tensors and its tuple of level schedules)."""
    if a is b:
        return a
    if isinstance(a, tuple):
        return type(a)(*(tree_where(mask, x, y) for x, y in zip(a, b)))
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


@contextlib.contextmanager
def full_matmul_precision():
    """Pin true-f32 matmuls (TF32 off) for the duration of a solve, and
    restore the caller's settings after. In reduced-precision matmuls the
    IPM stalls near tolerance (the JAX package observed 526/1024 vs
    1024/1024 batched f32 solves, ``tulip_tpu/ipm/hsd.py:138-149``)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _col(v: torch.Tensor) -> torch.Tensor:
    """(B,) per-lane scalar -> (B, 1), to broadcast against (B, k)."""
    return v.unsqueeze(-1)


# ---------------------------------------------------------------------------
# Newton system
# ---------------------------------------------------------------------------

class NewtonAux(NamedTuple):
    """Per-iteration constants for Δτ recovery: the preliminary augmented
    solve (hx, hy), the denominator h0, and cpx = c + Θl·l + Θu·u
    (reference: src/IPM/HSD/step.jl:58-76)."""

    hx: torch.Tensor
    hy: torch.Tensor
    h0: torch.Tensor
    cpx: torch.Tensor


def augmented_rhs(dat: LPData, pt: Point, xi_l, xi_u, xi_d, xi_xzl, xi_xzu):
    """Modified dual RHS of the reduced augmented system
    (reference: src/IPM/HSD/step.jl:210-214)."""
    lf, uf = dat.lflag, dat.uflag
    xl_s = torch.where(lf > 0, pt.xl, 1.0)
    xu_s = torch.where(uf > 0, pt.xu, 1.0)
    return xi_d + (-((xi_xzl + pt.zl * xi_l) / xl_s) * lf
                   + ((xi_xzu - pt.zu * xi_u) / xu_s) * uf)


def solve_newton_system(dat: LPData, pt: Point, kkt_solve, aux: NewtonAux,
                        xi_p, xi_l, xi_u, xi_d, xi_g, xi_xzl, xi_xzu, xi_tk,
                        ) -> Point:
    """Solve the 8-block HSD Newton system by reduction to one augmented
    solve plus closed-form recovery (reference: src/IPM/HSD/step.jl:198-266).
    ``xi_g`` and ``xi_tk`` are (B,) per-lane scalars."""
    lf, uf = dat.lflag, dat.uflag
    xl_s = torch.where(lf > 0, pt.xl, 1.0)
    xu_s = torch.where(uf > 0, pt.xu, 1.0)
    ll = dat.l * lf
    uu = dat.u * uf

    # I. Augmented solve with modified dual RHS (step.jl:210-214).
    xi_d_ = augmented_rhs(dat, pt, xi_l, xi_u, xi_d, xi_xzl, xi_xzu)
    dx, dy = kkt_solve(xi_p, xi_d_)

    # II. Recover Δτ (step.jl:218-233).
    xi_g_ = (xi_g + xi_tk / pt.tau
             - dot((xi_xzl / xl_s) * lf, ll)
             + dot((xi_xzu / xu_s) * uf, uu)
             - dot(((pt.zl / xl_s) * xi_l) * lf, ll)
             - dot(((pt.zu / xu_s) * xi_u) * uf, uu))
    dtau = (xi_g_ + dot(aux.cpx, dx) - dot(dat.b, dy)) / aux.h0

    dx = dx + _col(dtau) * aux.hx
    dy = dy + _col(dtau) * aux.hy

    # III. Recover bound slacks (step.jl:240-245).
    dxl = (-xi_l + dx - _col(dtau) * ll) * lf
    dxu = (xi_u - dx + _col(dtau) * uu) * uf

    # IV. Recover bound duals (step.jl:248-249).
    dzl = ((xi_xzl - pt.zl * dxl) / xl_s) * lf
    dzu = ((xi_xzu - pt.zu * dxu) / xu_s) * uf

    # V. Recover Δκ (step.jl:252).
    dkappa = (xi_tk - pt.kappa * dtau) / pt.tau

    return Point(x=dx, xl=dxl, xu=dxu, y=dy, zl=dzl, zu=dzu,
                 tau=dtau, kappa=dkappa, mu=torch.zeros_like(dtau))


def max_step_length(dat: LPData, pt: Point, delta: Point) -> torch.Tensor:
    """Per lane, max a >= 0 with pt + a*delta >= 0 on all nonnegative
    coordinates, as masked min-reductions over the last axis
    (reference: src/IPM/HSD/step.jl:274-306). A lane with no blocking
    coordinate gets inf from the reductions, then the cap at 1."""
    def ratio(x, dx, mask):
        neg = (dx < 0) & (mask > 0)
        r = torch.where(neg, -x / torch.where(neg, dx, -1.0), float("inf"))
        return r.amin(dim=-1)

    def scalar_ratio(v, dv):
        neg = dv < 0
        return torch.where(neg, -v / torch.where(neg, dv, -1.0), 1.0)

    axl = ratio(pt.xl, delta.xl, dat.lflag)
    axu = ratio(pt.xu, delta.xu, dat.uflag)
    azl = ratio(pt.zl, delta.zl, dat.lflag)
    azu = ratio(pt.zu, delta.zu, dat.uflag)
    at = scalar_ratio(pt.tau, delta.tau)
    ak = scalar_ratio(pt.kappa, delta.kappa)
    return torch.clamp_max(torch.minimum(
        torch.minimum(torch.minimum(axl, axu), torch.minimum(azl, azu)),
        torch.minimum(at, ak)), 1.0)


def _point_axpy(alpha: torch.Tensor, delta: Point, pt: Point) -> Point:
    """pt + alpha*delta per lane on every field but mu (kept from pt)."""
    a = _col(alpha)
    return Point(x=pt.x + a * delta.x, xl=pt.xl + a * delta.xl,
                 xu=pt.xu + a * delta.xu, y=pt.y + a * delta.y,
                 zl=pt.zl + a * delta.zl, zu=pt.zu + a * delta.zu,
                 tau=pt.tau + alpha * delta.tau,
                 kappa=pt.kappa + alpha * delta.kappa, mu=pt.mu)


def _higher_corrector(dat: LPData, opts: HSDOptions, pt: Point, kkt_solve,
                      aux: NewtonAux, gamma, delta: Point, alpha,
                      ) -> Tuple[Point, torch.Tensor]:
    """Gondzio-style centrality correction: clip outlier complementarity
    products at a trial point back toward [βγμ, γμ/β] and take one more
    Newton solve (reference: src/IPM/HSD/step.jl:325-401)."""
    lf, uf = dat.lflag, dat.uflag
    beta = opts.CentralityOutlierThreshold

    a_ = torch.clamp_max(2.0 * alpha, 1.0)
    ac = _col(a_)

    vl = ((pt.xl + ac * delta.xl) * (pt.zl + ac * delta.zl)) * lf
    vu = ((pt.xu + ac * delta.xu) * (pt.zu + ac * delta.zu)) * uf
    vt = (pt.tau + a_ * delta.tau) * (pt.kappa + a_ * delta.kappa)

    mu_l = beta * pt.mu * gamma
    mu_u = gamma * pt.mu / beta

    def clip(v, lo, hi):
        return torch.where(v < lo, lo - v,
                           torch.where(v > hi, hi - v, torch.zeros_like(v)))

    vl = clip(vl, _col(mu_l), _col(mu_u)) * lf
    vu = clip(vu, _col(mu_l), _col(mu_u)) * uf
    vt = clip(vt, mu_l, mu_u)

    # Project target to v'e = 0 (step.jl:373-377).
    p = num_finite_bounds(dat)
    dshift = (vl.sum(-1) + vu.sum(-1) + vt) / (p + 1.0)
    vl = (vl - _col(dshift)) * lf
    vu = (vu - _col(dshift)) * uf
    vt = vt - dshift

    zero_m = torch.zeros_like(pt.y)
    zero_n = torch.zeros_like(pt.x)
    zero = torch.zeros_like(pt.tau)
    dc = solve_newton_system(dat, pt, kkt_solve, aux,
                             zero_m, zero_n, zero_n, zero_n, zero,
                             vl, vu, vt)
    dc = Point(x=dc.x + delta.x, xl=dc.xl + delta.xl, xu=dc.xu + delta.xu,
               y=dc.y + delta.y, zl=dc.zl + delta.zl, zu=dc.zu + delta.zu,
               tau=dc.tau + delta.tau, kappa=dc.kappa + delta.kappa,
               mu=dc.mu)
    alpha_c = max_step_length(dat, pt, dc)
    return dc, alpha_c


# ---------------------------------------------------------------------------
# One HSD step
# ---------------------------------------------------------------------------

def factor_with_bumps(backend, kkt, theta_inv, regP, regD, regG=None):
    """Factorization with up to 3 ×100 regularization bumps on failure
    (step.jl:34-51; MPC: MPC/step.jl:34-51). Only lanes that failed retry,
    each keeping its own regularization, as under the reference's vmapped
    while_loop (``bump_cond``/``bump_body``, ``tulip_tpu/ipm/hsd.py:
    325-339``). ``regG`` (HSD only) is bumped with them. The host-driven
    loop tests for a failed lane before each bump; the device program
    makes all 3, masked (:func:`.graph.bounded_while`). Returns (kkt, regP,
    regD, regG, per-lane ok)."""
    kkt, ok = backend.update(kkt, theta_inv, regP, regD)

    def bump(c, retry):
        kkt, rp, rd, rg, ok = c
        rp_b = rp * 100.0
        rd_b = rd * 100.0
        kkt_b, ok_b = backend.update(kkt, theta_inv, rp_b, rd_b)
        return (tree_where(retry, kkt_b, kkt), tree_where(retry, rp_b, rp),
                tree_where(retry, rd_b, rd),
                None if rg is None else torch.where(retry, rg * 100.0, rg),
                torch.where(retry, ok_b, ok))

    return bounded_while(lambda c: ~c[4], bump, (kkt, regP, regD, regG, ok),
                         3)


def compute_step(backend, opts: HSDOptions, dat: LPData, state: HSDState,
                 ) -> HSDState:
    """One full HSD step for every lane (reference: src/IPM/HSD/step.jl:10-151).
    The caller masks the result to the lanes that should move."""
    pt, res = state.pt, state.res
    lf, uf = dat.lflag, dat.uflag

    xl_s = torch.where(lf > 0, pt.xl, 1.0)
    xu_s = torch.where(uf > 0, pt.xu, 1.0)
    theta_l = (pt.zl / xl_s) * lf
    theta_u = (pt.zu / xu_s) * uf
    theta_inv = theta_l + theta_u

    # Regularization decay (step.jl:29-31).
    regP = torch.clamp_min(state.regP / 10.0, opts.PRegMin)
    regD = torch.clamp_min(state.regD / 10.0, opts.DRegMin)
    regG = torch.clamp_min(state.regG / 10.0, opts.PRegMin)

    kkt, regP, regD, regG, fact_ok = factor_with_bumps(
        backend, state.kkt, theta_inv, regP, regD, regG)

    kkt_solve = partial(backend.solve, kkt)
    kkt_solve_pred = (partial(backend.solve_unrefined, kkt)
                      if opts.FastPredictor else kkt_solve)
    kkt_solve_corr = (partial(backend.solve_unrefined, kkt)
                      if opts.FastCorrections else kkt_solve)

    ll = dat.l * lf
    uu = dat.u * uf

    # Preliminary solve enabling Δτ recovery (step.jl:58-76).
    xi_ = dat.c - theta_l * ll - theta_u * uu
    hx, hy = kkt_solve(dat.b, xi_)
    cpx = dat.c + theta_l * ll + theta_u * uu
    h0 = (dot(ll, ll * theta_l) + dot(uu, uu * theta_u)
          - dot(cpx, hx) + dot(dat.b, hy)
          + pt.kappa / pt.tau + regG)
    aux = NewtonAux(hx=hx, hy=hy, h0=h0, cpx=cpx)

    # Affine-scaling predictor (step.jl:79-85).
    delta = solve_newton_system(
        dat, pt, kkt_solve_pred, aux,
        res.rp, res.rl, res.ru, res.rd, res.rg,
        -(pt.xl * pt.zl) * lf,
        -(pt.xu * pt.zu) * uf,
        -pt.tau * pt.kappa)

    alpha = max_step_length(dat, pt, delta)
    gamma = (1.0 - alpha) ** 2 * torch.clamp_max(1.0 - alpha, opts.GammaMin)
    eta = 1.0 - gamma
    gmu = _col(gamma * pt.mu)

    # Mehrotra corrector (step.jl:93-99).
    delta = solve_newton_system(
        dat, pt, kkt_solve, aux,
        _col(eta) * res.rp, _col(eta) * res.rl, _col(eta) * res.ru,
        _col(eta) * res.rd, eta * res.rg,
        (-pt.xl * pt.zl + gmu - delta.xl * delta.zl) * lf,
        (-pt.xu * pt.zu + gmu - delta.xu * delta.zu) * uf,
        -pt.tau * pt.kappa + gamma * pt.mu - delta.tau * delta.kappa)
    alpha = max_step_length(dat, pt, delta)

    # Extra centrality corrections (step.jl:103-136), per lane: a lane
    # stops at CorrectionLimit, at a near-full step, or once a correction
    # failed to grow its step enough (``corr_cond``/``corr_body``,
    # ``tulip_tpu/ipm/hsd.py:385-400``). The loop ends within
    # CorrectionLimit trips: a lane still active at a trip was active at
    # every earlier one, and each counted it.
    def correct(c, active):
        delta, alpha, ncor, done = c
        dc, ac = _higher_corrector(dat, opts, pt, kkt_solve_corr, aux, gamma,
                                   delta, alpha)
        use = active & (ac > alpha)
        return (tree_where(use, dc, delta), torch.where(use, ac, alpha),
                ncor + active.to(ncor.dtype),
                torch.where(active, ac < 1.1 * alpha, done))

    delta, alpha, _, _ = bounded_while(
        lambda c: (c[2] < opts.CorrectionLimit) & (c[1] < 0.999) & ~c[3],
        correct, (delta, alpha, torch.zeros_like(state.niter),
                  torch.zeros_like(alpha, dtype=torch.bool)),
        opts.CorrectionLimit)

    # Damped update (step.jl:139-148).
    alpha = alpha * opts.StepDampFactor
    pt_new = update_mu(_point_axpy(alpha, delta, pt), dat, hflag=True)

    # Factorization failure after all bumps → numerical-problem status
    # (HSD.jl:319-326): keep the old point, flag the lane.
    pt_out = tree_where(fact_ok, pt_new, pt)
    status = torch.where(fact_ok, state.status,
                         torch.full_like(state.status, _NUMERICAL_PROBLEM))
    niter = torch.where(fact_ok, state.niter + 1, state.niter)

    return state._replace(pt=pt_out, regP=regP, regD=regD, regG=regG,
                          kkt=kkt, niter=niter, status=status)


# ---------------------------------------------------------------------------
# Convergence / certificate tests
# ---------------------------------------------------------------------------

def first_match(like: torch.Tensor, *pairs, default) -> torch.Tensor:
    """Per lane, the code of the first (mask, code) pair whose mask holds,
    else ``default``, as nested ``jnp.where`` gives it."""
    out = torch.full_like(like, default)
    for mask, code in reversed(pairs):
        out = out.masked_fill(mask, code)
    return out


def update_status(dat: LPData, opts: HSDOptions, norms: DataNorms,
                  state: HSDState) -> HSDState:
    """Optimality test + unboundedness and Farkas-infeasibility certificate
    tests, per lane (reference: src/IPM/HSD/HSD.jl:136-196)."""
    pt, res = state.pt, state.res

    pobj = primal_objective(dat, pt)
    dobj = dual_objective(dat, pt)

    rho_p = torch.maximum(
        res.rp_nrm / (pt.tau * (1.0 + norms.b)),
        torch.maximum(res.rl_nrm / (pt.tau * (1.0 + norms.l)),
                      res.ru_nrm / (pt.tau * (1.0 + norms.u))))
    rho_d = res.rd_nrm / (pt.tau * (1.0 + norms.c))
    rho_g = (pobj - dobj).abs() / (1.0 + dobj.abs())

    p_feas = rho_p <= opts.TolerancePFeas
    d_feas = rho_d <= opts.ToleranceDFeas
    optimal = p_feas & d_feas & (rho_g <= opts.ToleranceRGap)

    # Unbounded-ray (dual infeasibility) certificate (HSD.jl:172-181).
    ray_nrm = torch.maximum(
        inf_norm(matvec(dat, pt.x)),
        torch.maximum(inf_norm((pt.x - pt.xl) * dat.lflag),
                      inf_norm((pt.x + pt.xu) * dat.uflag)))
    dual_infeas = (ray_nrm * (norms.c / torch.clamp_min(norms.b, 1.0))
                   < -opts.ToleranceIFeas * dot(dat.c, pt.x))

    # Farkas (primal infeasibility) certificate (HSD.jl:183-193).
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


# ---------------------------------------------------------------------------
# Iteration + solve loop
# ---------------------------------------------------------------------------

def init_state(dat: LPData, backend, mehrotra: bool = False) -> HSDState:
    """Cold-start state for every lane (reference: HSD.jl:34-65, 238-249).

    ``mehrotra=True`` replaces the all-ones start with the Mehrotra
    least-squares point embedded at τ = κ = 1 (one extra factorization and
    two extra solves, once per solve; ``tulip_tpu/ipm/hsd.py:498-527``).
    """
    kkt = backend.setup_data(dat)
    if mehrotra:
        from .mpc import mpc_starting_point
        pt, kkt = mpc_starting_point(dat, backend, kkt)
        pt = update_mu(pt._replace(kappa=torch.ones_like(pt.kappa)), dat,
                       hflag=True)
    else:
        pt = starting_point(dat, hflag=True)
    return fresh_state(dat, pt, compute_residuals(dat, pt), kkt,
                       regG=torch.ones_like(dat.c0))


def fresh_state(dat: LPData, pt: Point, res, kkt, regG) -> HSDState:
    """State before the first iteration: unit regP and regD, iteration 0,
    statuses UNKNOWN, objectives ±inf."""
    B = dat.c.shape[0]
    dev = dat.c.device

    def codes(v):
        return torch.full((B,), v, dtype=torch.int32, device=dev)

    return HSDState(
        pt=pt, res=res,
        regP=torch.ones_like(dat.c),
        regD=torch.ones_like(dat.b),
        regG=regG,
        kkt=kkt,
        niter=codes(0),
        status=codes(_UNKNOWN),
        primal_status=codes(_SLN_UNKNOWN),
        dual_status=codes(_SLN_UNKNOWN),
        pobj=torch.full_like(dat.c0, float("inf")),
        dobj=torch.full_like(dat.c0, float("-inf")),
    )


def hsd_iteration(backend, opts: HSDOptions, dat: LPData, state: HSDState,
                  ) -> HSDState:
    """Residuals → status checks → one step on the lanes still UNKNOWN.

    Iteration 0 is the starting point: residuals and convergence are
    evaluated before any factorization (reference: HSD.jl:251-343). Every
    lane computes the step, as under vmap; lanes with a terminal status
    keep their state (``lax.cond`` under vmap is a select).
    """
    norms = _data_norms(dat)
    res = compute_residuals(dat, state.pt)
    pt = update_mu(state.pt, dat, hflag=True)
    state = state._replace(pt=pt, res=res)
    state = update_status(dat, opts, norms, state)
    state = state._replace(status=torch.where(
        (state.status == _UNKNOWN) & (state.niter >= opts.IterationsLimit),
        torch.full_like(state.status, _ITERATION_LIMIT), state.status))
    moving = state.status == _UNKNOWN
    return tree_where(moving, compute_step(backend, opts, dat, state), state)


def solve(backend, opts, dat: LPData, init=None, iteration=None,
          algo: str = "HSD", log_fn=None) -> HSDState:
    """Start every lane with ``init(dat, backend)`` and run ``iteration``
    until no lane is UNKNOWN. A lane that has terminated keeps its state,
    as a lane of ``lax.while_loop`` under vmap does. Terminates: every lane
    reaches a status by IterationsLimit.

    Routing as the reference's ``hsd_solve`` / ``mpc_solve``
    (``tulip_tpu/ipm/hsd.py:587-595``, ``mpc.py:451-458``): with
    ``OutputLevel == 0``, no ``log_fn``, an infinite ``TimeLimit`` and
    ``HostLoop`` off, a backend that declares ``device_loop`` solves
    through the device program (:func:`device_solve`); otherwise the
    host-driven loop runs, which for one LP prints the iteration log and
    checks the wall-clock limit between passes (``tulip_tpu/ipm/hsd.py:
    597-649``, HSD.jl:203-350). ``init`` runs eagerly either way, as in
    the reference.

    The defaults are the HSD method's (:func:`init_state`, honouring
    ``opts.MehrotraStart``, and :func:`hsd_iteration`); the MPC method and
    the warm restart pass their own, and ``algo`` names the method in the
    log. ``log_fn``, for one LP, is called with the state after every pass
    (``tulip_tpu/ipm/hsd.py:633-634``)."""
    if init is None:
        init = partial(init_state, mehrotra=opts.MehrotraStart)
    if iteration is None:
        iteration = hsd_iteration
    host_driven = (opts.OutputLevel > 0 or opts.TimeLimit != float("inf")
                   or log_fn is not None)
    if host_driven and dat.b.shape[0] != 1:
        raise ValueError("OutputLevel > 0, a finite TimeLimit and log_fn "
                         "apply to one LP, not to a batch")
    if not (host_driven or opts.HostLoop) and backend.device_loop:
        with full_matmul_precision():
            state = init(dat, backend)
        return device_solve(backend, opts, dat, state, iteration)
    with full_matmul_precision():
        state = init(dat, backend)
        tstart = time.time()
        if opts.OutputLevel > 0:
            _log_header(backend, dat, algo)
        while True:
            live = state.status == _UNKNOWN
            if not bool(live.any()):
                break
            # Each pass evaluates residuals and objectives at the current
            # point, then steps if the lane is not terminal: the logged row
            # belongs to the entry iteration count (row k = point k).
            n_entry = int(state.niter) if opts.OutputLevel > 0 else 0
            state = tree_where(live, iteration(backend, opts, dat, state),
                               state)
            if host_driven:
                ttot = time.time() - tstart
                if opts.OutputLevel > 0:
                    _log_row(n_entry, state, ttot, algo)
                if log_fn is not None:
                    log_fn(state)
                if ttot >= opts.TimeLimit and int(state.status) == _UNKNOWN:
                    state = state._replace(status=torch.full_like(
                        state.status, int(TerminationStatus.TIME_LIMIT)))
    if opts.OutputLevel > 0:
        print(f"Solver exited with status "
              f"{TerminationStatus(int(state.status)).name}")
    return state


def device_solve(backend, opts, dat, state: HSDState,
                 iteration=None) -> HSDState:
    """Run ``iteration`` from ``state`` until no lane is UNKNOWN, as the
    device program (:mod:`.graph`): one pass, the iteration masked to the
    lanes still UNKNOWN, captured once per key (the iteration, backend,
    options, device and the shapes of ``dat`` and ``state``, as ``jax.jit``
    keys its static arguments) and replayed, with one host read of whether
    any lane is UNKNOWN every :data:`.graph.K_PASSES` passes. A second
    solve of the same key copies its inputs into the cached program's
    static buffers and replays it. A capture that fails raises: nothing
    falls back to the host-driven loop."""
    if iteration is None:
        iteration = hsd_iteration
    key = (iteration, backend, opts, dat.b.device,
           graph.signature(dat, state))

    def step(d, s):
        return tree_where(s.status == _UNKNOWN,
                          iteration(backend, opts, d, s), s)

    with full_matmul_precision():
        return graph.run(key, dat, state, step,
                         lambda s: (s.status == _UNKNOWN).any())


def hsd_solve_device(backend, opts: HSDOptions, dat: LPData,
                     state: Optional[HSDState] = None) -> HSDState:
    """The whole HSD solve as the device program (reference:
    ``tulip_tpu/ipm/hsd.py:564-577``, one ``lax.while_loop``), from
    ``state`` or, when None, from :func:`init_state` run eagerly, for any
    backend, as the reference's."""
    if state is None:
        with full_matmul_precision():
            state = init_state(dat, backend, mehrotra=opts.MehrotraStart)
    return device_solve(backend, opts, dat, state, hsd_iteration)


def _log_header(backend, dat: LPData, algo: str) -> None:
    """The iteration log's header (reference: ``tulip_tpu/ipm/hsd.py:599-610``
    and ``tulip_tpu/ipm/mpc.py:463-472``; HSD.jl:203-230). MPC has no gap
    column."""
    print(f"\nOptimizer info ({algo})")
    print(f"Constraints  : {dat.nrow}")
    print(f"Variables    : {dat.ncol}")
    print("Linear solver:")
    print(f"  Arithmetic : {backend.arithmetic_label(dat.c.dtype)}")
    print(f"  Backend    : {backend.name}")
    print(f"  System     : {backend.linear_system()}")
    gap = f" {'GFeas':>8}" if algo == "HSD" else ""
    print(f"\n{'Itn':>4}  {'PObj':>14}  {'DObj':>14}  "
          f"{'PFeas':>8} {'DFeas':>8}{gap}  {'Mu':>7}  Time")


def _log_row(k: int, s: HSDState, ttot: float, algo: str) -> None:
    """One row: HSD's primal column is max(rp, ru) and it adds the gap
    residual; MPC's is rp (``tulip_tpu/ipm/mpc.py:481-485``)."""
    if algo == "HSD":
        pfeas = float(torch.maximum(s.res.rp_nrm, s.res.ru_nrm))
        gap = f" {float(s.res.rg_nrm):8.2e}"
    else:
        pfeas = float(s.res.rp_nrm)
        gap = ""
    print(f"{k:4d}  {float(s.pobj):+14.7e}  "
          f"{float(s.dobj):+14.7e}  "
          f"{pfeas:8.2e} "
          f"{float(s.res.rd_nrm):8.2e}{gap}  "
          f"{float(s.pt.mu):7.1e}  {ttot:.2f}")


@trace.call("hsd_solve")
def hsd_solve(dat: LPData, backend, opts: HSDOptions,
              log_fn=None) -> HSDState:
    """Solve one LP: ``dat`` is a batch of one (see ``make_lp_data``).
    ``log_fn(state)`` is called after every iteration. A direct call opens
    the call record ``"hsd_solve"`` (:mod:`tulip_tpu_torch.trace`: the
    device program's passes and host reads, the collectives of the data's
    group); inside ``Model.optimize`` they add to its record."""
    if dat.b.shape[0] != 1:
        raise ValueError(f"hsd_solve takes one LP, got a batch of "
                         f"{dat.b.shape[0]}; use batched_hsd_solve")
    return solve(backend, opts, dat, log_fn=log_fn)
