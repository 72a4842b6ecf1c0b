"""Primal-dual iterate and residuals as NamedTuples of batch-first tensors.

Counterpart of ``tulip_tpu/ipm/point.py`` (reference: src/IPM/point.jl:6-48,
src/IPM/residuals.jl:6-22). Vectors are (B, n) or (B, m); the reference's
scalars are (B,) tensors, and every reduction runs over the last axis only.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .data import LPData, matvec, rmatvec


class Point(NamedTuple):
    """Primal-dual point.

    ``xl``/``xu`` are bound slacks (``x - xl = l``, ``x + xu = u``), zero on
    masked bounds; ``zl``/``zu`` the corresponding duals; ``tau``/``kappa``
    the homogeneous embedding variables; ``mu`` the barrier parameter
    (reference: src/IPM/point.jl:6-48).
    """

    x: torch.Tensor      # (B, n)
    xl: torch.Tensor     # (B, n)
    xu: torch.Tensor     # (B, n)
    y: torch.Tensor      # (B, m)
    zl: torch.Tensor     # (B, n)
    zu: torch.Tensor     # (B, n)
    tau: torch.Tensor    # (B,)
    kappa: torch.Tensor  # (B,)
    mu: torch.Tensor     # (B,)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-lane inner product over the last axis."""
    return (a * b).sum(-1)


def starting_point(dat: LPData, hflag: bool = True) -> Point:
    """Cold start: x = 0, unit bound slacks/duals on flagged bounds,
    tau = kappa = 1 (reference: src/IPM/HSD/HSD.jl:238-249)."""
    one = torch.ones_like(dat.c0)
    pt = Point(
        x=torch.zeros_like(dat.c),
        xl=dat.lflag.clone(),
        xu=dat.uflag.clone(),
        y=torch.zeros_like(dat.b),
        zl=dat.lflag.clone(),
        zu=dat.uflag.clone(),
        tau=one,
        kappa=one if hflag else torch.zeros_like(one),
        mu=one,
    )
    return update_mu(pt, dat, hflag=hflag)


def num_finite_bounds(dat: LPData) -> torch.Tensor:
    return dat.lflag.sum(-1) + dat.uflag.sum(-1)


def update_mu(pt: Point, dat: LPData, hflag: bool = True) -> Point:
    """mu = (xl'zl + xu'zu + hflag*tau*kappa) / (p + hflag)
    (reference: src/IPM/point.jl:45-48)."""
    p = num_finite_bounds(dat)
    h = 1.0 if hflag else 0.0
    # p + h = 0 (MPC on an all-free-variable LP): the numerator is exactly 0
    # too, so mu := 0, not 0/0 = NaN.
    mu = ((dot(pt.xl, pt.zl) + dot(pt.xu, pt.zu) + h * pt.tau * pt.kappa)
          / torch.clamp_min(p + h, 1.0))
    return pt._replace(mu=mu)


class Residuals(NamedTuple):
    """Primal/dual/bound/gap residuals and their inf-norms
    (reference: src/IPM/residuals.jl:6-22)."""

    rp: torch.Tensor   # (B, m)  tau*b - A x
    rl: torch.Tensor   # (B, n)  tau*l - (x - xl), masked
    ru: torch.Tensor   # (B, n)  tau*u - (x + xu), masked
    rd: torch.Tensor   # (B, n)  tau*c - A'y - zl + zu
    rg: torch.Tensor   # (B,)    c'x - b'y - l'zl + u'zu + kappa
    rp_nrm: torch.Tensor
    rl_nrm: torch.Tensor
    ru_nrm: torch.Tensor
    rd_nrm: torch.Tensor
    rg_nrm: torch.Tensor


def inf_norm(v: torch.Tensor) -> torch.Tensor:
    """Per-lane max-abs over the last axis: (B, k) -> (B,)."""
    return v.abs().amax(-1)


def compute_residuals(dat: LPData, pt: Point) -> Residuals:
    """Residuals at ``pt`` (reference: src/IPM/HSD/HSD.jl:77-128)."""
    tau = pt.tau.unsqueeze(-1)
    rp = tau * dat.b - matvec(dat, pt.x)
    rl = (-pt.x + pt.xl + tau * dat.l) * dat.lflag
    ru = (-pt.x - pt.xu + tau * dat.u) * dat.uflag
    rd = (tau * dat.c - rmatvec(dat, pt.y)
          - pt.zl * dat.lflag + pt.zu * dat.uflag)
    rg = pt.kappa + (dot(dat.c, pt.x)
                     - (dot(dat.b, pt.y)
                        + dot(dat.l * dat.lflag, pt.zl)
                        - dot(dat.u * dat.uflag, pt.zu)))
    return Residuals(
        rp=rp, rl=rl, ru=ru, rd=rd, rg=rg,
        rp_nrm=inf_norm(rp), rl_nrm=inf_norm(rl), ru_nrm=inf_norm(ru),
        rd_nrm=inf_norm(rd), rg_nrm=rg.abs(),
    )


def primal_objective(dat: LPData, pt: Point) -> torch.Tensor:
    """(c'x)/tau + c0 (reference: HSD.jl:120)."""
    return dot(dat.c, pt.x) / pt.tau + dat.c0


def dual_objective(dat: LPData, pt: Point) -> torch.Tensor:
    """(b'y + l'zl - u'zu)/tau + c0 (reference: HSD.jl:121-125)."""
    return (dot(dat.b, pt.y)
            + dot(dat.l * dat.lflag, pt.zl)
            - dot(dat.u * dat.uflag, pt.zu)) / pt.tau + dat.c0
