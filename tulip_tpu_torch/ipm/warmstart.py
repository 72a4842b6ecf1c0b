"""Warm-started re-solves.

Counterpart of ``tulip_tpu/ipm/warmstart.py``, batch-first. The reference
has no warm start (reference: src/Interfaces/MOI/constraints.jl:14-16); the
JAX package adds the standard homogeneous-IPM scheme, which this module
ports: blend the previous iterate with the cold-start point and re-center
the homogeneous variables,

    pt = λ·prev + (1-λ)·cold,   τ = 1,   κ = μ(pt),

which keeps the point interior while keeping most of the previous
solution. With λ = 0 it is exactly the cold start.
"""

from __future__ import annotations

import torch

from .data import LPData
from .hsd import HSDState, _col, init_state
from .point import Point, dot, num_finite_bounds, starting_point, update_mu


def blend_point(dat: LPData, prev: Point, lam: float = 0.99) -> Point:
    """λ·prev + (1-λ)·cold per lane, with re-centered (τ, κ). λ is rounded
    to the working dtype before 1 - λ is taken, as in the reference."""
    cold = starting_point(dat, hflag=True)
    lam = torch.as_tensor(lam, dtype=prev.x.dtype, device=prev.x.device)

    def mix(a, b):
        return lam * a + (1.0 - lam) * b

    one = torch.ones_like(prev.tau)
    pt = Point(
        x=mix(prev.x, cold.x),
        xl=mix(prev.xl, cold.xl),
        xu=mix(prev.xu, cold.xu),
        y=mix(prev.y, cold.y),
        zl=mix(prev.zl, cold.zl),
        zu=mix(prev.zu, cold.zu),
        tau=one,
        kappa=one,
        mu=prev.mu,
    )
    # κ = μ so that the homogeneous product starts on-center.
    p = num_finite_bounds(dat)
    mu = (dot(pt.xl, pt.zl) + dot(pt.xu, pt.zu)) / p
    pt = pt._replace(kappa=torch.clamp_min(mu, 1e-8))
    return update_mu(pt, dat, hflag=True)


def warm_state(dat: LPData, backend, prev: HSDState,
               lam: float = 0.99) -> HSDState:
    """Initial HSD state for re-solving ``dat`` from the final state
    ``prev`` of a related solve of the same shapes. The previous point is
    divided by its τ before blending, so the warm point lives at the τ = 1
    scale of the embedding."""
    state = init_state(dat, backend)
    tau_inv = 1.0 / prev.pt.tau
    t = _col(tau_inv)
    prev_pt = Point(
        x=prev.pt.x * t, xl=prev.pt.xl * t, xu=prev.pt.xu * t,
        y=prev.pt.y * t, zl=prev.pt.zl * t, zu=prev.pt.zu * t,
        tau=torch.ones_like(prev.pt.tau),
        kappa=prev.pt.kappa, mu=prev.pt.mu)
    return state._replace(pt=blend_point(dat, prev_pt, lam))
