"""Dense K1 (normal equations) backend.

Counterpart of ``tulip_tpu/kkt/dense.py``. Solves the augmented system by
pivoting on its (1,1) block: with ``D = (Θ⁻¹ + Rp)⁻¹`` the Schur complement
is the SPD normal-equations matrix ``K = A D Aᵀ + Rd``, factorized by dense
Cholesky (reference semantics: src/KKT/Dense/lapack.jl:65-119; K1 system
src/KKT/systems.jl:34-54).

- ``K = (A √D)(A √D)ᵀ`` is one batched GEMM.
- The factorization is ``torch.linalg.cholesky_ex``, whose ``info`` turns
  into the per-lane ``ok`` flag the IPM's regularization ladder branches on.
- The JAX package switches to a recursive blocked Cholesky+inverse
  (``ops/blocked.py``) at m ≥ 4096. That recursion works around XLA's
  Cholesky on the TPU and is not ported: ``torch.linalg`` computes the
  same L and L⁻¹ here.
- ``explicit_minv`` and ``matmul_precision`` are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from .base import KKTBackend, bmtv, bmv


class DenseK1State(NamedTuple):
    A: torch.Tensor          # (B, m, n) constraint matrix (constant)
    d: torch.Tensor          # (B, n)  D = (Θ⁻¹ + Rp)⁻¹ diagonal
    theta_reg: torch.Tensor  # (B, n)  Θ⁻¹ + Rp (for refinement residuals)
    regD: torch.Tensor       # (B, m)
    L: torch.Tensor          # (B, m, m) Cholesky factor of K, or L⁻¹


def normal_matrix(A: torch.Tensor, d: torch.Tensor,
                  regD: torch.Tensor) -> torch.Tensor:
    """K = (A √d)(A √d)ᵀ + diag(regD), per lane."""
    Bm = A * torch.sqrt(d).unsqueeze(-2)
    return Bm @ Bm.transpose(-1, -2) + torch.diag_embed(regD)


def identity_where_failed(L: torch.Tensor) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """(L with failed lanes replaced by I, per-lane ok flag).

    ``ok`` reduces over the (m, m) axes of each lane only, as the
    reference's ``jnp.all(jnp.isfinite(L))`` does under vmap: one bad lane
    must not stall the others. The swap keeps downstream solves finite
    while the regularization ladder retries that lane.
    """
    ok = torch.isfinite(L).all(dim=-1).all(dim=-1)
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return torch.where(ok[:, None, None], L, eye), ok


@dataclasses.dataclass(frozen=True)
class DenseK1Backend(KKTBackend):
    """K1 backend.

    ``inv_factor=True`` additionally inverts the Cholesky factor at update
    time (one batched triangular solve with m right-hand sides), so every
    backsolve becomes two GEMVs instead of two triangular solves. Slightly
    less accurate than backsolves: pair with ``refinement_steps>=1`` in f32.
    """

    name = "dense"
    systems = ("K1",)
    inv_factor: bool = False

    def linear_system(self) -> str:
        return "Normal equations (K1)"

    def setup(self, A: torch.Tensor) -> DenseK1State:
        B, m, n = A.shape
        kw = dict(dtype=A.dtype, device=A.device)
        return DenseK1State(
            A=A,
            d=torch.ones(B, n, **kw),
            theta_reg=torch.ones(B, n, **kw),
            regD=torch.ones(B, m, **kw),
            L=torch.eye(m, **kw).expand(B, m, m).clone(),
        )

    def update(self, state: DenseK1State, theta_inv, regP, regD,
               ) -> Tuple[DenseK1State, torch.Tensor]:
        A = state.A
        theta_reg = theta_inv + regP
        d = 1.0 / theta_reg
        K = normal_matrix(A, d, regD)
        L, info = torch.linalg.cholesky_ex(K)
        L = L.masked_fill((info > 0)[:, None, None], float("nan"))
        L, ok = identity_where_failed(L)
        if self.inv_factor:
            # Store L⁻¹ instead of L: one triangular solve with m RHS now,
            # GEMV-only solves afterwards.
            eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
            L = torch.linalg.solve_triangular(L, eye.expand_as(L),
                                              upper=False)
        return (DenseK1State(A=A, d=d, theta_reg=theta_reg, regD=regD, L=L),
                ok)

    def _base_solve(self, state: DenseK1State, xi_p, xi_d):
        A, d, L = state.A, state.d, state.L
        rhs = xi_p + bmv(A, d * xi_d)
        if self.inv_factor:
            dy = bmtv(L, bmv(L, rhs))
        else:
            w = torch.linalg.solve_triangular(L, rhs.unsqueeze(-1),
                                              upper=False)
            dy = torch.linalg.solve_triangular(
                L.transpose(-1, -2), w, upper=True).squeeze(-1)
        dx = d * (bmtv(A, dy) - xi_d)
        return dx, dy

    def solve(self, state: DenseK1State, xi_p, xi_d):
        dx, dy = self._base_solve(state, xi_p, xi_d)
        return self._refine(state, xi_p, xi_d, dx, dy, self._base_solve)
