"""Dense K2 (augmented system) backend (``"dense-ldl"``) via LDLᵀ without
pivoting.

Counterpart of ``tulip_tpu/kkt/dense_ldl.py``: the quasi-definite matrix
(reference semantics: src/KKT/Cholmod/sqd.jl:42-53, src/KKT/systems.jl:8-32)::

    K2 = [-(Θ⁻¹ + Rp)   Aᵀ]
         [   A          Rd]

has an LDLᵀ factorization without pivoting for any symmetric ordering
(Vanderbei 1995). The reference factors it by a ``lax.fori_loop`` over all
m + n columns. Here:

- :func:`ldl_nopivot` factors any quasi-definite K blocked: panels of
  ``block`` columns, a short column loop inside the panel, and one GEMM
  for the update of the trailing matrix. It computes the reference's L, d
  and ``ok``, with the sums taken in another order.
- :class:`DenseK2Backend` uses the x-first ordering: K2's (1,1) block is
  diagonal, so its n pivots are exact, d_j = -(Θ⁻¹ + Rp)_j and
  L[n:, j] = A[:, j] / d_j with no update, bit for bit the reference's.
  Only the m×m Schur block Rd - Σ_j L[n:, j] d_j L[n:, j]ᵀ
  = Rd + A (Θ⁻¹ + Rp)⁻¹ Aᵀ goes through :func:`ldl_nopivot`.

``torch.linalg.ldl_factor`` pivots (Bunch-Kaufman) and is not this
function. Tensors are batch-first: ``update`` factors every lane and
returns a per-lane ``ok``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from .base import KKTBackend


def _eye_like(K: torch.Tensor) -> torch.Tensor:
    return torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)


def ldl_nopivot(K: torch.Tensor, block: int = 64,
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Unpivoted LDLᵀ of K (..., N, N): K = L diag(d) Lᵀ with unit lower L.

    Returns (L, d, ok); ``ok`` (one flag per matrix) is False where a zero
    or non-finite pivot appears, not on a negative one. A zero pivot
    divides its column by 1 and the factorization goes on, as in the
    reference. Only the lower triangle of K is read.
    """
    N = K.shape[-1]
    W = K.clone()
    d = K.new_empty(K.shape[:-1])
    for k in range(0, N, block):
        e = min(k + block, N)
        P = W[..., k:, k:e]          # the panel: rows k:N, columns k:e
        piv = P.diagonal(dim1=-2, dim2=-1)   # its pivots, as they are made
        for j in range(e - k):
            if j:
                # Columns < j of the panel hold L; their pivots sit on its
                # diagonal.
                w = P[..., j, :j] * piv[..., :j]
                P[..., j:, j].sub_(
                    (P[..., j:, :j] @ w.unsqueeze(-1)).squeeze(-1))
            dj = P[..., j, j]
            # dj, or 1 where it is 0 (two launches, no scalar tensor).
            P[..., j + 1:, j].div_((dj + (dj == 0)).unsqueeze(-1))
        dp = piv.clone()
        d[..., k:e] = dp
        if e < N:
            L21 = P[..., e - k:, :]                    # (..., N-e, nb)
            W[..., e:, e:].sub_((L21 * dp.unsqueeze(-2))
                                @ L21.transpose(-1, -2))
    L = W.tril(-1) + _eye_like(K)
    ok = (torch.isfinite(L).flatten(-2).all(-1) & torch.isfinite(d).all(-1)
          & (d != 0).all(-1))
    return L, d, ok


class DenseK2State(NamedTuple):
    A: torch.Tensor          # (B, m, n)
    theta_reg: torch.Tensor  # (B, n)  Θ⁻¹ + Rp
    regD: torch.Tensor       # (B, m)
    L: torch.Tensor          # (B, m+n, m+n) unit lower factor
    d: torch.Tensor          # (B, m+n) pivots


@dataclasses.dataclass(frozen=True)
class DenseK2Backend(KKTBackend):
    name = "dense-ldl"
    systems = ("K2",)
    # update and solve read nothing on the host (KKTBackend.device_loop).
    device_loop = True

    def linear_system(self) -> str:
        return "Augmented system (K2)"

    def setup(self, A: torch.Tensor) -> DenseK2State:
        B, m, n = A.shape
        kw = dict(dtype=A.dtype, device=A.device)
        return DenseK2State(
            A=A,
            theta_reg=torch.ones(B, n, **kw),
            regD=torch.ones(B, m, **kw),
            L=torch.eye(m + n, **kw).expand(B, m + n, m + n).clone(),
            d=torch.ones(B, m + n, **kw),
        )

    def update(self, state: DenseK2State, theta_inv, regP, regD,
               ) -> Tuple[DenseK2State, torch.Tensor]:
        A = state.A
        B, m, n = A.shape
        theta_reg = theta_inv + regP
        # The x block: exact pivots, and L[n:, :n] = A diag(d_x)⁻¹.
        dx = -theta_reg
        Lx = A / torch.where(dx == 0, 1.0, dx).unsqueeze(-2)
        S = torch.diag_embed(regD) - (Lx * dx.unsqueeze(-2)) @ Lx.transpose(
            -1, -2)
        Ls, ds, ok = ldl_nopivot(S)
        L = A.new_zeros(B, m + n, m + n)
        L[:, :n, :n] = _eye_like(A.new_empty(n, n))
        L[:, n:, :n] = Lx
        L[:, n:, n:] = Ls
        d = torch.cat([dx, ds], dim=-1)
        ok = (ok & torch.isfinite(Lx).flatten(-2).all(-1)
              & torch.isfinite(dx).all(-1) & (dx != 0).all(-1))
        L = torch.where(ok[:, None, None], L, _eye_like(L))
        d = torch.where(ok[:, None], d, torch.ones_like(d))
        return (DenseK2State(A=A, theta_reg=theta_reg, regD=regD, L=L, d=d),
                ok)

    def _base_solve(self, state: DenseK2State, xi_p, xi_d):
        n = state.A.shape[-1]
        rhs = torch.cat([xi_d, xi_p], dim=-1).unsqueeze(-1)
        w = torch.linalg.solve_triangular(state.L, rhs, upper=False,
                                          unitriangular=True)
        w = w / state.d.unsqueeze(-1)
        sol = torch.linalg.solve_triangular(state.L.transpose(-1, -2), w,
                                            upper=True,
                                            unitriangular=True).squeeze(-1)
        return sol[:, :n], sol[:, n:]

    def solve(self, state: DenseK2State, xi_p, xi_d):
        dx, dy = self._base_solve(state, xi_p, xi_d)
        return self._refine(state, xi_p, xi_d, dx, dy, self._base_solve)
