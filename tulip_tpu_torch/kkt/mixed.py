"""Mixed-precision K1 backend (``"dense-mixed"``): f32 factorization, f64
refinement.

Counterpart of ``tulip_tpu/kkt/mixed.py``: the O(m³) work (the Gram
matrix, its Cholesky factor and the factor's inverse) runs in f32, the
O(m²) work of each solve (residuals and corrections) in f64. Refinement
against the f64 augmented system recovers f64-grade solves while
eps_f32·cond(K) < 1; pair it with ``PRegMin/DRegMin ≈ 1e-6``.

- The f32 products must run at full f32 precision, not TF32: the IPM runs
  every solve under ``ipm.hsd.full_matmul_precision()``.
- From m = 4096 (its ``blocked_min``) the reference forms L⁻¹ by a
  recursive blocked Cholesky + inverse (``tulip_tpu/ops/blocked.py``), a
  workaround for XLA on the TPU. Here L⁻¹ comes from
  ``torch.linalg.cholesky_ex`` and ``solve_triangular`` at every m: the
  same factor inverse, rounded differently (ROADMAP queue 3, allowed
  divergences).

Tensors are batch-first; ``update`` returns a per-lane ``ok``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from .base import KKTBackend, bmtv, bmv
from .dense import identity_where_failed


class MixedK1State(NamedTuple):
    A: torch.Tensor          # (B, m, n) f64
    A32: torch.Tensor        # (B, m, n) f32 copy
    d: torch.Tensor          # (B, n)  f64  D = (Θ⁻¹+Rp)⁻¹
    theta_reg: torch.Tensor  # (B, n)  f64
    regD: torch.Tensor       # (B, m)  f64
    Li32: torch.Tensor       # (B, m, m) f32 inverse Cholesky factor


@dataclasses.dataclass(frozen=True)
class MixedK1Backend(KKTBackend):
    name = "dense-mixed"
    systems = ("K1",)
    # update and solve read nothing on the host (KKTBackend.device_loop).
    device_loop = True
    refinement_steps: int = 3

    def arithmetic_label(self, dtype) -> str:
        return "float32 factorization / float64 refinement"

    def linear_system(self) -> str:
        return "Normal equations (K1), mixed precision"

    def setup(self, A: torch.Tensor) -> MixedK1State:
        Bt, m, n = A.shape
        A = A.to(torch.float64)
        ones = A.new_ones
        return MixedK1State(
            A=A, A32=A.to(torch.float32), d=ones(Bt, n),
            theta_reg=ones(Bt, n), regD=ones(Bt, m),
            Li32=torch.eye(m, dtype=torch.float32,
                           device=A.device).expand(Bt, m, m).clone())

    def update(self, state: MixedK1State, theta_inv, regP, regD,
               ) -> Tuple[MixedK1State, torch.Tensor]:
        theta_reg = theta_inv + regP
        d = 1.0 / theta_reg
        B32 = state.A32 * torch.sqrt(d).to(torch.float32).unsqueeze(-2)
        K32 = (B32 @ B32.transpose(-1, -2)
               + torch.diag_embed(regD.to(torch.float32)))
        L32, info = torch.linalg.cholesky_ex(K32)
        L32 = L32.masked_fill((info > 0)[:, None, None], float("nan"))
        L32, ok = identity_where_failed(L32)
        eye = torch.eye(L32.shape[-1], dtype=L32.dtype, device=L32.device)
        Li32 = torch.linalg.solve_triangular(L32, eye.expand_as(L32),
                                             upper=False)
        return (MixedK1State(A=state.A, A32=state.A32, d=d,
                             theta_reg=theta_reg, regD=regD, Li32=Li32), ok)

    def _f32_solve(self, state: MixedK1State, xi_p, xi_d):
        """One f32 core solve of the augmented system; f64 in/out."""
        A, d = state.A, state.d
        rhs = (xi_p + bmv(A, d * xi_d)).to(torch.float32)
        dy = bmtv(state.Li32, bmv(state.Li32, rhs)).to(torch.float64)
        dx = d * (bmtv(A, dy) - xi_d)
        return dx, dy

    def solve(self, state: MixedK1State, xi_p, xi_d):
        dx, dy = self._f32_solve(state, xi_p, xi_d)
        # f64 refinement against the augmented system.
        for _ in range(self.refinement_steps):
            rd = xi_d - (-(state.theta_reg * dx) + bmtv(state.A, dy))
            rp = xi_p - (bmv(state.A, dx) + state.regD * dy)
            ddx, ddy = self._f32_solve(state, rp, rd)
            dx = dx + ddx
            dy = dy + ddy
        return dx, dy
