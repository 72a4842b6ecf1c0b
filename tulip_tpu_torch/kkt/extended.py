"""Extended-precision K1 backends: double-double refinement (``"extended"``)
and double-double assembly and factorization (``"extended-dd"``).

Counterpart of ``tulip_tpu/kkt/extended.py``; see its docstring for the
design. ``"extended"`` is the f64 dense K1 Cholesky (:mod:`.dense`) whose
refinement residuals are computed in double-word arithmetic
(:mod:`..ops.doubledouble`), so the forward error of the refined solution
is ~u independent of cond(K) while the f64 factorization exists.
``"extended-dd"`` assembles and factors K in double-word arithmetic, for
K1 matrices past the f64 factorization boundary (cond up to ~1e30);
O(m²n + m³) dd work, slow by design.

Every dd value here is the reference's bit for bit (the tests hold it so
on the CPU, and ``chip_smoke.py`` on the card): elementwise torch ops only,
no fused multiply-add, the same pairwise trees. Two loops of the
reference are reshaped without changing a bit:

- the assembly of K, one column at a time there (``fori_loop(0, m,
  acol)``), runs here in chunks of columns at once: each column is the
  same elementwise products and the same tree sum over n;
- the left-looking Cholesky and the triangular solves keep the
  reference's column (row) loop, as Python loops.

Tensors are batch-first, as in every backend of this package: A is
(B, m, n), and ``update`` returns a per-lane ``ok``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..ops import doubledouble as dd
from .dense import DenseK1Backend

# Elements of the (chunk, m, n) dd intermediates of one chunk of the
# assembly of K (f64 words; a few such arrays are alive at once).
_ASSEMBLY_CHUNK_ELEMENTS = 1 << 22


@dataclasses.dataclass(frozen=True)
class ExtendedK1Backend(DenseK1Backend):
    """Dense K1 Cholesky with double-double-residual refinement.

    ``refinement_steps`` here counts dd-residual sweeps (default 2; one
    sweep already restores ~u forward error when cond(K)·u < 1, the second
    covers the regime cond(K) ≈ 1/u where the first correction is still
    contaminated).
    """

    name = "extended"
    systems = ("K1",)
    refinement_steps: int = 2

    def arithmetic_label(self, dtype) -> str:
        return f"{super().arithmetic_label(dtype)} + double-double refinement"

    def _dd_residuals(self, state, xi_p, xi_d, dx, dy):
        """Augmented-system residuals in double-word precision:
        rd = ξd + (Θ⁻¹+Rp)∘dx − Aᵀdy ;  rp = ξp − A dx − Rd∘dy."""
        A = state.A
        rd = dd.sub(dd.add(dd.from_f(xi_d),
                           dd.ewmul_vec(state.theta_reg, dx)),
                    dd.matvec(A.transpose(-1, -2), dy))
        rp = dd.sub(dd.sub(dd.from_f(xi_p), dd.matvec(A, dx)),
                    dd.ewmul_vec(state.regD, dy))
        return dd.to_f(rp), dd.to_f(rd)

    def solve(self, state, xi_p, xi_d):
        if state.A.dtype != torch.float64:
            raise TypeError(f"{self.name} backend requires float64 data; "
                            f"got {state.A.dtype}")
        dx, dy = self._base_solve(state, xi_p, xi_d)
        for _ in range(self.refinement_steps):
            rp, rd = self._dd_residuals(state, xi_p, xi_d, dx, dy)
            ddx, ddy = self._base_solve(state, rp, rd)
            dx = dx + ddx
            dy = dy + ddy
        return dx, dy


class DDK1State(NamedTuple):
    """A + diagonals + the dd Cholesky factor of K1 (batch-first)."""

    A: torch.Tensor          # (B, m, n)
    theta_reg: torch.Tensor  # (B, n)
    regD: torch.Tensor       # (B, m)
    Lhi: torch.Tensor        # (B, m, m)
    Llo: torch.Tensor        # (B, m, m)


def dd_cholesky(Kh, Kl):
    """Left-looking dd Cholesky of dd SPD matrices (..., m, m): a column
    loop with vectorized masked updates (O(m) sequential steps of O(m²)
    dd work), the reference's ``dd_cholesky`` over a leading batch."""
    m = Kh.shape[-1]
    idx = torch.arange(m, device=Kh.device)
    Lh, Ll = torch.zeros_like(Kh), torch.zeros_like(Kl)
    for j in range(m):
        kmask = (idx < j).to(Kh.dtype)                # columns k < j
        # s_i = Σ_{k<j} L[i,k]·L[j,k] in dd.
        rowj = (Lh[..., j, :] * kmask, Ll[..., j, :] * kmask)
        prod = dd.mul((Lh, Ll), (rowj[0].unsqueeze(-2),
                                 rowj[1].unsqueeze(-2)))
        s = dd.sum_(prod, axis=-1)                    # dd (..., m)
        col = dd.sub((Kh[..., :, j], Kl[..., :, j]), s)
        diag = (col[0][..., j], col[1][..., j])
        ljj = dd.sqrt_(diag)
        pos = ljj[0] > 0
        inv = dd.recip((torch.where(pos, ljj[0], 1.0),
                        torch.where(pos, ljj[1], 0.0)))
        below = (idx > j).to(Kh.dtype)
        colv = dd.mul(col, ((inv[0].unsqueeze(-1) * below),
                            (inv[1].unsqueeze(-1) * below)))
        colv[0][..., j] = ljj[0]
        colv[1][..., j] = ljj[1]
        Lh[..., :, j] = colv[0]
        Ll[..., :, j] = colv[1]
    return Lh, Ll


def dd_tri_solve(Lh, Ll, bh, bl, trans=False):
    """Solve L y = b (or Lᵀ y = b) with L (..., m, m) and b (..., m) in
    dd; the reference's row loop with masked dd dot products."""
    m = Lh.shape[-1]
    idx = torch.arange(m, device=Lh.device)
    yh, yl = torch.zeros_like(bh), torch.zeros_like(bl)
    for t in range(m):
        j = m - 1 - t if trans else t
        if trans:
            mask = (idx > j).to(Lh.dtype)
            row = (Lh[..., :, j] * mask, Ll[..., :, j] * mask)  # Lᵀ row j
        else:
            mask = (idx < j).to(Lh.dtype)
            row = (Lh[..., j, :] * mask, Ll[..., j, :] * mask)
        acc = dd.sum_(dd.mul(row, (yh, yl)), axis=-1)
        r = dd.sub((bh[..., j], bl[..., j]), acc)
        v = dd.div(r, (Lh[..., j, j], Ll[..., j, j]))
        yh[..., j] = v[0]
        yl[..., j] = v[1]
    return yh, yl


def _dd_matvec_ddvec(A, xh, xl):
    """A @ x with f64 A (..., m, n) and dd x (..., n) → dd (..., m), via
    broadcasted mul_f + tree sum."""
    ones = torch.ones_like(A)
    p = dd.mul_f((xh.unsqueeze(-2) * ones, xl.unsqueeze(-2) * ones), A)
    return dd.sum_(p, axis=-1)


def dd_normal_matrix(A, dinv, regD):
    """K = A diag(d) Aᵀ + diag(Rd) in dd (the reference's column loop):
    K[:, j] = A (d ∘ A[j, :]) + Rd_j e_j, with the diagonal add
    compensated. ``dinv`` is d as dd (..., n). Columns are formed in
    chunks at once, each by the reference's operations."""
    m, n = A.shape[-2:]
    Kh = A.new_zeros(A.shape[:-1] + (m,))
    Kl = torch.zeros_like(Kh)
    chunk = max(1, _ASSEMBLY_CHUNK_ELEMENTS // max(m * n, 1))
    for j0 in range(0, m, chunk):
        rows = A[..., j0:j0 + chunk, :]               # (..., c, n)
        zj = dd.mul((dinv[0].unsqueeze(-2), dinv[1].unsqueeze(-2)),
                    dd.from_f(rows))                  # d ∘ A[j, :]
        col = _dd_matvec_ddvec(A.unsqueeze(-3), zj[0], zj[1])  # (..., c, m)
        Kh[..., :, j0:j0 + chunk] = col[0].transpose(-1, -2)
        Kl[..., :, j0:j0 + chunk] = col[1].transpose(-1, -2)
    # Compensated diagonal add: a plain f64 add into the hi word would
    # drop its rounding error (the reference's comment at :203-206).
    dh, dl = dd.add_f((Kh.diagonal(dim1=-2, dim2=-1),
                       Kl.diagonal(dim1=-2, dim2=-1)), regD)
    Kh.diagonal(dim1=-2, dim2=-1).copy_(dh)
    Kl.diagonal(dim1=-2, dim2=-1).copy_(dl)
    return Kh, Kl


@dataclasses.dataclass(frozen=True)
class ExtendedDDK1Backend(ExtendedK1Backend):
    """Dense K1 with double-double ASSEMBLY and FACTORIZATION."""

    name = "extended-dd"
    systems = ("K1",)
    refinement_steps: int = 1        # dd-residual sweeps on the dd factor

    def arithmetic_label(self, dtype) -> str:
        return "double-double factorization"

    def setup(self, A):
        Bt, m, n = A.shape
        z = A.new_zeros(Bt, m, m)
        return DDK1State(A=A, theta_reg=A.new_ones(Bt, n),
                         regD=A.new_ones(Bt, m), Lhi=z, Llo=z)

    def update(self, state, theta_inv, regP, regD):
        A = state.A
        m = A.shape[-2]
        theta_reg = theta_inv + regP
        dinv = dd.recip(dd.from_f(theta_reg))         # dd (B, n)
        Kh, Kl = dd_normal_matrix(A, dinv, regD)
        Lh, Ll = dd_cholesky(Kh, Kl)
        ok = (torch.isfinite(Lh).flatten(-2).all(-1)
              & torch.isfinite(Ll).flatten(-2).all(-1))
        eye = torch.eye(m, dtype=A.dtype, device=A.device)
        Lh = torch.where(ok[:, None, None], Lh, eye)
        Ll = torch.where(ok[:, None, None], Ll, torch.zeros_like(Ll))
        return DDK1State(A=A, theta_reg=theta_reg, regD=regD,
                         Lhi=Lh, Llo=Ll), ok

    def _base_solve(self, state, xi_p, xi_d):
        A = state.A
        dinv = dd.recip(dd.from_f(state.theta_reg))
        # rhs = ξp + A (d ∘ ξd) in dd.
        dz = dd.mul(dinv, dd.from_f(xi_d))
        rhs = dd.add(dd.from_f(xi_p), _dd_matvec_ddvec(A, dz[0], dz[1]))
        u = dd_tri_solve(state.Lhi, state.Llo, rhs[0], rhs[1])
        y = dd_tri_solve(state.Lhi, state.Llo, u[0], u[1], trans=True)
        # dx = d ∘ (Aᵀ y − ξd) in dd.
        aty = _dd_matvec_ddvec(A.transpose(-1, -2), y[0], y[1])
        dx = dd.mul(dinv, dd.sub(aty, dd.from_f(xi_d)))
        return dd.to_f(dx), dd.to_f(y)
