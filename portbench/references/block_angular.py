"""The plain reference for two-stage (block-angular) LPs

    min cᵀx s.t. A0 x0 = b0, Tk x0 + Wk xk = hk (k = 1..K), 0 ≤ x ≤ u,

that never makes A dense: A is kept as its blocks A0 (m0, n0), T (K, mk,
n0) and W (K, mk, nk) on one device, and A·x and Aᵀ·y are taken by blocks.
It imports nothing of the program under test.

The IPM is ``reference.solve_box_lp``'s (Mehrotra's predictor-corrector,
the upper bounds carried as slacks w = u - x, the best iterate kept, each
Newton direction refined on A·dx = rb itself), for one LP, in float64.
Each correction of the refinement solves the normal equations
A·D·Aᵀ ddy = rb - A·dx by conjugate gradients, A·D·Aᵀ applied by blocks,
preconditioned by a block elimination that takes the scenario rows first
(J. R. Birge and L. Qi, "Computing block-angular Karmarkar projections
with applications to stochastic programming", Management Science 34
(1988)): with Bk = Wk Dk Wkᵀ and the n0×n0 capacitance
C = D0⁻¹ + Σk Tkᵀ Bk⁻¹ Tk,

    y0 = (A0 C⁻¹ A0ᵀ)⁻¹ (r0 - A0 C⁻¹ Σk Tkᵀ Bk⁻¹ rk),
    v  = C⁻¹ (A0ᵀ y0 + Σk Tkᵀ Bk⁻¹ rk),
    yk = Bk⁻¹ (rk - Tk v).

Near the optimum a scenario whose rows the first stage's columns span has
a singular Bk while A·D·Aᵀ is not: each Bk is shifted by ``RHO`` of its
largest diagonal entry, which only the preconditioner sees. The program
eliminates the other way (its regularized first-stage system in x0,
``kkt/schur.py``), so a fault in its elimination is not the reference's
too. There is no vertex finish: a basis of this size is out of reach, and
an LP left above ``tol`` after ``MAX_ITER`` iterations reports
``converged = False``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.reference import Solved

MAX_ITER = 150
# The shift of each Bk, relative to its largest diagonal entry.
RHO = 1e-10
# A Newton direction is refined until A·dx = rb holds to CG_TOL·(1 + ‖b‖∞),
# at most REFINE times, each correction by at most CG_MAX conjugate
# gradients.
CG_TOL = 1e-13
CG_MAX = 200
REFINE = 5


class BlockLP(NamedTuple):
    A0: torch.Tensor    # (m0, n0)
    T: torch.Tensor     # (K, mk, n0)
    W: torch.Tensor     # (K, mk, nk)
    b: torch.Tensor     # (1, m0 + K·mk)
    c: torch.Tensor     # (1, n0 + K·nk)
    u: torch.Tensor     # (1, n0 + K·nk)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """A·x of a (B, n) batch, by blocks."""
        B, n0 = x.shape[0], self.A0.shape[1]
        K, mk, nk = self.W.shape
        x0, xs = x[:, :n0], x[:, n0:].reshape(B, K, nk)
        scen = (torch.einsum("kij,bj->bki", self.T, x0)
                + torch.einsum("kij,bkj->bki", self.W, xs))
        return torch.cat([x0 @ self.A0.T, scen.reshape(B, K * mk)], -1)

    def rmatvec(self, y: torch.Tensor) -> torch.Tensor:
        """Aᵀ·y of a (B, m) batch, by blocks."""
        B, m0 = y.shape[0], self.A0.shape[0]
        K, mk, nk = self.W.shape
        y0, ys = y[:, :m0], y[:, m0:].reshape(B, K, mk)
        top = y0 @ self.A0 + torch.einsum("kij,bki->bj", self.T, ys)
        scen = torch.einsum("kij,bki->bkj", self.W, ys)
        return torch.cat([top, scen.reshape(B, K * nk)], -1)


def build(item: dict, device) -> BlockLP:
    """The LP of a pool item (``generators/two_stage.py``'s arrays)."""
    def t(v):
        return torch.as_tensor(np.asarray(v, dtype=np.float64),
                               device=device)

    if np.any(np.asarray(item["l"]) != 0) or not np.isfinite(
            item["u"]).all():
        raise ValueError("the block reference takes 0 <= x <= u, u finite")
    b = np.concatenate([item["b0"], np.asarray(item["h"]).reshape(-1)])
    c = np.concatenate([item["c0x"], np.asarray(item["cks"]).reshape(-1)])
    return BlockLP(A0=t(item["A0"]), T=t(item["T"]), W=t(item["W"]),
                   b=t(b)[None], c=t(c)[None], u=t(item["u"])[None])


def _chol(M: torch.Tensor) -> torch.Tensor:
    """Cholesky factors of a batch of SPD matrices; a matrix whose
    factorization fails is shifted by 1e-14 of its largest diagonal
    entry, 100 times more at each retry (the preconditioner only)."""
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    scale = M.diagonal(dim1=-2, dim2=-1).amax(-1)
    shift = torch.zeros_like(scale)
    for k in range(6):
        L, info = torch.linalg.cholesky_ex(
            M + (shift * scale)[..., None, None] * eye)
        if not bool((info != 0).any()):
            return L
        shift = torch.where(info != 0, 1e-14 * 100.0 ** k, shift)
    raise torch.linalg.LinAlgError("a block stays singular when shifted")


def _cho(L: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    return torch.cholesky_solve(r.unsqueeze(-1), L).squeeze(-1)


class _Normal:
    """The preconditioner: A·diag(d)·Aᵀ of a block-angular A with each Bk
    shifted, factored by blocks; ``solve`` takes and returns one (m,)
    vector."""

    def __init__(self, lp: BlockLP, d: torch.Tensor):
        A0, T, W = lp.A0, lp.T, lp.W
        n0 = A0.shape[1]
        K, mk, nk = W.shape
        self.lp, self.m0 = lp, A0.shape[0]
        d0, dk = d[:n0], d[n0:].reshape(K, nk)
        eye = torch.eye(mk, dtype=W.dtype, device=W.device)
        Bk = (W * dk[:, None, :]) @ W.mT
        rho = RHO * Bk.diagonal(dim1=-2, dim2=-1).amax(-1)
        self.Lb = _chol(Bk + rho[:, None, None] * eye)
        Z = torch.linalg.solve_triangular(self.Lb, T, upper=False)
        C = torch.diag(1.0 / d0) + torch.einsum("kij,kil->jl", Z, Z)
        self.Lc = _chol(C)
        E = torch.linalg.solve_triangular(self.Lc, A0.T, upper=False)
        self.Lf = _chol(E.T @ E)

    def solve(self, r: torch.Tensor) -> torch.Tensor:
        A0, T = self.lp.A0, self.lp.T
        K, mk, _ = T.shape
        r0, rs = r[:self.m0], r[self.m0:].reshape(K, mk)
        g = _cho(self.Lb, rs)
        q = torch.einsum("kij,ki->j", T, g)
        p = _cho(self.Lc, q)
        y0 = _cho(self.Lf, r0 - A0 @ p)
        v = _cho(self.Lc, A0.T @ y0 + q)
        ys = g - _cho(self.Lb, torch.einsum("kij,j->ki", T, v))
        return torch.cat([y0, ys.reshape(-1)])


def _pcg(M, r, P, tol):
    """x with M·x ≈ r (M symmetric positive definite) by conjugate
    gradients preconditioned by ``P`` ≈ M⁻¹, until the recurrence's
    residual is at most ``tol`` or after ``CG_MAX`` iterations."""
    x = torch.zeros_like(r)
    res = r
    z = P(res)
    p = z
    rz = res @ z
    for _ in range(CG_MAX):
        q = M(p)
        alpha = rz / (p @ q)
        x = x + alpha * p
        res = res - alpha * q
        if float(res.abs().amax()) <= tol:
            break
        z = P(res)
        rz, rz_old = res @ z, rz
        p = z + (rz / rz_old) * p
    return x


def _max_step(v: torch.Tensor, dv: torch.Tensor) -> torch.Tensor:
    """The largest α with v + α·dv ≥ 0 (v > 0), at most 1e30."""
    ratio = torch.where(dv < 0, -v / dv, torch.full_like(v, 1e30))
    return ratio.amin()


def solve(lp: BlockLP, *, precision: str = "float64",
          tol: float = 1e-9) -> Solved:
    """The LP solved to ``tol`` (relative primal and dual residuals and
    gap), in float64 on its device."""
    if precision != "float64":
        raise ValueError("the block reference solves in float64 only")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _solve(lp, tol)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _solve(lp: BlockLP, tol: float) -> Solved:
    b, c, u = lp.b[0], lp.c[0], lp.u[0]
    n = c.shape[0]

    def mv(v):
        return lp.matvec(v[None])[0]

    def rmv(v):
        return lp.rmatvec(v[None])[0]

    def inf(v):
        return v.abs().amax()

    x = u / 2
    w = u - x
    y = torch.zeros_like(b)
    z = c.clamp(min=0) + 1
    s = z - c
    nb, nc, nu = 1 + inf(b), 1 + inf(c), 1 + inf(u)
    best, best_x = float("inf"), x
    it = 0
    for it in range(MAX_ITER + 1):
        rb = b - mv(x)
        ru = u - x - w
        rc = c - rmv(y) - z + s
        pobj = c @ x
        dobj = b @ y - u @ s
        err = float(torch.stack([inf(rb) / nb, inf(ru) / nu, inf(rc) / nc,
                                 (pobj - dobj).abs() / (1 + pobj.abs())])
                    .amax())
        if err < best:
            best, best_x = err, x
        if best <= tol or it == MAX_ITER:
            break
        mu = (x @ z + w @ s) / (2 * n)
        d = 1.0 / (z / x + s / w)
        normal = _Normal(lp, d)

        def M(v):
            return mv(d * rmv(v))

        def newton(rxz, rws):
            rhat = rc - rxz / x + (rws - s * ru) / w
            # Refinement on A·dx = rb itself, each correction by
            # conjugate gradients: dx grows by D·Aᵀ·ddy, so its error
            # does not scale with D as D·(Aᵀdy - r̂) formed anew would.
            dy = torch.zeros_like(rb)
            dx = -d * rhat
            for _ in range(REFINE):
                r = rb - mv(dx)
                if float(inf(r)) <= CG_TOL * nb:
                    break
                ddy = _pcg(M, r, normal.solve, CG_TOL * nb)
                dy = dy + ddy
                dx = dx + d * rmv(ddy)
            dz = (rxz - z * dx) / x
            dw = ru - dx
            ds = (rws - s * dw) / w
            return dx, dw, dy, dz, ds

        dxa, dwa, _, dza, dsa = newton(-x * z, -w * s)
        ap = torch.minimum(_max_step(x, dxa), _max_step(w, dwa)).clamp(max=1)
        ad = torch.minimum(_max_step(z, dza), _max_step(s, dsa)).clamp(max=1)
        mu_aff = ((x + ap * dxa) @ (z + ad * dza)
                  + (w + ap * dwa) @ (s + ad * dsa)) / (2 * n)
        cm = (mu_aff / mu) ** 3 * mu
        dx, dw, dy, dz, ds = newton(cm - x * z - dxa * dza,
                                    cm - w * s - dwa * dsa)
        ap = (0.995 * torch.minimum(_max_step(x, dx), _max_step(w, dw))
              ).clamp(max=1)
        ad = (0.995 * torch.minimum(_max_step(z, dz), _max_step(s, ds))
              ).clamp(max=1)
        x, w = x + ap * dx, w + ap * dw
        y, z, s = y + ad * dy, z + ad * dz, s + ad * ds
    return Solved(converged=torch.tensor([best <= tol], device=b.device),
                  obj=(c @ best_x)[None], x=best_x[None], iters=it)
