"""The plain reference: LPs of the form min cᵀx s.t. Ax = b, 0 ≤ x ≤ u.

A batched Mehrotra predictor-corrector interior-point method in plain
PyTorch, from the textbook (S. J. Wright, *Primal-Dual Interior-Point
Methods*, SIAM 1997, ch. 10-11, with the upper bounds carried as slacks
w = u - x): dense normal equations A·D·Aᵀ, a Cholesky factor, one
predictor and one corrector a step. It imports nothing of the program
under test and takes only the generated inputs.

Every lane stops on its own when the relative primal residuals, the
relative dual residual and the relative gap are all below ``tol``. Each
lane keeps the iterate at which the largest of the four was least, since
the normal equations lose digits as the iterates near a vertex, and a
lane can step away from a point that already met the test. A lane that
has not stopped after ``max_iter`` iterations is, in float64, finished
at the vertex its best iterate points to (its m columns farthest from
their bounds form the basis; the others sit at the bound they are
nearer), and that vertex is tested again, with its duals from the basis;
a lane that fails both tests reports ``converged = False``. The finish
mends float64's loss of digits near a vertex; the lower precisions,
which stand in for the program as controls, run the IPM alone.

``precision`` chooses the arithmetic: ``"float64"`` (the reference),
``"float32"``, or ``"tf32"``: float32 with every matrix product's operands
rounded to TF32's 10 mantissa bits first, as the card's tensor cores
round them (the same numbers on the CPU as on the card).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


# Columns tried for the last basic place of a lane's vertex (_vertex).
VERTEX_TRIES = 64


class Solved(NamedTuple):
    converged: torch.Tensor   # (B,) bool
    obj: torch.Tensor         # (B,) cᵀx
    x: torch.Tensor           # (B, n)
    iters: int


def to_tf32(a: torch.Tensor) -> torch.Tensor:
    """``a`` (float32) rounded to the nearest TF32 value (10 mantissa
    bits, ties away from zero)."""
    bits = a.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _dtype(precision: str) -> torch.dtype:
    return torch.float64 if precision == "float64" else torch.float32


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32":
        a, b = to_tf32(a), to_tf32(b)
    return a @ b


def _max_step(v: torch.Tensor, dv: torch.Tensor) -> torch.Tensor:
    """Per lane, the largest α with v + α·dv ≥ 0 (v > 0), at most 1e30."""
    ratio = torch.where(dv < 0, -v / dv, torch.full_like(v, 1e30))
    return ratio.amin(dim=-1)


def solve_box_lp(A: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                 u: torch.Tensor, *, precision: str = "float64",
                 tol: float = 1e-9, max_iter: int = 100) -> Solved:
    """Solve each lane of min cᵀx, Ax = b, 0 ≤ x ≤ u (A: (B, m, n); b:
    (B, m); c, u: (B, n), u finite) on the tensors' device."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _solve(A, b, c, u, precision, tol, max_iter)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _solve(A, b, c, u, precision, tol, max_iter):
    dt = _dtype(precision)
    A, b, c, u = (t.to(dt) for t in (A, b, c, u))
    B, m, n = A.shape
    At = A.mT

    def mv(M, v):
        return _mm(M, v.unsqueeze(-1), precision).squeeze(-1)

    def dot(p, q):
        return (p * q).sum(-1)

    def inf(v):
        return v.abs().amax(-1)

    x = u / 2
    w = u - x
    y = torch.zeros(B, m, dtype=dt, device=A.device)
    z = c.clamp(min=0) + 1
    s = z - c
    nb, nc, nu = 1 + inf(b), 1 + inf(c), 1 + inf(u)
    active = torch.ones(B, dtype=torch.bool, device=A.device)
    best = torch.full((B,), float("inf"), dtype=dt, device=A.device)
    best_x, best_w, best_z, best_s = x, w, z, s
    eye = torch.eye(m, dtype=dt, device=A.device)
    reg = torch.finfo(dt).eps * 100
    it = 0
    for it in range(max_iter + 1):
        rb = b - mv(A, x)
        ru = u - x - w
        rc = c - mv(At, y) - z + s
        pobj = dot(c, x)
        dobj = dot(b, y) - dot(u, s)
        err = torch.stack([inf(rb) / nb, inf(ru) / nu, inf(rc) / nc,
                           (pobj - dobj).abs() / (1 + pobj.abs())]).amax(0)
        better = err < best
        best = torch.where(better, err, best)
        best_x, best_w, best_z, best_s = (
            torch.where(better[:, None], v, bv) for v, bv in
            ((x, best_x), (w, best_w), (z, best_z), (s, best_s)))
        active &= best > tol
        if it == max_iter or not bool(active.any()):
            break
        mu = (dot(x, z) + dot(w, s)) / (2 * n)
        d = 1.0 / (z / x + s / w)
        M = _mm(A * d.unsqueeze(-2), At, precision)
        scale = M.diagonal(dim1=-2, dim2=-1).amax(-1)
        shift = torch.zeros_like(scale)
        for k in range(5):
            # A lane whose factorization fails is shifted, 100 times more
            # at each retry.
            L, info = torch.linalg.cholesky_ex(
                M + (shift * scale)[:, None, None] * eye)
            if not bool((info != 0).any()):
                break
            shift = torch.where(info != 0, reg * 100.0 ** k, shift)
        active &= info == 0

        def chol_solve(r):
            return torch.cholesky_solve(r.unsqueeze(-1), L).squeeze(-1)

        def newton(rxz, rws):
            rhat = rc - rxz / x + (rws - s * ru) / w
            dy = chol_solve(rb + mv(A, d * rhat))
            dx = d * (mv(At, dy) - rhat)
            for _ in range(2):
                # Refinement on the primal equation A·dx = rb itself: the
                # normal matrix, formed once, loses what A·D·Aᵀ's spread
                # of scales hides.
                ddy = chol_solve(rb - mv(A, dx))
                dy = dy + ddy
                dx = dx + d * mv(At, ddy)
            dz = (rxz - z * dx) / x
            dw = ru - dx
            ds = (rws - s * dw) / w
            return dx, dw, dy, dz, ds

        dxa, dwa, _, dza, dsa = newton(-x * z, -w * s)
        ap = torch.minimum(_max_step(x, dxa), _max_step(w, dwa)).clamp(max=1)
        ad = torch.minimum(_max_step(z, dza), _max_step(s, dsa)).clamp(max=1)
        mu_aff = (dot(x + ap[:, None] * dxa, z + ad[:, None] * dza)
                  + dot(w + ap[:, None] * dwa, s + ad[:, None] * dsa)) / (2 * n)
        sigma = (mu_aff / mu) ** 3
        cm = (sigma * mu)[:, None]
        dx, dw, dy, dz, ds = newton(cm - x * z - dxa * dza,
                                    cm - w * s - dwa * dsa)
        ap = (0.995 * torch.minimum(_max_step(x, dx), _max_step(w, dw))
              ).clamp(max=1)
        ad = (0.995 * torch.minimum(_max_step(z, dz), _max_step(s, ds))
              ).clamp(max=1)
        ap = torch.where(active, ap, torch.zeros_like(ap))[:, None]
        ad = torch.where(active, ad, torch.zeros_like(ad))[:, None]
        x, w = x + ap * dx, w + ap * dw
        y, z, s = y + ad * dy, z + ad * dz, s + ad * ds
    converged = best <= tol
    if precision == "float64" and not bool(converged.all()):
        lanes = (~converged).nonzero().flatten()
        ok, xv = _vertex(*(t[lanes] for t in (A, b, c, u, best_x, best_w,
                                              best_z, best_s)), tol)
        converged = converged.index_put((lanes,), ok)
        best_x = best_x.index_put((lanes,), torch.where(
            ok[:, None], xv, best_x[lanes]))
    return Solved(converged=converged, obj=dot(c, best_x), x=best_x,
                  iters=it)


def _vertex(A, b, c, u, x, w, z, s, tol):
    """(whether it is optimal to ``tol``, x) of the vertex each lane's
    iterate points to. Columns are ranked by min(x, w) / (z + s); the
    first m - 1 are basic, and so is one of the next ``VERTEX_TRIES``,
    the first that gives an optimal vertex: near degeneracy (a basic
    column 1e-7 from its bound) leaves the m-th place in doubt, and the
    column that belongs there can rank far down. Each other column sits
    at 0 or u, whichever it is nearer; x_B solves A_B·x_B = b - A_N·x_N
    and y solves A_Bᵀ·y = c_B. Optimal: A·x = b, 0 ≤ x ≤ u, and the
    reduced costs c - Aᵀy are ≥ 0 at 0 and ≤ 0 at u, each to ``tol``
    relative to b, u and c."""
    m = A.shape[1]
    order = (torch.minimum(x, w) / (z + s)).argsort(dim=-1, descending=True)
    ok = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    out = x
    for k in range(min(VERTEX_TRIES, x.shape[1] - m + 1)):
        basic = torch.cat([order[:, :m - 1], order[:, m - 1 + k:m + k]], 1)
        good, xv = _basis_vertex(A, b, c, u, w < x, basic, tol)
        new = good & ~ok
        out = torch.where(new[:, None], xv, out)
        ok |= good
    return ok, out


def _basis_vertex(A, b, c, u, nearer_upper, basic, tol):
    m = A.shape[1]
    is_basic = torch.zeros_like(u, dtype=torch.bool).scatter(1, basic, True)
    at_upper = ~is_basic & nearer_upper
    xn = torch.where(at_upper, u, torch.zeros_like(u))
    AB = A.gather(2, basic[:, None, :].expand(-1, m, -1))
    xB, info = torch.linalg.solve_ex(AB, b - (A @ xn.unsqueeze(-1))
                                     .squeeze(-1))
    y, info_t = torch.linalg.solve_ex(AB.mT, c.gather(1, basic))
    xv = xn.scatter(1, basic, xB)
    r = c - (A.mT @ y.unsqueeze(-1)).squeeze(-1)
    wrong_sign = torch.where(is_basic, torch.zeros_like(r),
                             torch.where(at_upper, r, -r).clamp(min=0))
    viol = torch.maximum((-xv).clamp(min=0), (xv - u).clamp(min=0))

    def inf(v):
        return v.abs().amax(-1)

    err = torch.stack([
        inf(b - (A @ xv.unsqueeze(-1)).squeeze(-1)) / (1 + inf(b)),
        inf(viol) / (1 + inf(u)), inf(wrong_sign) / (1 + inf(c))]).amax(0)
    return (info == 0) & (info_t == 0) & (err <= tol), xv
