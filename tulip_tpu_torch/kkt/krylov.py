"""Matrix-free Krylov KKT backends.

Counterpart of ``tulip_tpu/kkt/krylov.py`` (the reference's TlpKrylov
module, src/KKT/Krylov/{krylov,defs,spd,sid}.jl): ``update`` only
refreshes the diagonals, and ``solve`` runs an iterative method against
an implicit operator, two batched GEMVs an application.

Each solver takes the reference's arguments with a leading lane axis B on
every tensor. The reference runs one ``lax.while_loop`` per lane (under
``vmap``); here one host loop, :func:`_masked_while`, runs the body for
every lane on each trip, and a lane whose stopping test holds keeps its
carry (``torch.where``), so it ends on the iterate at which the
reference's loop stops for it. Frozen lanes never change, so the host
tests ``active.any()`` only every ``_CHECK_EVERY`` trips, with the same
bits as testing on every trip. Trip counts are Python ints: a lane still
active on trip t has run t trips, which is the reference's counter ``k``.

- ``CgK1Backend``: conjugate gradients on the SPD normal-equations operator
  ``w ↦ A D Aᵀ w + Rd w`` with Jacobi preconditioning
  (reference operator shape: src/KKT/Krylov/spd.jl:55-63).
- ``MinresK2Backend``: MINRES on the full symmetric indefinite augmented
  operator over (dx, dy) (reference: src/KKT/Krylov/sid.jl:50-64).
- ``TricgK2Backend``: TriCG on the SQD form (reference:
  src/KKT/Krylov/sqd.jl:87-92), experimental for full IPM runs: once Θ
  spans ~16 orders of magnitude its short recurrences lose orthogonality.
- ``SqdMinresK2Backend``: MINRES on the SQD system scaled by
  diag(M, N)^(-1/2) (the TriMR role).
- CR, CAR, SYMMLQ, MINRES-QLP, MINARES (experimental), LSQR, LSMR, CRAIG
  and CRAIGMR, as in the reference.

Tolerances default to sqrt(eps) like the reference (spd.jl:66-67).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from .base import KKTBackend

# Trips between two host tests of whether any lane is still active. Not a
# user setting: the result does not depend on it.
_CHECK_EVERY = 16


class KrylovState(NamedTuple):
    A: torch.Tensor          # (B, m, n)
    d: torch.Tensor          # (B, n)  D = (Θ⁻¹ + Rp)⁻¹
    theta_reg: torch.Tensor  # (B, n)  Θ⁻¹ + Rp
    regD: torch.Tensor       # (B, m)


def _sqrt_eps(dt: torch.dtype) -> float:
    return torch.finfo(dt).eps ** 0.5


def _any(active: torch.Tensor) -> bool:
    """One host sync: whether any lane is still active."""
    return bool(active.any())


def _pack(carry: tuple) -> torch.Tensor:
    """The carry's tensors, (B,) scalars and (B, k) vectors, side by side
    in one (B, K) buffer."""
    return torch.cat([t.unsqueeze(-1) if t.dim() == 1 else t
                      for t in carry], dim=-1)


def _unpack(buf: torch.Tensor, like: tuple) -> tuple:
    """Views of ``buf`` in the shapes of ``like``'s tensors."""
    parts = buf.split([t.shape[-1] if t.dim() == 2 else 1 for t in like],
                      dim=-1)
    return tuple(p if t.dim() == 2 else p.squeeze(-1)
                 for p, t in zip(parts, like))


def _masked_while(cond: Callable, body: Callable, carry: tuple,
                  maxiter: int) -> tuple:
    """The reference's ``lax.while_loop(cond, body, carry)`` over a lane
    axis, for at most ``maxiter`` trips: ``cond(carry)`` is a (B,) mask,
    ``body(carry, k)`` the next carry, with ``k`` the trip's index (the
    count of trips an active lane has run). A lane keeps its carry from
    the trip on which ``cond`` first fails; the loop stops when no lane is
    active, which the host tests every ``_CHECK_EVERY`` trips. The carry
    lives in one buffer, so that a trip's per-lane select is one
    ``torch.where`` (and one ``torch.cat``) whatever its length."""
    buf = _pack(carry)
    carry = _unpack(buf, carry)
    active = cond(carry)
    for k in range(maxiter):
        if k % _CHECK_EVERY == 0 and not _any(active):
            break
        buf = torch.where(active.unsqueeze(-1), _pack(body(carry, k)), buf)
        carry = _unpack(buf, carry)
        # A frozen lane's carry, hence its cond, no longer changes.
        active = cond(carry)
    return carry


def bmv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, r, k) x (B, k) -> (B, r), as a row vector times Mᵀ: in this
    form torch's CPU matmul gives a lane the same bits at any batch size,
    where ``kkt.base.bmv``'s one-lane product folds into a matrix-vector
    call that sums in another order than the batched one."""
    return (v.unsqueeze(-2) @ M.mT).squeeze(-2)


def bmtv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, r, k) x (B, r) -> (B, k), as a row vector times M."""
    return (v.unsqueeze(-2) @ M).squeeze(-2)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vecdot(a, b)


def _norm(a: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(a, dim=-1)


def _c(s: torch.Tensor) -> torch.Tensor:
    """(B,) per-lane scalar -> (B, 1), to broadcast against (B, k)."""
    return s.unsqueeze(-1)


def _safe(x: torch.Tensor) -> torch.Tensor:
    """x with its zeros replaced by 1 (the reference's
    ``where(x == 0, 1, x)``), in two launches."""
    return x + (x == 0)


def minres(matvec: Callable, b: torch.Tensor, rtol, maxiter: int,
           ) -> torch.Tensor:
    """MINRES (Paige & Saunders 1975) for symmetric (possibly indefinite)
    systems."""
    one = torch.ones_like(b[..., 0])
    zero = torch.zeros_like(one)
    beta1 = _norm(b)
    beta1_safe = _safe(beta1)
    v0 = b / _c(beta1_safe)
    zb = torch.zeros_like(b)
    # carry: (x, v_prev, v, beta, eta, gamma0, gamma1, sigma0, sigma1,
    #         w_mm, w_m, rnorm)
    carry0 = (zb, zb, v0, beta1, beta1, one, one, zero, zero, zb, zb, beta1)
    tol = rtol * beta1_safe

    def cond(c):
        return c[-1] > tol

    def body(c, k):
        (x, v_prev, v, beta, eta, g0, g1, s0, s1, w_mm, w_m, _) = c
        Av = matvec(v)
        alpha = _dot(v, Av)
        r = Av - _c(alpha) * v - _c(beta) * v_prev
        beta_next = _norm(r)
        v_next = r / _c(_safe(beta_next))

        delta = g1 * alpha - g0 * s1 * beta
        rho1 = torch.sqrt(delta * delta + beta_next * beta_next)
        rho1_safe = _safe(rho1)
        rho2 = s1 * alpha + g0 * g1 * beta
        rho3 = s0 * beta
        g_next = delta / rho1_safe
        s_next = beta_next / rho1_safe

        w = (v - _c(rho3) * w_mm - _c(rho2) * w_m) / _c(rho1_safe)
        x = x + _c(g_next * eta) * w
        eta_next = -s_next * eta
        return (x, v, v_next, beta_next, eta_next, g1, g_next, s1, s_next,
                w_m, w, eta_next.abs())

    return _masked_while(cond, body, carry0, maxiter)[0]


def pcg(matvec: Callable, b: torch.Tensor, precond: Callable, rtol,
        maxiter: int) -> torch.Tensor:
    """Preconditioned conjugate gradients."""
    z0 = precond(b)
    gamma0 = _dot(b, z0)
    tol2 = (rtol * _safe(_norm(b))) ** 2

    def cond(c):
        r = c[1]
        return _dot(r, r) > tol2

    def body(c, k):
        x, r, z, p, gamma = c
        Ap = matvec(p)
        alpha = gamma / _safe(_dot(p, Ap))
        x = x + _c(alpha) * p
        r = r - _c(alpha) * Ap
        z = precond(r)
        gamma_new = _dot(r, z)
        beta = gamma_new / _safe(gamma)
        p = z + _c(beta) * p
        return x, r, z, p, gamma_new

    return _masked_while(cond, body, (torch.zeros_like(b), b, z0, z0, gamma0),
                         maxiter)[0]


def cr(matvec: Callable, b: torch.Tensor, precond: Callable, rtol,
       maxiter: int) -> torch.Tensor:
    """Preconditioned conjugate residuals (SPD; minimizes ||r|| instead of
    the A-norm error — the reference's SPD family also exposes CR,
    reference: src/KKT/Krylov/defs.jl:1-17)."""
    z0 = precond(b)              # preconditioned residual M⁻¹r
    Az0 = matvec(z0)
    gamma0 = _dot(z0, Az0)
    tol2 = (rtol * _safe(_norm(b))) ** 2

    # The TRUE residual r = b − Kx is carried alongside z: testing
    # ‖M⁻¹r‖ against rtol·‖b‖ stops orders of magnitude too early when
    # the Jacobi diagonal is large (late-IPM Θ⁻¹ ~ 1e16), which returned
    # junk steps and stalled the IPM at ITERATION_LIMIT (the reference's
    # round-5 finding, tulip_tpu/kkt/krylov.py:155-160).
    def cond(c):
        r = c[1]
        return _dot(r, r) > tol2

    def body(c, k):
        x, r, z, p, Az, Ap, gamma = c
        MAp = precond(Ap)
        alpha = gamma / _safe(_dot(Ap, MAp))
        x = x + _c(alpha) * p
        r = r - _c(alpha) * Ap
        z = z - _c(alpha) * MAp
        Az = matvec(z)
        gamma_new = _dot(z, Az)
        beta = gamma_new / _safe(gamma)
        p = z + _c(beta) * p
        Ap = Az + _c(beta) * Ap
        return x, r, z, p, Az, Ap, gamma_new

    return _masked_while(cond, body, (torch.zeros_like(b), b, z0, z0, Az0,
                                      Az0, gamma0), maxiter)[0]


def car(matvec: Callable, b: torch.Tensor, precond: Callable, rtol,
        maxiter: int) -> torch.Tensor:
    """CAR — conjugate A-residuals for SPD systems (the third member of the
    reference's SPD family, reference: src/KKT/Krylov/defs.jl:1-5;
    Montoison, Orban & Saunders 2023). Minimizes ``||r_k||_A`` over the
    Krylov space, one operator application per iteration.

    Orthomin-form recurrences with A³-conjugate directions: maintaining
    q = Ar, u = Ap, w = A²p,

        α = rᵀA²r / pᵀA³p = <q,q> / <u,w>,
        x += αp,  r -= αu,  q -= αw,  s = Aq,
        β = <q',q'> / <q,q>,
        p = r + βp,  u = q + βu,  w = s + βw.

    Preconditioning is symmetric-diagonal: callers pass the Jacobi-scaled
    operator (``precond`` is unused, as in the reference)."""
    del precond
    q0 = matvec(b)
    s0 = matvec(q0)
    rho0 = _dot(q0, q0)
    tol2 = (rtol * _safe(_norm(b))) ** 2

    def cond(c):
        r = c[1]
        return _dot(r, r) > tol2

    def body(c, k):
        x, r, q, p, u, w, rho = c
        alpha = rho / _safe(_dot(u, w))
        x = x + _c(alpha) * p
        r = r - _c(alpha) * u
        q = q - _c(alpha) * w
        s = matvec(q)
        rho_new = _dot(q, q)
        beta = _c(rho_new / _safe(rho))
        return (x, r, q, r + beta * p, q + beta * u, s + beta * w, rho_new)

    return _masked_while(cond, body, (torch.zeros_like(b), b, q0, b, q0, s0,
                                      rho0), maxiter)[0]


def _sym_givens(a, b):
    """Symmetric orthogonal reflection: returns (c, s, r) with
    [c s; s -c][a; b] = [r; 0], r = hypot(a, b) >= 0."""
    r = torch.sqrt(a * a + b * b)
    r_safe = _safe(r)
    c = torch.where(r == 0, 1.0, a / r_safe)
    s = torch.where(r == 0, 0.0, b / r_safe)
    return c, s, r


def minres_qlp(matvec: Callable, b: torch.Tensor, rtol, maxiter: int,
               ) -> torch.Tensor:
    """MINRES-QLP (Choi, Paige & Saunders, SIAM J. Sci. Comput. 2011) for
    symmetric (possibly indefinite or singular) systems.

    Beyond MINRES it applies a second, right-side sequence of reflections
    (the QLP decomposition of the tridiagonal), which keeps the solution
    update well-conditioned near (numerical) singularity and converges to
    the minimum-length solution of singular consistent systems. This runs
    the always-QLP variant, as the reference does.

    Carry, as the reference's dict: Lanczos r1, r2 (scaled v's), beta,
    betan; left reflections cs, sn, dltan, eplnn; right-rotated tridiagonal
    entries gama/gamal, eta/etal, vepln/veplnl; solution tau/taul, phi,
    ul3/ul2/ul/u, xl2, wl, w. Both right reflections are computed fresh
    every iteration, so row k-2 and W column k-2 finalize at iteration k.
    The reference's ``where(k > 1, ...)`` on its counter becomes a Python
    branch on the trip index."""
    one = torch.ones_like(b[..., 0])
    zero = torch.zeros_like(one)
    beta1 = _norm(b)
    tol = rtol * _safe(beta1)
    zb = torch.zeros_like(b)
    names = ("r1", "r2", "beta", "betan", "cs", "sn", "dltan", "eplnn",
             "gama", "gamal", "eta", "etal", "vepln", "veplnl", "tau",
             "taul", "phi", "ul3", "ul2", "ul", "u", "xl2", "wl", "w", "x")
    carry0 = dict(
        r1=zb, r2=b, beta=zero, betan=beta1,
        cs=-one, sn=zero, dltan=zero, eplnn=zero,
        gama=zero, gamal=zero,
        eta=zero, etal=zero, vepln=zero, veplnl=zero,
        tau=zero, taul=zero, phi=beta1,
        ul3=zero, ul2=zero, ul=zero, u=zero,
        xl2=zb, wl=zb, w=zb, x=zb)

    def cond(c):
        return c[names.index("phi")] > tol

    def body(t, trip):
        c = dict(zip(names, t))
        k = trip + 1
        # -- Lanczos step (r1/r2 carry beta-scaled basis vectors) --
        betal = c["beta"]
        beta = c["betan"]
        beta_safe = _safe(beta)
        v = c["r2"] / _c(beta_safe)
        r3 = matvec(v)
        if k > 1:
            r3 = r3 - _c(beta / _safe(betal)) * c["r1"]
        alfa = _dot(v, r3)
        r3 = r3 - _c(alfa / beta_safe) * c["r2"]
        betan = _norm(r3)

        # -- previous left reflection Q_{k-1} --
        dbar = c["dltan"]
        dlta = c["cs"] * dbar + c["sn"] * alfa
        epln = c["eplnn"]
        gbar = c["sn"] * dbar - c["cs"] * alfa
        eplnn = c["sn"] * betan
        dltan = -c["cs"] * betan
        # -- current left reflection Q_k --
        gamal2 = c["gamal"]
        gamal = c["gama"]
        cs, sn, gama = _sym_givens(gbar, betan)
        taul2 = c["taul"]
        taul = c["tau"]
        tau = cs * c["phi"]
        phi = sn * c["phi"]

        # -- first right reflection P_{k-2,k}: zeros the (k-2, k) entry
        # epln against the provisional row-(k-2) diagonal, finalizing it --
        etal2 = c["etal"]          # final eta_{k-2} (set at iteration k-2)
        veplnl2 = c["veplnl"]      # final nu_{k-2}  (set at iteration k-1)
        if k > 2:
            cr2, sr2, gamal2 = _sym_givens(gamal2, epln)
            veplnl = cr2 * c["vepln"] + sr2 * dlta
            dlta = sr2 * c["vepln"] - cr2 * dlta
            etal = c["eta"]
            eta = sr2 * gama
            gama = -cr2 * gama
        else:
            cr2, sr2 = -one, zero
            veplnl = c["veplnl"]
            etal = c["etal"]
            eta = zero
        # -- second right reflection P_{k-1,k}: zeros the rotated (k-1, k)
        # entry against the provisional row-(k-1) diagonal --
        if k > 1:
            cr1, sr1, gamal = _sym_givens(gamal, dlta)
            vepln = sr1 * gama
            gama = -cr1 * gama
        else:
            cr1, sr1 = -one, zero
            vepln = c["vepln"]

        # -- solution coefficients (forward substitution through L) --
        # Row k-2 is final this iteration; rows k-1 and k stay provisional.
        ul4 = c["ul3"]
        ul3 = c["ul2"]
        ul2 = ((taul2 - etal2 * ul4 - veplnl2 * ul3) / _safe(gamal2)
               if k > 2 else c["ul2"])
        ul = ((taul - etal * ul3 - veplnl * ul2) / _safe(gamal)
              if k > 1 else c["ul"])
        u = torch.where(gama.abs() > 0,
                        (tau - eta * ul2 - vepln * ul) / _safe(gama), 0.0)

        # -- QLP direction vectors and iterate --
        wl2 = c["wl"]
        if k == 1:
            wl_out = v * _c(sr1)
            w_out = -v * _c(cr1)
        elif k == 2:
            wl_out = c["w"] * _c(cr1) + v * _c(sr1)
            w_out = c["w"] * _c(sr1) - v * _c(cr1)
        else:
            w_3a = wl2 * _c(sr2) - v * _c(cr2)
            wl2 = wl2 * _c(cr2) + v * _c(sr2)
            wl_out = c["w"] * _c(cr1) + w_3a * _c(sr1)
            w_out = c["w"] * _c(sr1) - w_3a * _c(cr1)

        xl2 = c["xl2"] + wl2 * _c(ul2)
        x = xl2 + wl_out * _c(ul) + w_out * _c(u)
        new = dict(
            r1=c["r2"], r2=r3, beta=beta, betan=betan,
            cs=cs, sn=sn, dltan=dltan, eplnn=eplnn,
            gama=gama, gamal=gamal,
            eta=eta, etal=etal, vepln=vepln, veplnl=veplnl,
            tau=tau, taul=taul, phi=phi,
            ul3=ul3, ul2=ul2, ul=ul, u=u,
            xl2=xl2, wl=wl_out, w=w_out, x=x)
        return tuple(new[n] for n in names)

    out = _masked_while(cond, body, tuple(carry0[n] for n in names), maxiter)
    return out[names.index("x")]


def symmlq(matvec: Callable, b: torch.Tensor, rtol, maxiter: int,
           ) -> torch.Tensor:
    """SYMMLQ (Paige & Saunders 1975) for symmetric (possibly indefinite)
    systems.

    Derivation used here: with Lanczos ``A V_k = V_{k+1} T̄_k``, the
    Galerkin condition for x = V_{k+1} y reads ``T̄_kᵀ y = β₁ e₁``
    (underdetermined); SYMMLQ takes the minimum-norm y via an LQ
    factorization of T̄ᵀ built from symmetric reflection rotations
    G_i = [[c, s], [s, -c]] on columns (i, i+1):

        ε_k = s_{k-2} β_k,   δ_k = -c_{k-1} c_{k-2} β_k + s_{k-1} α_k,
        γ̄_k = -s_{k-1} c_{k-2} β_k - c_{k-1} α_k,
        γ_k = hypot(γ̄_k, β_{k+1}),  c_k = γ̄_k/γ_k,  s_k = β_{k+1}/γ_k

    forward solve L z = β₁ e₁ and direction columns W = V Qᵀ via
    ``w_k = c_k w̄_k + s_k v_{k+1}``, ``w̄_{k+1} = s_k w̄_k - c_k v_{k+1}``.
    Stopping uses the true residual (one extra matvec per iteration)."""
    one = torch.ones_like(b[..., 0])
    zero = torch.zeros_like(one)
    beta1 = _norm(b)
    v1 = b / _c(_safe(beta1))
    # First Lanczos step.
    u = matvec(v1)
    alpha1 = _dot(v1, u)
    u = u - _c(alpha1) * v1
    beta2 = _norm(u)
    v2 = u / _c(_safe(beta2))
    tol = rtol * _safe(beta1)

    # carry: x, v_k, v_{k+1}, α_k, β_k, β_{k+1}, c_{k-2}, s_{k-2},
    #        c_{k-1}, s_{k-1}, z_{k-2}, z_{k-1}, h (forward-solve RHS:
    #        β₁ at k=1, then 0), w̄_k, rnorm.  c₀ = -1, s₀ = 0 make the
    #        k=1,2 edge rows come out of the general recurrences.
    carry0 = (torch.zeros_like(b), v1, v2, alpha1, zero, beta2, -one, zero,
              -one, zero, zero, zero, beta1, v1, beta1)

    def cond(c):
        return c[-1] > tol

    def body(c, k):
        (x, vk, vk1, alpha, beta_k, beta_n, c2, s2, c1, s1, z2, z1, h,
         wbar, _) = c
        eps_k = s2 * beta_k
        delta_k = -c1 * c2 * beta_k + s1 * alpha
        gbar_k = -s1 * c2 * beta_k - c1 * alpha
        gamma_k = _safe(torch.sqrt(gbar_k ** 2 + beta_n ** 2))
        ck = gbar_k / gamma_k
        sk = beta_n / gamma_k
        # Forward solve: z_k = (h - ε_k z_{k-2} - δ_k z_{k-1}) / γ_k with
        # h = β₁ for k=1 and 0 after.
        zk = (h - eps_k * z2 - delta_k * z1) / gamma_k
        # Direction and iterate.
        wk = _c(ck) * wbar + _c(sk) * vk1
        wbar_next = _c(sk) * wbar - _c(ck) * vk1
        x = x + _c(zk) * wk
        # Next Lanczos step (α_{k+1}, β_{k+2}, v_{k+2}).
        u = matvec(vk1) - _c(beta_n) * vk
        alpha_next = _dot(vk1, u)
        u = u - _c(alpha_next) * vk1
        beta_nn = _norm(u)
        v_next = u / _c(_safe(beta_nn))
        # True residual for stopping (extra matvec).
        rnorm = _norm(b - matvec(x))
        return (x, vk1, v_next, alpha_next, beta_n, beta_nn, c1, s1,
                ck, sk, z1, zk, zero, wbar_next, rnorm)

    return _masked_while(cond, body, carry0, maxiter)[0]


def tricg(A, Mdiag, Ndiag, b, c, rtol, maxiter):
    """TriCG: Galerkin method for the symmetric quasi-definite system

        [ M   A ] [x]   [b]
        [ Aᵀ  -N ] [y] = [c]

    with diagonal SPD M (m) and N (n), via the preconditioned
    Saunders-Simon-Yip process (A is (B, m, n)). Bases V (M-orthonormal)
    and U (N-orthonormal) satisfy ``A U_k = M V_k T_k + β_{k+1} M v_{k+1}
    e_kᵀ`` and ``Aᵀ V_k = N U_k T_kᵀ + γ_{k+1} N u_{k+1} e_kᵀ``; the
    Galerkin conditions reduce to the 2k×2k SQD block-tridiagonal system
    ``[I T; Tᵀ -I]`` solved incrementally by block-LDLᵀ with 2×2 pivots
    (strongly factorizable — Vanderbei). O(m+n) storage per iteration.
    Each 2×2 block is carried as its four (B,) entries.
    """
    Minv = 1.0 / Mdiag
    Ninv = 1.0 / Ndiag
    beta1 = torch.sqrt(_dot(b, Minv * b))
    gamma1 = torch.sqrt(_dot(c, Ninv * c))
    v1 = (Minv * b) / _c(_safe(beta1))
    u1 = (Ninv * c) / _c(_safe(gamma1))
    rnorm0 = torch.sqrt(beta1 ** 2 + gamma1 ** 2)
    tol = rtol * rnorm0
    eps_b = torch.finfo(b.dtype).eps ** 0.75
    zero = torch.zeros_like(beta1)
    zm, zn = torch.zeros_like(b), torch.zeros_like(c)
    carry0 = (
        zm, zn,                           # x, y
        zm, v1,                           # v_prev, v
        zn, u1,                           # u_prev, u
        beta1, gamma1,                    # β_k, γ_k
        zero, zero, zero, zero,           # Δ_{k-1}⁻¹ (00, 01, 10, 11)
        zero, zero,                       # ζ_{k-1}
        zm, zn,                           # G col1 (v-part, u-part)
        zm, zn,                           # G col2
        rnorm0,                           # rnorm estimate
    )

    def cond(cr_):
        return cr_[-1] > tol

    def body(cr_, k):
        (x, y, v_prev, v, u_prev, u, beta, gamma, di00, di01, di10, di11,
         zt0, zt1, g1v, g1u, g2v, g2u, _) = cr_
        Au = bmv(A, u)
        Atv = bmtv(A, v)
        alpha = _dot(v, Au)
        q = Minv * Au - _c(gamma) * v_prev - _c(alpha) * v
        p = Ninv * Atv - _c(beta) * u_prev - _c(alpha) * u
        beta_n = torch.sqrt(_dot(q, Mdiag * q))
        gamma_n = torch.sqrt(_dot(p, Ndiag * p))
        # Breakdown deflation: when one Krylov space is exhausted the new
        # norm is pure rounding noise; normalizing it would inject a junk
        # basis vector and break the three-term recurrences. Zero the
        # vector instead (the process then keeps expanding the other
        # space, which is the exact-arithmetic behavior).
        scale_q = torch.sqrt(_dot(Au, Minv * Au)) + gamma + alpha.abs()
        scale_p = torch.sqrt(_dot(Atv, Ninv * Atv)) + beta + alpha.abs()
        dead_v = beta_n <= eps_b * scale_q
        dead_u = gamma_n <= eps_b * scale_p
        beta_n = torch.where(dead_v, 0.0, beta_n)
        gamma_n = torch.where(dead_u, 0.0, gamma_n)
        v_next = torch.where(_c(dead_v), 0.0, q / _c(_safe(beta_n)))
        u_next = torch.where(_c(dead_u), 0.0, p / _c(_safe(gamma_n)))

        # Block-LDLᵀ step on [I T; Tᵀ -I] in interleaved (x̄_i, ȳ_i) order:
        # diag blocks Ω_i=[1 α_i; α_i -1], coupling Ψ_{i-1}=[0 γ_i; β_i 0].
        # Λ_k = Ψ_{k-1}ᵀ Δ_{k-1}⁻¹, Δ_k = Ω_k - Λ_k Ψ_{k-1}.
        l00, l01 = beta * di10, beta * di11
        l10, l11 = gamma * di00, gamma * di01
        d00 = 1.0 - l01 * beta
        d01 = alpha - l00 * gamma
        d10 = alpha - l11 * beta
        d11 = -1.0 - l10 * gamma
        det = _safe(d00 * d11 - d01 * d10)
        n00, n01, n10, n11 = d11 / det, -d01 / det, -d10 / det, d00 / det
        # ζ_k = h - Λ_k ζ_{k-1}, h = (β₁, γ₁) on the first trip, else 0.
        z0 = -(l00 * zt0 + l01 * zt1)
        z1 = -(l10 * zt0 + l11 * zt1)
        if k == 0:
            z0, z1 = beta1 + z0, gamma1 + z1
        # Direction blocks G_k = P_k - G_{k-1} Λ_kᵀ with P_k = [v 0; 0 u].
        g1v_n = v - (g1v * _c(l00) + g2v * _c(l01))
        g1u_n = -(g1u * _c(l00) + g2u * _c(l01))
        g2v_n = -(g1v * _c(l10) + g2v * _c(l11))
        g2u_n = u - (g1u * _c(l10) + g2u * _c(l11))
        t0 = n00 * z0 + n01 * z1                 # last block of w̄
        t1 = n10 * z0 + n11 * z1
        x = x + _c(t0) * g1v_n + _c(t1) * g2v_n
        y = y + _c(t0) * g1u_n + _c(t1) * g2u_n
        # Residual lies in span{Mv_{k+1}, Nu_{k+1}}:
        # ‖r‖ over diag(M⁻¹,N⁻¹) = hypot(β_{k+1}·ȳ_k, γ_{k+1}·x̄_k).
        rnorm = torch.sqrt((beta_n * t1) ** 2 + (gamma_n * t0) ** 2)
        return (x, y, v, v_next, u, u_next, beta_n, gamma_n, n00, n01, n10,
                n11, z0, z1, g1v_n, g1u_n, g2v_n, g2u_n, rnorm)

    out = _masked_while(cond, body, carry0, maxiter)
    return out[0], out[1]


def lsqr(matvec: Callable, rmatvec: Callable, b: torch.Tensor, n: int,
         rtol, maxiter: int) -> torch.Tensor:
    """LSQR (Paige & Saunders 1982): Golub-Kahan bidiagonalization solve of
    ``min ||A x - b||``. Stops on the least-squares optimality estimate
    ``||A'r|| <= rtol * ||A'b||``."""
    beta = _norm(b)
    u = b / _c(_safe(beta))
    v = rmatvec(u)
    alfa = _norm(v)
    v = v / _c(_safe(alfa))
    # ||A'b|| = alfa * beta
    tol = rtol * _safe(alfa * beta)
    # carry: x, u, v, w, alfa, phibar, rhobar, atrnorm
    carry0 = (b.new_zeros(b.shape[:-1] + (n,)), u, v, v, alfa, beta, alfa,
              alfa * beta)

    def cond(c):
        return c[-1] > tol

    def body(c, k):
        x, u, v, w, alfa, phibar, rhobar, _ = c
        u = matvec(v) - _c(alfa) * u
        beta = _norm(u)
        u = u / _c(_safe(beta))
        v_new = rmatvec(u) - _c(beta) * v
        alfa_new = _norm(v_new)
        v_new = v_new / _c(_safe(alfa_new))

        rho = torch.sqrt(rhobar * rhobar + beta * beta)
        rho_safe = _safe(rho)
        cs = rhobar / rho_safe
        sn = beta / rho_safe
        theta = sn * alfa_new
        rhobar_new = -cs * alfa_new
        phi = cs * phibar
        phibar_new = sn * phibar

        x = x + _c(phi / rho_safe) * w
        w = v_new - _c(theta / rho_safe) * w
        # ||A'r_k|| = phibar_{k+1} * alfa_{k+1} * |c_k| (Paige & Saunders
        # 1982, eq. 5.2).
        atrnorm = phibar_new * alfa_new * cs.abs()
        return (x, u, v_new, w, alfa_new, phibar_new, rhobar_new, atrnorm)

    return _masked_while(cond, body, carry0, maxiter)[0]


def lsmr(matvec: Callable, rmatvec: Callable, b: torch.Tensor, n: int,
         rtol, maxiter: int) -> torch.Tensor:
    """LSMR (Fong & Saunders 2011): MINRES applied to the normal equations
    through Golub-Kahan bidiagonalization; ``||A'r_k||`` decreases
    monotonically and is tracked exactly by ``zetabar``."""
    beta = _norm(b)
    u = b / _c(_safe(beta))
    v = rmatvec(u)
    alfa = _norm(v)
    v = v / _c(_safe(alfa))

    zetabar = alfa * beta
    one = torch.ones_like(alfa)
    tol = rtol * _safe(zetabar)   # ||A'b||
    zn = b.new_zeros(b.shape[:-1] + (n,))
    # carry: x, u, v, h, hbar, alfa, alfabar, rho, rhobar, cbar, sbar,
    #        zetabar, |zetabar|
    carry0 = (zn, u, v, v, zn, alfa, alfa, one, one, one,
              torch.zeros_like(alfa), zetabar, zetabar.abs())

    def cond(c):
        return c[-1] > tol

    def body(c, k):
        (x, u, v, h, hbar, alfa, alfabar, rho, rhobar, cbar, sbar, zetabar,
         _) = c
        u = matvec(v) - _c(alfa) * u
        beta = _norm(u)
        u = u / _c(_safe(beta))
        v_new = rmatvec(u) - _c(beta) * v
        alfa_new = _norm(v_new)
        v_new = v_new / _c(_safe(alfa_new))

        # First rotation (as in LSQR).
        rho_new = torch.sqrt(alfabar * alfabar + beta * beta)
        rho_new_safe = _safe(rho_new)
        c1 = alfabar / rho_new_safe
        s1 = beta / rho_new_safe
        theta_new = s1 * alfa_new
        alfabar_new = c1 * alfa_new

        # Second rotation (the MINRES part).
        thetabar = sbar * rho_new
        rhotemp = cbar * rho_new
        rhobar_new = torch.sqrt(rhotemp * rhotemp + theta_new * theta_new)
        rhobar_new_safe = _safe(rhobar_new)
        cbar_new = rhotemp / rhobar_new_safe
        sbar_new = theta_new / rhobar_new_safe
        zeta = cbar_new * zetabar
        zetabar_new = -sbar_new * zetabar

        hbar = h - _c(thetabar * rho_new / _safe(rho * rhobar)) * hbar
        x = x + _c(zeta / _safe(rho_new * rhobar_new)) * hbar
        h = v_new - _c(theta_new / rho_new_safe) * h

        return (x, u, v_new, h, hbar, alfa_new, alfabar_new, rho_new,
                rhobar_new, cbar_new, sbar_new, zetabar_new,
                zetabar_new.abs())

    return _masked_while(cond, body, carry0, maxiter)[0]


def craig(matvec: Callable, rmatvec: Callable, b: torch.Tensor, nw: int,
          rtol, maxiter: int) -> torch.Tensor:
    """CRAIG (Paige 1974): minimum-norm solution of the CONSISTENT
    underdetermined system ``A w = b`` via Golub-Kahan bidiagonalization
    (mathematically CG on ``A Aᵀ y = b`` with ``w = Aᵀ y``). Also the CG
    transfer point of LNLQ (Estrin, Orban & Saunders 2019). Residual norm
    ``||b - A w_k|| = |β_{k+1} ζ_k|`` is tracked exactly; stops at
    ``rtol * ||b||``. The reference's counter starts at 1, so at most
    ``maxiter - 1`` trips run; ``nw``, the length of w, is implied by
    ``rmatvec``, as in the reference."""
    beta1 = _norm(b)
    u = b / _c(_safe(beta1))
    v = rmatvec(u)
    alfa = _norm(v)
    v = v / _c(_safe(alfa))
    zeta = beta1 / _safe(alfa)
    tol = rtol * _safe(beta1)
    # carry: w, u, v, alfa, zeta, rnorm
    carry0 = (_c(zeta) * v, u, v, alfa, zeta, beta1.abs())

    def cond(c):
        return c[-1] > tol

    def body(c, k):
        w, u, v, alfa, zeta, _ = c
        u_new = matvec(v) - _c(alfa) * u
        beta = _norm(u_new)
        u_new = u_new / _c(_safe(beta))
        v_new = rmatvec(u_new) - _c(beta) * v
        alfa_new = _norm(v_new)
        v_new = v_new / _c(_safe(alfa_new))
        rnorm = (beta * zeta).abs()             # ||b - A w_k||
        zeta_new = -(beta / _safe(alfa_new)) * zeta
        w = w + _c(zeta_new) * v_new
        return (w, u_new, v_new, alfa_new, zeta_new, rnorm)

    return _masked_while(cond, body, carry0, maxiter - 1)[0]


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------

def _k2_mv(A, theta_reg, regD, n):
    """The raw augmented operator [-(Θ⁻¹+Rp) Aᵀ; A Rd] over (wx, wy)."""
    def K2_mv(w):
        wx, wy = w[..., :n], w[..., n:]
        top = -theta_reg * wx + bmtv(A, wy)
        bot = bmv(A, wx) + regD * wy
        return torch.cat([top, bot], dim=-1)
    return K2_mv


@dataclasses.dataclass(frozen=True)
class CgK1Backend(KKTBackend):
    name = "cg"
    systems = ("K1",)
    # Matrix-free: satisfies the Jacobi-weighted residual criterion, not
    # the kit's uniform relative gate; validated end-to-end at the
    # reference's measured achievable tolerances
    # (tests/test_torch_krylov_golden.py).
    sweep_resid_atol = None
    rtol: float = 0.0        # 0 -> sqrt(eps(dtype))
    maxiter_factor: int = 10  # maxiter = factor * m

    def linear_system(self) -> str:
        return "Normal equations (K1), CG"

    def setup(self, A: torch.Tensor) -> KrylovState:
        B, m, n = A.shape
        kw = dict(dtype=A.dtype, device=A.device)
        return KrylovState(A=A, d=torch.ones(B, n, **kw),
                           theta_reg=torch.ones(B, n, **kw),
                           regD=torch.ones(B, m, **kw))

    def update(self, state: KrylovState, theta_inv, regP, regD):
        theta_reg = theta_inv + regP
        new = KrylovState(A=state.A, d=1.0 / theta_reg, theta_reg=theta_reg,
                          regD=regD)
        ok = (theta_reg > 0).all(-1) & (regD > 0).all(-1)
        return new, ok

    def _base_solve(self, state: KrylovState, xi_p, xi_d):
        A, d, regD = state.A, state.d, state.regD
        rtol = self.rtol or _sqrt_eps(A.dtype)
        maxiter = self.maxiter_factor * A.shape[-2]

        def K_mv(w):
            return bmv(A, d * bmtv(A, w)) + regD * w

        # Jacobi preconditioner: diag(A D Aᵀ) + Rd.
        Kdiag = bmv(A * A, d) + regD
        rhs = xi_p + bmv(A, d * xi_d)
        dy = pcg(K_mv, rhs, lambda r: r / Kdiag, rtol, maxiter)
        dx = d * (bmtv(A, dy) - xi_d)
        return dx, dy

    def solve(self, state, xi_p, xi_d):
        dx, dy = self._base_solve(state, xi_p, xi_d)
        return self._refine(state, xi_p, xi_d, dx, dy, self._base_solve)


@dataclasses.dataclass(frozen=True)
class CrK1Backend(CgK1Backend):
    """Conjugate residuals on the K1 normal equations."""

    name = "cr"

    def linear_system(self) -> str:
        return "Normal equations (K1), CR"

    def _base_solve(self, state: KrylovState, xi_p, xi_d):
        A, d, regD = state.A, state.d, state.regD
        rtol = self.rtol or _sqrt_eps(A.dtype)
        maxiter = self.maxiter_factor * A.shape[-2]

        def K_mv(w):
            return bmv(A, d * bmtv(A, w)) + regD * w

        Kdiag = bmv(A * A, d) + regD
        rhs = xi_p + bmv(A, d * xi_d)
        dy = cr(K_mv, rhs, lambda r: r / Kdiag, rtol, maxiter)
        dx = d * (bmtv(A, dy) - xi_d)
        return dx, dy


@dataclasses.dataclass(frozen=True)
class MinresK2Backend(KKTBackend):
    """Unpreconditioned MINRES on the raw K2 augmented system (reference
    parity: the reference's SID Krylov solvers are also unpreconditioned,
    src/KKT/Krylov/sid.jl:50-64). Achievable end-to-end tolerance is
    ~1e-6 (the reference's golden-LP measurement): late-IPM K2 carries
    Θ⁻¹ entries up to ~1e16 and the unscaled residual test cannot deliver
    accurate dx components past that. For full 1e-8 use "sqd-minres" (the
    same method under the natural SQD diagonal scaling) or "minres-qlp"."""

    name = "minres"
    systems = ("K2",)
    sweep_resid_atol = None   # matrix-free; see CgK1Backend
    rtol: float = 0.0
    maxiter_factor: int = 10

    def linear_system(self) -> str:
        return "Augmented system (K2), MINRES"

    setup = CgK1Backend.setup
    update = CgK1Backend.update

    def _krylov(self):
        return minres

    def _base_solve(self, state: KrylovState, xi_p, xi_d):
        A, theta_reg, regD = state.A, state.theta_reg, state.regD
        m, n = A.shape[-2:]
        rtol = self.rtol or _sqrt_eps(A.dtype)
        maxiter = self.maxiter_factor * (m + n)
        rhs = torch.cat([xi_d, xi_p], dim=-1)
        sol = self._krylov()(_k2_mv(A, theta_reg, regD, n), rhs, rtol,
                             maxiter)
        return sol[..., :n], sol[..., n:]

    def solve(self, state, xi_p, xi_d):
        dx, dy = self._base_solve(state, xi_p, xi_d)
        return self._refine(state, xi_p, xi_d, dx, dy, self._base_solve)


@dataclasses.dataclass(frozen=True)
class TricgK2Backend(KKTBackend):
    """TriCG on the SQD augmented system (the reference's TriCG/TriMR
    family, reference: src/KKT/Krylov/sqd.jl:87-92). The K2 system

        [-(Θ⁻¹+Rp)  Aᵀ] [dx]   [ξd]
        [    A      Rd] [dy] = [ξp]

    reordered as [Rd A; Aᵀ -(Θ⁻¹+Rp)][dy; dx] = [ξp; ξd] is exactly the
    TriCG form with M = Rd, N = Θ⁻¹+Rp — the same natural diagonal
    preconditioners the reference passes to Krylov.jl (sqd.jl:90-91)."""

    name = "tricg"
    sweep_resid_atol = None   # matrix-free; see CgK1Backend
    systems = ("K2",)
    rtol: float = 0.0
    maxiter_factor: int = 10
    # Experimental (see the module docstring): controls the N⁻¹-weighted
    # residual, but the unweighted dual residual degrades at late-IPM Θ
    # spans; prefer sqd-minres for full solves.
    experimental = True

    def linear_system(self) -> str:
        return "Augmented system (K2), TriCG"

    setup = CgK1Backend.setup
    update = CgK1Backend.update

    def _base_solve(self, state: KrylovState, xi_p, xi_d):
        A, theta_reg, regD = state.A, state.theta_reg, state.regD
        rtol = self.rtol or _sqrt_eps(A.dtype)
        maxiter = self.maxiter_factor * sum(A.shape[-2:])
        dy, dx = tricg(A, regD, theta_reg, xi_p, xi_d, rtol, maxiter)
        return dx, dy

    def solve(self, state, xi_p, xi_d):
        dx, dy = self._base_solve(state, xi_p, xi_d)
        return self._refine(state, xi_p, xi_d, dx, dy, self._base_solve)


@dataclasses.dataclass(frozen=True)
class SqdMinresK2Backend(MinresK2Backend):
    """Minimum-residual method on the SQD augmented system with the natural
    block-Jacobi preconditioner (the TriMR role of the reference's SQD
    family): symmetrically scale K2 by diag(Θ⁻¹+Rp, Rd)^(-1/2) so the
    scaled operator is [-I Â; Âᵀ I], then run MINRES and unscale."""

    name = "sqd-minres"

    def linear_system(self) -> str:
        return "Augmented system (K2), SQD-scaled MINRES"

    def _base_solve(self, state: KrylovState, xi_p, xi_d):
        A, theta_reg, regD = state.A, state.theta_reg, state.regD
        m, n = A.shape[-2:]
        rtol = self.rtol or _sqrt_eps(A.dtype)
        maxiter = self.maxiter_factor * (m + n)
        f = torch.sqrt(theta_reg)        # F = (Θ⁻¹+Rp)^(1/2)
        e = torch.sqrt(regD)             # E = Rd^(1/2)

        def K2_mv(w):
            wx, wy = w[..., :n], w[..., n:]
            top = -wx + bmtv(A, wy / e) / f
            bot = bmv(A, wx / f) / e + wy
            return torch.cat([top, bot], dim=-1)

        rhs = torch.cat([xi_d / f, xi_p / e], dim=-1)
        sol = minres(K2_mv, rhs, rtol, maxiter)
        return sol[..., :n] / f, sol[..., n:] / e


@dataclasses.dataclass(frozen=True)
class SymmlqK2Backend(MinresK2Backend):
    """SYMMLQ on the augmented system (the reference's SID family also
    exposes SYMMLQ, reference: src/KKT/Krylov/defs.jl:9-17). Galerkin
    (minimum-error) counterpart of MINRES; kept as a conformance/fallback
    option — it spends one extra operator application per iteration on
    true-residual stopping. Achievable end-to-end tolerance ~1e-4 (the
    reference's golden-LP measurement)."""

    name = "symmlq"

    def linear_system(self) -> str:
        return "Augmented system (K2), SYMMLQ"

    def _krylov(self):
        return symmlq


@dataclasses.dataclass(frozen=True)
class CarK1Backend(CgK1Backend):
    """CAR on the K1 normal equations (reference SPD family:
    src/KKT/Krylov/defs.jl:1-5). Minimizes the K-norm of the residual;
    Jacobi preconditioning applied as a symmetric diagonal scaling so the
    scaled operator stays SPD."""

    name = "car"

    def linear_system(self) -> str:
        return "Normal equations (K1), CAR"

    def _base_solve(self, state: KrylovState, xi_p, xi_d):
        A, d, regD = state.A, state.d, state.regD
        rtol = self.rtol or _sqrt_eps(A.dtype)
        maxiter = self.maxiter_factor * A.shape[-2]

        # Symmetric Jacobi scaling: solve S K S (S⁻¹dy) = S rhs with
        # S = diag(K)^(-1/2), keeping the operator SPD for CAR.
        Kdiag = bmv(A * A, d) + regD
        s = 1.0 / torch.sqrt(Kdiag)

        def K_mv(w):
            return s * bmv(A, d * bmtv(A, s * w)) + s * regD * (s * w)

        rhs = s * (xi_p + bmv(A, d * xi_d))
        dy = s * car(K_mv, rhs, None, rtol, maxiter)
        dx = d * (bmtv(A, dy) - xi_d)
        return dx, dy


@dataclasses.dataclass(frozen=True)
class MinresQlpK2Backend(MinresK2Backend):
    """MINRES-QLP on the augmented system (reference SID family:
    src/KKT/Krylov/defs.jl:9-17). Extra right-side QLP reflections keep
    the iterate update well-conditioned when the (regularized) system
    approaches numerical singularity near IPM convergence, and yield the
    minimum-length solution on singular consistent systems."""

    name = "minres-qlp"

    def linear_system(self) -> str:
        return "Augmented system (K2), MINRES-QLP"

    def _krylov(self):
        return minres_qlp


@dataclasses.dataclass(frozen=True)
class MinaresK2Backend(MinresK2Backend):
    """‖Ar‖-minimizing method on the augmented system (the MINARES role of
    the reference SID family, src/KKT/Krylov/defs.jl:9-17; Montoison,
    Orban & Saunders 2023). Implemented as conjugate residuals on the
    squared operator — K² is SPD for symmetric nonsingular K, and the CR
    residual of K²x = Kb is exactly K r, so the iterates minimize ‖K r‖
    over x ∈ K_k(K², Kb), two operator applications per iteration.

    EXPERIMENTAL (the reference's round-5 end-to-end finding): squaring
    the operator squares its condition number; with late-IPM κ(K2) ~
    1e8-1e16 the squared system is numerically intractable in f64, and
    golden-LP solves stall at ITERATION_LIMIT even at 1e-4 tolerances.
    Passes the conformance kit on benign matrices only — same class as
    TriCG."""

    name = "minares"
    experimental = True

    def linear_system(self) -> str:
        return "Augmented system (K2), MINARES (CR on K²)"

    def _base_solve(self, state: KrylovState, xi_p, xi_d):
        A, theta_reg, regD = state.A, state.theta_reg, state.regD
        m, n = A.shape[-2:]
        rtol = self.rtol or _sqrt_eps(A.dtype)
        maxiter = self.maxiter_factor * (m + n)
        K2_mv = _k2_mv(A, theta_reg, regD, n)

        def K2sq_mv(w):
            return K2_mv(K2_mv(w))

        rhs = torch.cat([xi_d, xi_p], dim=-1)
        sol = cr(K2sq_mv, K2_mv(rhs), lambda r: r, rtol, maxiter)
        return sol[..., :n], sol[..., n:]


@dataclasses.dataclass(frozen=True)
class LsqrK1Backend(KKTBackend):
    """LSQR on the damped least-squares formulation of K1 (the reference's
    LS family, reference: src/KKT/Krylov/defs.jl:25-29). The normal
    equations ``(A E⁻¹ Aᵀ + F) dy = ξp + A E⁻¹ ξd`` with E = Θ⁻¹+Rp,
    F = Rd are the optimality conditions of

        min_dy || [E^(-1/2) Aᵀ; F^(1/2)] dy - [E^(-1/2) ξd; F^(-1/2) ξp] ||

    which LSQR solves via Golub-Kahan bidiagonalization — never forming
    A E⁻¹ Aᵀ and with better conditioning (κ(Ā) = √κ(K1))."""

    name = "lsqr"
    sweep_resid_atol = None   # matrix-free; see CgK1Backend
    systems = ("K1",)
    rtol: float = 0.0
    maxiter_factor: int = 10

    def linear_system(self) -> str:
        return "Normal equations (K1), LSQR on the damped LS form"

    setup = CgK1Backend.setup
    update = CgK1Backend.update

    def _ls_solver(self):
        return lsqr

    def _base_solve(self, state: KrylovState, xi_p, xi_d):
        A, theta_reg, regD = state.A, state.theta_reg, state.regD
        m, n = A.shape[-2:]
        rtol = self.rtol or _sqrt_eps(A.dtype)
        maxiter = self.maxiter_factor * m
        e_isqrt = 1.0 / torch.sqrt(theta_reg)   # E^(-1/2)
        f_sqrt = torch.sqrt(regD)               # F^(1/2)

        def mv(dy):                             # Ā dy, stacked (n + m)
            return torch.cat([e_isqrt * bmtv(A, dy), f_sqrt * dy], dim=-1)

        def rmv(r):                             # Āᵀ r
            return bmv(A, e_isqrt * r[..., :n]) + f_sqrt * r[..., n:]

        bbar = torch.cat([e_isqrt * xi_d, xi_p / f_sqrt], dim=-1)
        dy = self._ls_solver()(mv, rmv, bbar, m, rtol, maxiter)
        dx = (bmtv(A, dy) - xi_d) / theta_reg
        return dx, dy

    def solve(self, state, xi_p, xi_d):
        dx, dy = self._base_solve(state, xi_p, xi_d)
        return self._refine(state, xi_p, xi_d, dx, dy, self._base_solve)


@dataclasses.dataclass(frozen=True)
class LsmrK1Backend(LsqrK1Backend):
    """LSMR variant of :class:`LsqrK1Backend` (min-residual on the normal
    equations; ``||Ā'r||`` decreases monotonically — the safer choice when
    stopping early)."""

    name = "lsmr"

    def linear_system(self) -> str:
        return "Normal equations (K1), LSMR on the damped LS form"

    def _ls_solver(self):
        return lsmr


@dataclasses.dataclass(frozen=True)
class CraigK1Backend(LsqrK1Backend):
    """CRAIG/LNLQ on the least-norm formulation of K1 (the reference's LN
    family, reference: src/KKT/Krylov/defs.jl:19-23). With
    ``Â = [A E^(-1/2)  F^(1/2)]`` (full row rank since F = Rd > 0, so the
    system is always consistent) the minimum-norm problem

        min ||w||  s.t.  Â w = ξp + A E⁻¹ ξd

    has solution ``w = Âᵀ dy`` where ``(A E⁻¹ Aᵀ + F) dy = ξ̄`` is exactly
    K1 — and the second block of w recovers the K1 solution directly:
    ``dy = F^(-1/2) w₂``. Never forms A E⁻¹ Aᵀ; κ(Â) = √κ(K1) like the LS
    family."""

    name = "craig"

    def linear_system(self) -> str:
        return "Normal equations (K1), CRAIG on the least-norm form"

    def _base_solve(self, state: KrylovState, xi_p, xi_d):
        A, theta_reg, regD = state.A, state.theta_reg, state.regD
        m, n = A.shape[-2:]
        rtol = self.rtol or _sqrt_eps(A.dtype)
        maxiter = self.maxiter_factor * m
        e_isqrt = 1.0 / torch.sqrt(theta_reg)   # E^(-1/2)
        f_sqrt = torch.sqrt(regD)               # F^(1/2)

        def mv(w):                               # Â w, m-vector
            return bmv(A, e_isqrt * w[..., :n]) + f_sqrt * w[..., n:]

        def rmv(u):                              # Âᵀ u, (n + m)-vector
            return torch.cat([e_isqrt * bmtv(A, u), f_sqrt * u], dim=-1)

        bbar = xi_p + bmv(A, xi_d / theta_reg)
        w = craig(mv, rmv, bbar, n + m, rtol, maxiter)
        dy = w[..., n:] / f_sqrt
        dx = (bmtv(A, dy) - xi_d) / theta_reg
        return dx, dy


@dataclasses.dataclass(frozen=True)
class CraigmrK1Backend(CraigK1Backend):
    """CRAIGMR role of the LN family: minimum-RESIDUAL iterates on the same
    least-norm system — MINRES applied to the SPD operator
    ``Â Âᵀ = A E⁻¹ Aᵀ + F`` in factored (Gram-free) form, with ``dy`` read
    off directly. Monotone residual decrease makes it the safer LN choice
    when stopping early, mirroring LSMR's role in the LS family."""

    name = "craigmr"

    def linear_system(self) -> str:
        return "Normal equations (K1), CRAIGMR (min-residual least-norm)"

    def _base_solve(self, state: KrylovState, xi_p, xi_d):
        A, theta_reg, regD = state.A, state.theta_reg, state.regD
        m = A.shape[-2]
        rtol = self.rtol or _sqrt_eps(A.dtype)
        maxiter = self.maxiter_factor * m

        def op(y):                               # (A E⁻¹ Aᵀ + F) y, Gram-free
            return bmv(A, bmtv(A, y) / theta_reg) + regD * y

        bbar = xi_p + bmv(A, xi_d / theta_reg)
        dy = minres(op, bbar, rtol, maxiter)
        dx = (bmtv(A, dy) - xi_d) / theta_reg
        return dx, dy
