"""Distributed Schur-complement K1 backend for block-angular LPs (``"schur"``).

Counterpart of ``tulip_tpu/kkt/schur.py``; see its docstring for the
elimination. Per scenario k, with D = (Θ⁻¹+Rp)⁻¹ split as D0/Dk and Rd
as Rd0/Rdk, Mk = Wk Dk Wkᵀ + Rdk is factored locally and the first
stage solves

    S dx0 = A0ᵀ Rd0⁻¹ ξp0 − ξd0 + Σk Tkᵀ Mk⁻¹ rk,
    S = D0⁻¹ + Σk Tkᵀ Mk⁻¹ Tk + A0ᵀ Rd0⁻¹ A0,  rk = ξpk + Wk Dk ξdk.

Batch-first: A0 (B, m0, n0), T (B, Kl, mk, n0), W (B, Kl, mk, nk), where
Kl is the count of scenarios this process holds (all K with one process).
The flat vectors (Θ⁻¹, regularizations, right-hand sides, dx, dy) are
whole on every process; each reads its own scenarios' segments.

The reference's two ``Σk`` become explicit calls on the state's
:class:`~tulip_tpu_torch.parallel.comm.Comm` (GSPMD inserts them there):

- ``update``: one all-reduce of the n0×n0 Schur matrix G
  (``schur_reduce`` in the call record's counters), and one AND of the
  per-lane factorization flag (``factor_ok``). The reference's ``ok_k``
  reduces over the whole scenario axis; without the AND one process would
  bump its regularization and another would not, and they would part
  ways.
- ``solve``: one all-reduce of an n0-vector per base solve
  (``solve_reduce``) and per refinement residual (``aty_reduce``), and
  one gather of the scenario blocks of dx and dy at the end
  (``solve_gather``: K·(mk + nk) elements, the largest collective from
  K = n0²/(mk + nk) on). Refinement runs on this process's blocks only.

Everything outside the scenario blocks is computed from the same inputs
by the same operations on every process, so the replicated state stays
equal bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import torch

from .base import KKTBackend, bmtv, bmv


class SchurState(NamedTuple):
    # Constant blocks (the data's own tensors, passed through every update)
    A0: torch.Tensor         # (B, m0, n0)
    T: torch.Tensor          # (B, Kl, mk, n0)
    W: torch.Tensor          # (B, Kl, mk, nk)
    # Per-update quantities
    d0: torch.Tensor         # (B, n0)      D0 diagonal
    dk: torch.Tensor         # (B, Kl, nk)  Dk of the held scenarios
    theta_reg: torch.Tensor  # (B, n)       flat Θ⁻¹+Rp (refinement residuals)
    regD0: torch.Tensor      # (B, m0)
    regDk: torch.Tensor      # (B, Kl, mk)
    Lk: torch.Tensor         # (B, Kl, mk, mk) Cholesky factors of Mk
    Ls: torch.Tensor         # (B, n0, n0)     Cholesky factor of S
    comm: Any                # parallel.comm.Comm of the scenario axis


def segments(v: torch.Tensor, off: int, width: int, Kl: int,
             rank: int) -> torch.Tensor:
    """The blocks of flat ``v`` (B, off + K·width) that belong to this
    process's ``Kl`` scenarios (rank ``rank``'s contiguous share):
    (B, Kl, width)."""
    lo = off + rank * Kl * width
    return v[:, lo:lo + Kl * width].reshape(v.shape[0], Kl, width)


def ax_blocks(A0, T, W, x0, xk):
    """A·x by blocks: (A0 x0, Tk x0 + Wk xk for the held k)."""
    return (bmv(A0, x0),
            torch.einsum("bkij,bj->bki", T, x0) + bmv(W, xk))


def aty_blocks(A0, T, W, comm, y0, yk):
    """Aᵀ·y by blocks: (A0ᵀ y0 + Σk Tkᵀ yk summed over the group, Wkᵀ yk
    for the held k)."""
    return (bmtv(A0, y0)
            + comm.all_reduce_sum(torch.einsum("bkij,bki->bj", T, yk),
                                  name="aty_reduce"),
            bmtv(W, yk))


def block_matvec(A0, T, W, comm, x: torch.Tensor) -> torch.Tensor:
    """A·x of a block-angular A, (B, n) -> (B, m), whole on every rank."""
    B, Kl, mk, n0 = T.shape
    top, scen = ax_blocks(A0, T, W, x[:, :n0],
                          segments(x, n0, W.shape[-1], Kl, comm.rank))
    return torch.cat([top, comm.all_gather_blocks(
        scen, 1, name="ax_gather").reshape(B, -1)], -1)


def block_rmatvec(A0, T, W, comm, y: torch.Tensor) -> torch.Tensor:
    """Aᵀ·y of a block-angular A, (B, m) -> (B, n), whole on every rank."""
    B, Kl, mk, _ = T.shape
    m0 = A0.shape[-2]
    top, scen = aty_blocks(A0, T, W, comm, y[:, :m0],
                           segments(y, m0, mk, Kl, comm.rank))
    return torch.cat([top, comm.all_gather_blocks(
        scen, 1, name="aty_gather").reshape(B, -1)], -1)


def _cho_solve(L: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """M X = rhs with M = L Lᵀ, batched over every leading axis; ``rhs``
    is a vector per factor or a matrix."""
    vec = rhs.dim() == L.dim() - 1
    r = rhs.unsqueeze(-1) if vec else rhs
    w = torch.linalg.solve_triangular(L, r, upper=False)
    out = torch.linalg.solve_triangular(L.mT, w, upper=True)
    return out.squeeze(-1) if vec else out


def _factor(M: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Cholesky factor, per-lane flag that it is finite): the reference's
    ``jnp.all(jnp.isfinite(L))`` over every axis after the lane axis. A
    failed factorization is made non-finite first (``cholesky_ex`` leaves
    a partial factor and raises nothing)."""
    L, info = torch.linalg.cholesky_ex(M)
    L = L.masked_fill((info > 0)[(...,) + (None,) * 2], float("nan"))
    return L, torch.isfinite(L).flatten(1).all(-1)


@dataclasses.dataclass(frozen=True)
class SchurK1Backend(KKTBackend):
    """K1-style Schur-complement backend over block-angular data
    (``parallel.BlockAngularLPData``, sharded over its scenarios or not)."""

    name = "schur"
    systems = ("K1",)
    # A device program captures the pass; a Gloo group's collectives are
    # host operations of its script (ipm/graph.py, parallel/comm.py).
    device_loop = True
    lp_data_refusal = (
        "KKT backend 'schur' solves block-angular LPs only: build a "
        "BlockAngularLPData (tulip_tpu_torch.parallel.make_block_angular) "
        "and solve it with ipm.hsd_solve and kkt.SchurK1Backend; a Model "
        "holds a general LP")

    def linear_system(self) -> str:
        return "Block-angular Schur complement (K1)"

    def setup(self, A):
        raise TypeError(self.lp_data_refusal)

    def setup_data(self, dat) -> SchurState:
        B, Kl, mk, n0 = dat.T.shape
        m0, nk = dat.A0.shape[-2], dat.W.shape[-1]
        kw = dict(dtype=dat.c.dtype, device=dat.c.device)
        return SchurState(
            A0=dat.A0, T=dat.T, W=dat.W,
            d0=torch.ones(B, n0, **kw), dk=torch.ones(B, Kl, nk, **kw),
            theta_reg=torch.ones_like(dat.c),
            regD0=torch.ones(B, m0, **kw), regDk=torch.ones(B, Kl, mk, **kw),
            Lk=torch.eye(mk, **kw).expand(B, Kl, mk, mk).clone(),
            Ls=torch.eye(n0, **kw).expand(B, n0, n0).clone(),
            comm=dat.comm,
        )

    def update(self, state: SchurState, theta_inv, regP, regD,
               ) -> Tuple[SchurState, torch.Tensor]:
        A0, T, W, comm = state.A0, state.T, state.W, state.comm
        B, Kl, mk, n0 = T.shape
        m0, nk = A0.shape[-2], W.shape[-1]

        theta_reg = theta_inv + regP
        d0 = 1.0 / theta_reg[:, :n0]
        dk = 1.0 / segments(theta_reg, n0, nk, Kl, comm.rank)
        regD0 = regD[:, :m0]
        regDk = segments(regD, m0, mk, Kl, comm.rank)

        # Per-scenario Mk = Wk Dk Wkᵀ + Rdk and its Cholesky (local work);
        # the flag is ANDed over the group, as the reference's reduces over
        # the whole scenario axis.
        M = (W * dk.unsqueeze(-2)) @ W.mT + torch.diag_embed(regDk)
        Lk, ok_k = _factor(M)
        ok_k = comm.all_reduce_and(ok_k, name="factor_ok")
        eye_k = torch.eye(mk, dtype=M.dtype, device=M.device)
        Lk = torch.where(ok_k[:, None, None, None], Lk, eye_k)

        # G = Σk Zkᵀ Zk with Zk = Lk⁻¹ Tk: the local sum, then the one
        # n0×n0 all-reduce.
        Z = torch.linalg.solve_triangular(Lk, T, upper=False)
        Zf = Z.reshape(B, Kl * mk, n0)
        G = comm.all_reduce_sum(Zf.mT @ Zf, name="schur_reduce")

        # First-stage system S = D0⁻¹ + G + A0ᵀ Rd0⁻¹ A0 (replicated).
        S = (torch.diag_embed(1.0 / d0) + G
             + A0.mT @ (A0 / regD0.unsqueeze(-1)))
        Ls, ok_s = _factor(S)
        ok = ok_k & ok_s
        eye_0 = torch.eye(n0, dtype=S.dtype, device=S.device)
        Ls = torch.where(ok[:, None, None], Ls, eye_0)

        return (SchurState(A0=A0, T=T, W=W, d0=d0, dk=dk,
                           theta_reg=theta_reg, regD0=regD0, regDk=regDk,
                           Lk=Lk, Ls=Ls, comm=comm), ok)

    # -- solves on this process's blocks ------------------------------------
    @staticmethod
    def _split(state: SchurState, xi_p, xi_d):
        """(ξp0, ξpk, ξd0, ξdk): first-stage parts and held blocks."""
        B, Kl, mk, n0 = state.T.shape
        m0, nk, r = state.A0.shape[-2], state.W.shape[-1], state.comm.rank
        return (xi_p[:, :m0], segments(xi_p, m0, mk, Kl, r),
                xi_d[:, :n0], segments(xi_d, n0, nk, Kl, r))

    def _solve_blocks(self, state: SchurState, xp0, xpk, xd0, xdk):
        """(dx0, dxk, dy0, dyk) of one base solve, by blocks."""
        A0, T, W = state.A0, state.T, state.W

        # rk = ξpk + Wk Dk ξdk ; uk = Mk⁻¹ rk  (local per scenario).
        rk = xpk + bmv(W, state.dk * xdk)
        uk = _cho_solve(state.Lk, rk)

        # t = ξd0 − Σk Tkᵀ uk  (the n0-vector all-reduce).
        t = xd0 - state.comm.all_reduce_sum(
            torch.einsum("bkij,bki->bj", T, uk), name="solve_reduce")

        # First-stage solve (replicated).
        rhs0 = bmtv(A0, xp0 / state.regD0) - t
        w = torch.linalg.solve_triangular(state.Ls, rhs0.unsqueeze(-1),
                                          upper=False)
        dx0 = torch.linalg.solve_triangular(state.Ls.mT, w,
                                            upper=True).squeeze(-1)
        dy0 = (xp0 - bmv(A0, dx0)) / state.regD0

        # Back-substitute the held scenarios (local).
        Tdx0 = torch.einsum("bkij,bj->bki", T, dx0)
        dyk = uk - _cho_solve(state.Lk, Tdx0)
        dxk = state.dk * (bmtv(W, dyk) - xdk)
        return dx0, dxk, dy0, dyk

    def _residual_blocks(self, state: SchurState, rhs, sol):
        """(rp0, rpk, rd0, rdk): the augmented-system residuals of ``sol``
        against ``rhs`` by blocks, with the blocked operator."""
        xp0, xpk, xd0, xdk = rhs
        dx0, dxk, dy0, dyk = sol
        A0, T, W = state.A0, state.T, state.W
        B, Kl, mk, n0 = T.shape
        At_dy0, At_dyk = aty_blocks(A0, T, W, state.comm, dy0, dyk)
        A_dx0, A_dxk = ax_blocks(A0, T, W, dx0, dxk)
        th0 = state.theta_reg[:, :n0]
        thk = segments(state.theta_reg, n0, W.shape[-1], Kl, state.comm.rank)
        return (xp0 - (A_dx0 + state.regD0 * dy0),
                xpk - (A_dxk + state.regDk * dyk),
                xd0 - (-(th0 * dx0) + At_dy0),
                xdk - (-(thk * dxk) + At_dyk))

    def _assemble(self, state: SchurState, dx0, dxk, dy0, dyk):
        """Flat (dx, dy), whole on every process: one gather of the held
        blocks of both."""
        B, nk = dx0.shape[0], dxk.shape[-1]
        both = state.comm.all_gather_blocks(torch.cat([dxk, dyk], -1), 1,
                                            name="solve_gather")
        return (torch.cat([dx0, both[..., :nk].reshape(B, -1)], -1),
                torch.cat([dy0, both[..., nk:].reshape(B, -1)], -1))

    def _base_solve(self, state: SchurState, xi_p, xi_d):
        return self._assemble(state, *self._solve_blocks(
            state, *self._split(state, xi_p, xi_d)))

    def solve(self, state: SchurState, xi_p, xi_d):
        rhs = self._split(state, xi_p, xi_d)
        sol = self._solve_blocks(state, *rhs)
        for _ in range(self.refinement_steps):
            corr = self._solve_blocks(
                state, *self._residual_blocks(state, rhs, sol))
            sol = tuple(a + b for a, b in zip(sol, corr))
        return self._assemble(state, *sol)
