"""Banded K1 backend (``"banded"``): host symbolic analysis + blocked band
Cholesky.

Counterpart of ``tulip_tpu/kkt/banded.py``; see its docstring for the
design. ``rcm_bandwidth`` (the host symbolic phase) is a verbatim copy.
The numeric phase has both of the reference's schedules:

- ``"level"`` (the default): bandwidth-sized tiles through the sparse
  backend's level engine (:mod:`.sparse`, :mod:`.levels`);
- ``"scan"``: the block-tridiagonal Cholesky and its substitutions, the
  reference's ``lax.scan``s as plain Python loops over the blocks. The
  reference takes it where the level engine's gate rejects the plan.

It falls back to the dense inverse-factor backend where the reordered
bandwidth gives no advantage (2·bw ≥ m), as the reference does. The
batch-first contract and ``host_A`` are those of :mod:`.sparse`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .base import KKTBackend
from .dense import DenseK1Backend, DenseK1State
from .levels import cholesky_or_identity, solve_lower, solve_right_lower_t
from .sparse import (SparseK1Backend, SparseK1LevelState, from_blocked,
                     host_matrix, index_tensor, k1_level_plan, to_blocked)


def rcm_bandwidth(A: np.ndarray, use_native: bool = True,
                  ) -> Tuple[np.ndarray, int]:
    """Reverse Cuthill-McKee ordering of the K = A Aᵀ pattern.

    Returns (perm, bandwidth of P K Pᵀ). Prefers the native C++ engine
    (native/symbolic.cpp via kkt/native.py); falls back to scipy."""
    if use_native:
        from .native import rcm_native
        out = rcm_native(A)
        if out is not None:
            return out

    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    # int32 accumulator: with int8, >=128 shared columns overflows and can
    # wrap to exactly 0 (e.g. 512 ≡ 0 mod 256), silently erasing K entries
    # and mis-classifying dense matrices as banded.
    pattern = sp.csr_matrix((np.abs(A) > 0).astype(np.int32))
    Kpat = (pattern @ pattern.T).tocsr()
    perm = np.asarray(reverse_cuthill_mckee(Kpat, symmetric_mode=True))
    Kp = Kpat[perm][:, perm].tocoo()
    bw = int(np.max(np.abs(Kp.row - Kp.col))) if Kp.nnz else 0
    return perm, bw


class BandedK1State(NamedTuple):
    """Static plan + numeric factors. ``perm.shape[0]`` carries the true
    row count m (padded rows of Ap are zero; their pivots are identity).
    Per-LP tensors carry a leading lane axis of 1."""

    Ap: torch.Tensor         # (1, nb, bw, n) permuted + padded rows, blocked
    perm: torch.Tensor       # (m,) int64 row permutation
    d: torch.Tensor          # (1, n)
    theta_reg: torch.Tensor  # (1, n)
    regD: torch.Tensor       # (1, nb, bw) permuted + padded (1.0 on padding)
    L: torch.Tensor          # (1, nb, bw, bw) diagonal Cholesky blocks
    M: torch.Tensor          # (1, nb, bw, bw) subdiagonal factors (M[0] = 0)


@dataclasses.dataclass(frozen=True)
class BandedK1Backend(KKTBackend):
    """K1 via RCM-permuted block-tridiagonal Cholesky."""

    name = "banded"
    systems = ("K1",)
    # update and solve read nothing on the host (KKTBackend.device_loop).
    device_loop = True
    # The symbolic bandwidth is rounded up to a multiple of this.
    min_block: int = 64
    # "level": execute through the shared nested-dissection level engine
    # (kkt/levels.py via kkt/sparse.py). "scan": the sequential
    # block-tridiagonal loop.
    schedule: str = "level"
    host_A: Optional[np.ndarray] = dataclasses.field(
        default=None, compare=False, repr=False)

    def _dense(self) -> DenseK1Backend:
        return DenseK1Backend(inv_factor=True,
                              refinement_steps=self.refinement_steps)

    def _level(self, block: int) -> SparseK1Backend:
        return SparseK1Backend(block=block, schedule="level",
                               refinement_steps=self.refinement_steps)

    def linear_system(self) -> str:
        return "Normal equations (K1), RCM block-tridiagonal"

    # -- host symbolic ---------------------------------------------------
    def setup(self, A: torch.Tensor):
        A_np = host_matrix(self, A)
        m, n = A_np.shape
        perm, bw = rcm_bandwidth(A_np)
        bw_block = max(self.min_block,
                       -(-max(bw, 1) // self.min_block) * self.min_block)
        if 2 * bw_block >= m:
            return self._dense().setup(A)  # no banded advantage
        if self.schedule == "level":
            # Bandwidth-sized tiles through the shared level engine; the
            # gate may reject (tiny chains), then keep the scan path. (The
            # reference runs the sparse backend's whole setup here and
            # keeps its result only when it is a level state; this runs
            # only the level planner, which decides that.)
            level = self._level(min(bw_block, 128))
            lv = k1_level_plan(A_np, level.block)
            if lv is not None:
                return level.setup_level(A_np, lv, A.dtype, A.device)
        nb = -(-m // bw_block)
        Ap = np.zeros((nb * bw_block, n), dtype=A_np.dtype)
        Ap[:m] = A_np[perm]
        dt, dev = A.dtype, A.device
        return BandedK1State(
            Ap=torch.as_tensor(Ap.reshape(1, nb, bw_block, n), dtype=dt,
                               device=dev),
            perm=index_tensor(perm, dev),
            d=torch.ones(1, n, dtype=dt, device=dev),
            theta_reg=torch.ones(1, n, dtype=dt, device=dev),
            regD=torch.ones(1, nb, bw_block, dtype=dt, device=dev),
            L=torch.eye(bw_block, dtype=dt, device=dev).repeat(1, nb, 1, 1),
            M=torch.zeros(1, nb, bw_block, bw_block, dtype=dt, device=dev),
        )

    # -- device numeric --------------------------------------------------
    def update(self, state, theta_inv, regP, regD):
        if isinstance(state, DenseK1State):
            return self._dense().update(state, theta_inv, regP, regD)
        if isinstance(state, SparseK1LevelState):
            return self._level(self.min_block).update(
                state, theta_inv, regP, regD)
        st = state
        Ap = st.Ap[0]
        nb, bw, n = Ap.shape
        theta_reg = theta_inv + regP
        d = 1.0 / theta_reg
        regDb = to_blocked(st.perm, nb, bw, regD[0], pad=1.0)

        Ad = Ap * d[0]
        # Diagonal blocks D_i = A_i D A_iᵀ + diag(regD_i).
        D = Ad @ Ap.transpose(-1, -2) + torch.diag_embed(regDb)
        # Subdiagonal blocks E_i = A_i D A_{i-1}ᵀ (i >= 1).
        E = Ad[1:] @ Ap[:-1].transpose(-1, -2)

        L_prev, ok = cholesky_or_identity(D[0])
        Ls, Ms = [L_prev], [torch.zeros_like(L_prev)]
        for i in range(1, nb):
            Mi = solve_right_lower_t(L_prev, E[i - 1])   # E_i L_{i-1}⁻ᵀ
            # A non-finite M_i makes this factor fail too, so L_i is
            # already I wherever ok_i is false.
            Li, ok_i = cholesky_or_identity(D[i] - Mi @ Mi.T)
            Mi = torch.where(ok_i, Mi, torch.zeros_like(Mi))
            Ls.append(Li)
            Ms.append(Mi)
            ok = ok & ok_i
            L_prev = Li
        new = BandedK1State(Ap=st.Ap, perm=st.perm, d=d, theta_reg=theta_reg,
                            regD=regDb[None], L=torch.stack(Ls)[None],
                            M=torch.stack(Ms)[None])
        return new, ok.reshape(1)

    @staticmethod
    def _band_solve_K(st: BandedK1State, rhs_b):
        """(P K Pᵀ) y = rhs via block forward/backward substitution."""
        L, M = st.L[0], st.M[0]
        nb = L.shape[0]
        y = [solve_lower(L[0], rhs_b[0])]
        for i in range(1, nb):
            y.append(solve_lower(L[i], rhs_b[i] - M[i] @ y[-1]))
        x = [solve_lower(L[-1], y[-1], trans=True)]
        for i in reversed(range(nb - 1)):
            x.append(solve_lower(L[i], y[i] - M[i + 1].T @ x[-1],
                                 trans=True))
        return torch.stack(x[::-1])

    def _base_solve1(self, st: BandedK1State, xi_p, xi_d):
        Ap = st.Ap[0]
        nb, bw, n = Ap.shape
        d = st.d[0]
        rhs_b = to_blocked(st.perm, nb, bw, xi_p) + Ap @ (d * xi_d)
        y_b = self._band_solve_K(st, rhs_b)
        dx = d * (Ap.reshape(-1, n).T @ y_b.reshape(-1) - xi_d)
        return dx, from_blocked(st.perm, y_b)

    def _base_solve(self, state, xi_p, xi_d):
        if isinstance(state, DenseK1State):
            return self._dense()._base_solve(state, xi_p, xi_d)
        if isinstance(state, SparseK1LevelState):
            return self._level(self.min_block)._base_solve(state, xi_p,
                                                           xi_d)
        dx, dy = self._base_solve1(state, xi_p[0], xi_d[0])
        return dx[None], dy[None]

    def solve(self, state, xi_p, xi_d):
        if isinstance(state, DenseK1State):
            return self._dense().solve(state, xi_p, xi_d)
        if isinstance(state, SparseK1LevelState):
            return self._level(self.min_block).solve(state, xi_p, xi_d)
        st = state
        Ap = st.Ap[0]
        nb, bw, n = Ap.shape
        xi_p, xi_d = xi_p[0], xi_d[0]
        dx, dy = self._base_solve1(st, xi_p, xi_d)
        regD_unperm = from_blocked(st.perm, st.regD[0])
        theta_reg = st.theta_reg[0]
        for _ in range(self.refinement_steps):
            Adx = from_blocked(st.perm, Ap @ dx)
            ATdy = Ap.reshape(-1, n).T @ to_blocked(st.perm, nb, bw,
                                                    dy).reshape(-1)
            rp = xi_p - (Adx + regD_unperm * dy)
            rd = xi_d - (-(theta_reg * dx) + ATdy)
            ddx, ddy = self._base_solve1(st, rp, rd)
            dx = dx + ddx
            dy = dy + ddy
        return dx[None], dy[None]
