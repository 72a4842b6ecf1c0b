"""Dense-column splitting K1 backend (``"sparse-smw"``): tiled sparse
Cholesky on the sparse part + Sherman-Morrison-Woodbury for the dense
columns.

Counterpart of ``tulip_tpu/kkt/splitting.py``; see its docstring for the
design. With A = As + U eᵀ (U = the k dense columns)::

    K1 = As Θs Asᵀ + Rd  +  U Θd Uᵀ,
    K1⁻¹ r = B⁻¹r − V (Θd⁻¹ + Uᵀ V)⁻¹ Uᵀ B⁻¹ r,    V = B⁻¹ U,

where B = As Θs Asᵀ + Rd is factored by the tiled backend
(:class:`~.sparse.SparseK1Backend`, ``refinement_steps=0``), and the
refinement sweeps run here on the full operator: the dense A, or the
sparse-first ``SparseLPData`` through ``ipm.data.matvec`` / ``rmatvec``.

Batch-first contract as in :mod:`.sparse`: one LP as a batch of one. The
state's per-LP tensors (``V``, ``Lc``, ``theta_reg``, ``regD``) carry a
lane axis of 1; ``A``, ``U`` and ``dense_idx`` are constants of the setup
and are the same objects in every state derived from it. The k solves of
V = B⁻¹U (the reference's ``vmap``) run one after the other.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .base import KKTBackend, bmtv, bmv
from .dense import DenseK1Backend, DenseK1State
from .sparse import (SparseK1Backend, SparseK1LevelState, SparseK1State,
                     from_blocked, host_matrix, index_tensor, to_blocked)
from .sparse_ldl import dense_threshold


class SplitK1State(NamedTuple):
    inner: object             # tiled state of B = As Θs Asᵀ + Rd
    A: object                 # (1, m, n) FULL A, or the SparseLPData whose
                              # registered operators give A·x and Aᵀ·y
    U: torch.Tensor           # (1, m, k) the dense columns
    dense_idx: torch.Tensor   # (k,) int64 their column indices in A
    V: torch.Tensor           # (1, m, k) B⁻¹ U after update
    Lc: torch.Tensor          # (1, k, k) Cholesky factor of Θd⁻¹ + Uᵀ B⁻¹ U
    theta_reg: torch.Tensor   # (1, n) Θ⁻¹ + Rp
    regD: torch.Tensor        # (1, m)


_TILED = (SparseK1State, SparseK1LevelState)


@dataclasses.dataclass(frozen=True)
class SplitK1Backend(KKTBackend):
    """K1 via tiled sparse Cholesky + SMW dense-column correction."""

    name = "sparse-smw"
    systems = ("K1",)
    # update and solve read nothing on the host (KKTBackend.device_loop).
    device_loop = True
    block: int = 64
    # Forwarded to the inner tiled backend: "level" or "column".
    schedule: str = "level"
    host_A: Optional[np.ndarray] = dataclasses.field(
        default=None, compare=False, repr=False)

    def _inner(self) -> SparseK1Backend:
        # Refinement runs at THIS level on the full A; the inner backend's
        # tile solves are used raw.
        return SparseK1Backend(block=self.block, refinement_steps=0,
                               schedule=self.schedule)

    def _tiled(self) -> SparseK1Backend:
        """The plain tiled backend, for a state with no dense column."""
        return SparseK1Backend(schedule=self.schedule,
                               refinement_steps=self.refinement_steps)

    def _dense(self) -> DenseK1Backend:
        return DenseK1Backend(inv_factor=True,
                              refinement_steps=self.refinement_steps)

    def linear_system(self) -> str:
        return ("Normal equations (K1), tiled sparse Cholesky + "
                "SMW dense-column splitting")

    # -- host symbolic ----------------------------------------------------
    def setup_data(self, dat):
        """Sparse-first LP data: the dense columns were split out at the
        data level (A = As + U eᵀ, the tile plan on As); the inner level
        state comes from the compressed blocks and the ``SparseLPData``
        itself is the full operator."""
        from ..ipm.sparse_data import SparseLPData
        if not isinstance(dat, SparseLPData):
            return self.setup(dat.A)
        if dat.U.shape[-1] == 0:
            # No dense columns: the plain tiled path.
            return self._inner().setup_data(dat)
        inner = SparseK1Backend.setup_from_sparse_data(dat)
        return self._state(inner, dat, dat.U, dat.dense_idx, dat.c.shape[-1])

    def setup(self, A: torch.Tensor):
        A_np = host_matrix(self, A)
        m, n = A_np.shape
        colnnz = (np.abs(A_np) > 0).sum(axis=0)
        dense_idx = np.flatnonzero(colnnz >= dense_threshold(m))
        if dense_idx.size == 0 or dense_idx.size > max(64, 0.02 * n):
            # Nothing to split (or too much): the dense path.
            return self._dense().setup(A)
        As_np = A_np.copy()
        As_np[:, dense_idx] = 0.0
        inner = dataclasses.replace(self._inner(), host_A=As_np).setup(A)
        if not isinstance(inner, _TILED):
            return self._dense().setup(A)
        idx = index_tensor(dense_idx, A.device)
        return self._state(inner, A, A[:, :, idx], idx, n)

    @staticmethod
    def _state(inner, A, U, dense_idx, n) -> SplitK1State:
        """The state before the first update: V = 0, Lc = I."""
        _, m, k = U.shape
        kw = dict(dtype=U.dtype, device=U.device)
        return SplitK1State(
            inner=inner, A=A, U=U, dense_idx=dense_idx,
            V=torch.zeros(1, m, k, **kw),
            Lc=torch.eye(k, **kw)[None],
            theta_reg=torch.ones(1, n, **kw),
            regD=torch.ones(1, m, **kw))

    # -- full operator ----------------------------------------------------
    @staticmethod
    def _full_mv(Aor, x):
        if isinstance(Aor, torch.Tensor):
            return bmv(Aor, x)
        from ..ipm.data import matvec
        return matvec(Aor, x)

    @staticmethod
    def _full_rmv(Aor, y):
        if isinstance(Aor, torch.Tensor):
            return bmtv(Aor, y)
        from ..ipm.data import rmatvec
        return rmatvec(Aor, y)

    # -- device numeric ---------------------------------------------------
    def _bsolve(self, inner, r):
        """B⁻¹ r for one unbatched (m,) vector."""
        be = self._inner()
        nbr, B = inner.regD.shape[1:]
        y_b = be.solve_K_blocked(inner, to_blocked(inner.perm, nbr, B, r))
        return from_blocked(inner.perm, y_b)

    def update(self, state, theta_inv, regP, regD):
        if isinstance(state, DenseK1State):
            return self._dense().update(state, theta_inv, regP, regD)
        if isinstance(state, _TILED):
            return self._tiled().update(state, theta_inv, regP, regD)
        st = state
        theta_reg = theta_inv + regP
        # The zeroed dense columns of As contribute nothing to B whatever
        # their θ, so the inner backend takes the full vectors.
        inner, ok1 = self._inner().update(st.inner, theta_inv, regP, regD)
        U = st.U[0]
        V = torch.stack([self._bsolve(inner, U[:, j])
                         for j in range(U.shape[1])], dim=1)   # (m, k)
        # C = Θd⁻¹ + Uᵀ B⁻¹ U (SPD, (k, k)).
        C = torch.diag(theta_reg[0, st.dense_idx]) + U.T @ V
        Lc, info = torch.linalg.cholesky_ex(C)
        ok2 = (info == 0) & torch.isfinite(Lc).all()
        Lc = torch.where(ok2, Lc, torch.eye(Lc.shape[0], dtype=Lc.dtype,
                                            device=Lc.device))
        new = st._replace(inner=inner, V=V[None], Lc=Lc[None],
                          theta_reg=theta_reg, regD=regD)
        return new, ok1 & ok2.reshape(1)

    # -- solve ------------------------------------------------------------
    def _k1_solve(self, st: SplitK1State, r):
        """K1⁻¹ r for one unbatched (m,) vector, by SMW over B's factors."""
        t = self._bsolve(st.inner, r)
        Lc = st.Lc[0]
        w = torch.linalg.solve_triangular(Lc, (st.U[0].T @ t)[:, None],
                                          upper=False)
        w = torch.linalg.solve_triangular(Lc.T, w, upper=True)
        return t - (st.V[0] @ w)[:, 0]

    def _base_solve(self, state, xi_p, xi_d):
        if isinstance(state, DenseK1State):
            return self._dense()._base_solve(state, xi_p, xi_d)
        if isinstance(state, _TILED):
            return self._tiled()._base_solve(state, xi_p, xi_d)
        st = state
        d = 1.0 / st.theta_reg
        rhs = xi_p + self._full_mv(st.A, d * xi_d)
        dy = self._k1_solve(st, rhs[0])[None]
        dx = d * (self._full_rmv(st.A, dy) - xi_d)
        return dx, dy

    def solve(self, state, xi_p, xi_d):
        if isinstance(state, DenseK1State):
            return self._dense().solve(state, xi_p, xi_d)
        if isinstance(state, _TILED):
            return self._tiled().solve(state, xi_p, xi_d)
        st = state
        dx, dy = self._base_solve(st, xi_p, xi_d)
        # Refinement on the TRUE augmented system via the full operators.
        for _ in range(self.refinement_steps):
            rd = xi_d - (-(st.theta_reg * dx) + self._full_rmv(st.A, dy))
            rp = xi_p - (self._full_mv(st.A, dx) + st.regD * dy)
            ddx, ddy = self._base_solve(st, rp, rd)
            dx = dx + ddx
            dy = dy + ddy
        return dx, dy
