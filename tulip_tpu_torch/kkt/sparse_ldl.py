"""Tiled sparse K2 backend (``"sparse-ldl"``): host symbolic analysis +
signed blocked LDLᵀ of the quasi-definite augmented system.

Counterpart of ``tulip_tpu/kkt/sparse_ldl.py``; see its docstring for the
design (K2 is what survives dense columns of A: a dense column fills K1
completely, but in K2 it is one node that a dense-last ordering confines
to the trailing block). The host planners (``dense_threshold``,
``_k2_pattern_perm``, ``k2_tile_plan``, ``k2_level_plan``) are verbatim
copies; ``setup`` also precomputes the constant off-diagonal tile store
``T0`` on the host, once. The numeric phase has both of the reference's
schedules:

- ``"column"`` (the default): the RCM-ordered loop over block columns, as
  a Python loop (the reference's ``lax.fori_loop``): per block column the
  signed pivot factor U_j = [[Lp, 0], [-W, Ls]] from two masked SPD
  Choleskys and one triangular solve (``levels.signed_pivot``), the L
  tiles of the column as one batched product (or triangular solve), and
  the right-looking updates as one batched GEMM + ``index_add_``;
- ``"level"`` (opt-in; it loses digits against RCM on K2, see the
  reference's comment on ``schedule``): nested-dissection block order and
  ``levels.level_factor_signed``.

Both keep the reference's Jacobi scaling (S K2 S has a ±1 diagonal), its
two ``inv_factor`` modes (U_j⁻¹ stored, so that the L tiles and the
substitutions are products) and its refinement sweeps on the true
system, and fall back to the dense K2 backend (``"dense-ldl"``) where
``k2_tile_plan`` says that tiling gives no advantage: the reference's own
semantics.

``jnp.linalg.cholesky`` returns NaN where it fails; here
``torch.linalg.cholesky_ex``'s ``info`` says so, and ``ok`` stays a 0-d
device tensor, combined column by column without a host sync. The column
schedule's padded scatters land on a trailing dummy tile (and dummy block
row); the dummy tile is zeroed after the factorization, so that the
backward sweep's product of it with the zero dummy row stays exactly 0.

Batch-first contract (:mod:`.base`), as in :mod:`.sparse`: one LP as a
batch of one. Per-LP tensors of a state carry a leading lane axis of 1;
the plan's index tensors (``nodes``, the tile coordinates and the column
schedule) carry none. ``update`` returns ``ok`` as a (1,) flag. ``setup``
reads A on the host (``host_A`` when given).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .base import KKTBackend
from .dense_ldl import DenseK2Backend, DenseK2State
from .levels import (build_level_plan, level_bwd, level_factor_signed,
                     level_fwd, nd_block_order, segs_to, signed_pivot,
                     solve_lower, solve_right_lower_t, tile_fill)
from .sparse import host_matrix, index_tensor, symbolic_schedule


def dense_threshold(dim: int) -> float:
    """A column of A with >= this many nonzeros (out of ``dim``) counts as
    dense: it produces a ~nnz² clique of fill under elimination, which at
    40% of the dimension stops being 'sparse plus exceptions'."""
    return max(32.0, 0.4 * dim)


def _k2_pattern_perm(A_np: np.ndarray):
    """Shared host symbolic front end: K2 pattern + dense-last RCM node
    permutation. Returns (K2 csr pattern, perm0, N, n_dense)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    m, n = A_np.shape
    N = n + m
    Apat = sp.csr_matrix((np.abs(A_np) > 0).astype(np.int32))
    K2 = sp.bmat(
        [[sp.eye(n, dtype=np.int32, format="csr"), Apat.T],
         [Apat, sp.eye(m, dtype=np.int32, format="csr")]],
        format="csr")

    # Dense-node deferral: a column (row) of A touching a large fraction
    # of its dimension would explode RCM bandwidth and tile fill; order
    # such nodes last so their fill stays in the trailing block columns
    # (the CHOLMOD dense-row deferral, re-cast at node granularity).
    colnnz = Apat.getnnz(axis=0)
    rownnz = Apat.getnnz(axis=1)
    dense_x = np.flatnonzero(colnnz >= dense_threshold(m))
    dense_y = n + np.flatnonzero(rownnz >= dense_threshold(n))
    dense_nodes = np.concatenate([dense_x, dense_y])
    if len(dense_nodes) > 0.1 * N:
        dense_nodes = np.empty(0, np.int64)
    sparse_nodes = np.setdiff1d(np.arange(N), dense_nodes,
                                assume_unique=True)
    sub = K2[sparse_nodes][:, sparse_nodes].tocsr()
    psub = np.asarray(reverse_cuthill_mckee(sub, symmetric_mode=True))
    perm = np.concatenate([sparse_nodes[psub],
                           dense_nodes]).astype(np.int64)
    return K2, perm, N, len(dense_nodes)


def k2_tile_plan(A_np: np.ndarray, block: int, gate: float = 0.5):
    """Host symbolic phase for the augmented system (column schedule).

    Returns None if tiling gives no advantage, else a dict with the node
    permutation (dense-degree nodes last, RCM on the rest) and the padded
    static tile schedule."""
    m, n = A_np.shape
    K2, perm, N, _ = _k2_pattern_perm(A_np)

    # Within-tile x-first sort: reorder each B-lane tile so x nodes
    # (< n, pivot sign −1) precede y nodes (sign +1). Tile membership —
    # hence the tile-granular pattern and schedule — is unchanged, but
    # every pivot tile becomes [[−P, Bᵀ], [B, Q]] with a STATIC sign
    # split, which is what lets the signed blocked Cholesky below use
    # masked SPD Choleskys instead of explicit quasi-definite inverses.
    for j0 in range(0, N, block):
        tile = perm[j0:j0 + block]
        perm[j0:j0 + block] = tile[np.argsort(tile >= n, kind="stable")]

    nbr = -(-N // block)
    Kp = K2[perm][:, perm].tocoo()
    sched = symbolic_schedule(Kp.row // block, Kp.col // block, nbr, gate)
    if sched is None:
        return None
    sched["perm"] = perm
    sched["N"] = N
    return sched


def k2_level_plan(A_np: np.ndarray, block: int, gate: float = 0.5):
    """Host symbolic phase for the LEVEL-SCHEDULED augmented system.

    Like :func:`k2_tile_plan` but the block rows are re-ordered by nested
    dissection over the tile graph (dense-node block rows forced last), so
    the numeric factorization runs in O(log nb) batched levels instead of
    nb sequential block-column steps (kkt/levels.py).

    Returns None if tiling gives no advantage, else
    (nodes_np (nbr, B), LevelPlan, N).
    """
    m, n = A_np.shape
    B = block
    K2, perm0, N, n_dense = _k2_pattern_perm(A_np)
    nbr = -(-N // B)
    if nbr <= 2:
        return None

    # Lane layout in perm0 block order; padding lanes get unique ids >= N.
    ext_len = nbr * B
    node_ids = np.concatenate(
        [perm0, N + np.arange(ext_len - N)]).astype(np.int32)
    nodes0 = node_ids.reshape(nbr, B)

    # Tile pattern in perm0 block coordinates.
    Kp = K2[perm0][:, perm0].tocoo()
    bi0 = Kp.row // B
    bj0 = Kp.col // B
    # Dense nodes sit at the end of perm0: their block rows are forced to
    # eliminate last (the root separator in the level schedule).
    first_dense_block = (N - n_dense) // B if n_dense else nbr
    last_blocks = range(first_dense_block, nbr)
    order = nd_block_order(bi0, bj0, nbr, last=last_blocks)
    binv = np.empty(nbr, np.int64)
    binv[order] = np.arange(nbr)

    nodes_np = nodes0[order]
    # Within-tile x-first sort (see k2_tile_plan): padding ids >= N sort
    # with the y/+1 group, which is what their identity pivots need.
    for j in range(nbr):
        lane = nodes_np[j]
        nodes_np[j] = lane[np.argsort(lane >= n, kind="stable")]

    col_rows = tile_fill(binv[bi0], binv[bj0], nbr)
    ntiles = nbr + sum(len(c) for c in col_rows)
    if ntiles >= gate * (nbr * (nbr + 1) // 2):
        return None
    return nodes_np, build_level_plan(col_rows, nbr), N




def _constant_tiles(A_np: np.ndarray, nodes_np: np.ndarray, N: int,
                    tile_brow, tile_bcol, ntiles: int) -> np.ndarray:
    """The A part of every K2 tile, (ntiles, B, B), which never changes
    across IPM iterations (``tulip_tpu/kkt/sparse_ldl.py:314-333``): tile
    t couples the node ids of block row ``tile_brow[t]`` with those of
    block column ``tile_bcol[t]``; a y node i (id n + i) against an x node
    j (id j) holds A[i, j], and the transposed pair Aᵀ. Padding ids (>= N)
    and the diagonal stay 0."""
    m, n = A_np.shape
    B = nodes_np.shape[1]
    Aext = np.zeros((m + 1, n + 1), A_np.dtype)
    Aext[:m, :n] = A_np

    def off_vals(rn, cn):
        r_y = (rn >= n) & (rn < N)
        r_x = rn < n
        c_y = (cn >= n) & (cn < N)
        c_x = cn < n
        ar = np.where(r_y, rn - n, m)
        ac = np.where(c_x, cn, n)
        v_yx = Aext[ar[:, None], ac[None, :]]
        ar2 = np.where(c_y, cn - n, m)
        ac2 = np.where(r_x, rn, n)
        v_xy = Aext[ar2[None, :], ac2[:, None]]
        return (np.where(r_y[:, None] & c_x[None, :], v_yx, 0.0)
                + np.where(r_x[:, None] & c_y[None, :], v_xy, 0.0))

    T0 = np.zeros((len(tile_brow), B, B), A_np.dtype)
    for t in range(ntiles):
        T0[t] = off_vals(nodes_np[tile_brow[t]], nodes_np[tile_bcol[t]])
    return T0


class SparseK2LevelState(NamedTuple):
    """Level-scheduled variant of :class:`SparseK2State` (the reference's
    fields; per-LP tensors with a leading lane axis of 1): exact per-level
    index tensors, no dummy tile, no padding."""

    A: torch.Tensor          # (1, m, n) constraint matrix
    nodes: torch.Tensor      # (nbr, B) int64 node id per lane (pad >= N)
    theta_reg: torch.Tensor  # (1, n)
    regD: torch.Tensor       # (1, m)
    scale: torch.Tensor      # (1, nbr*B) Jacobi scale per node id
    T: torch.Tensor          # (1, ntiles, B, B) tile store
    T0: torch.Tensor         # (1, ntiles, B, B) constant off-diag K2 tiles
    tile_brow: torch.Tensor  # (ntiles,)
    tile_bcol: torch.Tensor  # (ntiles,)
    segs: tuple              # Tuple[LevelSeg, ...]


class SparseK2State(NamedTuple):
    """Static tile schedule + numeric factors for the permuted K2 (the
    column schedule).

    ``T`` holds all (B, B) tiles of the filled lower-triangular pattern
    plus one trailing dummy tile absorbing masked scatter traffic. After
    ``update``, diagonal tiles hold the signed-Cholesky pivot factors U_j
    (or U_j⁻¹; K2 = 𝓛 Σ 𝓛ᵀ, Σ read off the signs of ``nodes``) and
    subdiagonal tiles the L blocks.
    """

    A: torch.Tensor            # (1, m, n) constraint matrix
    nodes: torch.Tensor        # (nbr+1, B) int64 node id per lane (pad >= N)
    theta_reg: torch.Tensor    # (1, n)  Θ⁻¹ + Rp
    regD: torch.Tensor         # (1, m)
    scale: torch.Tensor        # (1, ext_len) Jacobi scale per node id
    T: torch.Tensor            # (1, ntiles+1, B, B) tile store
    T0: torch.Tensor           # (1, ntiles+1, B, B) constant off-diag tiles
    tile_brow: torch.Tensor    # (ntiles+1,) block row of each tile
    tile_bcol: torch.Tensor    # (ntiles+1,) block col of each tile
    col_ids: torch.Tensor      # (nbr, cmax) subdiag tile ids (dummy-padded)
    col_blkrows: torch.Tensor  # (nbr, cmax) block-row index (nbr = dummy)
    u_a: torch.Tensor          # (nbr, umax) source position a in col list
    u_b: torch.Tensor          # (nbr, umax) source position b
    u_tgt: torch.Tensor        # (nbr, umax) target tile id (dummy-padded)


@dataclasses.dataclass(frozen=True)
class SparseK2Backend(KKTBackend):
    """K2 via dense-last + RCM ordered tile-granular signed block LDLᵀ."""

    name = "sparse-ldl"
    systems = ("K2",)
    # update and solve read nothing on the host (KKTBackend.device_loop).
    device_loop = True
    block: int = 64
    jacobi_scale: bool = True
    # "column" (the default) or "level"; see the module docstring.
    schedule: str = "column"
    # Store U_j⁻¹ and run the L-tile formation and the substitutions as
    # products instead of triangular solves.
    inv_factor: bool = True
    host_A: Optional[np.ndarray] = dataclasses.field(
        default=None, compare=False, repr=False)

    def _dense(self) -> DenseK2Backend:
        return DenseK2Backend(refinement_steps=self.refinement_steps)

    def linear_system(self) -> str:
        return "Augmented system (K2), tiled block LDL^T"

    # -- host symbolic ----------------------------------------------------
    def setup(self, A: torch.Tensor):
        A_np = host_matrix(self, A)
        dt, dev = A.dtype, A.device
        if self.schedule == "level":
            lv = k2_level_plan(A_np, self.block)
            if lv is not None:
                return self._setup_level(A, A_np, lv)
            # fall through to the column schedule
        plan = k2_tile_plan(A_np, self.block)
        if plan is None:
            return self._dense().setup(A)
        m, n = A_np.shape
        B = self.block
        nbr = plan["nbr"]
        N = plan["N"]
        # Unique node ids for every lane incl. padding and the dummy
        # block row (row nbr).
        ext_len = (nbr + 1) * B
        node_ids = np.concatenate(
            [plan["perm"], N + np.arange(ext_len - N)]).astype(np.int64)
        nodes_np = node_ids.reshape(nbr + 1, B)

        ntiles = plan["ntiles"]
        tile_brow = np.full(ntiles + 1, nbr, np.int64)
        tile_bcol = np.full(ntiles + 1, nbr, np.int64)
        tile_brow[:nbr] = tile_bcol[:nbr] = np.arange(nbr)
        valid = plan["col_ids"] < ntiles
        ids = plan["col_ids"][valid]
        tile_brow[ids] = plan["col_blkrows"][valid]
        tile_bcol[ids] = np.nonzero(valid)[0]
        T0 = _constant_tiles(A_np, nodes_np, N, tile_brow, tile_bcol, ntiles)

        def idx(a):
            return index_tensor(a, dev)

        return SparseK2State(
            A=A,
            nodes=idx(nodes_np),
            theta_reg=torch.ones(1, n, dtype=dt, device=dev),
            regD=torch.ones(1, m, dtype=dt, device=dev),
            scale=torch.ones(1, ext_len, dtype=dt, device=dev),
            T=torch.zeros(1, ntiles + 1, B, B, dtype=dt, device=dev),
            T0=torch.as_tensor(T0[None], dtype=dt, device=dev),
            tile_brow=idx(tile_brow), tile_bcol=idx(tile_bcol),
            col_ids=idx(plan["col_ids"]),
            col_blkrows=idx(plan["col_blkrows"]),
            u_a=idx(plan["u_a"]), u_b=idx(plan["u_b"]),
            u_tgt=idx(plan["u_tgt"]),
        )

    def _setup_level(self, A, A_np, lv) -> SparseK2LevelState:
        """The level state from :func:`k2_level_plan`'s output ``lv``: the
        same constant tiles as the column path, exact tile lists."""
        m, n = A_np.shape
        nodes_np, plan, N = lv
        nbr, B = nodes_np.shape
        dt, dev = A.dtype, A.device
        T0 = _constant_tiles(A_np, nodes_np, N, plan.tile_brow,
                             plan.tile_bcol, plan.ntiles)
        return SparseK2LevelState(
            A=A,
            nodes=index_tensor(nodes_np, dev),
            theta_reg=torch.ones(1, n, dtype=dt, device=dev),
            regD=torch.ones(1, m, dtype=dt, device=dev),
            scale=torch.ones(1, nbr * B, dtype=dt, device=dev),
            T=torch.zeros(1, plan.ntiles, B, B, dtype=dt, device=dev),
            T0=torch.as_tensor(T0[None], dtype=dt, device=dev),
            tile_brow=index_tensor(plan.tile_brow, dev),
            tile_bcol=index_tensor(plan.tile_bcol, dev),
            segs=segs_to(plan.segs, dev),
        )

    # -- device numeric ---------------------------------------------------
    def _assemble(self, st, theta_inv, regP, regD):
        """(Θ⁻¹ + Rp, Jacobi scale by node id, the scaled tile store).

        Symmetric Jacobi scaling factors S K2 S with S = |diag(K2)|^-½,
        whose diagonal is exactly -1 on x nodes and +1 on y nodes and
        padding lanes. The tiles are the constant T0 rescaled, plus that
        diagonal (or the unscaled -(Θ⁻¹ + Rp), Rd without the scaling):
        one vectorized pass over all tiles."""
        m, n = st.A.shape[1:]
        nbr_rows, B = st.nodes.shape
        ext_len = nbr_rows * B
        theta_reg = theta_inv + regP
        pad = theta_reg.new_ones(ext_len - n - m)
        if self.jacobi_scale:
            scale = torch.cat([1.0 / torch.sqrt(theta_reg[0]),
                               1.0 / torch.sqrt(regD[0]), pad])
            diagval = torch.cat([theta_reg.new_full((n,), -1.0),
                                 theta_reg.new_ones(ext_len - n)])
        else:
            scale = theta_reg.new_ones(ext_len)
            diagval = torch.cat([-theta_reg[0], regD[0], pad])
        T = (st.T0[0] * scale[st.nodes[st.tile_brow]].unsqueeze(-1)
             * scale[st.nodes[st.tile_bcol]].unsqueeze(-2))
        # The pivot tiles come first; the column state's nodes have one
        # more row, the dummy's.
        npiv = (nbr_rows if isinstance(st, SparseK2LevelState)
                else nbr_rows - 1)
        T[:npiv].diagonal(dim1=-2, dim2=-1).add_(diagval[st.nodes[:npiv]])
        return theta_reg, scale, T

    def _signs(self, st) -> torch.Tensor:
        """Σ per lane: -1 on x nodes (id < n), +1 on y nodes and padding."""
        n = st.A.shape[-1]
        return torch.where(st.nodes < n, -1.0, 1.0).to(st.A.dtype)

    def _update_level(self, st: SparseK2LevelState, theta_inv, regP, regD):
        theta_reg, scale, T = self._assemble(st, theta_inv, regP, regD)
        sgn = self._signs(st)
        T, ok = level_factor_signed(T, st.segs, lambda cols: sgn[cols],
                                    inv_factor=self.inv_factor)
        new = st._replace(theta_reg=theta_reg, regD=regD, scale=scale[None],
                          T=T[None])
        return new, ok.reshape(1)

    def _update_column(self, st: SparseK2State, theta_inv, regP, regD):
        theta_reg, scale, T = self._assemble(st, theta_inv, regP, regD)
        nbr = st.nodes.shape[0] - 1
        dummy = T.shape[0] - 1
        sgn = self._signs(st)
        ok = torch.ones((), dtype=torch.bool, device=T.device)
        # Right-looking signed blocked Cholesky K2 = 𝓛 Σ 𝓛ᵀ.
        for j in range(nbr):
            ids = st.col_ids[j]
            valid = (ids < dummy)[:, None, None]
            s = sgn[j]                                # (B,)
            U, ok_j = signed_pivot(T[j], s, self.inv_factor)
            Sub = T[ids]                              # (cmax, B, B)
            # L_ij = K_ij U_j⁻ᵀ Σ_j (a product with U_j⁻¹, or a batched
            # triangular solve).
            Y = (Sub @ U.T if self.inv_factor
                 else solve_right_lower_t(U.expand_as(Sub), Sub))
            Lsub = torch.where(valid & ok_j, Y * s, torch.zeros_like(Y))
            T[j] = U
            T[ids] = torch.where(valid, Lsub, Sub)
            # Right-looking updates T[tgt] -= L_a Σ_j L_bᵀ; the dummy tile
            # absorbs the pads.
            T.index_add_(0, st.u_tgt[j],
                         (Lsub[st.u_a[j]] * s)
                         @ Lsub[st.u_b[j]].transpose(-1, -2), alpha=-1)
            ok = ok & ok_j
        T[dummy] = 0.0
        new = st._replace(theta_reg=theta_reg, regD=regD, scale=scale[None],
                          T=T[None])
        return new, ok.reshape(1)

    def update(self, state, theta_inv, regP, regD):
        if isinstance(state, DenseK2State):
            return self._dense().update(state, theta_inv, regP, regD)
        if isinstance(state, SparseK2LevelState):
            return self._update_level(state, theta_inv, regP, regD)
        return self._update_column(state, theta_inv, regP, regD)

    # -- solve ------------------------------------------------------------
    def _scaled_rhs(self, st, xi_p, xi_d):
        """S rhs in node-id order, gathered to the (rows, B) lane layout."""
        ext_len = st.nodes.numel()
        rhs = torch.cat([xi_d, xi_p,
                         xi_p.new_zeros(ext_len - xi_d.shape[0]
                                        - xi_p.shape[0])]) * st.scale[0]
        return rhs[st.nodes]

    def _unscaled(self, st, nodes, x):
        """(dx, dy) from the lane-layout solution x of the scaled
        system."""
        n = st.A.shape[-1]
        N = n + st.A.shape[1]
        sol = x.new_zeros(st.nodes.numel()).index_copy_(
            0, nodes.reshape(-1), x.reshape(-1)) * st.scale[0]
        return sol[:n], sol[n:N]

    def _base_solve_level(self, st: SparseK2LevelState, xi_p, xi_d):
        rhs_b = self._scaled_rhs(st, xi_p, xi_d)
        T = st.T[0]
        u = level_fwd(T, st.segs, rhs_b, inv_factor=self.inv_factor)
        x = level_bwd(T, st.segs, u * self._signs(st),
                      inv_factor=self.inv_factor)
        return self._unscaled(st, st.nodes, x)

    def _base_solve_column(self, st: SparseK2State, xi_p, xi_d):
        nbr = st.nodes.shape[0] - 1
        T = st.T[0]
        # Forward: 𝓛 u = rhs (diagonal tiles hold U_j, or U_j⁻¹; u_j is
        # final once its block column is reached). Row nbr is the dummy.
        u = self._scaled_rhs(st, xi_p, xi_d)
        for j in range(nbr):
            uj = (T[j] @ u[j] if self.inv_factor
                  else solve_lower(T[j], u[j]))
            u[j] = uj
            u.index_add_(0, st.col_blkrows[j], T[st.col_ids[j]] @ uj,
                         alpha=-1)
        # Σ⁻¹ = Σ: flip signs on x lanes.
        v = u[:nbr] * self._signs(st)[:nbr]
        # Backward: 𝓛ᵀ x = v (the dummy row of x stays 0).
        x = u.new_zeros(nbr + 1, u.shape[1])
        for j in reversed(range(nbr)):
            xg = x[st.col_blkrows[j]]                 # (cmax, B)
            acc = (T[st.col_ids[j]].transpose(-1, -2)
                   @ xg.unsqueeze(-1)).squeeze(-1).sum(0)
            x[j] = (T[j].T @ (v[j] - acc) if self.inv_factor
                    else solve_lower(T[j], v[j] - acc, trans=True))
        return self._unscaled(st, st.nodes[:nbr], x[:nbr])

    def _base_solve(self, state, xi_p, xi_d):
        if isinstance(state, DenseK2State):
            return self._dense()._base_solve(state, xi_p, xi_d)
        solve1 = (self._base_solve_level
                  if isinstance(state, SparseK2LevelState)
                  else self._base_solve_column)
        dx, dy = solve1(state, xi_p[0], xi_d[0])
        return dx[None], dy[None]

    def solve(self, state, xi_p, xi_d):
        if isinstance(state, DenseK2State):
            return self._dense().solve(state, xi_p, xi_d)
        dx, dy = self._base_solve(state, xi_p, xi_d)
        return self._refine(state, xi_p, xi_d, dx, dy, self._base_solve)
