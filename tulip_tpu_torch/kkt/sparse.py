"""Tiled sparse K1 backend (``"sparse"``): host symbolic analysis +
tile-granular sparse Cholesky.

Counterpart of ``tulip_tpu/kkt/sparse.py``; see its docstring for the
design. The host symbolic phase (``tile_plan``, ``symbolic_schedule``,
``k1_level_plan``) is a verbatim copy, over the native engine of
``native/symbolic.cpp`` (:mod:`.native`); ``k1_level_plan_pattern`` is the
reference's but forms the K pattern with :func:`gram_pattern`, from the
distinct column patterns, index for index as the reference's product
(``tests/test_torch_gram_pattern.py``). The numeric
phase has both of the reference's schedules:

- ``"level"`` (the default): nested-dissection block order and
  level-batched factorization and substitution (:mod:`.levels`) over
  support-compressed operands precomputed at ``setup``;
- ``"column"``: the reference's ``lax.fori_loop``s over block columns,
  as plain Python loops (one small Cholesky, one batched triangular solve
  and one batched GEMM + scatter-add a block column);

and the reference's internal fall back to the dense inverse-factor
backend where tiling gives no advantage.

Batch-first contract (:mod:`.base`): the IPM hands these backends one LP
as a batch of one. Every per-LP tensor of a state carries a leading lane
axis of 1; the plan's index tensors (``perm``, ``sup_idx``, the level
schedule, ...) carry none and are the same objects in every state derived
from one ``setup``, so the IPM's per-lane select passes them through.
``update`` returns ``ok`` as a (1,) flag. A batch of more than one LP
raises ``ValueError``: the reference never vmaps these backends.

``setup`` reads A on the host. ``host_A``, when given, is that host array
(the caller's standard-form A in the solve's dtype), so that ``setup``
copies nothing back from the device. ``setup_data`` on sparse-first data
(``ipm/sparse_data.py:SparseLPData``) builds the level state from its plan
and compressed blocks on their device, with no dense A anywhere.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import trace
from .base import KKTBackend
from .dense import DenseK1Backend, DenseK1State
from .levels import (build_level_plan, cholesky_or_identity, index_add_fixed,
                     level_bwd, level_factor_spd, level_fwd, nd_block_order,
                     segs_to, solve_lower, solve_right_lower_t, tile_fill)


def tile_plan(A_np: np.ndarray, block: int, use_native: bool = True):
    """Host symbolic phase. Returns None if tiling gives no advantage,
    else a dict with the permutation and the padded static schedule.

    Prefers the native C++ engine (native/symbolic.cpp — adjacency, RCM,
    tile-granular elimination and schedule emission in one call); the
    pure-Python/scipy implementation below is the reference semantics and
    the fallback."""
    if use_native:
        from .native import UNAVAILABLE, tile_plan_native
        plan = tile_plan_native(A_np, block)
        if plan is not UNAVAILABLE:
            return plan

    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    m, n = A_np.shape
    # int32 accumulator — int8 overflow can wrap counts to exactly 0 and
    # erase K-pattern entries (see rcm_bandwidth).
    pattern = sp.csr_matrix((np.abs(A_np) > 0).astype(np.int32))
    Kpat = (pattern @ pattern.T).tocsr()
    perm = np.asarray(reverse_cuthill_mckee(Kpat, symmetric_mode=True))

    nbr = -(-m // block)
    # Tile-granular pattern of the permuted K (lower triangle).
    Kp = Kpat[perm][:, perm].tocoo()
    sched = symbolic_schedule(Kp.row // block, Kp.col // block, nbr)
    if sched is None:
        return None
    sched["perm"] = perm
    return sched


def symbolic_schedule(bi, bj, nbr, gate: float = 0.5):
    """Tile-granular symbolic elimination + static schedule emission.

    ``bi``/``bj`` are block coordinates of the nonzero entries of a
    (permuted) symmetric pattern; ``nbr`` the number of block rows. Shared
    by the K1 planner above and the K2 planner (kkt/sparse_ldl.py).
    Returns None when the filled tile count gives no sparsity advantage
    (>= ``gate`` of the dense lower-triangle tile count), else the padded
    static schedule dict (everything except the node permutation)."""
    cols = [set() for _ in range(nbr)]   # strictly-below block rows per col
    for i, j in zip(bi, bj):
        if i > j:
            cols[j].add(int(i))
        elif j > i:
            cols[i].add(int(j))
    # Symbolic elimination at tile granularity: eliminating column j turns
    # every pair (a, b) of its below-diagonal block rows into a tile of
    # column min(a, b) (right-looking fill).
    for j in range(nbr):
        rows = sorted(cols[j])
        for x in range(len(rows)):
            for y in range(x + 1, len(rows)):
                cols[rows[x]].add(rows[y])

    ntiles_sub = sum(len(c) for c in cols)
    ntiles = ntiles_sub + nbr            # + diagonal tiles
    dense_tiles = nbr * (nbr + 1) // 2
    if ntiles >= gate * dense_tiles or nbr <= 2:
        return None                      # no sparsity advantage

    # Assign tile ids: diagonal tiles first (id j for (j, j)), then
    # subdiagonal tiles column-major.
    tid = {}
    for j in range(nbr):
        tid[(j, j)] = j
    next_id = nbr
    col_rows = []
    for j in range(nbr):
        rows = sorted(cols[j])
        col_rows.append(rows)
        for i in rows:
            tid[(i, j)] = next_id
            next_id += 1

    cmax = max((len(r) for r in col_rows), default=0)
    cmax = max(cmax, 1)
    umax = max((len(r) * (len(r) + 1) // 2 for r in col_rows), default=0)
    umax = max(umax, 1)

    dummy = ntiles                       # masked gathers/scatters land here
    col_ids = np.full((nbr, cmax), dummy, np.int32)
    col_blkrows = np.full((nbr, cmax), nbr, np.int32)  # dummy block row
    u_a = np.zeros((nbr, umax), np.int32)     # position in col list
    u_b = np.zeros((nbr, umax), np.int32)
    u_tgt = np.full((nbr, umax), dummy, np.int32)
    for j in range(nbr):
        rows = col_rows[j]
        for p, i in enumerate(rows):
            col_ids[j, p] = tid[(i, j)]
            col_blkrows[j, p] = i
        q = 0
        for x in range(len(rows)):
            for y in range(x, len(rows)):
                a, b = rows[y], rows[x]          # a >= b
                u_a[j, q] = y
                u_b[j, q] = x
                u_tgt[j, q] = tid[(a, b)]
                q += 1
    return dict(nbr=nbr, ntiles=ntiles, cmax=cmax, umax=umax,
                col_ids=col_ids, col_blkrows=col_blkrows,
                u_a=u_a, u_b=u_b, u_tgt=u_tgt)


def k1_level_plan(A_np: np.ndarray, block: int, gate: float = 0.5,
                  use_native: bool = True):
    """Host symbolic phase for the LEVEL-SCHEDULED K1 backend.

    Like :func:`tile_plan` (scalar RCM on the K = A Aᵀ pattern) but the
    block rows are re-ordered by nested dissection over the tile graph so
    the numeric factorization runs in O(log nb) batched levels
    (kkt/levels.py) instead of nb sequential block-column steps.

    Also emits the per-block-row COLUMN SUPPORT of A (``sup_idx``), so
    tile assembly contracts each A_i D A_jᵀ tile over the owner column's
    support instead of all n columns (the assembly is where K1's flops
    live; the support is padded with ``n``, pointing at a zero column).

    Returns None if tiling (or the support compression) gives no
    advantage, else a dict.
    """
    import scipy.sparse as sp

    pattern = sp.csr_matrix((np.abs(A_np) > 0).astype(np.int32))
    return k1_level_plan_pattern(pattern, A_np.shape, block, gate)


def _column_classes(rows: np.ndarray, ptr: np.ndarray, weights: np.ndarray):
    """Exact classes of equal columns of a CSC pattern.

    ``rows``/``ptr``: the pattern's CSC row indices (sorted within each
    column) and column pointers; ``weights``: one uint64 a row. Columns
    are sorted by (length, sum of their rows' weights mod 2⁶⁴), and each
    is compared entry for entry with the one before it, so two columns
    share a class only if their row lists are equal, whatever the weights
    (a collision only splits a class). Returns ``(ids, reps)``: each
    column's class id and each class's first column.
    """
    n = ptr.size - 1
    lens = np.diff(ptr)
    sums = np.zeros(rows.size + 1, np.uint64)
    np.cumsum(weights[rows], out=sums[1:])
    h = sums[ptr[1:]] - sums[ptr[:-1]]
    order = np.lexsort((h, lens))
    cur, prev = order[1:], order[:-1]
    # same[j]: column j equals the column before it in ``order``.
    same = np.zeros(n, bool)
    same[cur] = (lens[cur] == lens[prev]) & (h[cur] == h[prev])
    shift = np.zeros(n, np.int64)
    shift[cur] = np.where(same[cur], ptr[prev] - ptr[cur], 0)
    differ = np.flatnonzero(
        rows[np.arange(rows.size) + np.repeat(shift, lens)] != rows)
    same[np.searchsorted(ptr, differ, side="right") - 1] = False
    new = ~same[order]
    ids = np.empty(n, np.int64)
    ids[order] = np.cumsum(new) - 1
    return ids, order[new]


def gram_pattern(pattern):
    """The pattern of ``pattern @ pattern.T``, from its distinct columns.

    ``pattern``: a scipy CSR 0/1 matrix (every stored value 1; rows may be
    stored unsorted). Returns a CSR matrix whose ``indptr`` and
    ``indices`` equal, index for index, those of ``(pattern @
    pattern.T).tocsr()``, the unsorted order within each row included;
    its ``data`` may differ (the plan reads only the structure).

    scipy's product emits each row in reverse order of first visit: it
    walks the row's stored columns in order and, for each, that column's
    rows ascending. A column whose pattern already appeared earlier in the
    row visits nothing new, so the product of the row × class matrix
    (each row's first entry of each class, in stored order) by its
    transpose visits the same rows in the same order. That holds for any
    partition into equal columns, a class split in two included. Counts
    the classes (``level_plan/col_patterns``) in the open call record.
    """
    import scipy.sparse as sp

    m, n = pattern.shape
    nnz = pattern.indices.size
    # Its columns, each entry holding its position in ``pattern``.
    csc = sp.csr_matrix((np.arange(nnz, dtype=np.int64), pattern.indices,
                         pattern.indptr), shape=(m, n)).tocsc()
    weights = np.random.default_rng(0).integers(
        1, 2**63, m, dtype=np.uint64)
    ids, reps = _column_classes(csc.indices, csc.indptr, weights)
    trace.count("level_plan/col_patterns", reps.size)
    # Number each (row, class) pair by the row's place in the class's
    # first column, and keep its first entry in ``pattern``'s order.
    lens = np.diff(csc.indptr)
    start = np.concatenate([[0], np.cumsum(lens[reps])])
    pair = np.arange(nnz) + np.repeat(start[ids] - csc.indptr[:-1], lens)
    first = np.full(start[-1], nnz, np.int64)
    np.minimum.at(first, pair, csc.data)
    keep = np.zeros(nnz, bool)
    keep[first] = True
    kept = np.concatenate([[0], np.cumsum(keep)])
    classes = sp.csr_matrix(
        (np.ones(kept[-1], np.int32), ids[pattern.indices[keep]],
         kept[pattern.indptr]), shape=(m, reps.size))
    return (classes @ classes.T).tocsr()


def k1_level_plan_pattern(pattern, shape, block: int, gate: float = 0.5,
                          sup_cap: float = 0.5):
    """Pattern-only core of :func:`k1_level_plan`.

    ``pattern`` is a scipy CSR 0/1 matrix — the only input the symbolic
    phase needs, so the sparse-first LPData path (ipm/sparse_data.py) can
    plan in O(nnz) without ever materializing a dense (m, n) array.
    """
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    m, n = shape
    B = block
    Kpat = gram_pattern(pattern)
    perm0 = np.asarray(reverse_cuthill_mckee(Kpat, symmetric_mode=True))
    nbr = -(-m // B)
    if nbr <= 2:
        return None

    Kp = Kpat[perm0][:, perm0].tocoo()
    bi0 = Kp.row // B
    bj0 = Kp.col // B
    # The partial final block (m % B != 0) must stay LAST: the composed
    # scalar permutation concatenates whole blocks, so a short block in
    # the middle would shift every later block boundary off the tile
    # coordinates (observed as numerically-nonzero K tiles missing from
    # the symbolic plan on a 2080-row block-angular LP).
    last_blocks = [nbr - 1] if m % B else []
    order = nd_block_order(bi0, bj0, nbr, last=last_blocks)
    binv = np.empty(nbr, np.int64)
    binv[order] = np.arange(nbr)

    # Composed scalar permutation: RCM rows regrouped in ND block order
    # (the last, possibly partial, RCM block keeps its identity).
    blocks0 = [perm0[k * B:(k + 1) * B] for k in range(nbr)]
    perm = np.concatenate([blocks0[b] for b in order]).astype(np.int64)

    col_rows = tile_fill(binv[bi0], binv[bj0], nbr)
    ntiles = nbr + sum(len(c) for c in col_rows)
    if ntiles >= gate * (nbr * (nbr + 1) // 2):
        return None
    plan = build_level_plan(col_rows, nbr)

    # Column support per (ND-ordered) block row of A.
    Aperm = pattern[perm]          # csr, rows in elimination order
    sups = []
    for j in range(nbr):
        rows = Aperm[j * B:min((j + 1) * B, m)]
        sups.append(np.unique(rows.indices))
    smax = max((len(s) for s in sups), default=1)
    smax = max(smax, 1)
    if smax > sup_cap * n:
        return None                # support compression gives no advantage
    sup_idx = np.full((nbr, smax), n, np.int32)
    for j, s in enumerate(sups):
        sup_idx[j, :len(s)] = s
    return dict(perm=perm, plan=plan, sup_idx=sup_idx)


class SparseK1LevelState(NamedTuple):
    """Level-scheduled variant of :class:`SparseK1State` (the reference's
    fields; per-LP tensors with a leading lane axis of 1)."""

    Apc: torch.Tensor         # (1, nbr, B, smax) support-compressed rows
    sup_idx: torch.Tensor     # (nbr, smax) int64 column support (pad = n)
    Rg0: torch.Tensor         # (1, ntiles, smax, B) row-side tile operand
    Oc0: torch.Tensor         # (1, ntiles, B, smax) col-side tile operand
    sup_tile: torch.Tensor    # (ntiles, smax) owner column's support
    perm: torch.Tensor        # (m,) int64
    d: torch.Tensor           # (1, n)
    theta_reg: torch.Tensor   # (1, n)
    regD: torch.Tensor        # (1, nbr, B) permuted/padded (1.0 on padding)
    T: torch.Tensor           # (1, ntiles, B, B) tile store
    segs: tuple               # Tuple[LevelSeg, ...]


class SparseK1State(NamedTuple):
    """Static tile schedule + numeric factors (the column schedule).

    ``T`` holds all (B, B) tiles of the filled lower-triangular pattern
    plus one trailing dummy tile absorbing masked scatter traffic. After
    ``update``, diagonal tiles hold their Cholesky factors and
    subdiagonal tiles hold L-blocks.
    """

    Ap: torch.Tensor           # (1, nbr, B, n) permuted + padded rows
    perm: torch.Tensor         # (m,) int64
    d: torch.Tensor            # (1, n)
    theta_reg: torch.Tensor    # (1, n)
    regD: torch.Tensor         # (1, nbr, B) permuted/padded (1.0 on padding)
    T: torch.Tensor            # (1, ntiles+1, B, B) tile store
    col_ids: torch.Tensor      # (nbr, cmax) subdiag tile ids (dummy-padded)
    col_blkrows: torch.Tensor  # (nbr, cmax) block-row index (nbr = dummy)
    u_a: torch.Tensor          # (nbr, umax) source position a in col list
    u_b: torch.Tensor          # (nbr, umax) source position b
    u_tgt: torch.Tensor        # (nbr, umax) target tile id (dummy-padded)


def host_matrix(backend, A: torch.Tensor) -> np.ndarray:
    """One LP's constraint matrix on the host for a structured backend's
    ``setup``: ``backend.host_A`` when given, else A copied back from its
    device. Raises ``ValueError`` on a batch of more than one LP."""
    if A.dim() != 3 or A.shape[0] != 1:
        raise ValueError(f"{backend.name!r} takes one LP (a batch of one), "
                         f"got A of shape {tuple(A.shape)}")
    if backend.host_A is None:
        return A[0].cpu().numpy()
    if tuple(backend.host_A.shape) != tuple(A.shape[1:]):
        raise ValueError(f"host_A has shape {backend.host_A.shape}, A "
                         f"{tuple(A.shape[1:])}")
    return backend.host_A


def index_tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.int64), device=device)


def to_blocked(perm: torch.Tensor, nbr: int, B: int, v: torch.Tensor,
               pad: float = 0.0) -> torch.Tensor:
    """Unpermuted (m,) row vector -> permuted (nbr, B), the padded rows
    set to ``pad`` (1.0 for regD: unit pivots on the padding)."""
    m = perm.shape[0]
    return torch.nn.functional.pad(v[perm], (0, nbr * B - m),
                                   value=pad).reshape(nbr, B)


def from_blocked(perm: torch.Tensor, vb: torch.Tensor) -> torch.Tensor:
    """Permuted padded (nbr, B) -> unpermuted (m,)."""
    m = perm.shape[0]
    return vb.new_zeros(m).index_copy_(0, perm, vb.reshape(-1)[:m])


@dataclasses.dataclass(frozen=True)
class SparseK1Backend(KKTBackend):
    """K1 via RCM-ordered tile-granular sparse Cholesky."""

    name = "sparse"
    systems = ("K1",)
    # update and solve read nothing on the host (KKTBackend.device_loop).
    device_loop = True
    block: int = 64
    # "level": nested-dissection block ordering + elimination-level batched
    # execution with support-compressed assembly (kkt/levels.py);
    # "column": the round-3 loop over block columns.
    schedule: str = "level"
    # Store L_j⁻¹ per pivot tile and run L-tile formation and the fwd/bwd
    # solves as GEMMs. Only used by the level schedule.
    inv_factor: bool = True
    host_A: Optional[np.ndarray] = dataclasses.field(
        default=None, compare=False, repr=False)

    def _dense(self) -> DenseK1Backend:
        return DenseK1Backend(inv_factor=True,
                              refinement_steps=self.refinement_steps)

    def linear_system(self) -> str:
        return "Normal equations (K1), tiled sparse Cholesky"

    # -- host symbolic ----------------------------------------------------
    def setup_data(self, dat):
        """Sparse-first LP data (``ipm/sparse_data.py``) carries the plan
        and the compressed blocks already: the level state is built from
        them, with no dense A anywhere. Dense data goes to :meth:`setup`."""
        from ..ipm.sparse_data import SparseLPData
        if isinstance(dat, SparseLPData):
            return self.setup_from_sparse_data(dat)
        return self.setup(dat.A)

    @staticmethod
    def setup_from_sparse_data(dat) -> SparseK1LevelState:
        """The level state of a ``SparseLPData``
        (``tulip_tpu/kkt/sparse.py:311-362``), at its block size.

        Tile t = (i, j) contracts block row i of A against block row j over
        j's column support. The gather map ``gmap[t, s]`` is the position
        of column ``sup[j, s]`` inside row i's support, or ``smax`` (a zero
        pad column) where row i does not touch it; each support row is
        sorted with its pads (= n) last, so one batched searchsorted over
        the tiles finds it. ``Rg0`` and ``Oc0`` are then one gather each
        from ``Apc`` on its device.
        """
        Apc = dat.Apc[0]
        nbr, B, smax = Apc.shape
        n = dat.c.shape[-1]
        sup = dat.sup_idx
        tb, tc = dat.tile_brow, dat.tile_bcol
        si, sj = sup[tb], sup[tc]                     # (ntiles, smax)
        pos = torch.searchsorted(si, sj).clamp_max_(smax - 1)
        hit = (si.gather(1, pos) == sj) & (sj < n)
        gmap = torch.where(hit, pos, torch.full_like(pos, smax))
        Apc_ext = torch.cat([Apc, Apc.new_zeros(nbr, B, 1)], dim=2)
        Rg = Apc_ext[tb].gather(
            2, gmap[:, None, :].expand(-1, B, -1))   # (ntiles, B, smax)
        dt, dev = Apc.dtype, Apc.device
        return SparseK1LevelState(
            Apc=dat.Apc, sup_idx=sup,
            Rg0=Rg.transpose(1, 2)[None],     # a view: the update reads Rg
            Oc0=Apc[tc][None],
            sup_tile=sj,
            perm=dat.perm,
            d=torch.ones(1, n, dtype=dt, device=dev),
            theta_reg=torch.ones(1, n, dtype=dt, device=dev),
            regD=torch.ones(1, nbr, B, dtype=dt, device=dev),
            T=torch.zeros(1, tb.shape[0], B, B, dtype=dt, device=dev),
            segs=dat.segs,
        )

    def setup(self, A: torch.Tensor):
        A_np = host_matrix(self, A)
        if self.schedule == "level":
            lv = k1_level_plan(A_np, self.block)
            if lv is not None:
                return self.setup_level(A_np, lv, A.dtype, A.device)
            # ND fill can trip the gate where the RCM column plan does
            # not (small chains): fall through to the column schedule.
        plan = tile_plan(A_np, self.block)
        if plan is None:
            return self._dense().setup(A)
        m, n = A_np.shape
        B = self.block
        nbr = plan["nbr"]
        Ap = np.zeros((nbr * B, n), dtype=A_np.dtype)
        Ap[:m] = A_np[plan["perm"]]
        dt, dev = A.dtype, A.device

        def idx(k):
            return index_tensor(plan[k], dev)

        return SparseK1State(
            Ap=torch.as_tensor(Ap.reshape(1, nbr, B, n), dtype=dt,
                               device=dev),
            perm=idx("perm"),
            d=torch.ones(1, n, dtype=dt, device=dev),
            theta_reg=torch.ones(1, n, dtype=dt, device=dev),
            regD=torch.ones(1, nbr, B, dtype=dt, device=dev),
            T=torch.zeros(1, plan["ntiles"] + 1, B, B, dtype=dt, device=dev),
            col_ids=idx("col_ids"), col_blkrows=idx("col_blkrows"),
            u_a=idx("u_a"), u_b=idx("u_b"), u_tgt=idx("u_tgt"),
        )

    def setup_level(self, A_np, lv, dtype, device) -> SparseK1LevelState:
        """The level state from :func:`k1_level_plan`'s output ``lv``."""
        m, n = A_np.shape
        B = self.block
        plan = lv["plan"]
        perm = lv["perm"]
        sup_idx = lv["sup_idx"]
        nbr = -(-m // B)
        Ap = np.zeros((nbr * B, n + 1), dtype=A_np.dtype)
        Ap[:m, :n] = A_np[perm]
        Ap = Ap.reshape(nbr, B, n + 1)
        # Support-compressed row blocks (pad column n reads as zero).
        Apc = np.take_along_axis(Ap, sup_idx[:, None, :], axis=2)
        # Constant per-tile assembly operands: tile (i, j) contracts
        # A_i[:, sup(j)] against A_j[:, sup(j)] — both never change.
        Rg0 = Ap[plan.tile_brow[:, None], :,
                 sup_idx[plan.tile_bcol]]            # (ntiles, smax, B)
        Oc0 = Apc[plan.tile_bcol]                    # (ntiles, B, smax)

        def lane(a):
            return torch.as_tensor(a[None], dtype=dtype, device=device)

        return SparseK1LevelState(
            Apc=lane(Apc), sup_idx=index_tensor(sup_idx, device),
            Rg0=lane(Rg0), Oc0=lane(Oc0),
            sup_tile=index_tensor(sup_idx[plan.tile_bcol], device),
            perm=index_tensor(perm, device),
            d=torch.ones(1, n, dtype=dtype, device=device),
            theta_reg=torch.ones(1, n, dtype=dtype, device=device),
            regD=torch.ones(1, nbr, B, dtype=dtype, device=device),
            T=torch.zeros(1, plan.ntiles, B, B, dtype=dtype, device=device),
            segs=segs_to(plan.segs, device),
        )

    # -- helpers (one LP: unbatched vectors) ------------------------------
    @staticmethod
    def _blocked(st, v):
        nbr, B = st.regD.shape[1:]
        return to_blocked(st.perm, nbr, B, v)

    @staticmethod
    def _A_blocked(st: SparseK1LevelState, x):
        """A x per (permuted) block row via the compressed supports."""
        xs = torch.cat([x, x.new_zeros(1)])[st.sup_idx]      # (nbr, smax)
        return (st.Apc[0] @ xs.unsqueeze(-1)).squeeze(-1)

    @staticmethod
    def _AT_blocked(st: SparseK1LevelState, yb):
        """Aᵀ y for a blocked y via scatter-add over the supports (a
        column in several block rows' supports sums their terms in one
        order on every run)."""
        n = st.d.shape[1]
        contrib = (st.Apc[0].transpose(-1, -2)
                   @ yb.unsqueeze(-1)).squeeze(-1)         # (nbr, smax)
        return index_add_fixed(yb.new_zeros(n + 1), st.sup_idx.reshape(-1),
                               contrib.reshape(-1))[:n]

    # -- device numeric ---------------------------------------------------
    def _update_level(self, st: SparseK1LevelState, theta_inv, regP, regD):
        nbr, B = st.regD.shape[1:]
        theta_reg = theta_inv + regP
        d = 1.0 / theta_reg
        regDb = to_blocked(st.perm, nbr, B, regD[0], pad=1.0)
        # Support-compressed assembly of ALL tiles in one batched product
        # over the CONSTANT setup-time operands: tile (i, j) = A_i diag(d)
        # A_jᵀ contracted over column j's support only; just d changes.
        ds = torch.cat([d[0], d.new_zeros(1)])[st.sup_tile]  # (ntiles, smax)
        T = st.Rg0[0].transpose(-1, -2) @ (
            st.Oc0[0] * ds.unsqueeze(-2)).transpose(-1, -2)
        T[:nbr].diagonal(dim1=-2, dim2=-1).add_(regDb)
        T, ok = level_factor_spd(T, st.segs, inv_factor=self.inv_factor)
        new = st._replace(d=d, theta_reg=theta_reg, regD=regDb[None],
                          T=T[None])
        return new, ok.reshape(1)

    def _update_column(self, st: SparseK1State, theta_inv, regP, regD):
        Ap = st.Ap[0]
        nbr, B, n = Ap.shape
        ntiles_p1 = st.T.shape[1]
        theta_reg = theta_inv + regP
        d = 1.0 / theta_reg
        regDb = to_blocked(st.perm, nbr, B, regD[0], pad=1.0)
        Ad = Ap * d[0]
        # Pad block-row gathers with a zero block at index nbr.
        Ap_g = torch.cat([Ap, Ap.new_zeros(1, B, n)])

        # ---- assemble K tiles column by column (bounded memory) --------
        T = Ap.new_zeros(ntiles_p1, B, B)
        for j in range(nbr):
            T[st.col_ids[j]] = Ap_g[st.col_blkrows[j]] @ Ad[j].T
            T[j] = Ap[j] @ Ad[j].T + torch.diag(regDb[j])

        # ---- right-looking tiled Cholesky -------------------------------
        ok = torch.ones((), dtype=torch.bool, device=Ap.device)
        for j in range(nbr):
            ids = st.col_ids[j]
            valid = (ids < ntiles_p1 - 1)[:, None, None]
            Ld, ok_j = cholesky_or_identity(T[j])
            Sub = T[ids]                              # (cmax, B, B)
            # L_ij = T_ij Ld^-T (batched triangular solve).
            Lsub = solve_right_lower_t(Ld.expand_as(Sub), Sub)
            Lsub = torch.where(valid & ok_j, Lsub, torch.zeros_like(Lsub))
            T[j] = Ld
            T[ids] = torch.where(valid, Lsub, Sub)
            # Right-looking updates: T[tgt] -= L_a L_bᵀ (the dummy tile
            # absorbs the pads).
            T.index_add_(0, st.u_tgt[j],
                         Lsub[st.u_a[j]] @ Lsub[st.u_b[j]].transpose(-1, -2),
                         alpha=-1)
            ok = ok & ok_j
        new = st._replace(d=d, theta_reg=theta_reg, regD=regDb[None],
                          T=T[None])
        return new, ok.reshape(1)

    def update(self, state, theta_inv, regP, regD):
        if isinstance(state, DenseK1State):
            return self._dense().update(state, theta_inv, regP, regD)
        if isinstance(state, SparseK1LevelState):
            return self._update_level(state, theta_inv, regP, regD)
        return self._update_column(state, theta_inv, regP, regD)

    def solve_K_blocked(self, st, rhs_b):
        """(P K Pᵀ) y = rhs for one blocked (nbr, B) right-hand side, on
        either schedule's factors."""
        if isinstance(st, SparseK1LevelState):
            T = st.T[0]
            u = level_fwd(T, st.segs, rhs_b, inv_factor=self.inv_factor)
            return level_bwd(T, st.segs, u, inv_factor=self.inv_factor)
        return self._tile_solve_K(st, rhs_b)

    def _tile_solve_K(self, st: SparseK1State, rhs_b):
        """(P K Pᵀ) y = rhs via blocked forward/backward substitution."""
        T = st.T[0]
        nbr, B = rhs_b.shape
        y = torch.cat([rhs_b, rhs_b.new_zeros(1, B)])
        for j in range(nbr):
            yj = solve_lower(T[j], y[j])
            y[j] = yj
            y.index_add_(0, st.col_blkrows[j], T[st.col_ids[j]] @ yj,
                         alpha=-1)                    # dummy row nbr
        x = rhs_b.new_zeros(nbr + 1, B)
        for j in reversed(range(nbr)):
            xg = x[st.col_blkrows[j]]                 # (cmax, B)
            acc = (T[st.col_ids[j]].transpose(-1, -2)
                   @ xg.unsqueeze(-1)).squeeze(-1).sum(0)
            x[j] = solve_lower(T[j], y[j] - acc, trans=True)
        return x[:nbr]

    def _base_solve1(self, st, xi_p, xi_d):
        """One LP's unrefined solve (unbatched vectors)."""
        d = st.d[0]
        if isinstance(st, SparseK1LevelState):
            rhs_b = self._blocked(st, xi_p) + self._A_blocked(st, d * xi_d)
            y_b = self.solve_K_blocked(st, rhs_b)
            dx = d * (self._AT_blocked(st, y_b) - xi_d)
        else:
            Ap = st.Ap[0]
            rhs_b = self._blocked(st, xi_p) + Ap @ (d * xi_d)
            y_b = self.solve_K_blocked(st, rhs_b)
            dx = d * (Ap.reshape(-1, Ap.shape[-1]).T @ y_b.reshape(-1)
                      - xi_d)
        return dx, from_blocked(st.perm, y_b)

    def _solve1(self, st, xi_p, xi_d):
        dx, dy = self._base_solve1(st, xi_p, xi_d)
        regD_unperm = from_blocked(st.perm, st.regD[0])
        theta_reg = st.theta_reg[0]
        for _ in range(self.refinement_steps):
            if isinstance(st, SparseK1LevelState):
                Adx = from_blocked(st.perm, self._A_blocked(st, dx))
                ATdy = self._AT_blocked(st, self._blocked(st, dy))
            else:
                Ap = st.Ap[0]
                Adx = from_blocked(st.perm, Ap @ dx)
                ATdy = (Ap.reshape(-1, Ap.shape[-1]).T
                        @ self._blocked(st, dy).reshape(-1))
            rp = xi_p - (Adx + regD_unperm * dy)
            rd = xi_d - (-(theta_reg * dx) + ATdy)
            ddx, ddy = self._base_solve1(st, rp, rd)
            dx = dx + ddx
            dy = dy + ddy
        return dx, dy

    def _base_solve(self, state, xi_p, xi_d):
        if isinstance(state, DenseK1State):
            return self._dense()._base_solve(state, xi_p, xi_d)
        dx, dy = self._base_solve1(state, xi_p[0], xi_d[0])
        return dx[None], dy[None]

    def solve(self, state, xi_p, xi_d):
        if isinstance(state, DenseK1State):
            return self._dense().solve(state, xi_p, xi_d)
        dx, dy = self._solve1(state, xi_p[0], xi_d[0])
        return dx[None], dy[None]
