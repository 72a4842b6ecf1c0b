"""Elimination-level scheduled execution for the tiled sparse backends.

Counterpart of ``tulip_tpu/kkt/levels.py``; see its docstring for the
design (nested dissection over the tile graph, block columns grouped into
~2·log₂(nb) independent elimination levels, one batched Cholesky, one
batched triangular inverse or solve and one batched GEMM + scatter-add a
level). The host functions (``nd_block_order``, ``tile_fill``,
``column_levels`` and their helpers) are verbatim copies. The plan
(:class:`LevelSeg`, :class:`LevelPlan`, :func:`build_level_plan`) is the
same plan, with torch index tensors (int64) on an explicit device.

The device functions take one LP's tile store T (ntiles, B, B):

- ``jnp.linalg.cholesky`` returns NaN where it fails; here
  ``torch.linalg.cholesky_ex``'s ``info`` says so. ``ok`` stays a device
  tensor: no host sync inside the level loop.
- ``.at[].add`` becomes ``index_add_``, which accumulates repeated
  targets (on CUDA through atomics, in an order that may change from
  run to run).
- ``level_factor_signed`` (the K2 factorization) is not ported yet: it
  comes with ``"sparse-ldl"`` (ROADMAP queue 1, item 8c).
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .base import bmtv, bmv



# ---------------------------------------------------------------------------
# Host: nested dissection over the tile graph
# ---------------------------------------------------------------------------

def _components(adj: List[set], nodes: Sequence[int]) -> List[List[int]]:
    nodeset = set(nodes)
    seen = set()
    comps = []
    for s in nodes:
        if s in seen:
            continue
        comp, stack = [], [s]
        seen.add(s)
        while stack:
            v = stack.pop()
            comp.append(v)
            for w in adj[v]:
                if w in nodeset and w not in seen:
                    seen.add(w)
                    stack.append(w)
        comps.append(comp)
    return comps


def _bfs_levels(adj: List[set], nodeset: set, root: int) -> List[List[int]]:
    levels = [[root]]
    seen = {root}
    while True:
        nxt = []
        for v in levels[-1]:
            for w in adj[v]:
                if w in nodeset and w not in seen:
                    seen.add(w)
                    nxt.append(w)
        if not nxt:
            return levels
        levels.append(nxt)


def nd_block_order(bi: np.ndarray, bj: np.ndarray, nbr: int,
                   last: Sequence[int] = (), leaf: int = 2) -> np.ndarray:
    """Nested-dissection elimination order of block rows.

    ``bi``/``bj``: block coordinates of the (symmetric) tile pattern.
    ``last``: block rows forced to the end (dense-node deferral).
    Returns a permutation ``order`` with ``order[k]`` = old block row
    eliminated k-th.
    """
    adj: List[set] = [set() for _ in range(nbr)]
    for i, j in zip(np.asarray(bi), np.asarray(bj)):
        i, j = int(i), int(j)
        if i != j:
            adj[i].add(j)
            adj[j].add(i)
    lastset = set(int(x) for x in last)
    free = [v for v in range(nbr) if v not in lastset]

    def dissect(nodes: List[int]) -> List[int]:
        order: List[int] = []
        for comp in _components(adj, nodes):
            if len(comp) <= leaf:
                order.extend(sorted(comp))
                continue
            compset = set(comp)
            # Pseudo-peripheral start: two BFS sweeps.
            lv = _bfs_levels(adj, compset, comp[0])
            lv = _bfs_levels(adj, compset, lv[-1][0])
            if len(lv) <= 2:
                # No useful diameter (clique-ish): eliminate as one block.
                order.extend(sorted(comp))
                continue
            # Split at the median level; that level is the separator.
            sizes = np.cumsum([len(l) for l in lv])
            k = int(np.searchsorted(sizes, sizes[-1] // 2))
            k = min(max(k, 1), len(lv) - 2)
            sep = lv[k]
            a = [v for l in lv[:k] for v in l]
            b = [v for l in lv[k + 1:] for v in l]
            order.extend(dissect(a))
            order.extend(dissect(b))
            order.extend(sorted(sep))
        return order

    return np.asarray(dissect(free) + sorted(lastset), np.int64)


# ---------------------------------------------------------------------------
# Host: fill, levels, and per-level schedule emission
# ---------------------------------------------------------------------------

def tile_fill(bi, bj, nbr) -> List[List[int]]:
    """Tile-granular symbolic elimination (right-looking fill): returns the
    sorted strictly-below block rows of each block column after fill."""
    cols = [set() for _ in range(nbr)]
    for i, j in zip(bi, bj):
        if i > j:
            cols[j].add(int(i))
        elif j > i:
            cols[i].add(int(j))
    for j in range(nbr):
        rows = sorted(cols[j])
        for x in range(len(rows)):
            for y in range(x + 1, len(rows)):
                cols[rows[x]].add(rows[y])
    return [sorted(c) for c in cols]


def column_levels(col_rows: List[List[int]]) -> np.ndarray:
    """Elimination level of each block column: 0 for columns receiving no
    updates, else 1 + max level over the columns that update them."""
    nbr = len(col_rows)
    level = np.zeros(nbr, np.int64)
    for i in range(nbr):
        li = level[i] + 1
        for j in col_rows[i]:          # eliminating i updates column j
            if li > level[j]:
                level[j] = li
    return level




class LevelSeg(NamedTuple):
    """One elimination level's exact (unpadded) schedule. All tensors are
    int64 on the plan's device; zero-length levels are empty tensors."""

    cols: torch.Tensor       # (w,)  block columns (diag tile id == col id)
    sub_ids: torch.Tensor    # (S,)  subdiagonal tile ids of these columns
    sub_owner: torch.Tensor  # (S,)  index into ``cols``
    sub_brow: torch.Tensor   # (S,)  block row of each subdiagonal tile
    u_a: torch.Tensor        # (U,)  index into the level's sub arrays
    u_b: torch.Tensor        # (U,)
    u_tgt: torch.Tensor      # (U,)  target tile id


class LevelPlan(NamedTuple):
    ntiles: int
    tile_brow: np.ndarray    # (ntiles,)
    tile_bcol: np.ndarray    # (ntiles,)
    segs: Tuple[LevelSeg, ...]


def build_level_plan(col_rows: List[List[int]], nbr: int,
                     device="cpu") -> LevelPlan:
    """Assign tile ids (diagonal first) and group block columns by
    elimination level, emitting exact per-level index tensors on
    ``device`` (the reference's ``build_level_plan``, same ids and order)."""
    level = column_levels(col_rows)
    tid = {(j, j): j for j in range(nbr)}
    next_id = nbr
    for j in range(nbr):
        for i in col_rows[j]:
            tid[(i, j)] = next_id
            next_id += 1
    ntiles = next_id
    tile_brow = np.zeros(ntiles, np.int32)
    tile_bcol = np.zeros(ntiles, np.int32)
    for (i, j), t in tid.items():
        tile_brow[t] = i
        tile_bcol[t] = j

    def idx(v):
        return torch.as_tensor(np.asarray(v, np.int64), device=device)

    segs = []
    for lv in range(int(level.max()) + 1 if nbr else 0):
        cols = np.flatnonzero(level == lv)
        sub_ids, sub_owner, sub_brow = [], [], []
        u_a, u_b, u_tgt = [], [], []
        base = {}
        for w, j in enumerate(cols):
            rows = col_rows[j]
            base[j] = len(sub_ids)
            for i in rows:
                sub_ids.append(tid[(i, j)])
                sub_owner.append(w)
                sub_brow.append(i)
        for j in cols:
            rows = col_rows[j]
            b0 = base[j]
            for x in range(len(rows)):
                for y in range(x, len(rows)):
                    a, b = rows[y], rows[x]          # a >= b
                    u_a.append(b0 + y)
                    u_b.append(b0 + x)
                    u_tgt.append(tid[(a, b)])
        segs.append(LevelSeg(cols=idx(cols), sub_ids=idx(sub_ids),
                             sub_owner=idx(sub_owner),
                             sub_brow=idx(sub_brow), u_a=idx(u_a),
                             u_b=idx(u_b), u_tgt=idx(u_tgt)))
    return LevelPlan(ntiles=ntiles, tile_brow=tile_brow,
                     tile_bcol=tile_bcol, segs=tuple(segs))


def segs_to(segs: Sequence[LevelSeg], device) -> Tuple[LevelSeg, ...]:
    """The same schedule with its index tensors on ``device``."""
    return tuple(LevelSeg(*(t.to(device) for t in seg)) for seg in segs)


# ---------------------------------------------------------------------------
# Device: level-scheduled numeric factorization and substitution
# ---------------------------------------------------------------------------

def _eye(T: torch.Tensor) -> torch.Tensor:
    return torch.eye(T.shape[-1], dtype=T.dtype, device=T.device)


def cholesky_or_identity(D: torch.Tensor):
    """(L with D = L Lᵀ, or I where any matrix of the batch failed; 0-d ok
    flag): the reference's ``jnp.where(all(isfinite(L)), L, eye)``."""
    L, info = torch.linalg.cholesky_ex(D)
    ok = (info == 0).all() & torch.isfinite(L).all()
    return torch.where(ok, L, _eye(D)), ok


def solve_lower(L: torch.Tensor, b: torch.Tensor,
                trans: bool = False) -> torch.Tensor:
    """L x = b (or Lᵀ x = b) for lower-triangular L and vector(s) b."""
    if trans:
        return torch.linalg.solve_triangular(
            L.transpose(-1, -2), b.unsqueeze(-1), upper=True).squeeze(-1)
    return torch.linalg.solve_triangular(
        L, b.unsqueeze(-1), upper=False).squeeze(-1)


def solve_right_lower_t(L: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
    """X with X Lᵀ = S for batched lower-triangular L: S L⁻ᵀ."""
    return torch.linalg.solve_triangular(L.transpose(-1, -2), S, upper=True,
                                         left=False)


def level_factor_spd(T: torch.Tensor, segs: Sequence[LevelSeg],
                     inv_factor: bool = True):
    """Level-scheduled right-looking tiled Cholesky of one tile store T
    (ntiles, B, B).

    After the pass, diagonal tiles hold L_j (or L_j⁻¹ when ``inv_factor``)
    and subdiagonal tiles hold the L blocks. Returns (T, ok), ``ok`` a 0-d
    bool tensor: a level whose pivots do not all factor stores identities
    and zero blocks, as the reference does. T is not modified.
    """
    T = T.clone()
    eye = _eye(T)
    ok = torch.ones((), dtype=torch.bool, device=T.device)
    for seg in segs:
        L, ok_l = cholesky_or_identity(T[seg.cols])
        Sub = T[seg.sub_ids]                         # (S, B, B)
        if inv_factor:
            Linv = torch.linalg.solve_triangular(L, eye.expand_as(L),
                                                 upper=False)
            ok_l = ok_l & torch.isfinite(Linv).all()
            Linv = torch.where(ok_l, Linv, eye)
            # L_ij = T_ij L_j⁻ᵀ as a GEMM.
            Lsub = Sub @ Linv[seg.sub_owner].transpose(-1, -2)
            diag_store = Linv
        else:
            Lsub = solve_right_lower_t(L[seg.sub_owner], Sub)
            diag_store = L
        Lsub = torch.where(ok_l, Lsub, torch.zeros_like(Lsub))
        T[seg.cols] = torch.where(ok_l, diag_store, eye)
        T[seg.sub_ids] = Lsub
        # All of the level's right-looking updates as one batched GEMM +
        # scatter-add (repeated targets accumulate).
        T.index_add_(0, seg.u_tgt,
                     Lsub[seg.u_a] @ Lsub[seg.u_b].transpose(-1, -2),
                     alpha=-1)
        ok = ok & ok_l
    return T, ok


def level_fwd(T: torch.Tensor, segs: Sequence[LevelSeg],
              rhs_b: torch.Tensor, inv_factor: bool = True) -> torch.Tensor:
    """Blocked forward substitution 𝓛 u = rhs over the level schedule.
    ``rhs_b`` is (nbr, B); diagonal tiles hold L_j (or L_j⁻¹)."""
    y = rhs_b.clone()
    for seg in segs:
        D = T[seg.cols]
        yj = y[seg.cols]                             # (w, B)
        yj = bmv(D, yj) if inv_factor else solve_lower(D, yj)
        y[seg.cols] = yj
        y.index_add_(0, seg.sub_brow, bmv(T[seg.sub_ids], yj[seg.sub_owner]),
                     alpha=-1)
    return y


def level_bwd(T: torch.Tensor, segs: Sequence[LevelSeg], v: torch.Tensor,
              inv_factor: bool = True) -> torch.Tensor:
    """Blocked backward substitution 𝓛ᵀ x = v over the level schedule,
    processed root-level first."""
    x = torch.zeros_like(v)
    for seg in reversed(segs):
        acc = bmtv(T[seg.sub_ids], x[seg.sub_brow])  # (S, B)
        acc_col = torch.zeros(seg.cols.shape[0], v.shape[1], dtype=v.dtype,
                              device=v.device).index_add_(0, seg.sub_owner,
                                                          acc)
        r = v[seg.cols] - acc_col
        D = T[seg.cols]
        x[seg.cols] = bmtv(D, r) if inv_factor else solve_lower(D, r,
                                                                trans=True)
    return x
