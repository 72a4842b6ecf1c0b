"""Batched LP solves: one HSD loop over a leading lane axis.

Counterpart of ``tulip_tpu/ipm/batch.py``. The JAX package vmaps the whole
solve into one program; here every tensor already carries the lane axis,
and :func:`batched_hsd_solve`, :func:`batched_hsd_resolve` and
:func:`batched_mpc_solve` run :func:`.hsd.solve`, which stops once no lane
is UNKNOWN: as the device program (``ipm/graph.py``: one captured pass,
one host read a pass; a second solve of the same shapes, such as a warm
re-solve, replays the cached pass) for a backend that declares
``device_loop`` (every backend of the port), else on the host-driven
loop.
:func:`shard_batch` splits a batch over the processes of a group and
:func:`gather_lanes` puts the final states back together; the solve in
between needs no collective (its lanes are independent).

Heterogeneous instances are padded to a common (m, n) envelope: padded
columns get c = 0 and bounds l = u = 0 (both flags on), pinning them to
zero; padded rows are all-zero with b = 0, which the dual regularization
keeps nonsingular.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, List

import numpy as np
import torch

from .data import LPData
from .hsd import HSDOptions, HSDState, solve
from .mpc import MPCOptions, init_state_mpc, mpc_iteration
from .warmstart import warm_state

if TYPE_CHECKING:
    from ..parallel.comm import Comm


def pad_lp(dat: LPData, m_pad: int, n_pad: int) -> LPData:
    """Embed a batch of (m, n) problems into an (m_pad, n_pad) envelope."""
    m, n = dat.nrow, dat.ncol
    dm, dn = m_pad - m, n_pad - n
    if dm < 0 or dn < 0:
        raise ValueError("pad target smaller than problem")
    pad = torch.nn.functional.pad
    return LPData(
        A=pad(dat.A, (0, dn, 0, dm)),
        b=pad(dat.b, (0, dm)),
        c=pad(dat.c, (0, dn)),
        c0=dat.c0,
        l=pad(dat.l, (0, dn)),
        u=pad(dat.u, (0, dn)),
        lflag=pad(dat.lflag, (0, dn), value=1.0),
        uflag=pad(dat.uflag, (0, dn), value=1.0),
    )


def stack_lps(dats: List[LPData]) -> LPData:
    """Concatenate batches of equal or mixed shape along the lane axis,
    padding to the common envelope."""
    m_pad = max(d.nrow for d in dats)
    n_pad = max(d.ncol for d in dats)
    padded = [pad_lp(d, m_pad, n_pad) for d in dats]
    return LPData(*(torch.cat(leaves) for leaves in zip(*padded)))


def bucket_dim(v: int, lo: int = 16) -> int:
    """Pad target for heterogeneous batching: next power of two ≥ v
    (floor ``lo``). Bounds padding waste to <2× per dimension."""
    p = lo
    while p < v:
        p *= 2
    return p


def stack_lps_host(problems, *, device="cuda", dtype=torch.float64,
                   m_pad=None, n_pad=None) -> LPData:
    """Host-side batch assembly: pad + stack raw ``(A, b, c, c0, l, u)``
    tuples with numpy and make ONE tensor per LPData leaf.

    Bounds may be infinite; they become the l/u + lflag/uflag masked form.
    Padded columns are pinned to zero and padded rows are zero rows with
    b = 0, exactly like :func:`pad_lp`.
    """
    B = len(problems)
    if m_pad is None:
        m_pad = max(np.shape(p[0])[0] for p in problems)
    if n_pad is None:
        n_pad = max(np.shape(p[0])[1] for p in problems)
    A_ = np.zeros((B, m_pad, n_pad))
    b_ = np.zeros((B, m_pad))
    c_ = np.zeros((B, n_pad))
    c0_ = np.zeros(B)
    l_ = np.zeros((B, n_pad))
    u_ = np.zeros((B, n_pad))
    lf_ = np.ones((B, n_pad))
    uf_ = np.ones((B, n_pad))
    for k, (A, b, c, c0, l, u) in enumerate(problems):
        A = np.asarray(A, dtype=np.float64)
        mm, nn = A.shape
        A_[k, :mm, :nn] = A
        b_[k, :mm] = b
        c_[k, :nn] = c
        c0_[k] = c0
        l = np.asarray(l, dtype=np.float64)
        u = np.asarray(u, dtype=np.float64)
        lf = np.isfinite(l)
        uf = np.isfinite(u)
        l_[k, :nn] = np.where(lf, l, 0.0)
        u_[k, :nn] = np.where(uf, u, 0.0)
        lf_[k, :nn] = lf
        uf_[k, :nn] = uf

    def t(v):
        return torch.as_tensor(v, device=device, dtype=dtype)

    return LPData(A=t(A_), b=t(b_), c=t(c_), c0=t(c0_), l=t(l_), u=t(u_),
                  lflag=t(lf_), uflag=t(uf_))


def batched_hsd_solve(backend, opts: HSDOptions, dats: LPData) -> HSDState:
    """Solve a batch of LPs (leading lane axis on every LPData leaf). Each
    lane converges, or stops, on its own; the loop ends when none is
    UNKNOWN."""
    return solve(backend, opts, dats)


def batched_hsd_resolve(backend, opts: HSDOptions, dats: LPData,
                        prev: HSDState, lam: float = 0.99) -> HSDState:
    """Warm-started batched re-solve: each lane starts from the blended
    homogeneous restart of its lane of ``prev``, the final state of a
    related solve of the same shapes (:mod:`.warmstart`)."""
    return solve(backend, opts, dats,
                 init=lambda dat, be: warm_state(dat, be, prev, lam=lam))


def batched_mpc_solve(backend, opts: MPCOptions, dats: LPData) -> HSDState:
    """Batched Mehrotra predictor-corrector solves."""
    return solve(backend, opts, dats, init=init_state_mpc,
                 iteration=mpc_iteration, algo="MPC")


def lane_split(B: int, size: int) -> List[int]:
    """Lanes of each of ``size`` ranks for a batch of ``B``: contiguous,
    the first ``B % size`` ranks one more (``numpy.array_split``'s)."""
    return [B // size + (r < B % size) for r in range(size)]


def shard_batch(dats, comm: Comm):
    """This rank's contiguous share of the lanes of ``dats`` (any LP data
    NamedTuple with a leading lane axis on its tensors; other fields pass
    through). Uneven splits are allowed (:func:`lane_split`). The
    counterpart of ``tulip_tpu/ipm/batch.py:shard_batch``, whose sharded
    batched solve partitions with no collectives: each rank solves its
    lanes alone."""
    counts = lane_split(dats.b.shape[0], comm.size)
    lo = sum(counts[:comm.rank])
    hi = lo + counts[comm.rank]
    return type(dats)(*(x[lo:hi] if torch.is_tensor(x) else x
                        for x in dats))


def gather_lanes(state: HSDState, comm: Comm) -> HSDState:
    """The whole batch's state on every rank, lanes in order, from each
    rank's state of its :func:`shard_batch` share. Every tensor of the
    state must carry the lane axis first (the states of the dense K1
    backends do); other leaves pass through from this rank. One gather
    for the lane counts, then one for each tensor."""
    counts = comm.all_gather_blocks(
        torch.tensor([state.niter.shape[0]], device=state.niter.device),
        0).tolist()
    return _map(state, lambda x: comm.all_gather_blocks(x, 0, counts)
                if torch.is_tensor(x) else x)


def _map(tree, fn):
    """``fn`` applied to every leaf of nested NamedTuples."""
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map(x, fn) for x in tree))
    return fn(tree)
