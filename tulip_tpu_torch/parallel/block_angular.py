"""Block-angular (two-stage stochastic) LP data, sharded over scenarios.

Counterpart of ``tulip_tpu/parallel/block_angular.py``; see its docstring
for the problem form

    min  c0'x0 + Σ_k ck'xk
    s.t. A0 x0                = b0          (first-stage rows, m0)
         Tk x0 + Wk xk        = hk          (scenario rows, K × mk)
         bounds on x0 (n0) and xk (K × nk)

with variables ordered [x0; x1; …; xK] and rows [first stage; scenario 1;
…; scenario K]. Batch-first, as every LP data type of the port: A0
(B, m0, n0), T (B, K, mk, n0), W (B, K, mk, nk) and flat b, c, l, u,
lflag, uflag over all rows and columns, with a lane axis of 1 for one LP.

:func:`shard_scenarios` keeps one process's contiguous share of the
scenario blocks of T and W (the reference's ``NamedSharding`` of the K
axis) and leaves A0 and the flat vectors whole on every process;
:func:`make_block_angular_share` makes the same share from that process's
blocks alone, so no process holds the others' blocks. The data
carries the :class:`~.comm.Comm` of its scenario axis into A·x and Aᵀ·y
(:func:`~tulip_tpu_torch.kkt.schur.block_matvec`,
:func:`~tulip_tpu_torch.kkt.schur.block_rmatvec`) and into the Schur
backend's state; unsharded data carries a ``Comm()`` of one process.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import trace
from ..ipm.data import LPData, register_operator
from ..kkt.schur import block_matvec, block_rmatvec
from .comm import Comm


class BlockAngularLPData(NamedTuple):
    """Standard-form LPs with block-angular constraint structure: the
    fields of ``LPData`` (b, c, c0, l, u, lflag, uflag) but A held as its
    blocks A0, T, W, with T and W holding this process's scenarios."""

    A0: torch.Tensor      # (B, m0, n0)
    T: torch.Tensor       # (B, Kl, mk, n0)
    W: torch.Tensor       # (B, Kl, mk, nk)
    b: torch.Tensor       # (B, m0 + K*mk)
    c: torch.Tensor       # (B, n0 + K*nk)
    c0: torch.Tensor      # (B,)
    l: torch.Tensor
    u: torch.Tensor
    lflag: torch.Tensor
    uflag: torch.Tensor
    comm: Comm            # the scenario axis's group (Comm() unsharded)

    @property
    def m0(self) -> int:
        return self.A0.shape[-2]

    @property
    def n0(self) -> int:
        return self.A0.shape[-1]

    @property
    def K(self) -> int:
        """Scenarios in all (over every process of the group)."""
        return self.T.shape[1] * self.comm.size

    @property
    def mk(self) -> int:
        return self.T.shape[2]

    @property
    def nk(self) -> int:
        return self.W.shape[3]

    @property
    def nrow(self) -> int:
        return self.m0 + self.K * self.mk

    @property
    def ncol(self) -> int:
        return self.n0 + self.K * self.nk

    # -- flat <-> blocked views -----------------------------------------
    def split_cols(self, x: torch.Tensor):
        """x (B, n) -> (x0 (B, n0), xs (B, K, nk))."""
        return x[:, :self.n0], x[:, self.n0:].reshape(-1, self.K, self.nk)

    def split_rows(self, y: torch.Tensor):
        """y (B, m) -> (y0 (B, m0), ys (B, K, mk))."""
        return y[:, :self.m0], y[:, self.m0:].reshape(-1, self.K, self.mk)


def _ba_matvec(dat: BlockAngularLPData, x: torch.Tensor) -> torch.Tensor:
    return block_matvec(dat.A0, dat.T, dat.W, dat.comm, x)


def _ba_rmatvec(dat: BlockAngularLPData, y: torch.Tensor) -> torch.Tensor:
    return block_rmatvec(dat.A0, dat.T, dat.W, dat.comm, y)


register_operator(BlockAngularLPData, _ba_matvec, _ba_rmatvec)


def make_block_angular(A0, b0, c0x, T, W, h, cks, l, u, c0=0.0, *,
                       device="cuda", dtype=torch.float64,
                       ) -> BlockAngularLPData:
    """One LP (a batch of one) from its blocks (host arrays).

    ``T``/``W``/``h``/``cks`` are (K, ...) stacked scenario arrays or lists;
    ``l``/``u`` are flat bounds over [x0; x1..xK] (may contain ±inf).
    """
    h = np.asarray(h, dtype=np.float64)
    b = np.concatenate([np.asarray(b0, dtype=np.float64), h.reshape(-1)])
    c = np.concatenate([np.asarray(c0x, dtype=np.float64),
                        np.asarray(cks, dtype=np.float64).reshape(-1)])
    l = np.asarray(l, dtype=np.float64)
    u = np.asarray(u, dtype=np.float64)
    lflag = np.isfinite(l)
    uflag = np.isfinite(u)

    def t(v):
        return torch.as_tensor(np.asarray(v, dtype=np.float64)[None],
                               device=device, dtype=dtype)

    return BlockAngularLPData(
        A0=t(A0), T=t(T), W=t(W), b=t(b), c=t(c), c0=t(c0),
        l=t(np.where(lflag, l, 0.0)), u=t(np.where(uflag, u, 0.0)),
        lflag=t(lflag), uflag=t(uflag), comm=Comm())


@trace.call("share")
def make_block_angular_share(A0, b0, c0x, T, W, h, cks, l, u, c0=0.0, *,
                             comm: Comm, device="cuda",
                             dtype=torch.float64) -> BlockAngularLPData:
    """This process's share of one LP over ``comm``, from host arrays: the
    first stage (``A0``, ``b0``, ``c0x``) and the flat ``h`` (K, mk),
    ``cks`` (K, nk), ``l`` and ``u`` whole, and ``T`` (Kl, mk, n0) and
    ``W`` (Kl, mk, nk) of this rank's Kl = K/size contiguous scenarios
    only, which are all that go to the device. Equal, field by field and
    bit for bit, to ``shard_scenarios(make_block_angular(...), comm)`` of
    the whole LP. Opens the call record ``"share"`` (its span ``share``
    encloses the copies to the device)."""
    h = np.asarray(h, dtype=np.float64)
    K, Kl = h.shape[0], np.shape(T)[0]
    if Kl * comm.size != K or np.shape(W)[0] != Kl:
        raise ValueError(f"rank {comm.rank} of {comm.size} holds "
                         f"{K // comm.size} of K = {K} scenarios; got "
                         f"{Kl} blocks of T and {np.shape(W)[0]} of W")
    with trace.span("share"):
        dat = make_block_angular(A0, b0, c0x, T, W, h, cks, l, u, c0,
                                 device=device, dtype=dtype)
    return dat._replace(comm=comm)


def pad_scenarios(dat: BlockAngularLPData, K_pad: int) -> BlockAngularLPData:
    """Zero-pad the scenario axis to ``K_pad`` (so that a group's size
    divides it). Padded scenarios have T = W = 0, h = 0, c_k = 0 and their
    variables pinned to 0 (l = u = 0, both flags on); dual regularization
    keeps the padded blocks' factors nonsingular, so the padded LP solves
    to the same optimum. Takes unsharded data."""
    if dat.comm.size != 1:
        raise ValueError("pad_scenarios takes unsharded data: pad before "
                         "shard_scenarios")
    B, K, mk, n0 = dat.T.shape
    nk = dat.nk
    dK = K_pad - K
    if dK < 0:
        raise ValueError("K_pad smaller than K")
    if dK == 0:
        return dat
    kw = dict(dtype=dat.c.dtype, device=dat.c.device)
    zeros_n = torch.zeros(B, dK * nk, **kw)
    ones_n = torch.ones(B, dK * nk, **kw)
    return dat._replace(
        T=torch.cat([dat.T, torch.zeros(B, dK, mk, n0, **kw)], 1),
        W=torch.cat([dat.W, torch.zeros(B, dK, mk, nk, **kw)], 1),
        b=torch.cat([dat.b, torch.zeros(B, dK * mk, **kw)], -1),
        c=torch.cat([dat.c, zeros_n], -1),
        l=torch.cat([dat.l, zeros_n], -1),
        u=torch.cat([dat.u, zeros_n], -1),
        lflag=torch.cat([dat.lflag, ones_n], -1),
        uflag=torch.cat([dat.uflag, ones_n], -1),
    )


def block_angular_to_dense(dat: BlockAngularLPData) -> LPData:
    """The equivalent dense ``LPData`` (for testing / small problems).
    Takes unsharded data."""
    if dat.comm.size != 1:
        raise ValueError("block_angular_to_dense takes unsharded data")
    B, K, mk, n0 = dat.T.shape
    m0, nk = dat.m0, dat.nk
    A = dat.c.new_zeros(B, dat.nrow, dat.ncol)
    A[:, :m0, :n0] = dat.A0
    for k in range(K):
        r0 = m0 + k * mk
        c0_ = n0 + k * nk
        A[:, r0:r0 + mk, :n0] = dat.T[:, k]
        A[:, r0:r0 + mk, c0_:c0_ + nk] = dat.W[:, k]
    return LPData(A=A, b=dat.b, c=dat.c, c0=dat.c0, l=dat.l, u=dat.u,
                  lflag=dat.lflag, uflag=dat.uflag)


def shard_scenarios(dat: BlockAngularLPData, comm: Comm,
                    ) -> BlockAngularLPData:
    """This process's share of ``dat`` over ``comm``: the contiguous
    K/size scenario blocks of T and W of its rank, with A0 and the flat
    vectors whole (replicated). K must be a multiple of the group's size,
    as a ``NamedSharding`` of the K axis requires; pad first with
    :func:`pad_scenarios`."""
    if dat.comm.size != 1:
        raise ValueError("the data is sharded already")
    K = dat.K
    if K % comm.size:
        raise ValueError(f"K = {K} scenarios do not split over {comm.size} "
                         f"processes; pad them first with pad_scenarios("
                         f"dat, {-(-K // comm.size) * comm.size})")
    Kl = K // comm.size
    lo = comm.rank * Kl
    return dat._replace(T=dat.T[:, lo:lo + Kl].contiguous(),
                        W=dat.W[:, lo:lo + Kl].contiguous(), comm=comm)
