"""Standard-form LP data as batch-first tensors.

Counterpart of ``tulip_tpu/ipm/data.py``. The problem seen by the IPM is
(reference: src/IPM/ipmdata.jl:1-13)::

    min  c'x + c0
    s.t. A x = b
         l <= x <= u        (entries of l, u may be infinite)

Infinite bounds are carried as float masks ``lflag``/``uflag`` (masked
arithmetic instead of data-dependent branches, reference:
src/IPM/ipmdata.jl:33-39). Every tensor has a leading batch axis: one
LP is a batch of one.

The conversion from a general ``ProblemData`` (``standard_form_arrays``,
numpy, copied verbatim from the JAX package) appends one slack column per
non-equality row (reference: src/IPM/ipmdata.jl:77-124).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..kkt.base import bmtv, bmv
from ..problem import ProblemData

INF = float("inf")


class LPData(NamedTuple):
    """Standard-form problem data for a batch of B LPs of one shape.

    ``l``/``u`` are finite-valued (masked entries hold 0), ``lflag``/``uflag``
    are {0,1} float masks of which bounds exist.
    """

    A: torch.Tensor       # (B, m, n)
    b: torch.Tensor       # (B, m)
    c: torch.Tensor       # (B, n)
    c0: torch.Tensor      # (B,)
    l: torch.Tensor       # (B, n) finite values, 0 where masked
    u: torch.Tensor       # (B, n)
    lflag: torch.Tensor   # (B, n) {0., 1.}
    uflag: torch.Tensor   # (B, n) {0., 1.}

    @property
    def nrow(self) -> int:
        return self.A.shape[-2]

    @property
    def ncol(self) -> int:
        return self.A.shape[-1]


def matvec(dat, x: torch.Tensor) -> torch.Tensor:
    """A @ x per lane, (B, n) -> (B, m), for any LP data type: a type
    registered with :func:`register_operator` (the sparse-first
    ``SparseLPData``) runs its own product, the dense ``LPData`` a batched
    GEMV on ``dat.A``."""
    fn = _MATVEC.get(type(dat))
    if fn is not None:
        return fn(dat, x)
    return bmv(dat.A, x)


def rmatvec(dat, y: torch.Tensor) -> torch.Tensor:
    """Aᵀ @ y per lane, (B, m) -> (B, n), for any LP data type."""
    fn = _RMATVEC.get(type(dat))
    if fn is not None:
        return fn(dat, y)
    return bmtv(dat.A, y)


_MATVEC: dict = {}
_RMATVEC: dict = {}


def register_operator(cls, mv, rmv) -> None:
    """Register ``mv(dat, x)`` and ``rmv(dat, y)`` as A·x and Aᵀ·y for LP
    data of type ``cls`` (``tulip_tpu/ipm/data.py:61-84``)."""
    _MATVEC[cls] = mv
    _RMATVEC[cls] = rmv


def make_lp_data(A, b, c, c0, l, u, *, device="cuda",
                 dtype=torch.float64) -> LPData:
    """Build a batch-of-one LPData from one LP with possibly-infinite
    bounds (host helper)."""
    l = np.asarray(l, dtype=np.float64)
    u = np.asarray(u, dtype=np.float64)
    lflag = np.isfinite(l)
    uflag = np.isfinite(u)

    def t(v):
        return torch.as_tensor(np.asarray(v, dtype=np.float64)[None],
                               device=device, dtype=dtype)

    return LPData(A=t(A), b=t(b), c=t(c), c0=t(c0),
                  l=t(np.where(lflag, l, 0.0)), u=t(np.where(uflag, u, 0.0)),
                  lflag=t(lflag), uflag=t(uflag))


def standard_form_arrays(pb: ProblemData) -> Tuple[np.ndarray, ...]:
    """Convert general-form ``pb`` to standard-form numpy arrays.

    Returns (A, b, c, c0, l, u, objsense). Row case analysis mirrors the
    reference (reference: src/IPM/ipmdata.jl:77-124):

    - equality row      a'x  = b          : no slack
    - free row          -inf <= a'x <= inf: slack +1, free
    - a'x <= ub                           : slack +1 in [0, inf), b = ub
    - a'x >= lb                           : slack -1 in [0, inf), b = lb
    - lb <= a'x <= ub (range)             : slack +1 in [0, ub-lb], b = ub
    """
    m, n = pb.ncon, pb.nvar
    b = np.zeros(m)
    sind, sval, lslack, uslack = [], [], [], []

    for i, (lb, ub) in enumerate(zip(pb.lcon, pb.ucon)):
        if lb == ub:
            b[i] = lb
        elif lb == -INF and ub == INF:
            sind.append(i); sval.append(1.0)
            lslack.append(-INF); uslack.append(INF)
            b[i] = 0.0
        elif lb == -INF and np.isfinite(ub):
            sind.append(i); sval.append(1.0)
            lslack.append(0.0); uslack.append(INF)
            b[i] = ub
        elif np.isfinite(lb) and ub == INF:
            sind.append(i); sval.append(-1.0)
            lslack.append(0.0); uslack.append(INF)
            b[i] = lb
        elif np.isfinite(lb) and np.isfinite(ub):
            sind.append(i); sval.append(1.0)
            lslack.append(0.0); uslack.append(ub - lb)
            b[i] = ub
        else:
            raise ValueError(f"Invalid bounds for row {i}: [{lb}, {ub}]")

    nslack = len(sind)
    c = np.concatenate([np.asarray(pb.obj, dtype=np.float64),
                        np.zeros(nslack)])
    c0 = pb.obj0
    if not pb.objsense:
        # Flip objective for maximization (reference: ipmdata.jl:130-135).
        c = -c
        c0 = -c0

    A = np.zeros((m, n + nslack))
    I, J, V = pb.to_coo()
    if len(I):
        A[I, J] = V
    for k, (i, v) in enumerate(zip(sind, sval)):
        A[i, n + k] = v

    l = np.concatenate([np.asarray(pb.lvar, dtype=np.float64),
                        np.asarray(lslack, dtype=np.float64)])
    u = np.concatenate([np.asarray(pb.uvar, dtype=np.float64),
                        np.asarray(uslack, dtype=np.float64)])
    return A, b, c, c0, l, u, pb.objsense


def lp_data_from_problem(pb: ProblemData, *, device="cuda",
                         dtype=torch.float64) -> Tuple[LPData, int, bool]:
    """ProblemData -> (batch-of-one LPData, n_structural_vars, objsense)."""
    A, b, c, c0, l, u, objsense = standard_form_arrays(pb)
    return (make_lp_data(A, b, c, c0, l, u, device=device, dtype=dtype),
            pb.nvar, objsense)
