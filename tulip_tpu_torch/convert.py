"""Carry LP data and solver state across from the JAX package.

The JAX package's pytrees (``LPData``, ``HSDState`` with a ``DenseK1State``
in its ``kkt`` field) are given here as dicts of numpy arrays, nested the
same way, keyed by field name, batch-first as ``jax.vmap`` leaves them. This
module imports no JAX: the caller flattens the pytree to numpy (e.g.
``{k: np.asarray(v) for k, v in tree._asdict().items()}`` per level).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .ipm.data import LPData
from .ipm.hsd import HSDState
from .ipm.point import Point, Residuals
from .kkt.banded import BandedK1State
from .kkt.dense import DenseK1State
from .kkt.levels import LevelSeg
from .kkt.sparse import SparseK1LevelState, SparseK1State

_INT_FIELDS = ("niter", "status", "primal_status", "dual_status")
_STRUCTURED = {cls.__name__: cls for cls in (SparseK1LevelState,
                                             SparseK1State, BandedK1State)}
# Fields of the structured states that index (the plan), not per-LP values.
_INDEX_FIELDS = ("perm", "sup_idx", "sup_tile", "col_ids", "col_blkrows",
                 "u_a", "u_b", "u_tgt")


def _tensor(v, device, dtype) -> torch.Tensor:
    return torch.as_tensor(np.array(v), device=device, dtype=dtype)


def _build(cls, d: Mapping, device, dtype):
    return cls(**{f: _tensor(d[f], device, dtype) for f in cls._fields})


def lp_data_from_numpy(d: Mapping, *, device="cuda",
                       dtype=torch.float64) -> LPData:
    """LPData from a dict of its fields as numpy arrays."""
    return _build(LPData, d, device, dtype)


def hsd_state_from_numpy(d: Mapping, *, device="cuda",
                         dtype=torch.float64) -> HSDState:
    """HSDState from nested dicts of numpy arrays; ``d["kkt"]`` holds the
    fields of a dense K1 state (A, d, theta_reg, regD, L)."""
    fields = {}
    for f in HSDState._fields:
        if f == "pt":
            fields[f] = _build(Point, d[f], device, dtype)
        elif f == "res":
            fields[f] = _build(Residuals, d[f], device, dtype)
        elif f == "kkt":
            fields[f] = _build(DenseK1State, d[f], device, dtype)
        elif f in _INT_FIELDS:
            fields[f] = _tensor(d[f], device, torch.int32)
        else:
            fields[f] = _tensor(d[f], device, dtype)
    return HSDState(**fields)


def hsd_state_to_numpy(state: HSDState) -> dict:
    """The inverse of :func:`hsd_state_from_numpy`: nested dicts of numpy
    arrays, one level per NamedTuple."""
    def conv(v):
        if isinstance(v, tuple):
            return {f: conv(x) for f, x in zip(v._fields, v)}
        return v.detach().cpu().numpy()

    return conv(state)


def structured_state_from_numpy(kind: str, d: Mapping, *, device="cuda",
                                dtype=torch.float64):
    """A structured K1 state of this package from the JAX package's, given
    as the name of its class (``"SparseK1LevelState"``,
    ``"SparseK1State"`` or ``"BandedK1State"``) and a dict of its fields as
    numpy arrays. A level state's ``d["segs"]`` is a sequence of dicts of
    ``LevelSeg`` fields: its plan's level schedule.

    Index fields become int64 tensors with no lane axis; every other field
    gains the leading lane axis of 1 that this package's states carry.
    """
    cls = _STRUCTURED[kind]
    fields = {}
    for f in cls._fields:
        if f == "segs":
            fields[f] = tuple(
                LevelSeg(**{k: _tensor(seg[k], device, torch.int64)
                            for k in LevelSeg._fields})
                for seg in d[f])
        elif f in _INDEX_FIELDS:
            fields[f] = _tensor(d[f], device, torch.int64)
        else:
            fields[f] = _tensor(np.asarray(d[f])[None], device, dtype)
    return cls(**fields)
