"""Carry LP data and solver state across from the JAX package.

The JAX package's pytrees (``LPData``, ``HSDState`` with a ``DenseK1State``
in its ``kkt`` field, ``SparseLPData``, ``BlockAngularLPData`` and the
other KKT states) are given here as dicts of numpy arrays, nested the
same way, keyed by field name; batched ones batch-first as ``jax.vmap``
leaves them. This
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
from .ipm.sparse_data import SparseLPData
from .kkt.banded import BandedK1State
from .kkt.dense import DenseK1State
from .kkt.dense_ldl import DenseK2State
from .kkt.extended import DDK1State
from .kkt.levels import LevelSeg
from .kkt.mixed import MixedK1State
from .kkt.schur import SchurState
from .kkt.sparse import SparseK1LevelState, SparseK1State
from .kkt.sparse_ldl import SparseK2LevelState, SparseK2State
from .kkt.splitting import SplitK1State
from .parallel.block_angular import BlockAngularLPData
from .parallel.comm import Comm

_INT_FIELDS = ("niter", "status", "primal_status", "dual_status")
_STRUCTURED = {cls.__name__: cls for cls in (
    SparseK1LevelState, SparseK1State, BandedK1State, SplitK1State,
    DenseK2State, SparseK2State, SparseK2LevelState, MixedK1State,
    DDK1State, SchurState)}
# Fields of the structured states and of SparseLPData that index (the
# plan), not per-LP values.
_INDEX_FIELDS = ("perm", "sup_idx", "sup_tile", "col_ids", "col_blkrows",
                 "u_a", "u_b", "u_tgt", "rsup_idx", "dense_idx", "tile_brow",
                 "tile_bcol", "nodes")
# Fields that keep float32 whatever the solve's dtype (the f32 factor of
# the mixed-precision backend).
_F32_FIELDS = ("A32", "Li32")


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
    arrays, one level per NamedTuple. A Schur state's ``comm`` (its
    process group, not data) is left out."""
    def conv(v):
        if isinstance(v, tuple):
            return {f: conv(x) for f, x in zip(v._fields, v)
                    if not isinstance(x, Comm)}
        return v.detach().cpu().numpy()

    return conv(state)


def _lane_fields(cls, d: Mapping, device, dtype, nested=None) -> dict:
    """The fields of ``cls`` from ``d``: ``segs`` as a tuple of
    ``LevelSeg``, index fields as int64 tensors with no lane axis, the
    fields named in ``nested`` converted by their function, and every
    other field with the leading lane axis of 1 that this package's
    one-LP states carry."""
    nested = nested or {}
    fields = {}
    for f in cls._fields:
        if f in nested:
            fields[f] = nested[f](d[f])
        elif f == "segs":
            fields[f] = tuple(
                LevelSeg(**{k: _tensor(seg[k], device, torch.int64)
                            for k in LevelSeg._fields})
                for seg in d[f])
        elif f in _INDEX_FIELDS:
            fields[f] = _tensor(d[f], device, torch.int64)
        else:
            fields[f] = _tensor(np.asarray(d[f])[None], device, dtype)
    return fields


def sparse_lp_data_from_numpy(d: Mapping, *, device="cuda",
                              dtype=torch.float64) -> SparseLPData:
    """SparseLPData from the JAX package's, as a dict of its fields as
    numpy arrays (``d["segs"]`` a sequence of dicts of ``LevelSeg``
    fields); its ``dense_onehot`` field, which this package does not
    carry, is ignored."""
    return SparseLPData(**_lane_fields(SparseLPData, d, device, dtype))


def block_angular_from_numpy(d: Mapping, *, device="cuda",
                             dtype=torch.float64) -> BlockAngularLPData:
    """BlockAngularLPData of one LP from the JAX package's, as a dict of
    its fields as numpy arrays (no lane axis); every field gains the lane
    axis of 1, and the data is unsharded (``Comm()``)."""
    return BlockAngularLPData(**{
        f: _tensor(np.asarray(d[f])[None], device, dtype)
        for f in BlockAngularLPData._fields if f != "comm"}, comm=Comm())


def structured_state_from_numpy(kind: str, d: Mapping, *, device="cuda",
                                dtype=torch.float64):
    """A KKT state of this package from the JAX package's, given as the
    name of its class (``"SparseK1LevelState"``, ``"SparseK1State"``,
    ``"BandedK1State"``, ``"SplitK1State"``, ``"DenseK2State"``,
    ``"SparseK2State"``, ``"SparseK2LevelState"``, ``"MixedK1State"``,
    ``"DDK1State"`` or ``"SchurState"``) and a dict of its fields as numpy
    arrays. A level state's ``d["segs"]`` is a sequence of dicts of
    ``LevelSeg`` fields: its plan's level schedule.

    Index fields become int64 tensors with no lane axis; every other field
    gains the leading lane axis of 1 that this package's states carry, in
    ``dtype`` (the f32 factor of a ``MixedK1State`` stays float32). A
    ``SplitK1State``'s ``d["inner"]`` is the dict of its tiled state (a
    level state when it has ``"segs"``), and its ``d["A"]`` is either the
    dense A or the dict of a ``SparseLPData``. A ``SchurState`` is
    unsharded (``comm`` is a ``Comm()``).
    """
    cls = _STRUCTURED[kind]
    nested = {f: (lambda x: _tensor(np.asarray(x)[None], device,
                                    torch.float32))
              for f in _F32_FIELDS if f in cls._fields}
    if cls is SplitK1State:
        def inner(x):
            k = "SparseK1LevelState" if "segs" in x else "SparseK1State"
            return structured_state_from_numpy(k, x, device=device,
                                               dtype=dtype)

        def full_A(x):
            if isinstance(x, Mapping):
                return sparse_lp_data_from_numpy(x, device=device,
                                                 dtype=dtype)
            return _tensor(np.asarray(x)[None], device, dtype)

        nested = {"inner": inner, "A": full_A}
    if cls is SchurState:
        d = {**d, "comm": None}
        nested = {"comm": lambda _: Comm()}
    return cls(**_lane_fields(cls, d, device, dtype, nested))
