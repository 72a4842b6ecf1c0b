"""KKT linear-system backends (counterpart of ``tulip_tpu/kkt``).

The IPM needs, at every iteration, solutions of the symmetric quasi-definite
augmented system (reference: src/KKT/KKT.jl:65-100)::

    [-(Θ⁻¹ + Rp)   Aᵀ] [dx]   [ξd]
    [   A          Rd] [dy] = [ξp]

Backends are frozen dataclasses implementing ``setup`` / ``update`` /
``solve`` over batch-first tensors; ``update`` returns a per-lane success
flag that the IPM's regularization ladder branches on.

The registry uses the reference's names, so ``Parameters.KKT.Backend``
means the same backend in both packages. A name the reference registers
but this package has not ported raises ``NotImplementedError`` naming the
ROADMAP item that will port it; it never falls back to another backend.
"""

from __future__ import annotations

from typing import Dict, Type

from .banded import BandedK1Backend
from .base import KKTBackend
from .dense import DenseK1Backend, DenseK1State
from .gram import GramK1Backend
from .small_k1 import SmallK1Backend
from .sparse import SparseK1Backend

_REGISTRY: Dict[str, Type[KKTBackend]] = {}

_PRECISION = "ROADMAP queue 1, item 6 (precision ladder)"
_K2 = "ROADMAP queue 1, item 7 (kkt/dense_ldl.py)"
_SPARSE_FIRST = "ROADMAP queue 1, item 8b (the sparse-first data path)"
_SPARSE_K2 = "ROADMAP queue 1, item 8c (kkt/sparse_ldl.py)"
_KRYLOV = "ROADMAP queue 1, item 9 (kkt/krylov.py)"
_DISTRIBUTED = "ROADMAP queue 1, item 10 (distributed Schur path)"

# The reference's other registered backends, each with the ROADMAP item
# that will port it.
UNPORTED: Dict[str, str] = {
    "dense-mixed": _PRECISION, "extended": _PRECISION,
    "extended-dd": _PRECISION,
    "dense-ldl": _K2,
    "sparse-smw": _SPARSE_FIRST, "sparse-ldl": _SPARSE_K2,
    **{k: _KRYLOV for k in ("car", "cg", "cr", "craig", "craigmr", "lsmr",
                            "lsqr", "minares", "minres", "minres-qlp",
                            "sqd-minres", "symmlq", "tricg")},
    "schur": _DISTRIBUTED,
}


def register(cls: Type[KKTBackend]) -> Type[KKTBackend]:
    _REGISTRY[cls.name] = cls
    return cls


for _cls in (DenseK1Backend, GramK1Backend, SmallK1Backend,
             BandedK1Backend, SparseK1Backend):
    register(_cls)


def available_backends() -> Dict[str, Type[KKTBackend]]:
    return dict(_REGISTRY)


def make_backend(name=None, system=None, refinement_steps: int = 0,
                 **kwargs) -> KKTBackend:
    """Instantiate a backend by name (default: dense K1, as in the
    reference, ``tulip_tpu/kkt/__init__.py:74-93``)."""
    if name is None:
        name = "dense" if system in (None, "K1") else "dense-ldl"
    if name in UNPORTED and name not in _REGISTRY:
        raise NotImplementedError(
            f"KKT backend {name!r} is not ported yet: {UNPORTED[name]}")
    cls = _REGISTRY[name]
    if system is not None and system not in cls.systems:
        raise ValueError(f"backend {name!r} does not support system {system!r}")
    return cls(refinement_steps=refinement_steps, **kwargs)


__all__ = ["KKTBackend", "DenseK1Backend", "DenseK1State", "GramK1Backend",
           "SmallK1Backend", "BandedK1Backend", "SparseK1Backend",
           "make_backend", "available_backends", "register"]
