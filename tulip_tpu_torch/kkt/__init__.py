"""KKT linear-system backends (counterpart of ``tulip_tpu/kkt``).

The IPM needs, at every iteration, solutions of the symmetric quasi-definite
augmented system (reference: src/KKT/KKT.jl:65-100)::

    [-(Θ⁻¹ + Rp)   Aᵀ] [dx]   [ξd]
    [   A          Rd] [dy] = [ξp]

Backends are frozen dataclasses implementing ``setup`` / ``update`` /
``solve`` over batch-first tensors; ``update`` returns a per-lane success
flag that the IPM's regularization ladder branches on.

The registry uses the reference's names, so ``Parameters.KKT.Backend``
means the same backend in both packages. Every name the reference
registers is ported except ``"schur"``, which raises
``NotImplementedError`` naming the ROADMAP item that will port it; it
never falls back to another backend.
"""

from __future__ import annotations

import warnings
from typing import Dict, Type

from .banded import BandedK1Backend
from .base import KKTBackend
from .dense import DenseK1Backend, DenseK1State
from .dense_ldl import DenseK2Backend
from .extended import ExtendedDDK1Backend, ExtendedK1Backend
from .gram import GramK1Backend
from .krylov import (CarK1Backend, CgK1Backend, CraigK1Backend,
                     CraigmrK1Backend, CrK1Backend, LsmrK1Backend,
                     LsqrK1Backend, MinaresK2Backend, MinresK2Backend,
                     MinresQlpK2Backend, SqdMinresK2Backend, SymmlqK2Backend,
                     TricgK2Backend)
from .mixed import MixedK1Backend
from .small_k1 import SmallK1Backend
from .sparse import SparseK1Backend
from .sparse_ldl import SparseK2Backend
from .splitting import SplitK1Backend

_REGISTRY: Dict[str, Type[KKTBackend]] = {}

# The reference's other registered backends, each with the ROADMAP item
# that will port it.
UNPORTED: Dict[str, str] = {
    "schur": "ROADMAP queue 1, item 10 (distributed Schur path)",
}


def register(cls: Type[KKTBackend]) -> Type[KKTBackend]:
    _REGISTRY[cls.name] = cls
    return cls


for _cls in (DenseK1Backend, GramK1Backend, SmallK1Backend,
             BandedK1Backend, SparseK1Backend, SplitK1Backend,
             DenseK2Backend, SparseK2Backend, MixedK1Backend,
             ExtendedK1Backend, ExtendedDDK1Backend,
             CarK1Backend, CgK1Backend, CraigK1Backend, CraigmrK1Backend,
             CrK1Backend, LsmrK1Backend, LsqrK1Backend, MinaresK2Backend,
             MinresK2Backend, MinresQlpK2Backend, SqdMinresK2Backend,
             SymmlqK2Backend, TricgK2Backend):
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
    if cls.experimental:
        warnings.warn(
            f"KKT backend {name!r} is experimental: it passes the "
            "augmented-system conformance kit but is not validated for "
            "full 1e-8 end-to-end solves", stacklevel=2)
    return cls(refinement_steps=refinement_steps, **kwargs)


__all__ = ["KKTBackend", "DenseK1Backend", "DenseK1State", "GramK1Backend",
           "SmallK1Backend", "BandedK1Backend", "SparseK1Backend",
           "SplitK1Backend", "DenseK2Backend", "SparseK2Backend",
           "MixedK1Backend", "ExtendedK1Backend", "ExtendedDDK1Backend",
           "CarK1Backend", "CgK1Backend", "CraigK1Backend",
           "CraigmrK1Backend", "CrK1Backend", "LsmrK1Backend",
           "LsqrK1Backend", "MinaresK2Backend", "MinresK2Backend",
           "MinresQlpK2Backend", "SqdMinresK2Backend", "SymmlqK2Backend",
           "TricgK2Backend", "make_backend", "available_backends",
           "register"]
