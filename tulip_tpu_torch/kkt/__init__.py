"""KKT linear-system backends (counterpart of ``tulip_tpu/kkt``).

The IPM needs, at every iteration, solutions of the symmetric quasi-definite
augmented system (reference: src/KKT/KKT.jl:65-100)::

    [-(Θ⁻¹ + Rp)   Aᵀ] [dx]   [ξd]
    [   A          Rd] [dy] = [ξp]

Backends are frozen dataclasses implementing ``setup`` / ``update`` /
``solve`` over batch-first tensors; ``update`` returns a per-lane success
flag that the IPM's regularization ladder branches on.
"""

from .base import KKTBackend
from .dense import DenseK1Backend, DenseK1State
from .small_k1 import SmallK1Backend

__all__ = ["KKTBackend", "DenseK1Backend", "DenseK1State", "SmallK1Backend"]
