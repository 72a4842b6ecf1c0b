"""tulip_tpu_torch — the tulip_tpu LP solver in PyTorch, for NVIDIA GPUs.

A port of ``tulip_tpu`` (JAX/XLA/Pallas) beside it in the same repository;
``tulip_tpu`` stays the reference that this package is tested against. The
module layout mirrors ``tulip_tpu``'s, so each module has a counterpart
there. So far it covers the batched HSD path: ``batch_linprog`` and
``ipm.batched_hsd_solve`` with the dense K1 backends, whose f32
factorization on CUDA is the hand-written kernel ``csrc/chol_inv.cu``.

Host layers (problem data, parameters, statuses, presolve) are numpy code
copied verbatim from ``tulip_tpu``, so this package runs where JAX is not
installed. It does not change torch's global default dtype: every entry
that builds tensors takes ``device`` (default ``"cuda"``) and ``dtype``.
"""

__version__ = "0.1.0"

from .linprog import LinprogResult, batch_linprog  # noqa: E402
from .params import (IPMOptions, KKTOptions, Parameters,  # noqa: E402
                     PresolveOptions)
from .problem import ProblemData  # noqa: E402
from .solution import Solution  # noqa: E402
from .status import SolutionStatus, TerminationStatus  # noqa: E402

__all__ = [
    "TerminationStatus",
    "SolutionStatus",
    "Parameters",
    "IPMOptions",
    "KKTOptions",
    "PresolveOptions",
    "ProblemData",
    "Solution",
    "LinprogResult",
    "batch_linprog",
]
