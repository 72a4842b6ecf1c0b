"""tulip_tpu_torch — the tulip_tpu LP solver in PyTorch, for NVIDIA GPUs.

A port of ``tulip_tpu`` (JAX/XLA/Pallas) beside it in the same repository;
``tulip_tpu`` stays the reference that this package is tested against. The
module layout mirrors ``tulip_tpu``'s, so each module has a counterpart
there. So far it covers:

- one LP: ``Model.optimize()``, ``linprog``, the CLI and the MPS reader,
  with HSD or MPC, and every route ``Model.optimize()`` takes at its
  defaults: the dense K1 backends ``"dense"``, ``"pallas-small"`` (f32
  on the card) and ``"dense-pallas"``; from m = 2048 rows the structure
  probe's ``"banded"``, ``"sparse"``, ``"sparse-smw"`` and the tiled K2
  ``"sparse-ldl"``; from ``KKT.SparseFirstThreshold`` rows the
  sparse-first data path (no dense A) through ``"sparse"`` or
  ``"sparse-smw"``; ``KKT.System="K2"`` through ``"dense-ldl"`` (below
  m = 2048) or ``"sparse-ldl"``; the precision ladder, ``"extended"``
  (f64 below 1e-9), ``"extended-dd"`` and ``"dense-mixed"``; and, when
  named, the thirteen matrix-free Krylov backends (``"cg"``,
  ``"sqd-minres"``, ``"lsmr"``, ...);
- many LPs: ``batch_linprog`` (HSD or MPC), ``ipm.batched_hsd_solve``,
  ``ipm.batched_mpc_solve`` and the warm-started
  ``ipm.batched_hsd_resolve``;
- many processes (``parallel``, on ``torch.distributed``): block-angular
  two-stage LPs through the distributed Schur-complement backend
  ``"schur"`` with their scenarios sharded (``parallel.shard_scenarios``),
  and a batch split over processes (``ipm.batch.shard_batch``,
  ``gather_lanes``).

Three hand-written CUDA kernels serve the f32 paths on the card:
``csrc/chol_inv.cu`` (the factorization of ``"pallas-small"``, one or
``pack`` instances per thread block), ``csrc/fused_solve.cu`` (its solve,
with ``SmallK1Backend(fused_solve=True)``) and ``csrc/scaled_gram.cu``
(K = A·diag(d)·Aᵀ of ``"dense-pallas"``). The other routes are
torch.linalg, cuBLAS and elementwise torch ops, as the reference's are
XLA library calls.

Host layers (problem data, parameters, statuses, presolve, MPS reading)
are numpy code copied from ``tulip_tpu``, so this package runs where JAX is
not installed; ``problem.py`` and ``presolve/`` keep a bulk-loaded matrix
in CSR/CSC arrays. It does not change torch's global default
dtype: every entry that builds tensors takes ``device`` (default
``"cuda"``) and ``dtype``.
"""

__version__ = "0.1.0"

from .api import (get_attribute, get_parameter, load_problem,  # noqa: E402
                  set_attribute, set_parameter)
from .io import read_mps  # noqa: E402
from .kkt import make_backend  # noqa: E402
from .linprog import LinprogResult, batch_linprog, linprog  # noqa: E402
from .model import Model  # noqa: E402
from . import parallel  # noqa: E402
from .params import (IPMOptions, KKTOptions, Parameters,  # noqa: E402
                     PresolveOptions)
from .problem import ProblemData  # noqa: E402
from .solution import Solution  # noqa: E402
from .status import SolutionStatus, TerminationStatus  # noqa: E402
from . import trace  # noqa: E402

__all__ = [
    "TerminationStatus",
    "SolutionStatus",
    "Parameters",
    "IPMOptions",
    "KKTOptions",
    "PresolveOptions",
    "ProblemData",
    "Solution",
    "Model",
    "load_problem",
    "get_parameter",
    "set_parameter",
    "get_attribute",
    "set_attribute",
    "read_mps",
    "make_backend",
    "LinprogResult",
    "linprog",
    "batch_linprog",
]


def version() -> str:
    return __version__
