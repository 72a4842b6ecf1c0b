"""K1 backend for small batched instances through the chol-inv kernel.

Counterpart of ``tulip_tpu/kkt/pallas_chol.py:PallasSmallK1Backend``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.chol import MAX_M, batched_cholesky_inverse
from ..ops.solve import batched_fused_k1_solve
from .dense import DenseK1Backend, DenseK1State, identity_where_failed, \
    normal_matrix


@dataclasses.dataclass(frozen=True)
class SmallK1Backend(DenseK1Backend):
    """Inverse-factor K1 backend whose factorization is the hand-written
    Cholesky + triangular-inverse kernel (``ops/chol.py``, ``csrc/chol_inv.cu``);
    the port of ``PallasSmallK1Backend``. Solves are GEMVs with L⁻¹.

    Routing follows the reference (``pallas_chol.py:112-117``): float32
    with m ≤ 1024 goes to ``batched_cholesky_inverse``, which launches the
    kernel on a CUDA tensor and runs its plain version on a CPU tensor;
    float64, or m > 1024, goes to ``DenseK1Backend(inv_factor=True)``.

    ``fused_solve=True`` sends ``solve`` (with its ``refinement_steps``
    sweeps) to ``batched_fused_k1_solve`` (``ops/solve.py``,
    ``csrc/fused_solve.cu``) under the same gate (``pallas_chol.py:152-160``);
    ``solve_unrefined`` stays the unfused ``_base_solve``, as in the
    reference.

    ``pack`` is not a tuning option: it exists so that a solve can drive
    the packed chol-inv launch (the port of the reference's lane-packed
    kernel, which the reference reaches only through
    ``batched_cholesky_inverse(K, pack=p)``), as ``chip_smoke.py``'s warm
    re-solve does. It is the count of instances per thread block (0 = one,
    the default); the output does not depend on it, and the reference's
    backend has no such field.
    """

    name = "pallas-small"
    inv_factor: bool = True
    fused_solve: bool = False
    pack: int = 0

    def __post_init__(self):
        if not self.inv_factor:
            raise ValueError("SmallK1Backend stores L⁻¹: inv_factor must "
                             "stay True")

    def update(self, state: DenseK1State, theta_inv, regP, regD):
        A = state.A
        if A.dtype != torch.float32 or A.shape[-2] > MAX_M:
            return DenseK1Backend.update(self, state, theta_inv, regP, regD)
        theta_reg = theta_inv + regP
        d = 1.0 / theta_reg
        K = normal_matrix(A, d, regD)
        Linv, ok = identity_where_failed(
            batched_cholesky_inverse(K, pack=self.pack))
        return (DenseK1State(A=A, d=d, theta_reg=theta_reg, regD=regD,
                             L=Linv), ok)

    def solve(self, state: DenseK1State, xi_p, xi_d):
        A = state.A
        if not (self.fused_solve and A.dtype == torch.float32
                and A.shape[-2] <= MAX_M):
            return DenseK1Backend.solve(self, state, xi_p, xi_d)
        args = (A, state.L, state.d, state.theta_reg, state.regD, xi_p, xi_d)
        return batched_fused_k1_solve(*(t.contiguous() for t in args),
                                      refine=self.refinement_steps)
