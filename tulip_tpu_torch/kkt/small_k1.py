"""K1 backend for small batched instances through the chol-inv kernel.

Counterpart of ``tulip_tpu/kkt/pallas_chol.py:PallasSmallK1Backend``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.chol import MAX_M, batched_cholesky_inverse
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
    ``fused_solve`` (the reference's ``ops/solve.py`` kernel) is not ported
    yet and raises.
    """

    name = "pallas-small"
    inv_factor: bool = True
    fused_solve: bool = False

    def __post_init__(self):
        if self.fused_solve:
            raise NotImplementedError(
                "fused_solve: the fused K1 solve kernel is not ported yet")
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
        Linv, ok = identity_where_failed(batched_cholesky_inverse(K))
        return (DenseK1State(A=A, d=d, theta_reg=theta_reg, regD=regD,
                             L=Linv), ok)
