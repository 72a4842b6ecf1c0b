"""K1 backend whose normal-equations matrix is formed by the scaled-Gram
kernel.

Counterpart of ``tulip_tpu/kkt/pallas_chol.py:PallasK1Backend``
("dense-pallas").
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.gram import scaled_gram
from .dense import DenseK1Backend, DenseK1State, identity_where_failed


@dataclasses.dataclass(frozen=True)
class GramK1Backend(DenseK1Backend):
    """K1 backend with K = ``scaled_gram(A, d)`` + diag(Rd), factored by
    ``torch.linalg.cholesky_ex`` and solved by triangular solves with L,
    as the reference does (``jnp.linalg.cholesky`` and
    ``DenseK1Backend._base_solve``; neither is a Pallas kernel there).

    Dtype routing follows the reference (``pallas_chol.py:175-183``):
    float64 goes to :meth:`DenseK1Backend.update`; other dtypes form K
    with :func:`~tulip_tpu_torch.ops.gram.scaled_gram`, which launches
    ``csrc/scaled_gram.cu`` on a CUDA tensor (float32 only) and runs its
    plain version on a CPU tensor.
    """

    name = "dense-pallas"

    def __post_init__(self):
        if self.inv_factor:
            raise ValueError("GramK1Backend keeps L itself: inv_factor must "
                             "stay False")

    def update(self, state: DenseK1State, theta_inv, regP, regD):
        A = state.A
        if A.dtype == torch.float64:
            return DenseK1Backend.update(self, state, theta_inv, regP, regD)
        theta_reg = theta_inv + regP
        d = 1.0 / theta_reg
        K = scaled_gram(A, d) + torch.diag_embed(regD)
        L, info = torch.linalg.cholesky_ex(K)
        L = L.masked_fill((info > 0)[:, None, None], float("nan"))
        L, ok = identity_where_failed(L)
        return (DenseK1State(A=A, d=d, theta_reg=theta_reg, regD=regD, L=L),
                ok)
