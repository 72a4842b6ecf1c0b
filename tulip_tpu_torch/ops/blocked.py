"""Cholesky factor and its inverse for large dense SPD matrices.

Counterpart of ``tulip_tpu/ops/blocked.py``. The reference computes L and
L⁻¹ by a recursive bisection whose work above a leaf size is plain GEMMs,
because XLA's Cholesky and triangular solve on the TPU serialize on narrow
panels (``tulip_tpu/ops/blocked.py:1-31``). That recursion works around
the TPU's compiler and is not ported: here ``torch.linalg.cholesky_ex``
and ``torch.linalg.solve_triangular`` (cuSOLVER and cuBLAS on the card)
compute the same L and L⁻¹.
"""

from __future__ import annotations

from typing import Tuple

import torch


def cholesky_invfactor_blocked(K: torch.Tensor, leaf: int = 2048,
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(L, X)`` with ``K = L Lᵀ`` and ``X = L⁻¹`` for a batch K (B, m, m).

    ``leaf`` is the reference's recursion leaf size; it is accepted for
    the same signature and unused. A non-SPD lane gives NaN in its own L
    and X (in no other lane) and nothing is raised, so that callers detect
    failure with ``isfinite``, as with the reference.
    """
    del leaf
    L, info = torch.linalg.cholesky_ex(K)
    L = L.masked_fill((info > 0)[:, None, None], float("nan"))
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    X = torch.linalg.solve_triangular(L, eye.expand_as(K), upper=False)
    return L, X
