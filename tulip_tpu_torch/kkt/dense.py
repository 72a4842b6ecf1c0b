"""Dense K1 (normal equations) backend.

Counterpart of ``tulip_tpu/kkt/dense.py``. Solves the augmented system by
pivoting on its (1,1) block: with ``D = (Θ⁻¹ + Rp)⁻¹`` the Schur complement
is the SPD normal-equations matrix ``K = A D Aᵀ + Rd``, factorized by dense
Cholesky (reference semantics: src/KKT/Dense/lapack.jl:65-119; K1 system
src/KKT/systems.jl:34-54).

- ``K = (A √D)(A √D)ᵀ`` is one batched GEMM.
- The factorization is ``torch.linalg.cholesky_ex``, whose ``info`` turns
  into the per-lane ``ok`` flag the IPM's regularization ladder branches on.
- With ``inv_factor`` or ``explicit_minv`` the update forms L⁻¹ through
  ``ops/blocked.py``'s ``cholesky_invfactor_blocked`` at every m. The
  reference takes that module from ``blocked_min`` on, for a recursion
  that works around XLA's Cholesky on the TPU; the port's computes L⁻¹
  with ``torch.linalg`` alone.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from ..ops.blocked import cholesky_invfactor_blocked
from .base import KKTBackend, bmtv, bmv

# JAX's matmul precision names -> the f32 matmul mode on the card (see
# f32_matmul_precision).
_MODES = {"highest": "ieee", "float32": "ieee",
          "high": "tf32x3", "bfloat16_3x": "tf32x3", "tensorfloat32": "tf32x3",
          "default": "tf32", "bfloat16": "tf32"}


def matmul_mode(name: Optional[str]) -> Optional[str]:
    """``"ieee"``, ``"tf32x3"`` or ``"tf32"`` for JAX's precision ``name``
    (None for None); an unknown name raises ``ValueError``."""
    if name is None:
        return None
    try:
        return _MODES[name]
    except KeyError:
        raise ValueError(f"unknown matmul precision {name!r}; expected one "
                         f"of {sorted(_MODES)}") from None


@contextlib.contextmanager
def allow_tf32(on: bool):
    """torch's CUDA f32 matmul flag set to ``on`` for the block, and the
    caller's restored on exit and on an exception."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@contextlib.contextmanager
def f32_matmul_precision(name: Optional[str]):
    """The f32 matmul mode of the card for the duration of the block, from
    JAX's name of a precision (``jax.default_matmul_precision``); None
    leaves the caller's mode. The caller's setting is restored on exit and
    on an exception, and an unknown name raises ``ValueError``.

    - ``"highest"`` / ``"float32"``: IEEE f32;
    - ``"high"`` / ``"bfloat16_3x"`` / ``"tensorfloat32"``: IEEE f32 in
      the block, and the backend's own GEMMs (:func:`gemm` with mode
      ``"tf32x3"``) as three TF32 products of a hi/lo split, about 21
      bits;
    - ``"default"`` / ``"bfloat16"``: TF32 for every f32 matmul in the
      block. JAX's name asks for one bf16 pass, but torch runs f32
      operands on CUDA in IEEE f32 or TF32 only, so TF32 is the coarsest
      it offers.

    One TF32 pass keeps 10 mantissa bits where XLA's 3-pass bf16
    (``"high"`` on the TPU) keeps about 16: a single pass would leave
    ``"high"`` coarser on the card than on the TPU, so it takes the
    three-pass split instead, which is a little finer than the TPU's.
    Library factorizations and solves (Cholesky, triangular solves) run
    in IEEE f32 under ``"high"``: a split cannot reach inside them. Only
    ``torch.backends.cuda.matmul.allow_tf32`` is set and the split runs
    on CUDA f32 tensors only, so the setting changes nothing on a CPU
    tensor. Nested blocks nest: the innermost wins, as a backend's
    ``matmul_precision`` wins over the IPM's pin
    (``ipm.hsd.full_matmul_precision``).
    """
    mode = matmul_mode(name)
    if mode is None:
        yield
        return
    with allow_tf32(mode == "tf32"):
        yield


def tf32_split(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` with ``a = hi + lo`` exactly: ``hi`` is ``a`` cut to
    TF32's 10 mantissa bits (so a TF32 product takes it whole) and ``lo``
    the f32 rest."""
    hi = (a.view(torch.int32) & -8192).view(torch.float32)
    return hi, a - hi


def gemm(a: torch.Tensor, b: torch.Tensor,
         mode: Optional[str] = None) -> torch.Tensor:
    """``a @ b``. With ``mode="tf32x3"`` on CUDA f32 tensors it is
    ``hi_a·lo_b + lo_a·hi_b + hi_a·hi_b``, three TF32 products of
    :func:`tf32_split` (the ``lo·lo`` term is below f32's rounding of
    the sum); elsewhere one product in the mode torch is set to."""
    if mode != "tf32x3" or not a.is_cuda or a.dtype != torch.float32:
        return a @ b
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    with allow_tf32(True):
        return (ah @ bl + al @ bh) + ah @ bh


class DenseK1State(NamedTuple):
    A: torch.Tensor          # (B, m, n) constraint matrix (constant)
    d: torch.Tensor          # (B, n)  D = (Θ⁻¹ + Rp)⁻¹ diagonal
    theta_reg: torch.Tensor  # (B, n)  Θ⁻¹ + Rp (for refinement residuals)
    regD: torch.Tensor       # (B, m)
    L: torch.Tensor          # (B, m, m) Cholesky factor of K, L⁻¹ or K⁻¹


def normal_matrix(A: torch.Tensor, d: torch.Tensor, regD: torch.Tensor,
                  mode: Optional[str] = None) -> torch.Tensor:
    """K = (A √d)(A √d)ᵀ + diag(regD), per lane (:func:`gemm`'s
    ``mode``)."""
    Bm = A * torch.sqrt(d).unsqueeze(-2)
    return gemm(Bm, Bm.transpose(-1, -2), mode) + torch.diag_embed(regD)


def identity_where_failed(L: torch.Tensor) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """(L with failed lanes replaced by I, per-lane ok flag).

    ``ok`` reduces over the (m, m) axes of each lane only, as the
    reference's ``jnp.all(jnp.isfinite(L))`` does under vmap: one bad lane
    must not stall the others. The swap keeps downstream solves finite
    while the regularization ladder retries that lane.
    """
    ok = torch.isfinite(L).all(dim=-1).all(dim=-1)
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return torch.where(ok[:, None, None], L, eye), ok


@dataclasses.dataclass(frozen=True)
class DenseK1Backend(KKTBackend):
    """K1 backend.

    ``inv_factor=True`` additionally inverts the Cholesky factor at update
    time (one batched triangular solve with m right-hand sides), so every
    backsolve becomes two GEMVs instead of two triangular solves. Slightly
    less accurate than backsolves: pair with ``refinement_steps>=1`` in f32.

    ``explicit_minv=True`` stores the whole inverse ``K⁻¹ = L⁻ᵀL⁻¹`` (one
    more batched GEMM at update time), so that every base solve is one
    GEMV; its accuracy is the inverse-factor path's.

    ``blocked_min``: the reference's default (4096) and field, kept for
    the same signature. The reference forms L⁻¹ from this m by the
    recursion of ``ops/blocked.py``; the port's ``ops/blocked.py`` is the
    Cholesky and triangular solve that every m takes, so there is no
    second path to choose.

    ``matmul_precision``: the f32 matmul mode inside this backend's
    ``update`` and ``solve`` only (:func:`f32_matmul_precision`; None
    keeps the caller's, the IPM's pin of IEEE f32). Under ``"high"`` the
    Gram matrix and K⁻¹ are three TF32 products of a split (:func:`gemm`).
    """

    name = "dense"
    systems = ("K1",)
    inv_factor: bool = False
    explicit_minv: bool = False
    blocked_min: int = 4096
    matmul_precision: Optional[str] = None

    def __post_init__(self):
        matmul_mode(self.matmul_precision)

    def linear_system(self) -> str:
        return "Normal equations (K1)"

    def setup(self, A: torch.Tensor) -> DenseK1State:
        B, m, n = A.shape
        kw = dict(dtype=A.dtype, device=A.device)
        return DenseK1State(
            A=A,
            d=torch.ones(B, n, **kw),
            theta_reg=torch.ones(B, n, **kw),
            regD=torch.ones(B, m, **kw),
            L=torch.eye(m, **kw).expand(B, m, m).clone(),
        )

    def update(self, state: DenseK1State, theta_inv, regP, regD,
               ) -> Tuple[DenseK1State, torch.Tensor]:
        with f32_matmul_precision(self.matmul_precision):
            return self._update_impl(state, theta_inv, regP, regD)

    def _update_impl(self, state: DenseK1State, theta_inv, regP, regD,
                     ) -> Tuple[DenseK1State, torch.Tensor]:
        A = state.A
        theta_reg = theta_inv + regP
        d = 1.0 / theta_reg
        mode = matmul_mode(self.matmul_precision)
        K = normal_matrix(A, d, regD, mode)
        if self.inv_factor or self.explicit_minv:
            # Store L⁻¹ instead of L: one triangular solve with m RHS now,
            # GEMV-only solves afterwards.
            L, ok = identity_where_failed(cholesky_invfactor_blocked(K)[1])
        else:
            L, info = torch.linalg.cholesky_ex(K)
            L = L.masked_fill((info > 0)[:, None, None], float("nan"))
            L, ok = identity_where_failed(L)
        if self.explicit_minv:
            L = gemm(L.mT, L, mode)
        return (DenseK1State(A=A, d=d, theta_reg=theta_reg, regD=regD, L=L),
                ok)

    def _base_solve(self, state: DenseK1State, xi_p, xi_d):
        A, d, L = state.A, state.d, state.L
        rhs = xi_p + bmv(A, d * xi_d)
        if self.explicit_minv:
            dy = bmv(L, rhs)
        elif self.inv_factor:
            dy = bmtv(L, bmv(L, rhs))
        else:
            w = torch.linalg.solve_triangular(L, rhs.unsqueeze(-1),
                                              upper=False)
            dy = torch.linalg.solve_triangular(
                L.transpose(-1, -2), w, upper=True).squeeze(-1)
        dx = d * (bmtv(A, dy) - xi_d)
        return dx, dy

    def solve(self, state: DenseK1State, xi_p, xi_d):
        with f32_matmul_precision(self.matmul_precision):
            dx, dy = self._base_solve(state, xi_p, xi_d)
            return self._refine(state, xi_p, xi_d, dx, dy, self._base_solve)
