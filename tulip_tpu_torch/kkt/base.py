"""KKT backend base class: the setup/update/solve contract.

Counterpart of ``tulip_tpu/kkt/base.py``. Every tensor a backend sees has a
leading batch axis; ``update`` returns a per-lane (B,) success flag.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch


def bmv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product: (B, r, k) x (B, k) -> (B, r)."""
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def bmtv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched transposed product: (B, r, k) x (B, r) -> (B, k)."""
    return (M.transpose(-1, -2) @ v.unsqueeze(-1)).squeeze(-1)


@dataclasses.dataclass(frozen=True)
class KKTBackend:
    """Immutable static configuration for a KKT solver backend.

    ``refinement_steps``: fixed count of iterative-refinement sweeps applied
    after each solve (the reference leaves refinement as a TODO,
    src/KKT/Dense/lapack.jl:117); in f32 it is what brings residuals near
    f64 grade.
    """

    refinement_steps: int = 0

    name = "abstract"
    systems: Tuple[str, ...] = ()
    # Experimental backends pass the conformance kit but are not validated
    # for full 1e-8 end-to-end solves; make_backend warns when it builds one.
    experimental = False
    # Gate of the conformance kit's late-IPM ill-conditioning sweeps
    # (kkt/testkit.py): the largest scale-aware relative residual on the
    # 16-decade θ sweep. None opts out (matrix-free backends).
    sweep_resid_atol = 1e-6

    # -- introspection (reference: src/KKT/KKT.jl:103-121) ---------------
    def arithmetic_label(self, dtype: torch.dtype) -> str:
        """Label for the solver-header log: the dtype's name, as numpy
        spells it ("float64")."""
        return str(dtype).replace("torch.", "")

    def linear_system(self) -> str:
        return self.systems[0] if self.systems else "unknown"

    def setup(self, A: torch.Tensor) -> Any:
        raise NotImplementedError

    def setup_data(self, dat) -> Any:
        """Build solver state from LP data (dense constraint matrix)."""
        return self.setup(dat.A)

    def update(self, state: Any, theta_inv: torch.Tensor,
               regP: torch.Tensor, regD: torch.Tensor,
               ) -> Tuple[Any, torch.Tensor]:
        raise NotImplementedError

    def solve(self, state: Any, xi_p: torch.Tensor,
              xi_d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def solve_unrefined(self, state: Any, xi_p: torch.Tensor,
                        xi_d: torch.Tensor,
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Solve WITHOUT the backend's iterative-refinement sweeps (the
        IPM's FastPredictor/FastCorrections options). Falls back to the
        full solve when the backend has no base/refine split."""
        base = getattr(self, "_base_solve", None)
        if base is None:
            return self.solve(state, xi_p, xi_d)
        return base(state, xi_p, xi_d)

    def _refine(self, state, xi_p, xi_d, dx, dy, base_solve):
        """Iterative refinement on the augmented system.

        Residuals: rd = ξd - (-(Θ⁻¹+Rp)dx + Aᵀdy), rp = ξp - (A dx + Rd dy);
        correction solved with the existing factorization.
        """
        for _ in range(self.refinement_steps):
            rd = xi_d - (-(state.theta_reg * dx) + bmtv(state.A, dy))
            rp = xi_p - (bmv(state.A, dx) + state.regD * dy)
            ddx, ddy = base_solve(state, rp, rd)
            dx = dx + ddx
            dy = dy + ddy
        return dx, dy
