"""The dense box reference, the default of a configuration that names
none: each pool item's A made dense on the device once, the LP solved by
``reference.solve_box_lp`` (dense normal equations), A·x read as
``A @ x``."""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.check import box_batch
from portbench.reference import Solved, solve_box_lp


class BoxLP(NamedTuple):
    A: torch.Tensor     # (B, m, n)
    b: torch.Tensor     # (B, m)
    c: torch.Tensor     # (B, n)
    u: torch.Tensor     # (B, n)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return (self.A @ x.unsqueeze(-1)).squeeze(-1)


def build(item: dict, device) -> BoxLP:
    return BoxLP(*box_batch(item, device))


def solve(lp: BoxLP, *, precision: str = "float64",
          tol: float = 1e-9) -> Solved:
    return solve_box_lp(lp.A, lp.b, lp.c, lp.u, precision=precision,
                        tol=tol)
