"""A plain reference for the tests that never makes an LP's A dense: A
is kept as row blocks of at most ``ROWS`` rows, each a dense block of
only the columns it touches, A·x is the sum of the block products, and
the LP is solved by HiGHS on the sparse A. It takes a pool item with a
sparse A (one LP), as the staircase generator makes it."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch
from scipy.optimize import linprog

from portbench.reference import Solved

ROWS = 64


class BlocksLP:
    def __init__(self, A, b, c, u, blocks):
        self.A, self.b, self.c, self.u = A, b, c, u
        self.blocks = blocks        # [(first column, end column, block)]

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([blk @ x[:, c0:c1].mT for c0, c1, blk in
                          self.blocks]).mT


def build(item: dict, device) -> BlocksLP:
    if not sp.issparse(item["A"]):
        raise TypeError("the blocks reference takes a sparse A (one LP)")
    A = item["A"].tocsr()
    blocks = []
    for r0 in range(0, A.shape[0], ROWS):
        rows = A[r0:r0 + ROWS]
        c0, c1 = int(rows.indices.min()), int(rows.indices.max()) + 1
        blocks.append((c0, c1, torch.as_tensor(
            rows[:, c0:c1].toarray(), device=device)))
    b, c, u = (torch.as_tensor(np.asarray(item[k], dtype=np.float64),
                               device=device)[None] for k in "bcu")
    return BlocksLP(A, b, c, u, blocks)


def solve(lp: BlocksLP, *, precision: str = "float64",
          tol: float = 1e-9) -> Solved:
    if precision != "float64":
        raise ValueError("HiGHS solves in float64 only")
    u = lp.u[0].cpu().numpy()
    h = linprog(lp.c[0].cpu().numpy(), A_eq=lp.A, b_eq=lp.b[0].cpu().numpy(),
                bounds=np.stack([0 * u, u], 1), method="highs")
    x = torch.as_tensor(h.x, device=lp.b.device)[None]
    return Solved(converged=torch.tensor([h.status == 0], device=x.device),
                  obj=(lp.c * x).sum(-1), x=x, iters=int(h.nit))
