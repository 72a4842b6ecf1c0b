"""Staircase (time-structured) equality LPs: stage blocks of ``mr`` rows
by ``nc`` columns, each stage coupled to the next, optional global linking
columns. The reference's sparse-first scale point
(``examples/large_sparse.py:staircase``, ``BASELINE.md``) is
``staircase_lp(32768)``.

``staircase_lp`` is a copy of ``tests/golden_large.py:staircase_lp`` (the
same seed gives the same LP; a test pins a hash of its output), without
the JAX package that file imports.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def staircase_lp(m, mr=64, nc=96, dense_cols=0, cyclic=False, seed=0,
                 dense_scale=0.5):
    """Staircase (time-structured) equality LP; ``cyclic`` adds the
    wrap-around coupling that defeats a pure band ordering;
    ``dense_cols`` adds global linking columns (the K1-fill killer)."""
    rng = np.random.default_rng(seed)
    stages = m // mr
    n = stages * nc + (0 if cyclic else nc)
    I, J, V = [], [], []
    for s in range(stages):
        for c0 in (s * nc, ((s + 1) % stages) * nc if cyclic
                   else (s + 1) * nc):
            ii, jj = np.meshgrid(np.arange(s * mr, (s + 1) * mr),
                                 np.arange(c0, c0 + nc), indexing="ij")
            I.append(ii.ravel())
            J.append(jj.ravel())
            V.append(rng.standard_normal(mr * nc))
    for k in range(dense_cols):
        I.append(np.arange(m))
        J.append(np.full(m, (7 * k) % n))
        V.append(rng.standard_normal(m) * dense_scale)
    I, J, V = map(np.concatenate, (I, J, V))
    A = sp.csr_matrix((V, (I, J)), shape=(m, n))
    u = rng.uniform(1, 3, n)
    x0 = u * rng.uniform(0.3, 0.7, n)
    return A, np.asarray(A @ x0), rng.standard_normal(n), u


def pool(cfg: dict, traffic: dict, seed: int, device) -> list:
    """``traffic["pool"]`` LPs of the configuration's ``rows``, one
    pattern, values from seeds drawn from ``seed``: each a dict of the
    sparse ``A`` (scipy CSR) and the float64 arrays ``b``, ``c``, ``u``,
    on the host."""
    seeds = np.random.SeedSequence(seed).generate_state(traffic["pool"],
                                                        np.uint64)
    out = []
    for s in seeds:
        A, b, c, u = staircase_lp(cfg["rows"], mr=cfg["stage_rows"],
                                  nc=cfg["stage_cols"], seed=int(s))
        out.append(dict(A=A, b=b, c=c, u=u))
    return out
