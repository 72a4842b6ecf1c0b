"""Random feasible LPs min cᵀx, Ax = b, 0 ≤ x ≤ u, with b = A·x0 for an
interior x0: the recipe of the project's own benchmark (``bench.py``).

``make_raw_instances`` is a copy of ``bench.py:make_raw_instances`` (the
same seed gives the same LPs; a test pins a hash of its output). The pool
is made on the host with it.
"""

from __future__ import annotations

import numpy as np
import torch


def make_raw_instances(nb, m, n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(nb):
        A = rng.standard_normal((m, n))
        u = rng.uniform(1.0, 4.0, n)
        x0 = u * rng.uniform(0.2, 0.8, n)
        b = A @ x0
        c = rng.standard_normal(n)
        out.append((A, b, c, u))
    return out


def pool(cfg: dict, traffic: dict, seed: int, device) -> list:
    """``traffic["pool"]`` batches of ``traffic["batch"]`` LPs of the
    configuration's ``rows`` × ``cols``, each a dict of float64 host
    tensors ``A`` (B, m, n), ``b`` (B, m), ``c`` and ``u`` (B, n) from
    :func:`make_raw_instances`."""
    P, B = traffic["pool"], traffic["batch"]
    seeds = np.random.SeedSequence(seed).generate_state(P, np.uint64)
    out = []
    for s in seeds:
        raws = make_raw_instances(B, cfg["rows"], cfg["cols"], seed=int(s))
        out.append({k: torch.as_tensor(np.stack([r[i] for r in raws]))
                    for i, k in enumerate("Abcu")})
    return out
