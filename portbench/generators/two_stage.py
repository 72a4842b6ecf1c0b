"""Two-stage stochastic LPs in block-angular form

    min  c0'x0 + Σk ck'xk
    s.t. A0 x0 = b0,  Tk x0 + Wk xk = hk (k = 1..K),  0 ≤ x ≤ u,

by the recipe of ``tulip_tpu_torch/parallel/dryrun.py:two_stage_arrays``
(``__graft_entry__.py:_make_block_angular``'s), copied so that the
benchmark does not import the program for its data: A0, Tk and Wk
standard normal, u uniform on [1, 3], the interior point x = u/2 fixing
b0 = A0·x0 and hk = Tk·x0 + Wk·xk, so every LP is feasible and bounded,
and c standard normal.

One departure: the first stage and each scenario come from streams of
their own, spawned from the seed by (item, 0) and (item, 1 + k), where
``two_stage_arrays`` draws everything from one stream. A process that
holds scenarios lo..hi-1 makes its blocks of T and W without drawing the
other scenarios (:func:`scenarios`).
"""

from __future__ import annotations

import numpy as np


def _rng(seed: int, item: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence(seed, spawn_key=(item, stream)))


def dims(cfg: dict) -> tuple:
    """(m0, n0, mk, nk, K) of the configuration."""
    return cfg["m0"], cfg["n0"], cfg["mk"], cfg["nk"], cfg["scenarios"]


def first_stage(cfg: dict, seed: int, item: int) -> tuple:
    """(A0, b0, c0x, u0, x0) of pool item ``item``."""
    m0, n0, *_ = dims(cfg)
    rng = _rng(seed, item, 0)
    A0 = rng.standard_normal((m0, n0))
    u0 = rng.uniform(1, 3, n0)
    x0 = u0 * 0.5
    return A0, A0 @ x0, rng.standard_normal(n0), u0, x0


def scenarios(cfg: dict, seed: int, item: int, lo: int, hi: int,
              x0: np.ndarray) -> tuple:
    """(T, W, h, cks, uk) of scenarios lo..hi-1 of pool item ``item``:
    T (hi-lo, mk, n0), W (hi-lo, mk, nk), h (hi-lo, mk), cks and uk
    (hi-lo, nk)."""
    _, n0, mk, nk, _ = dims(cfg)
    k = hi - lo
    T = np.empty((k, mk, n0))
    W = np.empty((k, mk, nk))
    h = np.empty((k, mk))
    cks = np.empty((k, nk))
    uk = np.empty((k, nk))
    for i in range(k):
        rng = _rng(seed, item, 1 + lo + i)
        rng.standard_normal(out=T[i])
        rng.standard_normal(out=W[i])
        uk[i] = rng.uniform(1, 3, nk)
        cks[i] = rng.standard_normal(nk)
        h[i] = T[i] @ x0 + W[i] @ (uk[i] * 0.5)
    return T, W, h, cks, uk


def make_item(cfg: dict, seed: int, item: int) -> dict:
    """Pool item ``item`` whole: the arguments of
    ``tulip_tpu_torch.parallel.make_block_angular`` under their names
    (``A0``, ``b0``, ``c0x``, ``T``, ``W``, ``h``, ``cks``, ``l``, ``u``),
    host float64 arrays, and the ``seed`` and ``index`` it was made from."""
    *_, K = dims(cfg)
    A0, b0, c0x, u0, x0 = first_stage(cfg, seed, item)
    T, W, h, cks, uk = scenarios(cfg, seed, item, 0, K, x0)
    u = np.concatenate([u0, uk.reshape(-1)])
    return dict(A0=A0, b0=b0, c0x=c0x, T=T, W=W, h=h, cks=cks,
                l=np.zeros_like(u), u=u, seed=seed, index=item)


def pool(cfg: dict, traffic: dict, seed: int, device) -> list:
    """``traffic["pool"]`` whole LPs on the host (the harness's pool, for
    the check and the process that holds rank 0)."""
    return [make_item(cfg, seed, i) for i in range(traffic["pool"])]
