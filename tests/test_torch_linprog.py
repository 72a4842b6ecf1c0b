"""Port parity: ``tulip_tpu_torch.batch_linprog`` against the JAX package's
``batch_linprog`` on the problem sets of tests/test_batch.py, in f64 on the
CPU (presolve, shape buckets, decided-by-presolve lanes, postsolve)."""

import numpy as np
import pytest
import torch

import tulip_tpu as tlp
import tulip_tpu_torch as tlt

torch.set_num_threads(1)


def feasible(rng, m, n):
    A = rng.standard_normal((m, n))
    u = rng.uniform(1, 4, n)
    x0 = u * rng.uniform(0.2, 0.8, n)
    b = A @ x0
    c = rng.standard_normal(n)
    return dict(c=c, A_eq=A, b_eq=b, bounds=list(zip(np.zeros(n), u)))


def heterogeneous():
    """tests/test_batch.py:test_batch_linprog_heterogeneous."""
    rng = np.random.default_rng(0)
    probs = []
    for _ in range(6):
        m, n = int(rng.integers(4, 10)), int(rng.integers(10, 20))
        probs.append(feasible(rng, m, n))
    probs.append(dict(c=[1.0], A_eq=[[1.0]], b_eq=[5.0],
                      bounds=[(0.0, 1.0)]))  # infeasible lane
    return probs


def presolve_paths():
    """tests/test_batch.py:test_batch_linprog_presolve_paths."""
    rng = np.random.default_rng(7)
    p = feasible(rng, 5, 10)
    u = [ub for _, ub in p["bounds"]]
    bounds_fix = list(p["bounds"])
    bounds_fix[3] = (u[3] * 0.5, u[3] * 0.5)
    return [p, dict(p, bounds=bounds_fix),
            dict(c=[1.0, 1.0], A_eq=[[1.0, 0.0]], b_eq=[5.0],
                 bounds=[(0.0, 1.0), (0.0, 1.0)])]   # decided: infeasible


def size_skew():
    """tests/test_batch.py:test_batch_linprog_bucketed_size_skew."""
    rng = np.random.default_rng(3)
    return [feasible(rng, m, n)
            for (m, n) in [(16, 32)] * 4 + [(24, 48), (40, 80), (64, 128)]]


def mixed_forms():
    """Inequality rows, free variables and an unbounded lane."""
    rng = np.random.default_rng(9)
    probs = []
    for _ in range(3):
        m, n = 5, 8
        A = rng.standard_normal((m, n))
        x0 = rng.uniform(0.5, 1.5, n)
        probs.append(dict(c=rng.uniform(0.5, 1.5, n), A_ub=-A,
                          b_ub=-(A @ x0) + 0.1,
                          bounds=[(None, None)] * 2 + [(0, 3)] * (n - 2)))
    probs.append(dict(c=[-1.0, -1.0], A_ub=[[1.0, -1.0]], b_ub=[1.0]))
    return probs


@pytest.mark.parametrize("make,presolve", [
    (heterogeneous, None), (presolve_paths, None), (presolve_paths, False),
    (size_skew, False), (mixed_forms, None)],
    ids=["heterogeneous", "presolve", "no-presolve", "size-skew", "forms"])
def test_batch_linprog_matches_jax(make, presolve):
    probs = make()
    want = tlp.batch_linprog(probs, dtype="float64", presolve=presolve)
    got = tlt.batch_linprog(probs, device="cpu", dtype="float64",
                            presolve=presolve)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.status, g.termination, g.nit) == \
            (w.status, w.termination, w.nit), g.message
        if w.success:
            # f64 on both sides; iterates agree to summation order.
            assert abs(g.fun - w.fun) <= 1e-6 * max(1.0, abs(w.fun))
            np.testing.assert_allclose(g.x, w.x, atol=1e-6, rtol=0)
    assert any(w.success for w in want)
