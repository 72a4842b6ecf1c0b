"""Port parity of the Krylov family (``tulip_tpu_torch/kkt/krylov.py``) on
the CPU: the ten solver functions against the JAX package's on seeded
operators of the right kind, the reference's own property tests
(tests/test_kkt.py) run on the port, masked batching bit for bit against
single-lane solves, and the thirteen backends through the port's
conformance kit and against the reference backend's solve on the same
state."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tulip_tpu.kkt as jkkt
import tulip_tpu.kkt.krylov as jk
from test_kkt import A_np
from tulip_tpu_torch import kkt
from tulip_tpu_torch.kkt import DenseK1Backend, make_backend
from tulip_tpu_torch.kkt import krylov as tk
from tulip_tpu_torch.kkt.krylov import bmtv, bmv
from tulip_tpu_torch.kkt.testkit import run_ls_tests

torch.set_num_threads(1)

KRYLOV_NAMES = ["car", "cg", "cr", "craig", "craigmr", "lsmr", "lsqr",
                "minares", "minres", "minres-qlp", "sqd-minres", "symmlq",
                "tricg"]


def orthogonal(rng, n):
    return np.linalg.qr(rng.standard_normal((n, n)))[0]


def spd(rng, n, lo=0.5, hi=5.0):
    Q = orthogonal(rng, n)
    return Q @ np.diag(rng.uniform(lo, hi, n)) @ Q.T


def indefinite(rng, n):
    Q = orthogonal(rng, n)
    return Q @ np.diag(rng.uniform(0.5, 5.0, n) * rng.choice([-1, 1], n)) \
        @ Q.T


def lane(x):
    """A numpy array as a one-lane f64 tensor."""
    return torch.tensor(np.asarray(x))[None]


def jmv(M):
    Mj = jnp.asarray(M)
    return lambda v: Mj @ v


def jrmv(M):
    Mj = jnp.asarray(M)
    return lambda u: Mj.T @ u


def tmv(M):
    """Batched matvec closure over a (B, r, k) tensor."""
    return lambda v: bmv(M, v)


def trmv(M):
    return lambda u: bmtv(M, u)


def rel(got, want):
    got, want = np.asarray(got).ravel(), np.asarray(want).ravel()
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def solver_case(name, seed=0):
    """(the reference's solution, the port's solution for one lane, the
    exact solution) of solver ``name`` at rtol 1e-12 on a seeded operator
    of its kind: SPD for pcg/cr/car, symmetric indefinite for
    minres/minres_qlp/symmlq, rectangular for lsqr/lsmr (tall) and craig
    (wide), SQD for tricg."""
    rng = np.random.default_rng(seed)
    n = 30
    if name in ("pcg", "cr", "car"):
        M = spd(rng, n)
        b = rng.standard_normal(n)
        dj = jnp.asarray(np.diag(M))
        dt = lane(np.diag(M))
        want = getattr(jk, name)(jmv(M), jnp.asarray(b), lambda r: r / dj,
                                 1e-12, 400)
        got = getattr(tk, name)(tmv(lane(M)), lane(b), lambda r: r / dt,
                                1e-12, 400)
        return want, got[0], np.linalg.solve(M, b)
    if name in ("minres", "minres_qlp", "symmlq"):
        M = indefinite(rng, n)
        b = rng.standard_normal(n)
        want = getattr(jk, name)(jmv(M), jnp.asarray(b), 1e-12, 400)
        got = getattr(tk, name)(tmv(lane(M)), lane(b), 1e-12, 400)
        return want, got[0], np.linalg.solve(M, b)
    if name in ("lsqr", "lsmr", "craig"):
        shape = (12, 30) if name == "craig" else (40, 15)
        M = rng.standard_normal(shape)
        b = rng.standard_normal(shape[0])
        want = getattr(jk, name)(jmv(M), jrmv(M), jnp.asarray(b), shape[1],
                                 1e-12, 2000)
        got = getattr(tk, name)(tmv(lane(M)), trmv(lane(M)), lane(b),
                                shape[1], 1e-12, 2000)
        return want, got[0], np.linalg.pinv(M) @ b
    assert name == "tricg"
    m, n = 9, 14
    A = rng.standard_normal((m, n))
    Md = rng.uniform(0.5, 3.0, m)
    Nd = 10.0 ** rng.uniform(-3, 3, n)
    b, c = rng.standard_normal(m), rng.standard_normal(n)
    xj, yj = jk.tricg(*map(jnp.asarray, (A, Md, Nd, b, c)), 1e-12, 400)
    xt, yt = tk.tricg(*map(lane, (A, Md, Nd, b, c)), 1e-12, 400)
    K = np.block([[np.diag(Md), A], [A.T, -np.diag(Nd)]])
    exact = np.linalg.solve(K, np.concatenate([b, c]))
    return (np.concatenate([xj, yj]), torch.cat([xt[0], yt[0]]), exact)


SOLVERS = ["minres", "pcg", "cr", "car", "minres_qlp", "symmlq", "tricg",
           "lsqr", "lsmr", "craig"]


@pytest.mark.parametrize("name", SOLVERS)
def test_solver_matches_reference(name):
    """f64 at rtol 1e-12: within 1e-9 relative of the reference's solution
    (the same iterates, summed in another order) and of the exact one."""
    want, got, exact = solver_case(name)
    assert rel(got, want) <= 1e-9, rel(got, want)
    assert rel(got, exact) <= 1e-9, rel(got, exact)


def test_sym_givens_matches_reference():
    rng = np.random.default_rng(1)
    a = np.concatenate([rng.standard_normal(6), [0.0, 0.0, 3.0]])
    b = np.concatenate([rng.standard_normal(6), [0.0, 2.0, 0.0]])
    want = jk._sym_givens(jnp.asarray(a), jnp.asarray(b))
    got = tk._sym_givens(torch.as_tensor(a), torch.as_tensor(b))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-15,
                                   atol=0)


# -- the reference's property tests (tests/test_kkt.py:375-548), on the port

def test_symmlq_matches_direct_solve():
    rng = np.random.default_rng(2)
    n = 40
    Q = orthogonal(rng, n)
    eigs = rng.uniform(0.5, 5.0, n)
    eigs[: n // 3] *= -1.0
    A = Q @ np.diag(eigs) @ Q.T
    b = rng.standard_normal(n)
    x = tk.symmlq(tmv(lane(A)), lane(b), 1e-12, 400)[0]
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(A, b), rtol=1e-8,
                               atol=1e-9)
    want = jk.symmlq(jmv(A), jnp.asarray(b), 1e-12, 400)
    assert rel(x, want) <= 1e-9


def test_minres_qlp_minimum_length_on_singular():
    """On a singular consistent symmetric system MINRES-QLP converges to
    the minimum-length solution (Choi, Paige & Saunders 2011)."""
    rng = np.random.default_rng(7)
    n, r = 30, 18
    Q = orthogonal(rng, n)
    d = np.concatenate([rng.uniform(0.5, 5.0, r) * rng.choice([-1, 1], r),
                        np.zeros(n - r)])
    A = Q @ np.diag(d) @ Q.T
    b = A @ rng.standard_normal(n)          # consistent right-hand side
    x_min = np.linalg.lstsq(A, b, rcond=None)[0]
    x = tk.minres_qlp(tmv(lane(A)), lane(b), 1e-12, 400)[0]
    np.testing.assert_allclose(x.numpy(), x_min, rtol=1e-8, atol=1e-10)
    want = jk.minres_qlp(jmv(A), jnp.asarray(b), 1e-12, 400)
    assert rel(x, want) <= 1e-9


def test_minres_qlp_matches_direct_solve_indefinite():
    rng = np.random.default_rng(11)
    n = 40
    Q = orthogonal(rng, n)
    A = Q @ np.diag(rng.uniform(0.5, 5.0, n) * rng.choice([-1, 1], n)) @ Q.T
    b = rng.standard_normal(n)
    x = tk.minres_qlp(tmv(lane(A)), lane(b), 1e-12, 400)[0]
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(A, b), rtol=1e-9,
                               atol=1e-12)


def test_car_matches_direct_solve_spd():
    rng = np.random.default_rng(5)
    n = 35
    M = rng.standard_normal((n, n))
    A = M @ M.T + n * np.eye(n)
    b = rng.standard_normal(n)
    x = tk.car(tmv(lane(A)), lane(b), None, 1e-12, 400)[0]
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(A, b), rtol=1e-9,
                               atol=1e-12)


def test_car_monotone_A_norm_residual():
    """CAR's defining optimality: ||r_k||_A decreases monotonically, on
    the port as on the reference (the same iterates, to 1e-10)."""
    rng = np.random.default_rng(9)
    n = 25
    M = rng.standard_normal((n, n))
    A = M @ M.T + 0.5 * np.eye(n)
    b = rng.standard_normal(n)
    norms = []
    for k in range(1, 12):
        x = tk.car(tmv(lane(A)), lane(b), None, 0.0, k)[0].numpy()
        r = b - A @ x
        norms.append(float(r @ A @ r))
        want = np.asarray(jk.car(jmv(A), jnp.asarray(b), None, 0.0, k))
        assert rel(x, want) <= 1e-10
    assert all(b2 <= a2 * (1 + 1e-10) for a2, b2 in zip(norms, norms[1:]))


def test_lsqr_lsmr_match_lstsq():
    rng = np.random.default_rng(13)
    mm, nn = 40, 15
    A = rng.standard_normal((mm, nn))
    b = rng.standard_normal(mm)
    x_ref = np.linalg.lstsq(A, b, rcond=None)[0]
    for name in ("lsqr", "lsmr"):
        x = getattr(tk, name)(tmv(lane(A)), trmv(lane(A)), lane(b), nn,
                              1e-13, 2000)[0]
        np.testing.assert_allclose(x.numpy(), x_ref, rtol=1e-10, atol=1e-12)


def test_craig_min_norm_matches_pinv():
    """CRAIG returns the minimum-norm solution of a consistent
    underdetermined system (= pinv solution)."""
    rng = np.random.default_rng(23)
    mm, nn = 12, 30
    A = rng.standard_normal((mm, nn))
    b = rng.standard_normal(mm)
    w = tk.craig(tmv(lane(A)), trmv(lane(A)), lane(b), nn, 1e-13, 2000)[0]
    np.testing.assert_allclose(w.numpy(), np.linalg.pinv(A) @ b, rtol=1e-9,
                               atol=1e-11)


def k1_state(seed, m, n, span, regD):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    theta_inv = 10.0 ** rng.uniform(-span, span, n)
    return (A, theta_inv, np.full(n, 1e-8), np.full(m, regD),
            rng.standard_normal(m), rng.standard_normal(n))


def port_solve(backend, A, theta_inv, regP, regD, xi_p, xi_d):
    st = backend.setup(lane(A))
    st, ok = backend.update(st, lane(theta_inv), lane(regP), lane(regD))
    assert bool(ok.all())
    dx, dy = backend.solve(st, lane(xi_p), lane(xi_d))
    return dx[0].numpy(), dy[0].numpy()


def ref_solve(backend, A, theta_inv, regP, regD, xi_p, xi_d):
    st = backend.setup(jnp.asarray(A))
    st, ok = backend.update(st, *map(jnp.asarray, (theta_inv, regP, regD)))
    assert bool(ok)
    dx, dy = backend.solve(st, jnp.asarray(xi_p), jnp.asarray(xi_d))
    return np.asarray(dx), np.asarray(dy)


@pytest.mark.parametrize("names,span,regD", [
    (("lsqr", "lsmr"), 6, 1e-8), (("craig", "craigmr"), 4, 1e-6)],
    ids=["ls", "ln"])
def test_gram_free_backends_match_dense(names, span, regD):
    """The LS and LN families solve K1 to the dense direct backend's answer
    on an ill-conditioned Θ (tests/test_kkt.py:475-548), one sweep each."""
    args = k1_state(17 if span == 6 else 29, 10, 25, span, regD)
    dx_ref, dy_ref = port_solve(DenseK1Backend(refinement_steps=2), *args)
    for name in names:
        dx, dy = port_solve(make_backend(name, refinement_steps=1), *args)
        np.testing.assert_allclose(dy, dy_ref, rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(dx, dx_ref, rtol=1e-6, atol=1e-8)


def test_gram_free_backends_never_form_the_normal_matrix():
    """LSQR, LSMR, CRAIG and CRAIGMR apply A and Aᵀ only: every product
    they take has A (or Aᵀ) as its left operand, never an m x m matrix."""
    args = k1_state(3, 10, 25, 2, 1e-6)
    seen = []
    real = tk.bmv

    def spy(M, v):
        seen.append(tuple(M.shape[-2:]))
        return real(M, v)

    tk.bmv = spy
    try:
        for name in ("lsqr", "lsmr", "craig", "craigmr"):
            port_solve(make_backend(name), *args)
    finally:
        tk.bmv = real
    assert seen and set(seen) == {(10, 25)}


# -- masked batching ------------------------------------------------------

def batch_case(name):
    """Three lanes of one solver's kind whose solves stop at very
    different trips (conditioning 1 or 2, ~1e2 and ~1e4), as one batch."""
    rng = np.random.default_rng(4)
    n = 24
    if name in ("lsqr", "lsmr", "craig"):
        shape = (40, 60) if name == "craig" else (60, 40)
        Ms = []
        for cond in (1.0, 1e2, 1e4):
            U, _, Vt = np.linalg.svd(rng.standard_normal(shape),
                                     full_matrices=False)
            Ms.append(U @ np.diag(np.geomspace(1, cond, len(Vt))) @ Vt)
        bs = rng.standard_normal((3, shape[0]))
        M, b = torch.as_tensor(np.stack(Ms)), torch.as_tensor(bs)
        return lambda M, b: getattr(tk, name)(
            tmv(M), trmv(M), b, shape[1], 1e-12, 500), (M, b)
    if name == "tricg":
        m, k = 9, 14
        A = torch.as_tensor(rng.standard_normal((3, m, k)))
        Md = torch.as_tensor(rng.uniform(0.5, 3.0, (3, m)))
        Nd = torch.as_tensor(10.0 ** np.stack(
            [rng.uniform(-s, s, k) for s in (0.0, 2.0, 4.0)]))
        b = torch.as_tensor(rng.standard_normal((3, m)))
        c = torch.as_tensor(rng.standard_normal((3, k)))
        return lambda A, Md, Nd, b, c: torch.cat(
            tk.tricg(A, Md, Nd, b, c, 1e-12, 400), dim=-1), (A, Md, Nd, b, c)
    Ms = []
    for cond in (2.0, 1e2, 1e4):
        Q = orthogonal(rng, n)
        ev = np.geomspace(1, cond, n)
        if name in ("minres", "minres_qlp", "symmlq"):
            ev = ev * rng.choice([-1, 1], n)
        Ms.append(Q @ np.diag(ev) @ Q.T)
    M = torch.as_tensor(np.stack(Ms))
    b = torch.as_tensor(rng.standard_normal((3, n)))
    if name in ("pcg", "cr", "car"):
        return lambda M, b: getattr(tk, name)(
            tmv(M), b, lambda r: r, 1e-12, 400), (M, b)
    return lambda M, b: getattr(tk, name)(tmv(M), b, 1e-12, 400), (M, b)


@pytest.mark.parametrize("name", SOLVERS)
def test_masked_batch_equals_single_lanes(name, monkeypatch):
    """Each lane of a batch of three ends on the bits of its own one-lane
    solve, though the lanes stop at very different trips; testing for a
    stop on every trip gives the same bits as every _CHECK_EVERY trips."""
    solve, args = batch_case(name)
    got = solve(*args)
    singles = [solve(*(a[i:i + 1] for a in args))[0] for i in range(3)]
    for i in range(3):
        assert torch.equal(got[i], singles[i]), i

    trips = []
    real = tk._masked_while

    def counted(cond, body, carry, maxiter):
        def body_(c, k):
            trips[-1] = k + 1
            return body(c, k)
        trips.append(0)
        return real(cond, body_, carry, maxiter)

    monkeypatch.setattr(tk, "_masked_while", counted)
    monkeypatch.setattr(tk, "_CHECK_EVERY", 1)
    assert torch.equal(solve(*args), got)
    # With a test on every trip, a one-lane loop runs exactly that lane's
    # trips: they differ widely.
    for i in range(3):
        solve(*(a[i:i + 1] for a in args))
    lane_trips = trips[1:]
    assert max(lane_trips) >= 2 * min(lane_trips) + 16, lane_trips


# -- the thirteen backends ------------------------------------------------

def test_registry_has_every_krylov_backend():
    names = {n for n, c in jkkt.available_backends().items()
             if c.__module__ == "tulip_tpu.kkt.krylov"}
    assert sorted(names) == KRYLOV_NAMES
    for name in KRYLOV_NAMES:
        jcls = jkkt.available_backends()[name]
        cls = kkt.available_backends()[name]
        assert cls.__name__ == jcls.__name__
        assert cls.systems == jcls.systems
        assert cls.experimental == jcls.experimental
        assert cls.sweep_resid_atol is None
        be, jbe = cls(), jcls()
        assert (be.rtol, be.maxiter_factor) == (jbe.rtol, jbe.maxiter_factor)
        assert be.linear_system() == jbe.linear_system()


@pytest.mark.parametrize("name", ["tricg", "minares"])
def test_experimental_backends_warn(name):
    with pytest.warns(UserWarning, match="experimental"):
        be = make_backend(name)
    assert be.name == name
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        make_backend("cg")


def quiet(name, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return make_backend(name, **kw)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("name", KRYLOV_NAMES)
def test_conformance(name, dtype):
    """tests/test_kkt.py's kit run on its 2x4 fixture."""
    run_ls_tests(torch.as_tensor(A_np, dtype=dtype), quiet(name))


@pytest.mark.parametrize("name", KRYLOV_NAMES)
def test_backend_solve_matches_reference(name):
    """dx, dy of one solve with one refinement sweep within 1e-6 relative
    of the reference backend's and of the exact solution, on one seeded
    K1 state (Θ⁻¹ over four decades, Rd = 1e-4) on which the reference's
    own solve of every backend lies within 1e-8 of the exact one. (At
    Rd = 1e-6 the reference's TriCG is 1.3e-6 from it and the port's
    3.5e-7: the method's loss of orthogonality, not either package's.)"""
    args = k1_state(31, 8, 20, 2, 1e-4)
    dx, dy = port_solve(quiet(name, refinement_steps=1), *args)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jbe = jkkt.make_backend(name, refinement_steps=1)
    dx_j, dy_j = ref_solve(jbe, *args)
    assert rel(dx, dx_j) <= 1e-6 and rel(dy, dy_j) <= 1e-6, (
        rel(dx, dx_j), rel(dy, dy_j))
    A, theta_inv, regP, regD, xi_p, xi_d = args
    K = np.block([[-np.diag(theta_inv + regP), A.T], [A, np.diag(regD)]])
    exact = np.linalg.solve(K, np.concatenate([xi_d, xi_p]))
    assert rel(np.concatenate([dx, dy]), exact) <= 1e-6
