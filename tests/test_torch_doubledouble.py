"""Port parity of the precision ladder on the CPU: the double-double
primitives and reductions bit for bit, ``"extended"``, ``"extended-dd"``
and ``"dense-mixed"`` against the JAX package's on the same inputs and
within the bounds of tests/test_doubledouble.py and
tests/test_extended_boundary.py (the Hilbert boundary included), and
``Model.optimize()``'s route to ``"extended"`` below 1e-9 in both
packages, from the same inputs (numpy seeds).

The reference's dd code is evaluated op by op (``jax.disable_jit`` where it
loops): compiled, XLA on the CPU contracts some ``a*b + c`` of ``mul``,
``div``, ``mul_f`` and ``recip`` into fused multiply-adds (11 of 257
results of ``mul`` differ in their last bits), so the compiled reference
is not the arithmetic its source writes."""

import importlib.util
from fractions import Fraction
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tulip_tpu as tlp
import tulip_tpu_torch as tlt
from test_doubledouble import exact_dot
from test_extended_boundary import hilbert_ldl_f64
from tulip_tpu.kkt import extended as jext
from tulip_tpu.kkt.mixed import MixedK1Backend as JMixed
from tulip_tpu.ops import doubledouble as jdd
from tulip_tpu_torch.convert import structured_state_from_numpy
from tulip_tpu_torch.kkt import (DenseK1Backend, ExtendedDDK1Backend,
                                 ExtendedK1Backend, MixedK1Backend,
                                 make_backend)
from tulip_tpu_torch.kkt import extended as text
from tulip_tpu_torch.ops import doubledouble as tdd
from tulip_tpu_torch.status import TerminationStatus

torch.set_num_threads(1)


def chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def lane(v, dt=torch.float64):
    return torch.as_tensor(np.asarray(v), dtype=dt)[None]


def test_dd_primitives_and_reductions_are_bit_for_bit():
    """Every error-free transform, dd operation and reduction (sum_, dot,
    matvec) of chip_smoke.py's phase 7d(a) gives the reference's bits."""
    cs = chip_smoke()
    want = cs.dd_results(jdd, jnp.asarray)
    got = cs.dd_results(tdd, torch.as_tensor)
    assert set(got) == set(want)
    assert cs.dd_mismatches(got, want) == []


def test_dd_dot_and_matvec_are_exact_grade():
    """The reference's accuracy tests hold for the port: the compensated
    dot survives the cancellation that ruins the f64 dot, and matvec rows
    are within 1e-26 of the exact rational sums."""
    inp = chip_smoke().dd_inputs()
    a, w = inp["cancel"], inp["w"]
    h, lo = tdd.dot(torch.as_tensor(a), torch.as_tensor(w))
    got = Fraction(float(h)) + Fraction(float(lo))
    exact = exact_dot(a, w)
    assert abs(got - exact) <= abs(exact) * Fraction(1, 10 ** 25)
    M, v = inp["M"], inp["v"]
    h, lo = tdd.matvec(torch.as_tensor(M), torch.as_tensor(v))
    for i in range(M.shape[0]):
        got = Fraction(float(h[i])) + Fraction(float(lo[i]))
        tol = max(abs(Fraction(float(x))) for x in M[i]) * Fraction(1, 10**26)
        assert abs(got - exact_dot(M[i], v)) <= tol


def dd_system(m, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, n)), 10.0 ** rng.uniform(-4, 4, n),
            np.full(m, 1e-8), rng.standard_normal(m), rng.standard_normal(n))


def test_extended_dd_update_and_solve_are_bit_for_bit():
    """``"extended-dd"``: the dd assembly, Cholesky factor and refined
    solve give the reference's bits (its loops run op by op)."""
    A, th, rD, xp, xd = dd_system(9, 17, seed=1)
    jbe, tbe = jext.ExtendedDDK1Backend(), ExtendedDDK1Backend()
    with jax.disable_jit():
        jst, jok = jbe.update(jbe.setup(jnp.asarray(A)), jnp.asarray(th),
                              jnp.zeros(17), jnp.asarray(rD))
        want = jbe.solve(jst, jnp.asarray(xp), jnp.asarray(xd))
    tst, tok = tbe.update(tbe.setup(lane(A)), lane(th),
                          torch.zeros(1, 17, dtype=torch.float64), lane(rD))
    assert tok.tolist() == [bool(jok)] == [True]
    for g, w in zip((tst.Lhi[0], tst.Llo[0]), (jst.Lhi, jst.Llo)):
        assert np.array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(tbe.solve(tst, lane(xp), lane(xd)), want):
        assert np.array_equal(g[0].numpy(), np.asarray(w))


def test_dd_assembly_in_chunks_is_the_column_loop(monkeypatch):
    """K assembled a chunk of columns at a time equals, bit for bit, K
    assembled one column at a time (the reference's loop), on a batch of
    two LPs."""
    rng = np.random.default_rng(2)
    A = torch.as_tensor(rng.standard_normal((2, 11, 23)))
    dinv = tdd.recip(tdd.from_f(torch.as_tensor(
        10.0 ** rng.uniform(-6, 6, (2, 23)))))
    regD = torch.full((2, 11), 1e-8, dtype=torch.float64)
    chunked = text.dd_normal_matrix(A, dinv, regD)
    monkeypatch.setattr(text, "_ASSEMBLY_CHUNK_ELEMENTS", 1)
    columns = text.dd_normal_matrix(A, dinv, regD)
    for g, w in zip(chunked, columns):
        assert torch.equal(g, w)


def test_extended_forward_error_ill_conditioned():
    """tests/test_doubledouble.py's forward-error experiment on the port:
    on a KKT system with θ over 16 decades, ``"extended"`` lands within
    1e-13 of the long-double solution and 10x below plain f64, and within
    1e-12 of the reference's ``"extended"`` solve (relative to the
    solution's largest entry)."""
    rng = np.random.default_rng(4)
    m, n = 12, 30
    A = rng.standard_normal((m, n))
    theta_inv = 10.0 ** rng.uniform(-8, 8, n)
    xi_p, xi_d = rng.standard_normal(m), rng.standard_normal(n)

    Al = np.asarray(A, dtype=np.longdouble)
    K2 = np.zeros((n + m, n + m), dtype=np.longdouble)
    K2[:n, :n] = -np.diag(np.asarray(theta_inv, np.longdouble) + 1e-8)
    K2[:n, n:], K2[n:, :n] = Al.T, Al
    K2[n:, n:] = np.diag(np.full(m, 1e-8, dtype=np.longdouble))
    M = np.hstack([K2, np.concatenate([xi_d, xi_p]).astype(
        np.longdouble)[:, None]])
    for k in range(n + m):
        piv = k + np.argmax(np.abs(M[k:, k]))
        M[[k, piv]] = M[[piv, k]]
        M[k] = M[k] / M[k, k]
        M[k + 1:] -= np.outer(M[k + 1:, k], M[k])
    sol = np.zeros(n + m, dtype=np.longdouble)
    for k in range(n + m - 1, -1, -1):
        sol[k] = M[k, -1] - M[k, k + 1:n + m] @ sol[k + 1:]
    scale = float(np.max(np.abs(sol)))

    def solve(be):
        st, ok = be.update(be.setup(lane(A)), lane(theta_inv),
                           lane(np.full(n, 1e-8)), lane(np.full(m, 1e-8)))
        assert ok.tolist() == [True]
        dx, dy = be.solve(st, lane(xi_p), lane(xi_d))
        return np.concatenate([dx[0].numpy(), dy[0].numpy()])

    def err(x):
        return float(np.max(np.abs(np.asarray(x, np.longdouble) - sol))
                     ) / scale

    got = solve(ExtendedK1Backend())
    assert err(got) < 1e-13
    assert err(got) < err(solve(DenseK1Backend())) / 10
    jbe = jext.ExtendedK1Backend()
    jst, _ = jbe.update(jbe.setup(jnp.asarray(A)), jnp.asarray(theta_inv),
                        jnp.full(n, 1e-8), jnp.full(m, 1e-8))
    want = np.concatenate([np.asarray(v) for v in jbe.solve(
        jst, jnp.asarray(xi_p), jnp.asarray(xi_d))])
    assert np.abs(got - want).max() <= 1e-12 * scale


def test_extended_requires_f64():
    A = lane(np.eye(2, 3), torch.float32)
    for be in (ExtendedK1Backend(), ExtendedDDK1Backend()):
        st, _ = be.update(be.setup(A), *(torch.ones(1, k) for k in (3, 3, 2)))
        with pytest.raises(TypeError, match="float64"):
            be.solve(st, torch.ones(1, 2), torch.ones(1, 3))


def test_hilbert_boundary_f64_fails_cleanly_dd_succeeds():
    """tests/test_extended_boundary.py on the port: the n = 16 Hilbert
    Gram fails the f64 Cholesky cleanly (ok false, finite solves), as in
    the reference; at n = 14 ``"extended-dd"`` factors it and its dy is
    within 1e-9 of the exact rational solution, 100x better than the f64
    path's, and equal to the reference's bit for bit."""
    A16 = hilbert_ldl_f64(16)
    be = DenseK1Backend()
    st, ok = be.update(be.setup(lane(A16)), torch.ones(1, 16),
                       torch.full((1, 16), 1e-30, dtype=torch.float64),
                       torch.full((1, 16), 1e-30, dtype=torch.float64))
    assert ok.tolist() == [False]
    dx, dy = be.solve(st, torch.ones(1, 16, dtype=torch.float64),
                      torch.zeros(1, 16, dtype=torch.float64))
    assert torch.isfinite(dx).all() and torch.isfinite(dy).all()

    A = hilbert_ldl_f64(14)
    m, n = A.shape
    Kx = [[sum(Fraction(float(A[i, k])) * Fraction(float(A[j, k]))
               for k in range(n)) for j in range(m)] for i in range(m)]
    Mx = [row[:] + [Fraction(1)] for row in Kx]
    for col in range(m):
        piv = max(range(col, m), key=lambda r: abs(Mx[r][col]))
        Mx[col], Mx[piv] = Mx[piv], Mx[col]
        for r in range(col + 1, m):
            f = Mx[r][col] / Mx[col][col]
            for cc in range(col, m + 1):
                Mx[r][cc] -= f * Mx[col][cc]
    y = [Fraction(0)] * m
    for r in range(m - 1, -1, -1):
        y[r] = (Mx[r][m] - sum(Mx[r][cc] * y[cc]
                               for cc in range(r + 1, m))) / Mx[r][r]
    y_true = np.array([float(v) for v in y])
    scale = max(1.0, float(np.max(np.abs(y_true))))

    args = (torch.ones(1, n, dtype=torch.float64),
            torch.zeros(1, n, dtype=torch.float64),
            torch.zeros(1, m, dtype=torch.float64))
    rhs = (torch.ones(1, m, dtype=torch.float64),
           torch.zeros(1, n, dtype=torch.float64))
    dd_be = ExtendedDDK1Backend()
    st, ok = dd_be.update(dd_be.setup(lane(A)), *args)
    assert ok.tolist() == [True]
    dy = dd_be.solve(st, *rhs)[1][0].numpy()
    err = float(np.max(np.abs(dy - y_true))) / scale
    assert err < 1e-9, err
    bef = DenseK1Backend(refinement_steps=2)
    stf, okf = bef.update(bef.setup(lane(A)), *args)
    if okf.tolist() == [True]:
        dyf = bef.solve(stf, *rhs)[1][0].numpy()
        assert err < float(np.max(np.abs(dyf - y_true))) / scale * 1e-2
    jbe = jext.ExtendedDDK1Backend()
    with jax.disable_jit():
        jst, _ = jbe.update(jbe.setup(jnp.asarray(A)), jnp.ones(n),
                            jnp.zeros(n), jnp.zeros(m))
        want = jbe.solve(jst, jnp.ones(m), jnp.zeros(n))[1]
    assert np.array_equal(dy, np.asarray(want))


def test_mixed_matches_reference():
    """``"dense-mixed"`` (f32 factor, three f64 sweeps) on the reference's
    test_mixed_backend_blocked_path_matches_default system: the dual
    residual under 1e-9 and dx, dy within rtol 1e-8, atol 1e-9 of the
    reference's (its own bound between its two f32 factor paths); the
    factor is f32."""
    rng = np.random.default_rng(13)
    m, n = 96, 150
    A = rng.standard_normal((m, n))
    th = 10.0 ** rng.uniform(-3, 3, n)
    xi_p, xi_d = rng.standard_normal(m), rng.standard_normal(n)
    jbe, tbe = JMixed(), MixedK1Backend()
    jst, _ = jbe.update(jbe.setup(jnp.asarray(A)), jnp.asarray(th),
                        jnp.full(n, 1e-8), jnp.full(m, 1e-8))
    want = [np.asarray(v) for v in jbe.solve(jst, jnp.asarray(xi_p),
                                              jnp.asarray(xi_d))]
    tst, ok = tbe.update(tbe.setup(lane(A)), lane(th),
                         lane(np.full(n, 1e-8)), lane(np.full(m, 1e-8)))
    assert ok.tolist() == [True] and tst.Li32.dtype == torch.float32
    dx, dy = (v[0].numpy() for v in tbe.solve(tst, lane(xi_p), lane(xi_d)))
    rd = xi_d - (-(th + 1e-8) * dx + A.T @ dy)
    assert np.max(np.abs(rd)) < 1e-9
    np.testing.assert_allclose(dx, want[0], rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(dy, want[1], rtol=1e-8, atol=1e-9)


def to_numpy(tree):
    return {f: np.asarray(v) for f, v in zip(tree._fields, tree)}


@pytest.mark.parametrize("kind", ["MixedK1State", "DDK1State"])
def test_converted_state_solves_as_the_ports_own(kind):
    """A reference state carried across by ``convert`` equals the port's
    own ``setup`` field for field (the mixed factor stays f32), and the
    same ``update`` and ``solve`` from either give the same bits; from the
    reference's updated state, the solve is within 1e-8 of the port's."""
    A, th, rD, xp, xd = dd_system(8, 14, seed=3)
    if kind == "MixedK1State":
        jbe, tbe = JMixed(), MixedK1Backend()
    else:
        jbe, tbe = jext.ExtendedDDK1Backend(), ExtendedDDK1Backend()
    jst = jbe.setup(jnp.asarray(A))
    assert type(jst).__name__ == kind
    conv = structured_state_from_numpy(kind, to_numpy(jst), device="cpu")
    own = tbe.setup(lane(A))
    for f in own._fields:
        g, w = getattr(conv, f), getattr(own, f)
        assert g.dtype == w.dtype and torch.equal(g, w), f
    args = (lane(th), lane(np.zeros(14)), lane(rD))
    a, _ = tbe.update(conv, *args)
    b, _ = tbe.update(own, *args)
    solved = tbe.solve(b, lane(xp), lane(xd))
    for x, y in zip(tbe.solve(a, lane(xp), lane(xd)), solved):
        assert torch.equal(x, y)
    jst, _ = jbe.update(jst, jnp.asarray(th), jnp.zeros(14), jnp.asarray(rD))
    up = structured_state_from_numpy(kind, to_numpy(jst), device="cpu")
    for x, y in zip(tbe.solve(up, lane(xp), lane(xd)), solved):
        assert (x - y).abs().max() <= 1e-8 * y.abs().max()


def test_make_backend_names_the_ladder():
    for name, cls, sweeps in [("dense-mixed", MixedK1Backend, 3),
                              ("extended", ExtendedK1Backend, 2),
                              ("extended-dd", ExtendedDDK1Backend, 1)]:
        assert type(make_backend(name, "K1", 1)) is cls
        assert cls().refinement_steps == sweeps
        with pytest.raises(ValueError):
            make_backend(name, "K2")


def tight_lp(seed=5):
    """The 20x40 LP of tests/test_doubledouble.py's tight-tolerance
    test."""
    rng = np.random.default_rng(seed)
    m, n = 20, 40
    A = rng.standard_normal((m, n))
    u = rng.uniform(1, 4, n)
    b = A @ (u * rng.uniform(0.2, 0.8, n))
    return A, b, rng.standard_normal(n), u


def load_pair(lp, **params):
    A, b, c, u = lp
    I, J = np.nonzero(A)
    out = []
    for pkg, kw in ((tlp, {}), (tlt, {"device": "cpu"})):
        mod = pkg.Model(**kw)
        mod.pbdata.load(True, c, 0.0, (I, J, A[I, J]), b, b,
                        np.zeros(A.shape[1]), u)
        for k, v in params.items():
            pkg.set_parameter(mod, k, v)
        out.append(mod)
    return out


def tolerances(t):
    return {f"IPM_Tolerance{k}": t for k in ("PFeas", "DFeas", "RGap",
                                              "IFeas")}


@pytest.mark.parametrize("backend,tol", [(None, 1e-10), ("extended", 1e-12),
                                         ("extended-dd", 1e-12)],
                         ids=["route-1e-10", "extended-1e-12",
                              "extended-dd-1e-12"])
def test_model_extended_routes_match_reference(backend, tol):
    """Below 1e-9 in f64 with no backend named both packages take
    ``"extended"`` (two dd sweeps); named, ``"extended"`` and
    ``"extended-dd"`` solve at 1e-12. The reference's status and
    iterations within ±1; the objective within 1e-9 of HiGHS and the
    primal-dual gap within 1e-10 (tests/test_doubledouble.py's bounds)."""
    from scipy.optimize import linprog

    params = tolerances(tol)
    if backend:
        params["KKT_Backend"] = backend
    lp = tight_lp()
    jmod, tmod = load_pair(lp, **params)
    st_j, st_t = jmod.optimize(), tmod.optimize()
    want = backend or "extended"
    assert tmod.kkt_backend.name == jmod.kkt_backend.name == want
    assert tmod.kkt_backend.refinement_steps == \
        jmod.kkt_backend.refinement_steps
    assert st_t == st_j == TerminationStatus.OPTIMAL
    assert abs(tmod.barrier_iterations - jmod.barrier_iterations) <= 1
    A, b, c, u = lp
    ref = linprog(c, A_eq=A, b_eq=b, bounds=[(0, ub) for ub in u],
                  method="highs")
    z = tlt.get_attribute(tmod, "ObjectiveValue")
    zd = tlt.get_attribute(tmod, "DualObjectiveValue")
    assert abs(z - ref.fun) < 1e-9 * max(1, abs(ref.fun))
    assert abs(z - zd) < 1e-10 * max(1, abs(z))
