"""Port parity of the dense K2 backend (``"dense-ldl"``) on the CPU: the
blocked unpivoted LDLᵀ against the reference's column loop on random
quasi-definite matrices, the backend's update and solve on states carried
across from the JAX package, and ``Model`` with ``KKT_System="K2"`` on both
packages, from the same inputs (numpy seeds)."""

from pathlib import Path

import importlib.util

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import tulip_tpu as tlp
import tulip_tpu_torch as tlt
from golden_large import load_model, staircase_lp
from tulip_tpu.io.mps import read_mps
from tulip_tpu.kkt.dense_ldl import DenseK2Backend as JK2
from tulip_tpu.kkt.dense_ldl import ldl_nopivot as jldl
from tulip_tpu_torch.convert import structured_state_from_numpy
from tulip_tpu_torch.kkt import DenseK2Backend, make_backend
from tulip_tpu_torch.kkt.dense_ldl import DenseK2State, ldl_nopivot
from tulip_tpu_torch.status import TerminationStatus

torch.set_num_threads(1)

DATA = Path(__file__).resolve().parent / "data"


def chip_smoke_k2_status():
    """chip_smoke.py's table of K2 statuses on tests/data/*.mps."""
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.K2_CLI_STATUS


def quasi_definite(n, m, seed, diagonal=False):
    """[[-H, Aᵀ], [A, D]] with H, D symmetric positive definite (H
    diagonal, as K2's (1,1) block, when ``diagonal``)."""
    rng = np.random.default_rng(seed)
    if diagonal:
        H = np.diag(rng.uniform(0.1, 10.0, n))
    else:
        H = rng.standard_normal((n, n))
        H = H @ H.T + n * np.eye(n)
    A = rng.standard_normal((m, n))
    D = rng.standard_normal((m, m))
    D = D @ D.T + np.eye(m)
    return np.block([[-H, A.T], [A, D]])


def rel(got, want):
    want = np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


@pytest.mark.parametrize("n,m,block,diagonal", [
    (5, 3, 64, False), (70, 60, 16, False), (100, 150, 64, False),
    (96, 130, 32, True)])
def test_ldl_nopivot_matches_reference(n, m, block, diagonal):
    """L and d within 1e-10 relative of the reference's (f64; the blocked
    factorization sums in another order), ``ok`` equal; negative pivots
    (the x block) leave ``ok`` true."""
    K = quasi_definite(n, m, seed=n + m, diagonal=diagonal)
    L_j, d_j, ok_j = jldl(jnp.asarray(K))
    L_t, d_t, ok_t = ldl_nopivot(torch.as_tensor(K), block=block)
    assert bool(ok_t) == bool(ok_j) is True
    assert (d_t[:n] < 0).all() and (d_t[n:] > 0).all()
    assert rel(L_t.numpy(), L_j) <= 1e-10
    assert rel(d_t.numpy(), d_j) <= 1e-10
    # The batched call factors each matrix as the single call does.
    L_b, d_b, ok_b = ldl_nopivot(torch.as_tensor(np.stack([K, -K])),
                                 block=block)
    assert rel(L_b[0].numpy(), L_j) <= 1e-10
    assert ok_b.shape == (2,)


@pytest.mark.parametrize("K,ok", [
    ([[0.0, 1.0, 2.0], [1.0, 3.0, 1.0], [2.0, 1.0, 5.0]], False),
    ([[2.0, 1.0, 0.0], [1.0, 0.5, 1.0], [0.0, 1.0, 1.0]], False),
    ([[1.0, np.nan], [np.nan, 1.0]], False),
    ([[-1.0, 2.0], [2.0, 1.0]], True)],
    ids=["zero-first", "zero-later", "nan", "negative"])
def test_ldl_nopivot_ok_flag(K, ok):
    """``ok`` is false on a zero or non-finite pivot, true on a negative
    one; past a zero pivot the column is divided by 1 and the
    factorization goes on, as in the reference."""
    K = np.asarray(K)
    L_j, d_j, ok_j = jldl(jnp.asarray(K))
    L_t, d_t, ok_t = ldl_nopivot(torch.as_tensor(K), block=2)
    assert bool(ok_t) == bool(ok_j) == ok
    if np.isfinite(K).all():
        np.testing.assert_allclose(L_t.numpy(), np.asarray(L_j), rtol=1e-12)
        np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-12)


def lane(v):
    return torch.as_tensor(v)[None]


def test_dense_k2_update_and_solve_match_reference():
    """DenseK2Backend.update + solve on the state carried across by
    ``convert``: L, d and the refined solution within 1e-8 of the
    reference's."""
    rng = np.random.default_rng(3)
    m, n = 150, 230      # the Schur block spans three panels of 64
    A = rng.standard_normal((m, n))
    jbe = JK2(refinement_steps=1)
    tst = structured_state_from_numpy(
        "DenseK2State", jbe.setup(jnp.asarray(A))._asdict(), device="cpu")
    assert isinstance(tst, DenseK2State)
    theta_inv = rng.uniform(1e-3, 1e3, n)
    regP, regD = np.full(n, 1e-8), np.full(m, 1e-8)
    xi_p, xi_d = rng.standard_normal(m), rng.standard_normal(n)
    jnew, jok = jbe.update(jbe.setup(jnp.asarray(A)),
                           *map(jnp.asarray, (theta_inv, regP, regD)))
    dx_j, dy_j = jbe.solve(jnew, jnp.asarray(xi_p), jnp.asarray(xi_d))
    tbe = DenseK2Backend(refinement_steps=1)
    tnew, tok = tbe.update(tst, lane(theta_inv), lane(regP), lane(regD))
    dx_t, dy_t = tbe.solve(tnew, lane(xi_p), lane(xi_d))
    assert bool(jok) and tok.tolist() == [True]
    # The x block's pivots and columns of L are the reference's, bit for
    # bit; the Schur block's within 1e-8.
    np.testing.assert_array_equal(tnew.d[0, :n].numpy(),
                                  np.asarray(jnew.d)[:n])
    np.testing.assert_array_equal(tnew.L[0, n:, :n].numpy(),
                                  np.asarray(jnew.L)[n:, :n])
    for got, want in [(tnew.L[0], jnew.L), (tnew.d[0], jnew.d),
                      (dx_t[0], dx_j), (dy_t[0], dy_j)]:
        assert rel(got.numpy(), want) <= 1e-8


def test_dense_k2_failed_lane_takes_identity():
    """A lane with a zero x-block pivot fails alone and stores the
    identity and unit pivots; the other lane factors."""
    rng = np.random.default_rng(4)
    A = torch.as_tensor(rng.standard_normal((2, 5, 8)))
    be = DenseK2Backend()
    theta_inv = torch.ones(2, 8, dtype=torch.float64)
    theta_inv[1, 3] = 0.0
    st, ok = be.update(be.setup(A), theta_inv, torch.zeros(2, 8,
                                                           dtype=A.dtype),
                       torch.full((2, 5), 1e-6, dtype=A.dtype))
    assert ok.tolist() == [True, False]
    assert torch.equal(st.L[1], torch.eye(13, dtype=A.dtype))
    assert torch.equal(st.d[1], torch.ones(13, dtype=A.dtype))


def test_make_backend_k2_is_dense_ldl():
    assert make_backend(None, "K2").name == "dense-ldl"
    with pytest.raises(ValueError):
        make_backend("dense-ldl", "K1")


def models(pb_j, **params):
    """The reference's Model holding ``pb_j`` and the port's holding the
    same LP, each with ``params`` and ``KKT_System="K2"``."""
    jmod = tlp.Model()
    jmod.pbdata = pb_j
    tmod = tlt.Model(device="cpu")
    I, J, V = pb_j.to_coo()
    tmod.pbdata.load(pb_j.objsense, np.asarray(pb_j.obj), pb_j.obj0,
                     (I, J, V), np.asarray(pb_j.lcon), np.asarray(pb_j.ucon),
                     np.asarray(pb_j.lvar), np.asarray(pb_j.uvar))
    for key, v in dict(params, KKT_System="K2").items():
        tlp.set_parameter(jmod, key, v)
        tlt.set_parameter(tmod, key, v)
    return jmod, tmod


@pytest.mark.parametrize("name,presolve", [
    ("lp_opt", 1), ("lp_freevars", 1), ("lp_opt", 0), ("lp_inf", 0),
    ("lp_ubd", 0), ("lp_freevars", 0), ("staircase", 1)])
def test_model_k2_matches_reference(name, presolve):
    """``KKT_System="K2"`` on both packages: the port runs "dense-ldl"
    where the reference does, with the reference's status, the objective
    within 1e-8 relative, iterations within ±1 (the Schur block's
    factorization sums in another order than the reference's column
    loop). Without presolve, the infeasible files reach "dense-ldl" and
    its infeasibility detection is held against the reference's, and
    every status is chip_smoke.py's for its K2 CLI run."""
    if name == "staircase":
        A, b, c, u = staircase_lp(256, mr=16, nc=24)
        pb = load_model(A, b, c, u).pbdata
    else:
        pb = read_mps(str(DATA / f"{name}.mps"))
    jmod, tmod = models(pb, Presolve_Level=presolve)
    st_j, st_t = jmod.optimize(), tmod.optimize()
    assert st_t == st_j
    if presolve == 0:
        assert jmod.kkt_backend is not None
        assert st_j.name == chip_smoke_k2_status()[name]
    if jmod.kkt_backend is not None:
        assert tmod.kkt_backend.name == jmod.kkt_backend.name == "dense-ldl"
        assert isinstance(tmod.solver_state.kkt, DenseK2State)
        assert abs(tmod.barrier_iterations - jmod.barrier_iterations) <= 1
    if st_j == TerminationStatus.OPTIMAL:
        z_j = tlp.get_attribute(jmod, "ObjectiveValue")
        z_t = tlt.get_attribute(tmod, "ObjectiveValue")
        assert abs(z_t - z_j) <= 1e-8 * max(1.0, abs(z_j))


def test_k2_from_2048_rows_raises_naming_8c():
    """K2 at m >= 2048 is the reference's "sparse-ldl" (item 8c, ported
    since): the port takes it where it raised, sets up the tiled
    ``SparseK2State`` the JAX package sets up for the same A, and runs
    its iterations."""
    from tulip_tpu.kkt.sparse_ldl import k2_tile_plan as jplan
    from tulip_tpu_torch.kkt.sparse_ldl import SparseK2State

    A, b, c, u = staircase_lp(2048)
    coo = A.tocoo()
    mod = tlt.Model(device="cpu")
    mod.pbdata.load(True, c, 0.0, (coo.row, coo.col, coo.data), b, b,
                    np.zeros(A.shape[1]), u)
    mod.params.KKT.System = "K2"
    mod.params.IPM.IterationsLimit = 2
    assert mod.optimize() == TerminationStatus.ITERATION_LIMIT
    assert mod.kkt_backend.name == "sparse-ldl"
    assert jplan(A.toarray(), 64) is not None
    assert isinstance(mod.solver_state.kkt, SparseK2State)
