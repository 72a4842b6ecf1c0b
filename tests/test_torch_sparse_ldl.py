"""Port parity of the tiled sparse K2 backend (``"sparse-ldl"``) on the CPU:
the host planners index for index, the signed blocked factorization and
the solves of both schedules and both ``inv_factor`` modes on states
carried across from the JAX package, HSD and MPC end to end, and
``Model.optimize()`` at its defaults where the structure probe answers
``"sparse-ldl"``, from the same inputs (numpy seeds)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tulip_tpu as tlp
import tulip_tpu_torch as tlt
from golden_large import staircase_lp
from test_sparse_ldl import _dense_col_lp, _staircase_dense_col
from tulip_tpu.ipm.data import make_lp_data as jmake
from tulip_tpu.ipm.hsd import HSDOptions as JHSDOptions
from tulip_tpu.ipm.hsd import hsd_solve as jhsd
from tulip_tpu.ipm.mpc import MPCOptions as JMPCOptions
from tulip_tpu.ipm.mpc import mpc_solve as jmpc
from tulip_tpu.kkt import sparse_ldl as jk2
from tulip_tpu_torch.convert import structured_state_from_numpy
from tulip_tpu_torch.ipm.data import make_lp_data
from tulip_tpu_torch.ipm.hsd import HSDOptions, hsd_solve
from tulip_tpu_torch.ipm.mpc import MPCOptions, mpc_solve
from tulip_tpu_torch.kkt import SparseK2Backend, make_backend
from tulip_tpu_torch.kkt import sparse_ldl as tk2
from tulip_tpu_torch.kkt.dense_ldl import DenseK2State
from tulip_tpu_torch.status import TerminationStatus

torch.set_num_threads(1)

DTYPES = {"f64": (np.float64, torch.float64), "f32": (np.float32,
                                                     torch.float32)}
# dx, dy against the reference's, relative to their largest entry.
RTOL = {"f64": 1e-10, "f32": 1e-4}


def to_numpy(tree):
    """A JAX NamedTuple pytree as nested dicts of numpy arrays (the level
    schedule as a list of dicts)."""
    if hasattr(tree, "_fields"):
        return {f: to_numpy(v) for f, v in zip(tree._fields, tree)}
    if isinstance(tree, tuple):
        return [to_numpy(v) for v in tree]
    return np.asarray(tree)


def lane(v, dt=torch.float64):
    return torch.as_tensor(np.asarray(v), dtype=dt)[None]


@pytest.mark.parametrize("block", [8, 16])
def test_k2_planners_match_reference(block):
    """k2_tile_plan and k2_level_plan give the reference's arrays."""
    A = _staircase_dense_col(ncols_dense=2)
    want, got = jk2.k2_tile_plan(A, block), tk2.k2_tile_plan(A, block)
    assert got is not None and set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]))
    (wn, wp, wN), (gn, gp, gN) = (jk2.k2_level_plan(A, block),
                                  tk2.k2_level_plan(A, block))
    assert gN == wN and gp.ntiles == wp.ntiles
    np.testing.assert_array_equal(gn, wn)
    np.testing.assert_array_equal(gp.tile_brow, wp.tile_brow)
    for g, w in zip(gp.segs, wp.segs):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def inputs(m, n, dt, seed, bad=False, f32_reg=1e-5):
    """θ⁻¹, Rp, Rd, ξp, ξd; f32 with the reference's moderate spread
    (tests/test_sparse_ldl.py:test_k2_tiled_f32). ``bad`` makes the
    system not quasi-definite: negative θ⁻¹ on x nodes turns their pivots
    positive, and the x-part Cholesky of their tiles fails (without the
    Jacobi scaling, whose 1/√θ⁻¹ would be NaN there)."""
    rng = np.random.default_rng(seed)
    span, reg = (6, 1e-8) if dt == "f64" else (2, f32_reg)
    th = 10.0 ** rng.uniform(-span, span, n)
    if bad:
        th[::5] = -1e3
    np_dt = DTYPES[dt][0]
    return [v.astype(np_dt) for v in (
        th, np.full(n, reg), np.full(m, reg), rng.standard_normal(m),
        rng.standard_normal(n))]


# (schedule, inv_factor, dtype, quasi-definite); the failure case in f64.
CASES = [(sched, inv, dt, True) for sched in ("column", "level")
         for inv in (True, False) for dt in sorted(DTYPES)] + [
    (sched, inv, "f64", False) for sched in ("column", "level")
    for inv in (True, False)]


@pytest.mark.parametrize("sched,inv,dt,qd", CASES, ids=[
    f"{s}-{'inv' if i else 'trsm'}-{d}{'' if q else '-not-qd'}"
    for s, i, d, q in CASES])
def test_factor_and_solve_match_reference(sched, inv, dt, qd):
    """``update`` + ``solve`` (two refinement sweeps) on the state carried
    across from the reference's ``setup``, which equals the port's own:
    the same ``ok``; dx, dy within 1e-10 (f64) or 1e-4 (f32) of the
    reference's, relative to their largest entry. Where the input is not
    quasi-definite both report failure and the port's solve stays
    finite.

    The level schedule in f32 runs at regularizations of 1e-3: at the
    column case's 1e-5 its nested-dissection order keeps 2-3 digits in
    both packages (measured: 5e-3 between the reference's f32 and f64
    solves; the reference's comment on ``schedule``), which a 1e-4
    comparison cannot resolve."""
    bad = not qd
    np_dt, t_dt = DTYPES[dt]
    A = _staircase_dense_col(seed=1).astype(np_dt)
    m, n = A.shape
    opts = dict(block=16, refinement_steps=2, schedule=sched,
                inv_factor=inv, jacobi_scale=qd)
    jbe, tbe = jk2.SparseK2Backend(**opts), SparseK2Backend(**opts)
    jst = jbe.setup(jnp.asarray(A))
    kind = type(jst).__name__
    assert kind == ("SparseK2State" if sched == "column"
                    else "SparseK2LevelState")
    tst = structured_state_from_numpy(kind, to_numpy(jst), device="cpu",
                                      dtype=t_dt)
    own = tbe.setup(lane(A, t_dt))
    assert type(own).__name__ == kind
    for f in own._fields:
        if f != "segs":
            np.testing.assert_array_equal(getattr(own, f).numpy(),
                                          getattr(tst, f).numpy())

    th, rP, rD, xp, xd = inputs(m, n, dt, seed=2, bad=bad,
                                f32_reg=1e-5 if sched == "column" else 1e-3)
    jst, jok = jax.jit(jbe.update)(jst, *map(jnp.asarray, (th, rP, rD)))
    tst, tok = tbe.update(tst, *(lane(v, t_dt) for v in (th, rP, rD)))
    assert tok.tolist() == [bool(jok)] == [not bad]
    dx, dy = (v[0].numpy() for v in tbe.solve(tst, lane(xp, t_dt),
                                              lane(xd, t_dt)))
    jdx, jdy = (np.asarray(v) for v in jax.jit(jbe.solve)(
        jst, jnp.asarray(xp), jnp.asarray(xd)))
    if bad:
        assert np.isfinite(dx).all() and np.isfinite(dy).all()
        assert np.isfinite(jdx).all() and np.isfinite(jdy).all()
        return
    assert np.abs(dx - jdx).max() <= RTOL[dt] * np.abs(jdx).max()
    assert np.abs(dy - jdy).max() <= RTOL[dt] * np.abs(jdy).max()


def test_unrefined_solve_and_converted_state_solve_alike():
    """A state converted from the reference's ``setup`` and the port's own
    give the same bits after the same ``update``; ``solve_unrefined`` is
    the base solve, within 1e-8 of the reference's (relative to its
    largest entry; unrefined, the two factorizations' rounding shows)."""
    A = _staircase_dense_col(ncols_dense=2, seed=3)
    m, n = A.shape
    jbe, tbe = jk2.SparseK2Backend(block=8), SparseK2Backend(block=8)
    th, rP, rD, xp, xd = inputs(m, n, "f64", seed=4)
    jst = jbe.setup(jnp.asarray(A))
    tst = structured_state_from_numpy("SparseK2State", to_numpy(jst),
                                      device="cpu")
    args = [lane(v) for v in (th, rP, rD)]
    a, _ = tbe.update(tst, *args)
    b, _ = tbe.update(tbe.setup(lane(A)), *args)
    for x, y in zip(tbe.solve(a, lane(xp), lane(xd)),
                    tbe.solve(b, lane(xp), lane(xd))):
        assert torch.equal(x, y)
    jst, _ = jax.jit(jbe.update)(jst, *map(jnp.asarray, (th, rP, rD)))
    want = jax.jit(jbe._base_solve)(jst, jnp.asarray(xp), jnp.asarray(xd))
    for g, w in zip(tbe.solve_unrefined(a, lane(xp), lane(xd)), want):
        w = np.asarray(w)
        assert np.abs(g[0].numpy() - w).max() <= 1e-8 * np.abs(w).max()


def test_falls_back_to_dense_ldl_where_the_reference_does():
    """A dense A gives no tiling advantage: both packages set up the dense
    K2 state, and the port's solve matches the reference's."""
    A = np.random.default_rng(3).standard_normal((24, 40))
    jbe = jk2.SparseK2Backend(block=8, refinement_steps=1)
    tbe = SparseK2Backend(block=8, refinement_steps=1)
    jst = jbe.setup(jnp.asarray(A))
    assert type(jst).__name__ == "DenseK2State"
    tst = tbe.setup(lane(A))
    assert isinstance(tst, DenseK2State)
    th, rP, rD, xp, xd = inputs(24, 40, "f64", seed=5)
    jst, _ = jbe.update(jst, *map(jnp.asarray, (th, rP, rD)))
    tst, ok = tbe.update(tst, *(lane(v) for v in (th, rP, rD)))
    assert ok.tolist() == [True]
    want = jbe.solve(jst, jnp.asarray(xp), jnp.asarray(xd))
    for g, w in zip(tbe.solve(tst, lane(xp), lane(xd)), want):
        w = np.asarray(w)
        assert np.abs(g[0].numpy() - w).max() <= 1e-10 * np.abs(w).max()


def test_dummy_tile_is_zero_after_the_factorization():
    """The column schedule's padded scatters land on the dummy tile; it
    is zero after ``update``, so the backward sweep's product of it with
    the zero dummy row cannot turn into NaN."""
    A = _staircase_dense_col(seed=1)
    be = SparseK2Backend(block=16)
    m, n = A.shape
    th, rP, rD, _, _ = inputs(m, n, "f64", seed=6)
    st, _ = be.update(be.setup(lane(A)), *(lane(v) for v in (th, rP, rD)))
    assert int((st.col_ids == st.T.shape[1] - 1).sum()) > 0
    assert torch.equal(st.T[0, -1], torch.zeros_like(st.T[0, -1]))


def test_make_backend_sparse_ldl():
    be = make_backend("sparse-ldl", "K2", refinement_steps=1)
    assert isinstance(be, SparseK2Backend) and be.refinement_steps == 1
    with pytest.raises(ValueError):
        make_backend("sparse-ldl", "K1")


@pytest.mark.parametrize("algo", ["hsd", "mpc"])
def test_end_to_end_dense_column_lp_matches_reference(algo):
    """HSD and MPC through ``"sparse-ldl"`` (block 8, two sweeps) on the
    reference's dense-column staircase LP: the reference's status,
    iterations within ±1, objectives within 1e-8 relative."""
    A, b, c, u = _dense_col_lp()
    n = A.shape[1]
    l = np.zeros(n)
    jbe = jk2.SparseK2Backend(block=8, refinement_steps=2)
    tbe = SparseK2Backend(block=8, refinement_steps=2)
    dat = make_lp_data(A, b, c, 0.0, l, u, device="cpu")
    assert isinstance(tbe.setup(dat.A), tk2.SparseK2State)
    if algo == "hsd":
        want = jhsd(jmake(A, b, c, 0.0, l, u), jbe, JHSDOptions())
        got = hsd_solve(dat, tbe, HSDOptions())
    else:
        want = jmpc(jmake(A, b, c, 0.0, l, u), jbe, JMPCOptions())
        got = mpc_solve(dat, tbe, MPCOptions())
    assert int(got.status[0]) == int(want.status) == \
        int(TerminationStatus.OPTIMAL)
    assert abs(int(got.niter[0]) - int(want.niter)) <= 1
    assert isinstance(got.kkt, tk2.SparseK2State)
    z_j, z_t = float(want.pobj), float(got.pobj[0])
    assert abs(z_t - z_j) <= 1e-8 * max(1.0, abs(z_j))


def load_pair(lp, **params):
    """The reference's Model and the port's (on the CPU) holding the same
    equality-form LP, with ``params`` set on both."""
    A, b, c, u = lp
    coo = A.tocoo()
    out = []
    for pkg, kw in ((tlp, {}), (tlt, {"device": "cpu"})):
        mod = pkg.Model(**kw)
        mod.pbdata.load(True, c, 0.0, (coo.row, coo.col, coo.data), b, b,
                        np.zeros(A.shape[1]), u)
        for k, v in params.items():
            pkg.set_parameter(mod, k, v)
        out.append(mod)
    return out


@pytest.mark.parametrize("lp,params", [
    (lambda: staircase_lp(2048, dense_cols=12, dense_scale=1.0), {}),
    (lambda: staircase_lp(512, dense_cols=4, dense_scale=1.0),
     {"KKT_System": "K2", "KKT_Backend": "sparse-ldl"}),
], ids=["probe-2048", "named-512"])
def test_model_reaches_the_tiled_state_as_the_reference(lp, params):
    """``Model.optimize()`` routes to ``"sparse-ldl"`` where the reference
    does (the structure probe's answer for 12 dense columns at m = 2048,
    with no backend named; the backend named at m = 512), sets up the
    tiled ``SparseK2State`` and reaches the reference's status, with
    iterations within ±1 and the objective within 1e-8 relative."""
    jmod, tmod = load_pair(lp(), **params)
    st_j, st_t = jmod.optimize(), tmod.optimize()
    assert tmod.kkt_backend.name == jmod.kkt_backend.name == "sparse-ldl"
    assert tmod.kkt_backend.refinement_steps == 2
    assert type(jmod.solver_state.kkt).__name__ == "SparseK2State"
    assert isinstance(tmod.solver_state.kkt, tk2.SparseK2State)
    assert st_t == st_j == TerminationStatus.OPTIMAL
    assert abs(tmod.barrier_iterations - jmod.barrier_iterations) <= 1
    z_j = tlp.get_attribute(jmod, "ObjectiveValue")
    z_t = tlt.get_attribute(tmod, "ObjectiveValue")
    assert abs(z_t - z_j) <= 1e-8 * max(1.0, abs(z_j))
