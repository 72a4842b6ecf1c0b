"""Port parity: the level engine and the structured K1 backends of
``tulip_tpu_torch`` (``kkt/levels.py``, ``kkt/sparse.py``,
``kkt/banded.py``) against the JAX package's, from the same inputs (numpy
seeds) on the CPU: the host plans index for index, the level factorization
and substitutions on the same tile store, and ``update`` + ``solve`` on
states carried across by ``tulip_tpu_torch.convert``. The reference's
device functions run under ``jax.jit`` (one compile of the unrolled levels
instead of one per operation and shape)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tulip_tpu  # noqa: F401
from tulip_tpu.kkt import banded as jbanded
from tulip_tpu.kkt import levels as jlevels
from tulip_tpu.kkt import sparse as jsparse
from tulip_tpu_torch.convert import structured_state_from_numpy
from tulip_tpu_torch.kkt import banded as tbanded
from tulip_tpu_torch.kkt import levels as tlevels
from tulip_tpu_torch.kkt import sparse as tsparse
from tulip_tpu_torch.kkt.dense import DenseK1State

torch.set_num_threads(1)

DTYPES = {"f64": (np.float64, torch.float64), "f32": (np.float32,
                                                     torch.float32)}


def staircase(stages=16, mr=16, nc=20, cyclic=False, seed=0):
    """The staircase constraint matrix of tests/test_levels.py, with
    ``cyclic`` wrap-around coupling."""
    rng = np.random.default_rng(seed)
    m = stages * mr
    n = stages * nc + (0 if cyclic else nc)
    A = np.zeros((m, n))
    for s in range(stages):
        A[s*mr:(s+1)*mr, s*nc:(s+1)*nc] = rng.standard_normal((mr, nc))
        t = ((s + 1) % stages) if cyclic else (s + 1)
        A[s*mr:(s+1)*mr, t*nc:(t+1)*nc] = rng.standard_normal((mr, nc))
    return A


def scattered(seed=4):
    """A staircase with long-range stage couplings (RCM bandwidth ~ m)."""
    rng = np.random.default_rng(seed)
    A = staircase(stages=20, mr=12, nc=16, seed=seed)
    for _ in range(4):
        s, t = rng.choice(20, 2, replace=False)
        A[s*12:(s+1)*12, t*16:(t+1)*16] += 0.3 * rng.standard_normal(
            (12, 16))
    return A


MATRICES = {"staircase": lambda: staircase(seed=1),
            "cyclic": lambda: staircase(cyclic=True, seed=2),
            "scattered": scattered}


def seg_arrays(segs):
    return [[np.asarray(t) for t in seg] for seg in segs]


@pytest.mark.parametrize("which", sorted(MATRICES))
def test_host_plans_match_reference(which):
    """k1_level_plan (its permutation, supports and level schedule),
    build_level_plan and tile_plan give the reference's arrays exactly."""
    A = MATRICES[which]()
    want = jsparse.k1_level_plan(A, 16)
    got = tsparse.k1_level_plan(A, 16)
    assert (want is None) == (got is None)
    if want is not None:
        np.testing.assert_array_equal(got["perm"], want["perm"])
        np.testing.assert_array_equal(got["sup_idx"], want["sup_idx"])
        wp, gp = want["plan"], got["plan"]
        assert gp.ntiles == wp.ntiles
        np.testing.assert_array_equal(gp.tile_brow, wp.tile_brow)
        np.testing.assert_array_equal(gp.tile_bcol, wp.tile_bcol)
        assert len(gp.segs) == len(wp.segs)
        for g, w in zip(seg_arrays(gp.segs), seg_arrays(wp.segs)):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
    want_t = jsparse.tile_plan(A, 16)
    got_t = tsparse.tile_plan(A, 16)
    assert (want_t is None) == (got_t is None)
    if want_t is not None:
        assert set(got_t) == set(want_t)
        for k in want_t:
            np.testing.assert_array_equal(np.asarray(got_t[k]),
                                          np.asarray(want_t[k]))


def test_build_level_plan_places_its_tensors():
    """build_level_plan puts every index tensor on the device it is given,
    as int64, with the reference's values."""
    nbr = 24
    bi = np.concatenate([np.arange(nbr), np.arange(1, nbr)])
    bj = np.concatenate([np.arange(nbr), np.arange(nbr - 1)])
    order = jlevels.nd_block_order(bi, bj, nbr)
    binv = np.empty(nbr, np.int64)
    binv[order] = np.arange(nbr)
    col_rows = jlevels.tile_fill(binv[bi], binv[bj], nbr)
    want = jlevels.build_level_plan(col_rows, nbr)
    got = tlevels.build_level_plan(col_rows, nbr, device="cpu")
    assert all(t.dtype == torch.int64 and t.device.type == "cpu"
               for seg in got.segs for t in seg)
    for g, w in zip(seg_arrays(got.segs), seg_arrays(want.segs)):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def tile_store(A, block, dtype, seed=3):
    """(level plan, tile store T) of K = A diag(d) Aᵀ + 1e-6 I in the
    plan's order: T holds K's tiles on the filled pattern (fill tiles
    zero), as the backends' assembly leaves it."""
    lv = jsparse.k1_level_plan(A, block)
    rng = np.random.default_rng(seed)
    d = 10.0 ** rng.uniform(-2, 2, A.shape[1])
    K = (A * d) @ A.T + 1e-6 * np.eye(A.shape[0])
    m = A.shape[0]
    nbr = -(-m // block)
    Kp = np.zeros((nbr * block, nbr * block))
    Kp[:m, :m] = K[np.ix_(lv["perm"], lv["perm"])]
    Kp[m:, m:] = np.eye(nbr * block - m)
    plan = lv["plan"]
    T = np.stack([Kp[i*block:(i+1)*block, j*block:(j+1)*block]
                  for i, j in zip(plan.tile_brow, plan.tile_bcol)])
    return plan, T.astype(dtype)


def assert_close(got, want, dt):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if dt == "f64":
        bound = 1e-10 * np.maximum(1.0, np.abs(want))
        assert np.all(np.abs(got - want) <= bound), \
            np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want)))
    else:
        rel = np.max(np.abs(got - want)) / np.max(np.abs(want))
        assert rel <= 2e-4, rel


@pytest.mark.parametrize("inv_factor", [True, False], ids=["inv", "trsm"])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_level_factor_and_substitutions_match_reference(dt, inv_factor):
    """level_factor_spd on the same T, then level_fwd and level_bwd on the
    reference's factor: f64 within 1e-10·max(1, |ref|), f32 within 2e-4
    relative."""
    np_dt, t_dt = DTYPES[dt]
    A = staircase(stages=12, mr=16, nc=20, cyclic=True, seed=5)
    plan, T = tile_store(A, 16, np_dt)
    tsegs = tlevels.segs_to(plan_segs(plan), "cpu")
    want_T, want_ok = jax.jit(lambda T: jlevels.level_factor_spd(
        T, plan.segs, inv_factor=inv_factor))(jnp.asarray(T))
    got_T, got_ok = tlevels.level_factor_spd(torch.as_tensor(T), tsegs,
                                             inv_factor=inv_factor)
    assert bool(want_ok) and bool(got_ok)
    assert got_T.dtype == t_dt
    assert_close(got_T, want_T, dt)

    nbr = -(-A.shape[0] // 16)
    rhs = np.random.default_rng(6).standard_normal((nbr, 16)).astype(np_dt)
    Tf = np.array(want_T)

    @jax.jit
    def substitutions(T, rhs):
        u = jlevels.level_fwd(T, plan.segs, rhs, inv_factor=inv_factor)
        return u, jlevels.level_bwd(T, plan.segs, u, inv_factor=inv_factor)

    u_want, x_want = (np.array(v) for v in substitutions(jnp.asarray(Tf),
                                                         jnp.asarray(rhs)))
    u_got = tlevels.level_fwd(torch.as_tensor(Tf), tsegs,
                              torch.as_tensor(rhs), inv_factor=inv_factor)
    assert_close(u_got, u_want, dt)
    x_got = tlevels.level_bwd(torch.as_tensor(Tf), tsegs,
                              torch.as_tensor(u_want), inv_factor=inv_factor)
    assert_close(x_got, x_want, dt)


def plan_segs(plan):
    """The reference plan's schedule as this package's LevelSegs."""
    return tuple(tlevels.LevelSeg(*(torch.as_tensor(np.asarray(t, np.int64))
                                    for t in seg)) for seg in plan.segs)


@pytest.mark.parametrize("inv_factor", [True, False], ids=["inv", "trsm"])
def test_level_factor_failure_matches_reference(inv_factor):
    """A pivot tile that is not SPD: ok is false and the failed level
    stores identities and zero blocks, on both sides."""
    A = staircase(stages=12, mr=16, nc=20, seed=7)
    plan, T = tile_store(A, 16, np.float64)
    bad = int(np.asarray(plan.segs[1].cols)[0])
    T[bad] = -T[bad]
    want_T, want_ok = jax.jit(lambda T: jlevels.level_factor_spd(
        T, plan.segs, inv_factor=inv_factor))(jnp.asarray(T))
    got_T, got_ok = tlevels.level_factor_spd(
        torch.as_tensor(T), plan_segs(plan), inv_factor=inv_factor)
    assert not bool(want_ok) and not bool(got_ok)
    np.testing.assert_array_equal(got_T[bad].numpy(), np.eye(16))
    finite = np.isfinite(np.asarray(want_T))
    np.testing.assert_array_equal(np.isfinite(got_T.numpy()), finite)
    assert_close(got_T.numpy()[finite], np.asarray(want_T)[finite], "f64")


# -- update + solve ---------------------------------------------------------

BACKENDS = {
    "sparse-level": (dict(block=16), "SparseK1LevelState"),
    "sparse-level-trsm": (dict(block=16, inv_factor=False),
                          "SparseK1LevelState"),
    "sparse-column": (dict(block=16, schedule="column"), "SparseK1State"),
    "banded-level": (dict(min_block=16), "SparseK1LevelState"),
    "banded-scan": (dict(min_block=16, schedule="scan"), "BandedK1State"),
}


def pair(name, **kw):
    opts, state = BACKENDS[name]
    mods = ((jbanded.BandedK1Backend, tbanded.BandedK1Backend)
            if name.startswith("banded") else
            (jsparse.SparseK1Backend, tsparse.SparseK1Backend))
    return mods[0](**opts, **kw), mods[1](**opts, **kw), state


def state_to_numpy(st):
    out = {}
    for f, v in st._asdict().items():
        out[f] = ([{k: np.asarray(t) for k, t in s._asdict().items()}
                   for s in v] if f == "segs" else np.asarray(v))
    return out


def contract_inputs(m, n, seed, span=4):
    rng = np.random.default_rng(seed)
    return (10.0 ** rng.uniform(-span, span, n), np.full(n, 1e-8),
            np.full(m, 1e-8), rng.standard_normal(m),
            rng.standard_normal(n))


def lane(v):
    return torch.as_tensor(np.asarray(v), dtype=torch.float64)[None]


@pytest.mark.parametrize("name", sorted(BACKENDS))
def test_update_solve_matches_reference(name):
    """``update`` + ``solve`` with two refinement sweeps on a state carried
    across from the reference's ``setup``: the augmented-system residual
    under 1e-9 (tests/test_levels.py's contract) and dx, dy within 1e-8
    relative of the reference's; the port's own ``setup`` gives the same
    state."""
    A = staircase(stages=24, mr=8, nc=12, seed=6) if name.startswith(
        "banded") else staircase(cyclic=True, seed=1)
    m, n = A.shape
    jbe, tbe, state = pair(name, refinement_steps=2)
    th, rP, rD, xp, xd = contract_inputs(m, n, seed=7)
    jst = jbe.setup(jnp.asarray(A))
    assert type(jst).__name__ == state
    tst = structured_state_from_numpy(state, state_to_numpy(jst),
                                      device="cpu")
    own = tbe.setup(lane(A))
    assert type(own).__name__ == state
    for f in own._fields:
        if f != "segs":
            np.testing.assert_array_equal(getattr(own, f).numpy(),
                                          getattr(tst, f).numpy())

    jst, jok = jax.jit(jbe.update)(jst, jnp.asarray(th), jnp.asarray(rP),
                                   jnp.asarray(rD))
    tst, tok = tbe.update(tst, lane(th), lane(rP), lane(rD))
    assert bool(jok) and tok.tolist() == [True]
    jdx, jdy = (np.asarray(v) for v in jax.jit(jbe.solve)(
        jst, jnp.asarray(xp), jnp.asarray(xd)))
    dx, dy = (v[0].numpy() for v in tbe.solve(tst, lane(xp), lane(xd)))
    rd = xd - (-(th + rP) * dx + A.T @ dy)
    rp = xp - (A @ dx + rD * dy)
    assert max(np.abs(rd).max(), np.abs(rp).max()) < 1e-9
    assert np.abs(dx - jdx).max() <= 1e-8 * np.abs(jdx).max()
    assert np.abs(dy - jdy).max() <= 1e-8 * np.abs(jdy).max()


@pytest.mark.parametrize("name", ["sparse-level", "banded-scan"])
def test_unrefined_solve_matches_reference(name):
    """``solve_unrefined`` (the IPM's fast predictor) is the base solve,
    as in the reference."""
    A = staircase(stages=24, mr=8, nc=12, seed=8)
    m, n = A.shape
    jbe, tbe, _ = pair(name, refinement_steps=2)
    th, rP, rD, xp, xd = contract_inputs(m, n, seed=9)
    jst, _ = jax.jit(jbe.update)(jbe.setup(jnp.asarray(A)), jnp.asarray(th),
                                 jnp.asarray(rP), jnp.asarray(rD))
    tst, _ = tbe.update(tbe.setup(lane(A)), lane(th), lane(rP), lane(rD))
    want = jax.jit(jbe._base_solve)(jst, jnp.asarray(xp), jnp.asarray(xd))
    got = tbe.solve_unrefined(tst, lane(xp), lane(xd))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g[0].numpy() - w).max() <= 1e-8 * np.abs(w).max()


def test_banded_falls_back_to_dense_where_the_reference_does():
    """No banded advantage (2·bw ≥ m): both packages set up the dense
    inverse-factor state, and the port's update and solve agree."""
    A = np.random.default_rng(10).standard_normal((40, 60))
    jbe, tbe, _ = pair("banded-level")
    assert type(jbe.setup(jnp.asarray(A))).__name__ == "DenseK1State"
    st = tbe.setup(lane(A))
    assert isinstance(st, DenseK1State)
    th, rP, rD, xp, xd = contract_inputs(40, 60, seed=11, span=1)
    st, ok = tbe.update(st, lane(th), lane(rP), lane(rD))
    dx, dy = (v[0].numpy() for v in tbe.solve(st, lane(xp), lane(xd)))
    rd = xd - (-(th + rP) * dx + A.T @ dy)
    rp = xp - (A @ dx + rD * dy)
    assert ok.tolist() == [True]
    assert max(np.abs(rd).max(), np.abs(rp).max()) < 1e-9


def test_sparse_falls_back_to_dense_where_the_reference_does():
    A = np.random.default_rng(12).standard_normal((64, 80))
    jbe, tbe, _ = pair("sparse-level")
    assert type(jbe.setup(jnp.asarray(A))).__name__ == "DenseK1State"
    assert isinstance(tbe.setup(lane(A)), DenseK1State)


def test_structured_backends_take_one_lp():
    A = lane(staircase(seed=1)).expand(2, -1, -1)
    for be in (tsparse.SparseK1Backend(block=16),
               tbanded.BandedK1Backend(min_block=16)):
        with pytest.raises(ValueError, match="one LP"):
            be.setup(A)


def test_host_A_is_what_setup_reads():
    """Given ``host_A``, setup plans on it and reads nothing back from the
    tensor (here a tensor of zeros, which has no plan at all)."""
    A = staircase(cyclic=True, seed=1)
    be = tsparse.SparseK1Backend(block=16, host_A=A)
    st = be.setup(torch.zeros((1,) + A.shape, dtype=torch.float64))
    want = tsparse.SparseK1Backend(block=16).setup(lane(A))
    np.testing.assert_array_equal(st.Apc.numpy(), want.Apc.numpy())
    with pytest.raises(ValueError, match="host_A"):
        be.setup(torch.zeros(1, 3, 4, dtype=torch.float64))


def test_sparse_first_data_raises_naming_item_8b():
    class SparseData:  # LP data without a dense A, as sparse-first data
        c = None

    with pytest.raises(NotImplementedError, match="8b"):
        tsparse.SparseK1Backend().setup_data(SparseData())
