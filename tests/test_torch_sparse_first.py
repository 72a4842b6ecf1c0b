"""Port parity of the sparse-first data path and of ``"sparse-smw"`` on the
CPU: the COO standard form and the compressed tile arrays index for index,
the operators against the dense product, the SMW backend's update and
solve on states carried across from the JAX package, HSD through
``Model.optimize()`` on both packages, and the routing, from the same LPs
(numpy seeds).

m = 2048 is the smallest staircase whose tile plan at the Model's block of
128 passes the 0.5 fill gate: at m = 1024 both packages fall back to the
dense data (``sparse_lp_data_from_problem`` gives None). Phase 16 of
``chip_smoke.py`` (the reference's scale point, m = 32768 and 65536) runs
here as a ``slow`` test."""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp
import tulip_tpu as tlp
import tulip_tpu_torch as tlt
from golden_large import load_model, staircase_lp
from tulip_tpu.ipm.sparse_data import \
    sparse_lp_data_from_problem as jsparse_data
from tulip_tpu.ipm.sparse_data import standard_form_coo as jcoo
from tulip_tpu.kkt.sparse import SparseK1Backend as JSparse
from tulip_tpu.kkt.splitting import SplitK1Backend as JSplit
from tulip_tpu_torch import cli
from tulip_tpu_torch.convert import (sparse_lp_data_from_numpy,
                                     structured_state_from_numpy)
from tulip_tpu_torch.io.mps import write_mps
from tulip_tpu_torch.ipm.data import matvec, rmatvec
from tulip_tpu_torch.ipm.sparse_data import (SparseLPData,
                                             sparse_lp_data_from_problem,
                                             standard_form_coo)
from tulip_tpu_torch.kkt import SparseK1Backend, SplitK1Backend
from tulip_tpu_torch.kkt.sparse import SparseK1LevelState
from tulip_tpu_torch.kkt.splitting import SplitK1State
from tulip_tpu_torch.status import TerminationStatus

torch.set_num_threads(1)


def to_numpy(tree):
    """A JAX NamedTuple pytree as nested dicts of numpy arrays (tuples of
    NamedTuples, the level schedule, as lists of dicts)."""
    if hasattr(tree, "_fields"):
        return {f: to_numpy(v) for f, v in zip(tree._fields, tree)}
    if isinstance(tree, tuple):
        return [to_numpy(v) for v in tree]
    return np.asarray(tree)


def tpb(pb):
    """The port's ProblemData holding the same LP as the reference's."""
    I, J, V = pb.to_coo()
    out = tlt.ProblemData()
    out.load(pb.objsense, np.asarray(pb.obj), pb.obj0, (I, J, V),
             np.asarray(pb.lcon), np.asarray(pb.ucon), np.asarray(pb.lvar),
             np.asarray(pb.uvar))
    return out


def small(k, m=256):
    """A staircase of 16 stages of 16 rows (k dense columns), planned at
    block 16: 16 block rows, the tile plan of the level engine."""
    A, b, c, u = staircase_lp(m, mr=16, nc=24, dense_cols=k)
    return load_model(A, b, c, u).pbdata, A


def general_bounds_lp():
    """An LP with all five row cases (equality, free, <=, >=, range)."""
    pb = tlp.Model().pbdata
    rng = np.random.default_rng(0)
    for j in range(6):
        pb.add_variable(obj=float(rng.standard_normal()), lb=0.0,
                        ub=float(j + 1))
    bounds = [(1.0, 1.0), (-np.inf, np.inf), (-np.inf, 2.0), (0.5, np.inf),
              (-1.0, 3.0)]
    for i, (lb, ub) in enumerate(bounds):
        cols = [j for j in range(6) if (i + j) % 2 == 0]
        pb.add_constraint(cols, [float(rng.standard_normal())
                                 for _ in cols], lb=lb, ub=ub)
    return pb


def test_standard_form_coo_matches_reference():
    pb = general_bounds_lp()
    got, want = standard_form_coo(tpb(pb)), jcoo(pb)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("k", [0, 2])
def test_sparse_lp_data_host_arrays_match_reference(k):
    """Every array of the port's SparseLPData (on the CPU) equals the
    reference's, index for index; the reference's ``dense_onehot`` is the
    one-hot of ``dense_idx``."""
    pb, _ = small(k)
    jd, n_j, s_j = jsparse_data(pb, block=16)
    td, n_t, s_t = sparse_lp_data_from_problem(tpb(pb), block=16,
                                               device="cpu")
    assert (n_t, s_t) == (n_j, s_j)
    want = to_numpy(jd)
    for f in SparseLPData._fields:
        if f == "segs":
            assert len(td.segs) == len(want["segs"])
            for seg_t, seg_j in zip(td.segs, want["segs"]):
                for name, v in zip(seg_t._fields, seg_t):
                    np.testing.assert_array_equal(v.numpy(), seg_j[name])
            continue
        got = getattr(td, f).numpy()
        if f in ("sup_idx", "perm", "rsup_idx", "dense_idx", "tile_brow",
                 "tile_bcol"):
            assert got.dtype == np.int64
            np.testing.assert_array_equal(got, want[f])
        else:
            np.testing.assert_array_equal(got, want[f][None])
    onehot = np.zeros_like(want["dense_onehot"])
    onehot[want["dense_idx"], np.arange(k)] = 1.0
    np.testing.assert_array_equal(want["dense_onehot"], onehot)
    assert td.U.shape == (1, pb.ncon, k)


@pytest.mark.parametrize("k", [0, 2])
def test_operators_match_dense_product(k):
    """matvec / rmatvec over the compressed blocks against the dense
    standard-form A·x and Aᵀ·y, within 1e-12 (f64)."""
    pb, _ = small(k)
    dat = sparse_lp_data_from_problem(tpb(pb), block=16, device="cpu")[0]
    I, J, V, ntot, *_ = standard_form_coo(tpb(pb))
    A = sp.csr_matrix((V, (I, J)), shape=(pb.ncon, ntot))
    rng = np.random.default_rng(1)
    x, y = rng.standard_normal(ntot), rng.standard_normal(pb.ncon)
    got_x = matvec(dat, torch.as_tensor(x)[None])
    got_y = rmatvec(dat, torch.as_tensor(y)[None])
    assert got_x.shape == (1, pb.ncon) and got_y.shape == (1, ntot)
    np.testing.assert_allclose(got_x[0].numpy(), A @ x, rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(got_y[0].numpy(), A.T @ y, rtol=1e-12,
                               atol=1e-12)


def test_level_state_from_sparse_data_matches_reference():
    """``setup_data`` on a SparseLPData builds the reference's level state:
    the gathered tile operands and supports, exactly."""
    pb, _ = small(0)
    jd = jsparse_data(pb, block=16)[0]
    want = to_numpy(JSparse()._setup_from_sparse_data(jd))
    st = SparseK1Backend().setup_data(
        sparse_lp_data_from_numpy(to_numpy(jd), device="cpu"))
    assert isinstance(st, SparseK1LevelState)
    for f in ("Apc", "Rg0", "Oc0", "T"):
        np.testing.assert_array_equal(getattr(st, f)[0].numpy(), want[f])
    for f in ("sup_tile", "sup_idx", "perm"):
        np.testing.assert_array_equal(getattr(st, f).numpy(), want[f])


def smw_states(sparse_first):
    """The reference's SplitK1State of a 2-dense-column staircase and the
    port's copy of it, from sparse-first data or from the dense A."""
    pb, A = small(2)
    jbe = JSplit(block=16, refinement_steps=2)
    if sparse_first:
        jst = jbe.setup_data(jsparse_data(pb, block=16)[0])
    else:
        jst = jbe.setup(jnp.asarray(A.toarray()))
    return jbe, jst, structured_state_from_numpy(
        "SplitK1State", to_numpy(jst), device="cpu")


@pytest.mark.parametrize("sparse_first", [True, False],
                         ids=["sparse-data", "dense-data"])
def test_smw_update_and_solve_match_reference(sparse_first):
    """SplitK1Backend.update + solve on the state carried across by
    ``convert``: V, Lc and the solution within 1e-8 of the reference's."""
    jbe, jst, tst = smw_states(sparse_first)
    assert isinstance(tst, SplitK1State)
    assert isinstance(tst.A, SparseLPData) == sparse_first
    m, n = tst.U.shape[1], tst.theta_reg.shape[1]
    rng = np.random.default_rng(7)
    theta_inv = rng.uniform(1e-2, 1e2, n)
    regP, regD = np.full(n, 1e-6), np.full(m, 1e-6)
    xi_p, xi_d = rng.standard_normal(m), rng.standard_normal(n)
    jnew, jok = jbe.update(jst, *map(jnp.asarray, (theta_inv, regP, regD)))
    dx_j, dy_j = jbe.solve(jnew, jnp.asarray(xi_p), jnp.asarray(xi_d))
    tbe = SplitK1Backend(block=16, refinement_steps=2)

    def lane(v):
        return torch.as_tensor(v)[None]

    tnew, tok = tbe.update(tst, lane(theta_inv), lane(regP), lane(regD))
    dx_t, dy_t = tbe.solve(tnew, lane(xi_p), lane(xi_d))
    assert bool(jok) and tok.tolist() == [True]
    for got, want in [(tnew.V[0], jnew.V), (tnew.Lc[0], jnew.Lc),
                      (dx_t[0], dx_j), (dy_t[0], dy_j)]:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-8,
                                   atol=1e-8 * np.abs(want).max())


def model_pair(k, **params):
    """The reference's and the port's Model on staircase_lp(2048, k dense
    columns), each with ``params``."""
    A, b, c, u = staircase_lp(2048, dense_cols=k)
    jmod = load_model(A, b, c, u)
    tmod = tlt.Model(device="cpu")
    tmod.pbdata = tpb(jmod.pbdata)
    for key, v in params.items():
        tlp.set_parameter(jmod, key, v)
        tlt.set_parameter(tmod, key, v)
    return jmod, tmod


@pytest.mark.parametrize("k,name", [(0, "sparse"), (2, "sparse-smw")])
def test_hsd_through_sparse_first_matches_reference(k, name):
    """``KKT_SparseFirst=True``: the reference's backend, status and
    iteration count, the objective within 1e-8 relative; the port's
    solver state is built from the SparseLPData (no dense A)."""
    jmod, tmod = model_pair(k, KKT_SparseFirst=True)
    st_j, st_t = jmod.optimize(), tmod.optimize()
    assert tmod.kkt_backend.name == jmod.kkt_backend.name == name
    assert tmod.kkt_backend.refinement_steps == \
        jmod.kkt_backend.refinement_steps >= 1
    assert st_t == st_j == TerminationStatus.OPTIMAL
    assert tmod.barrier_iterations == jmod.barrier_iterations
    z_j = tlp.get_attribute(jmod, "ObjectiveValue")
    z_t = tlt.get_attribute(tmod, "ObjectiveValue")
    assert abs(z_t - z_j) <= 1e-8 * max(1.0, abs(z_j))
    kkt = tmod.solver_state.kkt
    if k:
        assert isinstance(kkt, SplitK1State)
        assert isinstance(kkt.A, SparseLPData)
    else:
        assert isinstance(kkt, SparseK1LevelState)
    assert tmod._probe_cache is None


@pytest.mark.parametrize("k,name", [(0, "sparse"), (2, "sparse-smw")])
def test_sparse_first_auto_threshold(k, name):
    """At ``SparseFirstThreshold`` rows the defaults take sparse-first, by
    U's width, with no dense probe (its cache stays empty)."""
    _, tmod = model_pair(k, KKT_SparseFirstThreshold=2048,
                         IPM_IterationsLimit=2)
    assert tmod.optimize() == TerminationStatus.ITERATION_LIMIT
    assert tmod.kkt_backend.name == name
    assert tmod._probe_cache is None
    kkt = tmod.solver_state.kkt
    if k:
        assert isinstance(kkt, SplitK1State)
        assert isinstance(kkt.A, SparseLPData)
    else:
        assert isinstance(kkt, SparseK1LevelState)


def test_probe_sparse_smw_runs_on_dense_data():
    """Below the threshold, the probe's ``"sparse-smw"`` on the dense data
    (a staircase with one dense column): the reference's route, status,
    iteration count and objective within 1e-8."""
    jmod, tmod = model_pair(1)
    st_j, st_t = jmod.optimize(), tmod.optimize()
    assert tmod.kkt_backend.name == jmod.kkt_backend.name == "sparse-smw"
    assert tmod.kkt_backend.refinement_steps == 2
    assert st_t == st_j == TerminationStatus.OPTIMAL
    assert tmod.barrier_iterations == jmod.barrier_iterations
    z_j = tlp.get_attribute(jmod, "ObjectiveValue")
    z_t = tlt.get_attribute(tmod, "ObjectiveValue")
    assert abs(z_t - z_j) <= 1e-8 * max(1.0, abs(z_j))
    kkt = tmod.solver_state.kkt
    assert isinstance(kkt, SplitK1State) and isinstance(kkt.A, torch.Tensor)


def test_many_dense_columns_end_in_the_8c_raise():
    """More than 8 dense columns: sparse-first is refused, and the probe
    answers ``"sparse-ldl"`` (item 8c, which raised before it was
    ported), which runs on the dense data."""
    A, b, c, u = staircase_lp(2048, dense_cols=12, dense_scale=1.0)
    coo = A.tocoo()
    mod = tlt.Model(device="cpu")
    mod.pbdata.load(True, c, 0.0, (coo.row, coo.col, coo.data), b, b,
                    np.zeros(A.shape[1]), u)
    mod.params.KKT.SparseFirstThreshold = 2048
    mod.params.IPM.IterationsLimit = 0
    assert mod._sparse_first(mod.pbdata, np.dtype(np.float64)) is None
    assert mod.optimize() == TerminationStatus.ITERATION_LIMIT
    assert mod.kkt_backend.name == "sparse-ldl"
    assert not isinstance(mod.solver_state.kkt, SparseLPData)


def test_cli_sparse_first_flag(tmp_path, capsys):
    """``--SparseFirst 1`` through the port's CLI: reader, COO standard
    form, tile plan, level solve; OPTIMAL, the objective within 1e-7 of
    HiGHS's."""
    from scipy.optimize import linprog

    A, b, c, u = staircase_lp(2048)
    pb = load_model(A, b, c, u, name="sf2048").pbdata
    path = str(tmp_path / "sf2048.mps")
    write_mps(tpb(pb), path)
    rc = cli.main(["--SparseFirst", "1", "--OutputLevel", "1", path],
                  device="cpu")
    out = capsys.readouterr().out
    assert rc == 0, out
    assert re.search(r"Backend\s+: sparse$", out, re.M), out
    got = re.search(r"result: (\w+) objective (\S+)", out)
    assert got is not None and got.group(1) == "OPTIMAL", out
    r = linprog(c, A_eq=A, b_eq=b, method="highs-ipm",
                bounds=np.column_stack([np.zeros(A.shape[1]), u]))
    assert r.status == 0, r.message
    assert abs(float(got.group(2)) - r.fun) <= 1e-7 * max(1.0, abs(r.fun))


ROOT = Path(__file__).resolve().parent.parent


def load_script(path):
    """A script of the repository (not a package module) as a module."""
    spec = importlib.util.spec_from_file_location(Path(path).stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_scale_point_lp_is_the_references():
    """chip_smoke.py's phase 16 solves ``staircase_lp(m)``: it is the
    reference's scale-point LP, ``examples/large_sparse.py:staircase(m)``,
    array for array (A's CSR arrays, b, c, u)."""
    ours = load_script(ROOT / "chip_smoke.py").staircase_lp(1024)
    theirs = load_script(ROOT / "examples" / "large_sparse.py") \
        .staircase(1024)
    A, A_ref = ours[0], theirs[0]
    assert A.shape == A_ref.shape == (1024, 1632)
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(A, f), getattr(A_ref, f))
    for x, x_ref in zip(ours[1:], theirs[1:]):
        np.testing.assert_array_equal(x, x_ref)


@pytest.mark.slow
@pytest.mark.parametrize("point", [0, 1], ids=["m32768", "m65536"])
def test_scale_point_on_the_cpu(point):
    """Phase 16's LPs through the port's ``Model.optimize()`` at its
    defaults on the CPU, with phase 16's gates: sparse-first ``"sparse"``,
    OPTIMAL within one iteration of the reference's count and the
    objective within ``SCALE_RTOL`` of ``SCALE_POINTS``' (at m = 65536 the
    port's own, which this test gives)."""
    smoke = load_script(ROOT / "chip_smoke.py")
    m, iters, z_ref = smoke.SCALE_POINTS[point]
    mod = smoke.staircase_model(smoke.staircase_lp(m), "cpu", "float64")
    assert mod.optimize() == TerminationStatus.OPTIMAL
    assert mod.kkt_backend.name == "sparse"
    assert isinstance(mod.solver_state.kkt, SparseK1LevelState)
    assert abs(mod.barrier_iterations - iters) <= 1
    z = tlt.get_attribute(mod, "ObjectiveValue")
    assert abs(z - z_ref) <= smoke.SCALE_RTOL * abs(z_ref)
