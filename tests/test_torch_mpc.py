"""Port parity: the batch-first MPC of ``tulip_tpu_torch`` (``ipm/mpc.py``,
``batched_mpc_solve``, ``Algorithm="MPC"`` through Model and
``batch_linprog``) and ``HSDOptions(MehrotraStart=True)`` against the JAX
package, from the same inputs, in f64 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tulip_tpu as tlp
import tulip_tpu_torch as tlt
from golden_lps import ALL_GOLDEN
from test_torch_hsd import jax_batch, random_lps, to_numpy
from test_torch_linprog import heterogeneous, mixed_forms, presolve_paths
from test_torch_model import load_both
from tulip_tpu.ipm import batch as jbatch
from tulip_tpu.ipm import data as jdata
from tulip_tpu.ipm import hsd as jhsd
from tulip_tpu.ipm import mpc as jmpc
from tulip_tpu.kkt import DenseK1Backend as JDense
from tulip_tpu_torch.convert import (hsd_state_from_numpy, hsd_state_to_numpy,
                                     lp_data_from_numpy)
from tulip_tpu_torch.ipm.batch import (batched_hsd_solve, batched_mpc_solve,
                                       stack_lps_host)
from tulip_tpu_torch.ipm.data import make_lp_data
from tulip_tpu_torch.ipm.hsd import HSDOptions, init_state
from tulip_tpu_torch.ipm.mpc import MPCOptions, mpc_iteration, mpc_solve
from tulip_tpu_torch.kkt import DenseK1Backend
from tulip_tpu_torch.status import TerminationStatus

torch.set_num_threads(1)

OPT = int(TerminationStatus.OPTIMAL)


@pytest.mark.parametrize("jax_be,torch_be", [
    (JDense(), DenseK1Backend()),
    (JDense(inv_factor=True, refinement_steps=1),
     DenseK1Backend(inv_factor=True, refinement_steps=1)),
], ids=["dense", "inv-factor"])
def test_one_mpc_iteration_from_same_state(jax_be, torch_be):
    raws = random_lps(17, B=4)
    jd = jax_batch(raws, jnp.float64)
    step = jax.jit(jax.vmap(lambda d, s: jmpc.mpc_iteration(
        jax_be, jmpc.MPCOptions(), d, s)))
    state = jax.vmap(lambda d: jmpc.init_state_mpc(d, jax_be))(jd)
    for _ in range(3):
        state = step(jd, state)
    want = to_numpy(step(jd, state))

    got = hsd_state_to_numpy(mpc_iteration(
        torch_be, MPCOptions(), lp_data_from_numpy(to_numpy(jd), device="cpu"),
        hsd_state_from_numpy(to_numpy(state), device="cpu")))
    # f64 on both sides, summation order apart: 1e-10 relative leaves room
    # for the conditioning of one Newton step; atol covers exact zeros.
    for f, v in want["pt"].items():
        np.testing.assert_allclose(got["pt"][f], v, rtol=1e-10, atol=1e-14,
                                   err_msg=f)
    for f in ("regP", "regD", "pobj", "dobj"):
        np.testing.assert_allclose(got[f], want[f], rtol=1e-10, err_msg=f)
    for f in ("niter", "status", "primal_status", "dual_status"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def test_batched_mpc_matches_jax():
    """tests/test_batch.py:118's instances (seed 21, six 6×12 LPs)."""
    rng = np.random.default_rng(21)
    raws = []
    for _ in range(6):
        A = rng.standard_normal((6, 12))
        u = rng.uniform(1.0, 4.0, 12)
        b = A @ (u * rng.uniform(0.2, 0.8, 12))
        raws.append((A, b, rng.standard_normal(12), 0.0, np.zeros(12), u))
    want = jbatch.batched_mpc_solve(JDense(), jmpc.MPCOptions(),
                                    jax_batch(raws, jnp.float64))
    got = batched_mpc_solve(DenseK1Backend(), MPCOptions(),
                            stack_lps_host(raws, device="cpu"))
    assert (got.status.numpy() == OPT).all()
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(want.status))
    np.testing.assert_array_equal(got.niter.numpy(), np.asarray(want.niter))
    np.testing.assert_allclose(got.pobj.numpy(), np.asarray(want.pobj),
                               rtol=1e-8, atol=0)


def test_batched_mpc_heterogeneous_statuses_match_jax():
    """Optimal / infeasible / unbounded lanes (tests/test_batch.py:97-115)
    under MPC's weaker infeasibility tests, lane by lane."""
    probs = [
        ([[1, 1], [1, -1]], [1, 0], [1, 2], 0.0, [0, 0], [1, 1]),
        ([[1, 1], [1, -1]], [1, 3], [1, 1], 0.0, [0, 0], [1, 1]),
        ([[1, -1], [0, 0]], [1, 0], [-1, -1], 0.0, [0, 0], [np.inf, np.inf]),
    ]
    want = jbatch.batched_mpc_solve(JDense(), jmpc.MPCOptions(),
                                    jax_batch(probs, jnp.float64))
    got = batched_mpc_solve(DenseK1Backend(), MPCOptions(), stack_lps_host(
        probs, device="cpu"))
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(want.status))
    np.testing.assert_array_equal(got.niter.numpy(), np.asarray(want.niter))


@pytest.mark.parametrize("presolve", [1, 0], ids=["presolve", "no-presolve"])
@pytest.mark.parametrize("gen", ALL_GOLDEN, ids=lambda g: g.__name__)
def test_model_mpc_matches_jax_f64(gen, presolve):
    jm, tm = load_both(gen(), Presolve_Level=presolve, IPM_Algorithm="MPC")
    st_j, st_t = jm.optimize(), tm.optimize()
    assert st_t == st_j
    assert tm.barrier_iterations == jm.barrier_iterations
    if st_j == TerminationStatus.OPTIMAL:
        z_j = tlp.get_attribute(jm, "ObjectiveValue")
        z_t = tlt.get_attribute(tm, "ObjectiveValue")
        assert abs(z_t - z_j) <= 1e-8 * max(1.0, abs(z_j))


@pytest.mark.parametrize("make,presolve", [
    (heterogeneous, None), (presolve_paths, False), (mixed_forms, None)],
    ids=["heterogeneous", "no-presolve", "forms"])
def test_batch_linprog_mpc_matches_jax(make, presolve):
    probs = make()
    want = tlp.batch_linprog(probs, dtype="float64", presolve=presolve,
                             algorithm="MPC")
    got = tlt.batch_linprog(probs, device="cpu", dtype="float64",
                            presolve=presolve, algorithm="MPC")
    for g, w in zip(got, want):
        assert (g.status, g.termination, g.nit) == \
            (w.status, w.termination, w.nit), g.message
        if w.success:
            assert abs(g.fun - w.fun) <= 1e-8 * max(1.0, abs(w.fun))
    assert any(w.success for w in want)


def test_mpc_output_level_log_matches_jax(capsys):
    """OutputLevel=1 prints MPC's header (no gap column) and one row per
    pass through the shared driver loop, with the same numbers in f64:
    the objectives to every printed digit, the residual norms and μ to
    1e-6 relative or 1e-10 absolute (at the optimum they are rounding
    noise, ~1e-12)."""
    raw = random_lps(23, B=1)[0]
    jmpc.mpc_solve(jdata.make_lp_data(*raw), JDense(),
                   jmpc.MPCOptions(OutputLevel=1))
    want = capsys.readouterr().out.splitlines()
    got_state = mpc_solve(make_lp_data(*raw, device="cpu"), DenseK1Backend(),
                          MPCOptions(OutputLevel=1))
    got = capsys.readouterr().out.splitlines()
    assert "Optimizer info (MPC)" in got
    assert len(got) == len(want)
    rows = 0
    for g, w in zip(got, want):
        if g[:4].strip().isdigit():
            rows += 1
            gs, ws = g.split(), w.split()
            assert gs[:3] == ws[:3]
            np.testing.assert_allclose([float(v) for v in gs[3:6]],
                                       [float(v) for v in ws[3:6]],
                                       rtol=1e-6, atol=1e-10)
        else:
            assert g == w
    assert rows == int(got_state.niter[0]) + 1


def test_mpc_time_limit_and_batch_log_checks():
    raw = random_lps(24, B=1)[0]
    got = mpc_solve(make_lp_data(*raw, device="cpu"), DenseK1Backend(),
                    MPCOptions(TimeLimit=0.0))
    assert int(got.status[0]) == int(TerminationStatus.TIME_LIMIT)
    assert int(got.niter[0]) == 1
    dats = stack_lps_host(random_lps(1, B=2), device="cpu")
    with pytest.raises(ValueError):
        batched_mpc_solve(DenseK1Backend(), MPCOptions(OutputLevel=1), dats)
    with pytest.raises(ValueError):
        mpc_solve(dats, DenseK1Backend(), MPCOptions())


def test_mehrotra_start_matches_jax():
    raws = random_lps(25, B=5)
    jopts = jhsd.HSDOptions(MehrotraStart=True)
    want = jbatch.batched_hsd_solve(JDense(), jopts,
                                    jax_batch(raws, jnp.float64))
    got = batched_hsd_solve(DenseK1Backend(), HSDOptions(MehrotraStart=True),
                            stack_lps_host(raws, device="cpu"))
    assert (got.status.numpy() == OPT).all()
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(want.status))
    np.testing.assert_array_equal(got.niter.numpy(), np.asarray(want.niter))
    np.testing.assert_allclose(got.pobj.numpy(), np.asarray(want.pobj),
                               rtol=1e-8, atol=0)
    # The start itself: the Mehrotra point at τ = κ = 1.
    jstate = jhsd.init_state(jdata.make_lp_data(*raws[0]), JDense(),
                             mehrotra=True)
    tstate = init_state(make_lp_data(*raws[0], device="cpu"),
                        DenseK1Backend(), mehrotra=True)
    for f in ("x", "xl", "xu", "y", "zl", "zu", "kappa", "mu"):
        np.testing.assert_allclose(getattr(tstate.pt, f).numpy().ravel(),
                                   np.asarray(getattr(jstate.pt, f)).ravel(),
                                   rtol=1e-10, atol=1e-14, err_msg=f)


def test_model_mehrotra_start_matches_jax():
    jm, tm = load_both(ALL_GOLDEN[0](), IPM_MehrotraStart=True)
    assert jm.optimize() == tm.optimize() == TerminationStatus.OPTIMAL
    assert tm.barrier_iterations == jm.barrier_iterations
    z_j = tlp.get_attribute(jm, "ObjectiveValue")
    assert abs(tlt.get_attribute(tm, "ObjectiveValue") - z_j) <= \
        1e-8 * max(1.0, abs(z_j))
