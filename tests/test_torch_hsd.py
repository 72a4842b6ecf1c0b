"""Port parity: the batch-first HSD of ``tulip_tpu_torch`` against the JAX
package's vmapped HSD, from the same inputs (numpy seeds) and, for the
single-iteration check, the same iterate carried across by
``tulip_tpu_torch.convert``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tulip_tpu  # noqa: F401
from tulip_tpu.ipm import batch as jbatch
from tulip_tpu.ipm import data as jdata
from tulip_tpu.ipm import hsd as jhsd
from tulip_tpu.kkt import DenseK1Backend as JDense
from tulip_tpu.kkt import PallasSmallK1Backend
from tulip_tpu_torch.convert import (hsd_state_from_numpy, hsd_state_to_numpy,
                                     lp_data_from_numpy)
from tulip_tpu_torch.ipm.batch import (batched_hsd_solve, pad_lp, stack_lps,
                                       stack_lps_host)
from tulip_tpu_torch.ipm.data import make_lp_data
from tulip_tpu_torch.ipm.hsd import HSDOptions, hsd_iteration, hsd_solve
from tulip_tpu_torch.kkt import DenseK1Backend, SmallK1Backend
from tulip_tpu_torch.status import TerminationStatus

torch.set_num_threads(1)

OPT = int(TerminationStatus.OPTIMAL)
BENCH_TOL = dict(TolerancePFeas=3e-4, ToleranceDFeas=3e-4, ToleranceRGap=3e-4,
                 ToleranceIFeas=3e-4, PRegMin=1e-6, DRegMin=1e-6)


def random_lps(seed, B, m=6, n=12):
    """Random standard-form LPs with a known interior point, as
    tests/test_batch.py:random_feasible_lp draws them."""
    rng = np.random.default_rng(seed)
    raws = []
    for _ in range(B):
        A = rng.standard_normal((m, n))
        u = rng.uniform(1.0, 4.0, n)
        x0 = u * rng.uniform(0.2, 0.8, n)
        b = A @ x0
        c = rng.standard_normal(n)
        raws.append((A, b, c, 0.0, np.zeros(n), u))
    return raws


def jax_batch(raws, dtype):
    return jbatch.stack_lps([jdata.make_lp_data(*r, dtype=dtype)
                             for r in raws])


def to_numpy(tree):
    if hasattr(tree, "_asdict"):
        return {k: to_numpy(v) for k, v in tree._asdict().items()}
    return np.asarray(tree)


@pytest.mark.parametrize("jax_be,torch_be,fast", [
    (JDense(), DenseK1Backend(), False),
    (JDense(inv_factor=True, refinement_steps=1),
     DenseK1Backend(inv_factor=True, refinement_steps=1), True),
], ids=["dense", "inv-factor-fast-predictor"])
def test_one_iteration_from_same_state(jax_be, torch_be, fast):
    raws = random_lps(11, B=4)
    jd = jax_batch(raws, jnp.float64)
    kw = dict(FastPredictor=fast, FastCorrections=fast)
    jopts, topts = jhsd.HSDOptions(**kw), HSDOptions(**kw)
    step = jax.jit(jax.vmap(
        lambda d, s: jhsd.hsd_iteration(jax_be, jopts, d, s)))
    state = jax.vmap(lambda d: jhsd.init_state(d, jax_be))(jd)
    for _ in range(3):
        state = step(jd, state)
    want = to_numpy(step(jd, state))

    dat = lp_data_from_numpy(to_numpy(jd), device="cpu")
    got = hsd_state_to_numpy(hsd_iteration(
        torch_be, topts, dat,
        hsd_state_from_numpy(to_numpy(state), device="cpu")))
    # f64 on both sides; only the summation order of the reductions and
    # GEMVs differs, so the iterate agrees to ~1e-13 relative. rtol 1e-10
    # leaves room for the conditioning of one Newton step; atol covers
    # entries that are exactly zero on one side (masked bounds).
    for f, v in want["pt"].items():
        np.testing.assert_allclose(got["pt"][f], v, rtol=1e-10, atol=1e-14,
                                   err_msg=f)
    for f in ("niter", "status", "primal_status", "dual_status"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


@dataclasses.dataclass(frozen=True)
class JFlaky(JDense):
    """A lane's factorization "fails" while max(regD) < A[0, 0]."""

    def update(self, state, theta_inv, regP, regD):
        kkt, ok = JDense.update(self, state, theta_inv, regP, regD)
        return kkt, ok & (jnp.max(regD) >= state.A[0, 0])


@dataclasses.dataclass(frozen=True)
class Flaky(DenseK1Backend):
    def update(self, state, theta_inv, regP, regD):
        kkt, ok = DenseK1Backend.update(self, state, theta_inv, regP, regD)
        return kkt, ok & (regD.amax(-1) >= state.A[:, 0, 0])


def test_bump_ladder_is_per_lane():
    """Lane 0 factors at once, lane 1 after one x100 bump, lane 2 never
    (NUMERICAL_PROBLEM, point and niter frozen): each keeps its own
    regularization, as under the reference's vmapped while_loop."""
    raws = random_lps(13, B=3)
    for lane, a00 in enumerate([0.01, 5.0, 1e9]):
        raws[lane][0][0, 0] = a00
    jd = jax_batch(raws, jnp.float64)
    state = jax.vmap(lambda d: jhsd.init_state(d, JFlaky()))(jd)
    want = to_numpy(jax.vmap(lambda d, s: jhsd.hsd_iteration(
        JFlaky(), jhsd.HSDOptions(), d, s))(jd, state))

    got = hsd_state_to_numpy(hsd_iteration(
        Flaky(), HSDOptions(), lp_data_from_numpy(to_numpy(jd), device="cpu"),
        hsd_state_from_numpy(to_numpy(state), device="cpu")))
    np.testing.assert_allclose(got["regG"], [0.1, 10.0, 1e5], rtol=1e-12)
    assert got["status"].tolist() == [
        1, 1, int(TerminationStatus.NUMERICAL_PROBLEM)]
    assert got["niter"].tolist() == [1, 1, 0]
    for f in ("regP", "regD", "regG"):
        np.testing.assert_allclose(got[f], want[f], rtol=1e-12, err_msg=f)
    for f in ("niter", "status"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    for f, v in want["pt"].items():
        np.testing.assert_allclose(got["pt"][f], v, rtol=1e-10, atol=1e-14,
                                   err_msg=f)


def test_batched_solve_matches_jax_f64():
    raws = random_lps(42, B=8)
    want = jbatch.batched_hsd_solve(JDense(), jhsd.HSDOptions(),
                                    jax_batch(raws, jnp.float64))
    got = batched_hsd_solve(DenseK1Backend(), HSDOptions(),
                            stack_lps_host(raws, device="cpu",
                                           dtype=torch.float64))
    assert (got.status.numpy() == OPT).all()
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(want.status))
    np.testing.assert_array_equal(got.niter.numpy(), np.asarray(want.niter))
    # Same iterates up to summation order, accumulated over ~6 iterations.
    np.testing.assert_allclose(got.pobj.numpy(), np.asarray(want.pobj),
                               rtol=1e-9, atol=0)


def test_heterogeneous_statuses_match_jax():
    """Optimal / infeasible / unbounded lanes of tests/test_batch.py:97-115
    resolve independently and to the same statuses."""
    probs = [
        ([[1, 1], [1, -1]], [1, 0], [1, 2], 0.0, [0, 0], [1, 1]),
        ([[1, 1], [1, -1]], [1, 3], [1, 1], 0.0, [0, 0], [1, 1]),
        ([[1, -1], [0, 0]], [1, 0], [-1, -1], 0.0, [0, 0], [np.inf, np.inf]),
    ]
    want = jbatch.batched_hsd_solve(JDense(), jhsd.HSDOptions(),
                                    jax_batch(probs, jnp.float64))
    got = batched_hsd_solve(DenseK1Backend(), HSDOptions(), stack_lps(
        [make_lp_data(*p, device="cpu") for p in probs]))
    st = got.status.numpy()
    np.testing.assert_array_equal(st, np.asarray(want.status))
    assert st.tolist() == [OPT, int(TerminationStatus.PRIMAL_INFEASIBLE),
                           int(TerminationStatus.DUAL_INFEASIBLE)]
    np.testing.assert_array_equal(got.niter.numpy(), np.asarray(want.niter))


def test_small_k1_f32_matches_pallas_interpret():
    raws = random_lps(5, B=3)
    jopts = jhsd.HSDOptions(**BENCH_TOL)
    want = jbatch.batched_hsd_solve(
        PallasSmallK1Backend(interpret=True, refinement_steps=1), jopts,
        jax_batch(raws, jnp.float32))
    got = batched_hsd_solve(SmallK1Backend(refinement_steps=1),
                            HSDOptions(**BENCH_TOL),
                            stack_lps_host(raws, device="cpu",
                                           dtype=torch.float32))
    # No float literal promoted the f32 solve to f64, or the reverse.
    leaves = hsd_state_to_numpy(got)
    for part in ("pt", "res", "kkt"):
        for f, v in leaves[part].items():
            assert v.dtype == np.float32, (part, f)
    assert got.pobj.dtype == torch.float32
    assert got.niter.dtype == got.status.dtype == torch.int32
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(want.status))
    # f32 rounding order (plain Cholesky vs the Pallas rank-1 loop, GEMVs)
    # can move the tolerance crossing by one iteration.
    assert np.abs(got.niter.numpy() - np.asarray(want.niter)).max() <= 1
    np.testing.assert_allclose(got.pobj.numpy(), np.asarray(want.pobj),
                               rtol=1e-3, atol=0)


def test_hsd_solve_single_lp_and_padding():
    """hsd_solve is the batch-of-one case; a padded copy of the LP (pad_lp)
    reaches the same objective, as tests/test_batch.py:test_pad_preserves_solution
    asks of the JAX package."""
    raw = random_lps(3, B=1)[0]
    want = jhsd.hsd_solve(jdata.make_lp_data(*raw), JDense(),
                          jhsd.HSDOptions())
    dat = make_lp_data(*raw, device="cpu")
    got = hsd_solve(dat, DenseK1Backend(), HSDOptions())
    assert int(got.status[0]) == int(want.status) == OPT
    assert int(got.niter[0]) == int(want.niter)
    np.testing.assert_allclose(float(got.pobj[0]), float(want.pobj),
                               rtol=1e-9)
    padded = hsd_solve(pad_lp(dat, dat.nrow + 3, dat.ncol + 5),
                       DenseK1Backend(), HSDOptions())
    assert int(padded.status[0]) == OPT
    np.testing.assert_allclose(float(padded.pobj[0]), float(want.pobj),
                               rtol=1e-7)


@pytest.mark.parametrize("opts,B,exc", [
    (HSDOptions(OutputLevel=1), 2, ValueError),
    (HSDOptions(TimeLimit=10.0), 2, ValueError)],
    ids=["output", "time-limit"])
def test_unported_options_raise(opts, B, exc):
    """The iteration log and the time limit are ported for one LP; a batch
    raises, as the reference's batched solve has neither."""
    dats = stack_lps_host(random_lps(1, B=B), device="cpu",
                          dtype=torch.float64)
    with pytest.raises(exc):
        batched_hsd_solve(DenseK1Backend(), opts, dats)


def test_output_level_log_matches_jax(capsys):
    """OutputLevel=1 prints the reference's header and one row per pass,
    row k for point k, with the same numbers in f64."""
    raw = random_lps(21, B=1)[0]
    jhsd.hsd_solve(jdata.make_lp_data(*raw), JDense(),
                   jhsd.HSDOptions(OutputLevel=1))
    want = capsys.readouterr().out.splitlines()
    got_state = hsd_solve(make_lp_data(*raw, device="cpu"), DenseK1Backend(),
                          HSDOptions(OutputLevel=1))
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want)
    rows = 0
    for g, w in zip(got, want):
        if g[:4].strip().isdigit():
            rows += 1
            # Every column but the last (wall-clock seconds).
            assert g.rsplit(None, 1)[0] == w.rsplit(None, 1)[0]
        else:
            assert g == w
    assert rows == int(got_state.niter[0]) + 1


@pytest.mark.parametrize("limit,status", [
    (0.0, TerminationStatus.TIME_LIMIT), (600.0, TerminationStatus.OPTIMAL)],
    ids=["zero", "generous"])
def test_time_limit_matches_jax(limit, status):
    """A finite TimeLimit is checked after each iteration: 0 stops after
    the first, in both packages; a generous one changes nothing."""
    raw = random_lps(22, B=1)[0]
    want = jhsd.hsd_solve(jdata.make_lp_data(*raw), JDense(),
                          jhsd.HSDOptions(TimeLimit=limit))
    got = hsd_solve(make_lp_data(*raw, device="cpu"), DenseK1Backend(),
                    HSDOptions(TimeLimit=limit))
    assert int(got.status[0]) == int(want.status) == int(status)
    assert int(got.niter[0]) == int(want.niter)
    if status == TerminationStatus.TIME_LIMIT:
        assert int(got.niter[0]) == 1


@pytest.mark.parametrize("algo", ["HSD", "MPC"])
def test_log_fn_sees_the_references_iterations(algo):
    """``log_fn`` is called after every iteration of ``hsd_solve`` and
    ``mpc_solve``, as in the reference: on tests/data/lp_opt.mps in f64
    the per-iteration (niter, pobj, dobj, mu) of both packages have equal
    length and agree within 1e-10."""
    from pathlib import Path

    from tulip_tpu.io.mps import read_mps
    from tulip_tpu.ipm import mpc as jmpc
    from tulip_tpu_torch.ipm import data as tdata
    from tulip_tpu_torch.ipm.mpc import MPCOptions, mpc_solve

    pb = read_mps(str(Path(__file__).resolve().parent / "data"
                      / "lp_opt.mps"))

    def recorder(rows):
        return lambda s: rows.append(
            (int(np.asarray(s.niter).reshape(-1)[0]),
             *(float(np.asarray(v).reshape(-1)[0])
               for v in (s.pobj, s.dobj, s.pt.mu))))

    want, got = [], []
    jdat = jdata.lp_data_from_problem(pb)[0]
    tdat = tdata.lp_data_from_problem(pb, device="cpu")[0]
    if algo == "HSD":
        jhsd.hsd_solve(jdat, JDense(), jhsd.HSDOptions(),
                       log_fn=recorder(want))
        hsd_solve(tdat, DenseK1Backend(), HSDOptions(),
                  log_fn=recorder(got))
    else:
        jmpc.mpc_solve(jdat, JDense(), jmpc.MPCOptions(),
                       log_fn=recorder(want))
        mpc_solve(tdat, DenseK1Backend(), MPCOptions(),
                  log_fn=recorder(got))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert g[0] == w[0]
        np.testing.assert_allclose(g[1:], w[1:], rtol=1e-10, atol=1e-10)
