"""Port parity on random general LPs: the generator, HiGHS's classification
and the ray checks of ``tests/test_fuzz.py``, the six configurations of
``tests/test_fuzz_xl.py`` ({HSD, MPC} x presolve on/off x f64 at its
defaults / f32 at 3e-4), its MPS round trip and its batch-against-sequential
case, on the port on the CPU.

Each LP is built by the reference's generator, and the same problem data
is loaded into the port's ``Model(device="cpu")``. The two packages are held
to equal statuses, iterations within one, objectives within the
configuration's tolerance of each other and of HiGHS (1e-6 max(1, |f|) in
f64, ``tests/test_fuzz.py:143``), and every certificate the port claims is
a verified ray. One exception, measured: where MPC stops without OPTIMAL
(an infeasibility or a numerical stop), the two trajectories diverge from
rounding, so only the status and the rays are held there
(:func:`test_mpc_trajectories_without_optimum_diverge_from_rounding`).

Tier-1 runs the first CHUNK LPs of each configuration; the rest is marked
``slow``."""

import os
import tempfile
import zlib

import jax
import numpy as np
import pytest
import torch

import tulip_tpu as tlp
import tulip_tpu_torch as tlt
from test_fuzz import (random_general_lp, scipy_status_obj, verify_dual_ray,
                       verify_primal_ray)
from test_fuzz_xl import CONFIGS, N_PER_CONFIG, _configure
from tulip_tpu_torch.model import _certificate_tol

torch.set_num_threads(1)

# LPs a case: N_PER_CONFIG // CHUNK cases a configuration, the first in
# Tier-1.
CHUNK = 10


def port_model(jm):
    """The port's Model (on the CPU) holding the reference Model's LP."""
    pb = jm.pbdata
    I, J, V = pb.to_coo()
    tm = tlt.Model(device="cpu")
    tm.pbdata.load(pb.objsense, pb.obj, pb.obj0, (I, J, V), pb.lcon,
                   pb.ucon, pb.lvar, pb.uvar, name=pb.name)
    return tm


def config_lps(config):
    """The reference Models of ``test_fuzz_xl.py``'s battery for
    ``CONFIGS[config]`` (its seed, its order)."""
    algo, presolve, dtype, _, _ = CONFIGS[config]
    rng = np.random.default_rng(
        zlib.crc32(f"{algo}-{presolve}-{dtype}".encode()))
    return [random_general_lp(rng) for _ in range(N_PER_CONFIG)]


def check_rays(tm, what):
    """Every certificate the port claims verifies, at the gate its Model's
    validator uses."""
    tol = _certificate_tol(tm.params)
    if tm.solution.is_dual_ray:
        assert verify_dual_ray(tm.pbdata, tm.solution, tol=tol), what
    if tm.solution.is_primal_ray:
        assert verify_primal_ray(tm.pbdata, tm.solution, tol=tol), what


def close(a, b, rtol):
    return abs(a - b) <= rtol * max(1.0, abs(b))


CASES = [pytest.param(c, k, id=f"{a}-ps{p}-{d[-2:]}-{k}",
                      marks=() if k == 0 else pytest.mark.slow)
         for c, (a, p, d, _, _) in enumerate(CONFIGS)
         for k in range(N_PER_CONFIG // CHUNK)]


@pytest.mark.parametrize("config,chunk", CASES)
def test_fuzz_parity(config, chunk):
    # As test_fuzz_xl.py does: random shapes pile up XLA:CPU executables,
    # which past a few hundred have crashed later compiles
    # (docs/xla_cpu_executable_crash.md).
    jax.clear_caches()
    algo, presolve, dtype, tol, rtol = CONFIGS[config]
    checked = 0
    for trial, jm in enumerate(config_lps(config)):
        if trial // CHUNK != chunk:
            continue
        ref_status, ref_obj = scipy_status_obj(jm)
        if ref_status == "other":
            continue
        tm = port_model(jm)
        _configure(jm, algo, presolve, dtype, tol)
        _configure(tm, algo, presolve, dtype, tol)
        st_j, st_t = jm.optimize(), tm.optimize()
        what = (CONFIGS[config], trial, st_j.name, st_t.name,
                jm.barrier_iterations, tm.barrier_iterations)
        assert st_t.name == st_j.name, what
        if not (algo == "MPC" and st_j.name != "OPTIMAL"):
            assert abs(tm.barrier_iterations - jm.barrier_iterations) <= 1, \
                what
        if st_t.name == "OPTIMAL":
            z_t = tlt.get_attribute(tm, "ObjectiveValue")
            z_j = tlp.get_attribute(jm, "ObjectiveValue")
            assert close(z_t, z_j, rtol), (what, z_t, z_j)
            if ref_status == "optimal":
                assert close(z_t, ref_obj, rtol), (what, z_t, ref_obj)
        check_rays(tm, what)
        checked += 1
    assert checked >= CHUNK // 2, checked


def test_mpc_trajectories_without_optimum_diverge_from_rounding():
    """Trial 12 of the MPC, no-presolve, f64 battery is primal infeasible
    (HiGHS). Both packages stop PRIMAL_INFEASIBLE, the reference after 19
    iterations and the port after 12: their first iterates agree to
    rounding, and the gap grows about 100-fold an iteration as the dual
    objective runs off (3e-15 at the start, 2e-8 at iteration 3). So the
    count differs by the order of the floating-point sums (LAPACK's against
    XLA's), not by the method, and the battery does not hold it there."""
    from tulip_tpu.ipm import data as jdata
    from tulip_tpu.ipm import mpc as jmpc
    from tulip_tpu.kkt import DenseK1Backend as JDense
    from tulip_tpu_torch.ipm import data as tdata
    from tulip_tpu_torch.ipm.mpc import MPCOptions, mpc_solve
    from tulip_tpu_torch.kkt import DenseK1Backend

    config = [c[:3] for c in CONFIGS].index(("MPC", 0, "float64"))
    jm = config_lps(config)[12]
    assert scipy_status_obj(jm)[0] == "infeasible"
    pb = jm.pbdata

    def recorder(rows):
        return lambda s: rows.append(np.concatenate([
            np.asarray(getattr(s.pt, k), dtype=np.float64).ravel()
            for k in ("x", "xl", "xu", "y", "zl", "zu")]))

    want, got = [], []
    jout = jmpc.mpc_solve(jdata.lp_data_from_problem(pb)[0], JDense(),
                          jmpc.MPCOptions(), log_fn=recorder(want))
    tout = mpc_solve(tdata.lp_data_from_problem(pb, device="cpu")[0],
                     DenseK1Backend(), MPCOptions(), log_fn=recorder(got))
    assert int(np.asarray(jout.status).ravel()[0]) == \
        int(tout.status.ravel()[0])
    gaps = [np.abs(g - w).max() / np.abs(w).max()
            for g, w in zip(got, want)]
    assert gaps[0] <= 1e-13 and gaps[1] <= 1e-11 and gaps[2] <= 1e-9, gaps
    assert max(gaps) > 1e-3, gaps


def test_fuzz_mps_roundtrip():
    """``test_fuzz_xl.py``'s MPS round trip on the port: random LPs with
    every variable boxed, solved, written by the port's ``write_mps``, read
    back by its reader and solved again; the same status, the objective
    within 1e-6 of the first solve's and of HiGHS's."""
    from tulip_tpu_torch.io.mps import write_mps

    rng = np.random.default_rng(77)
    checked = 0
    for trial in range(60):
        jm = random_general_lp(rng)
        pb = jm.pbdata
        for j in range(pb.nvar):
            if not np.isfinite(pb.lvar[j]):
                pb.lvar[j] = -3.0
            if not np.isfinite(pb.uvar[j]):
                pb.uvar[j] = 3.0
        ref_status, ref_obj = scipy_status_obj(jm)
        if ref_status != "optimal":
            continue
        tm = port_model(jm)
        st1 = tm.optimize()
        z1 = tlt.get_attribute(tm, "ObjectiveValue")
        with tempfile.TemporaryDirectory() as td:
            fname = os.path.join(td, "rt.mps")
            write_mps(tm.pbdata, fname)
            tm2 = tlt.Model(device="cpu")
            tlt.load_problem(tm2, fname)
            st2 = tm2.optimize()
        assert st1.name == st2.name == "OPTIMAL", (trial, st1, st2)
        z2 = tlt.get_attribute(tm2, "ObjectiveValue")
        assert close(z2, z1, 1e-6), (trial, z1, z2)
        assert close(z1, ref_obj, 1e-6), (trial, z1, ref_obj)
        checked += 1
    assert checked >= 15, checked


def batch_problems(seed, k, shape=None):
    """``test_fuzz_xl.py``'s batch-against-sequential problems: boxed,
    feasible inequality LPs, of random shapes (m in 2..5, n in 2..8) or all
    of ``shape``."""
    rng = np.random.default_rng(seed)
    problems = []
    for _ in range(k):
        m_, n_ = shape or (int(rng.integers(2, 6)), int(rng.integers(2, 9)))
        A = rng.standard_normal((m_, n_))
        u = rng.uniform(0.5, 3.0, n_)
        x0 = u * rng.uniform(0.2, 0.8, n_)
        problems.append(dict(
            c=rng.standard_normal(n_),
            A_ub=A, b_ub=A @ x0 + rng.uniform(0.1, 1.0, m_),
            bounds=[(0.0, float(ub)) for ub in u],
        ))
    return problems


def test_fuzz_batch_vs_sequential():
    """``batch_linprog`` agrees with ``linprog`` on each instance, on the
    port: statuses equal, objectives within 1e-6."""
    from tulip_tpu_torch.linprog import batch_linprog, linprog

    problems = batch_problems(99, 24)
    batch = batch_linprog(problems, dtype="float64", device="cpu")
    for i, prob in enumerate(problems):
        seq = linprog(**prob, device="cpu")
        assert batch[i].status == seq.status, i
        if seq.success:
            assert close(batch[i].fun, seq.fun, 1e-6), (i, batch[i].fun,
                                                        seq.fun)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_lane_bits_at_two_batch_sizes(dtype):
    """A lane's result at two batch sizes, in one shape bucket (24 LPs of
    4 x 8, then the first 5 of them, then each of the first 3 alone): on
    the CPU the port's are equal bit for bit at every size; the reference's
    vmapped solve gives the same bits at 24 and 5 lanes, and at 1 lane
    agrees only to rounding (XLA compiles the batch of one apart). On the
    card the port's lanes depend on the batch's size (chip_smoke.py's phase
    12d), so that is the card's libraries, not the port's arithmetic."""
    from tulip_tpu.linprog import batch_linprog as jbatch_linprog
    from tulip_tpu_torch.linprog import batch_linprog

    problems = batch_problems(99, 24, shape=(4, 8))
    for run, kw in ((batch_linprog, {"device": "cpu"}), (jbatch_linprog, {})):
        full = run(problems, dtype=dtype, **kw)
        part = run(problems[:5], dtype=dtype, **kw)
        alone = [run([p], dtype=dtype, **kw)[0] for p in problems[:3]]
        assert all(r.status == 0 for r in full), [r.status for r in full]
        for i in range(5):
            assert np.array_equal(np.asarray(full[i].x),
                                  np.asarray(part[i].x)), (run, i)
            assert full[i].nit == part[i].nit
        for i in range(3):
            if run is batch_linprog:
                assert np.array_equal(np.asarray(full[i].x),
                                      np.asarray(alone[i].x)), i
            assert close(alone[i].fun, full[i].fun,
                         1e-6 if dtype == "float64" else 1e-3)
