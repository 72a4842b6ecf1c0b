"""End-to-end parity of the Krylov backends (``tulip_tpu_torch/kkt/
krylov.py``) on the CPU: tests/test_krylov_golden.py's battery through the
port's ``Model`` beside the JAX package's, in the same test; the CLI's
``--KKTBackend cg``; and ``batched_hsd_solve`` with ``CgK1Backend``
against the reference's vmapped batch."""

import importlib.util
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tulip_tpu as tlp
import tulip_tpu.cli as jcli
import tulip_tpu_torch as tlt
from golden_lps import ALL_GOLDEN, scipy_optimum
from test_krylov_golden import KRYLOV_CASES
from test_torch_cli import parse
from test_torch_hsd import jax_batch, random_lps
from tulip_tpu.ipm import batch as jbatch
from tulip_tpu.ipm import hsd as jhsd
from tulip_tpu.kkt import CgK1Backend as JCg
from tulip_tpu_torch import cli
from tulip_tpu_torch.ipm.batch import batched_hsd_solve, stack_lps_host
from tulip_tpu_torch.ipm.hsd import HSDOptions
from tulip_tpu_torch.kkt import CgK1Backend
from tulip_tpu_torch.status import TerminationStatus

torch.set_num_threads(1)

DATA = Path(__file__).resolve().parent / "data"


def solve_both(pb, backend, tol):
    """The JAX package's Model and the port's (on the CPU) on ``pb``
    through ``backend`` at IPM tolerance ``tol`` (None: the defaults):
    [(status, iterations, objective)] for each."""
    I, J, V = pb.to_coo()
    out = []
    for pkg, kw in ((tlp, {}), (tlt, {"device": "cpu"})):
        m = pkg.Model(**kw)
        m.pbdata.load(pb.objsense, pb.obj, pb.obj0, (I, J, V), pb.lcon,
                      pb.ucon, pb.lvar, pb.uvar, name=pb.name)
        m.params.KKT.Backend = backend
        if tol is not None:
            for f in ("TolerancePFeas", "ToleranceDFeas",
                      "ToleranceRGap", "ToleranceIFeas"):
                setattr(m.params.IPM, f, tol)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            st = m.optimize()
        z = (pkg.get_attribute(m, "ObjectiveValue")
             if st == TerminationStatus.OPTIMAL else None)
        out.append((st.name, m.barrier_iterations, z, m))
    return out


def check_case(gen, backend, tol, rtol):
    pb = gen()
    z_ref = scipy_optimum(pb)
    (st_j, it_j, z_j, _), (st_t, it_t, z_t, mod) = solve_both(pb, backend,
                                                            tol)
    assert st_t == st_j == "OPTIMAL", (st_t, st_j)
    assert mod.kkt_backend.name == backend
    assert mod.kkt_backend.refinement_steps == 0
    assert type(mod.solver_state.kkt).__name__ == "KrylovState"
    assert abs(it_t - it_j) <= 1, (it_t, it_j)
    assert abs(z_t - z_ref) <= rtol * max(1.0, abs(z_ref)), (z_t, z_ref)


@pytest.mark.parametrize("backend,tol,rtol", KRYLOV_CASES,
                         ids=[c[0] for c in KRYLOV_CASES])
def test_krylov_backend_end_to_end(backend, tol, rtol):
    """The transportation LP (presolve on, f64): the reference's status,
    its IPM iterations within ±1, the objective within the case's rtol of
    HiGHS."""
    check_case(ALL_GOLDEN[0], backend, tol, rtol)


@pytest.mark.slow
@pytest.mark.parametrize("backend,tol,rtol", KRYLOV_CASES,
                         ids=[c[0] for c in KRYLOV_CASES])
def test_krylov_backend_second_golden(backend, tol, rtol):
    """The multiperiod chain, tests/test_krylov_golden.py's second
    battery."""
    check_case(ALL_GOLDEN[8], backend, tol, rtol)


def chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_statuses_are_the_references():
    """The statuses that chip_smoke.py's phase 11a holds each backend to
    are the JAX package's on the CPU, with its iteration limit for
    minares; the experimental tricg and minares solved by the reference
    alone (the port's minares spends ~30 s on the CPU in 100
    iterations)."""
    smoke = chip_smoke()
    table = smoke.KRYLOV_STATUS
    assert sorted(table) == sorted(
        n for n, c in tlp.kkt.available_backends().items()
        if c.__module__ == "tulip_tpu.kkt.krylov")
    for name, tol, _ in KRYLOV_CASES:
        assert table[name] == "OPTIMAL", name
    pb = ALL_GOLDEN[0]()
    I, J, V = pb.to_coo()
    for name in ("tricg", "minares"):
        m = tlp.Model()
        m.pbdata.load(pb.objsense, pb.obj, pb.obj0, (I, J, V), pb.lcon,
                      pb.ucon, pb.lvar, pb.uvar, name=pb.name)
        m.params.KKT.Backend = name
        if name == "minares":
            m.params.IPM.IterationsLimit = smoke.MINARES_ITERATIONS
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            assert m.optimize().name == table[name], name


def test_cli_krylov_backend_matches_jax(monkeypatch, capsys):
    monkeypatch.setattr(jcli, "_enable_compile_cache", lambda: None)
    argv = ["--KKTBackend", "cg", "--OutputLevel", "1",
            str(DATA / "lp_opt.mps")]
    assert jcli.main(argv) == 0
    rows_j, st_j, z_j = parse(capsys.readouterr().out)
    assert cli.main(argv, device="cpu") == 0
    rows_t, st_t, z_t = parse(capsys.readouterr().out)
    assert st_t == st_j == "OPTIMAL"
    assert len(rows_t) == len(rows_j)
    assert abs(z_t - z_j) <= 1e-9 and abs(z_t - 1.5) <= 1e-6


def test_linprog_through_a_krylov_backend():
    """``linprog`` with ``KKT.Backend = "lsmr"`` gives HiGHS's optimum."""
    from scipy.optimize import linprog as highs

    rng = np.random.default_rng(5)
    A = rng.standard_normal((6, 14))
    x0 = rng.uniform(0.2, 0.8, 14)
    c = rng.standard_normal(14)
    params = tlt.Parameters()
    params.KKT.Backend = "lsmr"
    res = tlt.linprog(c, A_eq=A, b_eq=A @ x0, bounds=[(0, 1)] * 14,
                      params=params, device="cpu")
    ref = highs(c, A_eq=A, b_eq=A @ x0, bounds=[(0, 1)] * 14,
                method="highs")
    assert res.status == 0
    assert abs(res.fun - ref.fun) <= 1e-7 * max(1.0, abs(ref.fun))


def test_batched_cg_matches_jax():
    """Three LPs through ``CgK1Backend`` in one batch: the statuses of the
    reference's vmapped batch, iterations within ±1, objectives within
    1e-8."""
    raws = random_lps(17, B=3)
    want = jbatch.batched_hsd_solve(JCg(), jhsd.HSDOptions(),
                                    jax_batch(raws, jnp.float64))
    got = batched_hsd_solve(CgK1Backend(), HSDOptions(),
                            stack_lps_host(raws, device="cpu",
                                           dtype=torch.float64))
    np.testing.assert_array_equal(got.status.numpy(),
                                  np.asarray(want.status))
    assert (got.status.numpy() == int(TerminationStatus.OPTIMAL)).all()
    assert np.abs(got.niter.numpy() - np.asarray(want.niter)).max() <= 1
    np.testing.assert_allclose(got.pobj.numpy(), np.asarray(want.pobj),
                               rtol=1e-8, atol=0)
