"""Port parity: ``tulip_tpu_torch.Model`` and ``linprog`` against the JAX
package's, from the same problems (``tests/golden_lps.py``, numpy seeds),
on the CPU; and the routes this package does not port yet."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import tulip_tpu as tlp
import tulip_tpu_torch as tlt
from golden_lps import ALL_GOLDEN
from test_torch_linprog import mixed_forms, presolve_paths
from tulip_tpu_torch import model as tmodel
from tulip_tpu_torch.status import TerminationStatus

torch.set_num_threads(1)

DATA = Path(__file__).resolve().parent / "data"


def load_both(pb, **params):
    """The same problem in a JAX Model and a port Model (on the CPU),
    bulk-loaded from one COO export, with ``params`` set on both
    ("IPM_TimeLimit"-style names)."""
    I, J, V = pb.to_coo()
    out = []
    for pkg, kw in ((tlp, {}), (tlt, {"device": "cpu"})):
        m = pkg.Model(**kw)
        m.pbdata.load(pb.objsense, pb.obj, pb.obj0, (I, J, V), pb.lcon,
                      pb.ucon, pb.lvar, pb.uvar, name=pb.name)
        for k, v in params.items():
            pkg.set_parameter(m, k, v)
        out.append(m)
    return out


@pytest.mark.parametrize("presolve", [1, 0], ids=["presolve", "no-presolve"])
@pytest.mark.parametrize("gen", ALL_GOLDEN, ids=lambda g: g.__name__)
def test_model_matches_jax_f64(gen, presolve):
    jm, tm = load_both(gen(), Presolve_Level=presolve)
    st_j, st_t = jm.optimize(), tm.optimize()
    assert st_t == st_j == TerminationStatus.OPTIMAL
    assert tm.barrier_iterations == jm.barrier_iterations
    assert tm.kkt_backend.name == jm.kkt_backend.name == "dense"
    # f64 on both sides: the iterates differ by summation order only.
    z_j = tlp.get_attribute(jm, "ObjectiveValue")
    z_t = tlt.get_attribute(tm, "ObjectiveValue")
    assert abs(z_t - z_j) <= 1e-9 * max(1.0, abs(z_j))
    assert set(tm.timings) == set(jm.timings)
    np.testing.assert_allclose(tm.solution.x, jm.solution.x, rtol=0,
                               atol=1e-7 * max(1.0, np.abs(jm.solution.x)
                                               .max()))


def test_model_dense_pallas_f32_matches_jax():
    jm, tm = load_both(ALL_GOLDEN[0](), ArithmeticDtype="float32",
                       KKT_Backend="dense-pallas")
    st_j, st_t = jm.optimize(), tm.optimize()
    assert st_t == st_j == TerminationStatus.OPTIMAL
    assert tm.kkt_backend.name == "dense-pallas"
    assert tm.kkt_backend.refinement_steps == 0
    assert tm.solver_state.pt.x.dtype == torch.float32
    # f32 at its default tolerance sqrt(eps) ~ 3.45e-4; the port forms K
    # with d on one side, the reference (off the TPU) with √d on both.
    z_j = tlp.get_attribute(jm, "ObjectiveValue")
    z_t = tlt.get_attribute(tm, "ObjectiveValue")
    assert abs(z_t - z_j) <= 1e-4 * max(1.0, abs(z_j))


def test_model_f32_default_on_cpu_is_dense():
    """Off the accelerator the f32 default stays "dense", as the
    reference's does off the TPU."""
    jm, tm = load_both(ALL_GOLDEN[1](), ArithmeticDtype="float32")
    assert jm.optimize() == tm.optimize() == TerminationStatus.OPTIMAL
    assert tm.kkt_backend.name == jm.kkt_backend.name == "dense"
    assert tm.barrier_iterations == jm.barrier_iterations


def test_time_limit_zero_stops_after_one_iteration():
    jm, tm = load_both(ALL_GOLDEN[0](), IPM_TimeLimit=0.0)
    assert jm.optimize() == tm.optimize() == TerminationStatus.TIME_LIMIT
    assert tm.barrier_iterations == jm.barrier_iterations == 1


def test_output_level_log_matches_jax(capsys):
    jm, tm = load_both(ALL_GOLDEN[2](), OutputLevel=1)
    jm.optimize()
    out_j = capsys.readouterr().out
    tm.optimize()
    out_t = capsys.readouterr().out

    def table(out):
        # Every line but the iteration rows' wall-clock column.
        return [line.rsplit(None, 1)[0] if line[:4].strip().isdigit()
                else line for line in out.splitlines()]

    assert table(out_t) == table(out_j)


def small_staircase(m, seed=0):
    """A pure staircase LP with m equality rows that presolve keeps."""
    from golden_large import staircase_lp

    A, b, c, u = staircase_lp(m, seed=seed)
    coo = A.tocoo()
    pb = tlt.ProblemData()
    pb.load(True, c, 0.0, (coo.row, coo.col, coo.data), b, b,
            np.zeros(A.shape[1]), u)
    return pb


@pytest.mark.parametrize("params", [
    {"KKT_Backend": "schur"},
], ids=["schur"])
def test_unported_routes_raise_before_device_work(params):
    """device="cuda" on a machine without CUDA: reaching any device work
    would raise something else than NotImplementedError."""
    m = tlt.Model(device="cuda")
    m.pbdata = tlt.read_mps(str(DATA / "lp_freevars.mps"))
    m.params.Presolve.Level = 0
    for k, v in params.items():
        tlt.set_parameter(m, k, v)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        m.optimize()


@pytest.mark.parametrize("params,backend", [
    ({"KKT_SparseFirst": True}, "dense"),
    ({"KKT_System": "K2"}, "dense-ldl"),
    ({"IPM_TolerancePFeas": 1e-10, "IPM_ToleranceDFeas": 1e-10,
      "IPM_ToleranceRGap": 1e-10, "IPM_ToleranceIFeas": 1e-10},
     "extended"),
    ({"KKT_System": "K2", "KKT_Backend": "sparse-ldl"}, "sparse-ldl"),
    ({"KKT_Backend": "cg"}, "cg"),
], ids=["sparse-first", "K2", "extended", "unported-backend", "cg"])
def test_ported_routes_solve(params, backend):
    """The sparse-first path (item 8b), System="K2" below m = 2048
    (item 7), tolerances below 1e-9 in f64 (item 6), a named
    "sparse-ldl" (item 8c; here it falls back to "dense-ldl"'s state, the
    file being too small to tile) and a named Krylov backend (item 9;
    it raised before) solve the file on the CPU; sparse-first falls back
    to the dense data on a file this small, as the reference does."""
    m = tlt.Model(device="cpu")
    m.pbdata = tlt.read_mps(str(DATA / "lp_freevars.mps"))
    m.params.Presolve.Level = 0
    for k, v in params.items():
        tlt.set_parameter(m, k, v)
    assert m.optimize() == TerminationStatus.OPTIMAL
    assert m.kkt_backend.name == backend


def small_staircase_dense_cols(m, k):
    """small_staircase with ``k`` dense linking columns."""
    from golden_large import staircase_lp

    A, b, c, u = staircase_lp(m, dense_cols=k, dense_scale=1.0)
    coo = A.tocoo()
    pb = tlt.ProblemData()
    pb.load(True, c, 0.0, (coo.row, coo.col, coo.data), b, b,
            np.zeros(A.shape[1]), u)
    return pb


def test_structure_probe_route_raises():
    """At m = 2048 with no backend named the probe routes a staircase to
    "banded", one with a dense column to "sparse-smw" (item 8b) and one
    with many dense columns to "sparse-ldl" (item 8c, ported since: it
    raised before)."""
    for k, name in [(0, "banded"), (1, "sparse-smw"), (12, "sparse-ldl")]:
        m = tlt.Model(device="cpu")
        m.pbdata = (small_staircase_dense_cols(2048, k) if k
                    else small_staircase(2048))
        m.params.IPM.IterationsLimit = 0
        assert m.optimize() == TerminationStatus.ITERATION_LIMIT
        assert m.kkt_backend.name == name
    # Naming a backend takes it instead of the probe.
    m.params.KKT.Backend = "dense"
    assert m.optimize() == TerminationStatus.ITERATION_LIMIT
    assert m.kkt_backend.name == "dense"


@pytest.mark.parametrize("exc,status", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory"),
     TerminationStatus.MEMORY_LIMIT),
    (MemoryError(), TerminationStatus.MEMORY_LIMIT),
    (KeyboardInterrupt(), TerminationStatus.UNKNOWN),
], ids=["cuda-oom", "host-oom", "interrupt"])
def test_ipm_failures_map_to_statuses(monkeypatch, exc, status):
    def boom(*a, **k):
        raise exc

    monkeypatch.setattr(tmodel, "hsd_solve", boom)
    m = tlt.Model(device="cpu")
    m.pbdata = tlt.read_mps(str(DATA / "lp_opt.mps"))
    assert m.optimize() == status


def test_profile_dir_writes_a_chrome_trace(tmp_path):
    m = tlt.Model(device="cpu")
    m.pbdata = tlt.read_mps(str(DATA / "lp_opt.mps"))
    m.params.ProfileDir = str(tmp_path)
    assert m.optimize() == TerminationStatus.OPTIMAL
    trace = json.loads((tmp_path / "ipm_trace.json").read_text())
    assert trace["traceEvents"]


def test_empty_resets_the_model():
    m = tlt.Model(device="cpu")
    tlt.load_problem(m, str(DATA / "lp_opt.mps"))
    m.optimize()
    m.empty()
    assert (m.status, m.solution, m.pbdata.nvar) == (
        TerminationStatus.NOT_CALLED, None, 0)


@pytest.mark.parametrize("k", range(7))
def test_linprog_matches_jax(k):
    prob = (mixed_forms() + presolve_paths())[k]
    want = tlp.linprog(**prob)
    got = tlt.linprog(**prob, device="cpu")
    assert (got.status, got.termination, got.nit) == \
        (want.status, want.termination, want.nit), got.message
    if want.success:
        assert abs(got.fun - want.fun) <= 1e-9 * max(1.0, abs(want.fun))
        np.testing.assert_allclose(got.x, want.x, rtol=0, atol=1e-7)
