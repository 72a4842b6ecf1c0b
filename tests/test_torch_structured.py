"""Port parity of the structured route on the CPU: HSD through the
``"banded"`` and ``"sparse"`` backends against the JAX package's, the
structure probe's routing and its cache, and ``Model.optimize()`` at its
defaults on an m = 2048 staircase, from the same LPs (numpy seeds)."""

import numpy as np
import pytest
import torch

import tulip_tpu  # noqa: F401
import tulip_tpu.model as jmodel
import tulip_tpu_torch as tlt
from golden_large import scattered_coupling_lp, staircase_lp
from tulip_tpu.ipm.data import make_lp_data as jmake
from tulip_tpu.ipm.hsd import HSDOptions as JOptions
from tulip_tpu.ipm.hsd import hsd_solve as jsolve
from tulip_tpu.kkt.banded import BandedK1Backend as JBanded
from tulip_tpu.kkt.sparse import SparseK1Backend as JSparse
from tulip_tpu_torch import model as tmodel
from tulip_tpu_torch.ipm.data import make_lp_data, standard_form_arrays
from tulip_tpu_torch.ipm.hsd import HSDOptions, hsd_solve
from tulip_tpu_torch.kkt import BandedK1Backend, SparseK1Backend
from tulip_tpu_torch.status import TerminationStatus

torch.set_num_threads(1)


def highs(A, b, c, u):
    """HiGHS's optimum (its interior-point method: the dual simplex takes
    tens of seconds at m = 2048 on a CPU)."""
    from scipy.optimize import linprog

    r = linprog(c, A_eq=A, b_eq=b, method="highs-ipm",
                bounds=np.column_stack([np.zeros(A.shape[1]), u]))
    assert r.status == 0, r.message
    return float(r.fun)


def small_lp(cyclic, seed=3):
    """A 24-stage staircase LP (m = 192), dense, with an interior x0."""
    A, b, c, u = staircase_lp(192, mr=8, nc=12, cyclic=cyclic, seed=seed)
    return A.toarray(), b, c, u


@pytest.mark.parametrize("cyclic", [False, True], ids=["staircase",
                                                        "cyclic"])
@pytest.mark.parametrize("name", ["sparse", "banded"])
def test_hsd_through_structured_backend_matches_jax(name, cyclic):
    """The reference's status, iterations within ±1, the objective within
    1e-8 relative of the reference's and 1e-7 of HiGHS."""
    A, b, c, u = small_lp(cyclic)
    l = np.zeros(len(c))
    if name == "sparse":
        jbe, tbe = JSparse(block=16), SparseK1Backend(block=16)
    else:
        jbe, tbe = JBanded(min_block=16), BandedK1Backend(min_block=16)
    want = jsolve(jmake(A, b, c, 0.0, l, u), jbe, JOptions())
    got = hsd_solve(make_lp_data(A, b, c, 0.0, l, u, device="cpu"), tbe,
                    HSDOptions())
    assert int(got.status[0]) == int(want.status) == \
        int(TerminationStatus.OPTIMAL)
    assert abs(int(got.niter[0]) - int(want.niter)) <= 1
    z_j, z_t = float(want.pobj), float(got.pobj[0])
    assert abs(z_t - z_j) <= 1e-8 * max(1.0, abs(z_j))
    z_h = highs(A, b, c, u)
    assert abs(z_t - z_h) <= 1e-7 * max(1.0, abs(z_h))
    # The plan rode through the IPM's per-lane selects untouched.
    st = tbe.setup(torch.as_tensor(A)[None])
    assert type(got.kkt) is type(st)


def load(lp):
    """A port Model holding an equality-form LP (presolve keeps it)."""
    A, b, c, u = lp
    coo = A.tocoo()
    mod = tlt.Model(device="cpu")
    mod.pbdata.load(True, c, 0.0, (coo.row, coo.col, coo.data), b, b,
                    np.zeros(A.shape[1]), u)
    return mod


PROBED = {
    "staircase": (lambda: staircase_lp(2048), "banded"),
    "scattered": (lambda: scattered_coupling_lp(2048), "sparse"),
    "one-dense-column": (lambda: staircase_lp(2048, dense_cols=1),
                         "sparse-smw"),
    "many-dense-columns": (lambda: staircase_lp(2048, dense_cols=12,
                                                dense_scale=1.0),
                           "sparse-ldl"),
}


@pytest.mark.parametrize("which", sorted(PROBED))
def test_route_follows_the_reference_probe(which):
    """``Model._route`` at m = 2048 with no backend named takes the
    backend that the reference's ``_probe_structure`` returns on the same
    A, with the reference's refinement sweeps, "sparse-ldl" included
    (item 8c, which raised before it was ported)."""
    gen, want = PROBED[which]
    mod = load(gen())
    A_host = standard_form_arrays(mod.pbdata)[0]
    assert jmodel._probe_structure(A_host) == want
    dtype = np.dtype(np.float64)
    backend, _ = mod._route(mod.pbdata, dtype, A_host)
    assert backend.name == want
    assert backend.refinement_steps == (2 if want in ("sparse-smw",
                                                      "sparse-ldl") else 0)
    assert backend.host_A is A_host


def test_probe_is_cached_across_resolves(monkeypatch):
    """An objective-only edit re-optimises without probing again; a change
    to the pattern probes again (the reference's cache,
    tulip_tpu/model.py:186-206)."""
    calls = []
    real = tmodel._probe_structure
    monkeypatch.setattr(tmodel, "_probe_structure",
                        lambda A: calls.append(1) or real(A))
    mod = load(staircase_lp(2048))
    mod.params.IPM.IterationsLimit = 1
    assert mod.optimize() == TerminationStatus.ITERATION_LIMIT
    assert mod.kkt_backend.name == "banded" and len(calls) == 1
    tlt.set_attribute(mod, "VariableObjectiveCoeff", 2.0, index=0)
    mod.optimize()
    assert len(calls) == 1
    mod.pbdata.add_variable([0], [1.0], 0.5, 0.0, 1.0)
    mod.optimize()
    assert len(calls) == 2
    mod.empty()
    assert mod._probe_cache is None


def test_model_defaults_solve_a_2048_row_staircase_through_banded():
    """``Model.optimize()`` at its defaults (f64, HSD, presolve) on an
    m = 2048 staircase: the probe picks "banded", which runs its level
    engine, OPTIMAL at HiGHS's objective."""
    lp = staircase_lp(2048)
    mod = load(lp)
    assert mod.optimize() == TerminationStatus.OPTIMAL
    assert mod.kkt_backend.name == "banded"
    assert type(mod.solver_state.kkt).__name__ == "SparseK1LevelState"
    z = tlt.get_attribute(mod, "ObjectiveValue")
    z_h = highs(*lp)
    assert abs(z - z_h) <= 1e-7 * max(1.0, abs(z_h))
