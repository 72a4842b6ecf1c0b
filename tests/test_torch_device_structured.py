"""The device program (``ipm/graph.py``) on the structured and precision
backends of ``tulip_tpu_torch`` (``"banded"``, ``"sparse"``,
``"sparse-smw"``, ``"dense-ldl"``, ``"sparse-ldl"``, ``"extended"``,
``"extended-dd"``, ``"dense-mixed"``), on the CPU, where it runs its pass
step by step over the same static buffers as on the card:

(a) against the port's own host-driven loop (``HostLoop=True``), bit for
    bit: each backend under HSD, both schedules of ``"sparse"`` and
    ``"sparse-ldl"``, the dense fall-backs of ``"banded"`` and
    ``"sparse-ldl"``, sparse-first data, MPC, the bump ladder, and a
    second LP of the same shapes through the cached program;
(b) against the JAX package's ``hsd_solve_device`` on the same LP, in
    f64.

The LPs are ``tests/golden_large.py``'s staircases at m of a few hundred
(tiles of 16 rows), from numpy seeds.
"""

import dataclasses

import numpy as np
import pytest
import torch

import tulip_tpu_torch as tlt
from golden_large import staircase_lp
from test_torch_device_loop import assert_same_bits
from tulip_tpu.ipm import data as jdata
from tulip_tpu.ipm import hsd as jhsd
from tulip_tpu.kkt.dense_ldl import DenseK2Backend as JDenseLDL
from tulip_tpu.kkt.sparse import SparseK1Backend as JSparse
from tulip_tpu_torch.ipm import graph
from tulip_tpu_torch.ipm.data import make_lp_data
from tulip_tpu_torch.ipm.hsd import (HSDOptions, hsd_solve, hsd_solve_device,
                                     init_state)
from tulip_tpu_torch.ipm.mpc import MPCOptions, mpc_solve
from tulip_tpu_torch.ipm.sparse_data import (SparseLPData,
                                             sparse_lp_data_from_problem)
from tulip_tpu_torch.kkt import (BandedK1Backend, DenseK2Backend,
                                 ExtendedDDK1Backend, ExtendedK1Backend,
                                 MixedK1Backend, SparseK1Backend,
                                 SparseK2Backend, SplitK1Backend)
from tulip_tpu_torch.status import TerminationStatus

torch.set_num_threads(1)

OPT = int(TerminationStatus.OPTIMAL)


@pytest.fixture(autouse=True)
def fresh_cache():
    graph.clear_device_programs()
    yield
    graph.clear_device_programs()


def stair(m=192, seed=3, **kw):
    """A staircase of 8-row stages (12 columns each), dense A on the host
    and its LPData on the CPU."""
    A, b, c, u = staircase_lp(m, mr=8, nc=12, seed=seed, **kw)
    A = A.toarray()
    return A, make_lp_data(A, b, c, 0.0, np.zeros(len(c)), u, device="cpu")


def tight(opts, tol):
    return dataclasses.replace(opts, TolerancePFeas=tol, ToleranceDFeas=tol,
                               ToleranceRGap=tol, ToleranceIFeas=tol)


def twin(solve, dat, backend, opts):
    """The device program's final state and HostLoop=True's."""
    dev = solve(dat, backend, opts)
    assert graph.LAST["built"] and graph.LAST["passes"] == int(
        dev.niter[0]) + 1
    host = solve(dat, backend, dataclasses.replace(opts, HostLoop=True))
    return dev, host


# id: (backend from the host A, staircase keywords, HSD tolerance or None,
#      the KKT state the backend sets up)
HSD_CASES = {
    "banded": (lambda A: BandedK1Backend(min_block=16, host_A=A), {}, None,
               "SparseK1LevelState"),
    "banded-scan": (lambda A: BandedK1Backend(min_block=16, schedule="scan",
                                              host_A=A), {}, None,
                    "BandedK1State"),
    "banded-dense-fallback": (lambda A: BandedK1Backend(min_block=128,
                                                        host_A=A), {}, None,
                              "DenseK1State"),
    "sparse-level": (lambda A: SparseK1Backend(block=16, host_A=A), {}, None,
                     "SparseK1LevelState"),
    "sparse-column": (lambda A: SparseK1Backend(block=16, schedule="column",
                                                host_A=A), {}, None,
                      "SparseK1State"),
    "sparse-smw": (lambda A: SplitK1Backend(block=16, refinement_steps=2,
                                            host_A=A),
                   dict(m=256, dense_cols=2), None, "SplitK1State"),
    "dense-ldl": (lambda A: DenseK2Backend(), {}, None, "DenseK2State"),
    "sparse-ldl-column": (lambda A: SparseK2Backend(
        block=16, refinement_steps=2, host_A=A), {}, None, "SparseK2State"),
    "sparse-ldl-level": (lambda A: SparseK2Backend(
        block=16, schedule="level", refinement_steps=2, host_A=A), {}, None,
        "SparseK2LevelState"),
    "sparse-ldl-dense-fallback": (lambda A: SparseK2Backend(
        block=64, refinement_steps=2, host_A=A), dict(m=64), None,
        "DenseK2State"),
    "extended": (lambda A: ExtendedK1Backend(), {}, 1e-10, "DenseK1State"),
    "extended-dd": (lambda A: ExtendedDDK1Backend(), dict(m=16), 1e-12,
                    "DDK1State"),
    "dense-mixed": (lambda A: MixedK1Backend(), {}, None, "MixedK1State"),
}


@pytest.mark.parametrize("case", list(HSD_CASES))
def test_hsd_device_program_equals_host_loop(case):
    """HSD through each backend: the device program's CPU form (3 masked
    bumps and CorrectionLimit masked corrections a pass, the state in
    static buffers) ends in HostLoop=True's state bit for bit, OPTIMAL, on
    the backend's own KKT state (schedule or fall-back)."""
    make, kw, tol, kind = HSD_CASES[case]
    A, dat = stair(**kw)
    backend = make(A)
    assert backend.device_loop
    opts = HSDOptions() if tol is None else tight(HSDOptions(), tol)
    dev, host = twin(hsd_solve, dat, backend, opts)
    assert type(dev.kkt).__name__ == kind
    assert int(dev.status[0]) == OPT
    assert_same_bits(dev, host)


@pytest.mark.parametrize("case", ["banded", "dense-ldl", "sparse-ldl"])
def test_mpc_device_program_equals_host_loop(case):
    """MPC through a structured and a K2 backend: the device program ends
    in HostLoop=True's state bit for bit."""
    make = {"banded": lambda A: BandedK1Backend(min_block=16, host_A=A),
            "dense-ldl": lambda A: DenseK2Backend(),
            "sparse-ldl": lambda A: SparseK2Backend(
                block=16, refinement_steps=2, host_A=A)}[case]
    A, dat = stair()
    dev, host = twin(mpc_solve, dat, make(A), MPCOptions())
    assert int(dev.status[0]) == OPT
    assert_same_bits(dev, host)


def sparse_first(m=256, dense_cols=0):
    """The sparse-first data of a staircase of 16-row stages, planned at
    block 16 (no dense A anywhere)."""
    A, b, c, u = staircase_lp(m, mr=16, nc=24, dense_cols=dense_cols)
    coo = A.tocoo()
    pb = tlt.Model(device="cpu").pbdata
    pb.load(True, c, 0.0, (coo.row, coo.col, coo.data), b, b,
            np.zeros(A.shape[1]), u)
    out = sparse_lp_data_from_problem(pb, device="cpu", block=16)
    assert out is not None
    return out[0]


@pytest.mark.parametrize("name,dense_cols,kind", [
    ("sparse", 0, "SparseK1LevelState"),
    ("sparse-smw", 2, "SplitK1State")])
def test_sparse_first_data_through_the_device_program(name, dense_cols,
                                                      kind):
    """Sparse-first data (``SparseLPData``: the plan's index tensors and
    level schedule are data leaves that the state aliases) through
    ``"sparse"`` and ``"sparse-smw"``: HostLoop=True's state bit for bit,
    the data's leaves never written and handed back as the caller's."""
    dat = sparse_first(dense_cols=dense_cols)
    be = (SparseK1Backend(refinement_steps=1) if name == "sparse"
          else SplitK1Backend(refinement_steps=2))
    before = [x.clone() for x in graph.leaves(dat)]
    dev, host = twin(hsd_solve, dat, be, HSDOptions())
    assert type(dev.kkt).__name__ == kind
    assert int(dev.status[0]) == OPT
    assert_same_bits(dev, host)
    assert all(torch.equal(a, b) for a, b in zip(before, graph.leaves(dat)))
    if name == "sparse-smw":
        assert isinstance(dev.kkt.A, SparseLPData)
        assert all(a is b for a, b in zip(graph.leaves(dev.kkt.A),
                                          graph.leaves(dat)))
    else:
        assert dev.kkt.Apc is dat.Apc and dev.kkt.segs[0].cols is \
            dat.segs[0].cols


@dataclasses.dataclass(frozen=True)
class FlakySparse(SparseK1Backend):
    """The tiled backend, failing any factorization with Rd below
    ``floor``: the ladder bumps Rd x100 until it passes, or ends the solve
    at NUMERICAL_PROBLEM when ``floor`` is out of its reach."""

    floor: float = 1e-3

    def update(self, state, theta_inv, regP, regD):
        kkt, ok = super().update(state, theta_inv, regP, regD)
        return kkt, ok & (regD.amin(-1) >= self.floor)


@pytest.mark.parametrize("floor,status", [
    (1e-3, TerminationStatus.OPTIMAL),
    (1e7, TerminationStatus.NUMERICAL_PROBLEM)], ids=["bumps", "gives-up"])
def test_bump_ladder_on_a_structured_backend(floor, status):
    """The regularization ladder on the tiled level state: bumps that
    factor (the masked trips keep the bumped state) and a ladder that
    gives up after its 3 trips end in HostLoop=True's state bit for
    bit."""
    A, dat = stair()
    be = FlakySparse(block=16, host_A=A, floor=floor)
    dev, host = twin(hsd_solve, dat, be, HSDOptions())
    assert int(dev.status[0]) == int(status)
    assert_same_bits(dev, host)
    if status == TerminationStatus.OPTIMAL:
        assert float(dev.regD.min()) >= floor


@pytest.mark.parametrize("case", ["sparse-level", "sparse-ldl-column"])
def test_second_lp_of_the_same_shapes_replays_the_cached_program(case):
    """A second LP of the same pattern and shapes (other values) through
    the cached structured program builds nothing and ends in a fresh
    host-loop solve's state bit for bit."""
    make = HSD_CASES[case][0]
    A1, dat1 = stair(seed=3)
    A2, dat2 = stair(seed=4)
    be1, be2 = make(A1), make(A2)
    assert be1 == be2
    n0 = graph.CAPTURES
    hsd_solve(dat1, be1, HSDOptions())
    again = hsd_solve(dat2, be2, HSDOptions())
    assert graph.CAPTURES == n0 + 1 and not graph.LAST["built"]
    fresh = hsd_solve(dat2, be2, HSDOptions(HostLoop=True))
    assert int(again.status[0]) == OPT
    assert_same_bits(again, fresh)


@pytest.mark.parametrize("name", ["sparse", "dense-ldl"])
def test_solve_device_matches_reference(name):
    """``hsd_solve_device`` through ``"sparse"`` and ``"dense-ldl"``
    against the JAX package's (one ``lax.while_loop`` from the same eager
    initial state), f64: status and iterations equal, objectives within
    1e-10·max(1, |f|)."""
    A, b, c, u = staircase_lp(192, mr=8, nc=12, seed=3)
    A = A.toarray()
    l = np.zeros(len(c))
    jdat = jdata.make_lp_data(A, b, c, 0.0, l, u)
    tdat = make_lp_data(A, b, c, 0.0, l, u, device="cpu")
    if name == "sparse":
        jbe, tbe = JSparse(block=16), SparseK1Backend(block=16, host_A=A)
    else:
        jbe, tbe = JDenseLDL(), DenseK2Backend()
    jopts = jhsd.HSDOptions()
    want = jhsd.hsd_solve_device(jbe, jopts, jdat,
                                 jhsd.init_state(jdat, jbe, mehrotra=False))
    got = hsd_solve_device(tbe, HSDOptions(), tdat,
                           init_state(tdat, tbe, mehrotra=False))
    assert graph.LAST["built"]
    assert int(got.status[0]) == int(want.status) == OPT
    assert int(got.niter[0]) == int(want.niter)
    for f in ("pobj", "dobj"):
        w, g = float(getattr(want, f)), float(getattr(got, f)[0])
        assert abs(g - w) <= 1e-10 * max(1.0, abs(w)), (f, g, w)


def test_cache_key_fixes_the_plan_but_not_its_values():
    """The program's key (``graph.signature``) holds what a pass's launch
    sequence depends on: the number of elimination levels and each
    level's sizes, and the state's type (a fall-back's state differs from
    the level state); index values of equal shapes are inputs, copied into
    the static buffers, and leave the key as it is."""
    A, dat = stair()
    st = SparseK1Backend(block=16, host_A=A).setup_data(dat)
    key = graph.signature(dat, st)
    seg = st.segs[0]
    moved = st._replace(segs=(seg._replace(cols=seg.cols.flip(0)),)
                        + st.segs[1:])
    assert graph.signature(dat, moved) == key
    assert graph.signature(dat, st._replace(segs=st.segs[:-1])) != key
    grown = st._replace(segs=(seg._replace(cols=torch.cat(
        [seg.cols, seg.cols[:1]])),) + st.segs[1:])
    assert graph.signature(dat, grown) != key
    dense = SparseK1Backend(block=16, host_A=A)._dense().setup(dat.A)
    assert graph.signature(dat, dense) != key
