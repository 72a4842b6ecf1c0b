"""The device program of ``tulip_tpu_torch`` (``ipm/graph.py``,
``hsd_solve_device``, ``mpc_solve_device`` and the batched entries that
route to it) on the CPU, where it runs its pass step by step over the same
static buffers as on the card:

(a) against the JAX package's ``hsd_solve_device`` / ``mpc_solve_device``
    and its vmapped batched while-loops, in f64;
(b) against the port's own host-driven loop (``HostLoop=True``), bit for
    bit, at every count of passes between host reads from 1 to 5;
(c) the routing of :func:`tulip_tpu_torch.ipm.hsd.solve`;
(d) the cache of programs.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_hsd import Flaky, jax_batch, random_lps
from tulip_tpu.io.mps import read_mps
from tulip_tpu.ipm import batch as jbatch
from tulip_tpu.ipm import data as jdata
from tulip_tpu.ipm import hsd as jhsd
from tulip_tpu.ipm import mpc as jmpc
from tulip_tpu.kkt import DenseK1Backend as JDense
from tulip_tpu_torch.ipm import data as tdata
from tulip_tpu_torch.ipm import graph
from tulip_tpu_torch.ipm.batch import (batched_hsd_resolve, batched_hsd_solve,
                                       batched_mpc_solve, stack_lps_host)
from tulip_tpu_torch.ipm.hsd import (HSDOptions, hsd_solve, hsd_solve_device,
                                     init_state)
from tulip_tpu_torch.ipm.mpc import MPCOptions, mpc_solve, mpc_solve_device
from tulip_tpu_torch.kkt import (DenseK1Backend, GramK1Backend,
                                 SmallK1Backend)
from tulip_tpu_torch.status import TerminationStatus

torch.set_num_threads(1)

DATA = Path(__file__).resolve().parent / "data"
OPT = int(TerminationStatus.OPTIMAL)


def mixed_lps(seed):
    """8 LPs padded to one shape (6 x 12): 6 random feasible and bounded
    ones, then the infeasible and the unbounded instance of
    tests/test_batch.py:97-115 (2 x 2), whose trajectories the two
    packages share under HSD and MPC alike. (An infeasible LP that MPC's
    weak tests leave running for ~80 iterations parts the two packages'
    iteration counts by summation order alone.)"""
    return random_lps(seed, B=6) + [
        ([[1, 1], [1, -1]], [1, 3], [1, 1], 0.0, [0, 0], [1, 1]),
        ([[1, -1], [0, 0]], [1, 0], [-1, -1], 0.0, [0, 0],
         [np.inf, np.inf])]


def assert_same_bits(a, b, path="state"):
    """Two trees of tensors equal bit for bit (NaN at the same places)."""
    if isinstance(a, tuple):
        assert type(a) is type(b), path
        for f, x, y in zip(getattr(a, "_fields", range(len(a))), a, b):
            assert_same_bits(x, y, f"{path}.{f}")
        return
    if not torch.is_tensor(a):
        assert a == b, path
        return
    assert a.dtype == b.dtype and a.shape == b.shape, path
    if a.is_floating_point():
        a = a.view({8: torch.int64, 4: torch.int32}[a.element_size()])
        b = b.view({8: torch.int64, 4: torch.int32}[b.element_size()])
    assert torch.equal(a, b), path


def assert_objectives_close(got, want):
    """pobj and dobj within 1e-10·max(1, |f|); a lane whose objective has
    run off along a ray (|f| ≥ 1e6: an infeasibility certificate's
    iterate, 3.5e8 for MPC's infeasible lane here) within 1e-9·|f|, the
    summation order of the two packages magnified along the ray."""
    for f in ("pobj", "dobj"):
        g = got[f]
        w = np.asarray(want[f], dtype=np.float64).reshape(g.shape)
        scale = np.maximum(1.0, np.abs(w))
        tol = np.where(scale >= 1e6, 1e-9, 1e-10) * scale
        finite = np.isfinite(w)
        assert np.array_equal(np.isfinite(g), finite), f
        assert (np.abs(g - w)[finite] <= tol[finite]).all(), (f, g, w)


def fields(state):
    return {"status": state.status.numpy(), "niter": state.niter.numpy(),
            "pobj": state.pobj.numpy(), "dobj": state.dobj.numpy()}


def jfields(state):
    return {f: np.asarray(getattr(state, f)).reshape(-1)
            for f in ("status", "niter", "pobj", "dobj")}


@pytest.fixture(autouse=True)
def fresh_cache():
    graph.clear_device_programs()
    yield
    graph.clear_device_programs()


# ---------------------------------------------------------------------------
# (a) against the reference's device programs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algo", ["HSD", "MPC"])
def test_solve_device_matches_reference_on_mps(algo):
    """``hsd_solve_device`` / ``mpc_solve_device`` on tests/data/lp_opt.mps
    against the JAX package's (one ``lax.while_loop``), f64: statuses and
    iteration counts equal, objectives within 1e-10·max(1, |f|)."""
    pb = read_mps(str(DATA / "lp_opt.mps"))
    jdat = jdata.lp_data_from_problem(pb)[0]
    tdat = tdata.lp_data_from_problem(pb, device="cpu")[0]
    if algo == "HSD":
        want = jhsd.hsd_solve_device(JDense(), jhsd.HSDOptions(), jdat)
        got = hsd_solve_device(DenseK1Backend(), HSDOptions(), tdat)
    else:
        want = jmpc.mpc_solve_device(JDense(), jmpc.MPCOptions(), jdat)
        got = mpc_solve_device(DenseK1Backend(), MPCOptions(), tdat)
    g, w = fields(got), jfields(want)
    assert g["status"].tolist() == w["status"].tolist() == [OPT]
    np.testing.assert_array_equal(g["niter"], w["niter"])
    assert_objectives_close(g, w)
    assert graph.LAST["built"] and graph.LAST["passes"] == g["niter"][0] + 1


@pytest.mark.parametrize("limit", [100, 3], ids=["defaults", "limit-3"])
@pytest.mark.parametrize("algo", ["HSD", "MPC"])
def test_batched_device_program_matches_reference(algo, limit):
    """A seeded batch of 8 LPs with an infeasible and an unbounded lane
    through the port's batched solve (the device program) and the
    reference's vmapped while-loop (``_solve_one``, ``_solve_one_mpc``), in
    f64, at the defaults and at IterationsLimit = 3 (lanes end at
    ITERATION_LIMIT): statuses and iteration counts equal, objectives
    within 1e-10·max(1, |f|)."""
    raws = mixed_lps(31)
    jd = jax_batch(raws, jnp.float64)
    td = stack_lps_host(raws, device="cpu", dtype=torch.float64)
    if algo == "HSD":
        want = jbatch.batched_hsd_solve(
            JDense(), jhsd.HSDOptions(IterationsLimit=limit), jd)
        got = batched_hsd_solve(DenseK1Backend(),
                                HSDOptions(IterationsLimit=limit), td)
    else:
        want = jbatch.batched_mpc_solve(
            JDense(), jmpc.MPCOptions(IterationsLimit=limit), jd)
        got = batched_mpc_solve(DenseK1Backend(),
                                MPCOptions(IterationsLimit=limit), td)
    assert graph.LAST["built"]
    g, w = fields(got), jfields(want)
    np.testing.assert_array_equal(g["status"], w["status"])
    np.testing.assert_array_equal(g["niter"], w["niter"])
    assert_objectives_close(g, w)
    st = g["status"].tolist()
    if limit == 3:
        assert st.count(int(TerminationStatus.ITERATION_LIMIT)) >= 6
    else:
        assert st[:6] == [OPT] * 6 and len(set(st[6:]) - {OPT}) == 2


# ---------------------------------------------------------------------------
# (b) against the port's host-driven loop, bit for bit
# ---------------------------------------------------------------------------

def _hsd(opts, td, backend):
    return batched_hsd_solve(backend, opts, td)


def _mpc(opts, td, backend):
    return batched_mpc_solve(backend, MPCOptions(HostLoop=opts.HostLoop),
                             td)


def _warm(opts, td, backend):
    prev = batched_hsd_solve(backend, HSDOptions(HostLoop=True), td)
    b = td.b * (1.0 + 0.01 * torch.linspace(-1.0, 1.0, td.b.shape[-1],
                                            dtype=td.b.dtype))
    return batched_hsd_resolve(backend, opts, td._replace(b=b), prev)


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("run,backend,dtype", [
    (_hsd, DenseK1Backend(), torch.float64),
    (_mpc, DenseK1Backend(inv_factor=True, refinement_steps=1),
     torch.float64),
    (_warm, SmallK1Backend(refinement_steps=1), torch.float32),
], ids=["hsd", "mpc", "warm-resolve"])
def test_device_program_equals_host_loop(run, backend, dtype, k,
                                         monkeypatch):
    """The device program's CPU form (its pass step by step over static
    buffers, 3 masked bumps and CorrectionLimit masked corrections a pass)
    ends in the host-driven loop's state bit for bit, reading whether a
    lane still runs every k passes: passes after the last lane finished
    change nothing. Host reads stay within ceil((max niter + 1) / k) + 2."""
    monkeypatch.setattr(graph, "K_PASSES", k)
    td = stack_lps_host(mixed_lps(7), device="cpu", dtype=dtype)
    host = run(HSDOptions(HostLoop=True), td, backend)
    dev = run(HSDOptions(), td, backend)
    assert graph.LAST["passes"] % k == 0
    assert graph.LAST["syncs"] <= -(-(int(dev.niter.max()) + 1) // k) + 2
    assert graph.LAST["passes"] >= int(dev.niter.max()) + 1
    assert_same_bits(dev, host)


def test_bump_ladder_through_the_device_program():
    """Lanes forced through the regularization ladder (the non-SPD K of
    tests/test_torch_hsd.py:test_bump_ladder_is_per_lane: lane 1 factors
    after one x100 bump, lane 2 never and ends NUMERICAL_PROBLEM) solve
    to the host loop's state bit for bit."""
    raws = random_lps(13, B=3)
    for lane, a00 in enumerate([0.01, 5.0, 1e9]):
        raws[lane][0][0, 0] = a00
    td = stack_lps_host(raws, device="cpu", dtype=torch.float64)
    dev = batched_hsd_solve(Flaky(), HSDOptions(), td)
    host = batched_hsd_solve(Flaky(), HSDOptions(HostLoop=True), td)
    assert graph.LAST["built"]
    assert int(dev.status[2]) == int(TerminationStatus.NUMERICAL_PROBLEM)
    assert int(dev.niter[2]) == 0
    assert_same_bits(dev, host)


def test_bounded_while_runs_its_bound_on_the_device():
    """The host-driven loop stops at the first trip no lane needs; the
    device program runs every trip, and a trip that no lane needs changes
    no lane."""
    trips = []

    def body(c, mask):
        trips.append(mask.clone())
        return torch.where(mask, c + 1, c)

    cond = lambda c: c < torch.tensor([0, 2, 1])  # noqa: E731
    eager = graph.bounded_while(cond, body, torch.zeros(3, dtype=torch.long),
                                5)
    assert len(trips) == 2
    trips.clear()
    with graph._device_mode():
        dev = graph.bounded_while(cond, body,
                                  torch.zeros(3, dtype=torch.long), 5)
    assert len(trips) == 5 and not bool(trips[-1].any())
    assert eager.tolist() == dev.tolist() == [0, 2, 1]


def test_captured_launches_count_once_a_replay():
    """A launch recorded while capturing counts in CAPTURED_LAUNCHES, not
    as a launch; the counters take it once for every replay when the solve
    ends; a warm-up launch counts in neither."""
    class Kernel:
        KERNEL_LAUNCHES = 0
        CAPTURED_LAUNCHES = 0
        SHAPES: set = set()

    captured = []
    with graph._device_mode(captured=captured):
        graph.count_launch(Kernel, (4, 8), KERNEL_LAUNCHES=1)
    assert (Kernel.KERNEL_LAUNCHES, Kernel.CAPTURED_LAUNCHES) == (0, 1)
    warm = graph.WARMUP_LAUNCHES
    with graph._device_mode(warmup=True):
        graph.count_launch(Kernel, (4, 8), KERNEL_LAUNCHES=1)
    assert graph.WARMUP_LAUNCHES == warm + 1 and Kernel.KERNEL_LAUNCHES == 0
    for module, shape, incs in captured:
        graph._credit(module, shape, incs, 7)
    graph.count_launch(Kernel, (2, 8), KERNEL_LAUNCHES=1)
    assert Kernel.KERNEL_LAUNCHES == 8
    assert Kernel.SHAPES == {(4, 8), (2, 8)}


# ---------------------------------------------------------------------------
# (c) routing
# ---------------------------------------------------------------------------

@pytest.fixture
def programs(monkeypatch):
    """The device programs run, by backend name."""
    seen = []
    real = graph.run

    def spy(key, *a, **k):
        seen.append(key[1].name)
        return real(key, *a, **k)

    monkeypatch.setattr(graph, "run", spy)
    return seen


@pytest.mark.parametrize("algo", ["HSD", "MPC"])
@pytest.mark.parametrize("how", ["output-level", "log-fn", "time-limit",
                                 "host-loop"])
def test_host_driven_options_take_the_host_loop(how, algo, programs, capsys):
    """An iteration log, ``log_fn``, a finite TimeLimit or HostLoop=True
    keep the solve on the host-driven loop, as the reference's
    ``hsd_solve`` / ``mpc_solve`` do; the defaults take the device
    program."""
    dat = stack_lps_host(random_lps(5, B=1), device="cpu",
                         dtype=torch.float64)
    kw = {"output-level": dict(OutputLevel=1), "time-limit":
          dict(TimeLimit=600.0), "host-loop": dict(HostLoop=True),
          "log-fn": {}}[how]
    log_fn = (lambda s: None) if how == "log-fn" else None
    Opts, solve = ((HSDOptions, hsd_solve) if algo == "HSD"
                   else (MPCOptions, mpc_solve))
    host = solve(dat, DenseK1Backend(), Opts(**kw), log_fn=log_fn)
    assert programs == []
    dev = solve(dat, DenseK1Backend(), Opts())
    assert programs == ["dense"]
    assert_same_bits(dev, host)


@pytest.mark.parametrize("backend", [
    DenseK1Backend(), DenseK1Backend(inv_factor=True, refinement_steps=1),
    SmallK1Backend(refinement_steps=1),
    SmallK1Backend(refinement_steps=1, fused_solve=True),
    SmallK1Backend(refinement_steps=1, explicit_minv=True),
    GramK1Backend()],
    ids=["dense", "dense-inv", "pallas-small", "fused", "explicit-minv",
         "dense-pallas"])
def test_device_backends_take_the_device_program(backend, programs):
    """Each backend that declares ``device_loop`` solves a batch through
    the device program at the defaults, to the host loop's bits."""
    td = stack_lps_host(random_lps(9, B=4), device="cpu", dtype=torch.float32)
    opts = HSDOptions(TolerancePFeas=1e-5, ToleranceDFeas=1e-5,
                      ToleranceRGap=1e-5, PRegMin=1e-6, DRegMin=1e-6)
    dev = batched_hsd_solve(backend, opts, td)
    assert programs == [backend.name]
    host = batched_hsd_solve(backend, HSDOptions(**{
        **opts.__dict__, "HostLoop": True}), td)
    assert programs == [backend.name]
    assert (dev.status == OPT).all()
    assert_same_bits(dev, host)


@pytest.mark.parametrize("name", ["sqd-minres", "lsqr", "cg"])
def test_host_loop_backends_solve_without_a_program(name, programs):
    """A default solve through a backend that once ran on the host-driven
    loop only (the Krylov backends) builds a device program now, and ends
    in the state that ``HostLoop=True`` gives, bit for bit."""
    from tulip_tpu_torch.kkt import make_backend

    dat = stack_lps_host(random_lps(6, B=2), device="cpu",
                         dtype=torch.float64)
    out = batched_hsd_solve(make_backend(name), HSDOptions(), dat)
    assert (out.status == OPT).all()
    assert programs == [name] and graph.LAST["built"]
    host = batched_hsd_solve(make_backend(name), HSDOptions(HostLoop=True),
                             dat)
    assert programs == [name]
    assert_same_bits(out, host)


# ---------------------------------------------------------------------------
# (d) the cache
# ---------------------------------------------------------------------------

def test_second_solve_of_the_same_shapes_reuses_the_program():
    """A second solve of the same shapes with other data builds nothing
    (the capture counter stays) and ends in the state a fresh program
    gives, bit for bit; another shape builds its own program."""
    be, opts = DenseK1Backend(), HSDOptions()
    first = stack_lps_host(random_lps(1, B=4), device="cpu",
                           dtype=torch.float64)
    second = stack_lps_host(random_lps(2, B=4), device="cpu",
                            dtype=torch.float64)
    n0 = graph.CAPTURES
    batched_hsd_solve(be, opts, first)
    again = batched_hsd_solve(be, opts, second)
    assert graph.CAPTURES == n0 + 1 and not graph.LAST["built"]
    graph.clear_device_programs()
    fresh = batched_hsd_solve(be, opts, second)
    assert graph.CAPTURES == n0 + 2 and graph.LAST["built"]
    assert_same_bits(again, fresh)
    batched_hsd_solve(be, opts, stack_lps_host(random_lps(1, B=5),
                                               device="cpu",
                                               dtype=torch.float64))
    assert graph.CAPTURES == n0 + 3


def test_cache_is_bounded_least_recent_out(monkeypatch):
    """The cache keeps CACHE_SIZE programs and drops the least recently
    used; the result keeps the caller's data leaves, not the program's."""
    monkeypatch.setattr(graph, "CACHE_SIZE", 2)
    be, opts = DenseK1Backend(), HSDOptions()
    dats = [stack_lps_host(random_lps(1, B=B), device="cpu",
                           dtype=torch.float64) for B in (2, 3, 4)]
    n0 = graph.CAPTURES
    for d in dats:
        out = batched_hsd_solve(be, opts, d)
        assert out.kkt.A is d.A
    assert len(graph._CACHE) == 2
    batched_hsd_solve(be, opts, dats[2])
    assert graph.CAPTURES == n0 + 3
    batched_hsd_solve(be, opts, dats[0])
    assert graph.CAPTURES == n0 + 4


def test_init_state_is_not_written_by_the_program():
    """The caller's initial state is copied in, never written: the program
    works on its own static buffers."""
    be, opts = DenseK1Backend(), HSDOptions()
    td = stack_lps_host(random_lps(3, B=2), device="cpu", dtype=torch.float64)
    state = init_state(td, be)
    before = [x.clone() for x in graph.leaves(state) if torch.is_tensor(x)]
    out = hsd_solve_device(be, opts, td, state)
    after = [x for x in graph.leaves(state) if torch.is_tensor(x)]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert (out.status == OPT).all()
