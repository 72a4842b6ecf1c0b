"""The device program (``ipm/graph.py``) on the 13 Krylov backends of
``tulip_tpu_torch`` (``kkt/krylov.py``), on the CPU, where the pass runs
step by step and each Krylov solve runs as a loop of the pass: its trips in
chunks of ``_CHECK_EVERY`` with one host read before each chunk, the same
chunks and reads as the chunk graphs replay on the card:

(a) each backend through ``hsd_solve_device`` bit for bit with
    ``HostLoop=True``, and cg, sqd-minres and lsqr through
    ``mpc_solve_device``, with the trips and host reads that
    ``graph.LAST`` reports;
(b) one solve as the loop of a one-pass program against the host-driven
    loop: chunk boundaries (``maxiter mod 16 != 0``, lanes still active
    at ``maxiter``, CRAIG's ``maxiter - 1``), and MINRES-QLP and TriCG
    solves that stop within their first 3 trips, where their bodies branch
    on the trip index;
(c) against the JAX package's ``hsd_solve_device`` (its Krylov loops are
    ``lax.while_loop``s inside the solve's), in f64.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_device_loop import assert_same_bits
from test_torch_hsd import random_lps
from tulip_tpu.ipm import data as jdata
from tulip_tpu.ipm import hsd as jhsd
from tulip_tpu.kkt import make_backend as jmake_backend
from tulip_tpu_torch.ipm import graph
from tulip_tpu_torch.ipm.batch import (batched_hsd_solve, batched_mpc_solve,
                                       stack_lps_host)
from tulip_tpu_torch.ipm.data import make_lp_data
from tulip_tpu_torch.ipm.hsd import HSDOptions, hsd_solve_device, init_state
from tulip_tpu_torch.ipm.mpc import MPCOptions, mpc_solve_device
from tulip_tpu_torch.kkt import krylov, make_backend
from tulip_tpu_torch.kkt.krylov import bmtv, bmv
from tulip_tpu_torch.status import TerminationStatus

torch.set_num_threads(1)

OPT = int(TerminationStatus.OPTIMAL)
KRYLOV = ["car", "cg", "craig", "craigmr", "cr", "lsmr", "lsqr", "minares",
          "minres", "minres-qlp", "sqd-minres", "symmlq", "tricg"]
# minres (unscaled K2) stalls near its ~1e-6 floor and minares runs every
# solve to maxiter: both are held to 10 iterations here, since the bits
# that the two loops must share do not depend on convergence.
LIMITS = {"minres": 10, "minares": 10}


@pytest.fixture(autouse=True)
def fresh_cache():
    graph.clear_device_programs()
    yield
    graph.clear_device_programs()


def backend(name, **kw):
    with warnings.catch_warnings():
        # make_backend warns that tricg and minares are experimental.
        warnings.simplefilter("ignore")
        return make_backend(name, **kw)


def counters():
    return (graph.LOOPS, graph.LOOP_TRIPS, graph.LOOP_READS)


def host_figures(run):
    """(result, (loops, trips, host reads)) of ``run()`` on the host-driven
    loop, from the port's loop counters."""
    before = counters()
    out = run()
    return out, tuple(a - b for a, b in zip(counters(), before))


def assert_loop_figures(last):
    """The program's own figures: every host read of a loop comes before a
    chunk, or ends its loop; a pass's reads are the passes'."""
    assert last["chunk_replays"] <= last["loop_reads"] \
        <= last["chunk_replays"] + last["loops"]
    assert last["trips"] <= last["chunk_replays"] * krylov._CHECK_EVERY
    assert last["host_reads"] == last["syncs"] + last["loop_reads"]
    assert last["host_ops"] == 0


# ---------------------------------------------------------------------------
# (a) the IPM through the program, bit for bit with the host loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", KRYLOV)
def test_krylov_backend_device_program_equals_host_loop(name):
    """Two LPs through ``hsd_solve_device`` and through the host-driven
    loop, f64: final states equal bit for bit. The program runs at least
    the host loop's loops and trips (its masked corrections solve for
    every lane even where no lane needs them)."""
    td = stack_lps_host(random_lps(21, B=2), device="cpu",
                        dtype=torch.float64)
    limit = LIMITS.get(name, 100)
    be = backend(name)
    dev = hsd_solve_device(be, HSDOptions(IterationsLimit=limit), td)
    last = dict(graph.LAST)
    host, (loops, trips, reads) = host_figures(lambda: batched_hsd_solve(
        be, HSDOptions(IterationsLimit=limit, HostLoop=True), td))
    assert last["built"] and last["passes"] == int(dev.niter.max()) + 1
    assert_same_bits(dev, host)
    if name not in LIMITS:
        assert (dev.status == OPT).all()
    assert last["loops"] >= loops > 0 and last["trips"] >= trips > 0
    assert_loop_figures(last)


@pytest.mark.parametrize("name", ["cg", "sqd-minres", "lsmr"])
def test_without_corrections_the_program_reads_as_the_host_loop(name):
    """With ``CorrectionLimit = 0`` no Krylov solve of a pass is masked:
    the program runs the host loop's loops and trips, with its host reads
    of the loops, exactly."""
    td = stack_lps_host(random_lps(22, B=2), device="cpu",
                        dtype=torch.float64)
    be = backend(name)
    dev = batched_hsd_solve(be, HSDOptions(CorrectionLimit=0), td)
    last = dict(graph.LAST)
    host, figures = host_figures(lambda: batched_hsd_solve(
        be, HSDOptions(CorrectionLimit=0, HostLoop=True), td))
    assert_same_bits(dev, host)
    assert (last["loops"], last["trips"], last["loop_reads"]) == figures
    assert_loop_figures(last)


@pytest.mark.parametrize("name", ["cg", "sqd-minres", "lsqr"])
def test_mpc_device_program_equals_host_loop(name):
    td = stack_lps_host(random_lps(23, B=2), device="cpu",
                        dtype=torch.float64)
    be = backend(name)
    dev = mpc_solve_device(be, MPCOptions(), td)
    last = dict(graph.LAST)
    host, (loops, trips, _) = host_figures(lambda: batched_mpc_solve(
        be, MPCOptions(HostLoop=True), td))
    assert last["built"]
    assert (dev.status == OPT).all()
    assert_same_bits(dev, host)
    assert last["loops"] >= loops and last["trips"] >= trips
    assert_loop_figures(last)


def test_chunk_boundary_inside_the_ipm():
    """cg with ``maxiter = 3·m = 18`` (a first chunk of 16 trips and a
    tail of 2) and a relative tolerance no solve reaches, so that every
    solve runs to maxiter: the program's final state equals the host
    loop's, and each loop runs 18 trips after 2 host reads."""
    td = stack_lps_host(random_lps(24, B=2), device="cpu",
                        dtype=torch.float64)
    be = backend("cg", maxiter_factor=3, rtol=1e-300)
    opts = HSDOptions(IterationsLimit=4)
    dev = batched_hsd_solve(be, opts, td)
    last = dict(graph.LAST)
    host, (loops, trips, reads) = host_figures(lambda: batched_hsd_solve(
        be, HSDOptions(IterationsLimit=4, HostLoop=True), td))
    assert_same_bits(dev, host)
    assert last["trips"] == 18 * last["loops"] and trips == 18 * loops
    assert last["loop_reads"] == 2 * last["loops"] and reads == 2 * loops
    assert last["chunk_replays"] == 2 * last["loops"]


# ---------------------------------------------------------------------------
# (b) one solve as the loop of a one-pass program
# ---------------------------------------------------------------------------

def one_pass(fn, *args):
    """``fn(*args)`` (a tuple of tensors) as the one pass of a device
    program, after the same call on the host-driven loop: (the program's
    result, the host loop's, ``graph.LAST``, the host loop's (loops, trips,
    reads))."""
    want, figures = host_figures(lambda: fn(*args))
    out = graph.run(("one pass", fn), tuple(args),
                    tuple(torch.zeros_like(w) for w in want),
                    lambda d, s: fn(*d),
                    lambda s: torch.zeros((), dtype=torch.bool))
    return out, want, dict(graph.LAST), figures


def spd_lanes(seed, m=40, cond=1e10):
    """Two lanes: the identity and an SPD matrix of condition ``cond``
    (eigenvalues spread geometrically), with random right-hand sides."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((m, m)))
    K = (Q * np.geomspace(1.0, cond, m)) @ Q.T
    M = np.stack([np.eye(m), (K + K.T) / 2])
    return (torch.as_tensor(M), torch.as_tensor(rng.standard_normal((2, m))))


def cg(maxiter):
    def fn(M, b):
        return (krylov.pcg(lambda v: bmv(M, v), b, lambda r: r, 1e-14,
                           maxiter),)
    return fn


@pytest.mark.parametrize("maxiter,chunks", [(10, 1), (16, 1), (18, 2),
                                            (37, 3)])
def test_chunks_stop_where_the_host_loop_stops(maxiter, chunks):
    """CG on two lanes, one that stops after its first trip (the identity)
    and one still active at ``maxiter`` (condition 1e10): the first chunk,
    the steady chunk and the tail of ``maxiter mod 16`` trips run the host
    loop's trips and reads, to its bits."""
    out, want, last, (loops, trips, reads) = one_pass(cg(maxiter),
                                                      *spd_lanes(1))
    assert_same_bits(out, want)
    assert (loops, trips) == (1, maxiter)
    assert (last["loops"], last["trips"], last["loop_reads"]) == \
        (loops, trips, reads) == (1, maxiter, chunks)
    assert last["chunk_replays"] == chunks and last["passes"] == 1
    # The lane of condition 1e10 was cut at maxiter, not converged.
    more, _ = host_figures(lambda: cg(maxiter + 16)(*spd_lanes(1)))
    assert not torch.equal(more[0][1], want[0][1])
    assert torch.equal(more[0][0], want[0][0])


def test_craig_runs_maxiter_minus_one_trips():
    """CRAIG's counter starts at 1 (``maxiter - 1`` trips): at
    ``maxiter = 17`` one chunk of 16 trips after one read, as the host
    loop."""
    M, b = spd_lanes(2)
    M = M[:, :, :30]

    def fn(A, y):
        return (krylov.craig(lambda w: bmv(A, w), lambda u: bmtv(A, u), y,
                             30, 1e-300, 17),)

    out, want, last, figures = one_pass(fn, M, b)
    assert_same_bits(out, want)
    assert figures == (1, 16, 1)
    assert (last["loops"], last["trips"], last["loop_reads"],
            last["chunk_replays"]) == (1, 16, 1, 1)


def small_lanes(seed, m=6):
    rng = np.random.default_rng(seed)
    A = torch.as_tensor(rng.standard_normal((2, m, m)) * 1e-3)
    return A, torch.as_tensor(rng.standard_normal((2, m)))


@pytest.mark.parametrize("solver", ["minres-qlp", "tricg"])
def test_early_stop_within_the_first_three_trips(solver):
    """MINRES-QLP (branches on k > 1, k > 2, k == 1, k == 2) and TriCG
    (on k == 0) on systems that stop within 3 trips: the first chunk runs
    16 trips, the read before trip 16 finds no lane active, and the result
    is the host loop's bit for bit (the solve at maxiter 3 is the solve at
    maxiter 40)."""
    A, b = small_lanes(3)
    eye = torch.eye(A.shape[-1], dtype=A.dtype)
    # I + q qᵀ has two eigenvalues: MINRES-QLP stops at its second trip.
    q = A[..., :1] * 1e3
    K = eye + q @ q.mT

    def fn_at(maxiter):
        if solver == "minres-qlp":
            def fn(A, b):
                return (krylov.minres_qlp(lambda v: bmv(K, v), b, 1e-8,
                                          maxiter),)
        else:
            def fn(A, b):
                one = torch.ones_like(b)
                return krylov.tricg(A, one, one, b, b, 1e-8, maxiter)
        return fn

    out, want, last, figures = one_pass(fn_at(40), A, b)
    assert_same_bits(out, want)
    early, _ = host_figures(lambda: fn_at(3)(A, b))
    assert_same_bits(early, want)
    assert figures == (1, 16, 2)
    assert (last["loops"], last["trips"], last["loop_reads"],
            last["chunk_replays"]) == (1, 16, 2, 1)


# ---------------------------------------------------------------------------
# (c) against the reference's device program
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["cg", "sqd-minres", "lsqr"])
def test_solve_device_matches_reference(name):
    """``hsd_solve_device`` against the JAX package's (its Krylov loops
    nested in the solve's ``lax.while_loop``), each from its own eager
    initial state of one LP, f64 at the default tolerances: status equal,
    iterations within ±1 and objectives within 1e-7·max(1, |f|) (the two
    packages' Krylov iterates part by rounding: a solve stops on a
    residual test at sqrt(eps))."""
    A, b, c, c0, l, u = random_lps(25, B=1)[0]
    jdat = jdata.make_lp_data(A, b, c, c0, l, u, dtype=jnp.float64)
    tdat = make_lp_data(A, b, c, c0, l, u, device="cpu")
    jbe, tbe = jmake_backend(name), backend(name)
    want = jhsd.hsd_solve_device(jbe, jhsd.HSDOptions(), jdat,
                                 jhsd.init_state(jdat, jbe, mehrotra=False))
    got = hsd_solve_device(tbe, HSDOptions(), tdat,
                           init_state(tdat, tbe, mehrotra=False))
    assert graph.LAST["built"] and graph.LAST["loops"] > 0
    assert int(got.status[0]) == int(want.status) == OPT
    assert abs(int(got.niter[0]) - int(want.niter)) <= 1
    for f in ("pobj", "dobj"):
        w, g = float(getattr(want, f)), float(getattr(got, f)[0])
        assert abs(g - w) <= 1e-7 * max(1.0, abs(w)), (f, g, w)
