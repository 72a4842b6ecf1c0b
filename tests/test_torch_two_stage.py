"""The two-stage deployment of the benchmark's ``schur-k1024.nccl4`` cell
at CPU sizes: the port's Schur solve (``ipm.hsd_solve`` through
``SchurK1Backend``) held to the plain block reference
(``portbench/references/block_angular.py``) and to the dense box
reference, the block reference held to HiGHS, the share builder
(``parallel.make_block_angular_share``) held to ``shard_scenarios`` bit
for bit, the ``hsd_solve`` call record's collective counters, and a
2-process Gloo job that builds each rank's share with the share builder.
The LPs are the benchmark generator's (``portbench/generators/two_stage.py``)
at (m0, n0, mk, nk) = (3, 6, 4, 8) with K = 8 and at the published widths
(8, 128, 128, 256) with K = 4. No JAX is imported here."""

import collections

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.optimize import linprog

from portbench.generators import two_stage
from portbench.reference import solve_box_lp
from portbench.references import block_angular as block_ref
from tulip_tpu_torch import trace
from tulip_tpu_torch.ipm.hsd import HSDOptions, hsd_solve
from tulip_tpu_torch.kkt import SchurK1Backend
from tulip_tpu_torch.parallel import (Comm, make_block_angular,
                                      make_block_angular_share,
                                      shard_scenarios)
from tulip_tpu_torch.parallel.dryrun import launch

torch.set_num_threads(1)

OPT = 2
SMALL = dict(m0=3, n0=6, mk=4, nk=8, scenarios=8)
PUBLISHED = dict(m0=8, n0=128, mk=128, nk=256, scenarios=4)
SIZES = {"small": SMALL, "published": PUBLISHED}
SEED = 2 ** 31 + 23
ARGS = ("A0", "b0", "c0x", "T", "W", "h", "cks", "l", "u")
# The program stops at its default relative gap and residuals, 1.49e-8
# (HSDOptions()): its objective lies within that of f* (relative to
# 1 + |f*|), and 1e-7 leaves room for the residuals' share. The block
# reference stops at 1e-9 and the box reference at 1e-9: 1e-8 between them.
OBJ_PROGRAM, OBJ_REFERENCES = 1e-7, 1e-8
# x at the optimum is unique for these LPs (random data), but an IPM that
# stops at a relative gap g leaves x within about sqrt(g) of its vertex
# along the optimal face's steepest direction; the program's g = 1.49e-8
# gives ~1e-4, the references' 1e-9 ~3e-5 (each with the largest entry
# of x at most 3).
X_PROGRAM, X_REFERENCES = 1e-3, 1e-4


def item(cfg, index=0, seed=SEED):
    return two_stage.make_item(cfg, seed, index)


def dense_A(it):
    """The LP's A as a dense array, from its blocks."""
    A0, T, W = it["A0"], it["T"], it["W"]
    (m0, n0), (K, mk, nk) = A0.shape, W.shape
    A = np.zeros((m0 + K * mk, n0 + K * nk))
    A[:m0, :n0] = A0
    for k in range(K):
        rows = slice(m0 + k * mk, m0 + (k + 1) * mk)
        A[rows, :n0] = T[k]
        A[rows, n0 + k * nk:n0 + (k + 1) * nk] = W[k]
    return A


def flat(it):
    return (np.concatenate([it["b0"], it["h"].reshape(-1)]),
            np.concatenate([it["c0x"], it["cks"].reshape(-1)]), it["u"])


def program(it, comm=None):
    """(status, objective, x) of the port's Schur solve of the whole LP,
    in one process."""
    dat = make_block_angular(*(it[k] for k in ARGS), device="cpu")
    if comm is not None:
        dat = dat._replace(comm=comm)
    out = hsd_solve(dat, SchurK1Backend(), HSDOptions())
    return (int(out.status), float(out.pobj),
            (out.pt.x / out.pt.tau[:, None])[0].numpy())


def assert_near(obj, x, f, xs, obj_tol, x_tol):
    assert abs(obj - f) <= obj_tol * max(1.0, abs(f)), (obj, f)
    assert np.abs(x - xs).max() <= x_tol


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("index", [0, 1])
def test_schur_solve_matches_block_and_box_references(size, index):
    it = item(SIZES[size], index)
    status, obj, x = program(it)
    assert status == OPT
    ref = block_ref.solve(block_ref.build(it, "cpu"))
    assert bool(ref.converged[0])
    f, xs = float(ref.obj[0]), ref.x[0].numpy()
    b, c, u = (torch.as_tensor(v)[None] for v in flat(it))
    box = solve_box_lp(torch.as_tensor(dense_A(it))[None], b, c, u)
    assert bool(box.converged[0])
    assert_near(obj, x, f, xs, OBJ_PROGRAM, X_PROGRAM)
    assert_near(obj, x, float(box.obj[0]), box.x[0].numpy(), OBJ_PROGRAM,
                X_PROGRAM)
    assert_near(f, xs, float(box.obj[0]), box.x[0].numpy(), OBJ_REFERENCES,
                X_REFERENCES)


@pytest.mark.parametrize("index", range(4))
def test_block_reference_matches_highs(index):
    it = item(SMALL, index, seed=SEED + 1)
    ref = block_ref.solve(block_ref.build(it, "cpu"))
    b, c, u = flat(it)
    h = linprog(c, A_eq=sp.csr_matrix(dense_A(it)), b_eq=b,
                bounds=np.stack([0 * u, u], 1), method="highs")
    assert h.status == 0 and bool(ref.converged[0])
    assert_near(float(ref.obj[0]), ref.x[0].numpy(), h.fun, h.x,
                OBJ_REFERENCES, X_REFERENCES)


def test_block_reference_matvec_is_the_dense_product():
    it = item(PUBLISHED)
    lp = block_ref.build(it, "cpu")
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (2, lp.c.shape[1])))
    A = torch.as_tensor(dense_A(it))
    torch.testing.assert_close(lp.matvec(x), x @ A.T, rtol=1e-13,
                               atol=1e-12)
    y = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (2, lp.b.shape[1])))
    torch.testing.assert_close(lp.rmatvec(y), y @ A, rtol=1e-13,
                               atol=1e-12)


def _group(rank, size):
    """A Comm that reads as rank ``rank`` of ``size`` (for building
    shares in one process; it runs no collective)."""
    comm = Comm()
    comm.rank, comm.size = rank, size
    return comm


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ranks", [2, 4])
def test_share_builder_is_shard_scenarios_bit_for_bit(size, dtype, ranks):
    it = item(SIZES[size])
    whole = make_block_angular(*(it[k] for k in ARGS), device="cpu",
                               dtype=dtype)
    K = len(it["h"])
    for r in range(ranks):
        comm = _group(r, ranks)
        want = shard_scenarios(whole, comm)
        lo, hi = r * K // ranks, (r + 1) * K // ranks
        got = make_block_angular_share(
            *(it[k][lo:hi] if k in "TW" else it[k] for k in ARGS),
            comm=comm, device="cpu", dtype=dtype)
        assert got.comm is comm and want.comm is comm
        for f, g, w in zip(want._fields, got, want):
            if torch.is_tensor(w):
                assert g.dtype == w.dtype and g.shape == w.shape, f
                assert g.is_contiguous(), f
                assert torch.equal(g, w), f


def test_share_builder_refuses_a_wrong_share():
    it = item(SMALL)
    with pytest.raises(ValueError, match="holds 4 of K = 8"):
        make_block_angular_share(*(it[k][:3] if k in "TW" else it[k]
                                   for k in ARGS),
                                 comm=_group(0, 2), device="cpu")


@pytest.fixture
def calls(monkeypatch):
    fresh = collections.deque(maxlen=trace.CALLS.maxlen)
    monkeypatch.setattr(trace, "CALLS", fresh)
    return fresh


@pytest.mark.parametrize("size", sorted(SIZES))
def test_hsd_solve_record_counts_the_collectives(size, calls):
    """A direct ``hsd_solve`` opens its record; the record counts the
    data's collectives as ``Comm`` does, one n0×n0 Schur all-reduce for
    each factorization attempt, and the bytes by name add up."""
    cfg = SIZES[size]
    comm = Comm()
    status, _, _ = program(item(cfg), comm)
    assert status == OPT
    assert [r["entry"] for r in calls] == ["hsd_solve"]
    cnt = calls[0]["counters"]
    assert cnt["collectives"] == sum(comm.counts.values())
    assert cnt["comm_bytes"] == comm.nbytes
    n0 = cfg["n0"]
    assert cnt["collectives/schur_reduce"] == \
        comm.counts[("all_reduce_sum", n0 * n0)] == \
        cnt["collectives/factor_ok"] > 0
    named = [k for k in cnt if k.startswith("collectives/")]
    assert sum(cnt[k] for k in named) == cnt["collectives"]
    assert sum(cnt["comm_bytes/" + k.split("/")[1]] for k in named) == \
        cnt["comm_bytes"]
    assert cnt["passes"] > 0


def test_share_is_a_record_and_nests_in_an_open_one(calls):
    it = item(SMALL)
    args = [it[k][:4] if k in "TW" else it[k] for k in ARGS]
    make_block_angular_share(*args, comm=_group(0, 2), device="cpu")
    with trace.call("outer"):
        make_block_angular_share(*args, comm=_group(0, 2), device="cpu")
    assert [r["entry"] for r in calls] == ["share", "outer"]
    assert all(r["times"]["share"] == 1 for r in calls)


def solve_share(comm, device, cfg, seed, index):
    """A job of ``dryrun.launch``: this rank makes its own scenarios of
    the generator's item and solves its share; status, objective, x and
    the ``hsd_solve`` record's counters."""
    K = cfg["scenarios"]
    lo, hi = comm.rank * K // comm.size, (comm.rank + 1) * K // comm.size
    A0, b0, c0x, u0, x0 = two_stage.first_stage(cfg, seed, index)
    T, W, _, _, _ = two_stage.scenarios(cfg, seed, index, lo, hi, x0)
    it = two_stage.make_item(cfg, seed, index)
    dat = make_block_angular_share(A0, b0, c0x, T, W, it["h"], it["cks"],
                                   it["l"], it["u"], comm=comm,
                                   device=device)
    out = hsd_solve(dat, SchurK1Backend(), HSDOptions())
    return dict(status=int(out.status), pobj=float(out.pobj),
                x=(out.pt.x / out.pt.tau[:, None])[0].numpy(),
                counters=trace.CALLS[-1]["counters"])


@pytest.mark.parametrize("size", sorted(SIZES))
def test_two_gloo_ranks_solve_their_shares(size):
    """Two CPU processes over Gloo (a 120 s limit), each holding only its
    scenarios' blocks: both ranks give the same answer bit for bit, within
    the program's tolerance of the one-process solve (the group's sums add
    in another order, so the iterates part in their last bits) and of the
    block reference, with one n0×n0 all-reduce a factorization attempt on
    every rank."""
    cfg = SIZES[size]
    res = launch(solve_share, 2, device="cpu", timeout_s=120.0,
                 args=(cfg, SEED, 0))
    it = item(cfg)
    status, obj, x = program(it)
    ref = block_ref.solve(block_ref.build(it, "cpu"))
    for r in res:
        assert r["status"] == status == OPT
        assert_near(r["pobj"], r["x"], obj, x, OBJ_PROGRAM, X_PROGRAM)
        assert_near(r["pobj"], r["x"], float(ref.obj[0]), ref.x[0].numpy(),
                    OBJ_PROGRAM, X_PROGRAM)
        cnt = r["counters"]
        assert cnt["collectives/schur_reduce"] == \
            cnt["collectives/factor_ok"] > 0
    np.testing.assert_array_equal(res[0]["x"], res[1]["x"])
