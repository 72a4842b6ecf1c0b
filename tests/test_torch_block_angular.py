"""Port parity of the block-angular data and the Schur-complement backend
(``tulip_tpu_torch.parallel``, ``kkt/schur.py``) against the JAX package,
in one process: the reference's two-stage LPs (``random_two_stage`` of
tests/test_block_angular.py, K=4, m0=3, n0=6, mk=4, nk=8, seeds 0-4) are
built with numpy and carried across by ``tulip_tpu_torch.convert``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_block_angular import random_two_stage

import tulip_tpu  # noqa: F401
from tulip_tpu.ipm import data as jdata
from tulip_tpu.ipm import hsd as jhsd
from tulip_tpu.ipm import mpc as jmpc
from tulip_tpu.kkt import SchurK1Backend as JSchur
from tulip_tpu.parallel import block_angular as jba
from tulip_tpu_torch.convert import (block_angular_from_numpy,
                                     structured_state_from_numpy)
from tulip_tpu_torch.ipm.data import matvec, rmatvec
from tulip_tpu_torch.ipm.hsd import HSDOptions, hsd_solve
from tulip_tpu_torch.ipm.mpc import MPCOptions, mpc_solve
from tulip_tpu_torch.kkt import SchurK1Backend
from tulip_tpu_torch.parallel import (block_angular_to_dense,
                                      make_block_angular, pad_scenarios,
                                      shard_scenarios)
from tulip_tpu_torch.status import TerminationStatus

torch.set_num_threads(1)

OPT = int(TerminationStatus.OPTIMAL)
SEEDS = range(5)


def two_stage(rng, K=4, m0=3, n0=6, mk=4, nk=8):
    """The arguments that ``random_two_stage`` passes to
    ``make_block_angular``, from the same draws."""
    A0 = rng.standard_normal((m0, n0))
    T = rng.standard_normal((K, mk, n0))
    W = rng.standard_normal((K, mk, nk))
    u0 = rng.uniform(1, 3, n0)
    uk = rng.uniform(1, 3, (K, nk))
    x0 = u0 * rng.uniform(0.2, 0.8, n0)
    xs = uk * rng.uniform(0.2, 0.8, (K, nk))
    b0 = A0 @ x0
    h = np.einsum("kij,j->ki", T, x0) + np.einsum("kij,kj->ki", W, xs)
    c0x = rng.standard_normal(n0)
    cks = rng.standard_normal((K, nk))
    l = np.zeros(n0 + K * nk)
    u = np.concatenate([u0, uk.reshape(-1)])
    return A0, b0, c0x, T, W, h, cks, l, u


def to_numpy(tree):
    if hasattr(tree, "_asdict"):
        return {k: to_numpy(v) for k, v in tree._asdict().items()}
    return np.asarray(tree)


def both(seed, dtype=np.float64):
    """(the reference's LP of ``seed``, the port's from its arrays, the
    rng after the LP's draws)."""
    rng = np.random.default_rng(seed)
    ref = random_two_stage(rng)
    if dtype == np.float32:
        ref = ref._replace(**{f: getattr(ref, f).astype(jnp.float32)
                              for f in ref._fields})
    dat = block_angular_from_numpy(
        to_numpy(ref), device="cpu",
        dtype={np.float64: torch.float64, np.float32: torch.float32}[dtype])
    return ref, dat, rng


def host(v):
    """A port tensor without its lane axis, or a reference array, as
    numpy."""
    return v[0].numpy() if torch.is_tensor(v) else np.asarray(v)


def assert_fields_equal(got, ref):
    for f in ref._fields:
        np.testing.assert_array_equal(host(getattr(got, f)),
                                      host(getattr(ref, f)), err_msg=f)


@pytest.mark.parametrize("seed", SEEDS)
def test_data_matches_reference(seed):
    """``make_block_angular``, ``pad_scenarios`` and
    ``block_angular_to_dense`` give the reference's arrays, entry for
    entry."""
    args = two_stage(np.random.default_rng(seed))
    ref = jba.make_block_angular(*args)
    assert_fields_equal(ref, random_two_stage(np.random.default_rng(seed)))
    dat = make_block_angular(*args, device="cpu")
    assert_fields_equal(dat, ref)
    assert (dat.K, dat.nrow, dat.ncol) == (ref.K, ref.nrow, ref.ncol)
    assert_fields_equal(pad_scenarios(dat, 6), jba.pad_scenarios(ref, 6))
    assert_fields_equal(block_angular_to_dense(dat),
                        jba.block_angular_to_dense(ref))


@pytest.mark.parametrize("seed", SEEDS)
def test_matvec_matches_reference(seed):
    ref, dat, rng = both(seed)
    x = rng.standard_normal(ref.ncol)
    y = rng.standard_normal(ref.nrow)
    got = matvec(dat, torch.as_tensor(x[None]))[0].numpy()
    np.testing.assert_allclose(got, np.asarray(jdata.matvec(ref, x)),
                               rtol=0, atol=1e-12)
    got = rmatvec(dat, torch.as_tensor(y[None]))[0].numpy()
    np.testing.assert_allclose(got, np.asarray(jdata.rmatvec(ref, y)),
                               rtol=0, atol=1e-12)


def conformance_inputs(ref, rng, dtype=np.float64, reg=1e-8):
    """The reference's conformance inputs
    (tests/test_block_angular.py:49-73): θ⁻¹ = 10^U(-3,3), Rp = Rd = 1e-8,
    standard normal right-hand sides."""
    n, m = ref.ncol, ref.nrow
    return dict(theta_inv=(10.0 ** rng.uniform(-3, 3, n)).astype(dtype),
                regP=np.full(n, reg, dtype), regD=np.full(m, reg, dtype),
                xi_p=rng.standard_normal(m).astype(dtype),
                xi_d=rng.standard_normal(n).astype(dtype))


def both_solves(ref, dat, x, refinement_steps):
    """(reference's (state, ok, dx, dy), port's) from the same inputs; the
    port's state starts from the reference's initial state, converted."""
    jbe = JSchur(refinement_steps=refinement_steps)
    jst, jok = jbe.update(jbe.setup_data(ref), jnp.asarray(x["theta_inv"]),
                          jnp.asarray(x["regP"]), jnp.asarray(x["regD"]))
    jdx, jdy = jbe.solve(jst, jnp.asarray(x["xi_p"]), jnp.asarray(x["xi_d"]))

    dt = dat.c.dtype
    be = SchurK1Backend(refinement_steps=refinement_steps)
    st0 = structured_state_from_numpy(
        "SchurState", to_numpy(jbe.setup_data(ref)), device="cpu", dtype=dt)
    assert type(st0).__name__ == "SchurState"

    def t(v):
        return torch.as_tensor(v[None], dtype=dt)

    st, ok = be.update(st0, t(x["theta_inv"]), t(x["regP"]), t(x["regD"]))
    dx, dy = be.solve(st, t(x["xi_p"]), t(x["xi_d"]))
    return ((jst, bool(jok), np.asarray(jdx), np.asarray(jdy)),
            (st, bool(ok), dx[0].numpy(), dy[0].numpy()))


def augmented_residual(ref, x, dx, dy):
    """max |rd|, |rp| of the augmented system with the dense A, in f64."""
    A = np.asarray(jba.block_angular_to_dense(ref).A, dtype=np.float64)
    th = x["theta_inv"].astype(np.float64) + x["regP"]
    rd = x["xi_d"] - (-th * dx + A.T @ dy)
    rp = x["xi_p"] - (A @ dx + x["regD"] * dy)
    return max(np.abs(rd).max(), np.abs(rp).max())


def rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("refine", [0, 1])
@pytest.mark.parametrize("seed", SEEDS)
def test_update_and_solve_match_reference(seed, refine):
    """Factors within 1e-10 of their largest entry; with one sweep, dx and
    dy within 1e-12 relative (max-norm) of the reference's. S is
    ill-conditioned here (cond ~2e7 on seed 1), so without a sweep each
    package's dx, dy sit up to ~1e-8 off the exact solve, in rounding
    that differs between the two: the port's unrefined solve is held to
    be within 2x the reference's distance from the exact solve (the
    reference's with two sweeps), or within 1e-8 of it. The residual with
    the dense A is the reference's own bar."""
    ref, dat, rng = both(seed)
    x = conformance_inputs(ref, rng)
    (jst, jok, jdx, jdy), (st, ok, dx, dy) = both_solves(ref, dat, x, refine)
    assert ok == jok is True
    for f in ("Lk", "Ls"):
        want = np.asarray(getattr(jst, f))
        np.testing.assert_allclose(getattr(st, f)[0].numpy(), want, rtol=0,
                                   atol=1e-10 * np.abs(want).max(),
                                   err_msg=f)
    if refine:
        assert rel(dx, jdx) <= 1e-12 and rel(dy, jdy) <= 1e-12
    else:
        (_, _, ex, ey), _ = both_solves(ref, dat, x, 2)
        assert rel(dx, ex) <= max(1e-8, 2 * rel(jdx, ex))
        assert rel(dy, ey) <= max(1e-8, 2 * rel(jdy, ey))
    assert augmented_residual(ref, x, dx, dy) < 1e-6


@pytest.mark.parametrize("seed", SEEDS)
def test_refined_f32_residual_as_the_references(seed):
    """f32 with one sweep: the port's augmented residual within 10× of the
    reference's on the same inputs (their f32 vectors are compared
    through the residual, not entry by entry: the reference's own refined
    f32 solve is several per cent off the exact one on seed 1).
    Regularization at the f32 IPM's floor, 1e-6 (the PRegMin and DRegMin
    of the reference's f32 test): at 1e-8 the first-stage S is
    conditioned past 1/eps of f32 (~2e7 on seed 1), and whether its
    Cholesky succeeds is a matter of rounding in both packages (their
    flags differ, each way, on two of these seeds)."""
    ref, dat, rng = both(seed, np.float32)
    x = conformance_inputs(ref, rng, np.float32, reg=1e-6)
    (_, jok, jdx, jdy), (st, ok, dx, dy) = both_solves(ref, dat, x, 1)
    assert ok == jok is True
    assert dat.c.dtype == st.Ls.dtype == torch.float32
    assert augmented_residual(ref, x, dx, dy) <= \
        10 * augmented_residual(ref, x, jdx, jdy)


@pytest.mark.parametrize("k", [0, 3])
def test_failed_update_flags_like_the_reference(k):
    """A non-finite θ⁻¹ in scenario k: ok False in both packages, and the
    port's Lk and Ls reset to the identity."""
    ref, dat, rng = both(1)
    x = conformance_inputs(ref, rng)
    x["theta_inv"][ref.n0 + k * ref.nk + 2] = np.nan
    (_, jok, _, _), (st, ok, dx, dy) = both_solves(ref, dat, x, 0)
    assert ok is jok is False
    assert torch.equal(st.Lk[0], torch.eye(ref.mk, dtype=torch.float64)
                       .expand(ref.K, -1, -1))
    assert torch.equal(st.Ls[0], torch.eye(ref.n0, dtype=torch.float64))


def recorder(rows):
    return lambda s: rows.append(
        (int(np.asarray(s.niter).reshape(-1)[0]),
         *(float(np.asarray(v).reshape(-1)[0])
           for v in (s.pobj, s.dobj, s.pt.mu))))


def test_hsd_matches_reference():
    """Seed 2: OPTIMAL in the reference's 7 iterations, pobj within
    1e-8·max(1,|f|), and the per-iteration (niter, pobj, dobj, mu) within
    1e-8 relative or 1e-10 absolute (as tests/test_torch_hsd.py's log test
    holds them: the last mu, 6.1e-7, differs by 3.7e-13)."""
    ref, dat, _ = both(2)
    want, got = [], []
    jout = jhsd.hsd_solve(ref, JSchur(), jhsd.HSDOptions(),
                          log_fn=recorder(want))
    out = hsd_solve(dat, SchurK1Backend(), HSDOptions(),
                    log_fn=recorder(got))
    assert int(out.status) == int(jout.status) == OPT
    assert int(out.niter) == int(jout.niter) == 7
    f = float(jout.pobj)
    assert abs(float(out.pobj) - f) <= 1e-8 * max(1.0, abs(f))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert g[0] == w[0]
        np.testing.assert_allclose(g[1:], w[1:], rtol=1e-8, atol=1e-10)


def test_hsd_matches_highs():
    from scipy.optimize import linprog

    ref, dat, _ = both(2)
    out = hsd_solve(dat, SchurK1Backend(), HSDOptions())
    dense = jba.block_angular_to_dense(ref)
    r = linprog(np.asarray(dense.c), A_eq=np.asarray(dense.A),
                b_eq=np.asarray(dense.b),
                bounds=list(zip(np.asarray(dense.l),
                                np.where(np.asarray(dense.uflag) > 0,
                                         np.asarray(dense.u), np.inf))),
                method="highs")
    assert r.status == 0
    assert abs(float(out.pobj) - r.fun) <= 1e-7 * max(1.0, abs(r.fun))


def test_mpc_matches_reference():
    ref, dat, _ = both(2)
    jout = jmpc.mpc_solve(ref, JSchur(), jmpc.MPCOptions())
    out = mpc_solve(dat, SchurK1Backend(), MPCOptions())
    assert int(out.status) == int(jout.status) == OPT
    assert int(out.niter) == int(jout.niter) == 8
    f = float(jout.pobj)
    assert abs(float(out.pobj) - f) <= 1e-8 * max(1.0, abs(f))


def test_f32_with_refinement_solves():
    """As tests/test_block_angular.py::test_schur_with_refinement_f32."""
    _, dat, _ = both(4, np.float32)
    tol = 3e-4
    opts = HSDOptions(TolerancePFeas=tol, ToleranceDFeas=tol,
                      ToleranceRGap=tol, ToleranceIFeas=tol,
                      PRegMin=1e-6, DRegMin=1e-6)
    out = hsd_solve(dat, SchurK1Backend(refinement_steps=1), opts)
    assert int(out.status) == OPT
    assert out.pobj.dtype == torch.float32


def test_padded_scenarios_keep_the_objective():
    _, dat, _ = both(2)
    out = hsd_solve(dat, SchurK1Backend(), HSDOptions())
    pad = hsd_solve(pad_scenarios(dat, 6), SchurK1Backend(), HSDOptions())
    assert int(pad.status) == OPT
    f = float(out.pobj)
    assert abs(float(pad.pobj) - f) <= 1e-7 * max(1.0, abs(f))


def test_shard_over_a_group_of_one_is_bit_identical(tmp_path):
    """``shard_scenarios`` over a real Gloo group of one process gives the
    unsharded solve's final state bit for bit, and the group's counter
    sees one n0×n0 all-reduce per factorization attempt."""
    import torch.distributed as dist

    from tulip_tpu_torch.parallel import init_comm

    _, dat, _ = both(2)
    want = hsd_solve(dat, SchurK1Backend(), HSDOptions())
    comm = init_comm("gloo", 0, 1, str(tmp_path / "store"), 60.0)
    try:
        got = hsd_solve(shard_scenarios(dat, comm), SchurK1Backend(),
                        HSDOptions())
    finally:
        dist.destroy_process_group()
    for f, g, w in zip(want._fields, got, want):
        if f == "kkt":
            g, w = g[:-1], w[:-1]     # the comm field
        for a, b in zip(torch.utils._pytree.tree_leaves(g),
                        torch.utils._pytree.tree_leaves(w)):
            assert torch.equal(a, b), f
    n0 = dat.n0
    assert comm.counts[("all_reduce_sum", n0 * n0)] == \
        comm.counts[("all_reduce_and", 1)] > 0
