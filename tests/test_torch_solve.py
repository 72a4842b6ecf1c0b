"""Port parity: the fused K1 solve (``tulip_tpu_torch.ops.solve``), the
packed chol-inv launch and ``SmallK1Backend(fused_solve=True)`` against the
JAX package's Pallas kernels run in interpret mode, from the same numpy
inputs, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tulip_tpu  # noqa: F401
from test_torch_hsd import BENCH_TOL, random_lps
from tulip_tpu.ipm import data as jdata
from tulip_tpu.ipm import hsd as jhsd
from tulip_tpu.kkt import PallasSmallK1Backend
from tulip_tpu.ops.chol import batched_cholesky_inverse_pallas
from tulip_tpu.ops.solve import batched_fused_k1_solve as jax_fused
from tulip_tpu.ops.solve import fused_k1_solve as jax_fused_one
from tulip_tpu_torch.ipm.batch import batched_hsd_solve, stack_lps_host
from tulip_tpu_torch.ipm.data import make_lp_data
from tulip_tpu_torch.ipm.hsd import HSDOptions, hsd_solve
from tulip_tpu_torch.kkt import DenseK1Backend, SmallK1Backend
from tulip_tpu_torch.ops import chol, solve
from tulip_tpu_torch.ops.chol import batched_cholesky_inverse
from tulip_tpu_torch.ops.solve import (batched_fused_k1_solve,
                                       batched_fused_k1_solve_plain,
                                       fused_k1_solve)
from tulip_tpu_torch.status import TerminationStatus

torch.set_num_threads(1)

OPT = int(TerminationStatus.OPTIMAL)


def fused_inputs(B, m, n, seed, spread=2.0):
    """The inputs of tests/test_pallas_ops.py:91-122: treg spanning
    10^±spread (2 there), regD 1e-4, Li = L⁻¹ of K = A diag(1/treg) Aᵀ +
    diag(regD) in f64."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, m, n)).astype(np.float32)
    treg = (10.0 ** rng.uniform(-spread, spread, (B, n))).astype(np.float32)
    d = (1.0 / treg).astype(np.float32)
    regD = np.full((B, m), 1e-4, np.float32)
    xi_p = rng.standard_normal((B, m)).astype(np.float32)
    xi_d = rng.standard_normal((B, n)).astype(np.float32)
    K = np.einsum("bij,bkj->bik", A.astype(np.float64) * d[:, None, :],
                  A.astype(np.float64))
    K += regD[:, :, None] * np.eye(m)[None]
    Li = np.stack([np.linalg.inv(np.linalg.cholesky(K[i]))
                   for i in range(B)]).astype(np.float32)
    return A, Li, d, treg, regD, xi_p, xi_d


def assert_close_per_lane(got, want, tol=1e-5):
    """Per lane, max|got − want| ≤ tol·max(1, max|want|)."""
    scale = np.maximum(1.0, np.abs(want).max(axis=-1, keepdims=True))
    assert (np.abs(got - want) <= tol * scale).all(), \
        (np.abs(got - want) / scale).max()


def jax_and_port(args, refine):
    want = jax_fused(*map(jnp.asarray, args), refine=refine, interpret=True)
    before = solve.KERNEL_LAUNCHES
    got = batched_fused_k1_solve(*map(torch.from_numpy, args), refine=refine)
    assert solve.KERNEL_LAUNCHES == before
    assert all(g.dtype == torch.float32 for g in got)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("refine", [0, 1, 2])
@pytest.mark.parametrize("B,m,n", [(6, 48, 96), (5, 20, 36)])
def test_fused_plain_matches_pallas_interpret(B, m, n, refine):
    """With a refinement sweep the two packages agree to 1e-5 per lane.
    Without one, the factor's conditioning at these inputs (treg spanning
    10^±2) amplifies f32 rounding: each package then lies up to ~5e-5
    from the same arithmetic in f64, so each is held against that f64
    solve at 1e-4 instead (the direct 1e-5 bar at refine 0 is
    test_fused_unrefined_matches_pallas_well_conditioned's)."""
    args = fused_inputs(B, m, n, seed=m + refine)
    got, want = jax_and_port(args, refine)
    if refine:
        for g, w in zip(got, want):
            assert_close_per_lane(g, w)
        return
    exact = batched_fused_k1_solve_plain(
        *[torch.from_numpy(a).double() for a in args], refine=0)
    for g, w, e in zip(got, want, exact):
        assert_close_per_lane(g, e.numpy(), 1e-4)
        assert_close_per_lane(w, e.numpy(), 1e-4)


@pytest.mark.parametrize("B,m,n", [(6, 48, 96), (5, 20, 36)])
def test_fused_unrefined_matches_pallas_well_conditioned(B, m, n):
    """Without a sweep, at treg spanning 10^±0.5, the two packages agree to
    1e-5 per lane."""
    got, want = jax_and_port(fused_inputs(B, m, n, seed=m, spread=0.5), 0)
    for g, w in zip(got, want):
        assert_close_per_lane(g, w)


def test_fused_refinement_reduces_the_augmented_residual():
    """The sweeps solve the augmented system: its residual falls with each,
    as tests/test_pallas_ops.py:115-122 asks of the Pallas kernel."""
    A, Li, d, treg, regD, xi_p, xi_d = map(torch.from_numpy,
                                           fused_inputs(4, 24, 40, seed=3))
    norms = []
    for refine in (0, 2):
        dx, dy = batched_fused_k1_solve_plain(A, Li, d, treg, regD, xi_p,
                                              xi_d, refine)
        rd = xi_d - (-(treg * dx) + (A.transpose(1, 2) @ dy[..., None])[..., 0])
        rp = xi_p - ((A @ dx[..., None])[..., 0] + regD * dy)
        norms.append(max(rd.abs().max().item(), rp.abs().max().item()))
    assert norms[1] < 1e-4
    assert norms[1] <= norms[0]


def test_fused_single_instance_entry():
    args = fused_inputs(1, 20, 36, seed=9)
    one = [a[0] for a in args]
    want = jax_fused_one(*map(jnp.asarray, one), refine=1, interpret=True)
    got = fused_k1_solve(*map(torch.from_numpy, one), refine=1)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert_close_per_lane(g.numpy()[None], np.asarray(w)[None])


def test_fused_ignores_the_upper_triangle():
    A, Li, d, treg, regD, xi_p, xi_d = map(torch.from_numpy,
                                           fused_inputs(2, 8, 12, seed=4))
    noisy = Li + torch.triu(torch.full_like(Li, float("nan")), 1)
    base = batched_fused_k1_solve(A, Li, d, treg, regD, xi_p, xi_d, 1)
    got = batched_fused_k1_solve(A, noisy, d, treg, regD, xi_p, xi_d, 1)
    for g, b in zip(got, base):
        assert torch.equal(g, b)


@pytest.mark.parametrize("B,m,pack", [(5, 48, 2), (3, 20, 3), (7, 64, 2),
                                      (9, 16, 4)])
def test_packed_chol_inv_matches_pallas_packed(B, m, pack):
    """tests/test_pallas_ops.py:79's cases, against the lane-packed Pallas
    kernel in interpret mode, atol 5e-5 as there."""
    rng = np.random.default_rng(B * m)
    X = rng.standard_normal((B, m, m)).astype(np.float32)
    K = np.einsum("bij,bkj->bik", X, X) + 3 * m * np.eye(m, dtype=np.float32)
    want = np.asarray(batched_cholesky_inverse_pallas(
        jnp.asarray(K), pack=pack, interpret=True))
    before = (chol.KERNEL_LAUNCHES, chol.KERNEL_LAUNCHES_PACKED)
    got = batched_cholesky_inverse(torch.from_numpy(K), pack=pack).numpy()
    assert (chol.KERNEL_LAUNCHES, chol.KERNEL_LAUNCHES_PACKED) == before
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=0)
    assert np.all(np.triu(got, 1) == 0.0)


def test_fused_backend_single_lp_matches_pallas_interpret():
    """tests/test_pallas_ops.py:131's LP through both fused backends."""
    rng = np.random.default_rng(4)
    m, n = 10, 20
    A = rng.standard_normal((m, n))
    u = rng.uniform(1, 4, n)
    b = A @ (u * rng.uniform(0.2, 0.8, n))
    c = rng.standard_normal(n)
    raw = (A, b, c, 0.0, np.zeros(n), u)
    want = jhsd.hsd_solve(
        jdata.make_lp_data(*raw, dtype=jnp.float32),
        PallasSmallK1Backend(interpret=True, fused_solve=True,
                             refinement_steps=1),
        jhsd.HSDOptions(**BENCH_TOL))
    got = hsd_solve(make_lp_data(*raw, device="cpu", dtype=torch.float32),
                    SmallK1Backend(fused_solve=True, refinement_steps=1),
                    HSDOptions(**BENCH_TOL))
    assert int(got.status[0]) == int(want.status) == OPT
    # f32 sums run in another order in the two packages: the tolerance
    # crossing may move by one iteration.
    assert abs(int(got.niter[0]) - int(want.niter)) <= 1
    np.testing.assert_allclose(float(got.pobj[0]), float(want.pobj),
                               rtol=1e-4)


def test_fused_backend_batch_matches_pallas_interpret():
    """Each lane of the port's batch against the reference's single-LP
    solve: the reference's vmapped fused solve fails at the first
    centrality correction, whose zero right-hand side is not batched
    (``tulip_tpu/ops/solve.py:181`` asserts that every input is)."""
    raws = random_lps(5, B=4, m=8, n=16)
    jbe = PallasSmallK1Backend(interpret=True, fused_solve=True,
                               refinement_steps=1)
    outs = [jhsd.hsd_solve(jdata.make_lp_data(*r, dtype=jnp.float32), jbe,
                           jhsd.HSDOptions(**BENCH_TOL)) for r in raws]
    want = {f: np.array([np.asarray(getattr(o, f)) for o in outs])
            for f in ("status", "niter", "pobj")}
    before = solve.KERNEL_LAUNCHES
    got = batched_hsd_solve(
        SmallK1Backend(fused_solve=True, refinement_steps=1),
        HSDOptions(**BENCH_TOL),
        stack_lps_host(raws, device="cpu", dtype=torch.float32))
    assert solve.KERNEL_LAUNCHES == before
    np.testing.assert_array_equal(got.status.numpy(), want["status"])
    assert (got.status.numpy() == OPT).all()
    assert np.abs(got.niter.numpy() - want["niter"]).max() <= 1
    np.testing.assert_allclose(got.pobj.numpy(), want["pobj"], rtol=1e-4,
                               atol=0)


def test_fused_backend_unrefined_solve_is_the_unfused_base():
    """FastPredictor/FastCorrections take ``solve_unrefined``: the fused
    backend's is the unfused base solve, bit for bit."""
    raws = random_lps(6, B=3, m=6, n=12)
    dat = stack_lps_host(raws, device="cpu", dtype=torch.float32)
    fused = SmallK1Backend(fused_solve=True, refinement_steps=1)
    kkt, ok = fused.update(fused.setup_data(dat),
                           torch.rand(dat.c.shape, dtype=torch.float32),
                           torch.full_like(dat.c, 1e-6),
                           torch.full_like(dat.b, 1e-6))
    assert ok.all()
    got = fused.solve_unrefined(kkt, dat.b, dat.c)
    want = DenseK1Backend(inv_factor=True)._base_solve(kkt, dat.b, dat.c)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # The refined solve goes through the fused path and differs from the
    # unfused chain only by the accumulated Aᵀdy.
    plain = DenseK1Backend(inv_factor=True, refinement_steps=1)
    for g, w in zip(fused.solve(kkt, dat.b, dat.c),
                    plain.solve(kkt, dat.b, dat.c)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-4 * w.abs().max().item())


def test_fused_backend_f64_takes_the_unfused_path():
    raws = random_lps(7, B=2)
    dat = stack_lps_host(raws, device="cpu", dtype=torch.float64)
    kw = dict(refinement_steps=1)
    got = batched_hsd_solve(SmallK1Backend(fused_solve=True, **kw),
                            HSDOptions(), dat)
    want = batched_hsd_solve(DenseK1Backend(inv_factor=True, **kw),
                             HSDOptions(), dat)
    assert torch.equal(got.pobj, want.pobj)
    assert torch.equal(got.niter, want.niter)


@pytest.mark.parametrize("m,n,dtype,fused", [
    (8, 5000, torch.float32, True),
    (1025, 4, torch.float32, False),
    (8, 12, torch.float64, False)])
def test_fused_backend_gate_is_dtype_and_rows(monkeypatch, m, n, dtype,
                                              fused):
    """The fused solve's gate is the reference's (``pallas_chol.py:152-160``):
    float32 and m ≤ 1024, whatever n."""
    from tulip_tpu_torch.kkt import small_k1
    from tulip_tpu_torch.kkt.dense import DenseK1State

    calls = []

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return batched_fused_k1_solve(*args, **kw)

    monkeypatch.setattr(small_k1, "batched_fused_k1_solve", spy)
    g = torch.Generator().manual_seed(0)
    A = torch.randn(1, m, n, generator=g, dtype=dtype)
    vec_n = torch.rand(1, n, generator=g, dtype=dtype) + 0.5
    vec_m = torch.rand(1, m, generator=g, dtype=dtype) + 0.5
    state = DenseK1State(A=A, d=1.0 / vec_n, theta_reg=vec_n, regD=vec_m,
                         L=torch.eye(m, dtype=dtype)[None])
    dx, dy = SmallK1Backend(fused_solve=True, refinement_steps=1).solve(
        state, vec_m, vec_n)
    assert calls == ([A.shape] if fused else [])
    assert dx.shape == (1, n) and dy.shape == (1, m)
