"""Port parity of the dense K1 backend's remaining options on the CPU:
``explicit_minv`` on ``"dense"`` and ``"pallas-small"`` (the reference's
Pallas kernel in interpret mode), ``blocked_min`` and ``ops/blocked.py``
against the reference's recursion, ``matmul_precision`` (torch's flags set
inside update and solve only, and restored), and the reference's fault on
``explicit_minv`` with the fused solve."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tulip_tpu.kkt as jkkt
from test_kkt import A_np
from tulip_tpu.ops.blocked import cholesky_invfactor_blocked as jblocked
from tulip_tpu_torch.ipm.hsd import full_matmul_precision
from tulip_tpu_torch.kkt import (DenseK1Backend, GramK1Backend,
                                 SmallK1Backend)
from tulip_tpu_torch.kkt import dense as tdense
from tulip_tpu_torch.kkt.dense import f32_matmul_precision
from tulip_tpu_torch.kkt.testkit import run_ls_tests
from tulip_tpu_torch.ops.blocked import cholesky_invfactor_blocked

torch.set_num_threads(1)

F64 = (torch.float64, jnp.float64)
F32 = (torch.float32, jnp.float32)


def k1_inputs(seed, m, n, span=2.0, reg=1e-6):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, n)), 10.0 ** rng.uniform(-span, span, n),
            np.full(n, reg), np.full(m, reg), rng.standard_normal(m),
            rng.standard_normal(n))


def port_solve(be, args, dtype=torch.float64):
    A, ti, rp, rd, xp, xd = (torch.tensor(a, dtype=dtype)[None]
                             for a in args)
    st, ok = be.update(be.setup(A), ti, rp, rd)
    assert bool(ok.all())
    dx, dy = be.solve(st, xp, xd)
    return dx[0].double().numpy(), dy[0].double().numpy(), st


def ref_solve(be, args, dtype=jnp.float64):
    A, ti, rp, rd, xp, xd = (jnp.asarray(a, dtype=dtype) for a in args)
    st, ok = be.update(be.setup(A), ti, rp, rd)
    assert bool(ok)
    dx, dy = be.solve(st, xp, xd)
    return np.asarray(dx, np.float64), np.asarray(dy, np.float64), st


def rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


# -- explicit_minv ----------------------------------------------------------

@pytest.mark.parametrize("refine", [0, 1])
def test_explicit_minv_dense_f64_matches_reference(refine):
    args = k1_inputs(0, 12, 30)
    dx, dy, st = port_solve(DenseK1Backend(explicit_minv=True,
                                           refinement_steps=refine), args)
    dx_j, dy_j, st_j = ref_solve(jkkt.DenseK1Backend(
        explicit_minv=True, refinement_steps=refine), args)
    # The state holds K⁻¹, symmetric.
    np.testing.assert_allclose(st.L[0].numpy(), np.asarray(st_j.L),
                               rtol=1e-10, atol=1e-12 * np.abs(
                                   np.asarray(st_j.L)).max())
    assert rel(dx, dx_j) <= 1e-10 and rel(dy, dy_j) <= 1e-10


@pytest.mark.parametrize("backend", [
    DenseK1Backend(explicit_minv=True),
    DenseK1Backend(explicit_minv=True, refinement_steps=1),
    SmallK1Backend(explicit_minv=True),
    SmallK1Backend(explicit_minv=True, refinement_steps=1)],
    ids=["dense", "dense-r1", "pallas-small", "pallas-small-r1"])
def test_explicit_minv_conformance(backend):
    """The kit in f64, and in f32 at the reference's bars for GEMV-only
    solves (tests/test_kkt.py:108-118): 1e-2 without a sweep, the default
    10·√eps with one."""
    run_ls_tests(torch.as_tensor(A_np), backend)
    atol = None if backend.refinement_steps else 1e-2
    run_ls_tests(torch.as_tensor(A_np, dtype=torch.float32), backend,
                 atol=atol)


@pytest.mark.parametrize("dtypes", [F64, F32], ids=["f64", "f32"])
@pytest.mark.parametrize("refine", [0, 1])
def test_explicit_minv_pallas_small_matches_interpret(dtypes, refine):
    """``SmallK1Backend(explicit_minv=True)`` against the reference's
    ``PallasSmallK1Backend``: in f32 the chol-inv kernel's plain version
    against the reference's kernel in interpret mode, in f64 (which both
    send to the dense inverse-factor path; the reference's kernel takes no
    f64) within 1e-10 relative; in f32 each solve within 1e-2 of the f64 one
    without a sweep and 10·√eps with one (the reference's kit bars), and
    the two packages within the sum of their distances to it."""
    tdt, jdt = dtypes
    args = k1_inputs(1, 8, 16)
    got = port_solve(SmallK1Backend(explicit_minv=True,
                                    refinement_steps=refine), args, tdt)
    want = ref_solve(jkkt.PallasSmallK1Backend(
        interpret=tdt == torch.float32, explicit_minv=True,
        refinement_steps=refine), args, jdt)
    if tdt == torch.float64:
        assert rel(got[0], want[0]) <= 1e-10 and rel(got[1], want[1]) <= 1e-10
        return
    exact = port_solve(DenseK1Backend(refinement_steps=2), args)
    bar = 10 * np.sqrt(np.finfo(np.float32).eps) if refine else 1e-2
    for k in (0, 1):
        e_t, e_j = rel(got[k], exact[k]), rel(want[k], exact[k])
        assert e_t <= bar and e_j <= bar, (e_t, e_j)
        assert rel(got[k], want[k]) <= e_t + e_j + 1e-6


def test_explicit_minv_refuses_the_fused_solve():
    with pytest.raises(ValueError, match="fused"):
        SmallK1Backend(explicit_minv=True, fused_solve=True)
    with pytest.raises(ValueError, match="explicit_minv"):
        GramK1Backend(explicit_minv=True)


def test_reference_explicit_minv_with_fused_solve_is_wrong():
    """The reference's fault (ROADMAP queue 3): its
    ``PallasSmallK1Backend(fused_solve=True, explicit_minv=True)`` stores
    K⁻¹ but hands it to the fused kernel as L⁻¹, so it solves with K⁻²:
    dy lands far off the dense solve, while the other three combinations
    of the two flags agree with it. The port refuses that combination."""
    args = k1_inputs(2, 8, 16)
    _, dy_ref, _ = ref_solve(jkkt.DenseK1Backend(), args)
    dys = {}
    for fused in (False, True):
        for minv in (False, True):
            be = jkkt.PallasSmallK1Backend(interpret=True, fused_solve=fused,
                                           explicit_minv=minv)
            dys[fused, minv] = ref_solve(be, args, jnp.float32)[1]
    for key, dy in dys.items():
        if key == (True, True):
            assert rel(dy, dy_ref) > 0.1, dy[:3]
        else:
            assert rel(dy, dy_ref) <= 1e-3, (key, dy[:3])


def chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_explicit_minv_one_sweep_tail_lanes_are_rounding():
    """With one sweep in f32, ``explicit_minv`` leaves tail lanes that
    reach the iteration limit or not with the rounding, in both packages:
    lane 227 of chip_smoke.py's instances of seed 3 solves alone in the
    reference and fails beside lane 226 (a batch rounds its products
    otherwise), and the port's does the reverse. Two sweeps solve it in
    either. chip_smoke.py's phase 11b holds the one-sweep run to OPTIMAL
    or ITERATION_LIMIT, with at most ``ONE_SWEEP_TAIL_MAX`` lanes at the
    limit, for that reason."""
    from tulip_tpu.ipm import batch as jbatch
    from tulip_tpu.ipm import data as jdata
    from tulip_tpu.ipm import hsd as jhsd
    from tulip_tpu_torch.ipm.batch import batched_hsd_solve, stack_lps_host
    from tulip_tpu_torch.ipm.hsd import HSDOptions

    smoke = chip_smoke()
    raws = smoke.make_raw_instances(228, 48, 96, seed=3)
    tol = dict(TolerancePFeas=3e-4, ToleranceDFeas=3e-4, ToleranceRGap=3e-4,
               ToleranceIFeas=3e-4, PRegMin=1e-6, DRegMin=1e-6)
    got = {}
    for lanes in ([227], [226, 227]):
        probs = [(A, b, c, 0.0, np.zeros(len(c)), u)
                 for (A, b, c, u) in (raws[k] for k in lanes)]
        for refine in (1, 2):
            jd = jbatch.stack_lps([jdata.make_lp_data(*p, dtype=jnp.float32)
                                   for p in probs])
            ref = jbatch.batched_hsd_solve(jkkt.PallasSmallK1Backend(
                explicit_minv=True, refinement_steps=refine),
                jhsd.HSDOptions(**tol), jd)
            port = batched_hsd_solve(
                SmallK1Backend(explicit_minv=True, refinement_steps=refine),
                HSDOptions(**tol), stack_lps_host(probs, device="cpu",
                                                  dtype=torch.float32))
            got[len(lanes), refine] = (int(np.asarray(ref.status)[-1]),
                                       int(port.status[-1]))
    opt, lim = smoke.OPTIMAL, smoke.ITERATION_LIMIT
    assert got == {(1, 1): (opt, lim), (2, 1): (lim, opt),
                   (1, 2): (opt, opt), (2, 2): (opt, opt)}, got


# -- blocked_min and ops/blocked.py ------------------------------------------

@pytest.mark.parametrize("m", [96, 130, 257])
def test_blocked_invfactor_matches_reference_recursion(m):
    """``cholesky_invfactor_blocked`` against the reference's recursion at
    leaf 64 (tests/test_kkt.py:550-574); ``leaf`` is unused in the port."""
    rng = np.random.default_rng(11)
    G = rng.standard_normal((m, m))
    K = G @ G.T + m * np.eye(m)
    L, X = cholesky_invfactor_blocked(torch.as_tensor(K)[None], leaf=64)
    Lj, Xj = jblocked(jnp.asarray(K), leaf=64)
    assert rel(L[0].numpy(), np.asarray(Lj)) <= 1e-10
    assert rel(X[0].numpy(), np.asarray(Xj)) <= 1e-10
    assert torch.equal(torch.triu(X, 1), torch.zeros_like(X))


def test_blocked_invfactor_nan_on_non_spd_lane():
    K = torch.stack([torch.eye(96, dtype=torch.float64),
                     -torch.eye(96, dtype=torch.float64)])
    L, X = cholesky_invfactor_blocked(K)
    finite = [bool(torch.isfinite(t).all()) for t in (L[0], X[0], L[1], X[1])]
    assert finite == [True, True, False, False]


@pytest.mark.parametrize("explicit_minv", [False, True])
def test_blocked_min_matches_reference_blocked_path(explicit_minv):
    """m = 96 with ``blocked_min=64``: the reference's update goes through
    its ``ops/blocked.py`` recursion, and the port's refined solves agree
    with it within 1e-10, with either ``blocked_min``."""
    args = k1_inputs(12, 96, 150)
    kw = dict(inv_factor=not explicit_minv, explicit_minv=explicit_minv,
              blocked_min=64, refinement_steps=1)
    dx_j, dy_j, _ = ref_solve(jkkt.DenseK1Backend(**kw), args)
    for blocked_min in (64, 4096):
        dx, dy, _ = port_solve(
            DenseK1Backend(**{**kw, "blocked_min": blocked_min}), args)
        assert rel(dx, dx_j) <= 1e-10 and rel(dy, dy_j) <= 1e-10


def test_blocked_path_keeps_a_failed_lane_apart():
    """A lane whose K is not SPD reports failure and gets the identity, the
    other lane its L⁻¹, as on the unblocked path."""
    A = torch.as_tensor(np.random.default_rng(3).standard_normal((2, 4, 9)))
    be = DenseK1Backend(inv_factor=True, blocked_min=2)
    theta = torch.ones(2, 9, dtype=torch.float64)
    regD = torch.tensor([[1e-6] * 4, [-1e6] * 4], dtype=torch.float64)
    st, ok = be.update(be.setup(A), theta, theta * 0, regD)
    ref, ok_ref = DenseK1Backend(inv_factor=True).update(
        be.setup(A), theta, theta * 0, regD)
    assert ok.tolist() == ok_ref.tolist() == [True, False]
    assert torch.equal(st.L[1], torch.eye(4, dtype=torch.float64))
    torch.testing.assert_close(st.L[0], ref.L[0], rtol=1e-12, atol=1e-12)


# -- matmul_precision ---------------------------------------------------------

@pytest.mark.parametrize("name,mode", [
    ("highest", "ieee"), ("float32", "ieee"), ("high", "tf32x3"),
    ("bfloat16_3x", "tf32x3"), ("tensorfloat32", "tf32x3"),
    ("default", "tf32"), ("bfloat16", "tf32")])
def test_matmul_precision_holds_inside_update_and_solve(name, mode,
                                                        monkeypatch):
    """Inside update and solve torch's CUDA f32 matmul flag is the named
    mode's (TF32 for ``"tf32"`` only; ``"tf32x3"`` sets it inside its split
    products alone), innermost over the IPM's pin, and the Gram matrix is
    asked for in that mode; outside, the caller's setting, restored. The
    results on a CPU tensor are the bits of the backend without the
    option."""
    seen = []
    real_nm, real_bmv = tdense.normal_matrix, tdense.bmv

    def nm(*a):
        seen.append(("update", torch.backends.cuda.matmul.allow_tf32, a[3]))
        return real_nm(*a)

    def mv(*a):
        seen.append(("solve", torch.backends.cuda.matmul.allow_tf32))
        return real_bmv(*a)

    monkeypatch.setattr(tdense, "normal_matrix", nm)
    monkeypatch.setattr(tdense, "bmv", mv)
    args = k1_inputs(4, 6, 12)
    be = DenseK1Backend(matmul_precision=name, refinement_steps=1)
    with full_matmul_precision():
        got = port_solve(be, args)
        assert torch.backends.cuda.matmul.allow_tf32 is False
    tf32 = mode == "tf32"
    assert set(seen) == {("update", tf32, mode), ("solve", tf32)}
    seen.clear()
    want = port_solve(DenseK1Backend(refinement_steps=1), args)
    assert {s[1] for s in seen} == {
        torch.backends.cuda.matmul.allow_tf32}
    assert all(np.array_equal(g, w) for g, w in zip(got[:2], want[:2]))


def test_tf32_split_is_exact_and_cut_to_tf32():
    """``hi`` keeps TF32's 10 mantissa bits (its low 13 are zero) and
    ``hi + lo`` is the input bit for bit, over a wide range of exponents
    and signs."""
    rng = np.random.default_rng(7)
    a = torch.as_tensor((rng.standard_normal((40, 50))
                         * 10.0 ** rng.uniform(-30, 30, (40, 50))
                         ).astype(np.float32))
    hi, lo = tdense.tf32_split(a)
    assert not bool((hi.view(torch.int32) & 8191).any())
    assert torch.equal(hi + lo, a)
    assert bool((lo.abs() <= a.abs() * 2.0 ** -10).all())


def test_three_tf32_products_reach_f32():
    """The split's arithmetic, ``hi·lo + lo·hi + hi·hi`` with ``lo·lo``
    dropped, lies within f32's own rounding of the product: here its
    products run in IEEE f32, as :func:`gemm` runs them on a CPU tensor
    (where it returns the plain product, bit for bit)."""
    rng = np.random.default_rng(8)
    a64, b64 = rng.standard_normal((64, 300)), rng.standard_normal((300, 48))
    a = torch.as_tensor(a64.astype(np.float32))
    b = torch.as_tensor(b64.astype(np.float32))
    exact = a.double() @ b.double()
    ah, al = tdense.tf32_split(a)
    bh, bl = tdense.tf32_split(b)
    split = (ah @ bl + al @ bh) + ah @ bh
    plain_err = (a @ b - exact).abs().max().item()
    assert (split - exact).abs().max().item() <= 4 * plain_err
    assert torch.equal(tdense.gemm(a, b, "tf32x3"), a @ b)


def test_matmul_precision_restores_on_an_exception(monkeypatch):
    def boom(*a):
        raise RuntimeError("boom")

    monkeypatch.setattr(tdense, "normal_matrix", boom)
    before = torch.backends.cuda.matmul.allow_tf32
    be = DenseK1Backend(matmul_precision="high" if not before else "highest")
    with pytest.raises(RuntimeError, match="boom"):
        port_solve(be, k1_inputs(4, 6, 12))
    assert torch.backends.cuda.matmul.allow_tf32 is before
    with pytest.raises(RuntimeError, match="boom"):
        with f32_matmul_precision("bfloat16"):
            raise RuntimeError("boom")
    assert torch.backends.cuda.matmul.allow_tf32 is before


def test_matmul_precision_rejects_unknown_names():
    for make in (DenseK1Backend, SmallK1Backend, GramK1Backend):
        with pytest.raises(ValueError, match="matmul precision"):
            make(matmul_precision="fastest")
    with pytest.raises(ValueError, match="matmul precision"):
        with f32_matmul_precision("fp8"):
            pass
    with f32_matmul_precision(None):
        pass
