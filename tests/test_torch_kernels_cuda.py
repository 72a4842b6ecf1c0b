"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Marked ``cuda``; without a CUDA device every test skips. Run on a
GPU machine with ``python -m pytest tests/test_torch_kernels_cuda.py -n 0``."""

from pathlib import Path

import numpy as np
import pytest
import torch

from tulip_tpu_torch.ops import chol, gram, solve
from tulip_tpu_torch.ops.chol import (batched_cholesky_inverse,
                                      batched_cholesky_inverse_plain)
from tulip_tpu_torch.ops.gram import scaled_gram, scaled_gram_plain
from tulip_tpu_torch.ops.solve import (batched_fused_k1_solve,
                                       batched_fused_k1_solve_plain)

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def spd_batch(B, m, seed, device):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B, m, m))
    K = np.einsum("bij,bkj->bik", X, X) + m * np.eye(m)
    return torch.as_tensor(K, dtype=torch.float32, device=device)


@pytest.mark.parametrize("B,m", [(1, 8), (3, 31), (3, 32), (3, 33),
                                 (7, 48), (5, 63), (64, 64), (5, 65),
                                 (4, 97), (5, 100), (2, 223), (3, 224),
                                 (4, 256), (2, 1024)])
def test_chol_inv_kernel_matches_plain(cuda, B, m):
    K = spd_batch(B, m, seed=m, device=cuda)
    before = chol.KERNEL_LAUNCHES
    got = batched_cholesky_inverse(K)
    torch.cuda.synchronize()
    assert chol.KERNEL_LAUNCHES == before + 1
    want = batched_cholesky_inverse_plain(K)
    assert torch.equal(torch.triu(got, 1), torch.zeros_like(got))
    # f32 with another summation order and FMA contraction than the
    # library factorization: absolute bar at small m, relative Frobenius
    # above, where entries of L⁻¹ span more magnitudes.
    if m <= 100:
        assert (got - want).abs().max().item() <= 1e-4
    else:
        rel = (torch.linalg.matrix_norm(got - want)
               / torch.linalg.matrix_norm(want)).max().item()
        assert rel <= 1e-4


def test_chol_inv_kernel_nonspd_lane(cuda):
    K = spd_batch(6, 48, seed=1, device=cuda)
    K[4] = -K[4]
    got = batched_cholesky_inverse(K)
    finite = torch.isfinite(got).all(-1).all(-1).tolist()
    assert finite == [True, True, True, True, False, True]


@pytest.mark.parametrize("pack", [0, 4])
@pytest.mark.parametrize("m", [48, 100])
def test_chol_inv_kernel_nonspd_past_first_panel(cuda, m, pack):
    """A lane whose leading 40 x 40 block is SPD and whose pivot 40 is
    negative fails in the second panel, past the identity rows that pad a
    ragged panel: non-finite alone, unpacked and packed."""
    K = spd_batch(6, m, seed=m, device=cuda)
    K[2, 40, 40] = -1.0
    got = batched_cholesky_inverse(K, pack=pack)
    finite = torch.isfinite(got).all(-1).all(-1).tolist()
    assert finite == [True, True, False, True, True, True]
    good = [0, 1, 3, 4, 5]
    want = batched_cholesky_inverse_plain(K[good])
    assert (got[good] - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("m", [225, 256, 300, 512, 1000, 1024])
def test_blocked_chol_inv_matches_plain(cuda, B, m):
    """The blocked path (m > 224, every m and not only the buckets' 256,
    512 and 1024): within 1e-4 relative Frobenius of the plain version per
    instance, exact zeros above the diagonal; with B = 3 the middle
    instance is not positive definite and is non-finite alone."""
    K = spd_batch(B, m, seed=B + m, device=cuda)
    if B == 3:
        K[1] = -K[1]
    before = (chol.KERNEL_LAUNCHES, chol.KERNEL_LAUNCHES_BLOCKED)
    got = batched_cholesky_inverse(K)
    torch.cuda.synchronize()
    assert (chol.KERNEL_LAUNCHES, chol.KERNEL_LAUNCHES_BLOCKED) == (
        before[0] + 1, before[1] + 1)
    assert (B, m, 1) in chol.SHAPES
    good = [0, 2] if B == 3 else [0]
    finite = torch.isfinite(got).all(-1).all(-1).tolist()
    assert finite == [b in good for b in range(B)]
    assert torch.equal(torch.triu(got, 1), torch.zeros_like(got))
    want = batched_cholesky_inverse_plain(K[good])
    rel = (torch.linalg.matrix_norm(got[good] - want)
           / torch.linalg.matrix_norm(want)).max().item()
    assert rel <= 1e-4


def test_blocked_chol_inv_zero_pivot(cuda):
    """A zero pivot (1 / sqrt(0) = inf) also ends non-finite, in its own
    instance only."""
    K = spd_batch(2, 320, seed=5, device=cuda)
    K[0, 40, :] = 0.0
    K[0, :, 40] = 0.0
    got = batched_cholesky_inverse(K)
    assert torch.isfinite(got).all(-1).all(-1).tolist() == [False, True]


def test_shared_range_does_not_count_as_blocked(cuda):
    before = chol.KERNEL_LAUNCHES_BLOCKED
    batched_cholesky_inverse(spd_batch(2, 224, seed=6, device=cuda))
    assert chol.KERNEL_LAUNCHES_BLOCKED == before


def test_chol_inv_kernel_refuses(cuda):
    K = spd_batch(2, 16, seed=2, device=cuda)
    with pytest.raises(TypeError):
        batched_cholesky_inverse(K.double())
    with pytest.raises(ValueError):
        batched_cholesky_inverse(K.transpose(0, 2))
    with pytest.raises(ValueError):
        batched_cholesky_inverse(torch.zeros(1, 1025, 1025, device=cuda))


def test_small_k1_solve_on_card_uses_kernel(cuda):
    from tulip_tpu_torch.ipm.batch import batched_hsd_solve, stack_lps_host
    from tulip_tpu_torch.ipm.hsd import HSDOptions
    from tulip_tpu_torch.kkt import SmallK1Backend
    from tulip_tpu_torch.status import TerminationStatus

    rng = np.random.default_rng(0)
    raws = []
    for _ in range(16):
        A = rng.standard_normal((12, 24))
        u = rng.uniform(1, 4, 24)
        raws.append((A, A @ (u * rng.uniform(0.2, 0.8, 24)),
                     rng.standard_normal(24), 0.0, np.zeros(24), u))
    dats = stack_lps_host(raws, device=cuda, dtype=torch.float32)
    opts = HSDOptions(TolerancePFeas=3e-4, ToleranceDFeas=3e-4,
                      ToleranceRGap=3e-4, ToleranceIFeas=3e-4,
                      PRegMin=1e-6, DRegMin=1e-6)
    before = chol.KERNEL_LAUNCHES
    out = batched_hsd_solve(SmallK1Backend(refinement_steps=1), opts, dats)
    assert chol.KERNEL_LAUNCHES > before
    assert (out.status == int(TerminationStatus.OPTIMAL)).all().item()


def gram_inputs(B, m, n, seed, device):
    rng = np.random.default_rng(seed)
    A = torch.as_tensor(rng.standard_normal((B, m, n)), dtype=torch.float32,
                        device=device)
    d = torch.as_tensor(10.0 ** rng.uniform(-3, 3, (B, n)),
                        dtype=torch.float32, device=device)
    return A, d


@pytest.mark.parametrize("B,m,n", [(1, 1, 1), (1, 37, 200), (3, 300, 520),
                                   (2, 129, 7), (2, 1000, 1500),
                                   (1, 130, 70), (2, 257, 1000),
                                   (1, 4096, 6240)])
def test_scaled_gram_kernel_matches_plain(cuda, B, m, n):
    A, d = gram_inputs(B, m, n, seed=m, device=cuda)
    before = gram.KERNEL_LAUNCHES
    got = scaled_gram(A, d)
    torch.cuda.synchronize()
    assert gram.KERNEL_LAUNCHES == before + 1
    want = scaled_gram_plain(A, d)
    # The kernel mirrors its lower tiles: K is exactly symmetric.
    assert torch.equal(got, got.transpose(-1, -2))
    # Three TF32 products per term summed in f32 in another order than
    # cuBLAS's, per lane.
    err = (got - want).abs().amax(dim=(-1, -2))
    assert (err <= 1e-5 * want.abs().amax(dim=(-1, -2))).all()


def test_scaled_gram_kernel_takes_an_unaligned_view(cuda):
    """A and d that start off a 16-byte boundary go through the kernel's
    4-byte copies."""
    A, d = gram_inputs(1, 70, 129, seed=4, device=cuda)
    A1, d1 = A.flatten()[1:1 + 69 * 128], d.flatten()[1:129]
    A1, d1 = A1.view(1, 69, 128), d1.view(1, 128)
    got = scaled_gram(A1, d1)
    want = scaled_gram_plain(A1, d1)
    assert torch.equal(got, got.transpose(-1, -2))
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_scaled_gram_kernel_refuses(cuda):
    A, d = gram_inputs(2, 16, 24, seed=3, device=cuda)
    with pytest.raises(TypeError):
        scaled_gram(A.double(), d.double())
    with pytest.raises(ValueError):
        scaled_gram(A.transpose(1, 2).contiguous().transpose(1, 2), d)
    with pytest.raises(ValueError):
        scaled_gram(A, d[:, :-1])


def test_dense_pallas_model_on_card_uses_kernel(cuda):
    from tulip_tpu_torch import Model, get_attribute, read_mps
    from tulip_tpu_torch.status import TerminationStatus

    m = Model(device=cuda)
    m.pbdata = read_mps(str(Path(__file__).resolve().parent / "data"
                            / "lp_opt.mps"))
    m.params.ArithmeticDtype = "float32"
    m.params.KKT.Backend = "dense-pallas"
    before = gram.KERNEL_LAUNCHES
    assert m.optimize() == TerminationStatus.OPTIMAL
    assert gram.KERNEL_LAUNCHES > before
    assert abs(get_attribute(m, "ObjectiveValue") - 1.5) <= 1e-3


@pytest.mark.parametrize("p", [2, 3, 4])
@pytest.mark.parametrize("B,m", [(7, 16), (9, 48), (2048, 48), (5, 64),
                                 (4, 65), (6, 100), (5, 160), (3, 300)])
def test_packed_chol_inv_matches_unpacked_and_plain(cuda, B, m, p):
    """p instances per block give the unpacked launch's output bit for bit
    (the same kernel body per instance, on groups of one warp up to m = 64,
    4 up to 128 and 8 above) and agree with the plain version. At m = 300
    the launcher lowers p to 1: the unpacked device-memory launch."""
    K = spd_batch(B, m, seed=B + m, device=cuda)
    one = batched_cholesky_inverse(K)
    before = (chol.KERNEL_LAUNCHES, chol.KERNEL_LAUNCHES_PACKED)
    got = batched_cholesky_inverse(K, pack=p)
    torch.cuda.synchronize()
    packed = m <= 224
    assert (chol.KERNEL_LAUNCHES, chol.KERNEL_LAUNCHES_PACKED) == (
        before[0] + (not packed), before[1] + packed)
    assert torch.equal(got, one)
    want = batched_cholesky_inverse_plain(K)
    if m <= 100:
        assert (got - want).abs().max().item() <= 1e-4
    else:
        rel = (torch.linalg.matrix_norm(got - want)
               / torch.linalg.matrix_norm(want)).max().item()
        assert rel <= 1e-4


@pytest.mark.parametrize("m", [16, 48])
def test_packed_chol_inv_nonspd_lane(cuda, m):
    """A non-SPD instance inside a packed block fails alone."""
    K = spd_batch(8, m, seed=2, device=cuda)
    K[5] = -K[5]
    finite = torch.isfinite(batched_cholesky_inverse(K, pack=4)) \
        .all(-1).all(-1).tolist()
    assert finite == [True] * 5 + [False] + [True] * 2


def fused_inputs(B, m, n, seed, device):
    """treg spanning 10^±2, regD 1e-4, Li = L⁻¹ of K = A D Aᵀ + diag(regD)
    (plain chol-inv in f64 on the card), random right-hand sides."""
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    A = t(rng.standard_normal((B, m, n)))
    treg = t(10.0 ** rng.uniform(-2, 2, (B, n)))
    d = 1.0 / treg
    regD = torch.full((B, m), 1e-4, device=device)
    xi_p = t(rng.standard_normal((B, m)))
    xi_d = t(rng.standard_normal((B, n)))
    A64 = A.double()
    K = (A64 * d.double()[:, None, :]) @ A64.transpose(1, 2) \
        + torch.diag_embed(regD.double())
    Li = batched_cholesky_inverse_plain(K).float()
    return A, Li, d, treg, regD, xi_p, xi_d


def staged(m, n):
    """Whether an (m, n) instance takes the fused kernel's staged layout:
    8 n-long and 7 m-long vectors, A and Li's lower triangle in the shared
    memory a block may opt in to (227 KB on an H100)."""
    optin = getattr(torch.cuda.get_device_properties(0),
                    "shared_memory_per_block_optin", 232448)
    return (8 * n + 7 * m + m * n + m * (m + 1) // 2) * 4 <= optin


def hold_fused(got, args, refine):
    """The plain-version bars of test_fused_solve_kernel_matches_plain."""
    want = batched_fused_k1_solve_plain(*args, refine=refine)
    exact = batched_fused_k1_solve_plain(*[a.double() for a in args],
                                         refine=refine)
    for g, w, e in zip(got, want, exact):
        scale = e.abs().amax(-1).clamp_min(1.0)
        err_k = ((g.double() - e).abs().amax(-1) / scale).max().item()
        err_p = ((w.double() - e).abs().amax(-1) / scale).max().item()
        if refine:
            assert ((g - w).abs().amax(-1) <= 1e-4 * scale.float()).all()
        else:
            assert err_k <= 2 * err_p + 1e-6, (err_k, err_p)


# (48, 1010) is the widest instance at m = 48 that the staged layout takes
# (by 4-byte copies: n is not a multiple of 4), (48, 1008) the widest it
# loads by bulk copies, (48, 1011) the narrowest read from device memory.
@pytest.mark.parametrize("refine", [0, 1])
@pytest.mark.parametrize("B,m,n", [(2048, 48, 96), (7, 48, 96),
                                   (4, 256, 512), (1, 1024, 2048),
                                   (2, 64, 8192), (5, 45, 91), (3, 13, 7),
                                   (2, 48, 1008), (2, 48, 1010),
                                   (2, 48, 1011)])
def test_fused_solve_kernel_matches_plain(cuda, B, m, n, refine):
    """Per lane, against max(1, max|exact|), exact being the plain version
    in f64 on the same inputs: with a sweep, the kernel within 1e-4 of the
    plain version in f32 (f32 products summed in another order than
    cuBLAS's); without one, where the factor's conditioning amplifies f32
    rounding, the kernel's worst lane at most twice as far from exact as
    the plain f32 version's (+1e-6). At n = 8192 the n-long vectors do not
    fit in shared memory and live in device memory. A staged instance with
    m and n multiples of 4 loads by bulk copies, any other by 4-byte
    copies."""
    args = fused_inputs(B, m, n, seed=m + refine, device=cuda)
    counts = (solve.KERNEL_LAUNCHES, solve.STREAMED_LAUNCHES,
              solve.WIDE_LAUNCHES, solve.BULK_LAUNCHES)
    got = batched_fused_k1_solve(*args, refine=refine)
    torch.cuda.synchronize()
    streamed, wide = not staged(m, n), n > 4096
    bulk = not streamed and m % 4 == 0 and n % 4 == 0
    assert (solve.KERNEL_LAUNCHES, solve.STREAMED_LAUNCHES,
            solve.WIDE_LAUNCHES, solve.BULK_LAUNCHES) == (
        counts[0] + 1, counts[1] + streamed, counts[2] + wide,
        counts[3] + bulk)
    hold_fused(got, args, refine)


def offset_views(args, k=1):
    """Each input copied into a buffer k floats longer and viewed from its
    k-th float: contiguous views whose data starts off 16 bytes for k = 1."""
    out = []
    for t in args:
        buf = torch.empty(t.numel() + k, dtype=t.dtype, device=t.device)
        view = buf[k:].view(t.shape)
        view.copy_(t)
        out.append(view)
    return out


@pytest.mark.parametrize("refine", [0, 1])
def test_fused_solve_kernel_takes_offset_views(cuda, refine):
    """Inputs that are views with a storage offset take the staged layout's
    4-byte copies and give the bulk-copied launch's output bit for bit; an
    A cut from a larger batch with m·n odd (A_big[1:]) as well."""
    args = fused_inputs(3, 48, 96, seed=9, device=cuda)
    bulk = solve.BULK_LAUNCHES
    want = batched_fused_k1_solve(*args, refine=refine)
    assert solve.BULK_LAUNCHES == bulk + 1
    got = batched_fused_k1_solve(*offset_views(args), refine=refine)
    torch.cuda.synchronize()
    assert solve.BULK_LAUNCHES == bulk + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    hold_fused(got, args, refine)

    big = fused_inputs(4, 45, 91, seed=10, device=cuda)
    cut = [t[1:] for t in big]
    assert cut[0].storage_offset() % 4 == 45 * 91 % 4 == 3
    got = batched_fused_k1_solve(*cut, refine=refine)
    hold_fused(got, cut, refine)


def test_fused_backend_takes_the_kernel_at_any_n(cuda):
    """The fused backend's gate is the reference's (f32, m <= 1024): an
    instance with n > 4096 goes to the kernel, its n-long vectors in
    device memory."""
    from tulip_tpu_torch.kkt import SmallK1Backend
    from tulip_tpu_torch.kkt.dense import DenseK1State

    A, Li, d, treg, regD, xi_p, xi_d = fused_inputs(2, 32, 8192, seed=8,
                                                    device=cuda)
    state = DenseK1State(A=A, d=d, theta_reg=treg, regD=regD, L=Li)
    be = SmallK1Backend(fused_solve=True, refinement_steps=1)
    counts = (solve.KERNEL_LAUNCHES, solve.WIDE_LAUNCHES)
    dx, dy = be.solve(state, xi_p, xi_d)
    torch.cuda.synchronize()
    assert (solve.KERNEL_LAUNCHES, solve.WIDE_LAUNCHES) == (counts[0] + 1,
                                                            counts[1] + 1)
    want = batched_fused_k1_solve_plain(A, Li, d, treg, regD, xi_p, xi_d, 1)
    for g, w in zip((dx, dy), want):
        scale = w.abs().amax(-1).clamp_min(1.0)
        assert ((g - w).abs().amax(-1) <= 1e-4 * scale).all()


@pytest.mark.parametrize("m,n,offset", [(48, 96, 0), (48, 96, 1),
                                        (45, 91, 0), (13, 7, 0)])
def test_fused_solve_kernel_nonfinite_lane(cuda, m, n, offset):
    """In the staged layout by bulk copies, by 4-byte copies of offset
    views, and at ragged shapes."""
    args = fused_inputs(6, m, n, seed=3, device=cuda)
    if offset:
        args = offset_views(args, offset)
    A, Li, d, treg, regD, xi_p, xi_d = args
    A[2, 5, min(7, n - 1)] = float("nan")
    dx, dy = batched_fused_k1_solve(A, Li, d, treg, regD, xi_p, xi_d, 1)
    ok = (torch.isfinite(dx).all(-1) & torch.isfinite(dy).all(-1)).tolist()
    assert ok == [True, True, False, True, True, True]


@pytest.mark.parametrize("m,n", [(48, 96), (45, 91), (48, 1008)])
def test_fused_staged_body_does_not_spill(cuda, m, n):
    """The staged body's launches keep every value in registers (no local
    memory) and fit at least one instance an SM."""
    import ctypes

    from tulip_tpu_torch import _build

    fn = _build.load("fused_solve").tulip_fused_k1_solve_occupancy
    for bulk in ([0, 1] if m % 4 == 0 and n % 4 == 0 else [0]):
        vals = [ctypes.c_int(0) for _ in range(4)]
        assert fn(m, n, bulk, 0, *map(ctypes.byref, vals)) == 0
        regs, local, blocks, threads = (v.value for v in vals)
        assert local == 0 and blocks >= 1 and regs <= 255, (bulk, regs,
                                                            local, blocks)


def test_fused_solve_kernel_refuses(cuda):
    args = list(fused_inputs(2, 16, 24, seed=4, device=cuda))
    with pytest.raises(TypeError):
        batched_fused_k1_solve(*[a.double() for a in args])
    with pytest.raises(ValueError):
        batched_fused_k1_solve(args[0], args[1], args[2], args[3],
                               args[4][:, :-1], args[5], args[6])
    with pytest.raises(ValueError):
        batched_fused_k1_solve(args[0].transpose(1, 2).contiguous()
                               .transpose(1, 2), *args[1:])


def test_fused_backend_on_card_uses_both_kernels(cuda):
    from tulip_tpu_torch.ipm.batch import (batched_hsd_resolve,
                                           batched_hsd_solve, stack_lps_host)
    from tulip_tpu_torch.ipm.hsd import HSDOptions
    from tulip_tpu_torch.kkt import SmallK1Backend
    from tulip_tpu_torch.status import TerminationStatus

    rng = np.random.default_rng(0)
    raws = []
    for _ in range(16):
        A = rng.standard_normal((12, 24))
        u = rng.uniform(1, 4, 24)
        raws.append((A, A @ (u * rng.uniform(0.2, 0.8, 24)),
                     rng.standard_normal(24), 0.0, np.zeros(24), u))
    dats = stack_lps_host(raws, device=cuda, dtype=torch.float32)
    opts = HSDOptions(TolerancePFeas=3e-4, ToleranceDFeas=3e-4,
                      ToleranceRGap=3e-4, ToleranceIFeas=3e-4,
                      PRegMin=1e-6, DRegMin=1e-6)
    be = SmallK1Backend(refinement_steps=1, fused_solve=True, pack=4)
    before = (solve.KERNEL_LAUNCHES, chol.KERNEL_LAUNCHES_PACKED)
    out = batched_hsd_solve(be, opts, dats)
    assert solve.KERNEL_LAUNCHES > before[0]
    assert chol.KERNEL_LAUNCHES_PACKED > before[1]
    assert (out.status == int(TerminationStatus.OPTIMAL)).all().item()
    warm = batched_hsd_resolve(be, opts, dats, out)
    assert (warm.status == int(TerminationStatus.OPTIMAL)).all().item()


def bf16_close(got, want):
    """Two float32 results a few ulps apart, each rounded to bfloat16:
    equal but where they straddle a rounding boundary (one bfloat16 ulp,
    at most 2⁻⁷ relative), or where the float32 values themselves are
    tiny against the largest entry."""
    got, want = got.float(), want.float()
    return bool(((got - want).abs() <= 2.0 ** -7 * want.abs()
                 + 1e-4 * want.abs().max()).all())


def test_bf16_kernel_launches_match_plain_rounded(cuda):
    """bfloat16 input: the kernels run in float32 on an upcast copy and
    round their result, held against the plain version rounded the same
    way."""
    K = spd_batch(5, 48, seed=9, device=cuda).bfloat16()
    before = chol.KERNEL_LAUNCHES
    got = batched_cholesky_inverse(K)
    assert chol.KERNEL_LAUNCHES == before + 1 and got.dtype == torch.bfloat16
    assert bf16_close(got, batched_cholesky_inverse_plain(K.float())
                      .bfloat16())
    A, d = (t.bfloat16() for t in gram_inputs(2, 64, 96, seed=9,
                                              device=cuda))
    before = gram.KERNEL_LAUNCHES
    got = scaled_gram(A, d)
    assert gram.KERNEL_LAUNCHES == before + 1 and got.dtype == torch.bfloat16
    assert bf16_close(got, scaled_gram_plain(A.float(), d.float())
                      .bfloat16())


@pytest.mark.parametrize("name", ["pallas-small", "pallas-small-fused",
                                  "dense-pallas"])
def test_bf16_backends_on_card_use_their_kernels(cuda, name):
    """The reference's two kernel backends take bfloat16
    (pallas_chol.py:115,176); so do the port's, through their kernels,
    against the same backend on CPU tensors (the plain versions, rounded
    the same way)."""
    from tulip_tpu_torch.kkt import GramK1Backend, SmallK1Backend

    be = {"pallas-small": SmallK1Backend(refinement_steps=1),
          "pallas-small-fused": SmallK1Backend(refinement_steps=1,
                                               fused_solve=True),
          "dense-pallas": GramK1Backend(refinement_steps=1)}[name]
    rng = np.random.default_rng(10)
    B, m, n = 4, 24, 48
    host = [rng.standard_normal((B, m, n)), 10.0 ** rng.uniform(-1, 1, (B, n)),
            np.full((B, n), 1e-2), np.full((B, m), 1e-2),
            rng.standard_normal((B, m)), rng.standard_normal((B, n))]
    out = {}
    for dev in (cuda, torch.device("cpu")):
        A, th, rP, rD, xp, xd = (torch.as_tensor(a, dtype=torch.bfloat16,
                                                 device=dev) for a in host)
        counts = (chol.KERNEL_LAUNCHES, gram.KERNEL_LAUNCHES,
                  solve.KERNEL_LAUNCHES)
        st, ok = be.update(be.setup(A), th, rP, rD)
        dx, dy = be.solve(st, xp, xd)
        torch.cuda.synchronize()
        launched = [a > b for a, b in zip((chol.KERNEL_LAUNCHES,
                                           gram.KERNEL_LAUNCHES,
                                           solve.KERNEL_LAUNCHES), counts)]
        assert ok.all().item() and dx.dtype == dy.dtype == torch.bfloat16
        out[dev.type] = (dx.cpu(), dy.cpu(), launched)
    want = {"pallas-small": [True, False, False],
            "pallas-small-fused": [True, False, True],
            "dense-pallas": [False, True, False]}[name]
    assert out["cuda"][2] == want and out["cpu"][2] == [False] * 3
    for got, ref in zip(out["cuda"][:2], out["cpu"][:2]):
        # bfloat16 keeps ~3 digits, and the plain versions' products round
        # at other places: within 2e-2 of the largest entry.
        assert (got.float() - ref.float()).abs().max() <= \
            2e-2 * ref.float().abs().max()


def sparse_first_staircase(k, device):
    """A 16-stage staircase (k dense columns) as sparse-first data planned
    at block 16, and its dense standard-form A on the host."""
    from tulip_tpu_torch.ipm.sparse_data import sparse_lp_data_from_problem
    from tulip_tpu_torch.problem import ProblemData

    rng = np.random.default_rng(k)
    A = np.zeros((256, 17 * 24))
    for s in range(16):
        A[16 * s:16 * (s + 1), 24 * s:24 * (s + 2)] = \
            rng.standard_normal((16, 48))
    A[:, [7 * j for j in range(k)]] = rng.standard_normal((256, k))
    I, J = np.nonzero(A)
    b = A @ np.full(A.shape[1], 0.5)
    pb = ProblemData()
    pb.load(True, np.ones(A.shape[1]), 0.0, (I, J, A[I, J]), b, b,
            np.zeros(A.shape[1]), np.ones(A.shape[1]))
    dat = sparse_lp_data_from_problem(pb, block=16, device=device)[0]
    assert dat.U.shape[-1] == k
    return dat, A


@pytest.mark.parametrize("k", [0, 2])
def test_sparse_lp_data_operators_on_card(cuda, k):
    """A·x and Aᵀ·y over the compressed blocks on the card against the
    same on the CPU, within 1e-12 (f64; no kernel of ours: gathers,
    batched GEMVs and index_add)."""
    from tulip_tpu_torch.ipm.data import matvec, rmatvec

    dat_g, A = sparse_first_staircase(k, cuda)
    dat_c, _ = sparse_first_staircase(k, "cpu")
    rng = np.random.default_rng(k)
    x = torch.as_tensor(rng.standard_normal((1, A.shape[1])))
    y = torch.as_tensor(rng.standard_normal((1, A.shape[0])))
    for op, v in [(matvec, x), (rmatvec, y)]:
        got = op(dat_g, v.to(cuda)).cpu()
        want = op(dat_c, v)
        assert (got - want).abs().max().item() <= 1e-12 * max(
            1.0, want.abs().max().item())
    np.testing.assert_allclose(matvec(dat_c, x)[0].numpy(), A @ x[0].numpy(),
                               rtol=1e-12, atol=1e-12)


def test_dense_ldl_update_and_solve_on_card(cuda):
    """One "dense-ldl" update + refined solve on the card against the same
    on the CPU, within 1e-10 relative (f64)."""
    from tulip_tpu_torch.kkt import DenseK2Backend

    rng = np.random.default_rng(5)
    m, n = 150, 230
    A = torch.as_tensor(rng.standard_normal((1, m, n)))
    theta_inv = torch.as_tensor(rng.uniform(1e-3, 1e3, (1, n)))
    regP = torch.full((1, n), 1e-8, dtype=torch.float64)
    regD = torch.full((1, m), 1e-8, dtype=torch.float64)
    xi_p = torch.as_tensor(rng.standard_normal((1, m)))
    xi_d = torch.as_tensor(rng.standard_normal((1, n)))
    be = DenseK2Backend(refinement_steps=1)
    out = []
    for dev in (cuda, torch.device("cpu")):
        args = [t.to(dev) for t in (theta_inv, regP, regD)]
        st, ok = be.update(be.setup(A.to(dev)), *args)
        dx, dy = be.solve(st, xi_p.to(dev), xi_d.to(dev))
        out.append([t.cpu() for t in (st.L, st.d, dx, dy, ok)])
    card, host = out
    for got, want in zip(card[:4], host[:4]):
        assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-10
    assert card[4].tolist() == host[4].tolist() == [True]


def test_dd_primitives_on_card_are_the_cpus_bits(cuda):
    """Double-double is exact only where every product and sum rounds on
    its own: the card's results of every dd primitive and reduction
    (chip_smoke.py's phase 7d(a)) equal the CPU's bit for bit, so no
    multiply and add were fused on the way."""
    import importlib.util

    from tulip_tpu_torch.ops import doubledouble as dd

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    card = cs.dd_results(dd, lambda v: torch.as_tensor(v, device=cuda))
    assert cs.dd_mismatches(card, cs.dd_results(dd, torch.as_tensor)) == []


@pytest.mark.parametrize("schedule", ["column", "level"])
def test_sparse_ldl_update_and_solve_on_card(cuda, schedule):
    """One "sparse-ldl" update + refined solve (tiled K2, both schedules)
    on the card against the same on the CPU: the same ok, dx and dy within
    1e-10 relative (f64), and the column schedule's dummy tile zero."""
    from tulip_tpu_torch.kkt import SparseK2Backend

    rng = np.random.default_rng(6)
    stages, mr, nc = 12, 16, 24
    m, n = stages * mr, stages * nc + nc
    A = np.zeros((m, n))
    for s in range(stages):
        A[s * mr:(s + 1) * mr, s * nc:(s + 2) * nc] = \
            rng.standard_normal((mr, 2 * nc))
    A[:, 5] = rng.standard_normal(m)
    A = torch.as_tensor(A)[None]
    theta_inv = torch.as_tensor(10.0 ** rng.uniform(-4, 4, (1, n)))
    regP = torch.full((1, n), 1e-8, dtype=torch.float64)
    regD = torch.full((1, m), 1e-8, dtype=torch.float64)
    xi_p = torch.as_tensor(rng.standard_normal((1, m)))
    xi_d = torch.as_tensor(rng.standard_normal((1, n)))
    be = SparseK2Backend(block=16, refinement_steps=2, schedule=schedule)
    out = []
    for dev in (cuda, torch.device("cpu")):
        args = [t.to(dev) for t in (theta_inv, regP, regD)]
        st, ok = be.update(be.setup(A.to(dev)), *args)
        dx, dy = be.solve(st, xi_p.to(dev), xi_d.to(dev))
        out.append([t.cpu() for t in (dx, dy, ok, st.T[0, -1])])
    card, host = out
    for got, want in zip(card[:2], host[:2]):
        assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-10
    assert card[2].tolist() == host[2].tolist() == [True]
    if schedule == "column":
        assert not card[3].any()


@pytest.mark.parametrize("refine", [0, 1])
def test_small_k1_explicit_minv_on_card_uses_kernel(cuda, refine):
    """``SmallK1Backend(explicit_minv=True)`` forms K⁻¹ from the chol-inv
    kernel's L⁻¹ on the card: one launch an update, K⁻¹ within 1e-4 of the
    plain version's relative to its size, and the solve within the f32
    bars of tests/test_kkt.py of the CPU's."""
    from tulip_tpu_torch.kkt import SmallK1Backend

    rng = np.random.default_rng(7)
    B, m, n = 64, 48, 96
    A = torch.as_tensor(rng.standard_normal((B, m, n)), dtype=torch.float32)
    theta = torch.as_tensor(10.0 ** rng.uniform(-2, 2, (B, n)),
                            dtype=torch.float32)
    regP = torch.full((B, n), 1e-6)
    regD = torch.full((B, m), 1e-4)
    xi_p = torch.as_tensor(rng.standard_normal((B, m)), dtype=torch.float32)
    xi_d = torch.as_tensor(rng.standard_normal((B, n)), dtype=torch.float32)
    be = SmallK1Backend(explicit_minv=True, refinement_steps=refine)
    out = []
    for dev in (cuda, torch.device("cpu")):
        before = chol.KERNEL_LAUNCHES
        st, ok = be.update(be.setup(A.to(dev)), theta.to(dev),
                           regP.to(dev), regD.to(dev))
        dx, dy = be.solve(st, xi_p.to(dev), xi_d.to(dev))
        torch.cuda.synchronize()
        launched = chol.KERNEL_LAUNCHES - before
        out.append((launched, ok.cpu(), st.L.cpu(), dx.cpu(), dy.cpu()))
    (n_card, ok_c, Kinv_c, dx_c, dy_c), (n_host, ok_h, Kinv_h, dx_h, dy_h) \
        = out
    assert (n_card, n_host) == (1, 0)
    assert ok_c.all() and ok_h.all()
    scale = Kinv_h.abs().amax(dim=(-1, -2), keepdim=True)
    assert ((Kinv_c - Kinv_h).abs() / scale).max().item() <= 1e-4
    bar = 1e-2 if refine == 0 else 10 * np.sqrt(np.finfo(np.float32).eps)
    for got, want in ((dx_c, dx_h), (dy_c, dy_h)):
        err = (got - want).abs().amax(-1) / want.abs().amax(-1).clamp_min(1)
        assert err.max().item() <= bar


def test_krylov_solves_on_card_match_the_cpu(cuda):
    """cg, sqd-minres and lsmr on the card in f64 against the CPU on the
    same state: within 1e-6 relative (their stopping tests may fall one
    trip apart)."""
    from tulip_tpu_torch.kkt import make_backend

    rng = np.random.default_rng(8)
    m, n = 40, 90
    A = torch.as_tensor(rng.standard_normal((2, m, n)))
    theta = torch.as_tensor(10.0 ** rng.uniform(-2, 2, (2, n)))
    regP = torch.full((2, n), 1e-8, dtype=torch.float64)
    regD = torch.full((2, m), 1e-6, dtype=torch.float64)
    xi_p = torch.as_tensor(rng.standard_normal((2, m)))
    xi_d = torch.as_tensor(rng.standard_normal((2, n)))
    for name in ("cg", "sqd-minres", "lsmr"):
        be = make_backend(name, refinement_steps=1)
        out = []
        for dev in (cuda, torch.device("cpu")):
            st, ok = be.update(be.setup(A.to(dev)), theta.to(dev),
                               regP.to(dev), regD.to(dev))
            out.append([t.cpu() for t in be.solve(st, xi_p.to(dev),
                                                  xi_d.to(dev))])
        for got, want in zip(*out):
            assert ((got - want).abs().max()
                    / want.abs().max()).item() <= 1e-6, name


def test_tf32x3_gemm_on_card_keeps_f32_digits(cuda):
    """``gemm(..., "tf32x3")`` on the card, three TF32 products of a split,
    within 8x of IEEE f32's error against the f64 product (the split's
    ``lo`` keeps 11 of its 13 bits, and the tensor cores add in f32), where
    one TF32 pass is at least 100x off; torch's flag is the caller's
    afterwards."""
    from tulip_tpu_torch.kkt.dense import allow_tf32, gemm

    rng = np.random.default_rng(9)
    a64, b64 = rng.standard_normal((256, 2048)), rng.standard_normal((2048,
                                                                      192))
    a = torch.as_tensor(a64, dtype=torch.float32, device=cuda)
    b = torch.as_tensor(b64, dtype=torch.float32, device=cuda)
    exact = torch.as_tensor(a64.astype(np.float32).astype(np.float64)
                            @ b64.astype(np.float32).astype(np.float64))
    flag = torch.backends.cuda.matmul.allow_tf32
    err = {}
    with allow_tf32(False):
        err["ieee"] = (a @ b).double().cpu() - exact
        err["tf32x3"] = gemm(a, b, "tf32x3").double().cpu() - exact
        assert torch.backends.cuda.matmul.allow_tf32 is False
    with allow_tf32(True):
        err["tf32"] = (a @ b).double().cpu() - exact
    assert torch.backends.cuda.matmul.allow_tf32 is flag
    e = {k: v.abs().max().item() for k, v in err.items()}
    assert e["tf32x3"] <= 8 * e["ieee"], e
    assert e["tf32"] >= 100 * e["ieee"], e


def test_device_program_replay_equals_the_host_loop(cuda):
    """The device program on the card (one captured CUDA graph a pass,
    replayed) against ``HostLoop=True`` on 64 random 48×96 LPs in f32
    through ``SmallK1Backend``: the final states equal bit for bit; the
    chol-inv kernel is a node of the pass, credited once a replay; a
    second solve replays the cached graph to the same bits."""
    from tulip_tpu_torch.ipm import graph
    from tulip_tpu_torch.ipm.batch import batched_hsd_solve, stack_lps_host
    from tulip_tpu_torch.ipm.hsd import HSDOptions
    from tulip_tpu_torch.kkt import SmallK1Backend

    rng = np.random.default_rng(10)
    raws = []
    for _ in range(64):
        A = rng.standard_normal((48, 96))
        u = rng.uniform(1.0, 4.0, 96)
        b = A @ (u * rng.uniform(0.2, 0.8, 96))
        raws.append((A, b, rng.standard_normal(96), 0.0, np.zeros(96), u))
    dats = stack_lps_host(raws, device=cuda, dtype=torch.float32)
    tol = dict(TolerancePFeas=3e-4, ToleranceDFeas=3e-4, ToleranceRGap=3e-4,
               ToleranceIFeas=3e-4, PRegMin=1e-6, DRegMin=1e-6)
    be = SmallK1Backend(refinement_steps=1)
    graph.clear_device_programs()
    host = batched_hsd_solve(be, HSDOptions(HostLoop=True, **tol), dats)
    captured, launched = chol.CAPTURED_LAUNCHES, chol.KERNEL_LAUNCHES
    dev = batched_hsd_solve(be, HSDOptions(**tol), dats)
    torch.cuda.synchronize()
    assert graph.LAST["built"]
    per_pass = chol.CAPTURED_LAUNCHES - captured
    assert per_pass == graph.LAST["launches_a_pass"]["chol"] > 0
    assert chol.KERNEL_LAUNCHES - launched == per_pass * graph.LAST["passes"]
    again = batched_hsd_solve(be, HSDOptions(**tol), dats)
    assert not graph.LAST["built"]

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    for a, b, c in zip(*(graph.leaves(s) for s in (dev, host, again))):
        if torch.is_tensor(a):
            assert torch.equal(bits(a), bits(b))
            assert torch.equal(bits(a), bits(c))


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_index_add_fixed_repeats_its_bits(cuda, dt):
    """The level engine's scatter-add (``kkt/levels.py:index_add_fixed``)
    onto targets repeated up to 40 times: two runs, and a replay of it
    captured in a CUDA graph, equal bit for bit; within rounding of the
    CPU's ``index_add_``."""
    from tulip_tpu_torch.kkt.levels import index_add_fixed

    g = torch.Generator().manual_seed(0)
    T = torch.randn(50, 8, 8, generator=g, dtype=dt)
    idx = torch.randint(0, 12, (400,), generator=g)
    src = torch.randn(400, 8, 8, generator=g, dtype=dt)
    Tc, idxc, srcc = T.to(cuda), idx.to(cuda), src.to(cuda)
    runs = [index_add_fixed(Tc.clone(), idxc, srcc, alpha=-1)
            for _ in range(2)]
    out = Tc.clone()
    graph = torch.cuda.CUDAGraph()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        index_add_fixed(out.clone(), idxc, srcc, alpha=-1)
    torch.cuda.current_stream().wait_stream(s)
    with torch.cuda.graph(graph):
        index_add_fixed(out, idxc, srcc, alpha=-1)
    out.copy_(Tc)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], out)
    want = T.clone().index_add_(0, idx, src, alpha=-1)
    tol = 1e-12 if dt == torch.float64 else 1e-5
    assert ((runs[0].cpu() - want).abs().max()
            <= tol * want.abs().max())


def test_dropped_programs_leave_no_graph_pool(cuda):
    """A device program keeps its static copies and its graphs' memory
    pool, and counts both (``Program.nbytes``); once every program is
    dropped, no graph pool is left on the card: the cuBLAS workspace its
    capture allocated lies in its pool and goes with it."""
    from tulip_tpu_torch.ipm import graph
    from tulip_tpu_torch.ipm.batch import batched_hsd_solve, stack_lps_host
    from tulip_tpu_torch.ipm.hsd import HSDOptions
    from tulip_tpu_torch.kkt import DenseK1Backend

    def pools():
        return sum(s["total_size"]
                   for s in torch.cuda.memory._snapshot()["segments"]
                   if tuple(s.get("segment_pool_id", (0, 0))) != (0, 0))

    rng = np.random.default_rng(11)
    raws = []
    for _ in range(8):
        A = rng.standard_normal((48, 96))
        u = rng.uniform(1.0, 4.0, 96)
        b = A @ (u * rng.uniform(0.2, 0.8, 96))
        raws.append((A, b, rng.standard_normal(96), 0.0, np.zeros(96), u))
    dats = stack_lps_host(raws, device=cuda, dtype=torch.float64)
    graph.clear_device_programs()
    torch.cuda.empty_cache()
    assert pools() == 0
    batched_hsd_solve(DenseK1Backend(), HSDOptions(), dats)
    assert graph.LAST["built"]
    (prog,) = graph._CACHE.values()
    assert prog.nbytes > graph._storage_bytes((prog.dat, prog.state))
    assert pools() > 0
    del prog
    graph.clear_device_programs()
    torch.cuda.empty_cache()
    assert pools() == 0
