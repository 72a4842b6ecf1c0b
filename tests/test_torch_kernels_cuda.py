"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Marked ``cuda``; without a CUDA device every test skips. Run on a
GPU machine with ``python -m pytest tests/test_torch_kernels_cuda.py -n 0``."""

from pathlib import Path

import numpy as np
import pytest
import torch

from tulip_tpu_torch.ops import chol, gram
from tulip_tpu_torch.ops.chol import (batched_cholesky_inverse,
                                      batched_cholesky_inverse_plain)
from tulip_tpu_torch.ops.gram import scaled_gram, scaled_gram_plain

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


@pytest.mark.parametrize("B,m", [(1, 8), (7, 48), (64, 64), (5, 100),
                                 (3, 224), (4, 256), (2, 1024)])
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
                                   (2, 129, 7), (2, 1000, 1500)])
def test_scaled_gram_kernel_matches_plain(cuda, B, m, n):
    A, d = gram_inputs(B, m, n, seed=m, device=cuda)
    before = gram.KERNEL_LAUNCHES
    got = scaled_gram(A, d)
    torch.cuda.synchronize()
    assert gram.KERNEL_LAUNCHES == before + 1
    want = scaled_gram_plain(A, d)
    # The kernel mirrors its lower tiles: K is exactly symmetric.
    assert torch.equal(got, got.transpose(-1, -2))
    # f32 sums of n terms in another order than cuBLAS's, per lane.
    err = (got - want).abs().amax(dim=(-1, -2))
    assert (err <= 1e-5 * want.abs().amax(dim=(-1, -2))).all()


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
