"""Port parity: the plain chol-inv version of ``tulip_tpu_torch.ops.chol``
against the JAX package's Pallas kernel run in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tulip_tpu  # noqa: F401
from tulip_tpu.ops.chol import batched_cholesky_inverse_pallas
from tulip_tpu_torch.ops import chol
from tulip_tpu_torch.ops.chol import (batched_cholesky_inverse, cholesky,
                                      cholesky_inverse)

torch.set_num_threads(1)


def spd_batch(B, m, seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B, m, m))
    return (np.einsum("bij,bkj->bik", X, X) + m * np.eye(m)).astype(
        np.float32)


@pytest.mark.parametrize("m", [8, 48, 64])
def test_plain_matches_pallas_kernel(m):
    # f32 at atol 5e-5, the bar tests/test_pallas_ops.py:88 holds the
    # Pallas kernel to against numpy: both are f32 factorizations of the
    # same well-conditioned K with different summation orders.
    K = spd_batch(7, m, seed=m)
    ref = np.asarray(batched_cholesky_inverse_pallas(jnp.asarray(K),
                                                     interpret=True))
    got = batched_cholesky_inverse(torch.from_numpy(K)).numpy()
    np.testing.assert_allclose(got, ref, atol=5e-5, rtol=0)
    assert np.all(np.triu(got, 1) == 0.0)


def test_nonspd_lane_is_nonfinite_others_exact():
    K = spd_batch(5, 16, seed=3)
    K[2] = -K[2]
    got = batched_cholesky_inverse(torch.from_numpy(K)).numpy()
    finite = np.isfinite(got).all(axis=(1, 2))
    assert finite.tolist() == [True, True, False, True, True]
    good = [0, 1, 3, 4]
    ref = np.asarray(batched_cholesky_inverse_pallas(
        jnp.asarray(K[good]), interpret=True))
    np.testing.assert_allclose(got[good], ref, atol=5e-5, rtol=0)


def test_block_and_pack_do_not_change_output():
    K = torch.from_numpy(spd_batch(3, 12, seed=5))
    base = batched_cholesky_inverse(K)
    for block, pack in [(4, 0), (0, 2), (8, 3)]:
        assert torch.equal(batched_cholesky_inverse(K, block=block,
                                                    pack=pack), base)


def test_single_matrix_and_cholesky():
    K = torch.from_numpy(spd_batch(1, 10, seed=7)[0]).double()
    Li = cholesky_inverse(K)
    L = cholesky(K)
    np.testing.assert_allclose(L.numpy(), np.linalg.cholesky(K.numpy()),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose((Li @ L).numpy(), np.eye(10), atol=1e-12)


def test_cpu_tensor_does_not_launch_the_kernel():
    before = chol.KERNEL_LAUNCHES
    batched_cholesky_inverse(torch.from_numpy(spd_batch(2, 8, seed=1)))
    assert chol.KERNEL_LAUNCHES == before


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("m", [225, 256, 300])
def test_plain_matches_pallas_kernel_above_shared_range(m, B):
    # The sizes the CUDA kernel's blocked path takes (m > 224). Relative
    # Frobenius norm per instance, the bar the card holds the kernel to:
    # entries of L⁻¹ span more magnitudes here than at m = 48.
    K = spd_batch(B, m, seed=m + B)
    ref = np.asarray(batched_cholesky_inverse_pallas(jnp.asarray(K),
                                                     interpret=True))
    got = batched_cholesky_inverse(torch.from_numpy(K)).numpy()
    rel = (np.linalg.norm(got - ref, axis=(1, 2))
           / np.linalg.norm(ref, axis=(1, 2)))
    assert rel.max() <= 1e-4, rel
    assert np.all(np.triu(got, 1) == 0.0)


def test_nonspd_lane_above_shared_range():
    K = spd_batch(3, 256, seed=11)
    K[1] = -K[1]
    got = batched_cholesky_inverse(torch.from_numpy(K)).numpy()
    ref = np.asarray(batched_cholesky_inverse_pallas(jnp.asarray(K),
                                                     interpret=True))
    for out in (got, ref):
        assert np.isfinite(out).all(axis=(1, 2)).tolist() == [True, False,
                                                              True]
    for b in (0, 2):
        rel = np.linalg.norm(got[b] - ref[b]) / np.linalg.norm(ref[b])
        assert rel <= 1e-4


def blocked_cholesky_inverse(K, nb):
    """The CUDA kernel's blocked algorithm (csrc/chol_inv.cu, m > 224) in
    plain PyTorch: a working copy padded to a multiple of ``nb`` with an
    identity tail; per panel j the diagonal block factored and inverted
    (X_jj = L_jj⁻¹), the panel below as a product L_ij = W_ij·X_jjᵀ, the
    trailing update W_ik −= L_ij·L_kjᵀ; then L⁻¹ by blocks,
    X_ij = −X_ii·Σ_{j≤k<i} L_ik·X_kj, and exact zeros above the diagonal."""
    B, m, _ = K.shape
    mp = -(-m // nb) * nb
    W = torch.eye(mp, dtype=K.dtype).repeat(B, 1, 1)
    W[:, :m, :m] = K
    eye = torch.eye(nb, dtype=K.dtype).expand(B, nb, nb)
    Xd = []
    for j in range(mp // nb):
        a, b = j * nb, (j + 1) * nb
        Ljj = torch.linalg.cholesky_ex(torch.tril(W[:, a:b, a:b]))[0]
        Xd.append(torch.linalg.solve_triangular(Ljj, eye, upper=False))
        if b < mp:
            W[:, b:, a:b] = W[:, b:, a:b] @ Xd[j].transpose(1, 2)
            P = W[:, b:, a:b]
            W[:, b:, b:] -= P @ P.transpose(1, 2)
    X = torch.zeros_like(W)
    nblk = mp // nb
    for j in range(nblk):
        cj = slice(j * nb, (j + 1) * nb)
        X[:, cj, cj] = Xd[j]
        for i in range(j + 1, nblk):
            ri = slice(i * nb, (i + 1) * nb)
            S = W[:, ri, j * nb:i * nb] @ X[:, j * nb:i * nb, cj]
            X[:, ri, cj] = -Xd[i] @ S
    return X[:, :m, :m]


@pytest.mark.parametrize("nb", [32, 64])
@pytest.mark.parametrize("B,m", [(1, 225), (3, 256), (2, 300), (1, 96)])
def test_blocked_recurrences_match_plain(B, m, nb):
    # f64, so that the bar checks the block recurrences and not rounding.
    K = torch.from_numpy(spd_batch(B, m, seed=B + m)).double()
    got = blocked_cholesky_inverse(K, nb)
    want = chol.batched_cholesky_inverse_plain(K)
    assert torch.equal(torch.triu(got, 1), torch.zeros_like(got))
    scale = want.abs().amax(dim=(1, 2), keepdim=True)
    assert ((got - want).abs() <= 1e-5 * scale).all()
    # And in f32, the kernel's type, at the card's bar.
    got32 = blocked_cholesky_inverse(K.float(), nb)
    rel = (torch.linalg.matrix_norm(got32.double() - want)
           / torch.linalg.matrix_norm(want))
    assert rel.max() <= 1e-4
