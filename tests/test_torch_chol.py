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


def factor_invert_block(D):
    """One diagonal block as a warp of the CUDA kernel factors it: a
    right-looking Cholesky of the lower triangle of D (B, nb, nb) with
    r = 1/√p per pivot (NaN past a non-positive one), then X = L⁻¹ by
    forward substitution. Returns (L, X)."""
    A = torch.tril(D)
    nb = D.shape[-1]
    r = torch.empty(D.shape[:-1], dtype=D.dtype)
    for j in range(nb):
        r[:, j] = 1.0 / torch.sqrt(A[:, j, j])
        A[:, j:, j] = A[:, j:, j] * r[:, j, None]
        col = A[:, j + 1:, j]
        A[:, j + 1:, j + 1:] -= col[:, :, None] * col[:, None, :]
    L = torch.tril(A)
    X = torch.zeros_like(D)
    eye = torch.eye(nb, dtype=D.dtype)
    for i in range(nb):
        X[:, i] = (eye[i] - (L[:, i, None, :i] @ X[:, :i])[:, 0]) \
            * r[:, i, None]
    return L, X


def blocked_cholesky_inverse(K, nb, pad="matrix"):
    """The CUDA kernel's algorithm (csrc/chol_inv.cu) in plain PyTorch:
    per panel j the diagonal block factored and inverted (X_jj = L_jj⁻¹),
    the panel below as a product L_ij = W_ij·X_jjᵀ, the trailing update
    W_ik −= L_ij·L_kjᵀ; then L⁻¹ by blocks,
    X_ij = −X_ii·Σ_{j≤k<i} L_ik·X_kj, and exact zeros above the diagonal.

    ``pad="matrix"`` is the blocked path (m > 224): a working copy padded to
    a multiple of ``nb`` with an identity tail. ``pad="block"`` is the
    shared-memory path (m ≤ 224): nothing is padded in the matrix; the
    ragged last diagonal block is factored inside its own nb×nb block whose
    tail rows are the identity, and the last block row and column are
    ragged. (That path applies L_jj⁻¹ and X_ii by substitution inside each
    block, in the column-at-a-time order: the same recurrences, rounded as
    the column-at-a-time kernel rounds them.)"""
    B, m, _ = K.shape
    if pad == "matrix":
        mp = -(-m // nb) * nb
        W = torch.eye(mp, dtype=K.dtype).repeat(B, 1, 1)
        W[:, :m, :m] = K
        return blocked_cholesky_inverse(W, nb, pad="block")[:, :m, :m]
    W = K.clone()
    blocks = [(a, min(a + nb, m)) for a in range(0, m, nb)]
    Xd = []
    for a, b in blocks:
        D = torch.eye(nb, dtype=K.dtype).repeat(B, 1, 1)
        D[:, :b - a, :b - a] = W[:, a:b, a:b]
        Xd.append(factor_invert_block(D)[1][:, :b - a, :b - a])
        if b < m:
            W[:, b:, a:b] = W[:, b:, a:b] @ Xd[-1].transpose(1, 2)
            P = W[:, b:, a:b]
            W[:, b:, b:] -= P @ P.transpose(1, 2)
    X = torch.zeros_like(W)
    for j, (a, b) in enumerate(blocks):
        X[:, a:b, a:b] = Xd[j]
        for i in range(j + 1, len(blocks)):
            ra, rb = blocks[i]
            S = W[:, ra:rb, a:ra] @ X[:, a:ra, a:b]
            X[:, ra:rb, a:b] = -Xd[i] @ S
    return X


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


def hold_to_reference(got, ref, m):
    """The bars of the f32 kernel against the Pallas kernel: atol 5e-5 up
    to m = 64, relative Frobenius 1e-4 per instance above."""
    if m <= 64:
        np.testing.assert_allclose(got, ref, atol=5e-5, rtol=0)
    else:
        rel = (np.linalg.norm(got - ref, axis=(1, 2))
               / np.linalg.norm(ref, axis=(1, 2)))
        assert rel.max() <= 1e-4, rel


@pytest.mark.parametrize("m", [1, 8, 31, 32, 33, 48, 64, 65, 100, 224])
def test_shared_path_recurrences_match_pallas_kernel(m):
    # The CUDA kernel's shared-memory path (m ≤ 224): 32-column panels, the
    # ragged last one padded in its own block, L⁻¹ by blocks. In f32
    # against the Pallas kernel, and in f64 against the plain version at
    # 1e-5·max|L⁻¹|, so that the bar checks the recurrences, not rounding.
    K = spd_batch(3, m, seed=100 + m)
    ref = np.asarray(batched_cholesky_inverse_pallas(jnp.asarray(K),
                                                     interpret=True))
    got = blocked_cholesky_inverse(torch.from_numpy(K), 32, pad="block")
    assert torch.equal(torch.triu(got, 1), torch.zeros_like(got))
    hold_to_reference(got.numpy(), ref, m)
    K64 = torch.from_numpy(K).double()
    got64 = blocked_cholesky_inverse(K64, 32, pad="block")
    want = chol.batched_cholesky_inverse_plain(K64)
    scale = want.abs().amax(dim=(1, 2), keepdim=True)
    assert ((got64 - want).abs() <= 1e-5 * scale).all()


@pytest.mark.parametrize("m", [48, 100])
def test_shared_path_nonspd_past_first_panel(m):
    # Lane 2's leading 40×40 block is SPD and its pivot 40 is negative: it
    # fails in the second panel, past the identity rows that pad a ragged
    # panel. Non-finite in that lane alone, in the emulation, the plain
    # version and the Pallas kernel; the other lanes match.
    K = spd_batch(4, m, seed=m)
    K[2, 40, 40] = -1.0
    ref = np.asarray(batched_cholesky_inverse_pallas(jnp.asarray(K),
                                                     interpret=True))
    got = blocked_cholesky_inverse(torch.from_numpy(K), 32,
                                   pad="block").numpy()
    plain = batched_cholesky_inverse(torch.from_numpy(K)).numpy()
    for out in (got, ref, plain):
        assert np.isfinite(out).all(axis=(1, 2)).tolist() == [True, True,
                                                              False, True]
    good = [0, 1, 3]
    hold_to_reference(got[good], ref[good], m)
