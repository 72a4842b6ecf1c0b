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
