"""Port parity: the warm-started batched re-solve (``ipm/warmstart.py``,
``batched_hsd_resolve``) against the JAX package's, from a JAX final state
carried across by ``tulip_tpu_torch.convert``, in f64 on the CPU."""

import jax
import numpy as np
import pytest
import torch

import tulip_tpu  # noqa: F401
from test_torch_hsd import to_numpy
from tulip_tpu.ipm import batch as jbatch
from tulip_tpu.ipm import data as jdata
from tulip_tpu.ipm import hsd as jhsd
from tulip_tpu.ipm import warmstart as jwarm
from tulip_tpu.kkt import DenseK1Backend as JDense
from tulip_tpu_torch.convert import hsd_state_from_numpy, lp_data_from_numpy
from tulip_tpu_torch.ipm.batch import (batched_hsd_resolve, batched_hsd_solve,
                                       stack_lps_host)
from tulip_tpu_torch.ipm.hsd import HSDOptions
from tulip_tpu_torch.ipm.warmstart import blend_point, warm_state
from tulip_tpu_torch.kkt import DenseK1Backend
from tulip_tpu_torch.status import TerminationStatus

torch.set_num_threads(1)

OPT = int(TerminationStatus.OPTIMAL)


def resolve_instances(perturb):
    """tests/test_batch.py:247-272: eight 8×16 LPs from seed 1, and the
    same LPs with b perturbed by 1% (seed 0)."""
    rng = np.random.default_rng(0)
    rng2 = np.random.default_rng(1)
    raws = []
    for _ in range(8):
        A = rng2.standard_normal((8, 16))
        u = rng2.uniform(1, 4, 16)
        x0 = u * rng2.uniform(0.2, 0.8, 16)
        c = rng2.standard_normal(16)
        b = A @ x0
        if perturb:
            b = b * (1 + 0.01 * rng.standard_normal(8))
        raws.append((A, b, c, 0.0, np.zeros(16), u))
    return raws


def jax_stack(raws):
    return jbatch.stack_lps([jdata.make_lp_data(*r) for r in raws])


@pytest.mark.parametrize("lam", [0.99, 0.5])
def test_batched_resolve_matches_jax(lam):
    opts = jhsd.HSDOptions()
    out0 = jbatch.batched_hsd_solve(JDense(), opts,
                                    jax_stack(resolve_instances(False)))
    raws2 = resolve_instances(True)
    want = jbatch.batched_hsd_resolve(JDense(), opts, jax_stack(raws2), out0,
                                      lam=lam)
    prev = hsd_state_from_numpy(to_numpy(out0), device="cpu")
    dats2 = stack_lps_host(raws2, device="cpu")
    got = batched_hsd_resolve(DenseK1Backend(), HSDOptions(), dats2, prev,
                              lam=lam)
    assert (got.status.numpy() == OPT).all()
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(want.status))
    np.testing.assert_array_equal(got.niter.numpy(), np.asarray(want.niter))
    np.testing.assert_allclose(got.pobj.numpy(), np.asarray(want.pobj),
                               rtol=1e-8, atol=0)
    if lam == 0.99:
        # The reason to warm-start: fewer iterations than a cold solve,
        # to the same objectives (tests/test_batch.py:280-283).
        cold = batched_hsd_solve(DenseK1Backend(), HSDOptions(), dats2)
        assert got.niter.double().mean() < cold.niter.double().mean()
        np.testing.assert_allclose(got.pobj.numpy(), cold.pobj.numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_warm_state_matches_jax():
    """The blended start itself, lane by lane, from a prev state whose τ
    is not 1 (the point is divided by τ before blending)."""
    raws = resolve_instances(True)
    jd = jax_stack(raws)
    out0 = jbatch.batched_hsd_solve(JDense(), jhsd.HSDOptions(),
                                    jax_stack(resolve_instances(False)))
    tau = np.linspace(0.5, 2.0, 8)
    out0 = out0._replace(pt=out0.pt._replace(
        x=out0.pt.x * tau[:, None], tau=out0.pt.tau * tau))
    want = jax.vmap(lambda d, p: jwarm.warm_state(d, JDense(), p))(jd, out0)
    got = warm_state(lp_data_from_numpy(to_numpy(jd), device="cpu"),
                     DenseK1Backend(),
                     hsd_state_from_numpy(to_numpy(out0), device="cpu"))
    for f in ("x", "xl", "xu", "y", "zl", "zu", "tau", "kappa", "mu"):
        np.testing.assert_allclose(getattr(got.pt, f).numpy(),
                                   np.asarray(getattr(want.pt, f)),
                                   rtol=1e-12, atol=1e-15, err_msg=f)


def test_blend_with_lam_zero_is_the_cold_start():
    dat = stack_lps_host(resolve_instances(False)[:2], device="cpu")
    prev = batched_hsd_solve(DenseK1Backend(), HSDOptions(), dat)
    pt = blend_point(dat, prev.pt, lam=0.0)
    assert torch.equal(pt.x, torch.zeros_like(pt.x))
    assert torch.equal(pt.xu, dat.uflag)
    assert torch.equal(pt.tau, torch.ones_like(pt.tau))
    assert torch.equal(pt.kappa, torch.ones_like(pt.kappa))
