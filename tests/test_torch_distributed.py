"""The port's distributed paths across processes: Gloo groups of spawned
CPU processes through ``tulip_tpu_torch.parallel.dryrun.launch`` (a
``FileStore`` in a temporary directory, no port; a 120 s limit per job).
One 2-process job and one 4-process job run every case once, for the
module, the reference's dry-run regimes among them; each test reads its
part. Each result is held to the JAX package's unsharded solve of the
same LP, and to the port's, both run in this process (the workers import
no JAX)."""

import functools
import multiprocessing
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_block_angular import two_stage

import tulip_tpu  # noqa: F401
from tulip_tpu.ipm import batch as jbatch
from tulip_tpu.ipm import hsd as jhsd
from tulip_tpu.kkt import DenseK1Backend as JDense
from tulip_tpu.kkt import SchurK1Backend as JSchur
from tulip_tpu.parallel import block_angular as jba
from tulip_tpu_torch.ipm.batch import batched_hsd_solve, stack_lps_host
from tulip_tpu_torch.ipm.hsd import HSDOptions, hsd_solve
from tulip_tpu_torch.kkt import DenseK1Backend, SchurK1Backend
from tulip_tpu_torch.parallel import init_comm, make_block_angular
from tulip_tpu_torch.parallel.dryrun import (LOOSE, VOLUME_DIMS,
                                             batch_problems, check_regimes,
                                             collective_signature, launch,
                                             main, regime_cases, run_cases,
                                             two_stage_arrays)

torch.set_num_threads(1)

OPT = 2
LIMIT_S = 120.0
SCHUR = two_stage(np.random.default_rng(3), K=8)      # K = 8: 4 a rank
UNEVEN = two_stage(np.random.default_rng(5), K=3)     # K = 3: padded to 4
BATCH = dict(nb=5, m=6, n=12, seed=7, dtype="float64", tol=None)
# Bars against the JAX package: f64 at the default tolerances, the
# reference's test_schur_sharded_over_mesh (the same iterations, pobj
# within 1e-8·max(1,|f|)); f32 at 1e-4, its dry run's 1e-3·max(1,|f|)
# (there an iteration count may differ by one between the packages).
F64_BAR, F32_BAR = 1e-8, 1e-3


def jax_opts(tol):
    """The JAX package's options of ``dryrun._opts(tol)``."""
    if tol is None:
        return jhsd.HSDOptions()
    return jhsd.HSDOptions(TolerancePFeas=tol, ToleranceDFeas=tol,
                           ToleranceRGap=tol, ToleranceIFeas=tol,
                           PRegMin=1e-6, DRegMin=1e-6)


def jax_schur(arrays, dtype="float64", tol=None, pad_to=None):
    """(statuses, iterations, objectives), one lane, of the JAX package's
    unsharded Schur HSD solve of the LP of ``arrays``, padded to
    ``pad_to`` scenarios first."""
    dat = jba.make_block_angular(*arrays, dtype=jnp.dtype(dtype))
    if pad_to is not None:
        dat = jba.pad_scenarios(dat, pad_to)
    out = jhsd.hsd_solve(dat, JSchur(), jax_opts(tol))
    return (np.array([int(out.status)]), np.array([int(out.niter)]),
            np.array([float(out.pobj)]))


def jax_batch(nb, m, n, seed=0, dtype="float32", tol=1e-4):
    """The same of the JAX package's batched dense solve of
    ``batch_problems(nb, m, n, seed)``."""
    out = jbatch.batched_hsd_solve(
        JDense(), jax_opts(tol), jbatch.stack_lps_host(
            batch_problems(nb, m, n, seed), dtype=jnp.dtype(dtype)))
    return tuple(np.asarray(v) for v in (out.status, out.niter, out.pobj))


@functools.lru_cache(maxsize=None)
def jax_regime(nprocs, label):
    """The JAX package's solve of regime ``label`` of
    ``regime_cases(nprocs, 4)`` (f64, for its bar, or f32)."""
    name, kw = {lbl: (nm, kw) for lbl, nm, kw in
                regime_cases(nprocs, volume_K=4)}[label]
    if name == "batch":
        return jax_batch(**kw), "float32"
    dtype = kw.get("dtype", "float64")
    return jax_schur(kw["arrays"], dtype, kw.get("tol"),
                     kw.get("pad_to")), dtype


def assert_matches_jax(got, want, dtype):
    """Per lane: ``want``'s status; in f64 its iterations and pobj within
    F64_BAR·max(1,|f|), in f32 pobj within F32_BAR·max(1,|f|)."""
    pobj = np.atleast_1d(got["pobj"])
    np.testing.assert_array_equal(np.atleast_1d(got["status"]), want[0])
    bar = F64_BAR if dtype == "float64" else F32_BAR
    if dtype == "float64":
        np.testing.assert_array_equal(np.atleast_1d(got["niter"]), want[1])
    assert (np.abs(pobj - want[2])
            <= bar * np.maximum(1.0, np.abs(want[2]))).all(), (pobj, want[2])


@pytest.fixture(scope="module")
def two():
    """The reference's regimes (regime 2b at K = 4) and this file's
    cases, on 2 processes."""
    cases = regime_cases(2, volume_K=4) + [
        ("schur", "schur", dict(arrays=SCHUR, state=True)),
        ("schur_host", "schur", dict(arrays=SCHUR, state=True,
                                     host_loop=True)),
        ("uneven_k", "shard_error", dict(arrays=UNEVEN)),
        ("padded", "schur", dict(arrays=UNEVEN, pad_to=4)),
        ("batch", "batch", BATCH)]
    return launch(run_cases, 2, device="cpu", timeout_s=LIMIT_S,
                  args=(cases,))


@pytest.fixture(scope="module")
def four():
    """The reference's regimes, the 2-D grid among them, on 4."""
    return launch(run_cases, 4, device="cpu", timeout_s=LIMIT_S,
                  args=(regime_cases(4),))


@pytest.mark.parametrize("job", ["two", "four"])
def test_reference_regimes_meet_their_bars(job, request):
    """Data-parallel, model-parallel, real volume (with the collective
    signature), uneven K and, on 4, the 2-D grid: each objective at the
    reference's bar against the dense single-process solve."""
    check_regimes(request.getfixturevalue(job), log=lambda *a: None)


@pytest.mark.parametrize("job", ["two", "four"])
@pytest.mark.parametrize("label", ["dp", "mp", "volume", "uneven"])
def test_regimes_match_the_jax_package(job, label, request):
    """Every rank's result of each regime (regime 2b at K = 4 in both
    jobs) against the JAX package's unsharded solve of the same LPs, at
    the same dtype, tolerances and padding."""
    results = request.getfixturevalue(job)
    want, dtype = jax_regime(len(results), label)
    for r in results:
        assert_matches_jax(r[label], want, dtype)


def unsharded(arrays):
    return hsd_solve(make_block_angular(*arrays, device="cpu"),
                     SchurK1Backend(), HSDOptions())


def test_sharded_schur_matches_unsharded(two):
    """The reference's test_schur_sharded_over_mesh bar: OPTIMAL, pobj
    within 1e-8; and the unsharded solve's iterations, the port's and the
    JAX package's."""
    ref = unsharded(SCHUR)
    want = jax_schur(SCHUR)
    for r in two:
        assert_matches_jax(r["schur"], want, "float64")
        assert r["schur"]["status"] == OPT
        assert r["schur"]["niter"] == int(ref.niter)
        assert abs(r["schur"]["pobj"] - float(ref.pobj)) < 1e-8


def test_ranks_end_bit_identical(two):
    a, b = (r["schur"]["state"] for r in two)
    assert sorted(a) == sorted(b) and "kkt.Ls" in a
    for k in a:
        assert a[k].tobytes() == b[k].tobytes(), k


def test_device_program_equals_host_loop_on_every_rank(two):
    """The sharded Schur solve through the device program (each pass step
    by step on the CPU, the Gloo collectives run in it) and through the
    host-driven loop: each rank's final state equal bit for bit, and the
    program's collectives counted, one n0×n0 all-reduce to each
    factorization attempt."""
    for r in two:
        dev, host = r["schur"], r["schur_host"]
        assert dev["graph"]["built"] and not host["graph"]
        assert dev["graph"]["passes"] == dev["niter"] + 1
        assert (dev["status"], dev["niter"]) == (host["status"],
                                                 host["niter"])
        assert sorted(dev["state"]) == sorted(host["state"])
        for k in dev["state"]:
            assert dev["state"][k].tobytes() == host["state"][k].tobytes(), k
        for res in (dev, host):
            _, schur, attempts = collective_signature(res)
            assert schur == attempts >= res["niter"]


def test_real_volume_matches_dense_with_the_schur_signature(two):
    """Regime 2b at K = 4: OPTIMAL at the default tolerances, within 1e-7
    of the dense single-process solve; the largest collective at most
    n0² elements, and one n0×n0 all-reduce per factorization attempt."""
    r0 = two[0]["volume"]
    f = r0["dense_pobj"]
    for r in two:
        assert r["volume"]["status"] == OPT
        assert abs(r["volume"]["pobj"] - f) <= 1e-7 * max(1.0, abs(f))
    largest, schur, attempts = collective_signature(r0)
    n0 = VOLUME_DIMS[1]
    assert largest <= n0 * n0
    assert schur == attempts >= r0["niter"]


def test_uneven_k_is_refused_then_padded(two):
    for r in two:
        assert "pad_scenarios(dat, 4)" in r["uneven_k"]["error"]
    f = float(unsharded(UNEVEN).pobj)
    want = jax_schur(UNEVEN, pad_to=4)
    for r in two:
        assert_matches_jax(r["padded"], want, "float64")
        assert r["padded"]["status"] == OPT
        assert abs(r["padded"]["pobj"] - f) <= 1e-7 * max(1.0, abs(f))


def test_shard_batch_then_gather_lanes(two):
    """5 LPs over 2 ranks (3 + 2 lanes): the gathered statuses and
    iterations are the port's unsharded batched solve's, objectives within
    1e-12, and the JAX package's at the f64 bar."""
    dats = stack_lps_host(batch_problems(5, 6, 12, 7), device="cpu")
    want = batched_hsd_solve(DenseK1Backend(), HSDOptions(), dats)
    jax_want = jax_batch(5, 6, 12, 7, "float64", None)
    assert [r["batch"]["lanes"] for r in two] == [3, 2]
    for r in two:
        got = r["batch"]
        assert_matches_jax(got, jax_want, "float64")
        np.testing.assert_array_equal(got["status"], want.status.numpy())
        np.testing.assert_array_equal(got["niter"], want.niter.numpy())
        np.testing.assert_allclose(got["pobj"], want.pobj.numpy(),
                                   rtol=0, atol=1e-12)


def test_workers_import_no_jax(two, four):
    for r in two + four:
        assert r["modules"] == []


def test_grid_of_four(four):
    """The 2-D regime: 2 LPs × 2 scenario ranks, each lane within 1e-3 of
    its dense solve (the reference's bar at 1e-4), and of the JAX
    package's Schur solve of the same LP."""
    refs = four[0]["grid"]["dense_pobj"]
    wants = [jax_schur(two_stage_arrays(2, s), "float32", LOOSE)
             for s in (10, 11)]
    for r in four:
        assert_matches_jax(r["grid"], tuple(np.concatenate(w) for w in
                                            zip(*wants)), "float32")
    assert sorted(r["grid"]["grid"] for r in four) == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in four:
        assert (r["grid"]["status"] == OPT).all()
        for got, f in zip(r["grid"]["pobj"], refs):
            assert abs(float(got) - f) <= 1e-3 * max(1.0, abs(f))


def test_data_parallel_over_four(four):
    """Regime 1: 8 LPs over 4 ranks (2 each), all OPTIMAL, lane 0 within
    1e-3 of its single-LP solve."""
    f = four[0]["dp"]["lane0_pobj"]
    for r in four:
        assert (r["dp"]["status"] == OPT).all() and r["dp"]["lanes"] == 2
        assert abs(float(r["dp"]["pobj"][0]) - f) <= 1e-3 * max(1.0, abs(f))


def test_a_failing_rank_fails_the_job():
    """Rank 1 raises while rank 0 waits in a collective: the job fails
    with rank 1's error, well within its limit, and leaves no process."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        launch(run_cases, 2, device="cpu", timeout_s=60.0,
               args=([("drill", "fail", {})],))
    assert time.monotonic() - t0 < 60.0
    assert multiprocessing.active_children() == []


def test_nccl_without_cuda_raises(tmp_path, monkeypatch):
    """No group is made, and no silent switch to Gloo."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL"):
        init_comm("nccl", 0, 1, str(tmp_path / "store"))


def test_entry_points_default_to_the_card(monkeypatch):
    """``launch`` and the command line run the ranks on the card unless
    asked for the CPU: with no CUDA device they refuse before any process
    starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch(run_cases, 2, args=([],))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--procs", "2"])
    assert multiprocessing.active_children() == []
