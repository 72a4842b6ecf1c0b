"""Smoke run of the PyTorch port (tulip_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

Phases, each of which exits non-zero on a failed check:

1. device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit (nvidia-smi), torch's and CUDA's versions;
2. build: compiles ``tulip_tpu_torch/csrc/chol_inv.cu`` and
   ``csrc/scaled_gram.cu`` (one nvcc each, started together) and the C++
   host engines of ``native/`` (``make -C native``) from the checkout;
3. kernel: the chol-inv kernel against its plain PyTorch version on SPD
   batches, a non-SPD lane, and kernel vs plain time at (2048, 48),
   (2048, 64) and (1, 1024);
3b. kernel: the scaled-Gram kernel against its plain version at four
   shapes up to (1, 4096, 6240), and kernel vs plain time there;
4. slice: the batched f32 HSD solve of the repository's benchmark
   instances (2048 random 48x96 LPs, seed 0, tolerance 3e-4) through
   ``SmallK1Backend``: every lane OPTIMAL, objectives of 128 lanes against
   scipy's HiGHS, solves/s and mean iterations;
5. entry: ``batch_linprog`` at its defaults (f32, presolve) on 64 mixed
   problems in two shape buckets (one with m >= 200), with inequality rows,
   free variables, an infeasible and an unbounded instance; statuses and
   objectives against HiGHS;
6. single LP: ``Model.optimize()`` on the 64-stage staircase
   ``multiperiod_lp(4096)`` (m = 4096, n = 6240) in f32 through
   ``KKT_Backend="dense-pallas"`` (the scaled-Gram kernel), presolve on:
   OPTIMAL and the objective against HiGHS; then the same LP through
   ``"dense"`` (cuBLAS + cuSOLVER) for its wall;
7. single-LP entry at defaults: the CLI on ``tests/data/*.mps`` (f64) and
   ``Model.optimize()`` on ``multiperiod_lp(1024)`` in f64 (``"dense"``)
   and in f32 (``"pallas-small"``, the chol-inv kernel at B = 1).

Phases 4-5, 6 and 7 are the main path: each kernel's launch count is reset
just before each of them and read just after. The last two lines are a
JSON list of the kernels with their launches, errors and times, and the
JSON result ``{"ok": true, "device": {...}}``. ``--profile DIR`` also
writes torch.profiler tables of one warm slice solve and of the phase-6
solve to DIR.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import statistics
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

TOL = 3e-4
OPTIMAL = 2  # TerminationStatus.OPTIMAL
KERNEL_SHAPES = [(1, 8), (7, 48), (2048, 48), (2048, 64), (64, 100),
                 (8, 224), (16, 256), (4, 1024)]
TIMED_SHAPES = [(2048, 48), (2048, 64), (1, 1024)]
GRAM_SHAPES = [(1, 37, 200), (3, 300, 520), (2, 1000, 1500),
               (1, 4096, 6240)]
GRAM_TIMED = (1, 4096, 6240)
ROOT = os.path.dirname(os.path.abspath(__file__))


def log(*a):
    print(*a, flush=True)


def check(ok, what):
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def spd_batch(B, m, seed, device):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B, m, m))
    K = np.einsum("bij,bkj->bik", X, X) + m * np.eye(m)
    return torch.as_tensor(K, dtype=torch.float32, device=device)


def time_ms(fn, reps=20, warmup=3):
    """Median of ``reps`` CUDA-event timings of ``fn`` after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def make_raw_instances(nb, m, n, seed=0):
    """The benchmark's instances (bench.py:make_raw_instances): random
    feasible standard-form LPs, b = A x0 for x0 inside [0, u]."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(nb):
        A = rng.standard_normal((m, n))
        u = rng.uniform(1.0, 4.0, n)
        x0 = u * rng.uniform(0.2, 0.8, n)
        b = A @ x0
        c = rng.standard_normal(n)
        out.append((A, b, c, u))
    return out


def highs(c, method="highs", **kw):
    from scipy.optimize import linprog

    return linprog(c, method=method, **kw)


# ---------------------------------------------------------------------------
# Phase 3: kernel against plain version
# ---------------------------------------------------------------------------

def phase_kernel(device):
    from tulip_tpu_torch.ops.chol import (batched_cholesky_inverse,
                                          batched_cholesky_inverse_plain)

    errs = {}
    for B, m in KERNEL_SHAPES:
        K = spd_batch(B, m, seed=0, device=device)
        got = batched_cholesky_inverse(K)
        want = batched_cholesky_inverse_plain(K)
        torch.cuda.synchronize()
        check(torch.equal(torch.triu(got, 1), torch.zeros_like(got)),
              f"nonzero above the diagonal at (B, m) = ({B}, {m})")
        abs_err = (got - want).abs().max().item()
        rel = (torch.linalg.matrix_norm(got - want)
               / torch.linalg.matrix_norm(want)).max().item()
        errs[(B, m)] = abs_err
        log(f"  chol_inv (B={B:5d}, m={m:5d}): max|kernel-plain| "
            f"{abs_err:.3e}  max rel Frobenius {rel:.3e}")
        # f32 with a different summation order and FMA: an absolute bar
        # for m <= 100, a relative one above, where L⁻¹ spans more
        # magnitudes.
        if m <= 100:
            check(abs_err <= 1e-4, f"max abs err {abs_err} at ({B}, {m})")
        else:
            check(rel <= 1e-4, f"rel Frobenius err {rel} at ({B}, {m})")

    K = spd_batch(7, 48, seed=1, device=device)
    K[3] = -K[3]
    finite = torch.isfinite(batched_cholesky_inverse(K)).all(-1).all(-1)
    check(finite.tolist() == [True, True, True, False, True, True, True],
          f"non-SPD lane 3: finite lanes {finite.tolist()}")
    log("  non-SPD lane: non-finite in that lane only")

    times = {}
    for B, m in TIMED_SHAPES:
        K = spd_batch(B, m, seed=2, device=device)
        tk = time_ms(lambda: batched_cholesky_inverse(K))
        tp = time_ms(lambda: batched_cholesky_inverse_plain(K))
        times[(B, m)] = (tk, tp)
        log(f"  time (B={B}, m={m}): kernel {tk:.4f} ms, plain "
            f"(cholesky_ex + solve_triangular) {tp:.4f} ms, median of 20")
    return errs, times


# ---------------------------------------------------------------------------
# Phase 3b: scaled-Gram kernel against plain version
# ---------------------------------------------------------------------------

def gram_inputs(B, m, n, seed, device):
    """A with standard-normal entries and a scale d spanning six decades,
    as the IPM's D = (Θ⁻¹ + Rp)⁻¹ does late in a solve."""
    rng = np.random.default_rng(seed)
    A = torch.as_tensor(rng.standard_normal((B, m, n)), dtype=torch.float32,
                        device=device)
    d = torch.as_tensor(10.0 ** rng.uniform(-3, 3, (B, n)),
                        dtype=torch.float32, device=device)
    return A, d


def phase_gram(device):
    from tulip_tpu_torch.ops.gram import scaled_gram, scaled_gram_plain

    errs = {}
    for B, m, n in GRAM_SHAPES:
        A, d = gram_inputs(B, m, n, seed=m, device=device)
        got = scaled_gram(A, d)
        want = scaled_gram_plain(A, d)
        torch.cuda.synchronize()
        check(torch.equal(got, got.transpose(-1, -2)),
              f"scaled_gram K not symmetric at {(B, m, n)}")
        # Per lane: f32 sums of n terms in another order than cuBLAS's.
        err = (got - want).abs().amax(dim=(-1, -2))
        scale = want.abs().amax(dim=(-1, -2))
        rel = (err / scale).max().item()
        errs[(B, m, n)] = err.max().item()
        log(f"  scaled_gram (B={B}, m={m}, n={n}): max|kernel-plain| "
            f"{errs[(B, m, n)]:.3e}, per lane / max|K| <= {rel:.3e}")
        check(rel <= 1e-5, f"scaled_gram error {rel} > 1e-5 max|K| at "
              f"{(B, m, n)}")

    B, m, n = GRAM_TIMED
    A, d = gram_inputs(B, m, n, seed=5, device=device)
    tk = time_ms(lambda: scaled_gram(A, d))
    tp = time_ms(lambda: scaled_gram_plain(A, d))
    full = 2.0 * B * m * m * n
    log(f"  time {GRAM_TIMED}: kernel {tk:.4f} ms, plain ((A*d) @ A^T, "
        f"cuBLAS f32) {tp:.4f} ms, median of 20; 2*m^2*n = {full:.4e} FLOP "
        f"-> kernel {full / tk / 1e9:.3f}, plain {full / tp / 1e9:.3f} "
        f"TFLOP/s (the kernel computes the lower tiles only, "
        f"{full / 2 / tk / 1e9:.3f} TFLOP/s of its own work)")
    return errs, (tk, tp)


# ---------------------------------------------------------------------------
# Phases 6 and 7: one LP
# ---------------------------------------------------------------------------

def staircase_lp(m, mr=64, nc=96, seed=0):
    """Staircase equality LP, a copy of tests/golden_large.py:staircase_lp
    (same seed, same LP) without the JAX package that file imports:
    min c'x s.t. Ax = b, 0 <= x <= u, b = A x0 for an interior x0."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    stages = m // mr
    n = stages * nc + nc
    I, J, V = [], [], []
    for s in range(stages):
        for c0 in (s * nc, (s + 1) * nc):
            ii, jj = np.meshgrid(np.arange(s * mr, (s + 1) * mr),
                                 np.arange(c0, c0 + nc), indexing="ij")
            I.append(ii.ravel())
            J.append(jj.ravel())
            V.append(rng.standard_normal(mr * nc))
    I, J, V = map(np.concatenate, (I, J, V))
    A = sp.csr_matrix((V, (I, J)), shape=(m, n))
    u = rng.uniform(1, 3, n)
    x0 = u * rng.uniform(0.3, 0.7, n)
    return A, np.asarray(A @ x0), rng.standard_normal(n), u


def highs_staircase(A, b, c, u):
    """HiGHS's optimum (its interior-point method: the dual simplex takes
    minutes at m = 4096)."""
    r = highs(c, method="highs-ipm", A_eq=A, b_eq=b,
              bounds=list(zip(np.zeros(A.shape[1]), u)))
    check(r.status == 0, f"HiGHS failed on the staircase: {r.message}")
    return float(r.fun)


def staircase_model(lp, device, dtype, backend=None):
    """A Model holding the staircase LP, bulk-loaded as
    tests/golden_large.py:load_model does."""
    from tulip_tpu_torch import Model

    A, b, c, u = lp
    coo = A.tocoo()
    mod = Model(device=device)
    mod.pbdata.load(True, c, 0.0, (coo.row, coo.col, coo.data), b, b,
                    np.zeros(A.shape[1]), u, name="staircase")
    mod.params.ArithmeticDtype = dtype
    mod.params.KKT.Backend = backend
    return mod


def solve_model(mod):
    """Optimize; returns (status, objective, wall seconds)."""
    from tulip_tpu_torch import get_attribute

    t0 = time.perf_counter()
    st = mod.optimize()
    wall = time.perf_counter() - t0
    return st, get_attribute(mod, "ObjectiveValue"), wall


def check_objective(what, z, ref, tol):
    err = abs(z - ref) / max(1.0, abs(ref))
    check(err <= tol, f"{what}: objective {z} vs HiGHS {ref} (rel {err:.3e} "
          f"> {tol})")
    return err


def describe(mod, wall):
    t = ", ".join(f"{k} {v:.4f} s" for k, v in mod.timings.items())
    it = mod.barrier_iterations
    return (f"{it} iterations, wall {wall:.4f} s ({t}); "
            f"{mod.timings['ipm'] / max(it, 1) * 1e3:.3f} ms per iteration")


def run_cli(path, device):
    """The CLI's ``main`` at its defaults; returns (rc, objective or None,
    iteration-log rows)."""
    from tulip_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([path], device=device)
    out = buf.getvalue()
    z = None
    for line in out.splitlines():
        if line.startswith("result:") and " objective " in line:
            z = float(line.split(" objective ")[1].split()[0])
    rows = sum(1 for line in out.splitlines()
               if line[:4].strip().isdigit() and "e" in line)
    return rc, z, rows


# ---------------------------------------------------------------------------
# Phases 4 and 5: the main path
# ---------------------------------------------------------------------------

def slice_inputs(device, nb):
    from tulip_tpu_torch.ipm.batch import stack_lps_host
    from tulip_tpu_torch.ipm.hsd import HSDOptions

    raws = make_raw_instances(nb, 48, 96, seed=0)
    dats = stack_lps_host(
        [(A, b, c, 0.0, np.zeros(len(c)), u) for (A, b, c, u) in raws],
        device=device, dtype=torch.float32)
    opts = HSDOptions(TolerancePFeas=TOL, ToleranceDFeas=TOL,
                      ToleranceRGap=TOL, ToleranceIFeas=TOL,
                      PRegMin=1e-6, DRegMin=1e-6)
    return raws, dats, opts


def entry_problems(rng):
    """64 LPs for batch_linprog: 58 small ones with equality and
    inequality rows and free variables, 4 with 210 equality rows (their
    bucket has m = 256, so the kernel's device-memory path runs), one
    infeasible and one unbounded."""
    probs = []
    for _ in range(58):
        m_eq, m_ub = int(rng.integers(8, 16)), int(rng.integers(4, 10))
        n = int(rng.integers(30, 44))
        u = rng.uniform(1.0, 4.0, n)
        x0 = u * rng.uniform(0.2, 0.8, n)
        x0[:3] = rng.standard_normal(3)
        A_eq = rng.standard_normal((m_eq, n))
        A_ub = rng.standard_normal((m_ub, n))
        bounds = [(None, None)] * 3 + [(0.0, float(v)) for v in u[3:]]
        probs.append(dict(c=rng.standard_normal(n), A_eq=A_eq,
                          b_eq=A_eq @ x0, A_ub=A_ub,
                          b_ub=A_ub @ x0 + rng.uniform(0.1, 1.0, m_ub),
                          bounds=bounds))
    for _ in range(4):
        m, n = 210, 300
        A = rng.standard_normal((m, n))
        u = rng.uniform(1.0, 4.0, n)
        x0 = u * rng.uniform(0.2, 0.8, n)
        probs.append(dict(c=rng.standard_normal(n), A_eq=A, b_eq=A @ x0,
                          bounds=[(0.0, float(v)) for v in u]))
    # Infeasible: x1 + x2 = 1, x1 - x2 = 3 with 0 <= x <= 1.
    probs.append(dict(c=[1.0, 1.0], A_eq=[[1.0, 1.0], [1.0, -1.0]],
                      b_eq=[1.0, 3.0], bounds=[(0.0, 1.0)] * 2))
    # Unbounded: min -x1 with x1 - x2 = 0, x >= 0.
    probs.append(dict(c=[-1.0, 0.0, 0.0], A_eq=[[1.0, -1.0, 0.0]],
                      b_eq=[0.0], A_ub=[[0.0, 0.0, 1.0]], b_ub=[2.0]))
    return probs


def check_slice(raws, out, n_ref):
    st = out.status.cpu().numpy()
    n_opt = int((st == OPTIMAL).sum())
    check(n_opt == len(raws), f"slice: {n_opt}/{len(raws)} lanes OPTIMAL")
    pobj = out.pobj.cpu().numpy()
    worst = 0.0
    for k in range(min(n_ref, len(raws))):
        A, b, c, u = raws[k]
        r = highs(c, A_eq=A, b_eq=b, bounds=[(0, ub) for ub in u])
        check(r.status == 0, f"HiGHS failed on lane {k}")
        err = abs(pobj[k] - r.fun) / max(1.0, abs(r.fun))
        worst = max(worst, err)
        check(err <= 1e-2, f"slice lane {k}: pobj {pobj[k]} vs HiGHS {r.fun}")
    return n_opt, worst


def check_entry(probs, res):
    worst = 0.0
    for k, (p, r) in enumerate(zip(probs, res)):
        ref = highs(p["c"], A_ub=p.get("A_ub"), b_ub=p.get("b_ub"),
                    A_eq=p.get("A_eq"), b_eq=p.get("b_eq"),
                    bounds=p.get("bounds", (0, None)))
        check(r.status == ref.status,
              f"entry problem {k}: status {r.status} ({r.message}) vs "
              f"HiGHS {ref.status}")
        if ref.status == 0:
            err = abs(r.fun - ref.fun) / max(1.0, abs(ref.fun))
            worst = max(worst, err)
            check(err <= 1e-2,
                  f"entry problem {k}: fun {r.fun} vs HiGHS {ref.fun}")
    return worst


def profile_solve(solve, path, wall_s):
    """torch.profiler table of one ``solve`` into ``path``; returns the
    summed kernel time in ms. The profiled run's own wall is inflated by
    the profiler, so the idle share is taken against ``wall_s``, the
    median unprofiled wall of the same solve."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        solve()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in ka
                  if e.device_type == DeviceType.CUDA) / 1e3
    n_kernels = sum(e.count for e in ka if e.device_type == DeviceType.CUDA)
    summary = (f"kernel time {busy_ms:.3f} ms in {n_kernels} kernel "
               f"launches; unprofiled wall {wall_s * 1e3:.3f} ms; device "
               f"idle share {1 - busy_ms / (wall_s * 1e3):.4f}")
    with open(path, "w") as f:
        f.write(summary + "\n" + ka.table(sort_by="self_cuda_time_total",
                                          row_limit=40) + "\n")
    log(f"  profile: {summary} -> {path}")
    return busy_ms


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="write torch.profiler tables of one warm slice "
                         "solve and of the phase-6 solve to DIR")
    args = ap.parse_args(argv)

    # -- 1. device ---------------------------------------------------------
    check(torch.cuda.is_available(), "no CUDA device")
    from tulip_tpu_torch import _build, batch_linprog
    from tulip_tpu_torch.ipm.batch import batched_hsd_solve
    from tulip_tpu_torch.kkt import DenseK1Backend, SmallK1Backend
    from tulip_tpu_torch.ops import chol, gram

    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    check(smi.returncode == 0 and card, f"nvidia-smi failed: {smi.stderr}")
    log(f"[1] device: {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as ex:
        libs = {name: ex.submit(_build.build, name)
                for name in ("chol_inv", "scaled_gram")}
        make = ex.submit(subprocess.run, ["make", "-C",
                                          os.path.join(ROOT, "native")],
                         capture_output=True, text=True, timeout=600)
        libs = {name: f.result() for name, f in libs.items()}
        make = make.result()
    check(make.returncode == 0,
          f"make -C native failed:\n{make.stdout}{make.stderr}")
    from tulip_tpu_torch.io.native import native_available as mps_native
    from tulip_tpu_torch.presolve.native import \
        native_available as presolve_native
    check(mps_native() and presolve_native(),
          "native MPS reader / presolve engine built but did not load")
    log(f"[2] build: {', '.join(p.name for p in libs.values())} and "
        f"native/ in {time.perf_counter() - t0:.2f} s (in parallel)")
    for name, lib in libs.items():
        ptxas = lib.with_name(lib.name + ".log")
        if ptxas.exists():
            for line in ptxas.read_text().splitlines():
                if "Used" in line or "spill" in line:
                    log(f"  {name}: {line.strip()}")

    # -- 3. kernel vs plain ------------------------------------------------
    log("[3] kernel vs plain version")
    errs, times = phase_kernel(device)
    log("[3b] scaled_gram kernel vs plain version")
    gram_errs, gram_times = phase_gram(device)

    # -- 4 + 5. the main path, counted -------------------------------------
    raws, dats, opts = slice_inputs(device, 2048)
    probs = entry_problems(np.random.default_rng(1))
    backend = SmallK1Backend(refinement_steps=1)
    torch.cuda.synchronize()
    chol.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    out = batched_hsd_solve(backend, opts, dats)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches_slice = chol.KERNEL_LAUNCHES
    res = batch_linprog(probs)
    launches = chol.KERNEL_LAUNCHES
    check(launches_slice > 0, "slice: the chol-inv kernel never launched")
    check(launches > launches_slice,
          "entry: the chol-inv kernel never launched")

    log(f"[4] slice: B={len(raws)} 48x96 f32 tol {TOL}, first solve "
        f"{t_first:.3f} s, {launches_slice} kernel launches")
    n_opt, worst = check_slice(raws, out, n_ref=128)
    iters = out.niter.cpu().numpy()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        batched_hsd_solve(backend, opts, dats).status.cpu()
        walls.append(time.perf_counter() - t0)
    plain_walls = []
    plain = DenseK1Backend(inv_factor=True, refinement_steps=1)
    for _ in range(3):
        t0 = time.perf_counter()
        o = batched_hsd_solve(plain, opts, dats)
        o.status.cpu()
        plain_walls.append(time.perf_counter() - t0)
    check(bool((o.status == OPTIMAL).all()), "slice with the plain backend: "
          "not every lane OPTIMAL")
    wall, pwall = statistics.median(walls), statistics.median(plain_walls)
    log(f"  {n_opt}/{len(raws)} OPTIMAL, mean iterations {iters.mean():.4f} "
        f"(max {iters.max()}), worst rel obj err vs HiGHS (128 lanes) "
        f"{worst:.3e}")
    log(f"  wall median of 5: {wall:.4f} s = {len(raws) / wall:.2f} solves/s"
        f"; same solve through DenseK1Backend(inv_factor) (cuSOLVER): "
        f"{pwall:.4f} s = {len(raws) / pwall:.2f} solves/s")
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        profile_solve(lambda: batched_hsd_solve(backend, opts, dats),
                      os.path.join(args.profile, "profile_slice.txt"), wall)

    worst_e = check_entry(probs, res)
    log(f"[5] entry: batch_linprog on {len(probs)} problems, statuses match "
        f"HiGHS, worst rel obj err {worst_e:.3e}; "
        f"{launches - launches_slice} kernel launches")

    # -- 6. one LP through dense-pallas, counted ---------------------------
    big = staircase_lp(4096)
    ref_big = highs_staircase(*big)
    mod = staircase_model(big, device, "float32", "dense-pallas")
    torch.cuda.synchronize()
    gram.KERNEL_LAUNCHES = 0
    st, z, wall = solve_model(mod)
    torch.cuda.synchronize()
    launches_gram = gram.KERNEL_LAUNCHES
    check(st.name == "OPTIMAL", f"single LP (dense-pallas): status {st.name}")
    check(launches_gram > 0, "single LP: the scaled_gram kernel never "
          "launched")
    check(mod.kkt_backend.name == "dense-pallas",
          f"single LP ran backend {mod.kkt_backend.name!r}")
    err = check_objective("single LP (dense-pallas)", z, ref_big, 1e-3)
    log(f"[6] single LP: multiperiod_lp(4096), m={big[0].shape[0]}, "
        f"n={big[0].shape[1]}, f32 dense-pallas, presolve on: OPTIMAL, "
        f"objective {z!r} vs HiGHS {ref_big!r} (rel {err:.3e}); "
        f"{describe(mod, wall)}; {launches_gram} scaled_gram launches")
    mod_d = staircase_model(big, device, "float32", "dense")
    st_d, z_d, wall_d = solve_model(mod_d)
    check(st_d.name == "OPTIMAL", f"single LP (dense f32): {st_d.name}")
    log(f"  same LP through KKT_Backend='dense' (cuBLAS + cuSOLVER), f32: "
        f"objective {z_d!r}; {describe(mod_d, wall_d)}")
    if args.profile:
        profile_solve(lambda: mod.optimize(),
                      os.path.join(args.profile, "profile_single_lp.txt"),
                      wall)

    # -- 7. single-LP entry at defaults, counted ---------------------------
    chol.KERNEL_LAUNCHES = 0
    want = {"lp_opt": (0, 1.5), "lp_inf": (1, None), "lp_ubd": (1, None),
            "lp_freevars": (0, 0.0)}
    for name, (rc_want, z_want) in want.items():
        rc, zc, rows = run_cli(os.path.join(ROOT, "tests", "data",
                                            f"{name}.mps"), device)
        check(rc == rc_want, f"cli {name}: rc {rc}, expected {rc_want}")
        if z_want is not None:
            check(zc is not None and abs(zc - z_want) <= 1e-6,
                  f"cli {name}: objective {zc}, expected {z_want}")
        log(f"[7] cli {name}.mps (f64 default): rc {rc}, objective {zc!r}, "
            f"{rows} iteration-log rows")
    small = staircase_lp(1024)
    ref_small = highs_staircase(*small)
    mod64 = staircase_model(small, device, "float64")
    st64, z64, wall64 = solve_model(mod64)
    check(st64.name == "OPTIMAL", f"multiperiod_lp(1024) f64: {st64.name}")
    check(mod64.kkt_backend.name == "dense", "f64 default did not route to "
          f"'dense' but {mod64.kkt_backend.name!r}")
    err64 = check_objective("multiperiod_lp(1024) f64", z64, ref_small, 1e-6)
    log(f"  multiperiod_lp(1024) f64 default (dense): objective {z64!r} vs "
        f"HiGHS {ref_small!r} (rel {err64:.3e}); {describe(mod64, wall64)}")
    mod32 = staircase_model(small, device, "float32")
    st32, z32, wall32 = solve_model(mod32)
    torch.cuda.synchronize()
    launches_entry = chol.KERNEL_LAUNCHES
    check(st32.name == "OPTIMAL", f"multiperiod_lp(1024) f32: {st32.name}")
    check(mod32.kkt_backend.name == "pallas-small", "f32 default did not "
          f"route to 'pallas-small' but {mod32.kkt_backend.name!r}")
    check(launches_entry > 0, "f32 default single LP: the chol-inv kernel "
          "never launched")
    err32 = check_objective("multiperiod_lp(1024) f32", z32, ref_small, 1e-3)
    log(f"  multiperiod_lp(1024) f32 default (pallas-small): objective "
        f"{z32!r} vs HiGHS (rel {err32:.3e}); {describe(mod32, wall32)}; "
        f"{launches_entry} chol_inv launches")

    tk, tp = times[(2048, 48)]
    gk, gp = gram_times
    kernels = [{
        "name": "chol_inv",
        "route": "cuda",
        "source": "tulip_tpu_torch/csrc/chol_inv.cu",
        "replaces": "tulip_tpu/ops/chol.py:42",
        "launches": launches + launches_entry,
        "max_abs_err": errs[(2048, 48)],
        "ms": tk,
        "plain_ms": tp,
    }, {
        "name": "scaled_gram",
        "route": "cuda",
        "source": "tulip_tpu_torch/csrc/scaled_gram.cu",
        "replaces": "tulip_tpu/kkt/pallas_chol.py:36",
        "launches": launches_gram,
        "max_abs_err": gram_errs[GRAM_TIMED],
        "ms": gk,
        "plain_ms": gp,
    }]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
