"""Smoke run of the PyTorch port (tulip_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

Phases, each of which exits non-zero on a failed check:

1. device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit (nvidia-smi), torch's and CUDA's versions;
2. build: compiles ``tulip_tpu_torch/csrc/chol_inv.cu``,
   ``csrc/scaled_gram.cu`` and ``csrc/fused_solve.cu`` (one nvcc each,
   started together) and the C++ host engines of ``native/``
   (``make -C native``) from the checkout;
3. kernel: the chol-inv kernel's registers, local memory and resident
   groups an SM (shared-memory path), then the kernel against its plain
   PyTorch version on SPD batches (its blocked path at m > 224 included,
   at ragged m too), a non-SPD lane in each path and one that fails past
   column 32 (in the second panel), and kernel vs plain time at
   (2048, 48), (2048, 64), (64, 100), (8, 224), (1, 224), (4, 256) and
   (1, 1024); the packed launch (p instances per block) at (2048, 48) with
   p = 2, 4 and (2048, 64) with p = 2 against the plain version and the
   unpacked launch, non-SPD lanes inside a packed block, and its time
   beside the unpacked launch's;
3b. kernel: the scaled-Gram kernel against its plain version at four
   shapes up to (1, 4096, 6240), both against the plain version in f64 at
   (2, 1000, 1500), and kernel vs plain vs one-einsum time at the largest;
3c. kernel: the fused K1 solve's staged body (registers, local memory and
   resident instances an SM, loaded by bulk copies and by 4-byte copies),
   then the kernel against its plain version at (2048, 48, 96),
   (7, 48, 96), (4, 256, 512), (1, 1024, 2048), (2, 64, 8192) (its
   n-long vectors in device memory), (5, 45, 91), (3, 13, 7) and
   (2, 48, 1010) (ragged: 4-byte copies), refine 0 (three seeds, held
   against the plain version in f64) and 1 (against it in f32 and in f64);
   inputs that are views off 16 bytes against the aligned launch, bit for
   bit; a non-finite lane at (6, 48, 96) and (6, 45, 91); and kernel vs
   plain time at (2048, 48, 96), refine 1;
4. slice: the batched f32 HSD solve of the repository's benchmark
   instances (2048 random 48x96 LPs, seed 0, tolerance 3e-4) through
   ``SmallK1Backend``: every lane OPTIMAL, objectives of 128 lanes against
   scipy's HiGHS, solves/s and mean iterations;
4b. slice: the same solve through ``SmallK1Backend(fused_solve=True)``
   (the fused solve kernel), with the same checks;
5. entry: ``batch_linprog`` at its defaults (f32, presolve) on 64 mixed
   problems in two shape buckets (one with m >= 200), with inequality rows,
   free variables, an infeasible and an unbounded instance; statuses and
   objectives against HiGHS;
5b. entry: the same through the fused backend; the m = 256 bucket runs the
   fused kernel's device-memory path;
6. single LP: ``Model.optimize()`` on the 64-stage staircase
   ``multiperiod_lp(4096)`` (m = 4096, n = 6240) in f32 through
   ``KKT_Backend="dense-pallas"`` (the scaled-Gram kernel), presolve on:
   OPTIMAL and the objective against HiGHS; then the same LP through
   ``"dense"`` (cuBLAS + cuSOLVER) for its wall;
6b. structured route: ``Model.optimize()`` at its defaults (no backend
   named: the structure probe picks) on ``multiperiod_lp(4096)`` in f64
   and f32 (HSD) and in f64 with ``IPM_Algorithm="MPC"``, which must run
   ``"banded"`` through its level engine, and on
   ``scattered_coupling_lp(2048)`` in f64, which must run ``"sparse"``
   through its level engine: OPTIMAL, the objective against HiGHS (1e-6
   in f64, 1e-3 in f32); iterations, walls, ``Model.timings`` and ms per
   iteration beside phase 6's walls on the same LP. No kernel of ours is
   on this route (the level engine is torch.linalg and cuBLAS);
7. single-LP entry at defaults: the CLI on ``tests/data/*.mps`` (f64) and
   ``Model.optimize()`` on ``multiperiod_lp(1024)`` in f64 (``"dense"``)
   and in f32 (``"pallas-small"``, the chol-inv kernel at B = 1);
8. MPC: ``batch_linprog(algorithm="MPC")`` at its defaults on the 64
   problems of phase 5 (statuses as the JAX package gives them on the CPU,
   objectives against HiGHS), ``Model`` with ``IPM_Algorithm="MPC"`` on
   ``multiperiod_lp(1024)`` in f64, and the CLI's ``--Method MPC`` on
   ``tests/data/*.mps``;
9. warm re-solve: ``b`` of the 2048 slice instances perturbed by 1%
   (seeded), re-solved by ``batched_hsd_resolve`` from phase 4b's final
   state through the fused backend with the packed chol-inv launch (4
   instances per block), against a cold solve;
10. kernels at the main path's shapes: every (B, m, n, refine) that phases
   4-9 gave the fused solve and every (B, m, instances per block) they gave
   the chol-inv kernel, held against the plain version on seeded inputs of
   that shape with phase 3's and 3c's bars; the chol-inv shapes must
   include the blocked path's (1, 1024) and an m = 256 bucket.

Phases 4-9 (6b included) are the main path: every kernel's launch count
is reset just before each of them and read just after. The last lines are the card's
name and power limit, a JSON list of the kernels with their launches,
errors, times and bounds, and the JSON result
``{"ok": true, "device": {...}}``. ``--profile DIR`` also writes
torch.profiler tables of one warm slice solve (phases 4 and 4b), of the
phase-6 solve and of phase 6b's banded f32 solve to DIR.
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
                 (8, 224), (1, 225), (16, 256), (3, 300), (2, 512),
                 (1, 1000), (4, 1024)]
TIMED_SHAPES = [(2048, 48), (2048, 64), (64, 100), (8, 224), (1, 224),
                (4, 256), (1, 1024)]
BLOCKED_TIMED = (1, 1024)
GRAM_F64_SHAPE = (2, 1000, 1500)
GRAM_SHAPES = [(1, 37, 200), (3, 300, 520), (2, 1000, 1500),
               (1, 4096, 6240)]
GRAM_TIMED = (1, 4096, 6240)
PACKED_SHAPES = [(2048, 48, 2), (2048, 48, 4), (2048, 64, 2)]
# Instances per block of the packed chol-inv launch on the main path
# (phase 9).
PACK = 4
FUSED_SHAPES = [(2048, 48, 96), (7, 48, 96), (4, 256, 512), (1, 1024, 2048),
                (2, 64, 8192), (5, 45, 91), (3, 13, 7), (2, 48, 1010)]
FUSED_TIMED = (2048, 48, 96)
# The fused solve's shape on the m = 256 bucket of phases 5b and 8 (the
# layout that reads A and L⁻¹ from device memory), timed in phase 10.
STREAMED_TIMED = (4, 256, 512)
# JAX package's batch_linprog(algorithm="MPC") at its defaults (f32) on the
# 64 problems of entry_problems, on the CPU: 62 OPTIMAL, the infeasible
# instance NUMERICAL_PROBLEM, the unbounded one DUAL_INFEASIBLE (decided by
# presolve). scipy codes: 0 optimal, 4 numerical, 3 unbounded.
MPC_ENTRY_STATUS = [0] * 62 + [4, 3]
# NVIDIA H100 SXM's published peaks (data sheet, dense, 700 W): device
# memory bandwidth, float32 outside the tensor cores, and TF32 in them.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
PEAK_TF32_S = 495e12
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


def bound_ms(nbytes, flops, peak=PEAK_F32_S):
    """(least time in ms, what bounds it): the bytes the function must
    move over the memory rate, or its operations over the peak rate of
    the unit that does them (float32 outside the tensor cores unless
    ``peak`` says otherwise), whichever is larger."""
    tb, tf = nbytes / PEAK_BYTES_S * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def chol_bound(B, m):
    """K read and L⁻¹ written in full (f32); ⅔m³ operations an instance
    (Cholesky m³/3, triangular inverse m³/3)."""
    return bound_ms(2 * B * m * m * 4, B * 2 * m ** 3 / 3)


def fused_bound(B, m, n, refine):
    """A, the lower triangle of L⁻¹ and the five input vectors read, dx and
    dy written; the products' multiply-adds and the elementwise steps."""
    nbytes = B * (m * n + m * (m + 1) // 2 + 3 * n + 2 * m + n + m) * 4
    base = 4 * m * n + 2 * m * (m + 1) + 3 * n + m
    sweep = 2 * m * n + 5 * n + 4 * m
    return bound_ms(nbytes, B * ((1 + refine) * base + refine * sweep))


def gram_bound(B, m, n):
    """A and d read, K written; the lower half m(m+1)n of 2m²n operations,
    since K is symmetric, three times over (the kernel makes each f32
    product of three TF32 products), at the tensor cores' TF32 rate."""
    return bound_ms(B * (m * n + n + m * m) * 4, 3 * B * m * (m + 1) * n,
                    PEAK_TF32_S)


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

def hold_chol(B, m, pack, seed, device):
    """The chol-inv kernel (``pack`` instances per block) against its
    plain version on an SPD batch; returns max|kernel − plain|."""
    from tulip_tpu_torch.ops.chol import (batched_cholesky_inverse,
                                          batched_cholesky_inverse_plain)

    K = spd_batch(B, m, seed=seed, device=device)
    got = batched_cholesky_inverse(K, pack=pack)
    want = batched_cholesky_inverse_plain(K)
    torch.cuda.synchronize()
    check(torch.equal(torch.triu(got, 1), torch.zeros_like(got)),
          f"nonzero above the diagonal at (B, m, pack) = ({B}, {m}, {pack})")
    abs_err = (got - want).abs().max().item()
    rel = (torch.linalg.matrix_norm(got - want)
           / torch.linalg.matrix_norm(want)).max().item()
    log(f"  chol_inv (B={B:5d}, m={m:5d}, pack {pack}): max|kernel-plain| "
        f"{abs_err:.3e}  max rel Frobenius {rel:.3e}")
    # f32 with a different summation order and FMA: an absolute bar for
    # m <= 100, a relative one above, where L⁻¹ spans more magnitudes.
    if m <= 100:
        check(abs_err <= 1e-4, f"max abs err {abs_err} at ({B}, {m}, {pack})")
    else:
        check(rel <= 1e-4, f"rel Frobenius err {rel} at ({B}, {m}, {pack})")
    return abs_err


def chol_occupancy(lib, m, p):
    """(registers a thread, local bytes a thread, instances resident on an
    SM, threads an instance) of the shared-memory path's launch at m with
    p instances a block."""
    import ctypes

    vals = [ctypes.c_int(0) for _ in range(4)]
    err = lib.tulip_chol_inv_occupancy(m, p, 0, *map(ctypes.byref, vals))
    check(err == 0, f"tulip_chol_inv_occupancy({m}, {p}): cudaError {err}")
    regs, local, blocks, group = (v.value for v in vals)
    return regs, local, blocks * p, group


def nonspd_lanes(B, m, pack, bad, device, past_panel=False):
    """Lane ``bad`` of an SPD batch made non-SPD: negated whole (its first
    pivot fails) or, with ``past_panel``, only its pivot 40 made negative
    (its leading 40 x 40 block stays SPD, so it fails in the second
    panel). Checks that it alone is non-finite."""
    from tulip_tpu_torch.ops.chol import batched_cholesky_inverse

    K = spd_batch(B, m, seed=1, device=device)
    if past_panel:
        K[bad, 40, 40] = -1.0
    else:
        K[bad] = -K[bad]
    finite = torch.isfinite(batched_cholesky_inverse(K, pack=pack)) \
        .all(-1).all(-1).tolist()
    check(finite == [b != bad for b in range(B)],
          f"non-SPD lane {bad} of ({B}, {m}), pack {pack}"
          f"{', past column 32' if past_panel else ''}: finite lanes "
          f"{finite}")
    log(f"  non-SPD lane {bad} of ({B}, {m}), pack {pack}"
        f"{' (fails at pivot 40)' if past_panel else ''}: non-finite in "
        f"that lane only")


def phase_kernel(device, lib):
    from tulip_tpu_torch.ops.chol import (batched_cholesky_inverse,
                                          batched_cholesky_inverse_plain)
    from tulip_tpu_torch.time_kernels import device_ms

    for m, p in [(48, 1), (48, PACK), (64, 1), (100, 1), (224, 1)]:
        regs, local, groups, group = chol_occupancy(lib, m, p)
        check(local == 0, f"chol_inv at m = {m}: {local} bytes of local "
              f"memory a thread (spills)")
        log(f"  shared-memory path m={m}, {p} a block: {regs} registers and "
            f"{local} bytes of local memory a thread, {group} threads an "
            f"instance, {groups} instances resident an SM")
    errs = {(B, m): hold_chol(B, m, 0, 0, device) for B, m in KERNEL_SHAPES}

    nonspd_lanes(7, 48, 0, 3, device)
    for m in (48, 100):
        nonspd_lanes(6, m, 0, 2, device, past_panel=True)
    nonspd_lanes(3, 512, 0, 1, device)

    times = {}
    for B, m in TIMED_SHAPES:
        K = spd_batch(B, m, seed=2, device=device)
        tk = time_ms(lambda: batched_cholesky_inverse(K))
        tp = time_ms(lambda: batched_cholesky_inverse_plain(K))
        td = device_ms(lambda: batched_cholesky_inverse(K))
        times[(B, m)] = (tk, tp, td)
        bound, by = chol_bound(B, m)
        log(f"  time (B={B}, m={m}): kernel {tk:.4f} ms (device time "
            f"{td:.4f} ms), plain (cholesky_ex + solve_triangular) {tp:.4f} "
            f"ms, median of 20; bound {bound:.4f} ms ({by}), kernel's device "
            f"time at {bound / td:.4f} of it")
    return errs, times


def phase_packed(device):
    """The packed launch against the plain version and the unpacked
    launch (the same kernel body per instance, so the same bits), non-SPD
    lanes inside a packed block, and its time beside the unpacked launch's
    at the same shape."""
    from tulip_tpu_torch.ops.chol import (batched_cholesky_inverse,
                                          batched_cholesky_inverse_plain)
    from tulip_tpu_torch.time_kernels import device_ms

    out = {}
    for B, m, p in PACKED_SHAPES:
        K = spd_batch(B, m, seed=3, device=device)
        got = batched_cholesky_inverse(K, pack=p)
        one = batched_cholesky_inverse(K)
        want = batched_cholesky_inverse_plain(K)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        vs_one = (got - one).abs().max().item()
        check(err <= 1e-4, f"packed chol_inv p={p} at ({B}, {m}): max err "
              f"{err} vs plain")
        check(torch.equal(torch.triu(got, 1), torch.zeros_like(got)),
              f"packed chol_inv p={p}: nonzero above the diagonal")
        tpk = time_ms(lambda: batched_cholesky_inverse(K, pack=p))
        tk = time_ms(lambda: batched_cholesky_inverse(K))
        tp = time_ms(lambda: batched_cholesky_inverse_plain(K))
        out[(B, m, p)] = (err, tpk, tk, tp, device_ms(
            lambda: batched_cholesky_inverse(K, pack=p)))
        bound, by = chol_bound(B, m)
        log(f"  packed p={p} (B={B}, m={m}): max|packed-plain| {err:.3e}, "
            f"max|packed-unpacked| {vs_one:.3e}; packed {tpk:.4f} ms, "
            f"unpacked {tk:.4f} ms, plain {tp:.4f} ms, median of 20; bound "
            f"{bound:.4f} ms ({by}), packed at {bound / tpk:.4f} of it")
    nonspd_lanes(8, 48, PACK, 5, device)
    for m in (48, 100):
        nonspd_lanes(8, m, PACK, 5, device, past_panel=True)
    return out


# ---------------------------------------------------------------------------
# Phase 3c: fused K1 solve kernel against plain version
# ---------------------------------------------------------------------------

def fused_inputs(B, m, n, seed, device):
    """treg spanning 10^±2, regD 1e-4, Li = L⁻¹ of K = A diag(1/treg) Aᵀ +
    diag(regD) (the plain chol-inv in f64), random right-hand sides: the
    inputs of tests/test_pallas_ops.py:91-122."""
    from tulip_tpu_torch.ops.chol import batched_cholesky_inverse_plain

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
    K = ((A64 * d.double()[:, None, :]) @ A64.transpose(1, 2)
         + torch.diag_embed(regD.double()))
    Li = batched_cholesky_inverse_plain(K).float()
    return A, Li, d, treg, regD, xi_p, xi_d


def hold_fused(B, m, n, refine, seeds, device):
    """The fused solve kernel against its plain version on seeded inputs of
    one shape; returns max|kernel − plain f32|. Errors are per lane, over
    max(1, max|exact|), where exact is the plain version in f64 on the same
    inputs. With a sweep, the kernel is held within 1e-4 of the plain
    version in f32 and of exact. Without one, the factor's conditioning
    (treg spans 10^±2, regD 1e-4) puts each f32 implementation up to ~1e-4
    from exact over thousands of lanes, so no fixed bar near that is safe:
    the kernel's worst lane is held within twice the plain f32 version's
    worst lane (+1e-6) of exact. A wrong kernel is off by O(1)."""
    from tulip_tpu_torch.ops.solve import (batched_fused_k1_solve,
                                           batched_fused_k1_solve_plain)

    rel, abs_err = [0.0, 0.0, 0.0], 0.0
    for seed in seeds:
        args = fused_inputs(B, m, n, seed=seed, device=device)
        got = batched_fused_k1_solve(*args, refine=refine)
        want = batched_fused_k1_solve_plain(*args, refine=refine)
        exact = batched_fused_k1_solve_plain(*[a.double() for a in args],
                                             refine=refine)
        torch.cuda.synchronize()
        for g, w, e in zip(got, want, exact):
            scale = e.abs().amax(-1).clamp_min(1.0)
            for k, (x, y) in enumerate([(g, w), (g, e), (w, e)]):
                rel[k] = max(rel[k], ((x.double() - y).abs().amax(-1)
                                      / scale).max().item())
            abs_err = max(abs_err, (g - w).abs().max().item())
    log(f"  fused_k1_solve (B={B}, m={m}, n={n}, refine {refine}, "
        f"{len(seeds)} seed(s)): max|kernel-plain| {abs_err:.3e}; per lane "
        f"/ max(1, max|exact|): kernel-plain {rel[0]:.3e}, kernel-exact "
        f"{rel[1]:.3e}, plain-exact {rel[2]:.3e} (exact = the plain version "
        f"in f64)")
    if refine:
        check(rel[0] <= 1e-4 and rel[1] <= 1e-4, f"fused_k1_solve error "
              f"{rel[:2]} at {(B, m, n, refine)}")
    else:
        check(rel[1] <= 2 * rel[2] + 1e-6, f"fused_k1_solve error to the "
              f"f64 plain version {rel[1]}, plain f32's {rel[2]}, at "
              f"{(B, m, n, refine)}")
    return abs_err


def fused_occupancy(lib, m, n, bulk):
    """(registers a thread, local bytes a thread, instances resident on an
    SM, threads an instance) of the fused kernel's staged body at (m, n),
    loaded by bulk copies or by 4-byte copies."""
    import ctypes

    vals = [ctypes.c_int(0) for _ in range(4)]
    err = lib.tulip_fused_k1_solve_occupancy(m, n, int(bulk), 0,
                                             *map(ctypes.byref, vals))
    check(err == 0, f"tulip_fused_k1_solve_occupancy({m}, {n}, {bulk}): "
          f"cudaError {err}")
    return tuple(v.value for v in vals)


def offset_views(args):
    """Each input copied into a buffer one float longer and viewed from its
    second float: contiguous views whose data starts off 16 bytes."""
    out = []
    for t in args:
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out.append(buf[1:].view(t.shape))
        out[-1].copy_(t)
    return out


def phase_fused(device, lib):
    from tulip_tpu_torch.ops import solve
    from tulip_tpu_torch.ops.solve import batched_fused_k1_solve

    for m, n, bulk in [(48, 96, True), (48, 96, False), (45, 91, False)]:
        regs, local, blocks, threads = fused_occupancy(lib, m, n, bulk)
        check(local == 0, f"fused_k1_solve staged at ({m}, {n}): {local} "
              f"bytes of local memory a thread (spills)")
        log(f"  staged body ({m}, {n}), {'bulk' if bulk else '4-byte'} "
            f"copies: {regs} registers and {local} bytes of local memory a "
            f"thread, {threads} threads an instance, {blocks} instances "
            f"resident an SM")
    errs = {}
    before = (solve.KERNEL_LAUNCHES, solve.STREAMED_LAUNCHES,
              solve.WIDE_LAUNCHES, solve.BULK_LAUNCHES)
    for B, m, n in FUSED_SHAPES:
        for refine in (0, 1):
            seeds = [m + refine] if refine else [m, m + 100, m + 200]
            errs[(B, m, n, refine)] = hold_fused(B, m, n, refine, seeds,
                                                 device)
    launches, streamed, wide, bulk = (a - b for a, b in zip(
        (solve.KERNEL_LAUNCHES, solve.STREAMED_LAUNCHES,
         solve.WIDE_LAUNCHES, solve.BULK_LAUNCHES), before))
    check(wide > 0, "fused_k1_solve: the layout with the n-long vectors in "
          "device memory never ran")
    check(bulk > 0 and launches - streamed - bulk > 0, f"fused_k1_solve: "
          f"the staged layout ran {bulk} times by bulk copies and "
          f"{launches - streamed - bulk} by 4-byte copies; both must run")
    args = fused_inputs(3, 48, 96, seed=7, device=device)
    want = batched_fused_k1_solve(*args, refine=1)
    bulk = solve.BULK_LAUNCHES
    got = batched_fused_k1_solve(*offset_views(args), refine=1)
    torch.cuda.synchronize()
    check(solve.BULK_LAUNCHES == bulk and all(
        torch.equal(g, w) for g, w in zip(got, want)), "fused_k1_solve: "
        "views off 16 bytes did not give the bulk-copied output bit for bit")
    log("  inputs off 16 bytes (4-byte copies): the bulk-copied output, "
        "bit for bit")
    for m, n in [(48, 96), (45, 91)]:
        args = fused_inputs(6, m, n, seed=5, device=device)
        args[0][2, 5, 7] = float("nan")
        dx, dy = batched_fused_k1_solve(*args, refine=1)
        ok = (torch.isfinite(dx).all(-1)
              & torch.isfinite(dy).all(-1)).tolist()
        check(ok == [True, True, False, True, True, True],
              f"fused non-finite lane 2 at (6, {m}, {n}): finite lanes {ok}")
        log(f"  non-finite lane at (6, {m}, {n}): non-finite output in that "
            f"lane only")

    return errs, time_fused(*FUSED_TIMED, 1, device)


def time_fused(B, m, n, refine, device):
    """(event ms, plain ms, device ms) of the fused solve at one shape,
    printed beside its bound."""
    from tulip_tpu_torch.ops.solve import (batched_fused_k1_solve,
                                           batched_fused_k1_solve_plain)
    from tulip_tpu_torch.time_kernels import device_ms

    args = fused_inputs(B, m, n, seed=6, device=device)
    tk = time_ms(lambda: batched_fused_k1_solve(*args, refine=refine))
    td = device_ms(lambda: batched_fused_k1_solve(*args, refine=refine))
    tp = time_ms(lambda: batched_fused_k1_solve_plain(*args, refine=refine))
    bound, by = fused_bound(B, m, n, refine)
    log(f"  time {(B, m, n)}, refine {refine}: kernel {tk:.4f} ms (device "
        f"time {td:.4f} ms), plain (the bmm chain) {tp:.4f} ms, median of "
        f"20; bound {bound:.4f} ms ({by}), kernel's device time at "
        f"{bound / td:.4f} of it")
    return tk, tp, td


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
    from tulip_tpu_torch.time_kernels import device_ms

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
        if (B, m, n) == GRAM_F64_SHAPE:
            # Both f32 results against the same product in f64: the three
            # TF32 products must cost no accuracy worth the name.
            exact = scaled_gram_plain(A.double(), d.double())
            scale = exact.abs().amax(dim=(-1, -2))
            far_k = ((got.double() - exact).abs().amax(dim=(-1, -2))
                     / scale).max().item()
            far_p = ((want.double() - exact).abs().amax(dim=(-1, -2))
                     / scale).max().item()
            log(f"  scaled_gram {GRAM_F64_SHAPE} from the plain version in "
                f"f64, per lane / max|K|: kernel {far_k:.3e}, plain f32 "
                f"{far_p:.3e}")
            check(far_k <= 4 * far_p, f"scaled_gram is {far_k} from the f64 "
                  f"product, over 4x the plain f32 version's {far_p}")

    B, m, n = GRAM_TIMED
    A, d = gram_inputs(B, m, n, seed=5, device=device)
    tk = time_ms(lambda: scaled_gram(A, d))
    td = device_ms(lambda: scaled_gram(A, d))
    tp = time_ms(lambda: scaled_gram_plain(A, d))
    # One library call computing the same function of the same inputs.
    tl = time_ms(lambda: torch.einsum("bik,bk,bjk->bij", A, d, A))
    full = 2.0 * B * m * m * n
    bound, by = gram_bound(B, m, n)
    log(f"  time {GRAM_TIMED}: kernel {tk:.4f} ms, plain ((A*d) @ A^T, "
        f"cuBLAS f32) {tp:.4f} ms, library (one einsum) {tl:.4f} ms, median "
        f"of 20; 2*m^2*n = {full:.4e} FLOP -> kernel {full / tk / 1e9:.3f}, "
        f"plain {full / tp / 1e9:.3f} TFLOP/s of f32 work (the kernel "
        f"computes the lower tiles only, three TF32 products a term: "
        f"{3 * full / 2 / tk / 1e9:.3f} TFLOP/s of tensor-core work); bound "
        f"{bound:.4f} ms ({by}, 3·m(m+1)n at the TF32 peak), kernel at "
        f"{bound / tk:.4f} of it")
    return errs, (tk, tp, tl, td)


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


def scattered_coupling_lp(m=2048, mr=64, nc=96, ncouple=10, seed=4):
    """Staircase plus random long-range stage couplings, a copy of
    tests/golden_large.py:scattered_coupling_lp (same seed, same LP): the
    scattered off-band blocks defeat any band ordering but stay cheap for
    tile-granular fill."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    A, b, c, u = staircase_lp(m, mr=mr, nc=nc, seed=seed)
    stages = m // mr
    n = A.shape[1]
    I, J, V = [], [], []
    for _ in range(ncouple):
        s, t = rng.choice(stages, 2, replace=False)
        ii, jj = np.meshgrid(np.arange(s * mr, (s + 1) * mr),
                             np.arange(t * nc, (t + 1) * nc),
                             indexing="ij")
        I.append(ii.ravel())
        J.append(jj.ravel())
        V.append(rng.standard_normal(mr * nc) * 0.3)
    I, J, V = map(np.concatenate, (I, J, V))
    A = (A + sp.csr_matrix((V, (I, J)), shape=A.shape)).tocsr()
    u = rng.uniform(1, 3, n)
    x0 = u * rng.uniform(0.3, 0.7, n)
    return A, np.asarray(A @ x0), rng.standard_normal(n), u


def highs_staircase(A, b, c, u):
    """HiGHS's optimum (its interior-point method: the dual simplex takes
    minutes at m = 4096)."""
    r = highs(c, method="highs-ipm", A_eq=A, b_eq=b,
              bounds=list(zip(np.zeros(A.shape[1]), u)))
    check(r.status == 0, f"HiGHS failed on an LP of m = {A.shape[0]}: "
          f"{r.message}")
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


def host_symbolic_s(mod, device):
    """(probe seconds, backend setup seconds) of a solved Model's
    structured route, each timed again alone on the same host A: the
    probe runs in ``Model._route``, outside ``Model.timings``; the
    backend's setup (symbolic analysis, operand gathers, copies to the
    card) at the start of the IPM, inside ``timings["ipm"]``."""
    from tulip_tpu_torch.model import _probe_structure

    be = mod.kkt_backend
    t0 = time.perf_counter()
    _probe_structure(be.host_A)
    probe_s = time.perf_counter() - t0
    A = torch.as_tensor(be.host_A, device=device)[None]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    be.setup(A)
    torch.cuda.synchronize()
    return probe_s, time.perf_counter() - t0


def run_cli(path, device, *flags):
    """The CLI's ``main`` at its defaults and ``flags``; returns (rc,
    objective or None, iteration-log rows)."""
    from tulip_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([*flags, path], device=device)
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


def highs_slice(raws, n_ref):
    """HiGHS's objectives of the first ``n_ref`` slice instances."""
    refs = []
    for k in range(min(n_ref, len(raws))):
        A, b, c, u = raws[k]
        r = highs(c, A_eq=A, b_eq=b, bounds=[(0, ub) for ub in u])
        check(r.status == 0, f"HiGHS failed on lane {k}")
        refs.append(float(r.fun))
    return refs


def check_slice(raws, out, refs, what="slice"):
    """Every lane OPTIMAL, and the lanes with a HiGHS objective in
    ``refs`` within 1e-2·max(1, |f|) of it; returns (OPTIMAL lanes, worst
    relative error)."""
    st = out.status.cpu().numpy()
    n_opt = int((st == OPTIMAL).sum())
    check(n_opt == len(raws), f"{what}: {n_opt}/{len(raws)} lanes OPTIMAL")
    pobj = out.pobj.cpu().numpy()
    worst = 0.0
    for k, ref in enumerate(refs):
        err = abs(pobj[k] - ref) / max(1.0, abs(ref))
        worst = max(worst, err)
        check(err <= 1e-2, f"{what} lane {k}: pobj {pobj[k]} vs HiGHS {ref}")
    return n_opt, worst


def highs_entry(probs):
    return [highs(p["c"], A_ub=p.get("A_ub"), b_ub=p.get("b_ub"),
                  A_eq=p.get("A_eq"), b_eq=p.get("b_eq"),
                  bounds=p.get("bounds", (0, None))) for p in probs]


def check_entry(probs, res, refs=None, statuses=None, what="entry"):
    """Statuses equal to HiGHS's (or to ``statuses``), and OPTIMAL lanes'
    objectives within 1e-2·max(1, |f|) of HiGHS's; returns the worst
    relative error."""
    refs = refs or highs_entry(probs)
    worst = 0.0
    for k, (r, ref) in enumerate(zip(res, refs)):
        want = ref.status if statuses is None else statuses[k]
        check(r.status == want, f"{what} problem {k}: status {r.status} "
              f"({r.message}) vs {want}")
        if r.status == 0:
            err = abs(r.fun - ref.fun) / max(1.0, abs(ref.fun))
            worst = max(worst, err)
            check(err <= 1e-2,
                  f"{what} problem {k}: fun {r.fun} vs HiGHS {ref.fun}")
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


COUNTERS = {"chol_inv": ("chol", "KERNEL_LAUNCHES"),
            "chol_inv_blocked": ("chol", "KERNEL_LAUNCHES_BLOCKED"),
            "chol_inv_packed": ("chol", "KERNEL_LAUNCHES_PACKED"),
            "fused_k1_solve": ("solve", "KERNEL_LAUNCHES"),
            "scaled_gram": ("gram", "KERNEL_LAUNCHES")}


class Launches:
    """Kernel launch counts of the main path: :meth:`phase` sets every
    count to 0 just before a phase and adds them to the totals just after."""

    def __init__(self):
        from tulip_tpu_torch.ops import chol, gram, solve

        self.mods = {"chol": chol, "gram": gram, "solve": solve}
        self.total = dict.fromkeys(COUNTERS, 0)
        self.streamed = 0
        self.bulk = 0
        # Shapes the main path gave the chol-inv and fused solve kernels.
        self.shapes = {"chol": set(), "solve": set()}

    @contextlib.contextmanager
    def phase(self):
        torch.cuda.synchronize()
        for mod, attr in COUNTERS.values():
            setattr(self.mods[mod], attr, 0)
        self.mods["solve"].STREAMED_LAUNCHES = 0
        self.mods["solve"].BULK_LAUNCHES = 0
        for mod in self.shapes:
            self.mods[mod].SHAPES.clear()
        got = {}
        yield got
        torch.cuda.synchronize()
        for name, (mod, attr) in COUNTERS.items():
            got[name] = getattr(self.mods[mod], attr)
            self.total[name] += got[name]
        got["streamed"] = self.mods["solve"].STREAMED_LAUNCHES
        self.streamed += got["streamed"]
        got["bulk"] = self.mods["solve"].BULK_LAUNCHES
        self.bulk += got["bulk"]
        for mod, seen in self.shapes.items():
            seen |= self.mods[mod].SHAPES


def timed_solves(solve, reps):
    """Walls of ``reps`` solves, each ending in a device→host copy of the
    statuses."""
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        solve().status.cpu()
        walls.append(time.perf_counter() - t0)
    return walls


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="write torch.profiler tables of one warm slice "
                         "solve and of the phase-6 solve to DIR")
    args = ap.parse_args(argv)

    # -- 1. device ---------------------------------------------------------
    check(torch.cuda.is_available(), "no CUDA device")
    from tulip_tpu_torch import _build, batch_linprog
    from tulip_tpu_torch.ipm.batch import (batched_hsd_resolve,
                                           batched_hsd_solve, stack_lps_host)
    from tulip_tpu_torch.kkt import DenseK1Backend, SmallK1Backend

    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    check(smi.returncode == 0 and card, f"nvidia-smi failed: {smi.stderr}")
    log(f"[1] device: {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}; {card}")

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as ex:
        libs = {name: ex.submit(_build.build, name)
                for name in ("chol_inv", "scaled_gram", "fused_solve")}
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
                if "Compiling entry" in line or "Used" in line \
                        or "spill" in line:
                    log(f"  {name}: {line.strip()}")

    # -- 3. kernels vs plain -----------------------------------------------
    log("[3] chol_inv kernel vs plain version")
    errs, times = phase_kernel(device, _build.load("chol_inv"))
    packed = phase_packed(device)
    log("[3b] scaled_gram kernel vs plain version")
    gram_errs, gram_times = phase_gram(device)
    log("[3c] fused_k1_solve kernel vs plain version")
    fused_errs, fused_times = phase_fused(device, _build.load("fused_solve"))

    count = Launches()
    raws, dats, opts = slice_inputs(device, 2048)
    refs_slice = highs_slice(raws, 128)
    probs = entry_problems(np.random.default_rng(1))
    refs_entry = highs_entry(probs)

    # -- 4. the slice, counted ---------------------------------------------
    backend = SmallK1Backend(refinement_steps=1)
    with count.phase() as n4:
        t0 = time.perf_counter()
        out = batched_hsd_solve(backend, opts, dats)
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
    check(n4["chol_inv"] > 0, "slice: the chol-inv kernel never launched")
    log(f"[4] slice: B={len(raws)} 48x96 f32 tol {TOL}, first solve "
        f"{t_first:.3f} s, launches {n4}")
    n_opt, worst = check_slice(raws, out, refs_slice)
    iters = out.niter.cpu().numpy()
    wall = statistics.median(timed_solves(
        lambda: batched_hsd_solve(backend, opts, dats), 5))
    plain = DenseK1Backend(inv_factor=True, refinement_steps=1)
    o = batched_hsd_solve(plain, opts, dats)
    check(bool((o.status == OPTIMAL).all()), "slice with the plain backend: "
          "not every lane OPTIMAL")
    pwall = statistics.median(timed_solves(
        lambda: batched_hsd_solve(plain, opts, dats), 3))
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

    # -- 4b. the slice through the fused solve, counted --------------------
    fused = SmallK1Backend(refinement_steps=1, fused_solve=True)
    with count.phase() as n4b:
        t0 = time.perf_counter()
        out_f = batched_hsd_solve(fused, opts, dats)
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
    check(n4b["fused_k1_solve"] > 0,
          "fused slice: the fused solve kernel never launched")
    n_opt_f, worst_f = check_slice(raws, out_f, refs_slice, "fused slice")
    iters_f = out_f.niter.cpu().numpy()
    wall_f = statistics.median(timed_solves(
        lambda: batched_hsd_solve(fused, opts, dats), 5))
    log(f"[4b] fused slice: first solve {t_first:.3f} s, launches {n4b}; "
        f"{n_opt_f}/{len(raws)} OPTIMAL, mean iterations "
        f"{iters_f.mean():.4f} (max {iters_f.max()}), worst rel obj err vs "
        f"HiGHS (128 lanes) {worst_f:.3e}")
    log(f"  wall median of 5: {wall_f:.4f} s = {len(raws) / wall_f:.2f} "
        f"solves/s, beside phase 4's {len(raws) / wall:.2f} solves/s")
    if args.profile:
        profile_solve(lambda: batched_hsd_solve(fused, opts, dats),
                      os.path.join(args.profile, "profile_slice_fused.txt"),
                      wall_f)

    # -- 5 + 5b. batch_linprog, counted ------------------------------------
    with count.phase() as n5:
        res = batch_linprog(probs)
    check(n5["chol_inv"] > 0, "entry: the chol-inv kernel never launched")
    check(n5["chol_inv_blocked"] > 0, "entry: the chol-inv kernel's blocked "
          "path (the m = 256 bucket) never ran")
    worst_e = check_entry(probs, res, refs_entry)
    log(f"[5] entry: batch_linprog on {len(probs)} problems, statuses match "
        f"HiGHS, worst rel obj err {worst_e:.3e}; launches {n5}")
    with count.phase() as n5b:
        res_f = batch_linprog(probs, backend=fused)
    check(n5b["fused_k1_solve"] > 0 and n5b["streamed"] > 0,
          f"fused entry: the fused kernel's device-memory path did not run "
          f"({n5b})")
    worst_ef = check_entry(probs, res_f, refs_entry, what="fused entry")
    log(f"[5b] fused entry: statuses match HiGHS, worst rel obj err "
        f"{worst_ef:.3e}; launches {n5b} ({n5b['streamed']} read A and L⁻¹ "
        f"from device memory: the m = 256 bucket)")

    # -- 6. one LP through dense-pallas, counted ---------------------------
    big = staircase_lp(4096)
    ref_big = highs_staircase(*big)
    mod = staircase_model(big, device, "float32", "dense-pallas")
    with count.phase() as n6:
        st, z, wall6 = solve_model(mod)
    check(st.name == "OPTIMAL", f"single LP (dense-pallas): status {st.name}")
    check(n6["scaled_gram"] > 0, "single LP: the scaled_gram kernel never "
          "launched")
    check(mod.kkt_backend.name == "dense-pallas",
          f"single LP ran backend {mod.kkt_backend.name!r}")
    err = check_objective("single LP (dense-pallas)", z, ref_big, 1e-3)
    log(f"[6] single LP: multiperiod_lp(4096), m={big[0].shape[0]}, "
        f"n={big[0].shape[1]}, f32 dense-pallas, presolve on: OPTIMAL, "
        f"objective {z!r} vs HiGHS {ref_big!r} (rel {err:.3e}); "
        f"{describe(mod, wall6)}; launches {n6}")
    mod_d = staircase_model(big, device, "float32", "dense")
    st_d, z_d, wall_d = solve_model(mod_d)
    check(st_d.name == "OPTIMAL", f"single LP (dense f32): {st_d.name}")
    log(f"  same LP through KKT_Backend='dense' (cuBLAS + cuSOLVER), f32: "
        f"objective {z_d!r}; {describe(mod_d, wall_d)}")
    if args.profile:
        profile_solve(lambda: mod.optimize(),
                      os.path.join(args.profile, "profile_single_lp.txt"),
                      wall6)

    # -- 6b. the structured route at the defaults, counted -----------------
    scattered = scattered_coupling_lp(2048)
    ref_sc = highs_staircase(*scattered)
    runs = [("multiperiod_lp(4096) f64 HSD", big, ref_big, "float64", "HSD",
             "banded", 1e-6),
            ("multiperiod_lp(4096) f32 HSD", big, ref_big, "float32", "HSD",
             "banded", 1e-3),
            ("multiperiod_lp(4096) f64 MPC", big, ref_big, "float64", "MPC",
             "banded", 1e-6),
            ("scattered_coupling_lp(2048) f64 HSD", scattered, ref_sc,
             "float64", "HSD", "sparse", 1e-6)]
    structured = {}
    with count.phase() as n6b:
        for what, lp, ref, dtype, algo, want_be, tol in runs:
            m6b = staircase_model(lp, device, dtype)
            m6b.params.IPM.Algorithm = algo
            st6b, z6b, w6b = solve_model(m6b)
            structured[what] = (m6b, st6b, z6b, w6b, ref, want_be, tol)
    for what, (m6b, st6b, z6b, w6b, ref, want_be, tol) in \
            structured.items():
        check(m6b.kkt_backend.name == want_be, f"{what}: the probe routed "
              f"to {m6b.kkt_backend.name!r}, not {want_be!r}")
        kind = type(m6b.solver_state.kkt).__name__
        check(kind == "SparseK1LevelState", f"{what}: {want_be!r} set up a "
              f"{kind}, not its level engine's state")
        check(st6b.name == "OPTIMAL", f"{what}: status {st6b.name}")
        err = check_objective(what, z6b, ref, tol)
        probe_s, setup_s = host_symbolic_s(m6b, device)
        it = m6b.barrier_iterations
        log(f"[6b] {what} at the defaults: {want_be} ({kind}), OPTIMAL, "
            f"objective {z6b!r} vs HiGHS {ref!r} (rel {err:.3e}); "
            f"{describe(m6b, w6b)}")
        log(f"  host symbolic phase, timed again alone: probe "
            f"{probe_s:.4f} s (outside the timings), backend setup "
            f"{setup_s:.4f} s (inside 'ipm'); the IPM without its setup "
            f"{(m6b.timings['ipm'] - setup_s) / it * 1e3:.3f} ms per "
            f"iteration")
    log(f"  beside phase 6 on multiperiod_lp(4096), f32: dense-pallas wall "
        f"{wall6:.4f} s, dense wall {wall_d:.4f} s; launches {n6b}; {card}")
    # The level engine scatter-adds with index_add_ (atomics on CUDA): a
    # second run of the same solve shows whether the order moved a count.
    m6r = staircase_model(big, device, "float32")
    st6r, z6r, w6r = solve_model(m6r)
    first = structured["multiperiod_lp(4096) f32 HSD"]
    log(f"  repeat of the f32 banded solve: {st6r.name}, "
        f"{m6r.barrier_iterations} iterations (first run "
        f"{first[0].barrier_iterations}), objective {z6r!r} (first run "
        f"{first[2]!r}, equal bit for bit: {z6r == first[2]}), wall "
        f"{w6r:.4f} s")
    if args.profile:
        profile_solve(lambda: m6r.optimize(),
                      os.path.join(args.profile, "profile_banded_f32.txt"),
                      w6r)

    # -- 7. single-LP entry at defaults, counted ---------------------------
    want = {"lp_opt": (0, 1.5), "lp_inf": (1, None), "lp_ubd": (1, None),
            "lp_freevars": (0, 0.0)}
    small = staircase_lp(1024)
    ref_small = highs_staircase(*small)
    with count.phase() as n7:
        for name, (rc_want, z_want) in want.items():
            rc, zc, rows = run_cli(os.path.join(ROOT, "tests", "data",
                                                f"{name}.mps"), device)
            check(rc == rc_want, f"cli {name}: rc {rc}, expected {rc_want}")
            if z_want is not None:
                check(zc is not None and abs(zc - z_want) <= 1e-6,
                      f"cli {name}: objective {zc}, expected {z_want}")
            log(f"[7] cli {name}.mps (f64 default): rc {rc}, objective "
                f"{zc!r}, {rows} iteration-log rows")
        mod64 = staircase_model(small, device, "float64")
        st64, z64, wall64 = solve_model(mod64)
        mod32 = staircase_model(small, device, "float32")
        st32, z32, wall32 = solve_model(mod32)
    check(st64.name == "OPTIMAL", f"multiperiod_lp(1024) f64: {st64.name}")
    check(mod64.kkt_backend.name == "dense", "f64 default did not route to "
          f"'dense' but {mod64.kkt_backend.name!r}")
    err64 = check_objective("multiperiod_lp(1024) f64", z64, ref_small, 1e-6)
    log(f"  multiperiod_lp(1024) f64 default (dense): objective {z64!r} vs "
        f"HiGHS {ref_small!r} (rel {err64:.3e}); {describe(mod64, wall64)}")
    check(st32.name == "OPTIMAL", f"multiperiod_lp(1024) f32: {st32.name}")
    check(mod32.kkt_backend.name == "pallas-small", "f32 default did not "
          f"route to 'pallas-small' but {mod32.kkt_backend.name!r}")
    check(n7["chol_inv_blocked"] > 0, "f32 default single LP: the chol-inv "
          "kernel's blocked path never ran")
    err32 = check_objective("multiperiod_lp(1024) f32", z32, ref_small, 1e-3)
    log(f"  multiperiod_lp(1024) f32 default (pallas-small): objective "
        f"{z32!r} vs HiGHS (rel {err32:.3e}); {describe(mod32, wall32)}; "
        f"launches {n7}")

    # -- 8. MPC, counted ---------------------------------------------------
    with count.phase() as n8:
        res_m = batch_linprog(probs, algorithm="MPC")
        mod_m = staircase_model(small, device, "float64")
        mod_m.params.IPM.Algorithm = "MPC"
        st_m, z_m, wall_m = solve_model(mod_m)
        cli_m = {name: run_cli(os.path.join(ROOT, "tests", "data",
                                            f"{name}.mps"), device,
                               "--Method", "MPC")
                 for name in want}
    check(n8["chol_inv"] > 0, "MPC entry: the chol-inv kernel never launched")
    worst_m = check_entry(probs, res_m, refs_entry, MPC_ENTRY_STATUS,
                          what="MPC entry")
    iters_m = [r.nit for r in res_m]
    log(f"[8] MPC: batch_linprog(algorithm='MPC') on {len(probs)} problems, "
        f"statuses as the JAX package's on the CPU, worst rel obj err vs "
        f"HiGHS {worst_m:.3e}, mean iterations {np.mean(iters_m):.4f}; "
        f"launches {n8}")
    check(st_m.name == "OPTIMAL", f"multiperiod_lp(1024) f64 MPC: {st_m.name}")
    err_m = check_objective("multiperiod_lp(1024) f64 MPC", z_m, ref_small,
                            1e-6)
    log(f"  multiperiod_lp(1024) f64 MPC (dense): objective {z_m!r} (rel "
        f"{err_m:.3e}); {describe(mod_m, wall_m)}")
    for name, (rc, zc, rows) in cli_m.items():
        rc_want, z_want = want[name]
        check(rc == rc_want, f"cli --Method MPC {name}: rc {rc}, expected "
              f"{rc_want}")
        if z_want is not None:
            check(zc is not None and abs(zc - z_want) <= 1e-6,
                  f"cli --Method MPC {name}: objective {zc}, expected "
                  f"{z_want}")
        log(f"  cli --Method MPC {name}.mps: rc {rc}, objective {zc!r}, "
            f"{rows} iteration-log rows")

    # -- 9. warm re-solve, counted -----------------------------------------
    rng = np.random.default_rng(2)
    raws2 = [(A, b * (1 + 0.01 * rng.standard_normal(len(b))), c, u)
             for (A, b, c, u) in raws]
    dats2 = stack_lps_host(
        [(A, b, c, 0.0, np.zeros(len(c)), u) for (A, b, c, u) in raws2],
        device=device, dtype=torch.float32)
    warm_be = SmallK1Backend(refinement_steps=1, fused_solve=True, pack=PACK)
    cold = batched_hsd_solve(fused, opts, dats2)
    with count.phase() as n9:
        t0 = time.perf_counter()
        warm = batched_hsd_resolve(warm_be, opts, dats2, out_f)
        torch.cuda.synchronize()
        wall9 = time.perf_counter() - t0
    check(n9["chol_inv_packed"] > 0 and n9["fused_k1_solve"] > 0,
          f"warm re-solve: a kernel never launched ({n9})")
    check(bool((warm.status == OPTIMAL).all()) and
          bool((cold.status == OPTIMAL).all()),
          "warm re-solve: not every lane OPTIMAL")
    pw, pc = warm.pobj.cpu().numpy(), cold.pobj.cpu().numpy()
    rel9 = np.abs(pw - pc) / np.maximum(1.0, np.abs(pc))
    check(rel9.max() <= 1e-3, f"warm re-solve: objective off the cold "
          f"solve's by {rel9.max()}")
    log(f"[9] warm re-solve: b perturbed 1%, {len(raws2)}/{len(raws2)} "
        f"OPTIMAL warm and cold, max rel obj diff {rel9.max():.3e}; mean "
        f"iterations warm {warm.niter.double().mean().item():.4f}, cold "
        f"{cold.niter.double().mean().item():.4f}; warm wall {wall9:.4f} s; "
        f"launches {n9}")
    for name in COUNTERS:
        check(count.total[name] > 0, f"main path: {name} never launched")

    # -- 10. the kernels at the main path's shapes -------------------------
    log(f"[10] kernels at the main path's shapes: "
        f"{sorted(count.shapes['solve'])} (fused, B m n refine), "
        f"{sorted(count.shapes['chol'])} (chol-inv, B m per-block)")
    for B, m, n, refine in sorted(count.shapes["solve"]):
        hold_fused(B, m, n, refine, [B + m + n], device)
    check(STREAMED_TIMED + (1,) in count.shapes["solve"], f"main path: the "
          f"fused solve never ran at {STREAMED_TIMED}, refine 1")
    time_fused(*STREAMED_TIMED, 1, device)
    for B, m, p in sorted(count.shapes["chol"]):
        hold_chol(B, m, p, B + m, device)
    blocked = {(B, m) for B, m, _ in count.shapes["chol"]
               if m > count.mods["chol"].SHARED_MAX_M}
    check(BLOCKED_TIMED in blocked and any(m == 256 for _, m in blocked),
          f"main path: the blocked chol-inv shapes {sorted(blocked)} lack "
          f"{BLOCKED_TIMED} or an m = 256 bucket")

    tk, tp, td = times[(2048, 48)]
    bk, bp, bd = times[BLOCKED_TIMED]
    pk_err, pk_ms, _, pk_plain, pk_dev = packed[(2048, 48, PACK)]
    gk, gp, gl, gd = gram_times
    fk, fp, fd = fused_times
    kernels = []
    # "ms" is a CUDA-event timing of one call, the host's launch included;
    # "device_ms" the kernel's own time on the card (torch.profiler).
    for name, src, repl, err_, ms, dev_ms, plain_ms, bound, lib in [
            ("chol_inv", "chol_inv.cu", "tulip_tpu/ops/chol.py:42",
             errs[(2048, 48)], tk, td, tp, chol_bound(2048, 48), None),
            ("chol_inv_blocked", "chol_inv.cu", "tulip_tpu/ops/chol.py:42",
             hold_chol(*BLOCKED_TIMED, 0, 0, device), bk, bd, bp,
             chol_bound(*BLOCKED_TIMED), None),
            ("chol_inv_packed", "chol_inv.cu", "tulip_tpu/ops/chol.py:95",
             pk_err, pk_ms, pk_dev, pk_plain, chol_bound(2048, 48), None),
            ("fused_k1_solve", "fused_solve.cu", "tulip_tpu/ops/solve.py:34",
             fused_errs[FUSED_TIMED + (1,)], fk, fd, fp,
             fused_bound(*FUSED_TIMED, 1), None),
            ("scaled_gram", "scaled_gram.cu",
             "tulip_tpu/kkt/pallas_chol.py:36", gram_errs[GRAM_TIMED], gk,
             gd, gp, gram_bound(*GRAM_TIMED), gl)]:
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"tulip_tpu_torch/csrc/{src}", "replaces": repl,
            "launches": count.total[name], "max_abs_err": err_, "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": lib})
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
