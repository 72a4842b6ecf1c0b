"""Times of the hand-written kernels of one checkout, as one JSON line.

    python tulip_tpu_torch/time_kernels.py [--root DIR]

Imports ``tulip_tpu_torch`` from DIR (default: the checkout this file is
in), builds its kernels, warms the card for 2 s, and times
``batched_cholesky_inverse`` at (2048, 48), (2048, 64), (64, 100),
(8, 224), (1, 224) (the shared-memory path), (4, 256), (16, 256),
(1, 1024) (the blocked path), ``scaled_gram`` at (1, 4096, 6240) and
``batched_fused_k1_solve`` at (2048, 48, 96) and (7, 48, 96) with refine 0
and 1, (5, 45, 91) (ragged: the staged layout's 4-byte copies) and
(4, 256, 512) (A and Li read from device memory) with refine 1, beside
their plain versions: median of 20 CUDA-event timings after 3 warm-up
calls, on seeded inputs. An event timing of one call takes in the host's
launch overhead whenever the card waits on the host, so the fused solve's
entries also carry ``device_ms``, the kernel's mean device time over 20
calls from torch.profiler. Each chol-inv and fused-solve entry carries
``bits``, a hash of the kernel's output, so that two checkouts whose
outputs agree bit for bit show the same hash. To compare two commits on
one card, unpack the other into a directory and run this once per root in
one command, in turns (parent, change, change, parent).

``--leave-out`` instead times diagnostic builds that leave one part of a
kernel out (their output is wrong, only the time means anything) beside
the whole kernel, to show which part the time goes to: of
``csrc/scaled_gram.cu`` (``-DGRAM_LEAVE_OUT=k``: 1 without the split
pass, 2 without the products, 3 without the loads) at (1, 4096, 6240),
with the whole kernel also at a width where A fits in the L2 cache; and
of ``csrc/chol_inv.cu``'s shared-memory path (``-DCHOL_LEAVE_OUT=k``: 1
without the loads and stores, 2 without the factorizations of the
diagonal blocks, 3 without the panels and trailing updates, 4 without
L⁻¹) at (2048, 48) and (2048, 64); and of ``csrc/fused_solve.cu``'s
staged layout (``-DFUSED_LEAVE_OUT=k``: 1 without the loads, 2 without
the row products, 3 without the column products, 4 without the
refinement sweep) at (2048, 48, 96), refine 1. ``--leave-out`` takes the
names of the kernels to take apart (default: all three).

``--batches`` times the fused solve, whole and without the staged layout's
loads, at (B, 48, 96), refine 1, for B from 132 to 2048 (device times).

``--threads K [K ...]`` times builds of the fused solve's staged layout
with K threads an instance (``-DFUSED_THREADS=K``) at (2048, 48, 96),
refine 0 and 1, each with its ``bits``. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

CHOL_SHAPES = [(2048, 48), (2048, 64), (64, 100), (8, 224), (1, 224),
               (4, 256), (16, 256), (1, 1024)]
GRAM_SHAPE = (1, 4096, 6240)
FUSED_SHAPES = [(2048, 48, 96, 0), (2048, 48, 96, 1), (7, 48, 96, 0),
                (7, 48, 96, 1), (5, 45, 91, 1), (4, 256, 512, 1)]
FUSED_TIMED = (2048, 48, 96)


def time_ms(fn, reps=20, warmup=3):
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


def device_ms(fn, reps=20, warmup=3):
    """Mean device time in ms of the CUDA kernels that one call of ``fn``
    runs, from torch.profiler: the card's own time, without the host's
    launch overhead that a CUDA-event timing of one call takes in when the
    card waits on the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # The profiler now and then returns no device events (its warning:
    # "Profiler clears events at the end of each cycle"); such a take is
    # repeated, and after three NaN is returned rather than 0.
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / reps / 1e3
    return float("nan")


def gram_inputs(rng, B, m, n, dev):
    A = torch.as_tensor(rng.standard_normal((B, m, n)), dtype=torch.float32,
                        device=dev)
    d = torch.as_tensor(10.0 ** rng.uniform(-3, 3, (B, n)),
                        dtype=torch.float32, device=dev)
    return A, d


def spd_batch(rng, B, m, dev):
    X = rng.standard_normal((B, m, m))
    return torch.as_tensor(np.einsum("bij,bkj->bik", X, X) + m * np.eye(m),
                           dtype=torch.float32, device=dev)


def fused_inputs(rng, B, m, n, dev):
    """A, Li, d, treg, regD, xi_p, xi_d (f32) as ``chip_smoke.py`` makes
    them: treg spanning 10^±2, regD 1e-4, Li = L⁻¹ of K = A diag(1/treg) Aᵀ
    + diag(regD), formed in f64 with numpy so that every checkout gets the
    same bits."""
    A = rng.standard_normal((B, m, n)).astype(np.float32)
    treg = (10.0 ** rng.uniform(-2, 2, (B, n))).astype(np.float32)
    d = (np.float32(1.0) / treg).astype(np.float32)
    regD = np.full((B, m), 1e-4, dtype=np.float32)
    xi_p = rng.standard_normal((B, m)).astype(np.float32)
    xi_d = rng.standard_normal((B, n)).astype(np.float32)
    A64 = A.astype(np.float64)
    K = np.einsum("bij,bj,bkj->bik", A64, d.astype(np.float64), A64) \
        + 1e-4 * np.eye(m)
    Li = np.tril(np.linalg.inv(np.linalg.cholesky(K))).astype(np.float32)
    return [torch.as_tensor(x, device=dev)
            for x in (A, Li, d, treg, regD, xi_p, xi_d)]


def digest(*ts):
    return hashlib.sha256(b"".join(t.cpu().numpy().tobytes()
                                   for t in ts)).hexdigest()[:16]


def variant_build(root, name, flags, tag):
    """The C library of ``csrc/<name>.cu`` built with extra ``flags``."""
    from tulip_tpu_torch import _build

    src = os.path.join(root, "tulip_tpu_torch", "csrc", f"{name}.cu")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    lib = os.path.join(_build.BUILD_DIR, f"{name}_{tag}.so")
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-o",
                    lib, src], check=True, capture_output=True)
    return ctypes.CDLL(lib)


def leave_out_build(root, name, macro, k):
    """The C library of ``csrc/<name>.cu`` built with -D<macro>=k."""
    return variant_build(root, name, [f"-D{macro}={k}"], f"leave_out{k}")


def fused_runner(lib, args, refine, dev):
    """A call of the library's ``tulip_fused_k1_solve_f32`` on ``args``
    (a staged or streamed shape: no workspace) into fresh dx, dy."""
    fn = lib.tulip_fused_k1_solve_f32
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
    B, m, n = args[0].shape
    dx = torch.empty(B, n, device=dev)
    dy = torch.empty(B, m, device=dev)
    layout = ctypes.c_int(-1)

    def run():
        err = fn(*(t.data_ptr() for t in args), dx.data_ptr(), dy.data_ptr(),
                 None, B, m, n, refine, 0,
                 torch.cuda.current_stream(dev).cuda_stream,
                 ctypes.byref(layout))
        if err:
            raise RuntimeError(f"cudaError {err}")
        return dx, dy
    return run


def leave_out_fused(root, dev):
    """Times of fused_solve builds with one part of the staged layout
    left out, at FUSED_TIMED, refine 1."""
    args = fused_inputs(np.random.default_rng(0), *FUSED_TIMED, dev)
    out = {}
    for k, what in enumerate(["whole", "no_loads", "no_row_products",
                              "no_column_products", "no_sweep"]):
        lib = leave_out_build(root, "fused_solve", "FUSED_LEAVE_OUT", k)
        run = fused_runner(lib, args, 1, dev)
        out[what] = {"ms": time_ms(run), "device_ms": device_ms(run)}
    return out


def fused_batches(root, dev):
    """Device times of the fused kernel, whole and without the staged
    layout's loads (-DFUSED_LEAVE_OUT=1), at (B, 48, 96), refine 1, for B
    from one instance an SM of an H100 (132) to 2048: how the time grows
    with the instances an SM holds (8 at once) and the waves they take."""
    full = fused_inputs(np.random.default_rng(0), *FUSED_TIMED, dev)
    libs = {what: leave_out_build(root, "fused_solve", "FUSED_LEAVE_OUT", k)
            for k, what in [(0, "whole"), (1, "no_loads")]}
    out = {}
    for B in (132, 264, 528, 1056, 1584, 2048):
        args = [t[:B].contiguous() for t in full]
        out[B] = {what: device_ms(fused_runner(lib, args, 1, dev))
                  for what, lib in libs.items()}
    return out


def fused_threads(root, dev, counts):
    """Times and bits of fused_solve builds with K threads an instance of
    the staged layout, at FUSED_TIMED, refine 0 and 1."""
    args = fused_inputs(np.random.default_rng(0), *FUSED_TIMED, dev)
    out = {}
    for k in counts:
        lib = variant_build(root, "fused_solve", [f"-DFUSED_THREADS={k}"],
                            f"threads{k}")
        for refine in (0, 1):
            run = fused_runner(lib, args, refine, dev)
            out[f"{k} threads, refine {refine}"] = {
                "ms": time_ms(run), "device_ms": device_ms(run),
                "bits": digest(*run())}
    return out


def leave_out_chol(root, dev):
    """Times of chol_inv builds with one part of the shared-memory path
    left out, at (2048, 48) and (2048, 64)."""
    rng = np.random.default_rng(0)
    Ks = [spd_batch(rng, 2048, m, dev) for m in (48, 64)]
    out = {}
    for k, what in enumerate(["whole", "no_loads_stores", "no_factor",
                              "no_panel_update", "no_inverse"]):
        fn = leave_out_build(root, "chol_inv", "CHOL_LEAVE_OUT",
                             k).tulip_chol_inv_f32
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]

        def run(K, O):
            err = fn(K.data_ptr(), O.data_ptr(), None, K.shape[0],
                     K.shape[1], 0, torch.cuda.current_stream(dev).cuda_stream)
            if err:
                raise RuntimeError(f"cudaError {err}")

        out[what] = {}
        for K in Ks:
            O = torch.empty_like(K)
            out[what][f"{tuple(K.shape[:2])}"] = time_ms(lambda: run(K, O))
    return out


def leave_out(root, dev):
    """Times of scaled_gram builds with one part left out, at GRAM_SHAPE,
    and of the whole kernel at n = 1568 (A = 25.7 MB, inside the L2)."""
    rng = np.random.default_rng(0)
    A, d = gram_inputs(rng, *GRAM_SHAPE, dev)
    A_l2, d_l2 = gram_inputs(rng, 1, GRAM_SHAPE[1], 1568, dev)
    out = {}
    for k, what in enumerate(["whole", "no_split", "no_products",
                              "no_loads"]):
        fn = leave_out_build(root, "scaled_gram", "GRAM_LEAVE_OUT",
                             k).tulip_scaled_gram_f32
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]

        def run(A, d):
            B, m, n = A.shape
            K = torch.empty(B, m, m, device=dev)
            err = fn(A.data_ptr(), d.data_ptr(), K.data_ptr(), B, m, n, 0,
                     torch.cuda.current_stream(dev).cuda_stream)
            if err:
                raise RuntimeError(f"cudaError {err}")

        out[what] = {"ms": time_ms(lambda: run(A, d))}
        if k == 0:
            stages = -(-GRAM_SHAPE[2] // 32), -(-1568 // 32)
            ms_l2 = time_ms(lambda: run(A_l2, d_l2))
            out["whole_n1568"] = {
                "ms": ms_l2, "us_per_32k": ms_l2 / stages[1] * 1e3,
                "us_per_32k_at_full_n": out[what]["ms"] / stages[0] * 1e3}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout to import from")
    ap.add_argument("--leave-out", nargs="*",
                    choices=["scaled_gram", "chol_inv", "fused_solve"],
                    help="time builds of these kernels (default: all) with "
                         "one part left out")
    ap.add_argument("--threads", nargs="+", type=int, metavar="K",
                    help="time builds of the fused solve's staged layout "
                         "with K threads an instance")
    ap.add_argument("--batches", action="store_true",
                    help="time the fused solve whole and without its loads "
                         "at batch sizes from 132 to 2048")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from tulip_tpu_torch.ops.chol import (batched_cholesky_inverse,
                                          batched_cholesky_inverse_plain)
    from tulip_tpu_torch.ops.gram import scaled_gram, scaled_gram_plain
    from tulip_tpu_torch.ops.solve import (batched_fused_k1_solve,
                                           batched_fused_k1_solve_plain)

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    out = {"root": args.root, "device": torch.cuda.get_device_name(0),
           "card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True,
               text=True).stdout.strip()}
    root = os.path.abspath(args.root)
    # Clocks ramp up under load: 2 s of matrix products before any timing.
    a = torch.randn(4096, 4096, device=dev)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 2:
        a @ a
    torch.cuda.synchronize()
    if args.leave_out is not None or args.threads or args.batches:
        parts = {"scaled_gram": leave_out, "chol_inv": leave_out_chol,
                 "fused_solve": leave_out_fused}
        names = [] if args.leave_out is None else args.leave_out or parts
        for name in names:
            out[f"{name}_leave_out"] = parts[name](root, dev)
        if args.threads:
            out["fused_solve_threads"] = fused_threads(root, dev,
                                                       args.threads)
        if args.batches:
            out["fused_solve_batches"] = fused_batches(root, dev)
        print(json.dumps(out), flush=True)
        return
    for B, m in CHOL_SHAPES:
        K = spd_batch(rng, B, m, dev)
        bits = batched_cholesky_inverse(K).cpu().numpy().tobytes()
        out[f"chol_inv{(B, m)}"] = {
            "ms": time_ms(lambda: batched_cholesky_inverse(K)),
            "plain_ms": time_ms(lambda: batched_cholesky_inverse_plain(K)),
            "bits": hashlib.sha256(bits).hexdigest()[:16]}
    A, d = gram_inputs(rng, *GRAM_SHAPE, dev)
    out[f"scaled_gram{GRAM_SHAPE}"] = {
        "ms": time_ms(lambda: scaled_gram(A, d)),
        "plain_ms": time_ms(lambda: scaled_gram_plain(A, d)),
        "einsum_ms": time_ms(lambda: torch.einsum("bik,bk,bjk->bij", A, d,
                                                  A))}
    for B, m, n, refine in FUSED_SHAPES:
        fargs = fused_inputs(rng, B, m, n, dev)
        out[f"fused_k1_solve{(B, m, n)}, refine {refine}"] = {
            "ms": time_ms(lambda: batched_fused_k1_solve(*fargs,
                                                         refine=refine)),
            "device_ms": device_ms(lambda: batched_fused_k1_solve(
                *fargs, refine=refine)),
            "plain_ms": time_ms(lambda: batched_fused_k1_solve_plain(
                *fargs, refine=refine)),
            "bits": digest(*batched_fused_k1_solve(*fargs, refine=refine))}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
