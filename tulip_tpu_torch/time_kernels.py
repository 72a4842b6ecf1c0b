"""Times of the hand-written kernels of one checkout, as one JSON line.

    python tulip_tpu_torch/time_kernels.py [--root DIR]

Imports ``tulip_tpu_torch`` from DIR (default: the checkout this file is
in), builds its kernels, and times ``batched_cholesky_inverse`` at
(2048, 48), (2048, 64), (64, 100), (8, 224), (1, 224) (the shared-memory
path), (4, 256), (16, 256), (1, 1024) (the blocked path) and
``scaled_gram`` at (1, 4096, 6240) beside their plain versions: median of
20 CUDA-event timings after 3 warm-up calls, on seeded inputs. Each
chol-inv entry also carries ``bits``, a hash of the kernel's output, so
that two checkouts whose outputs agree bit for bit show the same hash. To
compare two commits on one card, unpack the other into a directory and
run this once per root in one command, in turns (parent, change, change,
parent).

``--leave-out`` instead times diagnostic builds that leave one part of a
kernel out (their output is wrong, only the time means anything) beside
the whole kernel, to show which part the time goes to: of
``csrc/scaled_gram.cu`` (``-DGRAM_LEAVE_OUT=k``: 1 without the split
pass, 2 without the products, 3 without the loads) at (1, 4096, 6240),
with the whole kernel also at a width where A fits in the L2 cache; and
of ``csrc/chol_inv.cu``'s shared-memory path (``-DCHOL_LEAVE_OUT=k``: 1
without the loads and stores, 2 without the factorizations of the
diagonal blocks, 3 without the panels and trailing updates, 4 without
L⁻¹) at (2048, 48) and (2048, 64). Needs a CUDA device.
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

import numpy as np
import torch

CHOL_SHAPES = [(2048, 48), (2048, 64), (64, 100), (8, 224), (1, 224),
               (4, 256), (16, 256), (1, 1024)]
GRAM_SHAPE = (1, 4096, 6240)


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


def leave_out_build(root, name, macro, k):
    """The C library of ``csrc/<name>.cu`` built with -D<macro>=k."""
    from tulip_tpu_torch import _build

    src = os.path.join(root, "tulip_tpu_torch", "csrc", f"{name}.cu")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    lib = os.path.join(_build.BUILD_DIR, f"{name}_leave_out{k}.so")
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, f"-D{macro}={k}",
                    "-o", lib, src], check=True, capture_output=True)
    return ctypes.CDLL(lib)


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
    ap.add_argument("--leave-out", action="store_true",
                    help="time scaled_gram builds with one part left out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from tulip_tpu_torch.ops.chol import (batched_cholesky_inverse,
                                          batched_cholesky_inverse_plain)
    from tulip_tpu_torch.ops.gram import scaled_gram, scaled_gram_plain

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    out = {"root": args.root, "device": torch.cuda.get_device_name(0),
           "card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True,
               text=True).stdout.strip()}
    if args.leave_out:
        root = os.path.abspath(args.root)
        out["scaled_gram_leave_out"] = leave_out(root, dev)
        out["chol_inv_leave_out"] = leave_out_chol(root, dev)
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
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
