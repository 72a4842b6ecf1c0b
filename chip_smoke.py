"""Smoke run of the PyTorch port (tulip_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

Phases, each of which exits non-zero on a failed check:

1. device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit (nvidia-smi), torch's and CUDA's versions and whether this
   torch offers CUDA-graph IF nodes (the device program does not use
   them);
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
6c. sparse-first and SMW routes: ``Model.optimize()`` at its defaults in
   f64 on ``multiperiod_lp(8192)`` (m = 8192 reaches
   ``SparseFirstThreshold``: the standard form goes from COO into
   compressed tiles, never a dense A, and solves through ``"sparse"``; the
   solve's peak device memory must stay below the 811.6 MB of a dense f64
   A), on ``staircase_lp(8192, dense_cols=2)`` (sparse-first to
   ``"sparse-smw"``, U of width 2, the SparseLPData as its full operator)
   and on ``staircase_lp(4096, dense_cols=2)`` (the dense data, where the
   probe answers ``"sparse-smw"``): OPTIMAL within 1e-6 of HiGHS;
   iterations, walls, ``Model.timings``, the host symbolic seconds, the
   SparseLPData's bytes and ms per iteration beside phase 6b's. No kernel
   of ours is on these routes;
7. single-LP entry at defaults: the CLI on ``tests/data/*.mps`` (f64) and
   ``Model.optimize()`` on ``multiperiod_lp(1024)`` in f64 (``"dense"``)
   and in f32 (``"pallas-small"``, the chol-inv kernel at B = 1);
7b. K2: ``Model.optimize()`` with ``KKT_System="K2"`` on
   ``multiperiod_lp(1024)`` in f64 (``"dense-ldl"``: the blocked unpivoted
   LDLᵀ of the Schur block), OPTIMAL within 1e-6 of HiGHS, iterations and
   ms per iteration beside phase 7's ``"dense"``; the CLI with
   ``--KKTBackend dense-ldl --Presolve 0`` on ``tests/data/*.mps``, with
   the statuses the JAX package gives on the CPU;
7c. K2 from m = 2048 and the probe's ``"sparse-ldl"``: ``Model.optimize()``
   with ``KKT_System="K2"`` on ``multiperiod_lp(4096)`` and at its defaults
   (the probe answers ``"sparse-ldl"`` for 24 dense columns) on
   ``staircase_lp(2048, dense_cols=24, dense_scale=1.0)``, f64 HSD: the
   tiled signed block LDLᵀ, with the KKT state the JAX package sets up
   (``K2_STATE``), OPTIMAL within 1e-7 of HiGHS; iterations, walls, host
   setup seconds and ms per iteration. No kernel of ours is on this
   route (torch.linalg and cuBLAS);
7d. the precision ladder: every double-double primitive and reduction on
   seeded inputs on the card against the CPU, bit for bit;
   ``Model.optimize()`` on ``multiperiod_lp(1024)`` in f64 at tolerances
   of 1e-10 with no backend named (``"extended"``: OPTIMAL within 1e-7
   of HiGHS, the IPM's relative gap below 1e-10), with
   ``KKT_Backend="dense-mixed"`` at its defaults (the JAX package's
   status), ``"extended-dd"`` at 1e-12 on the 20x40 LP of
   tests/test_doubledouble.py (within 1e-9 of HiGHS) and the CLI's
   ``--KKTBackend extended-dd`` on ``tests/data/*.mps`` (the JAX
   package's statuses);
8. MPC: ``batch_linprog(algorithm="MPC")`` at its defaults on the 64
   problems of phase 5 (statuses as the JAX package gives them on the CPU,
   objectives against HiGHS), ``Model`` with ``IPM_Algorithm="MPC"`` on
   ``multiperiod_lp(1024)`` in f64, and the CLI's ``--Method MPC`` on
   ``tests/data/*.mps``;
9. warm re-solve: ``b`` of the 2048 slice instances perturbed by 1%
   (seeded), re-solved by ``batched_hsd_resolve`` from phase 4b's final
   state through the fused backend with the packed chol-inv launch (4
   instances per block), against a cold solve;
11. after phase 9, the rest of the KKT backends:
11a. Krylov: ``Model.optimize()`` (f64, presolve on) on the transportation
   LP of tests/golden_lps.py through each of the 13 Krylov backends at
   tests/test_krylov_golden.py's tolerances (``KRYLOV_TOL``; minares
   stopped at ``MINARES_ITERATIONS``): the JAX package's statuses
   (``KRYLOV_STATUS``) and objectives within each case's rtol of HiGHS
   (tricg and minares: the status only); ``multiperiod_lp(256)`` through
   ``"cg"`` and ``multiperiod_lp(128)`` through ``"sqd-minres"``
   (``KRYLOV_E2E``), each beside ``"dense"``, OPTIMAL within 1e-6 of
   HiGHS, with iterations, walls, ``Model.timings``, Krylov trips and
   host syncs a solve (the port's loop counters, ``ipm/graph.py``); these
   Models solve as the device program; one solve of cg, sqd-minres and
   lsmr on
   ``multiperiod_lp(4096)``'s A (Θ⁻¹ over four decades, Rd = 1e-8), on
   the host-driven loop: trips, ms a trip, host syncs, with the default
   test for a stop and with one on every trip, and the relative residual of the system each
   iterates on (K1; sqd-minres's SQD-scaled K2) within 10·rtol;
11b. ``explicit_minv``: the slice of phase 4 through
   ``SmallK1Backend(explicit_minv=True)`` (K⁻¹ from the chol-inv kernel's
   L⁻¹) with one refinement sweep (every lane OPTIMAL but at most
   ``ONE_SWEEP_TAIL_MAX`` at ITERATION_LIMIT, a tail that the rounding
   decides in both packages; the OPTIMAL ones against HiGHS) and with two
   (phase 4's checks), mean iterations beside phase 4's,
   ``hsd_solve`` with ``DenseK1Backend(explicit_minv=True)`` on
   ``multiperiod_lp(1024)`` in f64 (within 1e-6 of HiGHS), and
   ``SmallK1Backend(explicit_minv=True, fused_solve=True)`` refused;
11c. ``matmul_precision``: ``DenseK1Backend(inv_factor=True,
   refinement_steps=2)`` with ``"highest"`` and ``"high"`` (three TF32
   products of a split) on benchmarks/bench_sparse.py's f32
   staircase(8192): update plus one solve, median of 5 in turns, each
   relative augmented residual (``"high"``'s within 10x of
   ``"highest"``'s), torch's flag restored after each;
12. after phase 11, the distributed Schur path (``"schur"``) at the
   reference's regime-2b blocks (m0, n0, mk, nk) = (8, 128, 128, 256),
   f64 at the default tolerances (``parallel/dryrun.py:two_stage_arrays``,
   seed 11), every solve as the device program (phase 15d holds it to the
   host loop):
12a. K = 32 (m = 4104, n = 8320): ``hsd_solve`` through ``"schur"``
   (unsharded) and through ``"dense"`` on ``block_angular_to_dense`` of
   the same LP, both OPTIMAL and within 1e-7·max(1,|f|); iterations, walls,
   ms and kernel launches (torch.profiler) an iteration, and the one
   process's ``Comm`` counter an iteration;
12b. K = 1024 (m = 131,080, n = 262,272; a dense K1 matrix would take
   137 GB): OPTIMAL, relative gap within the tolerance, ‖Ax−b‖∞/(1+‖b‖∞)
   ≤ 1e-8 recomputed by blocks in numpy on the host; wall, ms and launches
   an iteration, peak device memory beside the bytes of T and W;
12c. the 12a LP sharded over an NCCL group of one in this process (12a's
   iterations and objective bit for bit), then over two spawned processes
   on the card in a Gloo group (collectives staged through host memory:
   host operations between the pass's captured segments), which also
   solve it warm and on the host loop for phase 15d:
   12a's iterations, the objective within 1e-8 relative, the ranks' final
   states equal bit for bit, the largest collective at most n0² = 16,384
   elements and one n0×n0 all-reduce per factorization attempt; the
   ``Comm`` counter an iteration;
12d. ``shard_batch`` of phase 4's 2048 LPs over the same two processes
   through ``"pallas-small"`` (the chol-inv kernel), then ``gather_lanes``:
   2048/2048 OPTIMAL and mean iterations within 0.01 of phase 4's; lanes
   whose count differs and the walls beside phase 4's. The workers'
   chol-inv launches join the main path's counts;
13. after phase 12, the device program beside the host-driven loop:
   phase 4's, 4b's, 8's (``batch_linprog(algorithm="MPC")``), 9's, 6's
   (``multiperiod_lp(4096)``, f32, ``"dense-pallas"``) and 7's
   (``multiperiod_lp(1024)``, f64 ``"dense"`` and f32 ``"pallas-small"``)
   solves, each run through the device program (one captured CUDA graph a
   pass, replayed; its cache cleared first, so the first call captures)
   and with ``HostLoop=True`` in this process: every final state equal
   bit for bit, each solve's host reads within ceil((max niter + 1) / k)
   + 2; the warm-up, capture, instantiation and first replays' walls and
   the graph's nodes a pass,
   the median of 5 warm calls (3 for the LP at m = 4096) beside the host
   loop's, taken in turns, and the peak device memory of both; under
   ``--profile`` one warm call of each profiled (kernel time, kernels run,
   idle share) and the device program's profile held to name the chol-inv,
   fused K1 solve and scaled-Gram kernels where its pair runs them;
14. after phase 13, the structured and precision routes beside the
   host-driven loop: the IPM call of each solve of phases 6b (``"banded"``
   f64, f32 and MPC, ``"sparse"``), 6c (sparse-first ``"sparse"`` and
   ``"sparse-smw"``, dense-data ``"sparse-smw"``), 7b (``"dense-ldl"``),
   7c (both ``"sparse-ldl"`` LPs) and 7d (``"extended"``,
   ``"dense-mixed"``, ``"extended-dd"``), which ran as the device program
   there, run again from one initial state with ``HostLoop=True`` twice,
   then through a program built anew (the cache cleared) and 3 times warm:
   statuses equal, the two host-loop runs equal bit for bit and every
   device-program state equal to theirs bit for bit; on 14d and 14g
   (``SCATTER_ROUTES``) every call of the level engine's scatter-add
   (``kkt/levels.py:index_add_fixed``) of a third host-loop run run twice
   more and compared bit for bit; one host read a pass; the warm-up,
   capture and instantiation seconds, the
   graph's nodes a pass, the first and the median warm solve's walls and
   ms an iteration beside the host loop's, peak device memory of both;
   under ``--profile``, kernel time and idle share of a warm solve and a
   host-loop run;
15. after phase 14, the Krylov and Schur routes through the device
   program (a pass is a script: captured segments, each Krylov solve a
   loop of chunk graphs of 16 trips with a host read before each chunk,
   each Gloo collective a host operation), each beside ``HostLoop=True``
   in this process, every final state equal to the host loop's bit for
   bit:
15a. the IPM call of each of phase 11a's 13 transportation-LP Models:
   statuses as ``KRYLOV_STATUS``; every Krylov solve of the host loop
   found, in order, among the program's (which adds the masked
   corrections' solves) with the same trips and host reads
   (``graph.LOOP_LOG``); segments, loops, chunk graphs and
   nodes a pass, warm-up, capture and instantiation seconds, ms an
   iteration of the replays, trips and host reads a solve of both;
15b. phase 11a's end-to-end IPM calls (``KRYLOV_E2E``), replaying the
   program 11a built: ms an iteration of its replays beside the host
   loop's and ``"dense"``'s, IPM wall a trip, the masked corrections'
   trips, and under ``--profile`` kernel time and idle share of a warm
   program solve;
15c. phase 11a's one solves at m = 4096 as the loop of a one-pass
   program: trips and bits equal to the host loop's, ms a trip beside its
   own and (cg) A read twice at 3.35 TB/s;
15d. ``"schur"`` at K = 32 and 1024 (12a, 12b) through a program built
   anew and warm beside the host loop (bits, ms an iteration, peak
   memory, ``Comm`` counts); the K = 32 LP over a ``SCHUR_GROUP`` group
   of one (one captured segment a pass, 12a's state bit for bit); 12c's
   two Gloo processes (program state equal to the host loop's on each
   rank, ranks equal, 12a's iterations; warm ms an iteration, segments
   and host operations a pass);
10. kernels at the main path's shapes: every (B, m, n, refine) that phases
   4-9, 11-13 gave the fused solve and every (B, m, instances per
   block) they gave the chol-inv kernel, held against the plain version on
   seeded inputs of that shape with phase 3's and 3c's bars; the chol-inv
   shapes must include the blocked path's (1, 1024) and an m = 256 bucket.

Phases 4-9 and 11-15 (6b, 6c, 7b, 7c, 7d, 12a-12d, 13's pairs and 14's
routes included) are the main path: every kernel's launch count is reset
just before each of them and read just after (12d's in each worker, just
before and after its solve). Solves through every backend (each declares
``device_loop``) run as the device program
(``tulip_tpu_torch/ipm/graph.py``) unless an iteration log is asked for
(the CLI's runs) or ``HostLoop=True`` (the twins of phases 13-15): a
kernel in its
captured pass counts once for every replay of the pass, credited when the
solve ends, and a capture or its warm-up counts no launch. The last lines are the card's name and power limit, a JSON list of
the kernels with their launches, errors, times and bounds, and the JSON
result ``{"ok": true, "device": {...}}``. ``--profile DIR`` also writes
torch.profiler tables of one warm slice solve (phases 4 and 4b), of the
phase-6 solve, of phase 6b's banded f32 solve, of phase 6c's sparse-first
``multiperiod_lp(8192)``, of phase 7b's K2 solve, of phase 7c's
``"sparse-ldl"`` K2 solve of ``multiperiod_lp(4096)``, of phase 11a's
cg solve at m = 4096, of phase 12a's and 12b's solves and of a warm
device-program solve and a host-loop run of each pair of phases 13, 14
and 15b to DIR.
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
from types import SimpleNamespace

import numpy as np
import torch

TOL = 3e-4
OPTIMAL = 2  # TerminationStatus.OPTIMAL
ITERATION_LIMIT = 6
# Phase 11b's one-sweep explicit_minv run on the 2048 slice LPs: lanes that
# may end at the iteration limit. The JAX package on the CPU leaves none of
# these 2048 and the port on the CPU one; the flip of a single lane with
# the rounding is shown in both by tests/test_torch_dense_options.py.
ONE_SWEEP_TAIL_MAX = 4
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
# The JAX package's statuses for ``--KKTBackend dense-ldl --Presolve 0`` on
# tests/data/*.mps on the CPU (with presolve on, presolve decides the two
# infeasible files before any K2 solve).
K2_CLI_STATUS = {"lp_opt": "OPTIMAL", "lp_inf": "PRIMAL_INFEASIBLE",
                 "lp_ubd": "DUAL_INFEASIBLE", "lp_freevars": "OPTIMAL"}
# The KKT state the JAX package sets up on the CPU for phase 7c's LPs
# (its Model with the same parameters): the tiled one, not the
# "dense-ldl" fall back, on both.
K2_STATE = {"multiperiod_lp(4096) K2": "SparseK2State",
            "staircase_lp(2048, dense_cols=24, dense_scale=1.0)":
                "SparseK2State"}
# The JAX package on the CPU with KKT_Backend="dense-mixed" (f64, its
# defaults, no refinement sweep) on multiperiod_lp(1024): (status,
# iterations). The status is held; the iterations are printed beside the
# port's, not held: with no sweep the f32 factor's rounding moves the
# trajectory from about the 7th iteration on (mu ~1e-5), and the two
# packages then stall near the tolerance for different counts (the port
# takes 68 on the CPU, from the same presolved LP).
MIXED_1024 = ("OPTIMAL", 47)
# The JAX package's statuses for ``--KKTBackend extended-dd`` on
# tests/data/*.mps on the CPU (presolve on: it decides the two infeasible
# files), and its status with "extended-dd" at 1e-12 on the 20x40 LP of
# tests/test_doubledouble.py.
DD_CLI_STATUS = {"lp_opt": "OPTIMAL", "lp_inf": "PRIMAL_INFEASIBLE",
                 "lp_ubd": "DUAL_INFEASIBLE", "lp_freevars": "OPTIMAL"}
DD_TIGHT_STATUS = "OPTIMAL"
# The JAX package's statuses on the CPU with each Krylov backend on the
# transportation LP of tests/golden_lps.py (f64, presolve on), at the
# tolerances of KRYLOV_CASES (the defaults for tricg and minares).
KRYLOV_STATUS = {**dict.fromkeys(
    ["cg", "cr", "car", "minres", "symmlq", "minres-qlp", "sqd-minres",
     "lsqr", "lsmr", "craig", "craigmr", "tricg"], "OPTIMAL"),
    "minares": "ITERATION_LIMIT"}
# tests/test_krylov_golden.py's KRYLOV_CASES: (IPM tolerance or None for
# the defaults, objective rtol against HiGHS); tricg and minares (None)
# are held to the status only.
KRYLOV_TOL = {"cg": (None, 1e-7), "cr": (None, 1e-7), "car": (None, 1e-7),
              "minres": (1e-6, 1e-5), "symmlq": (1e-4, 1e-3),
              "minres-qlp": (None, 1e-7), "sqd-minres": (None, 1e-7),
              "lsqr": (None, 1e-7), "lsmr": (None, 1e-7),
              "craig": (None, 1e-7), "craigmr": (None, 1e-7),
              "tricg": (None, None), "minares": (None, None)}
# IPM iterations phase 11a gives minares: every one of its solves runs its
# 620 trips to maxiter, and the JAX package stops it at ITERATION_LIMIT at
# any limit (100 by default, ~120,000 trips; 10 here).
MINARES_ITERATIONS = 10
# Phase 11a's end-to-end runs, each beside "dense" on the same LP:
# (backend, m of multiperiod_lp). sqd-minres's late solves run ~2.8x cg's
# trips at ~2.7x its time a trip (this phase on an NVIDIA H100 80GB HBM3 at
# 700 W: its IPM took 191.6 s at m = 256, against cg's 24.9 s), so it runs
# at m = 128.
KRYLOV_E2E = [("cg", 256), ("sqd-minres", 128)]
# Phase 11a's one solve at full width: Θ⁻¹ over four decades, Rp = Rd.
KRYLOV_ONE_SOLVE = ("cg", "sqd-minres", "lsmr")
KRYLOV_REG = 1e-8
# Phase 12: scenarios of the block-angular LPs (the reference's regime-2b
# blocks, seed 11; K = 1024 is 131,080 x 262,272), the backend of the
# group of one in this process, and the two-process job's wall limit.
SCHUR_K = 32
SCHUR_BIG_K = 1024
SCHUR_GROUP = "nccl"
SCHUR_JOB_S = 300.0
# Phase 14's routes whose host loop gave other bits on each run before the
# level engine's scatter-adds summed in one order (14d and 14g).
SCATTER_ROUTES = ("14d_sparse_scattered", "14g_smw_4096")
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

def staircase_lp(m, mr=64, nc=96, dense_cols=0, seed=0, dense_scale=0.5):
    """Staircase equality LP, a copy of tests/golden_large.py:staircase_lp
    (same seed, same LP; not cyclic) without the JAX package that file
    imports: min c'x s.t. Ax = b, 0 <= x <= u, b = A x0 for an interior
    x0; ``dense_cols`` adds global linking columns, their entries scaled
    by ``dense_scale``."""
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
    for k in range(dense_cols):
        I.append(np.arange(m))
        J.append(np.full(m, (7 * k) % n))
        V.append(rng.standard_normal(m) * dense_scale)
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


def tight_lp(seed=5):
    """The 20x40 LP of tests/test_doubledouble.py's tight-tolerance test
    (same seed, same LP) as a sparse staircase_lp-style tuple."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    A = rng.standard_normal((20, 40))
    u = rng.uniform(1, 4, 40)
    b = A @ (u * rng.uniform(0.2, 0.8, 40))
    return sp.csr_matrix(A), b, rng.standard_normal(40), u


def set_tolerances(mod, tol):
    for k in ("PFeas", "DFeas", "RGap", "IFeas"):
        setattr(mod.params.IPM, f"Tolerance{k}", tol)


def relative_gap(mod):
    """The IPM's own gap test at its final point: |pobj - dobj| /
    (1 + |dobj|)."""
    st = mod.solver_state
    p, d = float(st.pobj[0]), float(st.dobj[0])
    return abs(p - d) / (1.0 + abs(d))


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
    """Optimize; returns (status, objective, wall seconds). The Model
    keeps its IPM call (:func:`recorded`) as ``mod.smoke_ipm``, for
    phase 14."""
    import importlib

    from tulip_tpu_torch import get_attribute

    # The package exports a function named like this module.
    tmodel = importlib.import_module("tulip_tpu_torch.model")
    with recorded(tmodel, "hsd_solve", False) as hsd_calls, \
            recorded(tmodel, "mpc_solve", False) as mpc_calls:
        t0 = time.perf_counter()
        st = mod.optimize()
        wall = time.perf_counter() - t0
    mod.smoke_ipm = hsd_calls + mpc_calls
    return st, get_attribute(mod, "ObjectiveValue"), wall


def check_objective(what, z, ref, tol):
    err = abs(z - ref) / max(1.0, abs(ref))
    check(err <= tol, f"{what}: objective {z} vs HiGHS {ref} (rel {err:.3e} "
          f"> {tol})")
    return err


def describe(mod, wall):
    t = ", ".join(f"{k} {v:.4f} s" for k, v in mod.timings.items())
    it = mod.barrier_iterations
    fig = mod.smoke_ipm[-1][1] if getattr(mod, "smoke_ipm", None) else {}
    if not fig:
        how = "the host-driven loop"
    else:
        built = (f"built: warm-up {fig['warmup_s']:.4f} s, capture "
                 f"{fig['capture_s']:.4f} s, instantiation "
                 f"{fig['instantiate_s']:.4f} s" if fig["built"]
                 else "cached")
        how = (f"the device program ({built}; {fig['nodes_a_pass']} nodes a "
               f"pass, {fig['passes']} passes in {fig['replay_s']:.4f} s, "
               f"{fig['syncs']} host reads)")
    return (f"{it} iterations, wall {wall:.4f} s ({t}); "
            f"{mod.timings['ipm'] / max(it, 1) * 1e3:.3f} ms per iteration; "
            f"the IPM through {how}")


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
    objective or None, iteration-log rows, status word of the result
    line)."""
    from tulip_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([*flags, path], device=device)
    out = buf.getvalue()
    z = status = None
    for line in out.splitlines():
        if line.startswith("result:"):
            status = line.split()[1]
            if " objective " in line:
                z = float(line.split(" objective ")[1].split()[0])
    rows = sum(1 for line in out.splitlines()
               if line[:4].strip().isdigit() and "e" in line)
    return rc, z, rows, status


def tensor_bytes(tree):
    """Bytes of the tensors of a NamedTuple tree (a SparseLPData with its
    level schedule)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, tuple):
        return sum(tensor_bytes(x) for x in tree)
    return 0


def sparse_first_symbolic_s(mod, device):
    """(seconds, SparseLPData bytes on the card) of the sparse-first
    standard form of a solved Model's LP, built again alone from the LP
    as loaded (COO → tile plan → compressed blocks → copies to the card),
    and the seconds of its backend's setup from that data (the tile
    operands' gathers on the card)."""
    from tulip_tpu_torch.ipm.sparse_data import sparse_lp_data_from_problem

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dat = sparse_lp_data_from_problem(mod.pbdata, device=device)[0]
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mod.kkt_backend.setup_data(dat)
    torch.cuda.synchronize()
    return plan_s, tensor_bytes(dat), time.perf_counter() - t0


# ---------------------------------------------------------------------------
# Phase 7d: the double-double primitives, bit for bit
# ---------------------------------------------------------------------------

def dd_inputs(seed=0):
    """Seeded f64 inputs of the dd primitives: 257 pairs across 40 decades
    (odd length: the tree pads), a zero and an overflowing split among
    them, dd values with non-trivial low words, the cancellation dot of
    tests/test_doubledouble.py and a matrix spanning 16 decades. No
    result is subnormal: the error-free transforms hold only above the
    underflow threshold, and XLA on the CPU flushes subnormals to zero
    where torch (CPU and CUDA) keeps them."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(257) * 10.0 ** rng.integers(-20, 20, 257)
    b = rng.standard_normal(257) * 10.0 ** rng.integers(-20, 20, 257)
    a[:2] = [0.0, 1e300]
    big = np.where(np.abs(a) >= np.abs(b), a, b)
    small = np.where(np.abs(a) >= np.abs(b), b, a)
    u = rng.standard_normal(64)
    cancel = np.concatenate([u, [1e15, -1e15, 3e14, -3e14]])
    w = rng.standard_normal(68)
    w[-4:] = 1.0
    M = rng.standard_normal((7, 33)) * 10.0 ** rng.integers(-8, 8, (7, 33))
    return dict(a=a, b=b, big=big, small=small, alo=a * 1e-17,
                blo=b * 1e-17, cancel=cancel, w=w, M=M,
                v=rng.standard_normal(33), T3=rng.standard_normal((5, 9, 13)))


def dd_results(dd, to):
    """Every dd primitive and reduction of ``dd`` (a double-double module:
    the port's, or the JAX package's in the tests) on :func:`dd_inputs`,
    each input placed by ``to``: name -> tuple of results as numpy."""
    i = {k: to(v) for k, v in dd_inputs().items()}
    x, y = (i["a"], i["alo"]), (i["b"], i["blo"])
    pos = (abs(i["a"]), abs(i["alo"]))
    out = {
        "two_sum": dd.two_sum(i["a"], i["b"]),
        "fast_two_sum": dd.fast_two_sum(i["big"], i["small"]),
        "split": dd._split(i["a"]),
        "two_prod": dd.two_prod(i["a"], i["b"]),
        "add": dd.add(x, y), "sub": dd.sub(x, y), "mul": dd.mul(x, y),
        "div": dd.div(x, y), "add_f": dd.add_f(x, i["b"]),
        "mul_f": dd.mul_f(x, i["b"]), "mul_ff": dd.mul_ff(i["a"], i["b"]),
        "recip": dd.recip(y), "sqrt_": dd.sqrt_(pos),
        "to_f": (dd.to_f(x),), "sum_": dd.sum_(x),
        "sum_axis1": dd.sum_((i["T3"], i["T3"] * 1e-17), axis=1),
        "dot": dd.dot(i["cancel"], i["w"]),
        "matvec": dd.matvec(i["M"], i["v"]),
        "ewmul_vec": dd.ewmul_vec(i["a"], i["b"]),
    }
    return {k: tuple(np.asarray(v.cpu() if hasattr(v, "cpu") else v)
                     for v in t) for k, t in out.items()}


def same_bits(g, w):
    """Equal bit for bit, where a NaN equals any NaN."""
    g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
    nan = np.isnan(g)
    return (g.shape == w.shape and np.array_equal(nan, np.isnan(w))
            and np.array_equal(g[~nan].view(np.uint64),
                               w[~nan].view(np.uint64)))


def dd_mismatches(got, want):
    """Names whose results differ in any bit."""
    return [k for k in want
            if not all(same_bits(g, w) for g, w in zip(got[k], want[k]))]


# ---------------------------------------------------------------------------
# Phase 11: the Krylov family, explicit_minv, matmul_precision
# ---------------------------------------------------------------------------

def transportation(ns=6, nd=9, seed=0):
    """Balanced transportation LP, a copy of
    tests/golden_lps.py:transportation (same seed, same LP) on the port's
    ProblemData: (the problem, its HiGHS optimum)."""
    from tulip_tpu_torch.problem import INF, ProblemData

    rng = np.random.default_rng(seed)
    s = rng.integers(10, 50, ns).astype(float)
    d = rng.random(nd)
    d = np.floor(d / d.sum() * s.sum())
    d[-1] += s.sum() - d.sum()
    C = rng.uniform(1, 20, (ns, nd))

    pb = ProblemData(f"transport-{ns}x{nd}")
    idx = {}
    for i in range(ns):
        for j in range(nd):
            idx[i, j] = pb.add_variable((), (), C[i, j], 0.0, INF,
                                        f"x{i}_{j}")
    for i in range(ns):
        cols = [idx[i, j] for j in range(nd)]
        pb.add_constraint(cols, [1.0] * nd, s[i], s[i], f"supply{i}")
    for j in range(nd):
        cols = [idx[i, j] for i in range(ns)]
        pb.add_constraint(cols, [1.0] * ns, d[j], d[j], f"demand{j}")
    A_eq = np.vstack([np.kron(np.eye(ns), np.ones(nd)),
                      np.kron(np.ones(ns), np.eye(nd))])
    r = highs(C.ravel(), A_eq=A_eq, b_eq=np.concatenate([s, d]))
    check(r.status == 0, f"HiGHS failed on the transportation LP: "
          f"{r.message}")
    return pb, float(r.fun)


class KrylovTrips:
    """Krylov solves, their trips and the host reads of their stopping
    masks inside :meth:`count`, from the port's own counters
    (``ipm/graph.py``: ``LOOPS``, ``LOOP_TRIPS``, ``LOOP_READS``), which
    the host-driven loop and the device program's loop items keep alike
    (warm-ups and captures count nowhere)."""

    def __init__(self):
        self.solves = self.trips = self.syncs = 0

    @contextlib.contextmanager
    def count(self):
        from tulip_tpu_torch.ipm import graph

        before = (graph.LOOPS, graph.LOOP_TRIPS, graph.LOOP_READS)
        try:
            yield self
        finally:
            d = [a - b for a, b in zip((graph.LOOPS, graph.LOOP_TRIPS,
                                        graph.LOOP_READS), before)]
            self.solves += d[0]
            self.trips += d[1]
            self.syncs += d[2]

    def describe(self):
        n = max(self.solves, 1)
        return (f"{self.solves} solves, trips a solve mean "
                f"{self.trips / n:.1f}, host syncs a solve "
                f"{self.syncs / n:.2f}")


def krylov_model(pb, device, name):
    """A Model holding ``pb`` (f64, presolve on) through Krylov backend
    ``name`` at its KRYLOV_TOL tolerance."""
    import warnings

    from tulip_tpu_torch import Model

    I, J, V = pb.to_coo()
    mod = Model(device=device)
    mod.pbdata.load(pb.objsense, pb.obj, pb.obj0, (I, J, V), pb.lcon,
                    pb.ucon, pb.lvar, pb.uvar, name=pb.name)
    mod.params.KKT.Backend = name
    tol = KRYLOV_TOL[name][0]
    if tol is not None:
        set_tolerances(mod, tol)
    if name == "minares":
        mod.params.IPM.IterationsLimit = MINARES_ITERATIONS
    with warnings.catch_warnings():
        # make_backend warns that tricg and minares are experimental.
        warnings.simplefilter("ignore")
        return mod, solve_model(mod)


def k1_state(A, seed, device):
    """A seeded late-IPM K1 state on A (1, m, n) f64: Θ⁻¹ over four
    decades, Rp = Rd = KRYLOV_REG, random right-hand sides."""
    rng = np.random.default_rng(seed)
    m, n = A.shape[-2:]

    def t(x):
        return torch.as_tensor(x, dtype=torch.float64, device=device)[None]

    return (t(10.0 ** rng.uniform(-2, 2, n)), t(np.full(n, KRYLOV_REG)),
            t(np.full(m, KRYLOV_REG)), t(rng.standard_normal(m)),
            t(rng.standard_normal(n)))


def krylov_residuals(A, theta_inv, regP, regD, xi_p, xi_d, dx, dy):
    """(relative K1 residual of dy, relative residual of the SQD-scaled K2
    system, which sqd-minres iterates on)."""
    from tulip_tpu_torch.kkt.base import bmtv, bmv

    treg = theta_inv + regP
    d = 1.0 / treg
    rhs = xi_p + bmv(A, d * xi_d)
    k1 = rhs - (bmv(A, d * bmtv(A, dy)) + regD * dy)
    rd = xi_d - (-treg * dx + bmtv(A, dy))
    rp = xi_p - (bmv(A, dx) + regD * dy)
    f, e = treg.sqrt(), regD.sqrt()
    k2 = (torch.cat([rd / f, rp / e], -1).norm()
          / torch.cat([xi_d / f, xi_p / e], -1).norm())
    return (k1.norm() / rhs.norm()).item(), k2.item()


def bench_staircase(m):
    """The dense f32 staircase of benchmarks/bench_sparse.py:staircase
    (same seed, same matrix; not cyclic), copied since that file imports
    JAX: bench.py:156-185's matmul-precision point at m = 8192."""
    rng = np.random.default_rng(0)
    mr, nc = 64, 96
    stages = m // mr
    A = np.zeros((m, stages * nc + nc), np.float32)
    for s in range(stages):
        for t in (s, s + 1):
            A[s * mr:(s + 1) * mr, t * nc:(t + 1) * nc] = \
                rng.standard_normal((mr, nc)).astype(np.float32)
    return A


def augmented_residual(A, theta_inv, regP, regD, xi_p, xi_d, dx, dy):
    """The conformance kit's scale-aware relative residual of the augmented
    system (kkt/testkit.py), in f64."""
    from tulip_tpu_torch.kkt.base import bmtv, bmv

    A, theta_inv, regP, regD, xi_p, xi_d, dx, dy = (
        t.double() for t in (A, theta_inv, regP, regD, xi_p, xi_d, dx, dy))
    treg = theta_inv + regP
    rd = xi_d - (-treg * dx + bmtv(A, dy))
    rp = xi_p - (bmv(A, dx) + regD * dy)

    def mx(v):
        return v.abs().max().item()

    scale_d = mx(xi_d) + mx(treg * dx) + mx(bmtv(A, dy))
    scale_p = mx(xi_p) + mx(bmv(A, dx)) + mx(regD * dy)
    return max(mx(rd) / max(scale_d, 1.0), mx(rp) / max(scale_p, 1.0))


def phase_krylov(device, count, big, card, profile):
    """11a: every Krylov backend on the transportation LP, KRYLOV_E2E end
    to end beside "dense", and one solve of KRYLOV_ONE_SOLVE on
    multiperiod_lp(4096)'s A."""
    from tulip_tpu_torch.kkt import krylov, make_backend

    lp_t, ref_t = transportation()
    golden = {}
    with count.phase() as n11:
        for name in KRYLOV_STATUS:
            trips = KrylovTrips()
            with trips.count():
                golden[name] = krylov_model(lp_t, device, name) + (trips,)
    for name, (mod, (st, z, wall), trips) in golden.items():
        check(st.name == KRYLOV_STATUS[name], f"{name} on the transportation "
              f"LP: {st.name}; the JAX package gives {KRYLOV_STATUS[name]}")
        kind = type(mod.solver_state.kkt).__name__
        check(mod.kkt_backend.name == name and kind == "KrylovState",
              f"{name}: ran {mod.kkt_backend.name!r} with a {kind}")
        rtol = KRYLOV_TOL[name][1]
        err = ("status only" if rtol is None else
               f"rel {check_objective(name, z, ref_t, rtol):.3e} <= {rtol}")
        log(f"[11a] transportation LP, {name} (tolerance "
            f"{KRYLOV_TOL[name][0] or 'default'}): {st.name} as the JAX "
            f"package's, objective {z!r} vs HiGHS {ref_t!r} ({err}); "
            f"{mod.barrier_iterations} iterations, wall {wall:.4f} s; "
            f"{trips.describe()}")
    log(f"  launches {n11}")

    e2e = {}
    with count.phase() as n11e:
        for name, m in KRYLOV_E2E:
            lp = staircase_lp(m)
            ref = highs_staircase(*lp)
            for be in ("dense", name):
                trips = KrylovTrips()
                mod = staircase_model(lp, device, "float64", be)
                with trips.count():
                    e2e[m, be] = (mod, solve_model(mod), trips, ref)
    for (m, name), (mod, (st, z, wall), trips, ref) in e2e.items():
        what = f"multiperiod_lp({m}) {name}"
        check(st.name == "OPTIMAL", f"{what}: {st.name}")
        err = check_objective(what, z, ref, 1e-6)
        log(f"  {what}, f64: OPTIMAL, objective {z!r} vs HiGHS (rel "
            f"{err:.3e}); {describe(mod, wall)}"
            + (f"; {trips.describe()}" if trips.solves else ""))
    log(f"  launches {n11e}; {card}")

    A = torch.as_tensor(big[0].toarray(), device=device)[None]
    state = k1_state(A, 4, device)
    rtol = float(np.sqrt(np.finfo(np.float64).eps))
    one = {}
    for name in KRYLOV_ONE_SOLVE:
        be = make_backend(name)
        st, ok = be.update(be.setup(A), *state[:3])
        check(bool(ok.all()), f"{name}: update failed at m = 4096")
        runs = {}
        for every in (krylov._CHECK_EVERY, 1):
            saved, krylov._CHECK_EVERY = krylov._CHECK_EVERY, every
            trips = KrylovTrips()
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with trips.count():
                    dx, dy = be.solve(st, *state[3:])
                torch.cuda.synchronize()
                runs[every] = (time.perf_counter() - t0, trips, dx, dy)
            finally:
                krylov._CHECK_EVERY = saved
        wall, trips, dx, dy = runs[krylov._CHECK_EVERY]
        k1, k2 = krylov_residuals(A, *state, dx, dy)
        own, what = (k2, "SQD-scaled K2") if name == "sqd-minres" else \
            (k1, "K1")
        check(own <= 10 * rtol, f"{name} at m = 4096: relative {what} "
              f"residual {own:.3e} > 10 rtol")
        w1, t1 = runs[1][:2]
        log(f"[11a] one {name} solve on multiperiod_lp(4096)'s A (4096 x "
            f"6240 f64), Θ⁻¹ over 1e4, Rd = {KRYLOV_REG}: {trips.trips} "
            f"trips, {wall * 1e3:.3f} ms = {wall / trips.trips * 1e3:.4f} "
            f"ms a trip, {trips.syncs} host syncs (a test every "
            f"{krylov._CHECK_EVERY} trips); relative K1 residual {k1:.3e}, "
            f"SQD-scaled K2 residual {k2:.3e} (its own: {what}, <= 10 rtol = "
            f"{10 * rtol:.3e}); with a test on every trip: {t1.trips} "
            f"trips, {w1 * 1e3:.3f} ms = {w1 / t1.trips * 1e3:.4f} ms a "
            f"trip, {t1.syncs} syncs; {card}")
        one[name] = (be, st, runs[krylov._CHECK_EVERY])
        if profile and name == "cg":
            trips = KrylovTrips()
            with trips.count():
                _, n_kernels = profile_solve(
                    lambda: be.solve(st, *state[3:]),
                    os.path.join(profile, "profile_krylov_cg.txt"), wall)
            log(f"  launches a trip under the profiler: {n_kernels} kernel "
                f"launches / {trips.trips} trips = "
                f"{n_kernels / trips.trips:.2f}")
    return golden, e2e, (A, state, one)


def phase_explicit_minv(device, count, slice_run, iters4, small, ref_small):
    """11b: ``explicit_minv`` through the chol-inv kernel on the slice, on
    the dense f64 route, and its refusal of the fused solve."""
    from tulip_tpu_torch.ipm.batch import batched_hsd_solve
    from tulip_tpu_torch.ipm.data import make_lp_data
    from tulip_tpu_torch.ipm.hsd import HSDOptions, hsd_solve
    from tulip_tpu_torch.kkt import DenseK1Backend, SmallK1Backend

    raws, dats, opts, refs = slice_run
    runs = {}
    with count.phase() as n11b:
        for refine in (1, 2):
            be = SmallK1Backend(explicit_minv=True, refinement_steps=refine)
            t0 = time.perf_counter()
            out = batched_hsd_solve(be, opts, dats)
            torch.cuda.synchronize()
            runs[refine] = (out, time.perf_counter() - t0)
    check(n11b["chol_inv"] > 0, "explicit_minv slice: the chol-inv kernel "
          "never launched")
    # One sweep may leave a few lanes at the iteration limit: in either
    # package a lane fails or not with the rounding
    # (tests/test_torch_dense_options.py). That run is held to OPTIMAL or
    # ITERATION_LIMIT, to at most ONE_SWEEP_TAIL_MAX lanes at the limit,
    # and to HiGHS on its OPTIMAL lanes; two sweeps, to phase 4's checks.
    out, wall = runs[1]
    st = out.status.cpu().numpy()
    check(set(st.tolist()) <= {OPTIMAL, ITERATION_LIMIT}, f"explicit_minv "
          f"slice, one sweep: statuses {sorted(set(st.tolist()))}")
    check(int((st != OPTIMAL).sum()) <= ONE_SWEEP_TAIL_MAX, f"explicit_minv "
          f"slice, one sweep: {int((st != OPTIMAL).sum())} lanes at the "
          f"iteration limit, over {ONE_SWEEP_TAIL_MAX}")
    pobj = out.pobj.cpu().numpy()
    for k, ref in enumerate(refs):
        if st[k] == OPTIMAL:
            check(abs(pobj[k] - ref) <= 1e-2 * max(1.0, abs(ref)),
                  f"explicit_minv slice lane {k}: {pobj[k]} vs HiGHS {ref}")
    it = out.niter.double()
    tail = np.nonzero(st != OPTIMAL)[0].tolist()
    log(f"[11b] slice through SmallK1Backend(explicit_minv=True, "
        f"refinement_steps=1): {int((st == OPTIMAL).sum())}/{len(raws)} "
        f"OPTIMAL, lanes {tail} ITERATION_LIMIT; mean iterations "
        f"{it.mean().item():.4f} (max {int(it.max())}; phase 4's "
        f"{iters4:.4f}), first solve wall {wall:.3f} s")
    out, wall = runs[2]
    n_opt, worst = check_slice(raws, out, refs, "explicit_minv slice, two "
                               "sweeps")
    it = out.niter.double()
    log(f"  refinement_steps=2: {n_opt}/{len(raws)} OPTIMAL, worst rel obj "
        f"err vs HiGHS (128 lanes) {worst:.3e}, mean iterations "
        f"{it.mean().item():.4f} (max {int(it.max())}), first solve wall "
        f"{wall:.3f} s; launches {n11b}")
    A, b, c, u = small
    dat = make_lp_data(A.toarray(), b, c, 0.0, np.zeros(len(c)), u,
                       device=device)
    with count.phase() as n11d:
        t0 = time.perf_counter()
        st = hsd_solve(dat, DenseK1Backend(explicit_minv=True), HSDOptions())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(int(st.status[0]) == OPTIMAL, f"explicit_minv dense on "
          f"multiperiod_lp(1024): status {int(st.status[0])}")
    err = check_objective("explicit_minv dense multiperiod_lp(1024)",
                          float(st.pobj[0]), ref_small, 1e-6)
    log(f"  hsd_solve(DenseK1Backend(explicit_minv=True)) on "
        f"multiperiod_lp(1024) f64 (no presolve): OPTIMAL in "
        f"{int(st.niter[0])} iterations, objective {float(st.pobj[0])!r} vs "
        f"HiGHS (rel {err:.3e}), wall {wall:.4f} s; launches {n11d}")
    try:
        SmallK1Backend(explicit_minv=True, fused_solve=True)
    except ValueError as e:
        log(f"  SmallK1Backend(explicit_minv=True, fused_solve=True) "
            f"refused: {e}")
    else:
        check(False, "SmallK1Backend(explicit_minv=True, fused_solve=True) "
              "did not raise")


def phase_matmul_precision(device, card, reps=5, m=8192,
                           names=("highest", "high")):
    """11c: DenseK1Backend(inv_factor=True, refinement_steps=2) with each
    ``matmul_precision`` of ``names`` at bench.py's m = 8192 point (f32,
    the inputs of benchmarks/mfu.py:measure): update plus one solve,
    median of ``reps`` runs of each in turn, each one's relative augmented
    residual, and torch's flag restored after every call; returns {name:
    residual}."""
    from tulip_tpu_torch.kkt import DenseK1Backend

    A = torch.as_tensor(bench_staircase(m), device=device)[None]
    n = A.shape[-1]
    rng = np.random.default_rng(1)

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)[None]

    theta_inv = t(10.0 ** rng.uniform(-2, 2, n))
    regP, regD = t(np.full(n, 1e-6)), t(np.full(m, 1e-6))
    xi_p, xi_d = t(rng.standard_normal(m)), t(rng.standard_normal(n))
    bes = {c: DenseK1Backend(inv_factor=True, refinement_steps=2,
                             matmul_precision=c) for c in names}
    state = bes[names[0]].setup(A)
    flag = torch.backends.cuda.matmul.allow_tf32
    times = {c: [] for c in names}
    out = {}
    order = list(names) + list(reversed(names))
    for k in range(len(names) * (reps + 1)):
        c = order[k % len(order)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, ok = bes[c].update(state, theta_inv, regP, regD)
        dx, dy = bes[c].solve(st, xi_p, xi_d)
        torch.cuda.synchronize()
        if k >= len(names):            # the first of each is a warm-up
            times[c].append(time.perf_counter() - t0)
        check(torch.backends.cuda.matmul.allow_tf32 == flag, f"matmul "
              f"precision {c}: torch's allow_tf32 not restored")
        check(bool(ok.all()), f"matmul precision {c}: update failed")
        out[c] = (dx, dy)
    res = {c: augmented_residual(A, theta_inv, regP, regD, xi_p, xi_d,
                                 *out[c]) for c in names}
    base = res[names[0]]
    for c in names:
        log(f"[11c] DenseK1Backend(inv_factor=True, refinement_steps=2, "
            f"matmul_precision={c!r}) on benchmarks/bench_sparse.py's "
            f"staircase({m}) ({m} x {n} f32), update + one solve: median of "
            f"{len(times[c])} {statistics.median(times[c]) * 1e3:.3f} ms; "
            f"relative augmented residual {res[c]:.3e} ({res[c] / base:.3f}x "
            f"the first's); torch's allow_tf32 restored ({flag}) after each "
            f"call; {card}")
    return res


# ---------------------------------------------------------------------------
# Phase 12: the distributed Schur path
# ---------------------------------------------------------------------------

def schur_residual(arrays, x):
    """‖Ax − b‖∞ / (1 + ‖b‖∞) of the block-angular LP of ``arrays`` (the
    arguments of ``make_block_angular``) at ``x``, by blocks in numpy
    f64 on the host."""
    A0, b0, _, T, W, h = arrays[:6]
    n0 = A0.shape[1]
    K, _, nk = W.shape
    x0, xk = x[:n0], x[n0:].reshape(K, nk)
    r0 = A0 @ x0 - b0
    rk = np.einsum("kij,j->ki", T, x0) + np.einsum("kij,kj->ki", W, xk) - h
    return (max(np.abs(r0).max(), np.abs(rk).max())
            / (1.0 + max(np.abs(b0).max(), np.abs(h).max())))


def comm_line(counts, nbytes, niter):
    """A Comm counter, per iteration: collectives, their sizes, bytes."""
    per = ", ".join(f"{op} {numel}: {c / niter:.2f}"
                    for (op, numel), c in sorted(counts.items()))
    return (f"{sum(counts.values()) / niter:.2f} collectives an iteration "
            f"({per}), {nbytes / niter:.0f} B an iteration")


def phase_distributed(device, count, card, slice_run, iters4, wall4,
                      profile):
    """Phase 12: the Schur backend at the reference's regime-2b blocks on
    one card (12a against dense, 12b at K = SCHUR_BIG_K), sharded over a
    group of one in this process and over two processes on the card
    (12c), and ``shard_batch`` of the slice over the same two (12d)."""
    import tempfile

    import torch.distributed as dist

    from tulip_tpu_torch.ipm.batch import batched_hsd_solve, lane_split
    from tulip_tpu_torch.ipm.hsd import HSDOptions, hsd_solve
    from tulip_tpu_torch.kkt import (DenseK1Backend, SchurK1Backend,
                                     SmallK1Backend)
    from tulip_tpu_torch.parallel import (block_angular_to_dense, init_comm,
                                          make_block_angular, shard_scenarios)
    from tulip_tpu_torch.parallel.dryrun import (VOLUME_DIMS,
                                                 collective_signature,
                                                 launch, run_cases,
                                                 two_stage_arrays)

    t12 = time.perf_counter()
    opts = HSDOptions()
    n0 = VOLUME_DIMS[1]

    def timed(solve):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = solve()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def launches(solve, name, wall):
        path = os.path.join(profile, name) if profile else os.devnull
        return profile_solve(solve, path, wall)[1]

    # -- 12a: Schur against dense at K = SCHUR_K ---------------------------
    arrays = two_stage_arrays(SCHUR_K, 11, VOLUME_DIMS)
    dat = make_block_angular(*arrays, device=device)
    dense = block_angular_to_dense(dat)
    with count.phase() as n12a:
        out_s, wall_s = timed(lambda: hsd_solve(dat, SchurK1Backend(), opts))
        counts_a, bytes_a = dict(dat.comm.counts), dat.comm.nbytes
        out_d, wall_d = timed(lambda: hsd_solve(dense, DenseK1Backend(),
                                                opts))
    it_s, it_d = int(out_s.niter), int(out_d.niter)
    fs, fd = float(out_s.pobj), float(out_d.pobj)
    check(int(out_s.status) == OPTIMAL and int(out_d.status) == OPTIMAL,
          f"12a: statuses {int(out_s.status)} (schur), "
          f"{int(out_d.status)} (dense)")
    check(abs(fs - fd) <= 1e-7 * max(1.0, abs(fd)),
          f"12a: schur pobj {fs!r} vs dense {fd!r}")
    ls = launches(lambda: hsd_solve(dat, SchurK1Backend(), opts),
                  "profile_schur.txt", wall_s)
    ld = launches(lambda: hsd_solve(dense, DenseK1Backend(), opts),
                  "profile_schur_dense.txt", wall_d)
    log(f"[12a] block-angular LP, K={SCHUR_K} x (mk, nk) = "
        f"({VOLUME_DIMS[2]}, {VOLUME_DIMS[3]}), (m0, n0) = "
        f"({VOLUME_DIMS[0]}, {n0}), m={dat.nrow}, n={dat.ncol}, f64 at "
        f"the default tolerances: schur OPTIMAL in {it_s} iterations, wall "
        f"{wall_s:.4f} s, {wall_s / it_s * 1e3:.3f} ms an iteration, "
        f"{ls / it_s:.1f} kernel launches an iteration; dense OPTIMAL in "
        f"{it_d}, wall {wall_d:.4f} s, {wall_d / it_d * 1e3:.3f} ms an "
        f"iteration, {ld / it_d:.1f} launches an iteration; pobj {fs!r} vs "
        f"{fd!r} (rel {abs(fs - fd) / max(1.0, abs(fd)):.3e}); launches of "
        f"our kernels {n12a}")
    log(f"  Comm() of one process: {comm_line(counts_a, bytes_a, it_s)}")
    del dense, out_d

    # -- 12b: K = SCHUR_BIG_K, where the dense K1 matrix cannot exist ------
    arrays_b = two_stage_arrays(SCHUR_BIG_K, 11, VOLUME_DIMS)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dat_b = make_block_angular(*arrays_b, device=device)
    with count.phase() as n12b:
        out_b, wall_b = timed(lambda: hsd_solve(dat_b, SchurK1Backend(),
                                                opts))
    peak = torch.cuda.max_memory_allocated() - base
    tw = (dat_b.T.numel() + dat_b.W.numel()) * dat_b.T.element_size()
    it_b = int(out_b.niter)
    check(int(out_b.status) == OPTIMAL, f"12b: status {int(out_b.status)}")
    pb, db = float(out_b.pobj), float(out_b.dobj)
    gap = abs(pb - db) / (1.0 + abs(db))
    check(gap <= opts.ToleranceRGap, f"12b: relative gap {gap:.3e}")
    x = (out_b.pt.x / out_b.pt.tau.unsqueeze(-1))[0].cpu().numpy()
    res_b = schur_residual(arrays_b, x)
    check(res_b <= 1e-8, f"12b: ‖Ax−b‖∞/(1+‖b‖∞) = {res_b:.3e}")
    lb = launches(lambda: hsd_solve(dat_b, SchurK1Backend(), opts),
                  "profile_schur_big.txt", wall_b)
    log(f"[12b] K={SCHUR_BIG_K}: m={dat_b.nrow}, n={dat_b.ncol} (a dense "
        f"K1 matrix would take {dat_b.nrow ** 2 * 8 / 1e9:.1f} GB): OPTIMAL "
        f"in {it_b} iterations, relative gap {gap:.3e}, "
        f"‖Ax−b‖∞/(1+‖b‖∞) {res_b:.3e} (host, by blocks); wall "
        f"{wall_b:.4f} s, {wall_b / it_b * 1e3:.3f} ms an iteration, "
        f"{lb / it_b:.1f} kernel launches an iteration; peak device memory "
        f"{peak / 1e6:.1f} MB above the {base / 1e6:.1f} MB held before, "
        f"T + W {tw / 1e6:.1f} MB; launches of our kernels {n12b}")
    del dat_b, out_b, arrays_b

    # -- 12c: sharded over a group of one, then over two processes ---------
    with tempfile.TemporaryDirectory() as tmp:
        comm = init_comm(SCHUR_GROUP, 0, 1, os.path.join(tmp, "store"))
        try:
            with count.phase() as n12c:
                out_1, wall_1 = timed(lambda: hsd_solve(
                    shard_scenarios(dat, comm), SchurK1Backend(), opts))
        finally:
            dist.destroy_process_group()
    check(int(out_1.niter) == it_s and float(out_1.pobj) == fs,
          f"12c: a {SCHUR_GROUP} group of one gave {int(out_1.niter)} "
          f"iterations, pobj {float(out_1.pobj)!r}; unsharded {it_s}, {fs!r}")
    log(f"[12c] sharded over a {SCHUR_GROUP} group of one: {it_s} "
        f"iterations, pobj equal to 12a's bit for bit, wall {wall_1:.4f} s; "
        f"{comm_line(comm.counts, comm.nbytes, it_s)}")
    raws, dats, opts4, refs_slice = slice_run
    # The Schur solve through the device program (its Gloo collectives are
    # host operations between captured segments), again warm, and on the
    # host loop: phase 15d holds them to each other.
    cases = [("schur", "schur", dict(arrays=arrays, state=True)),
             ("schur_warm", "schur", dict(arrays=arrays)),
             ("schur_host", "schur", dict(arrays=arrays, state=True,
                                          host_loop=True)),
             ("slice", "batch", dict(nb=len(raws), m=48, n=96, seed=0,
                                     tol=TOL, backend="pallas-small",
                                     refinement_steps=1, reps=2))]
    t0 = time.perf_counter()
    ranks = launch(run_cases, 2, backend="gloo",
                   device=torch.device(device).type, timeout_s=SCHUR_JOB_S,
                   args=(cases,))
    wall_job = time.perf_counter() - t0
    check(all(not r["modules"] for r in ranks),
          f"12c: a worker imported {[r['modules'] for r in ranks]}")
    for k, r in enumerate(ranks):
        g = r["schur"]
        check(g["status"] == OPTIMAL and g["niter"] == it_s
              and abs(g["pobj"] - fs) <= 1e-8 * max(1.0, abs(fs)),
              f"12c rank {k}: status {g['status']}, {g['niter']} "
              f"iterations, pobj {g['pobj']!r}; unsharded {it_s}, {fs!r}")
    a, b = (r["schur"]["state"] for r in ranks)
    differ = [k for k in a if a[k].tobytes() != b[k].tobytes()]
    check(not differ, f"12c: the ranks' final states differ in {differ}")
    g = ranks[0]["schur"]
    largest, schur, attempts = collective_signature(g)
    check(largest <= n0 * n0 and schur == attempts,
          f"12c: largest collective {largest} elements (n0² = {n0 * n0}), "
          f"{schur} n0×n0 all-reduces for {attempts} factorizations")
    log(f"  two processes over gloo on the card (host-staged): "
        f"{g['niter']} iterations on both ranks, pobj {g['pobj']!r} (rel "
        f"{abs(g['pobj'] - fs) / max(1.0, abs(fs)):.3e} to 12a), final "
        f"states equal bit for bit; solve wall {g['wall']:.4f} s, "
        f"{g['wall'] / g['niter'] * 1e3:.3f} ms an iteration; largest "
        f"collective {largest} elements, {schur} n0×n0 all-reduces for "
        f"{attempts} factorizations; rank 0: "
        f"{comm_line(g['counts'], g['nbytes'], g['niter'])}")

    # -- 12d: shard_batch of the slice over the same two processes ---------
    # Each rank's lanes are held to the same lanes solved as one batch
    # here, bit for bit. Phase 4's per-lane counts are not the bar: on the
    # card a lane's rounding depends on the batch's size (the slice's
    # first 1024 lanes as a batch of their own take other iteration
    # counts than inside the 2048).
    sl = [r["slice"] for r in ranks]
    be4 = SmallK1Backend(refinement_steps=1)
    n0_, n1_ = lane_split(len(raws), 2)
    alone = [batched_hsd_solve(be4, opts4, type(dats)(*(x[lo:lo + n]
                                                       for x in dats)))
             for lo, n in ((0, n0_), (n0_, n1_))]
    it_alone = np.concatenate([o.niter.cpu().numpy() for o in alone])
    p_alone = np.concatenate([o.pobj.cpu().numpy() for o in alone])
    it, pobj = sl[0]["niter"], sl[0]["pobj"]
    check(all(np.array_equal(x["niter"], it) and np.array_equal(x["pobj"],
                                                                pobj)
              for x in sl), "12d: the ranks gathered different states")
    check(np.array_equal(it, it_alone) and np.array_equal(pobj, p_alone),
          f"12d: {int((it != it_alone).sum())} lanes' iterations and "
          f"{int((pobj != p_alone).sum())} objectives differ from the same "
          f"lanes solved as one batch in this process")
    n_opt, worst = check_slice(
        raws, SimpleNamespace(status=torch.as_tensor(sl[0]["status"]),
                              pobj=torch.as_tensor(pobj)), refs_slice, "12d")
    check(all(x["chol_launches"] > 0 for x in sl),
          f"12d: the chol-inv kernel never launched on a rank "
          f"({[x['chol_launches'] for x in sl]})")
    for x in sl:
        count.total["chol_inv"] += x["chol_launches"]
        count.shapes["chol"] |= {tuple(v) for v in x["chol_shapes"]}
    log(f"[12d] shard_batch of the {len(raws)} slice LPs over 2 processes "
        f"({lane_split(len(raws), 2)} lanes), pallas-small, gathered: "
        f"{n_opt}/{len(raws)} OPTIMAL, worst rel obj err vs HiGHS (128 "
        f"lanes) {worst:.3e}; iterations and objectives equal bit for bit "
        f"to each rank's lanes solved as one batch here; mean iterations "
        f"{it.mean():.4f} (phase 4, one batch of {len(raws)}: "
        f"{iters4.mean():.4f}; {int((it != iters4).sum())} lanes with "
        f"another count); warm solve walls "
        f"{[round(x['wall'], 4) for x in sl]} s (phase 4, all lanes in one "
        f"process: {wall4:.4f} s); chol-inv launches "
        f"{[x['chol_launches'] for x in sl]}; the 2-process job took "
        f"{wall_job:.1f} s")
    log(f"  phase 12 took {time.perf_counter() - t12:.1f} s; {card}")
    return {"ranks": ranks}


# ---------------------------------------------------------------------------
# Phase 13: the device program beside the host-driven loop
# ---------------------------------------------------------------------------

# The port's kernels as torch.profiler names them: a name containing one of
# these strings is that kernel's.
KERNEL_NAMES = {"chol_inv": ("chol_inv_kernel", "blocked_panel_kernel"),
                "fused_k1_solve": ("staged_solve_kernel",
                                   "fused_solve_kernel"),
                "scaled_gram": ("scaled_gram_kernel",)}


def same_state_bits(a, b):
    """Whether two final states are equal bit for bit, leaf by leaf
    (:func:`same_bits` on each tensor)."""
    from tulip_tpu_torch.ipm.graph import leaves

    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        same_bits(x.cpu(), y.cpu()) if torch.is_tensor(x) else x == y
        for x, y in zip(la, lb))


@contextlib.contextmanager
def recorded(module, name, host_loop):
    """``module.name`` (an IPM solve taking an options dataclass) wrapped:
    every call's final state is recorded with the device program's figures
    (``ipm.graph.LAST``, empty when the host loop ran), the call's wall
    (up to a sync on the card) and its positional arguments, and with
    ``host_loop`` the call runs with ``HostLoop=True``."""
    import dataclasses

    from tulip_tpu_torch.ipm import graph

    real = getattr(module, name)
    calls = []
    # solve_model records too, and runs in CPU rehearsals.
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (
        lambda: None)

    def wrapped(*args, **kw):
        if host_loop:
            args = tuple(dataclasses.replace(a, HostLoop=True)
                         if dataclasses.is_dataclass(a)
                         and hasattr(a, "HostLoop") else a for a in args)
        graph.LAST.clear()
        sync()
        t0 = time.perf_counter()
        out = real(*args, **kw)
        sync()
        calls.append((out, dict(graph.LAST), time.perf_counter() - t0,
                      args))
        return out

    setattr(module, name, wrapped)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def device_twin(label, module, name, call, count, card, profile,
                want=(), reps=5):
    """One pair of phase 13: ``call()`` makes one or more solves through
    ``module.name``; run it through the device program and with
    ``HostLoop=True`` in this process. Checks every final state equal bit
    for bit and each solve's host reads within ceil((max niter + 1) / k) +
    2; prints the walls (the first call's warm-up, capture + instantiation
    and first replays; the median of ``reps`` warm calls beside the host
    loop's, taken in turns), host reads, peak device memory and, under
    ``--profile``, kernel time, kernels run and idle share of one warm call
    of each, and holds the profile of the device program to name each
    kernel of ``want``."""
    from tulip_tpu_torch.ipm import graph

    def one(host_loop):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with recorded(module, name, host_loop) as calls:
            call()
        torch.cuda.synchronize()
        return calls, time.perf_counter() - t0

    def peak(host_loop):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        calls, wall = one(host_loop)
        return calls, wall, torch.cuda.max_memory_allocated() - base

    graph.clear_device_programs()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    with count.phase() as launches:
        first, first_wall, peak_dev = peak(False)
        reserved = torch.cuda.memory_reserved() - reserved0
        host, host_first_wall, peak_host = peak(True)
        walls_dev, walls_host, replay_s, solve_dev, solve_host = \
            [], [], [], [], []
        for _ in range(reps):
            calls, w = one(False)
            check(all(same_state_bits(c[0], f[0])
                      for c, f in zip(calls, first)),
                  f"{label}: a warm replay differs from the first solve")
            walls_dev.append(w)
            replay_s.append(sum(c[1]["replay_s"] for c in calls))
            solve_dev.append(sum(c[2] for c in calls))
            calls, w = one(True)
            walls_host.append(w)
            solve_host.append(sum(c[2] for c in calls))
    check(len(first) == len(host) > 0 and all(c[1] for c in first)
          and not any(c[1] for c in host),
          f"{label}: {len(first)} device-program solves, {len(host)} "
          f"host-loop solves")
    same = [same_state_bits(d[0], h[0]) for d, h in zip(first, host)]
    check(all(same), f"{label}: the device program's final state differs "
          f"from HostLoop=True's in solves {[i for i, s in enumerate(same) if not s]}")
    syncs, bars = [], []
    for state, fig, *_ in first:
        bar = -(-(int(state.niter.max()) + 1) // graph.K_PASSES) + 2
        syncs.append(fig["syncs"])
        bars.append(bar)
        check(fig["syncs"] <= bar, f"{label}: {fig['syncs']} host reads in "
              f"a solve, over the bar {bar}")
    niter = np.concatenate([c[0].niter.cpu().numpy() for c in first])
    statuses = np.concatenate([c[0].status.cpu().numpy() for c in first])
    wd, wh = statistics.median(walls_dev), statistics.median(walls_host)
    out = {"solves": len(first), "lanes": int(niter.size),
           "mean_niter": float(niter.mean()), "max_niter": int(niter.max()),
           "statuses": {int(k): int(v) for k, v in
                        zip(*np.unique(statuses, return_counts=True))},
           "host_reads": syncs, "read_bars": bars,
           "warmup_s": sum(c[1]["warmup_s"] for c in first),
           "capture_s": sum(c[1]["capture_s"] for c in first),
           "instantiate_s": sum(c[1]["instantiate_s"] for c in first),
           "nodes_a_pass": [c[1]["nodes_a_pass"] for c in first],
           "first_replay_s": sum(c[1]["replay_s"] for c in first),
           "first_call_s": first_wall, "first_solve_s":
           sum(c[2] for c in first), "warm_call_s": wd,
           "warm_solve_s": statistics.median(solve_dev),
           "warm_replay_s": statistics.median(replay_s),
           "host_loop_first_call_s": host_first_wall, "host_loop_call_s": wh,
           "host_loop_solve_s": statistics.median(solve_host),
           "peak_mb": peak_dev / 1e6, "host_loop_peak_mb": peak_host / 1e6,
           "pool_reserved_mb": reserved / 1e6,
           "launches_a_pass": [c[1]["launches_a_pass"] for c in first],
           "launches": {k: v for k, v in launches.items() if v}}
    if profile:
        seen = set()
        out["profile"] = profile_solve(
            call, os.path.join(profile, f"profile_{label}_graph.txt"), wd,
            seen)
        out["profile_host_loop"] = profile_solve(
            lambda: one(True), os.path.join(profile,
                                            f"profile_{label}_host.txt"), wh)
        for kernel in want:
            hit = sorted(k for k in seen
                         if any(n in k for n in KERNEL_NAMES[kernel]))
            check(hit, f"{label}: the profile of a replay shows no {kernel} "
                  f"kernel")
            out.setdefault("kernels_in_replay", {})[kernel] = hit[:2]
    log(f"[13] {label}: device program = HostLoop=True bit for bit "
        f"({len(first)} solves, {niter.size} lanes, mean iterations "
        f"{niter.mean():.4f}); {json.dumps(out)}; {card}")
    return out


def phase_device_program(device, count, card, slice_run, fused, warm_be,
                         prev, dats2, probs, big, small, profile):
    """Phase 13: each pair runs phase 4's, 4b's, 8's, 9's, 6's and 7's
    inputs through the device program and with ``HostLoop=True``
    (:func:`device_twin`)."""
    import importlib

    from tulip_tpu_torch import batch_linprog
    from tulip_tpu_torch.ipm import batch as tbatch
    from tulip_tpu_torch.kkt import SmallK1Backend

    # The package exports a function named like this module.
    tmodel = importlib.import_module("tulip_tpu_torch.model")
    raws, dats, opts = slice_run
    t13 = time.perf_counter()
    res = {}
    small_be = SmallK1Backend(refinement_steps=1)
    res["13a"] = device_twin(
        "13a_slice", tbatch, "solve",
        lambda: tbatch.batched_hsd_solve(small_be, opts, dats), count, card,
        profile, want=("chol_inv",))
    res["13b"] = device_twin(
        "13b_slice_fused", tbatch, "solve",
        lambda: tbatch.batched_hsd_solve(fused, opts, dats), count, card,
        profile, want=("chol_inv", "fused_k1_solve"))
    res["13c"] = device_twin(
        "13c_entry_mpc", tbatch, "solve",
        lambda: batch_linprog(probs, algorithm="MPC", device=device), count,
        card, profile,
        want=("chol_inv",))
    res["13d"] = device_twin(
        "13d_warm_resolve", tbatch, "solve",
        lambda: tbatch.batched_hsd_resolve(warm_be, opts, dats2, prev),
        count, card, profile, want=("chol_inv", "fused_k1_solve"))
    res["13e"] = device_twin(
        "13e_single_lp_4096", tmodel, "hsd_solve",
        lambda: solve_model(staircase_model(big, device, "float32",
                                            "dense-pallas")),
        count, card, profile, want=("scaled_gram",), reps=3)
    res["13f"] = device_twin(
        "13f_single_lp_1024", tmodel, "hsd_solve",
        lambda: (solve_model(staircase_model(small, device, "float64")),
                 solve_model(staircase_model(small, device, "float32"))),
        count, card, profile, want=("chol_inv",))
    log(f"  phase 13 took {time.perf_counter() - t13:.1f} s; {card}")
    return res


@contextlib.contextmanager
def scatter_repeats(plain=False):
    """Every call of the level engine's scatter-add
    (``kkt/levels.py:index_add_fixed``, from ``kkt/levels.py`` and
    ``kkt/sparse.py``) inside: run twice more on copies of its input and
    compared bit for bit; with ``plain``, the two extra runs are of
    ``index_add_`` itself, the op it replaced (the solve goes on with
    ``index_add_fixed``'s result either way). Yields {call site: [calls,
    calls that moved a bit]}."""
    import sys

    from tulip_tpu_torch.kkt import levels, sparse

    real = levels.index_add_fixed
    seen = {}

    def probe(t, index, source, alpha=1):
        return t.index_add_(0, index, source, alpha=alpha)

    def twice(t, index, source, alpha=1):
        f = sys._getframe(1)
        site = (f"{os.path.relpath(f.f_code.co_filename, ROOT)}:"
                f"{f.f_lineno}")
        run = probe if plain else real
        a = run(t.clone(), index, source, alpha=alpha)
        b = run(t.clone(), index, source, alpha=alpha)
        s = seen.setdefault(site, [0, 0])
        s[0] += 1
        bits = {8: torch.int64, 4: torch.int32}[a.element_size()]
        s[1] += not torch.equal(a.view(bits), b.view(bits))
        return real(t, index, source, alpha=alpha)

    levels.index_add_fixed = sparse.index_add_fixed = twice
    try:
        yield seen
    finally:
        levels.index_add_fixed = sparse.index_add_fixed = real


def structured_twin(label, mod, count, card, profile):
    """One route of phase 14: the IPM call that ``mod``'s last solve made
    (through the device program: phases 6b-7d), run again from one
    initial state with ``HostLoop=True`` twice, then through a device
    program built anew (the cache cleared) and 3 times warm. Checks the
    statuses equal, the two host-loop runs equal bit for bit and every
    device-program state equal to theirs bit for bit; one host read a
    pass. On the routes whose host loop did not repeat its bits before
    the level engine's scatter-adds were made to (``SCATTER_ROUTES``), a
    third host-loop run runs each of those scatters twice more and
    compares their bits, and a fourth runs plain ``index_add_`` twice at
    the same calls and counts the calls whose two runs differ (the
    census that found them; not a check). Prints the warm-up, capture and
    instantiation seconds, the graph's nodes a pass, the first and the
    warm solves' walls and ms an iteration beside the host loop's, and
    peak device memory of both (above the data and the initial state);
    under ``--profile``, kernel time and idle share of a warm solve and of
    a host-loop run."""
    import dataclasses

    from tulip_tpu_torch.ipm import graph, hsd, mpc

    _, fig, _, (dat, backend, opts) = mod.smoke_ipm[-1]
    check(backend.device_loop and fig.get("built") is not None,
          f"{label}: {backend.name!r} did not run as the device program")
    if isinstance(opts, mpc.MPCOptions):
        init, iteration = mpc.init_state_mpc, mpc.mpc_iteration
    else:
        def init(d, b):
            return hsd.init_state(d, b, mehrotra=opts.MehrotraStart)
        iteration = hsd.hsd_iteration
    graph.clear_device_programs()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with hsd.full_matmul_precision():
        state0 = init(dat, backend)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    base = torch.cuda.memory_allocated()

    def run(o):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        graph.LAST.clear()
        t0 = time.perf_counter()
        out = hsd.solve(backend, o, dat, init=lambda d, b: state0,
                        iteration=iteration)
        torch.cuda.synchronize()
        return (out, time.perf_counter() - t0,
                torch.cuda.max_memory_allocated() - base, dict(graph.LAST))

    host_opts = dataclasses.replace(opts, HostLoop=True)
    with count.phase() as launches:
        host = [run(host_opts) for _ in range(2)]
        first = run(opts)
        warm = [run(opts) for _ in range(3)]
    check(first[3].get("built") is True
          and all(w[3].get("built") is False for w in warm)
          and not any(h[3] for h in host),
          f"{label}: the device program was not built once and replayed")

    def lane(out):
        return (int(out.status[0]), int(out.niter[0]), float(out.pobj[0]))

    hs = [lane(h[0]) for h in host]
    host_same = same_state_bits(host[0][0], host[1][0])
    check(host_same, f"{label}: two host-loop runs from one initial state "
          f"differ")
    for r in [first] + warm:
        st, it, z = lane(r[0])
        check(st == hs[0][0], f"{label}: status {st} through the device "
              f"program, {hs[0][0]} on the host loop")
        bar = -(-(it + 1) // graph.K_PASSES) + 2
        check(r[3]["syncs"] <= bar, f"{label}: {r[3]['syncs']} host reads, "
              f"over the bar {bar}")
        check(same_state_bits(r[0], host[0][0]), f"{label}: the device "
              f"program's state differs from the host loop's")
    dev_same = all(same_state_bits(r[0], first[0]) for r in warm)
    niter = hs[0][1]
    wd = statistics.median(w[1] for w in warm)
    fg = first[3]
    out = {"backend": backend.name, "state": type(state0.kkt).__name__,
           "iterations": [h[1] for h in hs] + [lane(first[0])[1]],
           "host_loop_runs_equal_bits": host_same,
           "device_equals_host_bits": same_state_bits(first[0], host[0][0]),
           "device_runs_equal_bits": dev_same,
           "objective_host": [h[2] for h in hs],
           "objective_device": lane(first[0])[2],
           "init_s": init_s, "warmup_s": fg["warmup_s"],
           "capture_s": fg["capture_s"],
           "instantiate_s": fg["instantiate_s"],
           "nodes_a_pass": fg["nodes_a_pass"], "passes": fg["passes"],
           "host_reads": fg["syncs"], "first_solve_s": first[1],
           "first_replay_s": fg["replay_s"], "warm_solve_s": wd,
           "host_loop_solve_s": [h[1] for h in host],
           "ms_an_iteration": wd / niter * 1e3,
           "host_loop_ms_an_iteration": statistics.mean(
               h[1] for h in host) / niter * 1e3,
           "peak_mb": first[2] / 1e6, "warm_peak_mb": warm[0][2] / 1e6,
           "host_loop_peak_mb": host[0][2] / 1e6,
           "launches": {k: v for k, v in launches.items() if v}}
    if label in SCATTER_ROUTES:
        with scatter_repeats() as seen:
            again = run(host_opts)
        moved = {k: v for k, v in seen.items() if v[1]}
        check(seen and not moved and same_state_bits(again[0], host[0][0]),
              f"{label}: the level engine's scatter-adds moved bits between "
              f"two runs of one input: {moved} (calls, moved) by site")
        out["scatter_calls"] = seen
        # The census that found them: plain index_add_ at the same sites.
        with scatter_repeats(plain=True) as census:
            run(host_opts)
        out["plain_index_add_moved"] = census
    if profile:
        out["profile"] = profile_solve(
            lambda: run(opts), os.path.join(profile, f"profile_{label}_"
                                            f"graph.txt"), wd)
        out["profile_host_loop"] = profile_solve(
            lambda: run(host_opts), os.path.join(profile, f"profile_{label}"
                                                 f"_host.txt"),
            statistics.mean(h[1] for h in host))
    log(f"[14] {label}: {backend.name} ({out['state']}) through the device "
        f"program, bit for bit with HostLoop=True, whose two runs agree; "
        f"{json.dumps(out)}; {card}")
    return out


def phase_structured_device(routes, count, card, profile):
    """Phase 14: each route of phases 6b-7d (``routes``: label, solved
    Model) through :func:`structured_twin`."""
    t14 = time.perf_counter()
    res = {label: structured_twin(label, mod, count, card, profile)
           for label, mod in routes}
    log(f"  phase 14 took {time.perf_counter() - t14:.1f} s; {card}")
    return res


# ---------------------------------------------------------------------------
# Phase 15: the Krylov and Schur routes through the device program
# ---------------------------------------------------------------------------

def same_tensor_bits(a, b):
    """Whether two final states' tensors are equal bit for bit, leaf by
    leaf (leaves that are not tensors, such as a Schur state's group, are
    not compared)."""
    from tulip_tpu_torch.ipm.graph import leaves

    la = [x for x in leaves(a) if torch.is_tensor(x)]
    lb = [x for x in leaves(b) if torch.is_tensor(x)]
    return len(la) == len(lb) and all(same_bits(x.cpu(), y.cpu())
                                      for x, y in zip(la, lb))


def program_twin(label, dat, backend, opts, iteration, init, warm=1,
                 built=None, profile=None):
    """One solve from one initial state (``init``, run once, eagerly)
    through the host-driven loop and through a device program built anew
    (the cache cleared), then ``warm`` times warm; with ``warm = 0`` the
    first solve's replays (``graph.LAST["replay_s"]``: no warm-up, capture
    or instantiation) stand for a warm solve. With ``built``, the figures
    of an earlier solve that built the same program, the cache is kept
    and its build figures are those. Checks the final states equal bit
    for bit. Returns the figures: iterations, walls and ms an iteration,
    peak device memory above the inputs, the program's script, nodes,
    capture and instantiation seconds, and the Krylov solves, trips and
    host reads of both (``KrylovTrips``), the program's from
    ``graph.LAST``."""
    import dataclasses

    from tulip_tpu_torch.ipm import graph, hsd

    if built is None:
        graph.clear_device_programs()
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    with hsd.full_matmul_precision():
        state0 = init(dat, backend)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()

    comm = getattr(dat, "comm", None)

    def run(o):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        graph.LAST.clear()
        if comm is not None:
            comm.reset()
        trips = KrylovTrips()
        graph.LOOP_LOG = trips.log = []
        t0 = time.perf_counter()
        try:
            with trips.count():
                out = hsd.solve(backend, o, dat, init=lambda d, b: state0,
                                iteration=iteration)
                torch.cuda.synchronize()
        finally:
            graph.LOOP_LOG = None
        wall = time.perf_counter() - t0
        trips.comm = None if comm is None else comm_line(
            comm.counts, comm.nbytes, max(int(out.niter.max()), 1))
        return (out, wall, torch.cuda.max_memory_allocated() - base,
                dict(graph.LAST), trips)

    host = run(dataclasses.replace(opts, HostLoop=True))
    first = run(opts)
    warms = [run(opts) for _ in range(warm)]
    fg = first[3]
    check((built is not None or fg.get("built") is True) and not host[3]
          and all(w[3].get("built") is False for w in warms),
          f"{label}: the device program was not built once and replayed")
    check(same_tensor_bits(first[0], host[0])
          and all(same_tensor_bits(w[0], host[0]) for w in warms),
          f"{label}: the device program's final state differs from the "
          f"host loop's")
    # Each Krylov solve of the host loop is one of the program's, with its
    # trips and host reads: the program adds the masked corrections' solves.
    check(is_subsequence(host[4].log, first[4].log),
          f"{label}: the host loop's Krylov solves (trips, host reads) are "
          f"not, in order, among the device program's")
    niter = max(int(host[0].niter.max()), 1)
    wd = (statistics.median(w[1] for w in warms) if warms
          else fg["replay_s"])
    if built is not None:
        fg = {**fg, **{k: built[k] for k in ("warmup_s", "capture_s",
                                             "instantiate_s")}}
    ht = host[4]
    out = {"backend": backend.name, "status": int(first[0].status[0]),
           "iterations": int(host[0].niter.max()),
           "host_loop_s": host[1], "first_s": first[1], "warm_s": wd,
           "ms_an_iteration": wd / niter * 1e3,
           "host_loop_ms_an_iteration": host[1] / niter * 1e3,
           "peak_mb": first[2] / 1e6, "host_loop_peak_mb": host[2] / 1e6,
           "passes": fg["passes"], "segments": fg["segments"],
           "loops_a_pass": fg["loops_a_pass"],
           "chunk_graphs": fg["chunk_graphs"],
           "host_ops_a_pass": fg["host_ops_a_pass"],
           "nodes_a_pass": fg["nodes_a_pass"],
           "chunk_nodes": fg["chunk_nodes"], "warmup_s": fg["warmup_s"],
           "capture_s": fg["capture_s"],
           "instantiate_s": fg["instantiate_s"],
           "solves": fg["loops"], "trips": fg["trips"],
           "loop_reads": fg["loop_reads"],
           "chunk_replays": fg["chunk_replays"],
           "host_reads": fg["host_reads"],
           "host_loop_solves": ht.solves, "host_loop_trips": ht.trips,
           "host_loop_loop_reads": ht.syncs,
           "masked_trips": fg["trips"] - ht.trips}
    if comm is not None:
        out["comm"], out["host_loop_comm"] = (warms or [first])[-1][4].comm, \
            ht.comm
    if fg["loops"]:
        out["trips_a_solve"] = fg["trips"] / fg["loops"]
        out["reads_a_solve"] = fg["loop_reads"] / fg["loops"]
        out["ms_a_trip"] = wd / fg["trips"] * 1e3
    if ht.solves:
        out["host_loop_trips_a_solve"] = ht.trips / ht.solves
        out["host_loop_reads_a_solve"] = ht.syncs / ht.solves
        out["host_loop_ms_a_trip"] = host[1] / ht.trips * 1e3
    if profile:
        # The warm program only: a host-loop run of these routes records
        # a profiler event for each of its ~29 launches a trip (1.7
        # million for cg at m = 256).
        out["profile"] = profile_solve(
            lambda: run(opts), os.path.join(profile, f"profile_{label}_"
                                            f"graph.txt"), wd)
    return out, first[0]


def is_subsequence(part, whole):
    """Whether ``part``'s items appear in ``whole`` in the same order."""
    it = iter(whole)
    return all(any(x == y for y in it) for x in part)


def ipm_of(mod):
    """(dat, backend, opts, iteration, init) of the IPM call that ``mod``'s
    last solve made (:func:`solve_model`)."""
    from tulip_tpu_torch.ipm import hsd, mpc

    _, fig, _, (dat, backend, opts) = mod.smoke_ipm[-1]
    check(fig.get("built") is not None, f"{backend.name}: the Model's "
          f"solve did not run as the device program")
    if isinstance(opts, mpc.MPCOptions):
        return (dat, backend, opts, mpc.mpc_iteration, mpc.init_state_mpc,
                fig)

    def init(d, b):
        return hsd.init_state(d, b, mehrotra=opts.MehrotraStart)
    return dat, backend, opts, hsd.hsd_iteration, init, fig


def phase_krylov_device(krylov_run, schur_run, device, card, profile):
    """Phase 15: the 13 Krylov backends (15a-15c) and ``"schur"`` (15d)
    through the device program, each beside ``HostLoop=True`` in this
    process."""
    import tempfile

    import torch.distributed as dist

    from tulip_tpu_torch.ipm import graph
    from tulip_tpu_torch.ipm.hsd import HSDOptions, hsd_solve
    from tulip_tpu_torch.kkt import SchurK1Backend
    from tulip_tpu_torch.parallel import (init_comm, make_block_angular,
                                          shard_scenarios)
    from tulip_tpu_torch.parallel.dryrun import VOLUME_DIMS, two_stage_arrays
    from tulip_tpu_torch.status import TerminationStatus

    t15 = time.perf_counter()
    golden, e2e, (A, kstate, one) = krylov_run
    res = {}

    # -- 15a: the 13 backends on the transportation LP ---------------------
    for name, (mod, _, _) in golden.items():
        label = f"15a_{name}"
        dat, be, opts, iteration, init, _ = ipm_of(mod)
        out, final = program_twin(label, dat, be, opts, iteration, init,
                                  warm=0)
        st = TerminationStatus(out["status"]).name
        check(st == KRYLOV_STATUS[name], f"{label}: {st}, the JAX "
              f"package's {KRYLOV_STATUS[name]}")
        res[label] = out
        log(f"[15a] transportation LP, {name}: {st} through the device "
            f"program, bit for bit with HostLoop=True; each of the host "
            f"loop's {out['host_loop_solves']} Krylov solves among the "
            f"program's {out['solves']} with its trips and host reads; "
            f"host reads a solve {out.get('reads_a_solve', 0):.2f} (host "
            f"loop {out.get('host_loop_reads_a_solve', 0):.2f}); "
            f"{json.dumps(out)}")

    # -- 15b: the end-to-end runs -------------------------------------------
    for (m, name), (mod, _, _, _) in e2e.items():
        if name == "dense":
            continue
        label = f"15b_{name}_{m}"
        dat, be, opts, iteration, init, fig = ipm_of(mod)
        # Phase 11a's solve built this program: it is replayed (or built
        # again, if the cache let it go) and its build figures are 11a's.
        out, _ = program_twin(label, dat, be, opts, iteration, init, warm=0,
                              built=fig, profile=profile)
        dmod = e2e[m, "dense"][0]
        dense_wall, dense_it = dmod.smoke_ipm[-1][2], dmod.barrier_iterations
        out["dense_ms_an_iteration"] = dense_wall / max(dense_it, 1) * 1e3
        res[label] = out
        log(f"[15b] multiperiod_lp({m}) {name}: {out['iterations']} "
            f"iterations, bit for bit with HostLoop=True; "
            f"{out['ms_an_iteration']:.3f} ms an iteration warm (host loop "
            f"{out['host_loop_ms_an_iteration']:.3f}, 'dense' "
            f"{out['dense_ms_an_iteration']:.3f}); "
            f"{out.get('ms_a_trip', 0):.4f} ms of IPM wall a trip (host "
            f"loop {out.get('host_loop_ms_a_trip', 0):.4f}); masked "
            f"correction trips {out['masked_trips']} of {out['trips']}; "
            f"{json.dumps(out)}; {card}")

    # -- 15c: one solve at full width as a loop item ------------------------
    bound = 2 * A.numel() * A.element_size() / PEAK_BYTES_S * 1e3
    for name, (be, st, (hwall, htrips, hdx, hdy)) in one.items():
        zeros = (torch.zeros_like(hdx), torch.zeros_like(hdy))

        def solve_once():
            return graph.run(("15c", name), (st,) + tuple(kstate[3:]),
                             zeros, lambda d, s: be.solve(*d),
                             lambda s: torch.zeros((), dtype=torch.bool,
                                                   device=A.device))
        graph.clear_device_programs()
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dx, dy = solve_once()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            fg = dict(graph.LAST)
        check(same_bits(dx.cpu(), hdx.cpu()) and same_bits(dy.cpu(),
                                                          hdy.cpu())
              and fg["trips"] == htrips.trips,
              f"15c {name}: the loop item's solve ({fg['trips']} trips) "
              f"differs from the host loop's ({htrips.trips})")
        w = statistics.median(walls[1:])
        res[f"15c_{name}"] = dict(
            trips=fg["trips"], reads=fg["loop_reads"],
            host_loop_reads=htrips.syncs, ms=w * 1e3,
            ms_a_trip=w / fg["trips"] * 1e3,
            host_loop_ms_a_trip=hwall / htrips.trips * 1e3,
            bound_ms_a_trip=bound if name == "cg" else None,
            chunk_graphs=fg["chunk_graphs"], chunk_nodes=fg["chunk_nodes"],
            first_s=walls[0])
        log(f"[15c] one {name} solve on multiperiod_lp(4096)'s A as a loop "
            f"item: {fg['trips']} trips, bit for bit with the host loop, "
            f"{w / fg['trips'] * 1e3:.4f} ms a trip warm (host loop "
            f"{hwall / htrips.trips * 1e3:.4f}), {fg['loop_reads']} host "
            f"reads (host loop {htrips.syncs}); "
            + (f"a cg trip reads A twice: {bound:.4f} ms at "
               f"{PEAK_BYTES_S / 1e12:.2f} TB/s; " if name == "cg" else "")
            + f"{json.dumps(res[f'15c_{name}'])}; {card}")
    graph.clear_device_programs()
    del one, A

    # -- 15d: "schur" ---------------------------------------------------------
    opts = HSDOptions()

    def schur_init(d, b):
        from tulip_tpu_torch.ipm.hsd import init_state
        return init_state(d, b, mehrotra=opts.MehrotraStart)

    from tulip_tpu_torch.ipm.hsd import hsd_iteration
    outs = {}
    for label, K in (("15d_12a", SCHUR_K), ("15d_12b", SCHUR_BIG_K)):
        dat = make_block_angular(*two_stage_arrays(K, 11, VOLUME_DIMS),
                                 device=device)
        out, final = program_twin(label, dat, SchurK1Backend(), opts,
                                  hsd_iteration, schur_init)
        check(out["status"] == OPTIMAL, f"{label}: status {out['status']}")
        it = out["iterations"]
        res[label] = out
        outs[label] = (dat, final)
        log(f"[15d] {label[4:]} (K = {K}): OPTIMAL in {it} iterations "
            f"through the device program ({out['segments']} segment(s), "
            f"{out['host_ops_a_pass']} host operations a pass), bit for bit "
            f"with HostLoop=True; {out['ms_an_iteration']:.3f} ms an "
            f"iteration warm (host loop "
            f"{out['host_loop_ms_an_iteration']:.3f}); peak "
            f"{out['peak_mb']:.1f} MB (host loop "
            f"{out['host_loop_peak_mb']:.1f}); {json.dumps(out)}; {card}")
        if K == SCHUR_BIG_K:
            del dat, final
            outs.pop(label)
    dat, final = outs["15d_12a"]
    with tempfile.TemporaryDirectory() as tmp:
        comm = init_comm(SCHUR_GROUP, 0, 1, os.path.join(tmp, "store"))
        try:
            graph.clear_device_programs()
            sh = shard_scenarios(dat, comm)
            hsd_solve(sh, SchurK1Backend(), opts)
            comm.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out1 = hsd_solve(sh, SchurK1Backend(), opts)
            torch.cuda.synchronize()
            w1 = time.perf_counter() - t0
            fg = dict(graph.LAST)
            counts1, bytes1 = dict(comm.counts), comm.nbytes
            graph.clear_device_programs()
        finally:
            dist.destroy_process_group()
    it = int(out1.niter[0])
    check(same_tensor_bits(out1, final) and fg["segments"] == 1
          and fg["host_ops_a_pass"] == 0,
          f"15d: the {SCHUR_GROUP} group of one through the device program "
          f"({fg['segments']} segments, {fg['host_ops_a_pass']} host "
          f"operations a pass) differs from 12a's unsharded state")
    res["15d_group_of_one"] = dict(iterations=it, wall_s=w1,
                               ms_an_iteration=w1 / it * 1e3,
                               nodes_a_pass=fg["nodes_a_pass"],
                               segments=fg["segments"])
    log(f"[15d] 12c's {SCHUR_GROUP} group of one, captured whole (1 segment, "
        f"{fg['nodes_a_pass']} nodes a pass): bit for bit with 12a's "
        f"state; warm {w1 / it * 1e3:.3f} ms an iteration; "
        f"{comm_line(counts1, bytes1, it)}")
    ranks = schur_run["ranks"]
    for k, r in enumerate(ranks):
        g, h = r["schur"], r["schur_host"]
        check(g["graph"].get("built") is True and not h["graph"],
              f"15d rank {k}: the Gloo job's solves did not take their "
              f"routes")
        differ = [f for f in g["state"]
                  if g["state"][f].tobytes() != h["state"][f].tobytes()]
        check(not differ and g["niter"] == h["niter"],
              f"15d rank {k}: the device program's state differs from the "
              f"host loop's in {differ}")
    a, b = (r["schur"]["state"] for r in ranks)
    check(all(a[f].tobytes() == b[f].tobytes() for f in a),
          "15d: the ranks' program states differ")
    g, h, w = (ranks[0][k] for k in ("schur", "schur_host", "schur_warm"))
    gg = g["graph"]
    check(g["niter"] == res["15d_12a"]["iterations"]
          and w["graph"].get("built") is False,
          f"15d: {g['niter']} iterations over Gloo, 12a's "
          f"{res['15d_12a']['iterations']}; or the warm solve was built "
          f"anew")
    res["15d_gloo_two"] = dict(
        iterations=g["niter"], first_s=g["wall"], warm_s=w["wall"],
        ms_an_iteration=w["wall"] / w["niter"] * 1e3,
        host_loop_ms_an_iteration=h["wall"] / h["niter"] * 1e3,
        segments=gg["segments"], host_ops_a_pass=gg["host_ops_a_pass"],
        nodes_a_pass=gg["nodes_a_pass"], capture_s=gg["capture_s"],
        instantiate_s=gg["instantiate_s"])
    log(f"[15d] 12c's two Gloo processes through the segmented program: "
        f"{g['niter']} iterations (12a's {res['15d_12a']['iterations']}), "
        f"ranks equal bit for bit and each equal to its host loop; warm "
        f"{w['wall'] / w['niter'] * 1e3:.3f} ms an iteration (host loop "
        f"{h['wall'] / h['niter'] * 1e3:.3f}); "
        f"{gg['segments']} segments and {gg['host_ops_a_pass']} host "
        f"operations a pass; rank 0 warm program: "
        f"{comm_line(w['counts'], w['nbytes'], w['niter'])}; host loop: "
        f"{comm_line(h['counts'], h['nbytes'], h['niter'])}; "
        f"{json.dumps(res['15d_gloo_two'])}")
    log(f"  phase 15 took {time.perf_counter() - t15:.1f} s; {card}")
    return res


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


def profile_solve(solve, path, wall_s, seen=None):
    """torch.profiler table of one ``solve`` into ``path``; returns the
    summed kernel time in ms and the count of kernel launches (kernels run
    inside a CUDA graph's replay included), and adds the kernels' names to
    the set ``seen`` when one is given. The profiled run's own wall is
    inflated by the profiler, so the idle share is taken against
    ``wall_s``, the median unprofiled wall of the same solve."""
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
    if seen is not None:
        seen.update(e.key for e in ka if e.device_type == DeviceType.CUDA)
    summary = (f"kernel time {busy_ms:.3f} ms in {n_kernels} kernel "
               f"launches; unprofiled wall {wall_s * 1e3:.3f} ms; device "
               f"idle share {1 - busy_ms / (wall_s * 1e3):.4f}")
    with open(path, "w") as f:
        f.write(summary + "\n" + ka.table(sort_by="self_cuda_time_total",
                                          row_limit=40) + "\n")
    log(f"  profile: {summary} -> {path}")
    return busy_ms, n_kernels


COUNTERS = {"chol_inv": ("chol", "KERNEL_LAUNCHES"),
            "chol_inv_blocked": ("chol", "KERNEL_LAUNCHES_BLOCKED"),
            "chol_inv_packed": ("chol", "KERNEL_LAUNCHES_PACKED"),
            "fused_k1_solve": ("solve", "KERNEL_LAUNCHES"),
            "scaled_gram": ("gram", "KERNEL_LAUNCHES")}


class Launches:
    """Kernel launch counts of the main path: :meth:`phase` sets every
    count to 0 just before a phase and adds them to the totals just after.
    The counts are launches that ran (a node of a device program's pass
    once for every replay); the nodes captured into device programs are
    reported apart, as ``captured_nodes``, and count in no total."""

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
        for mod in self.mods.values():
            mod.CAPTURED_LAUNCHES = 0
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
        # Nodes recorded into device programs: not launches, not counted.
        got["captured_nodes"] = sum(m.CAPTURED_LAUNCHES
                                    for m in self.mods.values())
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
        f"{torch.__version__}, CUDA {torch.version.cuda}; {card}; CUDA-graph "
        f"IF nodes in this torch: "
        f"{hasattr(torch._C._CUDAGraph, 'begin_capture_to_if_node')}")

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

    # -- 6c. the sparse-first and SMW routes at the defaults, counted ------
    from tulip_tpu_torch.ipm.sparse_data import SparseLPData

    runs6c = [("multiperiod_lp(8192)", staircase_lp(8192), "sparse", True),
              ("staircase_lp(8192, dense_cols=2)",
               staircase_lp(8192, dense_cols=2), "sparse-smw", True),
              ("staircase_lp(4096, dense_cols=2)",
               staircase_lp(4096, dense_cols=2), "sparse-smw", False)]
    refs6c = {what: highs_staircase(*lp) for what, lp, _, _ in runs6c}
    sparse_first = {}
    with count.phase() as n6c:
        for what, lp, want_be, sf in runs6c:
            m6c = staircase_model(lp, device, "float64")
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            st6c, z6c, w6c = solve_model(m6c)
            peak = torch.cuda.max_memory_allocated() - base
            sparse_first[what] = (m6c, st6c, z6c, w6c, peak)
    for what, lp, want_be, sf in runs6c:
        m6c, st6c, z6c, w6c, peak = sparse_first[what]
        A = lp[0]
        dense_bytes = A.shape[0] * A.shape[1] * 8
        check(m6c.kkt_backend.name == want_be, f"{what}: routed to "
              f"{m6c.kkt_backend.name!r}, not {want_be!r}")
        kkt = m6c.solver_state.kkt
        kind = type(kkt).__name__
        if want_be == "sparse":
            # The dense route's "sparse" plans at block 64; the
            # sparse-first data at 128, from which this state was built.
            check(kind == "SparseK1LevelState" and kkt.Apc.shape[2] == 128,
                  f"{what}: a {kind} of block {kkt.Apc.shape[2]}, not the "
                  f"level state of the sparse-first data")
        else:
            check(kind == "SplitK1State" and kkt.U.shape[-1] == 2,
                  f"{what}: a {kind}, not an SMW state with U of width 2")
            check(isinstance(kkt.A, SparseLPData) == sf,
                  f"{what}: the operator is a {type(kkt.A).__name__}")
        check(st6c.name == "OPTIMAL", f"{what}: status {st6c.name}")
        err = check_objective(what, z6c, refs6c[what], 1e-6)
        it = m6c.barrier_iterations
        op = type(kkt.A).__name__ if hasattr(kkt, "A") else "none"
        log(f"[6c] {what} at the defaults: {want_be} ({kind}, full operator "
            f"{op}), OPTIMAL, objective {z6c!r} vs HiGHS {refs6c[what]!r} "
            f"(rel {err:.3e}); {describe(m6c, w6c)}")
        if sf:
            plan_s, dat_bytes, setup_s = sparse_first_symbolic_s(m6c, device)
            check(peak < dense_bytes, f"{what}: the solve's peak device "
                  f"memory {peak} B is not below the dense A's "
                  f"{dense_bytes} B")
            log(f"  sparse-first: SparseLPData {dat_bytes / 1e6:.3f} MB on "
                f"the card against {dense_bytes / 1e6:.3f} MB for a dense "
                f"f64 A; the solve's peak device memory "
                f"{peak / 1e6:.3f} MB above the {base / 1e6:.3f} MB held "
                f"before it (max_memory_allocated "
                f"{(peak + base) / 1e6:.3f} MB)")
            log(f"  host symbolic phase, timed again alone: COO -> tile plan "
                f"-> SparseLPData on the card {plan_s:.4f} s (inside "
                f"'standard_form'), backend setup {setup_s:.4f} s (inside "
                f"'ipm'); the IPM without its setup "
                f"{(m6c.timings['ipm'] - setup_s) / it * 1e3:.3f} ms per "
                f"iteration")
        else:
            probe_s, setup_s = host_symbolic_s(m6c, device)
            log(f"  dense data, probe -> sparse-smw: probe {probe_s:.4f} s "
                f"(outside the timings), backend setup {setup_s:.4f} s "
                f"(inside 'ipm'); the IPM without its setup "
                f"{(m6c.timings['ipm'] - setup_s) / it * 1e3:.3f} ms per "
                f"iteration; peak device memory {peak / 1e6:.3f} MB above "
                f"the {base / 1e6:.3f} MB held before")
    for what, (m6b, _, _, w6b, _, _, _) in structured.items():
        log(f"  beside phase 6b's {what}: {m6b.barrier_iterations} "
            f"iterations, wall {w6b:.4f} s, "
            f"{m6b.timings['ipm'] / m6b.barrier_iterations * 1e3:.3f} ms "
            f"per iteration")
    log(f"  launches {n6c}; {card}")
    if args.profile:
        m6c, _, _, w6c, _ = sparse_first["multiperiod_lp(8192)"]
        profile_solve(lambda: m6c.optimize(),
                      os.path.join(args.profile, "profile_sparse_first.txt"),
                      w6c)

    # -- 7. single-LP entry at defaults, counted ---------------------------
    want = {"lp_opt": (0, 1.5), "lp_inf": (1, None), "lp_ubd": (1, None),
            "lp_freevars": (0, 0.0)}
    small = staircase_lp(1024)
    ref_small = highs_staircase(*small)
    with count.phase() as n7:
        for name, (rc_want, z_want) in want.items():
            rc, zc, rows, _ = run_cli(os.path.join(ROOT, "tests", "data",
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

    # -- 7b. System="K2" through dense-ldl, counted -----------------------
    with count.phase() as n7b:
        mod_k2 = staircase_model(small, device, "float64")
        mod_k2.params.KKT.System = "K2"
        st_k2, z_k2, wall_k2 = solve_model(mod_k2)
        cli_k2 = {name: run_cli(os.path.join(ROOT, "tests", "data",
                                             f"{name}.mps"), device,
                                "--KKTBackend", "dense-ldl", "--Presolve", "0")
                  for name in want}
    check(mod_k2.kkt_backend.name == "dense-ldl", f"K2 routed to "
          f"{mod_k2.kkt_backend.name!r}, not 'dense-ldl'")
    check(st_k2.name == "OPTIMAL", f"multiperiod_lp(1024) K2: {st_k2.name}")
    err_k2 = check_objective("multiperiod_lp(1024) K2", z_k2, ref_small, 1e-6)
    log(f"[7b] multiperiod_lp(1024) f64 KKT_System='K2' (dense-ldl): "
        f"objective {z_k2!r} vs HiGHS (rel {err_k2:.3e}); "
        f"{describe(mod_k2, wall_k2)}; beside phase 7's 'dense' on the "
        f"same LP: {mod64.barrier_iterations} iterations, "
        f"{mod64.timings['ipm'] / mod64.barrier_iterations * 1e3:.3f} ms "
        f"per iteration; launches {n7b}")
    if args.profile:
        profile_solve(lambda: mod_k2.optimize(),
                      os.path.join(args.profile, "profile_k2.txt"), wall_k2)
    for name, (rc, zc, rows, status) in cli_k2.items():
        rc_want, z_want = want[name]
        check(rc == rc_want and status == K2_CLI_STATUS[name],
              f"cli --KKTBackend dense-ldl {name}: rc {rc}, {status}; the "
              f"JAX package gives rc {rc_want}, {K2_CLI_STATUS[name]}")
        if z_want is not None:
            check(zc is not None and abs(zc - z_want) <= 1e-6,
                  f"cli --KKTBackend dense-ldl {name}: objective {zc}, "
                  f"expected {z_want}")
        log(f"  cli --KKTBackend dense-ldl --Presolve 0 {name}.mps: rc {rc}, "
            f"{status}, objective {zc!r}, {rows} iteration-log rows")

    # -- 7c. K2 from m = 2048 and the probe's sparse-ldl, counted ---------
    from tulip_tpu_torch.ops import doubledouble as tdd

    lp7c = staircase_lp(2048, dense_cols=24, dense_scale=1.0)
    runs7c = [("multiperiod_lp(4096) K2", big, ref_big, "K2"),
              ("staircase_lp(2048, dense_cols=24, dense_scale=1.0)", lp7c,
               highs_staircase(*lp7c), None)]
    k2runs = {}
    with count.phase() as n7c:
        for what, lp, ref, system in runs7c:
            m7c = staircase_model(lp, device, "float64")
            m7c.params.KKT.System = system
            k2runs[what] = (m7c,) + solve_model(m7c)
    for what, lp, ref, system in runs7c:
        m7c, st7c, z7c, w7c = k2runs[what]
        kind = type(m7c.solver_state.kkt).__name__
        check(m7c.kkt_backend.name == "sparse-ldl", f"{what}: routed to "
              f"{m7c.kkt_backend.name!r}, not 'sparse-ldl'")
        check(kind == K2_STATE[what], f"{what}: set up a {kind}; the JAX "
              f"package sets up a {K2_STATE[what]}")
        check(st7c.name == "OPTIMAL", f"{what}: status {st7c.name}")
        err = check_objective(what, z7c, ref, 1e-7)
        _, setup_s = host_symbolic_s(m7c, device)
        it = m7c.barrier_iterations
        log(f"[7c] {what}: sparse-ldl ({kind}, {m7c.kkt_backend.schedule} "
            f"schedule, block {m7c.kkt_backend.block}), OPTIMAL, objective "
            f"{z7c!r} vs HiGHS {ref!r} (rel {err:.3e}); {describe(m7c, w7c)}")
        log(f"  host setup (K2 tile plan, constant tiles, copies to the "
            f"card), timed again alone: {setup_s:.4f} s (inside 'ipm'); the "
            f"IPM without it {(m7c.timings['ipm'] - setup_s) / it * 1e3:.3f} "
            f"ms per iteration")
    log(f"  launches {n7c}; {card}")
    if args.profile:
        m7c, _, _, w7c = k2runs["multiperiod_lp(4096) K2"]
        profile_solve(lambda: m7c.optimize(),
                      os.path.join(args.profile, "profile_sparse_ldl.txt"),
                      w7c)

    # -- 7d. the precision ladder, counted ---------------------------------
    bits_card = dd_results(tdd, lambda v: torch.as_tensor(v, device=device))
    bad = dd_mismatches(bits_card, dd_results(tdd, torch.as_tensor))
    check(not bad, f"dd primitives: the card's bits differ from the CPU's "
          f"in {bad}")
    log(f"[7d] dd primitives and reductions ({len(bits_card)}: "
        f"{', '.join(bits_card)}): the card's results equal the CPU's bit "
        f"for bit")
    tight = tight_lp()
    ref_tight = highs(tight[2], A_eq=tight[0].toarray(), b_eq=tight[1],
                      bounds=list(zip(np.zeros(40), tight[3]))).fun
    with count.phase() as n7d:
        m_ext = staircase_model(small, device, "float64")
        set_tolerances(m_ext, 1e-10)
        ext = solve_model(m_ext)
        m_mix = staircase_model(small, device, "float64", "dense-mixed")
        mix = solve_model(m_mix)
        m_dd = staircase_model(tight, device, "float64", "extended-dd")
        set_tolerances(m_dd, 1e-12)
        dd_run = solve_model(m_dd)
        cli_dd = {name: run_cli(os.path.join(ROOT, "tests", "data",
                                             f"{name}.mps"), device,
                                "--KKTBackend", "extended-dd")
                  for name in want}
    check(m_ext.kkt_backend.name == "extended", f"f64 at 1e-10 routed to "
          f"{m_ext.kkt_backend.name!r}, not 'extended'")
    check(ext[0].name == "OPTIMAL", f"extended at 1e-10: {ext[0].name}")
    err_ext = check_objective("multiperiod_lp(1024) at 1e-10", ext[1],
                              ref_small, 1e-7)
    gap = relative_gap(m_ext)
    check(gap <= 1e-10, f"extended at 1e-10: relative gap {gap:.3e}")
    log(f"  multiperiod_lp(1024) f64, tolerances 1e-10, no backend named: "
        f"extended ({m_ext.kkt_backend.refinement_steps} dd sweeps), "
        f"OPTIMAL, objective {ext[1]!r} vs HiGHS (rel {err_ext:.3e}), "
        f"relative gap {gap:.3e}; {describe(m_ext, ext[2])}")
    check(mix[0].name == MIXED_1024[0], f"dense-mixed on "
          f"multiperiod_lp(1024): {mix[0].name}; the JAX package gives "
          f"{MIXED_1024[0]}")
    err_mix = check_objective("multiperiod_lp(1024) dense-mixed", mix[1],
                              ref_small, 1e-6)
    log(f"  multiperiod_lp(1024) f64 KKT_Backend='dense-mixed': "
        f"{mix[0].name} as the JAX package's (which takes "
        f"{MIXED_1024[1]} iterations on the CPU), objective {mix[1]!r} vs "
        f"HiGHS (rel {err_mix:.3e}); {describe(m_mix, mix[2])}")
    check(dd_run[0].name == DD_TIGHT_STATUS,
          f"extended-dd at 1e-12: {dd_run[0].name}")
    err_dd = check_objective("20x40 LP, extended-dd at 1e-12", dd_run[1],
                             ref_tight, 1e-9)
    log(f"  20x40 LP of tests/test_doubledouble.py, extended-dd at 1e-12: "
        f"OPTIMAL, objective {dd_run[1]!r} vs HiGHS {ref_tight!r} (rel "
        f"{err_dd:.3e}), relative gap {relative_gap(m_dd):.3e}; "
        f"{describe(m_dd, dd_run[2])}")
    for name, (rc, zc, rows, status) in cli_dd.items():
        rc_want, z_want = want[name]
        check(rc == rc_want and status == DD_CLI_STATUS[name],
              f"cli --KKTBackend extended-dd {name}: rc {rc}, {status}; "
              f"the JAX package gives rc {rc_want}, {DD_CLI_STATUS[name]}")
        if z_want is not None:
            check(zc is not None and abs(zc - z_want) <= 1e-6,
                  f"cli --KKTBackend extended-dd {name}: objective {zc}, "
                  f"expected {z_want}")
        log(f"  cli --KKTBackend extended-dd {name}.mps: rc {rc}, {status}, "
            f"objective {zc!r}, {rows} iteration-log rows")
    log(f"  launches {n7d}; {card}")

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
    for name, (rc, zc, rows, _) in cli_m.items():
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
    t11 = time.perf_counter()
    krylov_run = phase_krylov(device, count, big, card, args.profile)
    phase_explicit_minv(device, count, (raws, dats, opts, refs_slice),
                        iters.mean(), small, ref_small)
    res = phase_matmul_precision(device, card)
    check(res["high"] <= 10 * res["highest"], f"'high' residual "
          f"{res['high']:.3e} over 10x 'highest''s {res['highest']:.3e}")
    log(f"  phase 11 took {time.perf_counter() - t11:.1f} s")
    schur_run = phase_distributed(device, count, card,
                                  (raws, dats, opts, refs_slice), iters,
                                  wall, args.profile)
    phase_device_program(device, count, card, (raws, dats, opts), fused,
                         warm_be, out_f, dats2, probs, big, small,
                         args.profile)
    phase_structured_device([
        ("14a_banded_f64", structured["multiperiod_lp(4096) f64 HSD"][0]),
        ("14b_banded_f32", structured["multiperiod_lp(4096) f32 HSD"][0]),
        ("14c_banded_mpc", structured["multiperiod_lp(4096) f64 MPC"][0]),
        ("14d_sparse_scattered",
         structured["scattered_coupling_lp(2048) f64 HSD"][0]),
        ("14e_sparse_first_8192", sparse_first["multiperiod_lp(8192)"][0]),
        ("14f_smw_first_8192",
         sparse_first["staircase_lp(8192, dense_cols=2)"][0]),
        ("14g_smw_4096", sparse_first["staircase_lp(4096, dense_cols=2)"][0]),
        ("14h_dense_ldl", mod_k2),
        ("14i_sparse_ldl_4096", k2runs["multiperiod_lp(4096) K2"][0]),
        ("14j_sparse_ldl_dense_cols",
         k2runs["staircase_lp(2048, dense_cols=24, dense_scale=1.0)"][0]),
        ("14k_extended", m_ext), ("14l_dense_mixed", m_mix),
        ("14m_extended_dd", m_dd)], count, card, args.profile)
    with count.phase() as n15:
        phase_krylov_device(krylov_run, schur_run, device, card,
                            args.profile)
    log(f"  phase 15 launches of our kernels {n15} (its routes run none)")
    del krylov_run, schur_run
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
