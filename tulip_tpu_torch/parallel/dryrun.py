"""Multi-process dry run of the distributed paths, on ``torch.distributed``.

Counterpart of ``__graft_entry__.py:dryrun_multichip`` and its
``_dist_worker``. :func:`launch` spawns one process per rank (start
method ``spawn``); each joins one process group through a ``FileStore``
in a temporary directory (no port is opened), runs a job and sends its
result back. Every job has a wall limit: when it passes, or when a rank
raises, every process is killed and the launch raises. :func:`dryrun`
runs the reference's regimes through it and holds each objective to the
dense single-process solve at the reference's bars:

1. data-parallel: ``shard_batch`` of 2·nprocs LPs, ``gather_lanes``;
2. model-parallel: the Schur backend with the scenarios sharded;
2b. real volume: blocks (m0, n0, mk, nk) = (8, 128, 128, 256) in f64 at
   the default tolerances, held to the collective signature (the largest
   collective at most n0² elements, one n0×n0 all-reduce per
   factorization attempt);
3. uneven K: K not a multiple of nprocs, padded;
4. 2-D: a batch × scenario grid of sub-groups, when nprocs ≥ 4 and even.

The reference's regime 5 (two processes) is what every regime is here.
The ranks run on the card unless the caller asks for the CPU: with NCCL
each rank takes its own card, with Gloo they share card 0 (collectives
staged through host memory, :mod:`.comm`); ``device="cpu"`` (``--device
cpu``) runs them as CPU processes over Gloo::

    python -m tulip_tpu_torch.parallel.dryrun --procs N --backend nccl

Every solve of a job runs as the device program (``ipm/graph.py``), as
``hsd_solve`` routes it: under NCCL each pass is captured whole, under
Gloo the pass's collectives are host operations between its captured
segments (on the CPU the pass runs step by step). ``case_schur(...,
host_loop=True)`` runs the host-driven loop instead. The workers import
this package and never JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import multiprocessing
import os
import pickle
import queue
import sys
import tempfile
import time
import traceback
from typing import Callable, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..ipm import graph
from ..ipm.batch import (batched_hsd_solve, gather_lanes, shard_batch,
                         stack_lps_host)
from ..ipm.hsd import HSDOptions, hsd_solve
from ..kkt import DenseK1Backend, SchurK1Backend, make_backend
from ..ops import chol
from .block_angular import (block_angular_to_dense, make_block_angular,
                            pad_scenarios, shard_scenarios)
from .comm import Comm, init_comm

OPTIMAL = 2  # TerminationStatus.OPTIMAL
# The reference's dry-run tolerance (with an f32-grade regularization
# floor, :func:`_opts`).
LOOSE = 1e-4
VOLUME_DIMS = (8, 128, 128, 256)
# Fields of the Schur backend's state that hold this rank's scenarios; the
# rest of a final state is the same on every rank.
SCENARIO_FIELDS = ("T", "W", "dk", "regDk", "Lk")


# ---------------------------------------------------------------------------
# Data (numpy, from a seed; the reference's recipes)
# ---------------------------------------------------------------------------

def batch_problems(nb: int, m: int, n: int, seed: int = 0) -> list:
    """``nb`` random feasible LPs (A, b, c, c0, l, u): the recipe of
    ``__graft_entry__.py:_make_batch`` and ``bench.py``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(nb):
        A = rng.standard_normal((m, n))
        u = rng.uniform(1.0, 4.0, n)
        x0 = u * rng.uniform(0.2, 0.8, n)
        out.append((A, A @ x0, rng.standard_normal(n), 0.0, np.zeros(n), u))
    return out


def two_stage_arrays(K: int, seed: int, dims=(3, 6, 4, 8)) -> tuple:
    """The arguments of ``make_block_angular`` for a feasible, bounded
    two-stage LP with K scenarios: ``__graft_entry__.py:_make_block_angular``'s
    recipe."""
    rng = np.random.default_rng(seed)
    m0, n0, mk, nk = dims
    A0 = rng.standard_normal((m0, n0))
    T = rng.standard_normal((K, mk, n0))
    W = rng.standard_normal((K, mk, nk))
    u0 = rng.uniform(1, 3, n0)
    uk = rng.uniform(1, 3, (K, nk))
    x0 = u0 * 0.5
    xs = uk * 0.5
    return (A0, A0 @ x0, rng.standard_normal(n0), T, W,
            np.einsum("kij,j->ki", T, x0) + np.einsum("kij,kj->ki", W, xs),
            rng.standard_normal((K, nk)),
            np.zeros(n0 + K * nk), np.concatenate([u0, uk.reshape(-1)]))


# ---------------------------------------------------------------------------
# Cases: what a rank runs (results are numpy and Python values)
# ---------------------------------------------------------------------------

def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "float64": torch.float64}[name]


def _opts(tol):
    """The defaults (``tol=None``), or every tolerance at ``tol`` with the
    regularization floor at 1e-6, as the reference's dry run and
    ``bench.py`` set them."""
    if tol is None:
        return HSDOptions()
    return HSDOptions(TolerancePFeas=tol, ToleranceDFeas=tol,
                      ToleranceRGap=tol, ToleranceIFeas=tol,
                      PRegMin=1e-6, DRegMin=1e-6)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _dense_pobj(arrays, device, dtype, tol) -> float:
    """The dense single-process solve of the LP of ``arrays``."""
    dat = make_block_angular(*arrays, device=device, dtype=_dtype(dtype))
    return float(hsd_solve(block_angular_to_dense(dat), DenseK1Backend(),
                           _opts(tol)).pobj)


def replicated_state(state) -> dict:
    """The parts of a final HSD state that every rank holds whole, as
    numpy arrays keyed by their path (``kkt.Ls``)."""
    out = {}
    for f, v in zip(state._fields, state):
        if f == "kkt":
            for g, w in zip(v._fields, v):
                if torch.is_tensor(w) and g not in SCENARIO_FIELDS:
                    out[f"kkt.{g}"] = w.cpu().numpy()
        elif isinstance(v, tuple):
            for g, w in zip(v._fields, v):
                out[f"{f}.{g}"] = w.cpu().numpy()
        else:
            out[f] = v.cpu().numpy()
    return out


def case_schur(comm, device, arrays, dtype="float64", tol=None,
               pad_to=None, refinement_steps=0, dense=False,
               state=False, host_loop=False) -> dict:
    """The HSD solve of one block-angular LP through ``"schur"`` with its
    scenarios (padded to ``pad_to`` first) sharded over ``comm``: as the
    device program (``ipm/graph.py``; under Gloo its collectives are host
    operations of the pass's script), or with ``host_loop`` on the
    host-driven loop. With ``dense``, rank 0 adds the dense single-process
    solve's objective of the unpadded LP; with ``state``, the replicated
    final state. ``graph`` holds the program's figures (empty on the host
    loop)."""

    dat = make_block_angular(*arrays, device=device, dtype=_dtype(dtype))
    if pad_to is not None:
        dat = pad_scenarios(dat, pad_to)
    dat = shard_scenarios(dat, comm)
    comm.reset()
    _sync(device)
    t0 = time.perf_counter()
    graph.LAST.clear()
    out = hsd_solve(dat, SchurK1Backend(refinement_steps=refinement_steps),
                    dataclasses.replace(_opts(tol), HostLoop=host_loop))
    _sync(device)
    res = dict(status=int(out.status), niter=int(out.niter),
               pobj=float(out.pobj), wall=time.perf_counter() - t0,
               counts=dict(comm.counts), nbytes=comm.nbytes,
               n0=dat.n0, K=dat.K, graph=dict(graph.LAST))
    if state:
        res["state"] = replicated_state(out)
    if dense and comm.rank == 0:
        res["dense_pobj"] = _dense_pobj(arrays, device, dtype, tol)
    return res


def case_shard_error(comm, device, arrays) -> dict:
    """The message of ``shard_scenarios``'s refusal of a K that the group
    does not divide (empty if it did not refuse)."""
    dat = make_block_angular(*arrays, device=device)
    try:
        shard_scenarios(dat, comm)
    except ValueError as e:
        return dict(error=str(e))
    return dict(error="")


def case_batch(comm, device, nb, m, n, seed=0, dtype="float32", tol=LOOSE,
               backend="dense", refinement_steps=0, reps=1) -> dict:
    """``shard_batch`` of ``batch_problems(nb, m, n, seed)`` over
    ``comm``, the batched HSD solve of this rank's lanes through the named
    backend (``reps`` times; the last is timed and counted), then
    ``gather_lanes``; with rank 0's single-LP solve of lane 0, and the
    chol-inv kernel's launches on this rank."""
    probs = batch_problems(nb, m, n, seed)
    dats = stack_lps_host(probs, device=device, dtype=_dtype(dtype))
    be = make_backend(backend, refinement_steps=refinement_steps)
    opts = _opts(tol)
    mine = shard_batch(dats, comm)
    for _ in range(reps - 1):
        batched_hsd_solve(be, opts, mine)
    chol.KERNEL_LAUNCHES = 0
    chol.SHAPES.clear()
    _sync(device)
    t0 = time.perf_counter()
    out = batched_hsd_solve(be, opts, mine)
    _sync(device)
    wall = time.perf_counter() - t0
    launches = chol.KERNEL_LAUNCHES
    full = gather_lanes(out, comm)
    res = dict(status=full.status.cpu().numpy(),
               niter=full.niter.cpu().numpy(), pobj=full.pobj.cpu().numpy(),
               lanes=int(mine.b.shape[0]), wall=wall,
               chol_launches=launches, chol_shapes=sorted(chol.SHAPES))
    if comm.rank == 0:
        one = type(dats)(*(x[:1] for x in dats))
        res["lane0_pobj"] = float(hsd_solve(one, be, opts).pobj)
    return res


def case_grid(comm, device, seeds=(10, 11), tol=LOOSE) -> dict:
    """Two block-angular LPs of size/2 scenarios each on a 2 × (size/2)
    grid: the batch split over the grid's columns (``shard_batch``), the
    scenarios over its rows (``shard_scenarios``), then ``gather_lanes``;
    rank 0 adds the dense solves' objectives."""
    half = comm.size // 2
    # Every process makes every group, in one order.
    rows = [dist.new_group([i * half + j for j in range(half)])
            for i in range(2)]
    cols = [dist.new_group([i * half + j for i in range(2)])
            for j in range(half)]
    i, j = divmod(comm.rank, half)
    scen, batch = Comm(rows[i]), Comm(cols[j])
    arrays = [two_stage_arrays(half, s) for s in seeds]
    lps = [make_block_angular(*a, device=device, dtype=torch.float32)
           for a in arrays]
    stacked = type(lps[0])(*(torch.cat(xs) if torch.is_tensor(xs[0])
                             else xs[0] for xs in zip(*lps)))
    mine = shard_scenarios(shard_batch(stacked, batch), scen)
    out = gather_lanes(batched_hsd_solve(SchurK1Backend(), _opts(tol),
                                         mine), batch)
    res = dict(status=out.status.cpu().numpy(), pobj=out.pobj.cpu().numpy(),
               grid=(i, j))
    if comm.rank == 0:
        res["dense_pobj"] = [_dense_pobj(a, device, "float32", tol)
                             for a in arrays]
    return res


def case_fail(comm, device, rank=1) -> dict:
    """A failure drill: rank ``rank`` raises while the others wait in a
    collective that it never joins; :func:`launch` must fail the job and
    stop every process."""
    if comm.rank == rank:
        raise RuntimeError(f"rank {rank} fails on purpose")
    comm.all_reduce_sum(torch.ones(1, device=device))
    return {}


CASES = {"schur": case_schur, "shard_error": case_shard_error,
         "batch": case_batch, "grid": case_grid, "fail": case_fail}


def run_cases(comm, device, cases: Sequence) -> dict:
    """The job of :func:`launch` that runs ``cases``, a sequence of
    ``(label, case name in CASES, keyword arguments)``, in order; the
    result maps each label to its case's result, and ``"modules"`` to the
    JAX modules this process imported (none)."""
    out = {label: CASES[name](comm, device, **kw)
           for label, name, kw in cases}
    out["modules"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib",
                                                   "tulip_tpu"))
    return out


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def _entry(rank, nprocs, backend, device, tmp, timeout_s, q):
    """One rank: join the group, run the job that :func:`launch` left in
    ``tmp``, send ``(rank, True, result)`` or ``(rank, False,
    traceback)``."""
    try:
        with open(os.path.join(tmp, "job.pkl"), "rb") as f:
            job, args = pickle.load(f)
        torch.set_num_threads(1)
        if device == "cuda":
            dev = torch.device("cuda", rank if backend == "nccl" else 0)
            torch.cuda.set_device(dev)
        else:
            dev = torch.device(device)
        comm = init_comm(backend, rank, nprocs, os.path.join(tmp, "store"),
                         timeout_s)
        q.put((rank, True, job(comm, dev, *args)))
    except BaseException:  # reported to the launcher, which fails the job
        q.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(job: Callable, nprocs: int, *, backend: str = "gloo",
           device: str = "cuda", timeout_s: float = 120.0,
           args: tuple = ()) -> List:
    """Run ``job(comm, device, *args)`` (an importable top-level function)
    in ``nprocs`` spawned processes of one group; the results in rank
    order. A rank that raises, dies, or a job that outlives ``timeout_s``
    kills every process and raises ``RuntimeError``.

    The job and its arguments travel in a file, not in the spawn pipe: a
    child that dies while it starts leaves a parent blocked in
    ``Process.start`` on a payload larger than the pipe's buffer."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "ranks as CPU processes")
    if backend == "nccl" and (device != "cuda" or
                              nprocs > torch.cuda.device_count()):
        raise ValueError("NCCL takes one card a rank: device='cuda' and "
                         f"nprocs <= {torch.cuda.device_count()} cards")
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "job.pkl"), "wb") as f:
            pickle.dump((job, args), f)
        procs = [ctx.Process(target=_entry, daemon=True, args=(
            r, nprocs, backend, device, tmp, timeout_s, q))
            for r in range(nprocs)]
        deadline = time.monotonic() + timeout_s
        try:
            for p in procs:
                p.start()
            while len(results) < nprocs:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise RuntimeError(
                        f"job {job.__name__} outlived its limit of "
                        f"{timeout_s} s; ranks {sorted(results)} reported")
                try:
                    rank, ok, payload = q.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in results and p.exitcode is not None]
                    if dead:
                        # A rank's last message may still be in the pipe.
                        try:
                            rank, ok, payload = q.get(timeout=5.0)
                        except queue.Empty:
                            raise RuntimeError(
                                f"rank {dead[0]} died with exit code "
                                f"{procs[dead[0]].exitcode} and no result")
                    else:
                        continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{payload}")
                results[rank] = payload
            for p in procs:
                p.join(max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.pid is None:
                    continue
                if p.is_alive():
                    p.kill()
                p.join(10)
            q.close()
    return [results[r] for r in range(nprocs)]


# ---------------------------------------------------------------------------
# The reference's regimes
# ---------------------------------------------------------------------------

def regime_cases(nprocs: int, volume_K: int = None) -> list:
    """The cases of the reference's dry run on ``nprocs`` ranks
    (``__graft_entry__.py:175-352``)."""
    K3 = nprocs + max(1, nprocs // 2)
    cases = [
        ("dp", "batch", dict(nb=2 * nprocs, m=8, n=16)),
        ("mp", "schur", dict(arrays=two_stage_arrays(2 * nprocs, 1),
                             dtype="float32", tol=LOOSE, dense=True)),
        ("volume", "schur", dict(
            arrays=two_stage_arrays(volume_K or nprocs, 11, VOLUME_DIMS),
            dense=True)),
        ("uneven", "schur", dict(arrays=two_stage_arrays(K3, 2),
                                 dtype="float32", tol=LOOSE,
                                 pad_to=-(-K3 // nprocs) * nprocs,
                                 dense=True)),
    ]
    if nprocs >= 4 and nprocs % 2 == 0:
        cases.append(("grid", "grid", {}))
    return cases


def collective_signature(res: dict) -> tuple:
    """(largest collective's elements, n0×n0 all-reduces, factorization
    attempts) of a ``case_schur`` result."""
    n0 = res["n0"]
    counts = res["counts"]
    largest = max(numel for _, numel in counts)
    schur = counts.get(("all_reduce_sum", n0 * n0), 0)
    attempts = sum(c for (op, _), c in counts.items()
                   if op == "all_reduce_and")
    return largest, schur, attempts


def _near(a: float, b: float, rtol: float) -> bool:
    return abs(a - b) <= rtol * max(1.0, abs(b))


def check_regimes(results: list, log=print) -> None:
    """Hold each regime of :func:`regime_cases` to the reference's bars;
    raise ``RuntimeError`` at the first that fails."""
    def need(ok, what):
        if not ok:
            raise RuntimeError(f"dry run: {what}")

    nprocs = len(results)
    r0 = results[0]
    need(all(not r["modules"] for r in results),
         f"a worker imported {[r['modules'] for r in results]}")
    dp = r0["dp"]
    need((dp["status"] == OPTIMAL).all(), f"dp statuses {dp['status']}")
    need(_near(float(dp["pobj"][0]), dp["lane0_pobj"], 1e-3),
         f"dp lane 0 pobj {dp['pobj'][0]} vs {dp['lane0_pobj']}")
    log(f"dry run ({nprocs} processes): dp OK, {len(dp['status'])} LPs over "
        f"{nprocs} ranks, lanes {[r['dp']['lanes'] for r in results]}")
    for label, rtol in (("mp", 1e-3), ("volume", 1e-7), ("uneven", 1e-3)):
        for r in results:
            need(r[label]["status"] == OPTIMAL,
                 f"{label}: status {r[label]['status']}")
            need(_near(r[label]["pobj"], r0[label]["dense_pobj"], rtol),
                 f"{label}: pobj {r[label]['pobj']} vs dense "
                 f"{r0[label]['dense_pobj']}")
        largest, schur, attempts = collective_signature(r0[label])
        n0 = r0[label]["n0"]
        # The reference pins the signature at real volume only: at n0 = 6
        # the scenario gathers outgrow n0².
        need(schur == attempts and (label != "volume"
                                    or largest <= n0 * n0),
             f"{label}: largest collective {largest} (n0² = {n0 * n0}), "
             f"{schur} n0×n0 all-reduces for {attempts} factorizations")
        log(f"dry run ({nprocs} processes): {label} OK, K = "
            f"{r0[label]['K']}, {r0[label]['niter']} iterations, pobj "
            f"{r0[label]['pobj']!r} vs dense {r0[label]['dense_pobj']!r}; "
            f"{sum(r0[label]['counts'].values())} collectives, largest "
            f"{largest} elements, {schur} n0×n0 all-reduces for {attempts} "
            f"factorizations")
    if "grid" in r0:
        for r in results:
            need((r["grid"]["status"] == OPTIMAL).all(),
                 f"grid statuses {r['grid']['status']}")
            for got, want in zip(r["grid"]["pobj"], r0["grid"]["dense_pobj"]):
                need(_near(float(got), want, 1e-3),
                     f"grid pobj {got} vs dense {want}")
        log(f"dry run ({nprocs} processes): 2-D grid OK, 2 LPs x "
            f"{nprocs // 2} scenario ranks")


def dryrun(nprocs: int, backend: str = "gloo", device: str = "cuda",
           timeout_s: float = 600.0) -> list:
    """The reference's regimes on ``nprocs`` processes, held to its bars;
    the per-rank results."""
    results = launch(run_cases, nprocs, backend=backend, device=device,
                     timeout_s=timeout_s, args=(regime_cases(nprocs),))
    check_regimes(results)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                    help="cuda: a card a rank under NCCL, card 0 shared "
                         "under Gloo; cpu: CPU processes (Gloo)")
    ap.add_argument("--timeout", type=float, default=600.0)
    a = ap.parse_args(argv)
    dryrun(a.procs, a.backend, a.device, a.timeout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
