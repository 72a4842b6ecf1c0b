"""Requests of ``ipm.hsd_solve`` through the Schur backend on a two-stage
LP sharded over its scenarios, one process a card.

``prepare`` starts ranks 1..R-1 (``python -m`` this file), each on card
r, and all R join one group through ``tulip_tpu_torch.parallel.init_comm``
and a ``FileStore`` in a temporary directory. Rank 0 is the harness's own
process: it holds the pool whole (for the check) and writes each item's
first stage and flat vectors for the peers; a peer makes only its own
scenarios' blocks of T and W from the generator's streams, and checks its
segments of the flat vectors against rank 0's.

Request k tells the peers the pool item (k mod pool). Every rank builds
its share on its card with ``parallel.make_block_angular_share`` and
solves it with ``ipm.hsd_solve(dat, SchurK1Backend(), HSDOptions())``;
rank 0 answers with the status, the objective and the whole x, which is
replicated. With ``control``, every rank solves in the control's dtype at
that dtype's default tolerances (sqrt of its epsilon), as ``Model`` does.

A peer that ends while the run needs it ends the run at once (exit code
70), its other peers killed; a peer that has not joined after ``JOIN_S``
seconds fails ``prepare``; a peer whose parent has gone ends itself.
``release`` sends the peers the stop, tears the group down with them
(collective under NCCL) and waits for them, or kills them where a
request was cut off inside a solve.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading

import numpy as np
import torch

SPANS = (("tulip_tpu_torch.parallel.block_angular",
          "make_block_angular_share", "share"),
         ("tulip_tpu_torch.ipm.hsd", "hsd_solve", "ipm"))
JOIN_S = 120.0
STOP_S = 60.0
WATCH_S = 0.5
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OPTIMAL = 2     # TerminationStatus.OPTIMAL
# The first stage and flat vectors of a pool item, as rank 0 writes them.
FLAT = ("A0", "b0", "c0x", "h", "cks", "l", "u")


def _log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def _opts(dtype: torch.dtype):
    """HSDOptions() in float64; in another dtype its defaults resolved as
    ``Model`` resolves them (sqrt of the dtype's epsilon)."""
    from tulip_tpu_torch.ipm.hsd import HSDOptions

    if dtype == torch.float64:
        return HSDOptions()
    se = float(np.sqrt(torch.finfo(dtype).eps))
    return HSDOptions(TolerancePFeas=se, ToleranceDFeas=se,
                      ToleranceRGap=se, ToleranceIFeas=se, PRegMin=se,
                      DRegMin=se)


def _solve(share: dict, comm, device, dtype):
    """This rank's share of one LP built on ``device`` and solved; the
    final HSD state."""
    from tulip_tpu_torch.ipm import hsd
    from tulip_tpu_torch.kkt import SchurK1Backend
    from tulip_tpu_torch.parallel import block_angular

    comm.reset()
    dat = block_angular.make_block_angular_share(
        *(share[k] for k in ("A0", "b0", "c0x", "T", "W", "h", "cks", "l",
                             "u")),
        comm=comm, device=device, dtype=dtype)
    return hsd.hsd_solve(dat, SchurK1Backend(), _opts(dtype))


def _kill(peers) -> None:
    for _, p in peers:
        if p.poll() is None:
            p.kill()
    for _, p in peers:
        p.wait()


def _watch(stop: threading.Event, peers: list) -> None:
    """Rank 0's watch over its peers: one that ends before ``release``
    sets ``stop`` ends the run."""
    while not stop.wait(WATCH_S):
        for r, p in peers:
            code = p.poll()
            if code is not None and not stop.is_set():
                _log(f"rank {r} (pid {p.pid}) ended with exit code {code} "
                     "while the run needed it; ending the run")
                _kill(peers)
                os._exit(70)


def prepare(cfg, traffic, pool, device, control=None):
    from tulip_tpu_torch.parallel import init_comm
    # The share builder: without it no rank can run, and none is started.
    from tulip_tpu_torch.parallel.block_angular import (  # noqa: F401
        make_block_angular_share)

    ranks, backend = traffic["ranks"], traffic["backend"]
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() < ranks:
        raise RuntimeError(f"{ranks} ranks take a card each: {ranks} cards")
    if backend == "nccl" and device.type != "cuda":
        raise RuntimeError("NCCL moves CUDA tensors: run on the cards")
    dtype = getattr(torch, (control or {}).get("dtype", cfg["dtype"]))
    tmp = tempfile.mkdtemp(prefix="portbench-schur-")
    for i, item in enumerate(pool):
        np.savez(os.path.join(tmp, f"flat{i}.npz"),
                 **{k: item[k] for k in FLAT})
    with open(os.path.join(tmp, "job.json"), "w") as f:
        json.dump(dict(cfg=cfg, seed=pool[0]["seed"], pool=len(pool),
                       ranks=ranks, backend=backend, device=device.type,
                       dtype=str(dtype).split(".")[-1],
                       parent=os.getpid()), f)
    Kl = len(pool[0]["h"]) // ranks
    prog = dict(pool=pool, device=device, dtype=dtype, ranks=ranks,
                backend=backend, tmp=tmp, peers=[], busy=False,
                stop=threading.Event(),
                mine=[dict(item, T=item["T"][:Kl], W=item["W"][:Kl])
                      for item in pool])
    try:
        for r in range(1, ranks):
            prog["peers"].append((r, subprocess.Popen(
                [sys.executable, "-m", "portbench.entries.schur_nccl", tmp,
                 str(r)], cwd=ROOT, stdout=2)))
        threading.Thread(target=_watch, args=(prog["stop"], prog["peers"]),
                         daemon=True).start()
        prog["comm"] = init_comm(backend, 0, ranks,
                                 os.path.join(tmp, "store"), JOIN_S)
    except BaseException:
        release(prog)
        raise
    return prog


def request(prog, i):
    k = i % len(prog["pool"])
    comm, dev = prog["comm"], prog["device"]
    prog["busy"] = True
    comm.all_reduce_sum(torch.tensor([1.0, k], dtype=torch.float64,
                                     device=dev))
    out = _solve(prog["mine"][k], comm, dev, prog["dtype"])
    x = (out.pt.x / out.pt.tau[:, None]).double().cpu().numpy()
    answers = dict(optimal=np.array([int(out.status[0]) == OPTIMAL]),
                   obj=np.array([float(out.pobj[0])]), x=x)
    prog["busy"] = False
    return 1, answers, dict(iters=int(out.niter[0]))


def describe(prog) -> str:
    comm = prog["comm"]
    n0 = prog["pool"][0]["A0"].shape[1]
    K = len(prog["pool"][0]["h"])
    counts = comm.counts
    schur = counts.get(("all_reduce_sum", n0 * n0), 0)
    attempts = sum(c for (op, _), c in counts.items()
                   if op == "all_reduce_and")
    op, numel = max(counts, key=lambda key: key[1])
    where = ("one card a rank" if prog["device"].type == "cuda"
             else "CPU processes")
    return (f"ipm.hsd_solve through 'schur', K = {K} over {prog['ranks']} "
            f"ranks ({prog['backend']}, {where}, {K // prog['ranks']} "
            f"scenarios each, "
            f"{str(prog['dtype']).split('.')[-1]}); rank 0's last solve: "
            f"{schur} n0×n0 all-reduces for {attempts} factorization "
            f"attempts, {sum(counts.values())} collectives, "
            f"{comm.nbytes} bytes, largest {op} of {numel} elements")


def release(prog) -> None:
    import torch.distributed as dist

    from tulip_tpu_torch.ipm.graph import clear_device_programs

    prog["stop"].set()
    peers = prog["peers"]
    clean = ("comm" in prog and not prog["busy"]
             and all(p.poll() is None for _, p in peers))
    try:
        if clean:
            prog["comm"].all_reduce_sum(torch.zeros(
                2, dtype=torch.float64, device=prog["device"]))
            # NCCL's teardown is collective: every rank drops its graphs
            # (which hold the group's collectives) and destroys the group
            # at once, rank 0 before it waits for the others.
            clear_device_programs()
            done = threading.Thread(target=dist.destroy_process_group,
                                    daemon=True)
            done.start()
            done.join(STOP_S)
            if done.is_alive():
                _log(f"the group's teardown outlived {STOP_S} s")
                clean = False
    finally:
        if not clean:
            _kill(peers)
        for r, p in peers:
            try:
                code = p.wait(timeout=STOP_S)
            except subprocess.TimeoutExpired:
                p.kill()
                code = p.wait()
            _log(f"rank {r} (pid {p.pid}) ended with exit code {code}")
        shutil.rmtree(prog["tmp"], ignore_errors=True)
        clear_device_programs()
        prog.clear()


def _watch_parent(parent: int) -> None:
    """End this process when its parent has gone."""
    def watch():
        while os.getppid() == parent:
            threading.Event().wait(WATCH_S)
        os._exit(1)

    threading.Thread(target=watch, daemon=True).start()


def peer_main(tmp: str, rank: int) -> int:
    """Rank ``rank``: make this rank's share of every pool item, join the
    group, then solve the item each request names until rank 0 sends the
    stop (a zero)."""
    import torch.distributed as dist

    from tulip_tpu_torch.ipm.graph import clear_device_programs
    from tulip_tpu_torch.parallel import init_comm
    from tulip_tpu_torch.parallel.block_angular import (  # noqa: F401
        make_block_angular_share)

    from portbench.generators import two_stage

    with open(os.path.join(tmp, "job.json")) as f:
        job = json.load(f)
    _watch_parent(job["parent"])
    if job["device"] == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    cfg, ranks = job["cfg"], job["ranks"]
    K = cfg["scenarios"]
    lo, hi = rank * K // ranks, (rank + 1) * K // ranks
    shares = []
    for i in range(job["pool"]):
        with np.load(os.path.join(tmp, f"flat{i}.npz")) as z:
            flat = {k: z[k] for k in FLAT}
        n0 = flat["A0"].shape[1]
        T, W, h, cks, uk = two_stage.scenarios(cfg, job["seed"], i, lo, hi,
                                               flat["u"][:n0] * 0.5)
        nk = cks.shape[1]
        if not (np.array_equal(h, flat["h"][lo:hi])
                and np.array_equal(cks, flat["cks"][lo:hi])
                and np.array_equal(uk.reshape(-1),
                                   flat["u"][n0 + lo * nk:n0 + hi * nk])):
            raise RuntimeError(f"rank {rank}: its scenarios of item {i} "
                               "differ from rank 0's")
        shares.append(dict(flat, T=T, W=W))
    dtype = getattr(torch, job["dtype"])
    comm = init_comm(job["backend"], rank, ranks, os.path.join(tmp, "store"),
                     JOIN_S)
    while True:
        go, k = comm.all_reduce_sum(torch.zeros(
            2, dtype=torch.float64, device=device)).tolist()
        if not go:
            break
        _solve(shares[int(k)], comm, device, dtype)
    # The stop: the group's teardown, with every other rank (collective
    # under NCCL). A rank that raises instead ends without it, and rank 0
    # ends the run.
    clear_device_programs()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(peer_main(sys.argv[1], int(sys.argv[2])))
