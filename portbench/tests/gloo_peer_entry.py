"""A stub entry whose requests span two processes, the shape of an entry
that drives several cards: ``prepare`` starts one peer (``python -m`` this
file) and both join a Gloo group of two CPU processes through
``tulip_tpu_torch.parallel.comm.init_comm`` and a ``FileStore`` in a
temporary directory. Each request sends the peer its pool index, and its
answer x is the sum over both ranks of their halves of HiGHS's solution
(even columns here, odd ones on the peer). ``release`` stops the peer.
With ``fail_at`` in the traffic mix, that request raises."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

SPANS = ()
TIMEOUT_S = 60.0
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _highs(item) -> tuple:
    from scipy.optimize import linprog

    A, b, c, u = (np.asarray(item[k], dtype=np.float64) for k in "Abcu")
    hs = [linprog(c[j], A_eq=A[j], b_eq=b[j], bounds=np.stack(
        [0 * u[j], u[j]], 1), method="highs") for j in range(len(c))]
    return (np.array([h.status == 0 for h in hs]),
            np.array([h.fun for h in hs]), np.stack([h.x for h in hs]))


def prepare(cfg, traffic, pool, device, control=None):
    from tulip_tpu_torch.parallel.comm import init_comm

    solved = [_highs(item) for item in pool]
    xs = [torch.as_tensor(x) for _, _, x in solved]
    odd = torch.arange(xs[0].shape[-1]) % 2 == 1
    tmp = tempfile.mkdtemp(prefix="portbench-peer-")
    torch.save([x * odd for x in xs], os.path.join(tmp, "peer.pt"))
    peer = subprocess.Popen([sys.executable, "-m",
                             "portbench.tests.gloo_peer_entry", tmp],
                            cwd=ROOT)
    prog = dict(peer=peer, tmp=tmp, mine=[x * ~odd for x in xs],
                solved=solved, fail_at=traffic.get("fail_at"))
    try:
        prog["comm"] = init_comm("gloo", 0, 2, os.path.join(tmp, "store"),
                                 TIMEOUT_S)
    except BaseException:
        release(prog)
        raise
    return prog


def request(prog, i):
    if i == prog["fail_at"]:
        raise RuntimeError(f"request {i} fails, as the traffic mix asks")
    k = i % len(prog["mine"])
    comm = prog["comm"]
    comm.all_reduce_sum(torch.tensor([1.0, k], dtype=torch.float64))
    x = comm.all_reduce_sum(prog["mine"][k])
    optimal, obj, _ = prog["solved"][k]
    answers = dict(optimal=optimal, obj=obj, x=x.numpy())
    return len(obj), answers, dict(iters=0)


def describe(prog) -> str:
    return f"a Gloo group with one peer process (pid {prog['peer'].pid})"


def release(prog) -> None:
    import torch.distributed as dist

    peer = prog["peer"]
    try:
        if "comm" in prog:
            prog["comm"].all_reduce_sum(torch.zeros(2, dtype=torch.float64))
    finally:
        try:
            code = peer.wait(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            peer.kill()
            code = peer.wait()
        print(f"peer {peer.pid} ended with exit code {code}",
              file=sys.stderr, flush=True)
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(prog["tmp"], ignore_errors=True)
        prog.clear()


def peer_main(tmp: str) -> int:
    """Rank 1: add its half of the asked item's x to each request's sum
    until rank 0 sends the index row [0, 0]."""
    import torch.distributed as dist

    from tulip_tpu_torch.parallel.comm import init_comm

    torch.set_num_threads(1)
    halves = torch.load(os.path.join(tmp, "peer.pt"))
    comm = init_comm("gloo", 1, 2, os.path.join(tmp, "store"), TIMEOUT_S)
    try:
        while True:
            go, k = comm.all_reduce_sum(
                torch.zeros(2, dtype=torch.float64)).tolist()
            if not go:
                return 0
            comm.all_reduce_sum(halves[int(k)])
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(peer_main(sys.argv[1]))
