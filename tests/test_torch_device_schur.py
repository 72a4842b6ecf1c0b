"""The device program (``ipm/graph.py``) on ``"schur"`` (``kkt/schur.py``)
in one process, and the parts of the program that a distributed pass
needs, on the CPU:

(a) the Schur solve of a block-angular LP (``Comm()``: every collective
    returns its input) through the device program, bit for bit with
    ``HostLoop=True``, under HSD and MPC and with a refinement sweep;
(b) the collectives' counts: one for every collective run in the pass,
    and a collective recorded while capturing credited once for every
    replay of the pass, as a kernel launch is;
(c) a host operation outside a capture (the CPU, a warm-up): its function
    of a host copy, back on the input's device.

Two Gloo processes through the device program are in
``tests/test_torch_distributed.py``."""

import collections

import numpy as np
import pytest
import torch
from test_torch_block_angular import two_stage

from test_torch_device_loop import assert_same_bits
from tulip_tpu_torch.ipm import graph
from tulip_tpu_torch.ipm.hsd import HSDOptions, hsd_solve
from tulip_tpu_torch.ipm.mpc import MPCOptions, mpc_solve
from tulip_tpu_torch.kkt import SchurK1Backend
from tulip_tpu_torch.parallel import make_block_angular
from tulip_tpu_torch.parallel.comm import Comm
from tulip_tpu_torch.status import TerminationStatus

torch.set_num_threads(1)

OPT = int(TerminationStatus.OPTIMAL)


@pytest.fixture(autouse=True)
def fresh_cache():
    graph.clear_device_programs()
    yield
    graph.clear_device_programs()


@pytest.mark.parametrize("algo,refine", [("HSD", 0), ("HSD", 1),
                                         ("MPC", 0)])
def test_schur_device_program_equals_host_loop(algo, refine):
    """K = 8 scenarios in one process: the program's final state equals
    the host loop's bit for bit; every collective of the pass is counted
    (the program's masked bumps and corrections make more of them than
    the host loop, one n0×n0 all-reduce to each factorization attempt in
    both)."""
    arrays = two_stage(np.random.default_rng(3), K=8)
    dat = make_block_angular(*arrays, device="cpu")
    be = SchurK1Backend(refinement_steps=refine)
    solve, Opts = ((hsd_solve, HSDOptions) if algo == "HSD"
                   else (mpc_solve, MPCOptions))
    dat.comm.reset()
    dev = solve(dat, be, Opts())
    last, dev_counts = dict(graph.LAST), dict(dat.comm.counts)
    dat.comm.reset()
    host = solve(dat, be, Opts(HostLoop=True))
    host_counts = dict(dat.comm.counts)
    assert last["built"] and last["passes"] == int(dev.niter[0]) + 1
    assert int(dev.status[0]) == OPT
    assert_same_bits(dev, host)
    assert last["loops"] == 0 and last["host_ops"] == 0
    n0 = dat.n0
    for counts in (dev_counts, host_counts):
        attempts = sum(c for (op, _), c in counts.items()
                       if op == "all_reduce_and")
        assert counts[("all_reduce_sum", n0 * n0)] == attempts > 0
    assert sum(dev_counts.values()) >= sum(host_counts.values())


def test_captured_collectives_count_once_a_replay():
    """A collective recorded while capturing (with its name, the op where
    the caller gives none) counts nothing then, and is credited once for
    every replay of its graph; a warm-up's counts nowhere."""
    comm = Comm()
    recorded = []
    graph._CTX.collectives = recorded
    try:
        comm.all_reduce_sum(torch.ones(3))
        comm.all_gather_blocks(torch.ones(2, 4), dim=1)
    finally:
        graph._CTX.collectives = None
    assert comm.counts == collections.Counter() and len(recorded) == 2
    with graph._device_mode(warmup=True):
        comm.all_reduce_and(torch.ones(5, dtype=torch.bool))
    assert comm.counts == collections.Counter() and comm.nbytes == 0
    assert [name for *_, name in recorded] == ["all_reduce_sum",
                                               "all_gather_blocks"]
    for c, key, nbytes, name in recorded:
        graph._credit_collective(c, key, nbytes, name, 7)
    comm.all_reduce_sum(torch.ones(3))
    assert comm.counts == {("all_reduce_sum", 3): 8,
                           ("all_gather_blocks", 8): 7}
    assert comm.nbytes == 8 * 3 * 4 + 7 * 8 * 4


def test_host_op_outside_a_capture():
    """Not capturing, a host operation is its function of a host copy,
    returned on the input's device, and counts once (a warm-up's does
    not)."""
    t = torch.arange(6.0).reshape(2, 3)
    n0 = graph.HOST_OPS
    out = graph.host_op(lambda x: x * 2, t, t.shape, t.dtype)
    assert torch.equal(out, t * 2) and out.device == t.device
    assert graph.HOST_OPS == n0 + 1
    with graph._device_mode(warmup=True):
        graph.host_op(lambda x: x + 1, t, t.shape, t.dtype)
    assert graph.HOST_OPS == n0 + 1


def test_schur_cache_keys_on_the_group():
    """Two Comm objects over the same data build two programs: a pass's
    collectives belong to its group."""
    arrays = two_stage(np.random.default_rng(4), K=4)
    a = make_block_angular(*arrays, device="cpu")
    b = a._replace(comm=Comm())
    n0 = graph.CAPTURES
    hsd_solve(a, SchurK1Backend(), HSDOptions())
    hsd_solve(b, SchurK1Backend(), HSDOptions())
    assert graph.CAPTURES == n0 + 2
    hsd_solve(a, SchurK1Backend(), HSDOptions())
    assert graph.CAPTURES == n0 + 2 and not graph.LAST["built"]
