"""The device program: a whole IPM solve as replays of one captured pass.

Counterpart of the JAX package's ``hsd_solve_device`` / ``mpc_solve_device``
(``tulip_tpu/ipm/hsd.py:564``, ``tulip_tpu/ipm/mpc.py:435``) and of the
vmapped ``lax.while_loop`` behind ``tulip_tpu/ipm/batch.py:134-195``. There
the whole solve is one XLA program: an outer while-loop over passes and,
inside a pass, the bounded while-loops of the regularization bumps
(``hsd.py:321-339``) and of the centrality corrections (``hsd.py:385-400``),
and the Krylov solvers' own while-loops (``tulip_tpu/kkt/krylov.py:104,
135``). Under vmap every one of them runs its body for every lane while any
lane needs it, and a lane whose condition is false keeps its carry.

The card's torch (2.11) has no CUDA-graph conditional nodes, so nothing in
a graph can branch on the device. Here:

- :func:`bounded_while` runs a per-lane loop with a small bound. The
  host-driven loop tests on the host before each trip and stops at the
  first trip that no lane needs (one sync a trip). In the device program it
  runs the loop's bound of trips, every one masked per lane: a trip that no
  lane needs leaves every lane's carry as it was, so the result is the same
  bit for bit, at the cost of the trips' work (3 factorizations a pass for
  the bumps, ``CorrectionLimit`` solves for the corrections);
- :func:`loop` runs a loop whose bound is too large to run out (a Krylov
  solve: up to ``maxiter_factor``·m trips) in chunks of trips, with one
  host read of its stopping mask before each chunk: the reads of the
  host-driven loop, which tests every ``every`` trips, so the trips run and
  the bits are its own;
- :func:`host_op` runs an operation that must run on the host (a Gloo
  collective of CUDA tensors, staged through host memory);
- :func:`run` captures one pass (one IPM iteration, masked to the lanes
  still running, written into static buffers) once per key, and replays
  it, reading between every :data:`K_PASSES` replays whether any lane is
  still running, through a pinned buffer and an event. A pass replayed
  after every lane has finished changes nothing: a finished lane keeps its
  state.

A captured pass is a *script*, replayed item by item in order: a captured
segment (a CUDA graph), a loop (its first, steady and tail chunks, each a
CUDA graph of up to ``every`` trips, replayed with a host read before each
chunk), or a host operation. The pass's Python runs once, under capture;
at a loop or a host operation the recorder ends the current graph, adds the
item and begins the next graph in the same memory pool. Every graph of a
pass is captured in the order it replays first, and what a later graph
reads lives at an address that stays: a loop's carry and mask are static
tensors that every chunk writes in place, a host operation writes a static
output, and the script holds them. A pass with neither is one graph.

On the CPU there is no graph: the same pass runs step by step over the same
static buffers, its loops in the same chunks with the same host reads, its
host operations eagerly. That is the plain version of the program.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import OrderedDict
from typing import Any, Callable, List, Tuple

import torch

from .. import trace

# Passes replayed between two reads of whether any lane is still running.
# Without conditional nodes a replay after the last lane finished is a whole
# pass of work (1-50 ms on the card), while a read costs one sync and the
# relaunch behind it (tens of microseconds), so reading after every pass
# loses the least.
K_PASSES = 1
# Device programs kept, least recently used out first, while there are more
# than CACHE_SIZE or they hold more than CACHE_SHARE of the device's memory
# together (:attr:`Program.nbytes`: static copies of a solve's data and
# state, and the graphs' memory pool). Eight covers a bench's repeats of a
# few shapes. A program holds several times its LP's data (the pool keeps
# the pass's intermediates), so a few large LPs would fill the card; the
# share leaves the rest to the solves. The program of the solve that just
# ran is kept whatever its size, so its warm replays stay.
CACHE_SIZE = 8
CACHE_SHARE = 0.25

# Programs built (captures on the card, static buffers on the CPU) since
# the process started.
CAPTURES = 0
# Launches of the port's kernels in the warm-up passes before captures
# (eager, on the static buffers, which are loaded again after); they count
# in no kernel's KERNEL_LAUNCHES.
WARMUP_LAUNCHES = 0
# Since the process started, on the host-driven loop and in device programs
# alike (warm-ups and captures excluded): loops run (one a Krylov solve),
# their trips, the host reads of their stopping masks, the chunk graphs
# replayed, and host operations run.
LOOPS = 0
LOOP_TRIPS = 0
LOOP_READS = 0
CHUNK_REPLAYS = 0
HOST_OPS = 0
# None, or a list to which each loop counted above appends its (trips,
# host reads), in the order the loops ran.
LOOP_LOG = None
# The last solve through a device program: passes replayed, host reads of
# the pass's end (``syncs``) and of its loops, whether the program was built
# for it, the seconds of its warm-up pass, of its capture and of its
# instantiation (0 when it came from the cache), the seconds of the replays
# and reads; the script a pass (segments, loops, chunk graphs, host
# operations; None on the CPU, where loops and host operations are counted
# as they run), the nodes of the segments summed over a pass and of the
# chunk graphs (all launches and copies; None on the CPU) and the launches
# of the port's kernels in the segments, by kernel; the loops, chunk
# replays, trips and host operations of the solve.
LAST: dict = {}

_CACHE: "OrderedDict[Any, Program]" = OrderedDict()


class _Ctx:
    # "host": the host-driven loop; "device": the device program's pass
    # (captured, its warm-up, or step by step on the CPU).
    mode = "host"
    warmup = False
    # Launches recorded while capturing: (module, shape, counter increments).
    captured: list = None
    # Collectives recorded while capturing: (Comm, (op, numel), bytes).
    collectives: list = None
    # The recorder of the pass being captured.
    recorder: "_Recorder" = None


_CTX = _Ctx()


@contextlib.contextmanager
def _device_mode(warmup: bool = False, captured: list = None,
                 recorder: "_Recorder" = None):
    saved = (_CTX.mode, _CTX.warmup, _CTX.captured, _CTX.collectives,
             _CTX.recorder)
    _CTX.mode, _CTX.warmup, _CTX.captured = "device", warmup, captured
    _CTX.collectives, _CTX.recorder = None, recorder
    try:
        yield
    finally:
        (_CTX.mode, _CTX.warmup, _CTX.captured, _CTX.collectives,
         _CTX.recorder) = saved


def in_device_program() -> bool:
    """Whether the caller runs inside a device program's pass (captured,
    its warm-up, or step by step on the CPU)."""
    return _CTX.mode == "device"


def bounded_while(cond: Callable, body: Callable, carry, trips: int):
    """The counterpart of a vmapped ``lax.while_loop`` that ends within
    ``trips`` trips: ``cond(carry)`` is the per-lane mask of the lanes still
    looping and ``body(carry, mask)`` one trip, which must leave a lane
    outside the mask as it was.

    In the host-driven loop: a host test before each trip, stopping at the
    first trip with no lane left. In the device program: ``trips`` trips,
    with no test (a trip with no lane left changes nothing)."""
    for _ in range(trips):
        mask = cond(carry)
        if _CTX.mode == "host" and not bool(mask.any()):
            break
        carry = body(carry, mask)
    return carry


def count_loop(trips: int, reads: int) -> None:
    """Count one loop that ran (on the host-driven loop or in a device
    program): its trips and host reads."""
    global LOOPS, LOOP_TRIPS, LOOP_READS
    LOOPS += 1
    LOOP_TRIPS += trips
    LOOP_READS += reads
    if LOOP_LOG is not None:
        LOOP_LOG.append((trips, reads))


def loop(trip: Callable, carry: tuple, active: torch.Tensor, maxiter: int,
         every: int) -> None:
    """A loop of a device program's pass: ``trip(k)`` runs trip ``k`` in
    place on the tensors of ``carry`` and on ``active``, the per-lane mask
    of the lanes still looping (a lane outside it must keep its carry). Trips
    run in chunks of ``every``, up to ``maxiter`` in all, each chunk after
    one host read of whether any lane is active, stopping at the first
    read that finds none: the host-driven loop's reads before trips 0,
    ``every``, 2·``every``, ... . Under capture the loop becomes an item of
    the pass's script; otherwise (the CPU, a warm-up) it runs now."""
    global CHUNK_REPLAYS
    if maxiter <= 0:
        return
    if _CTX.recorder is not None:
        _CTX.recorder.loop(trip, carry + (active,), active, maxiter, every)
        return
    trips = reads = chunks = 0
    for s in range(0, maxiter, every):
        reads += 1
        if not bool(active.any()):
            break
        for k in range(s, min(s + every, maxiter)):
            trip(k)
            trips += 1
        chunks += 1
    if not _CTX.warmup:
        count_loop(trips, reads)
        CHUNK_REPLAYS += chunks


def host_op(fn: Callable, t: torch.Tensor, shape, dtype) -> torch.Tensor:
    """``fn`` of a host copy of ``t`` (a CUDA tensor), back on ``t``'s
    device: ``fn`` takes a CPU tensor and returns a CPU tensor of ``shape``
    and ``dtype``. Under capture it becomes an item of the pass's script,
    which at each replay copies ``t`` into pinned host memory, runs ``fn``
    and copies its result into a static output, which it returns now."""
    global HOST_OPS
    if _CTX.recorder is not None:
        return _CTX.recorder.host_op(fn, t, shape, dtype)
    if not _CTX.warmup:
        HOST_OPS += 1
    return fn(t.cpu()).to(t.device)


def count_launch(module, shape, **incs) -> None:
    """Count one launch of one of the port's kernels, called by its wrapper
    in ``ops/`` where it launches. Outside a capture the increments
    ``incs`` are added to ``module``'s counters and ``shape`` to its
    ``SHAPES``. Under capture the launch is a node of the pass
    (``module.CAPTURED_LAUNCHES``), credited to the counters as one launch
    for every replay of its graph once the solve ends (exact: a graph
    without conditional nodes runs every node on every replay). In a
    warm-up it counts in :data:`WARMUP_LAUNCHES` only."""
    global WARMUP_LAUNCHES
    if _CTX.captured is not None:
        _CTX.captured.append((module, shape, incs))
        module.CAPTURED_LAUNCHES += 1
    elif _CTX.warmup:
        WARMUP_LAUNCHES += 1
    else:
        _credit(module, shape, incs, 1)


def count_collective(comm, key: tuple, nbytes: int) -> None:
    """Count one collective of ``comm`` (:class:`..parallel.comm.Comm`):
    ``key`` is ``(op, numel)``. Under capture it is credited once for every
    replay of the pass when the solve ends, as :func:`count_launch` credits
    a kernel; a warm-up's collectives count nowhere."""
    if _CTX.collectives is not None:
        _CTX.collectives.append((comm, key, nbytes))
    elif not _CTX.warmup:
        _credit_collective(comm, key, nbytes, 1)


def _credit(module, shape, incs: dict, times: int) -> None:
    if times <= 0:
        return
    for name, v in incs.items():
        setattr(module, name, getattr(module, name) + v * times)
    if shape is not None:
        module.SHAPES.add(shape)


def _credit_collective(comm, key: tuple, nbytes: int, times: int) -> None:
    if times > 0:
        comm.counts[key] += times
        comm.nbytes += nbytes * times


def assign(dst, src, frozen: frozenset = frozenset()) -> None:
    """Write the tree ``src`` into the tree ``dst`` leaf by leaf
    (``copy_``). A leaf that is the same object in both is left alone; a
    tensor of ``frozen`` (ids) must not be written, and leaves that do not
    match raise."""
    if dst is src:
        return
    if isinstance(dst, tuple):
        for a, b in zip(dst, src, strict=True):
            assign(a, b, frozen)
        return
    if torch.is_tensor(dst) and torch.is_tensor(src):
        if id(dst) in frozen:
            raise RuntimeError("a pass would write a static input of the "
                               f"device program ({tuple(dst.shape)})")
        dst.copy_(src)
        return
    raise TypeError(f"cannot write a {type(src).__name__} into a "
                    f"{type(dst).__name__} in place")


# ---------------------------------------------------------------------------
# Static buffers, programs, the cache
# ---------------------------------------------------------------------------

def leaves(tree) -> list:
    """The leaves of nested tuples, in order."""
    if isinstance(tree, tuple):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def _rebuild(tree, it):
    if isinstance(tree, tuple):
        vals = [_rebuild(t, it) for t in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else type(tree)(vals)
    return next(it)


def signature(dat, state) -> tuple:
    """The static part of a solve's inputs: each leaf's shape and dtype
    (the object itself for a leaf that is not a tensor), the trees' types,
    and which state leaves are data leaves (a K1 state holds ``A``)."""
    def sig(tree):
        if isinstance(tree, tuple):
            return (type(tree).__name__,) + tuple(sig(t) for t in tree)
        if torch.is_tensor(tree):
            return (tuple(tree.shape), tree.dtype)
        return tree
    dat_ids = {id(x): i for i, x in enumerate(leaves(dat))
               if torch.is_tensor(x)}
    alias = tuple(dat_ids.get(id(x), -1) for x in leaves(state))
    return sig(dat), sig(state), alias


def _fresh(x):
    if torch.is_tensor(x):
        return torch.empty_like(x, memory_format=torch.contiguous_format)
    return x


def _graph_nodes(g) -> int:
    """The nodes of a captured graph that is not instantiated yet
    (``cuGraphGetNodes`` of libcuda on ``g.raw_cuda_graph()``)."""
    import ctypes

    n = ctypes.c_size_t(0)
    rc = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(g.raw_cuda_graph()), None, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed with CUresult {rc}")
    return n.value


class _Graph:
    """A captured graph of the script: a segment of the pass or a chunk of
    a loop, with the launches and collectives recorded in it."""

    def __init__(self, trips: int = 0):
        # keep_graph: instantiated apart, after its nodes are counted.
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        self.trips = trips
        self.nodes = 0
        self.captured: list = []
        self.collectives: list = []
        self.replays = 0

    def capture(self, recorder: "_Recorder", fn: Callable) -> None:
        _CTX.captured, _CTX.collectives = self.captured, self.collectives
        self.graph.capture_begin(pool=recorder.pool)
        try:
            fn()
        finally:
            self.graph.capture_end()
            _CTX.captured = _CTX.collectives = None
        self.nodes = _graph_nodes(self.graph)

    def run(self, prog: "Program") -> None:
        self.graph.replay()
        self.replays += 1


class _Segment(_Graph):
    pass


class _Loop:
    """A loop item: chunk graphs replayed after a host read each."""

    def __init__(self, hold: tuple, active, maxiter, every, chunks: dict):
        # The static tensors that the chunks write in place and that later
        # segments read: held, so that the pool never hands them out.
        self.hold = hold
        self.active, self.maxiter, self.every = active, maxiter, every
        self.chunks = chunks            # (first chunk, trips) -> _Graph

    def run(self, prog: "Program") -> None:
        global CHUNK_REPLAYS
        trips = reads = 0
        for s in range(0, self.maxiter, self.every):
            reads += 1
            if not prog.read(self.active.any()):
                break
            g = self.chunks[s == 0, min(self.every, self.maxiter - s)]
            g.run(prog)
            trips += g.trips
            CHUNK_REPLAYS += 1
        count_loop(trips, reads)


class _HostOp:
    """A host operation item: its input staged through pinned memory, its
    result copied into a static output."""

    def __init__(self, fn, t, out):
        self.fn, self.t, self.out = fn, t, out
        self.pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)

    def run(self, prog: "Program") -> None:
        global HOST_OPS
        self.pinned.copy_(self.t)
        self.out.copy_(self.fn(self.pinned))
        HOST_OPS += 1


class _Recorder:
    """Cuts the pass being captured into a script of segments, loops and
    host operations, every graph in one memory pool."""

    def __init__(self):
        self.pool = torch.cuda.graph_pool_handle()
        self.script: list = []
        self.graphs: List[_Graph] = []
        self.segment = None

    def begin(self) -> None:
        self.segment = _Segment()
        seg = self.segment
        _CTX.captured, _CTX.collectives = seg.captured, seg.collectives
        seg.graph.capture_begin(pool=self.pool)

    def end(self) -> None:
        seg, self.segment = self.segment, None
        if seg is None:
            return
        try:
            seg.graph.capture_end()
        finally:
            _CTX.captured = _CTX.collectives = None
        seg.nodes = _graph_nodes(seg.graph)
        # An empty segment (two items in a row) is kept alive, not run.
        self.graphs.append(seg)
        if seg.nodes or seg.captured or seg.collectives:
            self.script.append(seg)

    def loop(self, trip, hold, active, maxiter: int, every: int) -> None:
        self.end()
        chunks: dict = {}
        for s in range(0, maxiter, every):
            kind = (s == 0, min(every, maxiter - s))
            if kind not in chunks:
                g = _Graph(trips=kind[1])
                g.capture(self, lambda s=s, n=kind[1]: [
                    trip(k) for k in range(s, s + n)])
                chunks[kind] = g
                self.graphs.append(g)
        self.script.append(_Loop(hold, active, maxiter, every, chunks))
        self.begin()

    def host_op(self, fn, t, shape, dtype) -> torch.Tensor:
        self.end()
        out = torch.empty(shape, dtype=dtype, device=t.device)
        self.script.append(_HostOp(fn, t, out))
        self.begin()
        return out


class Program:
    """One pass of a solve over static buffers: a captured script of CUDA
    graphs (and loops and host operations) on the card, the pass run step
    by step on the CPU."""

    def __init__(self, dat, state, step: Callable, live: Callable):
        global CAPTURES
        self.step, self.live_fn = step, live
        self.dat = _rebuild(dat, iter([_fresh(x) for x in leaves(dat)]))
        static_dat = {id(x): s for x, s in zip(leaves(dat),
                                               leaves(self.dat))}
        # A state leaf that is a data leaf (a K1 state's A) stays one.
        self.state = _rebuild(state, iter(
            [static_dat[id(x)] if id(x) in static_dat else _fresh(x)
             for x in leaves(state)]))
        self.frozen = frozenset(id(x) for x in leaves(self.dat)
                                if torch.is_tensor(x))
        # Positions of the state leaves that a pass returns as they came
        # (a structured state's plan: index tensors, constant tiles).
        self.passthrough: frozenset = frozenset()
        device = next(x for x in leaves(dat) if torch.is_tensor(x)).device
        self.device = device
        self.cuda = device.type == "cuda"
        self.script: list = []
        self.graphs: List[_Graph] = []
        self.warmup_s = self.capture_s = self.instantiate_s = 0.0
        # Bytes this program keeps on its device: the static copies, and on
        # the card the graphs' pool (added by the capture).
        self.nbytes = _storage_bytes((self.dat, self.state))
        self.load(dat, state)
        if self.cuda:
            self.flag = torch.zeros((), dtype=torch.bool, device=device)
            self.host = torch.zeros((), dtype=torch.bool).pin_memory()
            self.event = torch.cuda.Event()
            self._capture(dat, state)
        CAPTURES += 1

    def load(self, dat, state) -> None:
        """Copy a solve's inputs into the static buffers."""
        assign(self.dat, dat)
        dat_ids = {id(x) for x in leaves(dat)}
        for s, x in zip(leaves(self.state), leaves(state)):
            if torch.is_tensor(x) and id(x) not in dat_ids:
                s.copy_(x)

    def _pass(self, state) -> None:
        out = self.step(self.dat, state)
        self.passthrough = frozenset(
            i for i, (a, b) in enumerate(zip(leaves(state), leaves(out)))
            if a is b and torch.is_tensor(a))
        assign(state, out, self.frozen)

    def _capture(self, dat, state) -> None:
        # Warm-up: one pass, eagerly, on the static buffers, which are then
        # loaded again, so that every launch path the pass takes has run
        # once before the capture (nvcc builds and library loads, CUDA's
        # lazy module loading, cuBLAS/cuSOLVER handles and workspaces, an
        # NCCL communicator).
        t0 = time.perf_counter()
        with _device_mode(warmup=True):
            self._pass(self.state)
        self.load(dat, state)
        torch.cuda.synchronize()
        self.warmup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        # As torch.cuda.graph does: a side stream, the cache emptied, and
        # no gc.collect() (torch's is off by default: on a large heap a
        # full collection costs about a second a capture). cuBLAS keeps a
        # workspace for each stream it has run on; cleared before and after
        # the capture (as torch's inductor does), the workspace the capture
        # allocates lies in the graphs' pool and is freed with it, where a
        # workspace kept by cuBLAS would stay allocated, and hold that pool,
        # after the program is dropped.
        torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        rec = _Recorder()
        with torch.cuda.stream(stream), _device_mode(recorder=rec):
            rec.begin()
            try:
                self._pass(self.state)
            finally:
                rec.end()
        torch.cuda.current_stream().wait_stream(stream)
        torch.cuda.synchronize()
        self.capture_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for g in rec.graphs:
            if g.nodes:
                g.graph.instantiate()
        torch.cuda.synchronize()
        self.instantiate_s = time.perf_counter() - t0
        torch._C._cuda_clearCublasWorkspaces()
        self.nbytes += torch.cuda.memory_reserved(self.device) - reserved
        self.script, self.graphs = rec.script, rec.graphs

    @property
    def nodes(self):
        """Nodes of the pass's segments, summed (None on the CPU)."""
        if not self.cuda:
            return None
        return sum(i.nodes for i in self.script if isinstance(i, _Segment))

    def replay(self) -> None:
        if self.cuda:
            for item in self.script:
                item.run(self)
        else:
            with _device_mode():
                self._pass(self.state)

    def read(self, flag: torch.Tensor) -> bool:
        """One host read of a 0-d bool on the card, through a pinned
        buffer and an event."""
        self.flag.copy_(flag)
        self.host.copy_(self.flag, non_blocking=True)
        self.event.record()
        self.event.synchronize()
        return bool(self.host)

    def running(self) -> bool:
        """Whether any lane is still running: one host read."""
        live = self.live_fn(self.state)
        if not self.cuda:
            return bool(live)
        return self.read(live)

    def credit(self, passes: int) -> dict:
        """Credit the kernels and collectives recorded while capturing,
        once for every replay of their graphs in this solve (the segments:
        ``passes``); the launches of the port's kernels a pass, by
        kernel."""
        per_pass: dict = {}
        for g in self.graphs:
            times = passes if isinstance(g, _Segment) else g.replays
            for module, shape, incs in g.captured:
                _credit(module, shape, incs, times)
                if isinstance(g, _Segment):
                    name = module.__name__.rsplit(".", 1)[-1]
                    per_pass[name] = per_pass.get(name, 0) + 1
            for comm, key, nbytes in g.collectives:
                _credit_collective(comm, key, nbytes, times)
            g.replays = 0
        return per_pass

    def script_figures(self) -> dict:
        """The script of a pass: segments, loops, chunk graphs, host
        operations, and the nodes of the chunk graphs (None on the
        CPU)."""
        if not self.cuda:
            return dict(segments=None, loops_a_pass=None, chunk_graphs=None,
                        host_ops_a_pass=None, chunk_nodes=None)
        loops = [i for i in self.script if isinstance(i, _Loop)]
        chunks = [g for lp in loops for g in lp.chunks.values()]
        return dict(
            segments=sum(isinstance(i, _Segment) for i in self.script),
            loops_a_pass=len(loops), chunk_graphs=len(chunks),
            host_ops_a_pass=sum(isinstance(i, _HostOp)
                                for i in self.script),
            chunk_nodes=sum(g.nodes for g in chunks))

    def result(self, dat, state):
        """The final state out of the static buffers: a copy, with the
        caller's own data leaves where the state holds data leaves and the
        caller's own leaves of ``state`` where a pass passes them
        through (equal to the static ones: a pass never writes them)."""
        back = {id(s): x for s, x in zip(leaves(self.dat), leaves(dat))}
        theirs = leaves(state)
        out = []
        for i, s in enumerate(leaves(self.state)):
            if id(s) in back:
                out.append(back[id(s)])
            elif i in self.passthrough:
                out.append(theirs[i])
            else:
                out.append(s.clone() if torch.is_tensor(s) else s)
        return _rebuild(self.state, iter(out))


def run(key, dat, state, step: Callable, live: Callable):
    """Solve to the end through the device program of ``key``: build it or
    take it from the cache, copy ``dat`` and ``state`` into its static
    buffers, replay :data:`K_PASSES` passes between host reads of
    ``live(state)`` (a 0-d bool: any lane still running) and return the
    final state. ``step(dat, state)`` is one pass: the next state, masked
    to the lanes still running."""
    prog = _CACHE.get(key)
    built = prog is None
    if built:
        prog = Program(dat, state, step, live)
        _CACHE[key] = prog
        budget = CACHE_SHARE * _device_memory(prog.device)
        while len(_CACHE) > 1 and (
                len(_CACHE) > CACHE_SIZE
                or cached_bytes() > budget):
            _CACHE.popitem(last=False)
    else:
        _CACHE.move_to_end(key)
        prog.load(dat, state)
    before = (LOOPS, LOOP_TRIPS, LOOP_READS, CHUNK_REPLAYS, HOST_OPS)
    passes = syncs = 0
    t0 = time.perf_counter()
    while True:
        for _ in range(K_PASSES):
            prog.replay()
        passes += K_PASSES
        syncs += 1
        if not prog.running():
            break
    replay_s = time.perf_counter() - t0
    per_pass = prog.credit(passes)
    loops, trips, reads, chunks, host_ops = (
        a - b for a, b in zip((LOOPS, LOOP_TRIPS, LOOP_READS, CHUNK_REPLAYS,
                               HOST_OPS), before))
    LAST.clear()
    LAST.update(passes=passes, syncs=syncs, built=built,
                warmup_s=prog.warmup_s if built else 0.0,
                capture_s=prog.capture_s if built else 0.0,
                instantiate_s=prog.instantiate_s if built else 0.0,
                replay_s=replay_s, nodes_a_pass=prog.nodes,
                launches_a_pass=per_pass, **prog.script_figures(),
                loops=loops, trips=trips, loop_reads=reads,
                chunk_replays=chunks,
                host_ops=host_ops, host_reads=syncs + reads)
    trace.count("passes", passes)
    trace.count("host_reads", syncs + reads)
    trace.count("programs_built", built)
    return prog.result(dat, state)


def _storage_bytes(tree) -> int:
    """Bytes of the distinct storages of the tensor leaves of ``tree``."""
    seen = {}
    for x in leaves(tree):
        if torch.is_tensor(x):
            st = x.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def _device_memory(device: torch.device) -> int:
    """Bytes of memory of ``device``: the card's, or the host's for the
    CPU, where the programs' static copies live."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def cached_bytes() -> int:
    """Bytes that the cached programs keep (:attr:`Program.nbytes`)."""
    return sum(p.nbytes for p in _CACHE.values())


def clear_device_programs() -> None:
    """Drop every cached device program, and with them the memory pools of
    their graphs."""
    _CACHE.clear()
