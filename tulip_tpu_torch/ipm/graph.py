"""The device program: a whole IPM solve as replays of one captured CUDA
graph.

Counterpart of the JAX package's ``hsd_solve_device`` / ``mpc_solve_device``
(``tulip_tpu/ipm/hsd.py:564``, ``tulip_tpu/ipm/mpc.py:435``) and of the
vmapped ``lax.while_loop`` behind ``tulip_tpu/ipm/batch.py:134-195``. There
the whole solve is one XLA program: an outer while-loop over passes and,
inside a pass, the bounded while-loops of the regularization bumps
(``hsd.py:321-339``) and of the centrality corrections (``hsd.py:385-400``).
Under vmap every one of them runs its body for every lane while any lane
needs it, and a lane whose condition is false keeps its carry.

The card's torch (2.11) has no CUDA-graph conditional nodes, so nothing in
a graph can branch on the device. Here:

- :func:`bounded_while` runs such a per-lane loop. The host-driven loop
  tests on the host before each trip and stops at the first trip that no
  lane needs (one sync a trip). In the device program it runs the loop's
  bound of trips, every one masked per lane: a trip that no lane needs
  leaves every lane's carry as it was, so the result is the same bit for
  bit, at the cost of the trips' work (3 factorizations a pass for the
  bumps, ``CorrectionLimit`` solves for the corrections);
- :func:`run` captures one pass (one IPM iteration, masked to the lanes
  still running, written into static buffers) as a CUDA graph, once per
  key, and replays it, reading between every :data:`K_PASSES` replays
  whether any lane is still running, through a pinned buffer and an
  event. A pass replayed after every lane has finished changes nothing:
  a finished lane keeps its state.

On the CPU there is no graph: the same pass runs step by step over the same
static buffers, which is the plain version of the program.
"""

from __future__ import annotations

import contextlib
import time
from collections import OrderedDict
from typing import Any, Callable, List, Tuple

import torch

# Passes replayed between two reads of whether any lane is still running.
# Without conditional nodes a replay after the last lane finished is a whole
# pass of work (1-50 ms on the card), while a read costs one sync and the
# relaunch behind it (tens of microseconds), so reading after every pass
# loses the least.
K_PASSES = 1
# Device programs kept, least recently used out first. Each pins its graph's
# memory pool; eight covers a bench's repeats of a few shapes.
CACHE_SIZE = 8

# Programs built (captures on the card, static buffers on the CPU) since
# the process started.
CAPTURES = 0
# Launches of the port's kernels in the warm-up passes before captures
# (eager, on the static buffers, which are loaded again after); they count
# in no kernel's KERNEL_LAUNCHES.
WARMUP_LAUNCHES = 0
# The last solve through a device program: passes replayed, host reads,
# whether the program was built for it, the seconds of its warm-up pass, of
# its capture and of its instantiation (0 when it came from the cache), the
# seconds of the replays and reads, the nodes of the captured pass (all
# launches and copies; None on the CPU) and the launches of the port's
# kernels among them, by kernel.
LAST: dict = {}

_CACHE: "OrderedDict[Any, Program]" = OrderedDict()


class _Ctx:
    # "host": the host-driven loop; "device": the device program's pass
    # (captured, its warm-up, or step by step on the CPU).
    mode = "host"
    warmup = False
    # Launches recorded while capturing: (module, shape, counter increments).
    captured: list = None


_CTX = _Ctx()


@contextlib.contextmanager
def _device_mode(warmup: bool = False, captured: list = None):
    saved = (_CTX.mode, _CTX.warmup, _CTX.captured)
    _CTX.mode, _CTX.warmup, _CTX.captured = "device", warmup, captured
    try:
        yield
    finally:
        _CTX.mode, _CTX.warmup, _CTX.captured = saved


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


def count_launch(module, shape, **incs) -> None:
    """Count one launch of one of the port's kernels, called by its wrapper
    in ``ops/`` where it launches. Outside a capture the increments
    ``incs`` are added to ``module``'s counters and ``shape`` to its
    ``SHAPES``. Under capture the launch is a node of the pass
    (``module.CAPTURED_LAUNCHES``), credited to the counters as one launch
    for every replay of the pass once the solve ends (exact: a graph
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


def _credit(module, shape, incs: dict, times: int) -> None:
    if times <= 0:
        return
    for name, v in incs.items():
        setattr(module, name, getattr(module, name) + v * times)
    if shape is not None:
        module.SHAPES.add(shape)


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


class Program:
    """One pass of a solve over static buffers: a captured CUDA graph on
    the card, the pass run step by step on the CPU."""

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
        self.cuda = dat.b.device.type == "cuda"
        self.graph = None
        self.captured: List[Tuple[Any, Any, dict]] = []
        self.warmup_s = self.capture_s = self.instantiate_s = 0.0
        self.nodes = None
        self.load(dat, state)
        if self.cuda:
            self.flag = torch.zeros((), dtype=torch.bool, device=dat.b.device)
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
        # lazy module loading, cuBLAS/cuSOLVER handles and workspaces).
        t0 = time.perf_counter()
        with _device_mode(warmup=True):
            self._pass(self.state)
        self.load(dat, state)
        torch.cuda.synchronize()
        self.warmup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        # keep_graph: instantiated apart, after its nodes are counted.
        g = torch.cuda.CUDAGraph(keep_graph=True)
        captured: list = []
        with _device_mode(captured=captured):
            with torch.cuda.graph(g):
                self._pass(self.state)
        torch.cuda.synchronize()
        self.capture_s = time.perf_counter() - t0
        self.nodes = _graph_nodes(g)
        t0 = time.perf_counter()
        g.instantiate()
        torch.cuda.synchronize()
        self.instantiate_s = time.perf_counter() - t0
        self.graph, self.captured = g, captured

    def replay(self) -> None:
        if self.graph is not None:
            self.graph.replay()
        else:
            with _device_mode():
                self._pass(self.state)

    def running(self) -> bool:
        """Whether any lane is still running: one host sync, through a
        pinned buffer and an event on the card."""
        live = self.live_fn(self.state)
        if not self.cuda:
            return bool(live)
        self.flag.copy_(live)
        self.host.copy_(self.flag, non_blocking=True)
        self.event.record()
        self.event.synchronize()
        return bool(self.host)

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
        while len(_CACHE) > CACHE_SIZE:
            _CACHE.popitem(last=False)
    else:
        _CACHE.move_to_end(key)
        prog.load(dat, state)
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
    per_pass: dict = {}
    for module, shape, incs in prog.captured:
        _credit(module, shape, incs, passes)
        name = module.__name__.rsplit(".", 1)[-1]
        per_pass[name] = per_pass.get(name, 0) + 1
    LAST.clear()
    LAST.update(passes=passes, syncs=syncs, built=built,
                warmup_s=prog.warmup_s if built else 0.0,
                capture_s=prog.capture_s if built else 0.0,
                instantiate_s=prog.instantiate_s if built else 0.0,
                replay_s=replay_s, nodes_a_pass=prog.nodes,
                launches_a_pass=per_pass)
    return prog.result(dat, state)


def clear_device_programs() -> None:
    """Drop every cached device program, and with them the memory pools of
    their graphs."""
    _CACHE.clear()
