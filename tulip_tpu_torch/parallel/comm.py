"""The collectives of the distributed paths, named and counted.

The JAX package shards an array over a device mesh and lets XLA's GSPMD
partitioner insert the collectives (``psum``, all-gathers) where a
computation crosses the sharded axis. torch has no partitioner, so every
collective of the port's distributed paths is a call on a :class:`Comm`:

- ``Comm()`` (no group) is one process: every operation returns its input;
- ``Comm(group)`` runs over one ``torch.distributed`` process group, one
  process per card with NCCL, or CPU processes (or processes that share a
  card) with Gloo.

Under NCCL tensors stay on the card, and a CPU tensor is refused. Under
Gloo a CUDA tensor is copied to host memory, reduced or gathered there and
copied back: one explicit path, whatever collectives the installed Gloo
takes for CUDA tensors. Nothing switches between the two on its own.

Inside a device program (``ipm/graph.py``) an NCCL collective is captured
with the pass, and a Gloo collective of CUDA tensors is a host operation of
the pass's script (:func:`..ipm.graph.host_op`): the graph ends before it,
and the next begins after it.

Every call records ``(op, numel)`` in :attr:`Comm.counts` (and its bytes
in :attr:`Comm.nbytes`), the port's stand-in for the reference's check of
the collectives in the compiled program (``__graft_entry__.py:252-276``).
A collective captured in a device program counts once for every replay.
The open call record (:mod:`tulip_tpu_torch.trace`) counts the same calls
and bytes, in all (``collectives``, ``comm_bytes``) and by the name the
caller gives the call (``collectives/<name>``, ``comm_bytes/<name>``; the
op where it gives none).
"""

from __future__ import annotations

import collections
import datetime
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist


class Comm:
    """Collectives over one process group, or none (one process)."""

    def __init__(self, group=None):
        self.group = group
        if group is None:
            self.backend, self.rank, self.size = None, 0, 1
        else:
            self.backend = str(dist.get_backend(group))
            self.rank = dist.get_rank(group)
            self.size = dist.get_world_size(group)
        if self.backend == "nccl" and not torch.cuda.is_available():
            raise RuntimeError("an NCCL group needs CUDA devices")
        # (op, numel) -> calls; bytes moved by all calls.
        self.counts: collections.Counter = collections.Counter()
        self.nbytes = 0

    def reset(self) -> None:
        self.counts.clear()
        self.nbytes = 0

    def _record(self, op: str, numel: int, itemsize: int,
                name: Optional[str]) -> None:
        from ..ipm import graph

        graph.count_collective(self, (op, numel), numel * itemsize,
                               name or op)

    def _run(self, fn, t: torch.Tensor, shape, dtype) -> torch.Tensor:
        """``fn`` (a collective) of ``t`` where the group's backend takes
        it: on the card under NCCL (a CPU tensor is refused), in host
        memory under Gloo (a CUDA tensor is staged there and its result
        copied back: a host operation inside a device program). ``fn``
        returns a tensor of ``shape`` and ``dtype`` on its input's
        device."""
        from ..ipm import graph

        if self.backend == "nccl" and not t.is_cuda:
            raise ValueError("an NCCL group moves CUDA tensors; got one on "
                             f"{t.device}")
        if self.backend == "gloo" and t.is_cuda:
            return graph.host_op(fn, t, shape, dtype)
        return fn(t.contiguous())

    def all_reduce_sum(self, t: torch.Tensor,
                       name: Optional[str] = None) -> torch.Tensor:
        """The sum of ``t`` over the group, the same bits on every rank;
        ``name`` labels the call in the call record's counters."""
        self._record("all_reduce_sum", t.numel(), t.element_size(), name)
        if self.group is None:
            return t

        def fn(x):
            x = x.clone()
            dist.all_reduce(x, dist.ReduceOp.SUM, group=self.group)
            return x
        return self._run(fn, t, t.shape, t.dtype)

    def all_reduce_and(self, flag: torch.Tensor,
                       name: Optional[str] = None) -> torch.Tensor:
        """Elementwise AND of a boolean tensor over the group."""
        self._record("all_reduce_and", flag.numel(), flag.element_size(),
                     name)
        if self.group is None:
            return flag

        def fn(x):
            x = x.to(torch.int32)
            dist.all_reduce(x, dist.ReduceOp.MIN, group=self.group)
            return x.bool()
        return self._run(fn, flag, flag.shape, torch.bool)

    def all_gather_blocks(self, t: torch.Tensor, dim: int = 0,
                          counts: Optional[Sequence[int]] = None,
                          name: Optional[str] = None) -> torch.Tensor:
        """Every rank's block of ``t`` concatenated along ``dim``, ranks in
        order. ``counts[r]`` is rank r's extent along ``dim`` (default:
        all equal to this rank's); unequal blocks travel padded to the
        largest and are cut back."""
        if counts is None:
            counts = [t.shape[dim]] * self.size
        shape = list(t.shape)
        shape[dim] = sum(counts)
        numel = torch.Size(shape).numel()
        # The gathered result's elements: what the reference's HLO check
        # reads as the size of an all-gather.
        self._record("all_gather_blocks", numel, t.element_size(), name)
        if self.group is None:
            return t
        width = max(counts)

        def fn(x):
            if x.shape[dim] < width:
                pad = list(x.shape)
                pad[dim] = width - x.shape[dim]
                x = torch.cat([x, x.new_zeros(pad)], dim)
            parts: List[torch.Tensor] = [torch.empty_like(x)
                                         for _ in range(self.size)]
            dist.all_gather(parts, x.contiguous(), group=self.group)
            return torch.cat([p.narrow(dim, 0, c)
                              for p, c in zip(parts, counts)], dim)
        return self._run(fn, t, shape, t.dtype)


def init_comm(backend: str, rank: int, size: int, store_path: str,
              timeout_s: float = 120.0) -> Comm:
    """Join the default process group of ``size`` processes as ``rank``,
    through a ``FileStore`` at ``store_path`` (no port is opened), and
    return its :class:`Comm`. NCCL without CUDA raises before any group
    is made."""
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("an NCCL group needs CUDA devices")
    store = dist.FileStore(store_path, size)
    dist.init_process_group(backend, store=store, rank=rank, world_size=size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return Comm(dist.group.WORLD)
