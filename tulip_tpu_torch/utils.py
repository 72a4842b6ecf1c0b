"""Small shared helpers (reference: src/utils.jl).

The host-side subset of ``tulip_tpu/utils.py``, copied verbatim; the
functions left out there manage JAX compilation caches."""

from __future__ import annotations

import bz2
import gzip
import io


def open_maybe_compressed(fname: str) -> io.TextIOBase:
    """Open a text file, transparently decompressing .gz / .bz2
    (reference: src/utils.jl:9-20)."""
    if fname.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(fname, "rb"))
    if fname.endswith(".bz2"):
        return io.TextIOWrapper(bz2.open(fname, "rb"))
    return open(fname, "r")


def pos_part(x: float) -> float:
    return x if x >= 0 else 0.0


def neg_part(x: float) -> float:
    return -x if x < 0 else 0.0
