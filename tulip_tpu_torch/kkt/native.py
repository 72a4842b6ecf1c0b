"""ctypes bindings for the native C++ symbolic-analysis engine.

The sparse/banded KKT backends split work CHOLMOD-style (reference:
src/KKT/Cholmod/spd.jl:30-49): a host symbolic phase run once at ``setup``
and a device numeric phase per IPM iteration. This module accelerates the
symbolic phase — K = A Aᵀ adjacency, RCM ordering, tile-granular symbolic
elimination, static-schedule emission — with ``native/symbolic.cpp``,
falling back silently to the pure-Python/scipy path when the library can't
be built (callers use :func:`native_available`).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", ".."))
_SO_PATH = os.path.join(_REPO_ROOT, "native",
                        os.environ.get("TULIP_NATIVE_DIR", "build"),
                        "libtulip_symbolic.so")

_lib = None
_tried = False

_I32P = ctypes.POINTER(ctypes.c_int32)

#: Sentinel returned by :func:`tile_plan_native` when the native library is
#: unavailable — distinct from ``None`` ("tiling has no advantage"). Compare
#: with ``is``.
UNAVAILABLE = object()


def _build() -> bool:
    try:
        subprocess.run(["make", "-C", os.path.join(_REPO_ROOT, "native")],
                       check=True, capture_output=True, timeout=120)
        return os.path.exists(_SO_PATH)
    except Exception:
        return False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_SO_PATH) and not _build():
        return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
        lib.tlp_rcm.restype = ctypes.c_int32
        lib.tlp_rcm.argtypes = [ctypes.c_int32, ctypes.c_int32, _I32P, _I32P,
                                _I32P]
        lib.tlp_tile_plan_new.restype = ctypes.c_void_p
        lib.tlp_tile_plan_new.argtypes = [ctypes.c_int32, ctypes.c_int32,
                                          _I32P, _I32P, ctypes.c_int32, _I32P]
        lib.tlp_tile_plan_emit.restype = ctypes.c_int32
        lib.tlp_tile_plan_emit.argtypes = [ctypes.c_void_p, _I32P, _I32P,
                                           _I32P, _I32P, _I32P, _I32P]
        lib.tlp_tile_plan_free.restype = None
        lib.tlp_tile_plan_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def native_available() -> bool:
    return _load() is not None


def _csr_pattern(A_np: np.ndarray):
    """(indptr, indices) of the nonzero pattern of dense A, int32."""
    # abs>0 (not !=0) so NaN entries count as nonzero, matching the
    # scipy reference path in kkt/sparse.py.
    mask = np.abs(A_np) > 0
    counts = mask.sum(axis=1).astype(np.int32)
    indptr = np.zeros(A_np.shape[0] + 1, np.int32)
    np.cumsum(counts, out=indptr[1:])
    indices = np.nonzero(mask)[1].astype(np.int32)
    return indptr, indices


def _as_i32p(a: np.ndarray):
    return a.ctypes.data_as(_I32P)


def rcm_native(A_np: np.ndarray) -> Optional[Tuple[np.ndarray, int]]:
    """(perm, half-bandwidth of permuted A Aᵀ pattern), or None if the
    native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    m, n = A_np.shape
    indptr, indices = _csr_pattern(A_np)
    perm = np.empty(m, np.int32)
    bw = lib.tlp_rcm(m, n, _as_i32p(indptr), _as_i32p(indices), _as_i32p(perm))
    if bw < 0:
        return None
    return perm.astype(np.int64), int(bw)


def tile_plan_native(A_np: np.ndarray, block: int):
    """Native counterpart of :func:`tulip_tpu.kkt.sparse.tile_plan`.

    Returns the same plan dict, ``None`` if tiling has no advantage, or the
    module-level :data:`UNAVAILABLE` sentinel when the library can't be
    loaded (so the caller can distinguish fallback from a genuine
    no-advantage verdict — compare with ``is``).

    The analysis (adjacency + RCM + symbolic elimination) runs exactly once:
    ``tlp_tile_plan_new`` returns an opaque handle holding the plan, whose
    schedule is then copied out with ``tlp_tile_plan_emit``.
    """
    lib = _load()
    if lib is None:
        return UNAVAILABLE
    m, n = A_np.shape
    indptr, indices = _csr_pattern(A_np)
    sizes = np.zeros(5, np.int32)
    handle = lib.tlp_tile_plan_new(m, n, _as_i32p(indptr), _as_i32p(indices),
                                   block, _as_i32p(sizes))
    if not handle:
        return UNAVAILABLE
    try:
        nbr, ntiles, cmax, umax, advantage = (int(v) for v in sizes)
        if not advantage:
            return None
        perm = np.empty(m, np.int32)
        col_ids = np.empty((nbr, cmax), np.int32)
        col_blkrows = np.empty((nbr, cmax), np.int32)
        u_a = np.empty((nbr, umax), np.int32)
        u_b = np.empty((nbr, umax), np.int32)
        u_tgt = np.empty((nbr, umax), np.int32)
        rc = lib.tlp_tile_plan_emit(handle, _as_i32p(perm), _as_i32p(col_ids),
                                    _as_i32p(col_blkrows), _as_i32p(u_a),
                                    _as_i32p(u_b), _as_i32p(u_tgt))
        if rc != 0:
            return UNAVAILABLE
    finally:
        lib.tlp_tile_plan_free(handle)
    return dict(perm=perm.astype(np.int64), nbr=nbr, ntiles=ntiles,
                cmax=cmax, umax=umax, col_ids=col_ids,
                col_blkrows=col_blkrows, u_a=u_a, u_b=u_b, u_tgt=u_tgt)
