"""ctypes bindings for the native C++ MPS tokenizer.

Loads (or builds, once, with the system g++) ``native/build/libtulip_mps.so``
and assembles its flat token arrays into a ProblemData, applying the shared
semantics from :mod:`.semantics`. Falls back silently when the library
can't be built — callers use :func:`native_available`.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Dict, Optional

import numpy as np

from ..problem import INF, ProblemData, SparseAxis
from .semantics import apply_bound, row_bounds

_REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", ".."))
_SO_PATH = os.path.join(_REPO_ROOT, "native",
                        os.environ.get("TULIP_NATIVE_DIR", "build"),
                        "libtulip_mps.so")
_SRC = os.path.join(_REPO_ROOT, "native", "mps_tokenizer.cpp")

_lib = None
_tried = False


class _MpsResult(ctypes.Structure):
    _fields_ = [
        ("n_rows", ctypes.c_int64),
        ("row_types", ctypes.c_char_p),
        ("row_names", ctypes.POINTER(ctypes.c_char)),
        ("row_names_len", ctypes.c_int64),
        ("n_cols", ctypes.c_int64),
        ("col_names", ctypes.POINTER(ctypes.c_char)),
        ("col_names_len", ctypes.c_int64),
        ("nnz", ctypes.c_int64),
        ("e_row", ctypes.POINTER(ctypes.c_int32)),
        ("e_col", ctypes.POINTER(ctypes.c_int32)),
        ("e_val", ctypes.POINTER(ctypes.c_double)),
        ("n_obj", ctypes.c_int64),
        ("obj_col", ctypes.POINTER(ctypes.c_int32)),
        ("obj_val", ctypes.POINTER(ctypes.c_double)),
        ("obj_const", ctypes.c_double),
        ("objsense_min", ctypes.c_int32),
        ("n_rhs", ctypes.c_int64),
        ("rhs_row", ctypes.POINTER(ctypes.c_int32)),
        ("rhs_val", ctypes.POINTER(ctypes.c_double)),
        ("n_rng", ctypes.c_int64),
        ("rng_row", ctypes.POINTER(ctypes.c_int32)),
        ("rng_val", ctypes.POINTER(ctypes.c_double)),
        ("n_bnd", ctypes.c_int64),
        ("bnd_types", ctypes.POINTER(ctypes.c_char)),
        ("bnd_col", ctypes.POINTER(ctypes.c_int32)),
        ("bnd_val", ctypes.POINTER(ctypes.c_double)),
        ("bnd_has_val", ctypes.POINTER(ctypes.c_uint8)),
        ("name", ctypes.c_char_p),
        ("error", ctypes.c_char_p),
    ]


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
        lib.tulip_parse_mps.restype = ctypes.POINTER(_MpsResult)
        lib.tulip_parse_mps.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.tulip_free_mps.argtypes = [ctypes.POINTER(_MpsResult)]
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def native_available() -> bool:
    return _load() is not None


def _split_names(buf, total_len: int, n: int):
    blob = ctypes.string_at(buf, total_len)
    names = blob.decode("utf-8", errors="replace").split("\0")
    return names[:n]


def parse_mps_native(text: bytes, name_hint: str = "",
                     ) -> Optional[ProblemData]:
    """Parse MPS text bytes with the native tokenizer; None if unavailable,
    raises MPSError-compatible ValueError on parse errors."""
    lib = _load()
    if lib is None:
        return None
    res = lib.tulip_parse_mps(text, len(text))
    try:
        r = res.contents
        if r.error:
            raise ValueError(r.error.decode())

        n_rows = int(r.n_rows)
        n_cols = int(r.n_cols)
        row_types = (r.row_types or b"").decode()
        row_names = _split_names(r.row_names, int(r.row_names_len), n_rows)
        col_names = _split_names(r.col_names, int(r.col_names_len), n_cols)

        nnz = int(r.nnz)
        e_row = np.ctypeslib.as_array(r.e_row, (max(nnz, 1),))[:nnz].copy()
        e_col = np.ctypeslib.as_array(r.e_col, (max(nnz, 1),))[:nnz].copy()
        e_val = np.ctypeslib.as_array(r.e_val, (max(nnz, 1),))[:nnz].copy()
        n_obj = int(r.n_obj)
        obj_col = np.ctypeslib.as_array(
            r.obj_col, (max(n_obj, 1),))[:n_obj].copy()
        obj_val = np.ctypeslib.as_array(
            r.obj_val, (max(n_obj, 1),))[:n_obj].copy()
        n_rhs = int(r.n_rhs)
        rhs_row = np.ctypeslib.as_array(
            r.rhs_row, (max(n_rhs, 1),))[:n_rhs].copy()
        rhs_val = np.ctypeslib.as_array(
            r.rhs_val, (max(n_rhs, 1),))[:n_rhs].copy()
        n_rng = int(r.n_rng)
        rng_row = np.ctypeslib.as_array(
            r.rng_row, (max(n_rng, 1),))[:n_rng].copy()
        rng_val = np.ctypeslib.as_array(
            r.rng_val, (max(n_rng, 1),))[:n_rng].copy()
        n_bnd = int(r.n_bnd)
        bnd_types = ctypes.string_at(r.bnd_types, 2 * n_bnd).decode() \
            if n_bnd else ""
        bnd_col = np.ctypeslib.as_array(
            r.bnd_col, (max(n_bnd, 1),))[:n_bnd].copy()
        bnd_val = np.ctypeslib.as_array(
            r.bnd_val, (max(n_bnd, 1),))[:n_bnd].copy()
        name = (r.name or b"").decode()
        obj_const = float(r.obj_const)
        objsense_min = bool(r.objsense_min)
    finally:
        lib.tulip_free_mps(res)

    # ---- assemble ProblemData (same semantics as the Python parser) ----
    obj = np.zeros(n_cols)
    np.add.at(obj, obj_col, obj_val)

    lo: Dict[int, float] = {}
    up: Dict[int, float] = {}
    for k in range(n_bnd):
        apply_bound(lo, up, int(bnd_col[k]),
                    bnd_types[2 * k:2 * k + 2].strip(), float(bnd_val[k]))

    rhs = np.zeros(n_rows)
    rhs[rhs_row] = rhs_val
    has_rng = np.zeros(n_rows, dtype=bool)
    rngv = np.zeros(n_rows)
    has_rng[rng_row] = True
    rngv[rng_row] = rng_val

    pb = ProblemData(name or name_hint)
    pb.objsense = objsense_min
    pb.obj0 = obj_const
    pb.nvar = n_cols
    pb.obj = obj.tolist()
    pb.lvar = [lo.get(j, 0.0) for j in range(n_cols)]
    pb.uvar = [up.get(j, INF) for j in range(n_cols)]
    pb.var_names = col_names
    pb.acols = [SparseAxis() for _ in range(n_cols)]

    pb.ncon = n_rows
    pb.con_names = row_names
    pb.lcon = []
    pb.ucon = []
    pb.arows = [SparseAxis() for _ in range(n_rows)]
    for i in range(n_rows):
        lb, ub = row_bounds(row_types[i], float(rhs[i]),
                            bool(has_rng[i]), float(rngv[i]))
        pb.lcon.append(lb)
        pb.ucon.append(ub)

    # Entries: combine duplicates and drop zeros with vectorized numpy
    # (semantics identical to the Python parser's per-row sorted insert);
    # then build row/column views by boundary slicing.
    if nnz:
        key = e_row.astype(np.int64) * n_cols + e_col.astype(np.int64)
        order = np.argsort(key, kind="stable")
        key_s = key[order]
        v_s = e_val[order]
        uniq, starts = np.unique(key_s, return_index=True)
        vals = np.add.reduceat(v_s, starts)
        keep = vals != 0.0
        uniq, vals = uniq[keep], vals[keep]
        rows_u = (uniq // n_cols).astype(np.int64)
        cols_u = (uniq % n_cols).astype(np.int64)

        bounds = np.searchsorted(rows_u, np.arange(n_rows + 1))
        for i in range(n_rows):
            s, e = bounds[i], bounds[i + 1]
            pb.arows[i].nzind = cols_u[s:e].tolist()
            pb.arows[i].nzval = vals[s:e].tolist()

        corder = np.lexsort((rows_u, cols_u))
        cc, rr, vv = cols_u[corder], rows_u[corder], vals[corder]
        cbounds = np.searchsorted(cc, np.arange(n_cols + 1))
        for j in range(n_cols):
            s, e = cbounds[j], cbounds[j + 1]
            pb.acols[j].nzind = rr[s:e].tolist()
            pb.acols[j].nzval = vv[s:e].tolist()
    return pb
