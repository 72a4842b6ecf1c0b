"""A bulk-loaded problem's matrix kept in CSR and CSC arrays.

``ProblemData`` (``problem.py``, a verbatim copy of the JAX package's)
stores the constraint matrix as a Python list per row and per column.
``ProblemData.load`` builds those lists from COO arrays, and every consumer
on ``Model.optimize``'s path (the native presolve engine, the reduction,
postsolve) turns them back into arrays. Here ``load`` keeps the
deduplicated matrix as arrays instead and makes the instance an
:class:`ArrayProblemData`:

- ``csr = (rowptr, colind, val)``: the column indices sorted within each
  row, the entries and order that ``load`` gives ``arows``;
- ``csc = (colptr, rowind, val)``: the row indices sorted within each
  column, those of ``acols``.

The first read or assignment of ``arows`` or ``acols`` (the Python presolve
rules, ``get_coefficient``, every mutator) builds the lists exactly as the
verbatim ``load`` does, counts ``problem_lists_built`` in the open call
record, drops the arrays and turns the instance back into a plain
``ProblemData``. A problem built through the incremental API or an MPS
reader never has arrays.

The array-aware consumers read the arrays when they exist and otherwise
run the verbatim code: ``ArrayProblemData.to_coo`` and ``.nnz``,
``PresolveData.__init__``'s nonzero counts, the input arrays of
``presolve_native`` and ``extract_reduced_arrays``. Each gives the verbatim
path's output bit for bit. ``tulip_tpu_torch/__init__.py`` puts the
replacements of :data:`INSTALLED` on the verbatim classes and module.
"""

from __future__ import annotations

import numpy as np

from . import trace
from .presolve import native
from .presolve.presolve import PresolveData, ReducedArrays
from .problem import ProblemData, SparseAxis
from .solution import Solution
from .status import SolutionStatus, TerminationStatus

# The verbatim functions that the replacements fall back to.
_VERBATIM_LOAD = ProblemData.load
_VERBATIM_PRESOLVE_INIT = PresolveData.__init__
_VERBATIM_EXTRACT = PresolveData.extract_reduced_arrays
_VERBATIM_NATIVE = native.presolve_native


class ArrayProblemData(ProblemData):
    """A ``ProblemData`` whose matrix is still in the arrays ``csr`` and
    ``csc`` that ``load`` left; :meth:`build_lists` makes it a plain
    ``ProblemData`` again."""

    def build_lists(self) -> ProblemData:
        """Build ``arows`` and ``acols`` from the arrays as the verbatim
        ``load`` does, drop the arrays and return the plain instance."""
        rowptr, colind, rval = self.csr
        colptr, rowind, cval = self.csc
        del self.csr, self.csc
        self.__class__ = ProblemData
        trace.count("problem_lists_built")
        self.arows = _axes(rowptr, colind, rval)
        self.acols = _axes(colptr, rowind, cval)
        return self

    @property
    def arows(self):
        return self.build_lists().arows

    @arows.setter
    def arows(self, value):
        self.build_lists().arows = value

    @property
    def acols(self):
        return self.build_lists().acols

    @acols.setter
    def acols(self, value):
        self.build_lists().acols = value

    @property
    def nnz(self) -> int:
        return int(self.csc[2].size)

    def to_coo(self):
        """The verbatim ``to_coo``'s arrays: column by column, rows
        ascending."""
        colptr, rowind, val = self.csc
        J = np.repeat(np.arange(self.nvar, dtype=np.int64), np.diff(colptr))
        return rowind.copy(), J, val.copy()


def _axes(ptr, idx, val):
    """One ``SparseAxis`` per slice ``ptr[k]:ptr[k + 1]`` (the verbatim
    ``load``'s lists)."""
    il, vl = idx.tolist(), val.tolist()
    axes = []
    for k in range(ptr.size - 1):
        s, e = ptr[k], ptr[k + 1]
        ax = SparseAxis()
        if s < e:
            ax.nzind, ax.nzval = il[s:e], vl[s:e]
        axes.append(ax)
    return axes


@trace.call("load")
def load(self, objsense, obj, obj0, A_coo, lcon, ucon, lvar, uvar,
         con_names=None, var_names=None, name=""):
    """``ProblemData.load`` that keeps the matrix in arrays
    (:class:`ArrayProblemData`); a subclass of ``ProblemData`` gets the
    verbatim lists."""
    if type(self) not in (ProblemData, ArrayProblemData):
        return _VERBATIM_LOAD(self, objsense, obj, obj0, A_coo, lcon, ucon,
                              lvar, uvar, con_names, var_names, name)
    if type(self) is ArrayProblemData:  # a reload: no lists to build
        del self.csr, self.csc
        self.__class__ = ProblemData
    # Up to the lists, the verbatim load's statements.
    m, n = len(lcon), len(lvar)
    self.__init__(name)
    self.objsense = bool(objsense)
    self.obj0 = float(obj0)
    self.nvar = n
    self.ncon = m
    self.obj = [float(v) for v in obj]
    self.lvar = [float(v) for v in lvar]
    self.uvar = [float(v) for v in uvar]
    self.lcon = [float(v) for v in lcon]
    self.ucon = [float(v) for v in ucon]
    self.var_names = list(var_names) if var_names else [""] * n
    self.con_names = list(con_names) if con_names else [""] * m

    aI, aJ, aV = A_coo
    I = np.asarray(aI, dtype=np.int64).ravel()
    J = np.asarray(aJ, dtype=np.int64).ravel()
    V = np.asarray(aV, dtype=np.float64).ravel()
    nz = V != 0.0
    I, J, V = I[nz], J[nz], V[nz]
    if I.size:
        if I.min() < 0 or I.max() >= m:
            raise IndexError("row index out of range")
        if J.min() < 0 or J.max() >= n:
            raise IndexError("column index out of range")
        key = I * n + J
        order = np.argsort(key, kind="stable")
        ks, vs = key[order], V[order]
        starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
        sums = np.add.reduceat(vs, starts)
        ukey = ks[starts]
        keep = sums != 0.0
        ukey, sums = ukey[keep], sums[keep]
        I, J, V = ukey // n, ukey % n, sums

    # (I, J, V) is sorted by (i, j); the verbatim lexsort sorts by (j, i).
    o = np.lexsort((I, J))
    Jc = J[o]
    del self.arows, self.acols
    self.csr = (np.searchsorted(I, np.arange(m + 1)), J, V)
    self.csc = (np.searchsorted(Jc, np.arange(n + 1)), I[o], V[o])
    self.__class__ = ArrayProblemData


class _WithoutMatrix:
    """``pb`` seen with no columns, for the verbatim
    ``PresolveData.__init__`` to set up all but the nonzero counts."""

    acols = ()

    def __init__(self, pb):
        self._pb = pb

    def __getattr__(self, name):
        return getattr(self._pb, name)


def presolve_init(self, pb, options=None):
    """``PresolveData.__init__``; on an :class:`ArrayProblemData` the
    nonzero counts come from the pointers (``load`` keeps no zero)."""
    if type(pb) is not ArrayProblemData:
        return _VERBATIM_PRESOLVE_INIT(self, pb, options)
    _VERBATIM_PRESOLVE_INIT(self, _WithoutMatrix(pb), options)
    self.pb0 = pb
    self.nzrow = np.diff(pb.csr[0]).tolist()
    self.nzcol = np.diff(pb.csc[0]).tolist()


def native_matrix(pb):
    """The CSR and CSC arrays ``rp, rj, rv, cp, ci, cv`` that the verbatim
    ``presolve_native`` builds from ``pb``'s lists, from its arrays."""
    rowptr, colind, rval = pb.csr
    colptr, rowind, cval = pb.csc
    rp, rj, rv = rowptr.astype(np.int32), colind.astype(np.int32), rval
    cp, ci, cv = colptr.astype(np.int32), rowind.astype(np.int32), cval
    if rj.size == 0:
        rj = np.zeros(1, np.int32); rv = np.zeros(1, np.float64)
    if ci.size == 0:
        ci = np.zeros(1, np.int32); cv = np.zeros(1, np.float64)
    return rp, rj, rv, cp, ci, cv


def presolve_native(ps):
    """``presolve.native.presolve_native``; on an
    :class:`ArrayProblemData` its matrix goes to the engine from the
    arrays (:func:`native_matrix`). From the engine's call on, the
    verbatim function's statements."""
    pb = ps.pb0
    if type(pb) is not ArrayProblemData:
        return _VERBATIM_NATIVE(ps)
    lib = native._load()
    if lib is None:
        return None
    _I32P, _U8P, _F64P, _p = native._I32P, native._U8P, native._F64P, \
        native._p

    m, n = pb.ncon, pb.nvar
    rp, rj, rv, cp, ci, cv = native_matrix(pb)

    lrow = np.asarray(ps.lrow, np.float64)
    urow = np.asarray(ps.urow, np.float64)
    lcol = np.asarray(ps.lcol, np.float64)
    ucol = np.asarray(ps.ucol, np.float64)
    obj = np.asarray(ps.obj, np.float64)

    status = np.zeros(1, np.int32)
    sizes = np.zeros(5, np.int32)
    handle = lib.tlp_presolve_run(
        m, n, _p(rp, _I32P), _p(rj, _I32P), _p(rv, _F64P),
        _p(cp, _I32P), _p(ci, _I32P), _p(cv, _F64P),
        _p(lrow, _F64P), _p(urow, _F64P), _p(lcol, _F64P), _p(ucol, _F64P),
        _p(obj, _F64P), float(ps.obj0),
        float(ps.tol_pfeas), float(ps.tol_dfeas),
        _p(status, _I32P), _p(sizes, _I32P))
    if not handle:
        return None
    try:
        nrow_red, ncol_red, n_ops, oi_len, od_len = (int(v) for v in sizes)
        rowflag = np.zeros(m, np.uint8)
        colflag = np.zeros(n, np.uint8)
        obj0 = np.zeros(1, np.float64)
        oi = np.zeros(max(oi_len, 1), np.int32)
        od = np.zeros(max(od_len, 1), np.float64)
        cert_i = np.zeros(3, np.int32)
        cert_d = np.zeros(5, np.float64)
        lib.tlp_presolve_emit(
            handle, _p(rowflag, _U8P), _p(colflag, _U8P),
            _p(lrow, _F64P), _p(urow, _F64P), _p(lcol, _F64P),
            _p(ucol, _F64P), _p(obj, _F64P), _p(obj0, _F64P),
            _p(oi, _I32P), _p(od, _F64P), _p(cert_i, _I32P),
            _p(cert_d, _F64P))
    finally:
        lib.tlp_presolve_free(handle)

    # Write the final state back into the workspace.
    ps.rowflag = [bool(v) for v in rowflag]
    ps.colflag = [bool(v) for v in colflag]
    ps.lrow = lrow.tolist()
    ps.urow = urow.tolist()
    ps.lcol = lcol.tolist()
    ps.ucol = ucol.tolist()
    ps.obj = obj.tolist()
    ps.obj0 = float(obj0[0])
    ps.nrow = nrow_red
    ps.ncol = ncol_red
    ps.ops = native._decode_ops(n_ops, oi, od)
    ps.status = TerminationStatus(int(status[0]))
    ps.compute_index_mapping()

    # Certificates / empty-problem solution (presolve.py:137-169, 631-638).
    kind = int(cert_i[0])
    if kind == 0:
        sol = Solution(ps.nrow, ps.ncol)
        ps.solution = sol
        sol.primal_status = SolutionStatus.UNKNOWN
        sol.dual_status = SolutionStatus.INFEASIBILITY_CERTIFICATE
        sol.is_primal_ray = False
        sol.is_dual_ray = True
        sol.z_primal = sol.z_dual = float("inf")
        if int(cert_i[1]) >= 0:
            i_ = ps.new_con_idx[int(cert_i[1])]
            sol.y_lower[i_] = float(cert_d[0])
            sol.y_upper[i_] = float(cert_d[1])
        if int(cert_i[2]) >= 0:
            j_ = ps.new_var_idx[int(cert_i[2])]
            sol.s_lower[j_] = float(cert_d[2])
            sol.s_upper[j_] = float(cert_d[3])
    elif kind == 1:
        sol = Solution(ps.nrow, ps.ncol)
        ps.solution = sol
        sol.primal_status = SolutionStatus.INFEASIBILITY_CERTIFICATE
        sol.dual_status = SolutionStatus.UNKNOWN
        sol.is_primal_ray = True
        sol.is_dual_ray = False
        sol.z_primal = sol.z_dual = -float("inf")
        sol.x[ps.new_var_idx[int(cert_i[2])]] = float(cert_d[4])
    elif ps.status == TerminationStatus.OPTIMAL:
        sol = Solution(0, 0)
        ps.solution = sol
        sol.primal_status = SolutionStatus.OPTIMAL
        sol.dual_status = SolutionStatus.OPTIMAL
        sol.z_primal = ps.obj0
        sol.z_dual = ps.obj0

    return ps.status


def extract_reduced_arrays(self) -> ReducedArrays:
    """``PresolveData.extract_reduced_arrays``; on an
    :class:`ArrayProblemData` the original matrix comes from ``to_coo``
    (the verbatim ``fromiter`` order). From there on, the verbatim
    function's statements. On lists the verbatim function's ``fromiter``
    beats their ``to_coo``, so it runs as it is."""
    pb0 = self.pb0
    if type(pb0) is not ArrayProblemData:
        return _VERBATIM_EXTRACT(self)
    I, J, V = pb0.to_coo()

    rowflag = np.asarray(self.rowflag, bool)
    colflag = np.asarray(self.colflag, bool)
    keep = rowflag[I] & colflag[J] & (V != 0.0) if I.size else \
        np.zeros(0, bool)
    new_con = np.asarray(self.new_con_idx, np.int64)
    new_var = np.asarray(self.new_var_idx, np.int64)
    I2 = new_con[I[keep]]
    J2 = new_var[J[keep]]
    V2 = V[keep]

    nr, nc = len(self.old_con_idx), len(self.old_var_idx)
    rnorm = np.sqrt(np.bincount(I2, V2 * V2, minlength=nr)) if nr else \
        np.zeros(0)
    cnorm = np.sqrt(np.bincount(J2, V2 * V2, minlength=nc)) if nc else \
        np.zeros(0)
    rscale = np.sqrt(np.where(rnorm > 0, rnorm, 1.0))
    cscale = np.sqrt(np.where(cnorm > 0, cnorm, 1.0))
    V2 = V2 / (rscale[I2] * cscale[J2])

    ovi = np.asarray(self.old_var_idx, np.int64)
    oci = np.asarray(self.old_con_idx, np.int64)
    obj = np.asarray(self.obj)[ovi] if nc else np.zeros(0)
    obj0 = self.obj0
    if not self.objsense:
        obj = -obj
        obj0 = -obj0
    red = ReducedArrays(
        name=pb0.name,
        objsense=self.objsense,
        obj=obj / cscale,
        obj0=obj0,
        lcon=np.asarray(self.lrow)[oci] / rscale if nr else np.zeros(0),
        ucon=np.asarray(self.urow)[oci] / rscale if nr else np.zeros(0),
        lvar=np.asarray(self.lcol)[ovi] * cscale if nc else np.zeros(0),
        uvar=np.asarray(self.ucol)[ovi] * cscale if nc else np.zeros(0),
        I=I2, J=J2, V=V2)
    self.row_scaling = rscale
    self.col_scaling = cscale
    self.pb_red = red
    return red


# (owner, attribute, replacement): what tulip_tpu_torch/__init__.py puts on
# the verbatim classes and module. ArrayProblemData's own methods need no
# installing: only load makes one.
INSTALLED = (
    (ProblemData, "load", load),
    (PresolveData, "__init__", presolve_init),
    (PresolveData, "extract_reduced_arrays", extract_reduced_arrays),
    (native, "presolve_native", presolve_native),
)
