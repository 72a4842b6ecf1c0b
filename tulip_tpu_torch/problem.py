"""Host-side problem storage with an incremental mutation API.

Canonical form (reference: src/problemData.jl:26-68)::

    min / max   c'x + c0
    s.t.        lr <= A x <= ur
                lc <=   x <= uc

The constraint matrix is stored redundantly as both a list of sparse rows and
a list of sparse columns (reference: src/problemData.jl:43-44) — this is a
host-side, pointer-chasing structure by design; device arrays are only built
at standard-form extraction time (:mod:`tulip_tpu.ipm.data`).

Unlike the reference, :meth:`ProblemData.load` keeps the deduplicated
matrix in CSR and CSC arrays and makes the instance an
:class:`ArrayProblemData`:

- ``csr = (rowptr, colind, val)``: the column indices sorted within each
  row, the entries and order of the lists' ``arows``;
- ``csc = (colptr, rowind, val)``: the row indices sorted within each
  column, those of ``acols``.

The first read or assignment of ``arows`` or ``acols`` (the Python presolve
rules, ``get_coefficient``, every mutator) builds the lists as the list
path of ``load`` does, counts ``problem_lists_built`` in the open call
record, drops the arrays and turns the instance back into a plain
``ProblemData``. A problem built through the incremental API or an MPS
reader never has arrays. The readers of the matrix on ``Model.optimize``'s
path (``to_coo``, ``nnz``, ``PresolveData.__init__``, ``presolve_native``,
``extract_reduced_arrays``) read the arrays when they exist, and give the
lists' output bit for bit.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import trace

INF = float("inf")


class SparseAxis:
    """One sparse row or column: parallel index/value lists
    (reference: src/problemData.jl:3-6 ``RowOrCol``)."""

    __slots__ = ("nzind", "nzval")

    def __init__(self, nzind: Optional[List[int]] = None,
                 nzval: Optional[List[float]] = None):
        self.nzind: List[int] = list(nzind) if nzind else []
        self.nzval: List[float] = list(nzval) if nzval else []

    def __len__(self) -> int:
        return len(self.nzind)

    def items(self):
        return zip(self.nzind, self.nzval)

    def get(self, idx: int, default: float = 0.0) -> float:
        for i, v in self.items():
            if i == idx:
                return v
        return default

    def set(self, idx: int, val: float, drop_zero: bool = True) -> None:
        for k, i in enumerate(self.nzind):
            if i == idx:
                if val == 0.0 and drop_zero:
                    del self.nzind[k]
                    del self.nzval[k]
                else:
                    self.nzval[k] = val
                return
        if val != 0.0 or not drop_zero:
            self.nzind.append(idx)
            self.nzval.append(val)

    def drop(self, idx: int) -> None:
        for k, i in enumerate(self.nzind):
            if i == idx:
                del self.nzind[k]
                del self.nzval[k]
                return


class ProblemData:
    """Mutable LP model data (reference: src/problemData.jl:26-68)."""

    def __init__(self, name: str = ""):
        self.name = name
        self.ncon = 0
        self.nvar = 0

        self.objsense = True  # True = minimize (reference: problemData.jl:33)
        self.obj: List[float] = []
        self.obj0 = 0.0

        self.arows: List[SparseAxis] = []
        self.acols: List[SparseAxis] = []

        self.lcon: List[float] = []
        self.ucon: List[float] = []
        self.lvar: List[float] = []
        self.uvar: List[float] = []

        self.con_names: List[str] = []
        self.var_names: List[str] = []

    # ------------------------------------------------------------------
    # Queries
    # ------------------------------------------------------------------
    @property
    def nnz(self) -> int:
        return sum(len(c) for c in self.acols)

    def get_coefficient(self, i: int, j: int) -> float:
        return self.arows[i].get(j)

    # ------------------------------------------------------------------
    # Incremental construction (reference: src/problemData.jl:137-261)
    # ------------------------------------------------------------------
    def add_constraint(self, colids: Sequence[int], colvals: Sequence[float],
                       lb: float, ub: float, name: str = "",
                       issorted: bool = False) -> int:
        """Append a row; returns its index
        (reference: src/problemData.jl:137-190)."""
        if len(colids) != len(colvals):
            raise ValueError("colids and colvals must have equal length")
        for j in colids:
            if not (0 <= j < self.nvar):
                raise IndexError(f"column index {j} out of range")
        i = self.ncon
        self.ncon += 1
        self.lcon.append(float(lb))
        self.ucon.append(float(ub))
        self.con_names.append(name)
        row = SparseAxis()
        # Combine duplicates, drop numerical zeros.
        acc: Dict[int, float] = {}
        for j, v in zip(colids, colvals):
            acc[j] = acc.get(j, 0.0) + float(v)
        for j in (sorted(acc) if not issorted else acc):
            v = acc[j]
            if v != 0.0:
                row.nzind.append(j)
                row.nzval.append(v)
                self.acols[j].nzind.append(i)
                self.acols[j].nzval.append(v)
        self.arows.append(row)
        return i

    def add_variable(self, rowids: Sequence[int] = (),
                     rowvals: Sequence[float] = (), obj: float = 0.0,
                     lb: float = -INF, ub: float = INF, name: str = "",
                     ) -> int:
        """Append a column; returns its index
        (reference: src/problemData.jl:207-261)."""
        if len(rowids) != len(rowvals):
            raise ValueError("rowids and rowvals must have equal length")
        for i in rowids:
            if not (0 <= i < self.ncon):
                raise IndexError(f"row index {i} out of range")
        j = self.nvar
        self.nvar += 1
        self.obj.append(float(obj))
        self.lvar.append(float(lb))
        self.uvar.append(float(ub))
        self.var_names.append(name)
        col = SparseAxis()
        acc: Dict[int, float] = {}
        for i, v in zip(rowids, rowvals):
            acc[i] = acc.get(i, 0.0) + float(v)
        for i in sorted(acc):
            v = acc[i]
            if v != 0.0:
                col.nzind.append(i)
                col.nzval.append(v)
                self.arows[i].nzind.append(j)
                self.arows[i].nzval.append(v)
        self.acols.append(col)
        return j

    @trace.call("load")
    def load(self, objsense: bool, obj: Sequence[float], obj0: float,
             A_coo: Tuple[Sequence[int], Sequence[int], Sequence[float]],
             lcon: Sequence[float], ucon: Sequence[float],
             lvar: Sequence[float], uvar: Sequence[float],
             con_names: Optional[Sequence[str]] = None,
             var_names: Optional[Sequence[str]] = None,
             name: str = "") -> None:
        """Bulk-load a problem, replacing current contents
        (reference: src/problemData.jl:268-317).

        A ``ProblemData`` keeps the matrix in arrays and becomes an
        :class:`ArrayProblemData`; a subclass gets the lists."""
        if type(self) is ArrayProblemData:  # a reload: no lists to build
            del self.csr, self.csc
            self.__class__ = ProblemData
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

        # Vectorized sparse assembly: drop zero inputs, sum duplicates,
        # drop zero sums, build per-row (sorted by column) and per-column
        # (sorted by row) index/value lists by boundary slicing — same
        # result as per-entry add_constraint, O(nnz log nnz) numpy.
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

        if type(self) is ProblemData:
            # (I, J, V) is sorted by (i, j); the lists' lexsort sorts by
            # (j, i).
            o = np.lexsort((I, J))
            Jc = J[o]
            del self.arows, self.acols
            self.csr = (np.searchsorted(I, np.arange(m + 1)), J, V)
            self.csc = (np.searchsorted(Jc, np.arange(n + 1)), I[o], V[o])
            self.__class__ = ArrayProblemData
            return
        self.arows = [SparseAxis() for _ in range(m)]
        self.acols = [SparseAxis() for _ in range(n)]
        if I.size:
            # (I, J, V) is sorted by (i, j): slice rows directly.
            Jl, Vl = J.tolist(), V.tolist()
            rowptr = np.searchsorted(I, np.arange(m + 1))
            for i in range(m):
                s, e = rowptr[i], rowptr[i + 1]
                if s < e:
                    self.arows[i] = SparseAxis.__new__(SparseAxis)
                    self.arows[i].nzind = Jl[s:e]
                    self.arows[i].nzval = Vl[s:e]
            o = np.lexsort((I, J))
            Ic, Jc, Vc = I[o], J[o], V[o]
            Il, Vcl = Ic.tolist(), Vc.tolist()
            colptr = np.searchsorted(Jc, np.arange(n + 1))
            for j in range(n):
                s, e = colptr[j], colptr[j + 1]
                if s < e:
                    self.acols[j] = SparseAxis.__new__(SparseAxis)
                    self.acols[j].nzind = Il[s:e]
                    self.acols[j].nzval = Vcl[s:e]

    # ------------------------------------------------------------------
    # Deletion / modification (reference: src/problemData.jl:328-490)
    # ------------------------------------------------------------------
    def delete_constraint(self, i: int) -> None:
        if not (0 <= i < self.ncon):
            raise IndexError(f"row index {i} out of range")
        for j in self.arows[i].nzind:
            self.acols[j].drop(i)
        del self.arows[i]
        del self.lcon[i]
        del self.ucon[i]
        del self.con_names[i]
        self.ncon -= 1
        # Shift row indices in columns.
        for col in self.acols:
            col.nzind = [r - 1 if r > i else r for r in col.nzind]

    def delete_constraints(self, idxs: Sequence[int]) -> None:
        for i in sorted(idxs, reverse=True):
            self.delete_constraint(i)

    def delete_variable(self, j: int) -> None:
        if not (0 <= j < self.nvar):
            raise IndexError(f"column index {j} out of range")
        for i in self.acols[j].nzind:
            self.arows[i].drop(j)
        del self.acols[j]
        del self.obj[j]
        del self.lvar[j]
        del self.uvar[j]
        del self.var_names[j]
        self.nvar -= 1
        for row in self.arows:
            row.nzind = [c - 1 if c > j else c for c in row.nzind]

    def delete_variables(self, idxs: Sequence[int]) -> None:
        for j in sorted(idxs, reverse=True):
            self.delete_variable(j)

    def set_coefficient(self, i: int, j: int, v: float) -> None:
        """Set A[i, j] = v, dropping the entry when v == 0
        (reference: src/problemData.jl:451-490)."""
        if not (0 <= i < self.ncon and 0 <= j < self.nvar):
            raise IndexError("index out of range")
        self.arows[i].set(j, float(v))
        self.acols[j].set(i, float(v))

    # ------------------------------------------------------------------
    # Dense / COO export (host-side; device arrays built in ipm.data)
    # ------------------------------------------------------------------
    def to_coo(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        I, J, V = [], [], []
        for j, col in enumerate(self.acols):
            for i, v in col.items():
                I.append(i)
                J.append(j)
                V.append(v)
        return (np.asarray(I, dtype=np.int64),
                np.asarray(J, dtype=np.int64),
                np.asarray(V, dtype=np.float64))

    def to_dense(self, dtype=np.float64) -> np.ndarray:
        A = np.zeros((self.ncon, self.nvar), dtype=dtype)
        I, J, V = self.to_coo()
        A[I, J] = V
        return A


class ArrayProblemData(ProblemData):
    """A ``ProblemData`` whose matrix is still in the arrays ``csr`` and
    ``csc`` that ``load`` left; :meth:`build_lists` makes it a plain
    ``ProblemData`` again."""

    def build_lists(self) -> ProblemData:
        """Build ``arows`` and ``acols`` from the arrays as the list path
        of ``load`` does, drop the arrays and return the plain instance."""
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
        """The list ``to_coo``'s arrays: column by column, rows
        ascending."""
        colptr, rowind, val = self.csc
        J = np.repeat(np.arange(self.nvar, dtype=np.int64), np.diff(colptr))
        return rowind.copy(), J, val.copy()


def _axes(ptr, idx, val):
    """One ``SparseAxis`` per slice ``ptr[k]:ptr[k + 1]`` (the lists of
    ``load``)."""
    il, vl = idx.tolist(), val.tolist()
    axes = []
    for k in range(ptr.size - 1):
        s, e = ptr[k], ptr[k + 1]
        ax = SparseAxis()
        if s < e:
            ax.nzind, ax.nzval = il[s:e], vl[s:e]
        axes.append(ax)
    return axes
