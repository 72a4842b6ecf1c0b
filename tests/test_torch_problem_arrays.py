"""A bulk-loaded problem's matrix in CSR/CSC arrays
(``tulip_tpu_torch/problem.py:ArrayProblemData``): every function of
``problem.py`` and ``presolve/`` that reads the arrays, and the
``ArrayProblemData`` a load makes, give the verbatim path's output bit for
bit; the first list read or mutation turns the problem back into plain
lists, once. The verbatim path is the JAX package's code (the functions
that ``problem.py`` and ``presolve/`` edit in place), run on the port's
module names, so it stays the verbatim code whatever the port edits."""

import enum
import struct
import types
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import tulip_tpu.presolve.native as jnative
import tulip_tpu.presolve.presolve as jpresolve
import tulip_tpu.problem as jproblem
import tulip_tpu_torch as tlt
from golden_large import staircase_lp
from test_fuzz import random_general_lp
from test_fuzz_xl import CONFIGS
from tulip_tpu_torch import problem
from tulip_tpu_torch import trace
from tulip_tpu_torch.presolve import native, presolve
from tulip_tpu_torch.presolve.presolve import PresolveData, postsolve
from tulip_tpu_torch.problem import INF, ArrayProblemData, ProblemData
from tulip_tpu_torch.solution import Solution
from tulip_tpu_torch.status import TerminationStatus

torch.set_num_threads(1)

DATA = Path(__file__).resolve().parent / "data"


def verbatim(fn, module):
    """The JAX package's ``fn`` run on the names of the port's
    ``module``: the verbatim code, with the port's classes and enums, so
    that its results compare with the port's by type."""
    return types.FunctionType(fn.__code__, vars(module), fn.__name__,
                              fn.__defaults__)


VERBATIM_LOAD = verbatim(jproblem.ProblemData.load, problem)
VERBATIM_PRESOLVE_INIT = verbatim(jpresolve.PresolveData.__init__, presolve)
VERBATIM_EXTRACT = verbatim(jpresolve.PresolveData.extract_reduced_arrays,
                            presolve)
VERBATIM_NATIVE = verbatim(jnative.presolve_native, native)


def same(a, b, path="value"):
    """``a`` and ``b`` hold the same bits: types, array dtypes, shapes
    and bytes, float bits, and so on through lists, dicts and objects."""
    assert type(a) is type(b), path
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), path
    elif isinstance(a, enum.Enum):
        assert a is b, path
    elif isinstance(a, float):
        assert struct.pack("<d", a) == struct.pack("<d", b), path
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for k, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{k}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            same(a[k], b[k], f"{path}[{k!r}]")
    elif hasattr(a, "__slots__"):
        for k in a.__slots__:
            same(getattr(a, k), getattr(b, k), f"{path}.{k}")
    elif hasattr(a, "__dict__"):
        same(vars(a), vars(b), path)
    else:
        assert a == b, path


def lp_args(pb):
    """``load``'s arguments holding ``pb``'s LP, its matrix from
    ``to_coo``."""
    return (pb.objsense, pb.obj, pb.obj0, pb.to_coo(), pb.lcon, pb.ucon,
            pb.lvar, pb.uvar)


def fuzz_lps():
    """The first 10 LPs of each configuration of the fuzz battery
    (``tests/test_fuzz_xl.py``'s seeds, the reference's generator)."""
    out = []
    for algo, presolve, dtype, _, _ in CONFIGS:
        rng = np.random.default_rng(
            zlib.crc32(f"{algo}-{presolve}-{dtype}".encode()))
        out += [lp_args(random_general_lp(rng).pbdata) for _ in range(10)]
    return out


def staircase(dense_cols=0, scrambled=False):
    """``staircase_lp(1024)`` as a canonical CSR's COO, or ``scrambled``:
    shuffled, each entry split in two and explicit zeros added."""
    A, b, c, u = staircase_lp(1024, dense_cols=dense_cols)
    coo = A.tocoo()
    I, J, V = coo.row, coo.col, coo.data
    if scrambled:
        rng = np.random.default_rng(1)
        w = rng.uniform(0.2, 0.8, V.size)
        I, J, V = (np.r_[I, I, I[:50]], np.r_[J, J, J[:50]],
                   np.r_[V * w, V * (1 - w), np.zeros(50)])
        o = rng.permutation(V.size)
        I, J, V = I[o], J[o], V[o]
    return (True, c, 0.0, (I, J, V), b, b, np.zeros(A.shape[1]), u)


def mps_lps():
    """``tests/data/*.mps``, read and then re-loaded from their COO."""
    return [lp_args(tlt.read_mps(str(p)))
            for p in sorted(DATA.glob("*.mps"))]


def edge_lps():
    """Duplicates summing to zero or not, explicit zeros, empty rows and
    columns, an all-zero matrix, m = 0, n = 0, nothing at all."""
    dup = ([0, 0, 2, 2, 1, 0, 2], [1, 1, 3, 0, 3, 3, 0],
           [1.0, 2.0, 0.5, 4.0, 0.0, -1.5, -4.0])
    return [
        (True, [1.0, -1.0, 0.5, 2.0, 0.0], 1.5, dup, [0.0, -INF, 1.0],
         [1.0, 2.0, 1.0], [0.0] * 5, [3.0, 3.0, INF, 1.0, 1.0]),
        (False, [1.0, 2.0], 0.0, ([0, 1], [0, 1], [0.0, 0.0]),
         [0.0, -1.0], [1.0, 1.0], [0.0, -INF], [1.0, INF]),
        (True, [1.0, 2.0], 0.0, ([], [], []), [], [], [0.0, 0.0],
         [1.0, 1.0]),
        (True, [], 0.0, ([], [], []), [-1.0, 0.0], [1.0, 0.0], [], []),
        (True, [], 0.0, ([], [], []), [], [], [], []),
    ]


GROUPS = {"fuzz": fuzz_lps, "staircase": lambda: [staircase()],
          "staircase-link": lambda: [staircase(dense_cols=2)],
          "staircase-scrambled": lambda: [staircase(scrambled=True)],
          "mps": mps_lps, "edge": edge_lps}


def lps_of(group):
    return GROUPS[group]()


def verbatim_pb(args):
    pb = ProblemData()
    VERBATIM_LOAD(pb, *args)
    return pb


def verbatim_ps(pb):
    """``PresolveData(pb)`` by the verbatim ``__init__``."""
    ps = PresolveData.__new__(PresolveData)
    VERBATIM_PRESOLVE_INIT(ps, pb)
    return ps


def array_pb(args):
    pb = ProblemData()
    pb.load(*args)
    assert type(pb) is ArrayProblemData
    return pb


def outcome(fn, *args):
    """``fn(*args)``, or the type and message of what it raised."""
    try:
        return fn(*args)
    except Exception as e:  # noqa: BLE001 - compared, not handled
        return type(e).__name__, str(e)


def workspace_state(ps):
    """A PresolveData's fields but its original problem."""
    return {k: v for k, v in vars(ps).items() if k != "pb0"}


def check_load(args):
    """``load``: the lists that the arrays build, ``to_coo``, ``nnz``,
    ``to_dense`` and every other field."""
    pv, pb = verbatim_pb(args), array_pb(args)
    same(pb.to_coo(), pv.to_coo())
    assert pb.nnz == pv.nnz
    same(pb.to_dense(), pv.to_dense())
    with trace.call("lists") as rec:
        pb.build_lists()
    assert rec.record["counters"] == {"problem_lists_built": 1}
    same(vars(pb), vars(pv))


def check_presolve_init(args):
    """``PresolveData.__init__``: the nonzero counts and every other
    field of the workspace."""
    pv, pb = verbatim_pb(args), array_pb(args)
    same(workspace_state(PresolveData(pb)), workspace_state(verbatim_ps(pv)))
    assert type(pb) is ArrayProblemData


def check_presolve_native(args, monkeypatch):
    """``presolve_native``: every array handed to the engine (the CSR
    and CSC inputs, bounds, objective, output buffers), its status and
    the workspace it leaves."""
    assert native.native_available()
    handed = []
    p = native._p

    def record(a, tp):
        handed.append(a.copy())
        return p(a, tp)

    monkeypatch.setattr(native, "_p", record)
    runs = []
    for ps, fn in ((verbatim_ps(verbatim_pb(args)), VERBATIM_NATIVE),
                   (PresolveData(array_pb(args)), native.presolve_native)):
        handed.clear()
        runs.append((outcome(fn, ps), list(handed), workspace_state(ps)))
    assert len(runs[0][1]) >= 13
    same(runs[1], runs[0])


def presolved(pb, verbatim_code=False):
    """``pb`` after the native presolve: the verbatim workspace and pass,
    or the port's."""
    if verbatim_code:
        ps = verbatim_ps(pb)
        assert VERBATIM_NATIVE(ps) is not None
    else:
        ps = PresolveData(pb)
        assert native.presolve_native(ps) is not None
    return ps


def check_extract(args):
    """``extract_reduced_arrays``, on a loaded problem's arrays and on
    the verbatim lists: the reduced problem's fields and the scalings
    postsolve reads."""
    reds = []
    for pb, fn in ((verbatim_pb(args), VERBATIM_EXTRACT),
                   (verbatim_pb(args), PresolveData.extract_reduced_arrays),
                   (array_pb(args), PresolveData.extract_reduced_arrays)):
        ps = presolved(pb, verbatim_code=fn is VERBATIM_EXTRACT)
        red = outcome(fn, ps)
        reds.append((red if isinstance(red, tuple) else vars(red),
                     ps.row_scaling, ps.col_scaling))
    same(reds[1], reds[0])
    same(reds[2], reds[0])


PARITY = {"load": check_load, "__init__": check_presolve_init,
          "presolve_native": check_presolve_native,
          "extract_reduced_arrays": check_extract}


@pytest.mark.parametrize("group", list(GROUPS))
@pytest.mark.parametrize("name", ["load", "__init__", "extract_reduced_arrays",
                                  "presolve_native"])
def test_array_path_gives_the_verbatim_bits(name, group, monkeypatch):
    check = PARITY[name]
    for args in lps_of(group):
        if check is check_presolve_native:
            check(args, monkeypatch)
        else:
            check(args)


@pytest.mark.parametrize("group", list(GROUPS))
def test_postsolve_gives_the_verbatim_solution(group):
    """Postsolve reads the original matrix through ``to_coo``: a reduced
    solution (presolve's own, or seeded values) maps to the same bits."""
    for k, args in enumerate(lps_of(group)):
        sols = []
        for pb in (verbatim_pb(args), array_pb(args)):
            ref = type(pb) is ProblemData
            ps = presolved(pb, verbatim_code=ref)
            if ps.status == TerminationStatus.UNKNOWN:
                (VERBATIM_EXTRACT if ref else
                 PresolveData.extract_reduced_arrays)(ps)
                rng = np.random.default_rng(k)
                inner = Solution(ps.nrow, ps.ncol)
                for f in ("x", "y_lower", "y_upper", "s_lower", "s_upper"):
                    getattr(inner, f)[:] = rng.standard_normal(
                        getattr(inner, f).size)
            else:
                inner = ps.solution
            sol = Solution(pb.ncon, pb.nvar)
            postsolve(sol, inner, ps)
            sols.append(sol)
        same(sols[1], sols[0])


def incremental_pb(args):
    """The LP of ``args`` built by ``add_variable`` and ``add_constraint``
    from the verbatim load's rows."""
    rows = verbatim_pb(args)
    pb = ProblemData()
    for j in range(rows.nvar):
        pb.add_variable((), (), rows.obj[j], rows.lvar[j], rows.uvar[j])
    for i, row in enumerate(rows.arows):
        pb.add_constraint(row.nzind, row.nzval, rows.lcon[i], rows.ucon[i])
    pb.objsense, pb.obj0 = rows.objsense, rows.obj0
    return pb


def solved(pb, level, engine):
    m = tlt.Model(device="cpu")
    m.pbdata = pb
    m.params.Presolve.Level = level
    m.params.Presolve.Engine = engine
    with trace.call("solve") as rec:
        st = m.optimize()
    return (st, m.barrier_iterations, vars(m.solution)), \
        rec.record["counters"].get("problem_lists_built", 0)


@pytest.mark.parametrize("group,level,engine", [
    ("fuzz", 1, "native"), ("fuzz", 1, "python"), ("fuzz", 0, "native"),
    ("staircase", 1, "native")])
def test_optimize_of_a_loaded_lp_equals_the_incremental_one(group, level,
                                                           engine):
    """``Model.optimize()`` answers with the same bits whether the LP
    came through ``load`` (arrays) or the incremental API (lists). The
    lists are built at most once: where the Python presolve engine reads
    them, or where presolve finds the LP infeasible
    (``upgrade_if_both_infeasible`` reads them); never on the way to an
    optimum with the native engine."""
    for args in lps_of(group)[:20]:
        want, built = solved(incremental_pb(args), level, engine)
        assert built == 0
        got, built = solved(array_pb(args), level, engine)
        same(got, want)
        assert built <= 1
        if engine == "native" and got[0] == TerminationStatus.OPTIMAL:
            assert built == 0


MUTATIONS = {
    "add_constraint": lambda pb: pb.add_constraint([0, 2], [1.0, 2.0],
                                                   0.0, 1.0),
    "add_variable": lambda pb: pb.add_variable([0, 1], [1.5, -1.0], 1.0,
                                               0.0, 2.0),
    "delete_constraint": lambda pb: pb.delete_constraint(1),
    "delete_constraints": lambda pb: pb.delete_constraints([0, 2]),
    "delete_variable": lambda pb: pb.delete_variable(1),
    "delete_variables": lambda pb: pb.delete_variables([0, 3]),
    "set_coefficient": lambda pb: (pb.set_coefficient(0, 1, 0.0),
                                   pb.set_coefficient(2, 4, 5.0)),
    "get_coefficient": lambda pb: pb.get_coefficient(2, 3),
}


@pytest.mark.parametrize("name", list(MUTATIONS))
def test_mutation_after_load_builds_the_lists_once(name):
    """A mutator (or a list read) after ``load`` acts on the lists the
    verbatim load builds; the arrays go at the first list read, which is
    counted once."""
    args = edge_lps()[0]
    pv, pb = verbatim_pb(args), array_pb(args)
    with trace.call("mutate") as rec:
        same(MUTATIONS[name](pb), MUTATIONS[name](pv))
        assert type(pb) is ProblemData and not hasattr(pb, "csr")
        pb.add_constraint([1], [3.0], -1.0, 1.0)
        pv.add_constraint([1], [3.0], -1.0, 1.0)
    assert rec.record["counters"] == {"problem_lists_built": 1}
    same(vars(pb), vars(pv))
    same(pb.to_coo(), pv.to_coo())


def test_a_reload_keeps_arrays_and_a_subclass_keeps_lists():
    """Loading an array-backed problem again builds no lists; a subclass
    of ``ProblemData`` is loaded by the verbatim ``load``."""
    first, second = edge_lps()[0], edge_lps()[1]

    class Sub(ProblemData):
        pass

    with trace.call("reload") as rec:
        pb = array_pb(first)
        pb.load(*second)
        sub = Sub()
        sub.load(*second)
    assert "problem_lists_built" not in rec.record["counters"]
    assert type(pb) is ArrayProblemData and type(sub) is Sub
    same(pb.to_coo(), verbatim_pb(second).to_coo())
    same(vars(sub), vars(verbatim_pb(second)))
