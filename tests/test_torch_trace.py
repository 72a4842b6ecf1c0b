"""The port's call records and spans (``tulip_tpu_torch.trace``): how
records nest and are kept, what they may hold, when spans reach
torch.profiler, and what ``Model.optimize`` and ``batch_linprog`` record.
CPU tests, and one marked ``cuda`` that profiles the card (run there with
``python -m pytest tests/test_torch_trace.py -o addopts="" --noconftest
-p no:xdist``)."""

import collections
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tulip_tpu_torch as tlt
from tulip_tpu_torch import model as tmodel
from tulip_tpu_torch import trace
from tulip_tpu_torch.status import TerminationStatus

torch.set_num_threads(1)

DATA = Path(__file__).resolve().parent / "data"
# The top-level spans of a batch_linprog record: they do not overlap.
BATCH_TOP = ("load", "presolve", "standard_form", "stack", "ipm", "results")


@pytest.fixture
def calls(monkeypatch):
    """A fresh, empty CALLS for the test."""
    fresh = collections.deque(maxlen=trace.CALLS.maxlen)
    monkeypatch.setattr(trace, "CALLS", fresh)
    return fresh


def random_lps(k, m, n, seed):
    """``k`` feasible LPs min cᵀx, A x = b, 0 ≤ x ≤ u as scipy dicts."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        A = rng.standard_normal((m, n))
        u = rng.uniform(1.0, 4.0, n)
        b = A @ (u * rng.uniform(0.2, 0.8, n))
        out.append(dict(c=rng.standard_normal(n), A_eq=A, b_eq=b,
                        bounds=[(0.0, float(v)) for v in u]))
    return out


def staircase(m, seed=0, mr=16, nc=24):
    """A staircase equality LP (stage blocks coupled to the next) as COO
    triplets, b, c, u."""
    rng = np.random.default_rng(seed)
    stages = m // mr
    n = (stages + 1) * nc
    I, J = [], []
    for s in range(stages):
        for c0 in (s * nc, (s + 1) * nc):
            ii, jj = np.meshgrid(np.arange(s * mr, (s + 1) * mr),
                                 np.arange(c0, c0 + nc), indexing="ij")
            I.append(ii.ravel())
            J.append(jj.ravel())
    I, J = np.concatenate(I), np.concatenate(J)
    V = rng.standard_normal(I.size)
    u = rng.uniform(1, 3, n)
    x0 = u * rng.uniform(0.3, 0.7, n)
    b = np.bincount(I, V * x0[J], minlength=m)
    return (I, J, V), b, rng.standard_normal(n), u


def leaves(tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield k
            yield from leaves(v)
    else:
        yield tree


def test_nested_call_adds_to_the_outer_record(calls):
    with trace.call("outer") as outer:
        with trace.span("a"):
            pass
        with trace.call("inner") as inner:
            with trace.span("b"):
                pass
            with trace.span("a"):
                pass
            trace.count("k", 2)
        trace.count("k")
    assert len(calls) == 1
    rec = calls[0]
    assert rec["entry"] == "outer" and inner.record is rec
    assert rec["times"] == {"a": 2, "b": 1}
    assert rec["counters"] == {"k": 3}
    assert set(inner.spans()) == {"a", "b"}
    assert set(outer.spans()) == {"a", "b"}
    assert inner.spans()["a"] < rec["spans"]["a"]
    assert sum(rec["spans"].values()) <= rec["wall_s"]


def test_records_come_in_order_and_the_oldest_go(calls):
    for i in range(calls.maxlen + 6):
        with trace.call("c"):
            trace.count("i", i)
    assert len(calls) == calls.maxlen == 1024
    assert [r["counters"].get("i", 0) for r in calls] == \
        list(range(6, calls.maxlen + 6))
    t0 = [r["t0_ns"] for r in calls]
    assert t0 == sorted(t0)


def test_spans_and_counts_outside_a_call_record_nothing(calls):
    with trace.span("x") as sp:
        trace.count("y")
    assert not calls and sp.s >= 0.0


def test_a_decorated_function_opens_a_record_each_call(calls):
    @trace.call("f")
    def f(x):
        with trace.span("body"):
            return x + 1

    assert f(1) == 2 and f(2) == 3
    assert [r["times"] for r in calls] == [{"body": 1}, {"body": 1}]
    assert f.__name__ == "f"


def test_spans_enter_the_profiler_only_while_it_runs(calls, monkeypatch):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.call("c"):
            with trace.span("traced_span"):
                torch.ones(3).sum()
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("traced_span") == 1

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with trace.call("c"):
        with trace.span("untraced_span"):
            pass
    assert calls[-1]["times"] == {"untraced_span": 1}


def test_bulk_load_is_a_call_record(calls):
    coo, b, c, u = staircase(64)
    pb = tlt.ProblemData()
    pb.load(True, c, 0.0, coo, b, b, np.zeros(u.size), u)
    assert [r["entry"] for r in calls] == ["load"]
    assert calls[0]["wall_s"] > 0 and pb.nnz == coo[0].size


@pytest.mark.parametrize("presolve,sparse_first", [(1, False), (0, False),
                                                   (1, True)],
                         ids=["presolve", "no-presolve", "sparse-first"])
def test_model_timings_are_the_records_spans(calls, presolve, sparse_first):
    """Model.timings keeps the reference's keys; each is the sum of the
    call record's spans that ``model._TIMINGS`` names."""
    coo, b, c, u = staircase(128)
    m = tlt.Model(device="cpu")
    m.pbdata.load(True, c, 0.0, coo, b, b, np.zeros(u.size), u)
    m.params.Presolve.Level = presolve
    m.params.KKT.SparseFirst = sparse_first
    assert m.optimize() == TerminationStatus.OPTIMAL
    rec = calls[-1]
    assert [r["entry"] for r in calls] == ["load", "optimize"]
    want = {"standard_form", "ipm", "extract"}
    if presolve:
        want |= {"presolve", "postsolve"}
    assert set(m.timings) == want
    for key, value in m.timings.items():
        assert value == pytest.approx(
            sum(rec["spans"].get(n, 0.0) for n in tmodel._TIMINGS[key]),
            rel=1e-12)
    spans = rec["spans"]
    assert ("sparse_first" in spans) == sparse_first
    if sparse_first:
        # At this size the plan refuses the tiles after its level plan,
        # and the dense standard form follows.
        steps = [k for k in spans if k.startswith("sparse_first/")]
        assert steps == ["sparse_first/coo", "sparse_first/csr",
                         "sparse_first/dense_cols", "sparse_first/level_plan"]
        assert sum(spans[k] for k in steps) <= spans["sparse_first"]
        assert "standard_form" in spans
    if presolve:
        assert spans["presolve/native"] + spans["presolve/reduce"] <= \
            spans["presolve"]
    assert rec["counters"]["passes"] >= m.barrier_iterations
    assert rec["counters"]["host_reads"] >= 1
    assert all(isinstance(x, (str, int, float)) for x in leaves(rec))
    assert m.solve_time >= rec["wall_s"]


def test_loaded_problem_is_solved_without_its_lists(calls):
    """An optimize of a bulk-loaded ``staircase_lp(1024)`` reads its
    matrix from the load's arrays: ``problem_lists_built`` stays 0 in the
    ``load`` and ``optimize`` records, and the spans that ``load_s``,
    ``prep_s`` and ``post_s`` read keep their names."""
    from golden_large import staircase_lp

    A, b, c, u = staircase_lp(1024)
    coo = A.tocoo()
    m = tlt.Model(device="cpu")
    m.pbdata.load(True, c, 0.0, (coo.row, coo.col, coo.data), b, b,
                  np.zeros(u.size), u)
    assert m.optimize() == TerminationStatus.OPTIMAL
    assert [r["entry"] for r in calls] == ["load", "optimize"]
    assert all(r["counters"].get("problem_lists_built", 0) == 0
               for r in calls)
    assert {"presolve_setup", "presolve", "presolve/native",
            "presolve/reduce", "postsolve"} <= set(calls[-1]["spans"])


def test_level_plan_counts_its_block_pairs(calls, monkeypatch):
    """A sparse-first optimize of a bulk-loaded ``staircase_lp(1024)``
    counts the K pattern's block coordinates handed to the level plan's
    order (``level_plan/entries``) and the distinct block pairs passed on
    (``level_plan/block_pairs``), as numpy counts them, the pattern's
    distinct columns (``level_plan/col_patterns``); the plan's spans and
    ``problem_lists_built`` are unchanged."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    from golden_large import staircase_lp
    from tulip_tpu_torch.kkt import sparse as tsparse

    patterns = []
    plan = tsparse.k1_level_plan_pattern

    def recording(pattern, shape, block, *args, **kwargs):
        patterns.append((pattern.copy(), shape, block))
        return plan(pattern, shape, block, *args, **kwargs)

    monkeypatch.setattr(tsparse, "k1_level_plan_pattern", recording)
    A, b, c, u = staircase_lp(1024)
    coo = A.tocoo()
    m = tlt.Model(device="cpu")
    m.pbdata.load(True, c, 0.0, (coo.row, coo.col, coo.data), b, b,
                  np.zeros(u.size), u)
    m.params.KKT.SparseFirst = True
    assert m.optimize() == TerminationStatus.OPTIMAL
    rec = calls[-1]
    assert [r["entry"] for r in calls] == ["load", "optimize"]

    (pattern, shape, block), = patterns
    K = sp.csr_matrix(pattern @ pattern.T)
    perm = np.asarray(reverse_cuthill_mckee(K, symmetric_mode=True))
    Kp = K[perm][:, perm].tocoo()
    nbr = -(-shape[0] // block)
    pairs = np.unique((Kp.row // block).astype(np.int64) * nbr
                      + Kp.col // block).size
    counters = rec["counters"]
    assert counters["level_plan/entries"] == Kp.nnz
    assert counters["level_plan/block_pairs"] == pairs
    assert counters["level_plan/col_patterns"] == \
        np.unique(pattern.toarray().T, axis=0).shape[0]
    assert Kp.nnz > pairs > 0
    # At this size the plan refuses the tiles after its level plan.
    assert [k for k in rec["times"] if k.startswith("sparse_first/")] == [
        "sparse_first/coo", "sparse_first/csr", "sparse_first/dense_cols",
        "sparse_first/level_plan"]
    assert all(r["counters"].get("problem_lists_built", 0) == 0
               for r in calls)


def test_sparse_first_plan_steps_are_spans(calls):
    from tulip_tpu_torch.ipm.sparse_data import sparse_lp_data_from_problem

    coo, b, c, u = staircase(2048, mr=64, nc=96)
    pb = tlt.ProblemData()
    pb.load(True, c, 0.0, coo, b, b, np.zeros(u.size), u)
    with trace.call("plan"):
        assert sparse_lp_data_from_problem(pb, device="cpu") is not None
    assert calls[-1]["times"] == {f"sparse_first/{k}": 1 for k in (
        "coo", "csr", "dense_cols", "level_plan", "row_blocks",
        "col_blocks")}


def test_batch_linprog_record(calls):
    probs = random_lps(5, 4, 8, seed=1) + random_lps(3, 20, 40, seed=2)
    # No rows and a positive cost: presolve decides it (x = 0).
    probs.append(dict(c=np.ones(3), bounds=[(0.0, 1.0)] * 3))
    res = tlt.batch_linprog(probs, device="cpu", dtype="float64")
    assert [r.status for r in res] == [0] * len(probs)
    rec = calls[-1]
    assert [r["entry"] for r in calls] == ["batch_linprog"]
    counters = rec["counters"]
    assert (counters["problems"], counters["decided_by_presolve"],
            counters["buckets"]) == (9, 1, 2)
    times = rec["times"]
    assert times["load"] == times["presolve"] == 9
    assert times["standard_form"] == 8
    assert times["stack"] == times["ipm"] == 2
    assert times["results"] == 1
    assert times["extract"] == times["postsolve"] == 8
    assert sum(rec["spans"][k] for k in BATCH_TOP) <= rec["wall_s"]
    assert rec["spans"]["extract"] + rec["spans"]["postsolve"] <= \
        rec["spans"]["results"]
    assert all(isinstance(x, (str, int, float)) for x in leaves(rec))


def test_profile_dir_trace_shows_the_host_phases(tmp_path):
    m = tlt.Model(device="cpu")
    m.pbdata = tlt.read_mps(str(DATA / "lp_opt.mps"))
    m.params.ProfileDir = str(tmp_path)
    assert m.optimize() == TerminationStatus.OPTIMAL
    events = json.loads((tmp_path / "ipm_trace.json").read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert {"presolve_setup", "presolve", "presolve/reduce",
            "standard_form", "ipm", "extract", "postsolve"} <= names


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _batch_request():
    tlt.batch_linprog(random_lps(16, 48, 96, seed=3), device="cuda",
                      dtype="float32")


def _optimize_request():
    coo, b, c, u = staircase(2048, mr=64, nc=96)
    m = tlt.Model(device="cuda")
    m.pbdata.load(True, c, 0.0, coo, b, b, np.zeros(u.size), u)
    m.params.KKT.SparseFirst = True
    assert m.optimize() == TerminationStatus.OPTIMAL


@pytest.mark.cuda
@pytest.mark.parametrize("entry,request_", [
    ("batch_linprog", _batch_request),
    ("model_optimize", _optimize_request)], ids=["linprog", "optimize"])
def test_device_work_is_under_the_entrys_span_names(cuda, calls, entry,
                                                    request_):
    """A span's range that launches device work is recorded again on the
    device's timeline, where the benchmark counts every name outside its
    entry's ``SPANS`` as device work: no program span outside them may
    enclose a launch or a copy."""
    from portbench.harness import load_module

    allowed = {s[2] for s in load_module(f"entries/{entry}.py").SPANS}
    request_()                          # builds the device program
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        request_()
        torch.cuda.synchronize()
    program = set(calls[-1]["spans"])
    on_device = {e.name() for e in prof.profiler.kineto_results.events()
                 if e.device_type() == torch.autograd.DeviceType.CUDA
                 and e.name() in program}
    assert "ipm" in on_device
    assert on_device <= allowed
