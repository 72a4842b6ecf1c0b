"""The per-layer metrics that read the program's call records
(``portbench/calls.py``): the window they take, and their readings on
tiny traced runs of each cell on the CPU, held against the benchmark's
own spans around the same functions."""

import collections
from types import SimpleNamespace

import pytest

from portbench import calls, harness
from tulip_tpu_torch import trace

SEED = 2 ** 31 + 91

NEW = {"staircase8k.optimize": ("load_s.optimize", "sparse_plan_s.optimize"),
       "randlp48.linprog": ("load_ms.linprog", "presolve_ms.linprog",
                            "results_ms.linprog")}


@pytest.fixture
def records(monkeypatch):
    fresh = collections.deque(maxlen=trace.CALLS.maxlen)
    monkeypatch.setattr(trace, "CALLS", fresh)
    return fresh


def _calls(entry, marks):
    for k in marks:
        with trace.call(entry):
            trace.count("mark", k)


@pytest.mark.parametrize("before", [0, 3])
def test_window_takes_the_window_s_records(records, before):
    """Calls made before the run (set-up, earlier runs), other entries'
    records between them, and the profiled slice's after: the window's W
    records and no other."""
    _calls("e", range(100, 100 + before))
    for k in range(5):                  # the window's requests
        _calls("other", [-1])
        _calls("e", [k])
    _calls("e", [200, 201])             # the profiled slice's
    run = SimpleNamespace(records=[None] * 5,
                          profile=SimpleNamespace(requests=2))
    got = calls.window(run, "e")
    assert [r["counters"]["mark"] for r in got] == list(range(5))
    run.records = [None] * (6 + before)
    assert calls.window(run, "e") is None
    run.profile = None
    assert calls.window(run, "e") is None


def _spied_run(monkeypatch, workload, overrides):
    """A traced CPU run of ``workload`` and the ``run`` its readers got."""
    real = harness.load_module
    seen = {}

    def spy(path):
        mod = real(path)
        if path.startswith("metrics/"):
            read = mod.read
            mod.read = lambda run: (seen.setdefault("run", run), read(run))[1]
        return mod

    monkeypatch.setattr(harness, "load_module", spy)
    res, _ = harness.run_cell(workload, SEED, 0.5, 1, device="cpu",
                              overrides=overrides)
    return res, seen["run"]


def _harness_span(run, name):
    """The benchmark's own span ``name``, summed a request, mean a
    request of the window."""
    return sum(s["s"] for r in run.records for s in r.spans
               if s["name"] == name) / len(run.records)


def test_optimize_metrics_read_the_program_s_records(monkeypatch):
    """At m = 2048 with the sparse-first attempt forced, the plan runs
    whole; the program's ``sparse_first`` span and the benchmark's, which
    wrap the same call, agree."""
    from tulip_tpu_torch import Parameters
    from tulip_tpu_torch import model as tmodel

    def forced():
        p = Parameters()
        p.KKT.SparseFirst = True
        return p

    monkeypatch.setattr(tmodel, "Parameters", forced)
    res, run = _spied_run(monkeypatch, "staircase8k.optimize", dict(
        config=dict(rows=2048), traffic=dict(pool=2, trace_seconds=0.1)))
    assert res["correct"], res["checks"]
    got = {k: res["metrics"][k]["value"] for k in NEW["staircase8k.optimize"]}
    assert got["load_s.optimize"] > 0
    want = _harness_span(run, "sparse_first")
    assert want > 0
    assert abs(got["sparse_plan_s.optimize"] - want) <= 0.05 * want + 1e-3
    recs = calls.window(run, "optimize")
    assert all("sparse_first/col_blocks" in r["spans"] for r in recs)


def test_linprog_metrics_read_the_program_s_records(monkeypatch):
    res, run = _spied_run(monkeypatch, "randlp48.linprog",
                          dict(traffic=dict(batch=16, pool=2)))
    assert res["correct"], res["checks"]
    got = {k: res["metrics"][k]["value"] for k in NEW["randlp48.linprog"]}
    assert all(v > 0 for v in got.values())
    want = _harness_span(run, "load") * 1e3
    assert abs(got["load_ms.linprog"] - want) <= 0.05 * want + 1.0
