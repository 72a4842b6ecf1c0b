"""Whole runs of each cell on the CPU at a size a test run can hold (the
card's look skipped: ``run_cell(..., device="cpu")``): sound runs come
out correct, and runs with the timed path broken underneath, or its
lower-precision path switched on, come out not correct."""

import pytest
import torch

from portbench.harness import load_cell, metrics_of, run_cell

SEED = 2 ** 31 + 77

SMALL = {
    "randlp48.linprog": dict(traffic=dict(batch=8, pool=2)),
    "staircase8k.optimize": dict(config=dict(rows=256),
                                 traffic=dict(pool=2)),
}
BATCHED = ["randlp48.linprog"]


def run(workload, trace=0, device="cpu", control=False):
    return run_cell(workload, SEED, 0.5, trace, device=device,
                    control=control, overrides=SMALL[workload])[0]


@pytest.mark.parametrize("workload", sorted(SMALL))
@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run_is_correct(workload, trace):
    res = run(workload, trace)
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(res)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    # The metrics that BENCHMARK.json gives the cell, and no other; on the
    # CPU the readers of the card's allocator and trace find nothing.
    names = {m["name"] for m in metrics_of(load_cell(workload)[0],
                                           workload, trace)}
    assert set(res["metrics"]) <= names
    assert names - set(res["metrics"]) <= {
        "peak_device_mib", "device_idle_share", "device_idle_share.optimize"}
    if trace:
        assert res["device"]["window_s"] > 0


def _state_unchanged(monkeypatch):
    """Every IPM step returns the point it was given (the iteration count
    still moves, so the solve ends at the iteration limit)."""
    from tulip_tpu_torch.ipm import hsd

    real = hsd.hsd_iteration

    def stuck(backend, opts, dat, state):
        return real(backend, opts, dat, state)._replace(pt=state.pt)

    monkeypatch.setattr(hsd, "hsd_iteration", stuck)


def _half_batch(monkeypatch):
    """The batched solve solves the first half of its lanes and hands
    their answers back for the second half too."""
    from tulip_tpu_torch.ipm import batch

    real = batch.batched_hsd_solve

    def half(backend, opts, dats):
        B = dats.b.shape[0]
        h = (B + 1) // 2
        out = real(backend, opts, batch._map(dats, lambda t: t[:h]))
        return batch._map(out, lambda t: torch.cat([t, t])[:B]
                          if torch.is_tensor(t) and t.dim() else t)

    monkeypatch.setattr(batch, "batched_hsd_solve", half)


def _answer_altered_batched(monkeypatch):
    """Lane 0's x[0] moved by 1 where the batched solve produces it."""
    from tulip_tpu_torch.ipm import batch

    real = batch.batched_hsd_solve

    def altered(backend, opts, dats):
        out = real(backend, opts, dats)
        x = out.pt.x.clone()
        x[0, 0] += out.pt.tau[0]
        return out._replace(pt=out.pt._replace(x=x))

    monkeypatch.setattr(batch, "batched_hsd_solve", altered)


def _answer_altered_model(monkeypatch):
    """x[0] moved by 1 where postsolve produces the user's solution."""
    from tulip_tpu_torch import model

    real = model.postsolve

    def altered(sol, inner, ps):
        real(sol, inner, ps)
        sol.x[0] += 1.0

    monkeypatch.setattr(model, "postsolve", altered)


FAULTS = [(w, "state_unchanged", _state_unchanged) for w in sorted(SMALL)]
FAULTS += [(w, "half_batch", _half_batch) for w in BATCHED]
FAULTS += [(w, "answer_altered", _answer_altered_batched) for w in BATCHED]
FAULTS += [(w, "answer_altered", _answer_altered_model)
           for w in sorted(set(SMALL) - set(BATCHED))]


@pytest.mark.parametrize("workload,name,fault", FAULTS,
                         ids=[f"{w}-{n}" for w, n, _ in FAULTS])
def test_broken_timed_path_is_not_correct(workload, name, fault,
                                          monkeypatch):
    fault(monkeypatch)
    assert not run(workload)["correct"]


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_control_is_not_correct(workload):
    """Each configuration's control in the program's place: for randlp the
    plain reference computed in TF32, for staircase the program's own
    float32 path (ArithmeticDtype = "float32")."""
    assert not run(workload, control=True)["correct"]


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_sound_run_on_the_card_is_correct(workload, cuda):
    """The same small runs on the card, traced (skipped without one)."""
    res = run(workload, trace=1, device=cuda)
    assert res["correct"], res["checks"]
