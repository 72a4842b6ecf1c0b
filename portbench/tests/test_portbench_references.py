"""The configuration's own plain reference (its ``reference`` key,
``references/<name>.py``): the default box reference judges as the dense
check always has, bit for bit, and a reference that never makes A dense
decides ``correct`` through the same harness."""

import pytest
import torch

from portbench import check, harness, reference
from portbench.tests.test_portbench_runs import (SMALL, _answer_altered_model,
                                                 run)

SEED = 2 ** 31 + 113


def _parent_compare(pool, records, device):
    """The check's comparison as it was before a configuration could name
    its reference: each pool item's A made dense by ``box_batch``, solved
    by ``solve_box_lp``, and A·x read as ``A @ x``."""
    import numpy as np

    by_item = {}
    for r in records:
        by_item.setdefault(r.item, []).append(r.answers)
    out = dict(not_optimal=0, obj_err=0.0, primal_res=0.0, ref_unsolved=0)
    for k in sorted(by_item):
        A, b, c, u = check.box_batch(pool[k], device)
        ref = reference.solve_box_lp(A, b, c, u)
        out["ref_unsolved"] += int((~ref.converged).sum())
        scale = ref.obj.abs().clamp(min=1.0)
        for ans in by_item[k]:
            opt = torch.as_tensor(np.asarray(ans["optimal"]), device=device)
            out["not_optimal"] += int((~opt).sum())
            x = torch.as_tensor(np.asarray(ans["x"]), device=device,
                                dtype=torch.float64).reshape(u.shape)
            obj = torch.as_tensor(np.asarray(ans["obj"], dtype=np.float64),
                                  device=device).reshape(scale.shape)
            err = ((c * x).sum(-1) - ref.obj).abs()
            err = torch.maximum(err, torch.where(
                obj.isfinite(), (obj - ref.obj).abs(), err)) / scale
            res = check._inf((A @ x.unsqueeze(-1)).squeeze(-1) - b) / (
                1 + check._inf(b))
            viol = torch.maximum((-x).clamp(min=0), (x - u).clamp(min=0))
            res = torch.maximum(res, check._inf(viol) / (1 + check._inf(u)))
            inf = float("inf")
            out["obj_err"] = max(out["obj_err"], float(
                torch.nan_to_num(err, nan=inf).max()))
            out["primal_res"] = max(out["primal_res"], float(
                torch.nan_to_num(res, nan=inf).max()))
    return out


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_box_reference_judges_as_the_dense_check_did(workload, monkeypatch):
    """The run's own check (the configuration names no reference, so the
    default), the box reference named by the key, and the parent's dense
    comparison give the same four numbers, bit for bit, on the run's
    records."""
    real = check.compare
    seen = {}

    def spy(pool, records, device, ref):
        seen.update(pool=pool, records=records, device=device, ref=ref)
        return real(pool, records, device, ref)

    monkeypatch.setattr(check, "compare", spy)
    res = harness.run_cell(workload, SEED, 0.5, 0, device="cpu",
                           overrides=SMALL[workload])[0]
    assert "reference" not in harness.load_cell(workload)[2]
    assert seen["ref"].__file__.endswith("references/box.py")
    pool, records, dev = seen["pool"], seen["records"], seen["device"]
    assert len(records) > 0
    by_run = {k: c["value"] for k, c in res["checks"].items()}
    by_key = real(pool, records, dev,
                  harness.reference_of({"reference": "box"}))
    by_default = real(pool, records, dev, harness.reference_of({}))
    parent = _parent_compare(pool, records, dev)
    assert by_run == by_key == by_default == parent
    assert res["correct"], res["checks"]


STAIR = "staircase8k.optimize"
BLOCKS = dict(config={**SMALL[STAIR]["config"], "reference": "blocks"},
              traffic=SMALL[STAIR]["traffic"])


@pytest.fixture
def blocks_reference(monkeypatch):
    """The configuration's reference ``blocks`` found in the tests' folder;
    the dense path raises wherever it is called."""
    real = harness.load_module

    def load(path):
        return real("tests/blocks_reference.py"
                    if path == "references/blocks.py" else path)

    def dense(*a, **k):
        raise AssertionError("the dense box reference was called")

    monkeypatch.setattr(harness, "load_module", load)
    monkeypatch.setattr(check, "box_batch", dense)
    monkeypatch.setattr(reference, "solve_box_lp", dense)


def test_blocks_reference_decides_correct(blocks_reference):
    res = harness.run_cell(STAIR, SEED, 0.5, 0, device="cpu",
                           overrides=BLOCKS)[0]
    assert res["correct"], res["checks"]
    assert res["checks"]["ref_unsolved"]["value"] == 0


def test_blocks_reference_catches_an_answer_moved_by_one(blocks_reference,
                                                         monkeypatch):
    _answer_altered_model(monkeypatch)
    res = harness.run_cell(STAIR, SEED, 0.5, 0, device="cpu",
                           overrides=BLOCKS)[0]
    assert not res["correct"]
    c = res["checks"]["primal_res"]
    assert c["value"] > c["limit"]


def test_blocks_matvec_is_the_sparse_product():
    from portbench.generators.staircase import staircase_lp
    from portbench.harness import load_module

    A, b, c, u = staircase_lp(256, seed=3)
    lp = load_module("tests/blocks_reference.py").build(
        dict(A=A, b=b, c=c, u=u), "cpu")
    x = torch.rand((1, A.shape[1]), dtype=torch.float64)
    want = torch.as_tensor(A @ x[0].numpy())
    assert torch.allclose(lp.matvec(x)[0], want, rtol=1e-14, atol=1e-13)
    # Each block of 64 rows holds the 2 × 96 columns of its stage and the
    # next one's, never the whole width.
    assert [blk.shape for *_, blk in lp.blocks] == [(64, 192)] * 4
